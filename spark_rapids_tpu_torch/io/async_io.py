"""Async write throttling (counterpart of
``spark_rapids_tpu/io/async_io.py``).

Reference parity: io/async/{ThrottlingExecutor,TrafficController}.scala:
writes run on a background pool, but a controller caps the bytes in
flight so a burst of producers cannot exhaust host memory buffering
output (TrafficController initialized in Plugin.scala:558). The file
writer (``io/writer.py``) and the serialized exchange's packing
(``exec/nodes.ShuffleExchangeExec``) submit through it.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime import trace

#: bounded wait slice while blocked on admission: each wakeup re-checks
#: the caller's query cancel token (runtime/lifecycle.py), so a
#: cancelled query's writer unwinds instead of waiting out other
#: queries' releases
_CANCEL_SLICE_S = 0.25

_LOG = logging.getLogger("spark_rapids_tpu_torch")


class TrafficController:
    """Blocks producers while more than max_in_flight_bytes of writes are
    buffered or unfinished.

    ``stall_warn_s`` (None disables) arms a diagnostic: a producer that
    has waited that long without admission logs ONE warning, then keeps
    waiting. Admission semantics are unchanged. The wait emits an
    asyncWriteStalled trace instant and bumps the
    rapids_async_write_stalls_total obs counter too."""

    def __init__(self, max_in_flight_bytes: int,
                 stall_warn_s: Optional[float] = None):
        self.limit = max_in_flight_bytes
        self.stall_warn_s = stall_warn_s
        self._inflight = 0
        self._cv = _san.condition("asyncWrite.controller")

    def _warn_stalled(self, waited_s: float, nbytes: int,
                      inflight: int) -> None:
        """Called WITHOUT self._cv held: a blocked log handler must never
        hold up writers' release()."""
        _LOG.warning(
            "async write throttle stalled: waited %.1fs for %d bytes "
            "(%d in flight, limit %d) - a writer may be wedged",
            waited_s, nbytes, inflight, self.limit)
        trace.instant("asyncWriteStalled", cat="io", args={
            "waited_s": round(waited_s, 3), "bytes": nbytes,
            "in_flight": inflight, "limit": self.limit},
            level=trace.ESSENTIAL)
        from spark_rapids_tpu_torch.runtime import obs
        st = obs.state()
        if st is not None:
            try:
                st.registry.counter(
                    "rapids_async_write_stalls_total",
                    "Async-write throttle waits that exceeded the stall "
                    "warning threshold").inc()
            except Exception:  # noqa: BLE001 - diagnostics never fail IO
                pass

    def acquire(self, nbytes: int) -> None:
        from spark_rapids_tpu_torch.runtime import lifecycle as _lc
        t0 = time.perf_counter()
        blocked = False
        warned = False
        with self._cv:
            while self._inflight > 0 and self._inflight + nbytes > self.limit:
                blocked = True
                if self.stall_warn_s is not None and not warned:
                    waited = time.perf_counter() - t0
                    if waited >= self.stall_warn_s:
                        warned = True
                        inflight = self._inflight
                        # warn with the lock dropped: release() must stay
                        # reachable while the diagnostic does I/O
                        self._cv.release()
                        try:
                            self._warn_stalled(waited, nbytes, inflight)
                        finally:
                            self._cv.acquire()
                        continue  # re-check admission: it may have freed
                    self._cv.wait(timeout=min(self.stall_warn_s - waited,
                                              _CANCEL_SLICE_S))
                else:
                    # cancellation-aware bounded slices: a cancelled
                    # query's writer parked on admission wakes and unwinds
                    self._cv.wait(timeout=_CANCEL_SLICE_S)
                _lc.check_current()
            self._inflight += nbytes
        if blocked:
            trace.instant("asyncWriteThrottled", cat="io", args={
                "blocked_ns": int((time.perf_counter() - t0) * 1e9),
                "bytes": nbytes})

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._inflight


class ThrottlingExecutor:
    """Thread pool + TrafficController: submit(task_bytes, fn) blocks until
    the controller admits the bytes; completion releases them.

    Pass ``pool`` (anything with submit(fn) -> Future, such as the
    shared pool of ``runtime/host_pool.py``) to run tasks
    on a shared executor instead of owning one; shutdown() then leaves it
    alive, and ``max_threads`` bounds this executor's concurrency on it
    through a slot semaphore."""

    def __init__(self, max_threads: int, controller: TrafficController,
                 pool=None):
        self._owned = pool is None
        # tpulint: disable=TPU-L002 standalone-writer fallback only: the engine always passes pool= (the shared host pool); an owned executor here serves direct ThrottlingExecutor users (tests, tools) with shutdown() semantics the shared pool must not have
        self.pool = ThreadPoolExecutor(max_workers=max_threads) \
            if pool is None else pool
        self.controller = controller
        self._slots = None if pool is None \
            else threading.BoundedSemaphore(max_threads)

    def submit(self, nbytes: int, fn: Callable, *args) -> Future:
        self.controller.acquire(nbytes)
        if self._slots is not None:
            self._slots.acquire()

        def run():
            try:
                with trace.span("asyncWrite", cat="io", level=trace.DEBUG,
                                args={"bytes": nbytes}):
                    return fn(*args)
            finally:
                if self._slots is not None:
                    self._slots.release()
                self.controller.release(nbytes)

        return self.pool.submit(run)

    def shutdown(self, wait: bool = True) -> None:
        if self._owned:
            self.pool.shutdown(wait=wait)
