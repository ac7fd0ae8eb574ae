"""Device admission semaphore (counterpart of
``spark_rapids_tpu/runtime/semaphore.py``; reference GpuSemaphore.scala /
PrioritySemaphore.scala).

Limits the number of tasks concurrently touching the device to
``spark.rapids.sql.concurrentTpuTasks``. Tasks already holding device
data (re-acquisition) outrank fresh tasks; ties break by arrival.

Wakeups are direct handoff, not polling: a release (or an enqueue while
permits are free) grants permits to eligible head waiters under the lock
and signals exactly those waiters' events, so the measured
semaphoreWaitTime is real contention.

Interruptible acquire (``runtime/lifecycle.py``): a queued waiter's event
is registered with the acquiring query's cancel token, so ``cancel()``
doubles as the wakeup. A waiter that leaves abnormally (cancelled, or
killed by an exception on the wait path, which the ``semaphore.wait``
fault site injects) removes its heap entry and re-runs the handoff, so
its reserved permits can never strand.

The semaphore is created on first use with the permits of the conf in
force then; ``reset_semaphore`` drops it, so the next session's conf
sizes the next one.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Optional

from spark_rapids_tpu_torch.runtime import faults as _faults
from spark_rapids_tpu_torch.runtime import trace


class PrioritySemaphore:
    def __init__(self, permits: int):
        self._permits = permits
        self._available = permits
        self._lock = threading.Lock()
        self._waiters = []  # heap of [-priority, seq, n, event, granted]
        self._seq = 0

    def _grant_head_locked(self) -> None:
        """Direct handoff (caller holds the lock): pop head waiters while
        their permits fit, reserving the permits FOR them before setting
        their event — the woken thread never re-contends."""
        while self._waiters and self._available >= self._waiters[0][2]:
            entry = heapq.heappop(self._waiters)
            self._available -= entry[2]
            entry[4] = True  # reserved: an abandoning waiter must refund
            entry[3].set()

    def _abandon_locked_entry(self, entry) -> None:
        """A waiter is leaving abnormally (cancelled, or its wait path
        raised): refund permits already reserved for it, or remove its
        still-queued heap entry, then re-run the handoff — an abandoned
        head entry must never block later waiters."""
        with self._lock:
            if entry[4]:
                self._available += entry[2]
            else:
                try:
                    self._waiters.remove(entry)
                    heapq.heapify(self._waiters)
                except ValueError:
                    pass
            self._grant_head_locked()

    def acquire(self, n: int = 1, priority: int = 0,
                wait_metric=None, cancel_token=None) -> None:
        """Block until n permits are reserved for this caller. When
        `cancel_token` (runtime/lifecycle.CancelToken) is passed, the
        waiter event doubles as the cancel wakeup and a fired token
        raises QueryCancelledError with the entry cleaned up."""
        t0 = time.perf_counter_ns()
        with self._lock:
            if self._available >= n and not self._waiters:
                self._available -= n
                return
            ev = threading.Event()
            self._seq += 1
            entry = [-priority, self._seq, n, ev, False]
            heapq.heappush(self._waiters, entry)
            # a higher-priority arrival may jump an ineligible queue, and
            # permits freed while nobody dispatched must not strand: try
            # the handoff immediately (possibly granting ourselves)
            self._grant_head_locked()
        if cancel_token is not None:
            cancel_token.add_waiter(ev)
        try:
            # delay/wedge/ioerror a contended acquire; an injected error
            # here exercises the abandoned-entry cleanup below
            _faults.site("semaphore.wait")
            ev.wait()  # set once our permits are reserved, or on cancel
            if cancel_token is not None and cancel_token.cancelled:
                from spark_rapids_tpu_torch.runtime.lifecycle import (
                    QueryCancelledError,
                )
                raise QueryCancelledError(cancel_token.query_id,
                                          cancel_token.reason)
        except BaseException:
            self._abandon_locked_entry(entry)
            raise
        finally:
            if cancel_token is not None:
                cancel_token.remove_waiter(ev)
        if wait_metric is not None:
            wait_metric.add(time.perf_counter_ns() - t0)

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._available += n
            self._grant_head_locked()

    @property
    def available(self) -> int:
        return self._available

    @property
    def waiting(self) -> int:
        """Parked waiters (healthz saturation signal; racy read is fine)."""
        return len(self._waiters)


class TpuSemaphore:
    """Task-aware wrapper: re-entrant per task, auto-released on task end
    (reference GpuSemaphore.acquireIfNecessary / completion hook).

    The port materializes caches, exchanges and broadcast builds on the
    calling thread, each child partition in a task of its own nested in
    the calling task (``TaskContext.parent``). A nested task whose
    ancestor on the thread holds a permit runs under that permit instead
    of queueing for a second one: otherwise the tasks holding every
    permit could each wait for a permit for their own nested task."""

    def __init__(self, permits: int):
        self.permits = permits
        self._sem = PrioritySemaphore(permits)
        #: task_id -> perf_counter_ns at acquisition (truthy while held;
        #: the timestamp feeds the semaphoreHoldTime task accumulator)
        self._held: Dict[int, int] = {}
        self._lock = threading.Lock()
        #: most tasks that held a permit at once since the last
        #: reset_peak() (the wave's concurrency, as the card saw it)
        self.peak_held = 0

    def _holder(self, task_ctx):
        """task_ctx or the nearest ancestor on its thread that holds a
        permit, else None (caller holds the lock)."""
        c = task_ctx
        while c is not None:
            if self._held.get(c.task_id):
                return c
            c = c.parent
        return None

    def acquire_if_necessary(self, task_ctx) -> None:
        with self._lock:
            if self._holder(task_ctx) is not None:
                return
        if task_ctx.completed:
            # its consumer has unwound (a pipeline producer finishing a
            # cancelled query's batch): no permit, since nothing would
            # give it back; the producer stops at its next checkpoint
            return
        prio = 1 if task_ctx.holds_device_data else 0
        traced = trace.active() is not None
        t0 = time.perf_counter_ns() if traced else 0
        # the acquiring query's cancel token (if any) rides into the
        # waiter so a cancelled query parked on the semaphore wakes and
        # unwinds instead of holding its queue position forever
        from spark_rapids_tpu_torch.runtime import lifecycle as _lc
        self._sem.acquire(1, priority=prio,
                          wait_metric=task_ctx.metric("semaphoreWaitTime"),
                          cancel_token=_lc.current_token())
        if traced:  # args gated: no dict/clock work when tracing is off
            trace.instant("semaphoreAcquire", cat="semaphore", args={
                "task_id": task_ctx.task_id, "priority": prio,
                "wait_ns": time.perf_counter_ns() - t0})
        with self._lock:
            self._held[task_ctx.task_id] = time.perf_counter_ns()
            self.peak_held = max(self.peak_held, len(self._held))
        task_ctx.on_completion(lambda: self.release(task_ctx))

    def release(self, task_ctx) -> None:
        tid = task_ctx.task_id
        with self._lock:
            t_acq = self._held.pop(tid, 0)
            if not t_acq:
                return
        # hold-time accumulator (permit occupancy, the saturation-side
        # complement of semaphoreWaitTime)
        task_ctx.metric("semaphoreHoldTime").add(
            time.perf_counter_ns() - t_acq)
        self._sem.release(1)
        if trace.active() is not None:
            trace.instant("semaphoreRelease", cat="semaphore",
                          args={"task_id": tid})

    def release_for_wait(self, task_ctx) -> None:
        """Give back the permit covering task_ctx before it blocks on
        work another thread does under a lock (a materialization), so
        that thread can be admitted (reference GpuSemaphore releases
        around blocking shuffle waits). The task's next acquire takes a
        permit again, at the priority of a task holding device data."""
        with self._lock:
            holder = self._holder(task_ctx)
        if holder is not None:
            self.release(holder)

    def held(self) -> int:
        with self._lock:
            return len(self._held)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_held = len(self._held)

    @property
    def available(self) -> int:
        return self._sem.available

    @property
    def waiting(self) -> int:
        return self._sem.waiting


_global: Optional[TpuSemaphore] = None
_glock = threading.Lock()


def get_semaphore(conf=None) -> TpuSemaphore:
    global _global
    with _glock:
        if _global is None:
            from spark_rapids_tpu_torch import config as C
            c = conf if conf is not None else C.session_conf()
            _global = TpuSemaphore(int(c.get(C.CONCURRENT_TPU_TASKS)))
        return _global


def peek_semaphore() -> Optional[TpuSemaphore]:
    """The process semaphore without creating one."""
    return _global


def reset_semaphore() -> None:
    global _global
    with _glock:
        _global = None
