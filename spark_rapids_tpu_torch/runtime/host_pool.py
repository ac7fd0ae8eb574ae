"""The shared host task pool, task waves and service threads (counterpart
of ``spark_rapids_tpu/runtime/host_pool.py``).

Reference parity: MultiFileReaderThreadPool (GpuMultiFileReader.scala):
ONE executor-wide pool shared by every multi-file reader, sized once,
instead of a pool per scan. All host-side task parallelism (the Parquet
scan's prefetch, the pipeline boundaries' refills, the serialized
shuffle's packing and its blob decode) shares this bounded pool.

Deadlock discipline: pool workers may themselves reach code that submits
to the pool (a pipeline refill runs a scan whose prefetcher submits
row-group loads). A single bounded pool whose workers block on queued
work deadlocks, so the pool is TWO tiers of equal size: top-level
submissions run on tier 0, submissions from a tier-0 worker run on tier
1, and submissions from a tier-1 worker run inline. Tier-1 workers never
wait on tier-1 work, so no cycle can starve.

The serving QoS tier of the JAX module (``qos_nice``/``run_at_nice``:
background requests run their host work at raised niceness) waits for
the serving layer (A11f).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

_PREFIX0 = "rapids-host-pool-t0"
_PREFIX1 = "rapids-host-pool-t1"
_PREFIX_TASK = "rapids-task"
_END = object()


def run_task_wave(fn, items, max_concurrency: int = 16) -> list:
    """Run one action's top-level partition tasks (the Spark task-set
    role) and return [fn(item)] in input order.

    The wave owns a throwaway executor of at most ``max_concurrency``
    threads: task threads block for whole-task lifetimes (semaphore
    waits), so waves must not share one bounded executor. A wave thread
    carries the submitter's session conf and bound query id, so
    ``lifecycle.check_current`` and the per-query device quota see the
    query, and checks for a cancel before it starts its task."""
    items = list(items)
    if len(items) <= 1:
        return [fn(i) for i in items]
    from spark_rapids_tpu_torch import config as _cfg
    from spark_rapids_tpu_torch.runtime import lifecycle as _lc
    from spark_rapids_tpu_torch.runtime.obs import attribution as _attr
    from spark_rapids_tpu_torch.runtime.obs import live as _live
    conf = getattr(_cfg._local, "conf", None)
    # a warmup replay's suppression rides too: its task records and
    # audited dispatches must not land in a concurrent user query's
    suppress = _attr.thread_suppressed()
    # the submitter's bound query id rides to the wave threads: a task
    # constructed on a wave thread attributes to the query that fanned
    # it out
    qid = _live.current_query_id()
    # ... and so does the serving request context (A11f: request
    # tracing; None while no request is bound)
    rctx = _live.current_request()

    def bound(item):
        _cfg.set_session_conf(conf)
        if suppress:
            _attr.set_thread_suppressed(True)
        prev = _live.bind(qid)
        if rctx is not None:
            _live.bind_request(rctx)
        try:
            # wave-start cooperative checkpoint: partitions of an
            # already-cancelled query unwind before doing any work
            _lc.check_current()
            return fn(item)
        finally:
            if rctx is not None:
                _live.bind_request(None)
            _live.bind(prev)
            if suppress:
                _attr.set_thread_suppressed(False)
            _cfg.set_session_conf(None)

    with ThreadPoolExecutor(max_workers=min(len(items), max_concurrency),
                            thread_name_prefix=_PREFIX_TASK) as tp:
        return list(tp.map(bound, items))


def spawn_service_thread(target, name: str, daemon: bool = True
                         ) -> threading.Thread:
    """The creation point of long-lived or abandonable service threads
    (the deadline sweeper, the dispatch watchdog's heartbeat). Returns
    the started thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon)
    t.start()
    return t


class HostTaskPool:
    """Bounded shared two-tier pool with inline fallback at depth 2."""

    def __init__(self, n_threads: int):
        self.n_threads = max(1, int(n_threads))
        self._tier0 = ThreadPoolExecutor(max_workers=self.n_threads,
                                         thread_name_prefix=_PREFIX0)
        self._tier1 = ThreadPoolExecutor(max_workers=self.n_threads,
                                         thread_name_prefix=_PREFIX1)

    @staticmethod
    def _depth() -> int:
        name = threading.current_thread().name
        if name.startswith(_PREFIX1):
            return 2
        if name.startswith(_PREFIX0):
            return 1
        return 0

    def submit(self, fn: Callable, *args) -> Future:
        """Run fn(*args) on the tier below the caller's (inline from a
        tier-1 worker). The work runs bound to the submitter's query id,
        restored afterwards, so a cancel or a deadline reaches it."""
        depth = self._depth()
        from spark_rapids_tpu_torch.runtime import trace
        tr = trace.active()
        if tr is not None and tr.level >= trace.DEBUG:
            # queue-time observability: how long the task sat behind other
            # host work before a worker picked it up
            import time as _time
            enq = _time.perf_counter_ns()
            inner, name = fn, getattr(fn, "__name__", "task")

            def fn(*a):  # noqa: F811 - traced wrapper replaces fn
                trace.instant("hostPoolDequeue", cat="host_pool", args={
                    "queue_us": (_time.perf_counter_ns() - enq) / 1000.0,
                    "tier": depth, "fn": name},
                    level=trace.DEBUG)
                return inner(*a)
        # the submitter's query id, the OUTERMOST wrapper (so the dequeue
        # instant above runs bound too): pool workers are shared across
        # queries; unbound submitters skip the wrapper
        from spark_rapids_tpu_torch.runtime.obs import live as _live
        qid = _live.current_query_id()
        if qid is not None:
            inner_fn = fn

            def fn(*a):  # noqa: F811 - bound wrapper replaces fn
                return _live.run_bound(qid, inner_fn, *a)
        # the submitter's serving request context rides the same seam
        # (A11f: request tracing; None while no request is bound)
        rctx = _live.current_request()
        if rctx is not None:
            req_fn = fn

            def fn(*a):  # noqa: F811 - request-bound wrapper replaces fn
                return _live.run_request_bound(rctx, req_fn, *a)
        # A11f: the JAX package also carries the submitter's serving QoS
        # tier (qos_nice/run_at_nice) onto the worker here
        if depth == 0:
            return self._tier0.submit(fn, *args)
        if depth == 1:
            return self._tier1.submit(fn, *args)
        f: Future = Future()
        try:
            f.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - future carries it
            f.set_exception(e)
        return f

    def map_ordered(self, fn: Callable, items: Iterable,
                    max_concurrency: Optional[int] = None) -> Iterator:
        """Results of fn(item) in input order (pool.map analog that keeps
        the tiered-submission discipline). ``max_concurrency`` caps this
        caller's in-flight tasks below the tier size: the per-site knobs
        (scan and shuffle threads) still bound how much work one caller
        admits, even though the threads are shared. Closing the generator
        early waits for the calls in flight."""
        from collections import deque
        limit = self.n_threads if max_concurrency is None \
            else max(1, min(int(max_concurrency), self.n_threads))
        pending: "deque[Future]" = deque()
        it = iter(items)
        try:
            for item in it:
                pending.append(self.submit(fn, item))
                if len(pending) >= limit:
                    break
            while pending:
                # the head's result first, then its slot's next task: at
                # most ``limit`` calls are ever in flight
                res = pending.popleft().result()
                nxt = next(it, _END)
                if nxt is not _END:
                    pending.append(self.submit(fn, nxt))
                yield res
        finally:
            for f in pending:
                f.cancel()
            for f in pending:
                if not f.cancelled():
                    f.exception()

    def queue_depths(self) -> dict:
        """Tasks queued (submitted, not yet picked up) per tier. Racy
        reads by design."""
        return {"tier0": self._tier0._work_queue.qsize(),
                "tier1": self._tier1._work_queue.qsize()}

    def shutdown(self) -> None:
        self._tier0.shutdown(wait=True)
        self._tier1.shutdown(wait=True)


_LOCK = _san.lock("hostPool.registry")
_POOL: "Optional[HostTaskPool]" = None


def _pool_size(conf) -> int:
    """The tier size honors every conf that sizes host parallelism: the
    multithreaded read (scans) and the shuffle writer and reader
    threads."""
    from spark_rapids_tpu_torch import config as C
    c = conf if conf is not None else C.session_conf()
    return max(int(c.get(C.MULTIFILE_READER_THREADS)),
               int(c.get(C.SHUFFLE_WRITER_THREADS)),
               int(c.get(C.SHUFFLE_READER_THREADS)))


def get_host_pool(conf=None) -> HostTaskPool:
    """The process-wide pool, created on first use (the first caller's
    conf wins, as the reference's getOrCreateThreadPool)."""
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = HostTaskPool(_pool_size(conf))
        return _POOL


def current_pool() -> "Optional[HostTaskPool]":
    """The pool if one exists, without creating it."""
    return _POOL


def reset_host_pool() -> None:
    """Drop the shared pool so the next user re-sizes it (tests)."""
    global _POOL
    with _LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown()
