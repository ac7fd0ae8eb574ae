"""Task waves, the shuffle pools and service threads (counterpart of
``run_task_wave``, ``map_ordered`` and ``spawn_service_thread`` in
``spark_rapids_tpu/runtime/host_pool.py``).

The shared two-tier host pool and the decode pool of the JAX module are
ROADMAP A11. Until then the serialized shuffle packs and decodes on pools
of its own (``shuffle_pool``: one process-wide pool per role and size,
sized by spark.rapids.shuffle.multiThreaded.writer.threads and
.reader.threads), and the Parquet scan keeps its own bounded prefetch
pool (``exec/nodes._prefetched``).
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

_PREFIX_TASK = "rapids-task"


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
    conf = getattr(_cfg._local, "conf", None)
    qid = _lc.current_query_id()

    def bound(item):
        _cfg.set_session_conf(conf)
        prev = _lc.bind(qid)
        try:
            # wave-start cooperative checkpoint: partitions of an
            # already-cancelled query unwind before doing any work
            _lc.check_current()
            return fn(item)
        finally:
            _lc.bind(prev)
            _cfg.set_session_conf(None)

    with ThreadPoolExecutor(max_workers=min(len(items), max_concurrency),
                            thread_name_prefix=_PREFIX_TASK) as tp:
        return list(tp.map(bound, items))


_POOLS: Dict[Tuple[str, int], ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()


def shuffle_pool(role: str, threads: int) -> ThreadPoolExecutor:
    """The process-wide pool of ``threads`` threads for one shuffle role
    ('writer': packing and compression; 'reader': verification,
    decompression and parsing). Its tasks never touch the device and
    never block on other tasks, so sharing it across exchanges cannot
    deadlock."""
    key = (role, max(1, int(threads)))
    with _POOLS_LOCK:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = ThreadPoolExecutor(
                max_workers=key[1], thread_name_prefix=f"rapids-shuffle-"
                                                       f"{role}")
        return pool


def map_ordered(pool, fn, items, max_concurrency: int):
    """Yield fn(item) for each item, in input order, with at most
    ``max_concurrency`` calls in flight on ``pool``. Closing the generator
    early waits for the calls in flight."""
    pending = deque()
    it = iter(items)
    try:
        for item in it:
            pending.append(pool.submit(fn, item))
            if len(pending) >= max(1, max_concurrency):
                break
        while pending:
            fut = pending.popleft()
            nxt = next(it, _END)
            if nxt is not _END:
                pending.append(pool.submit(fn, nxt))
            yield fut.result()
    finally:
        for fut in pending:
            fut.cancel()
        for fut in pending:
            if not fut.cancelled():
                fut.exception()


_END = object()


def spawn_service_thread(target, name: str, daemon: bool = True
                         ) -> threading.Thread:
    """The creation point of long-lived or abandonable service threads
    (the deadline sweeper, the dispatch watchdog's heartbeat). Returns
    the started thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon)
    t.start()
    return t
