"""Task waves and service threads (counterpart of ``run_task_wave`` and
``spawn_service_thread`` in ``spark_rapids_tpu/runtime/host_pool.py``).

The shared two-tier host pool and the decode pool of the JAX module are
ROADMAP A11; the Parquet scan keeps its own bounded prefetch pool
(``exec/nodes._prefetched``).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

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


def spawn_service_thread(target, name: str, daemon: bool = True
                         ) -> threading.Thread:
    """The creation point of long-lived or abandonable service threads
    (the deadline sweeper, the dispatch watchdog's heartbeat). Returns
    the started thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon)
    t.start()
    return t
