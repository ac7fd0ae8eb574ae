"""Python UDF worker pool (counterpart of
``spark_rapids_tpu/runtime/pyworker.py``).

Reference parity: the reference ships a GPU-sharing PySpark daemon +
worker pool (python/rapids/daemon.py, GpuPythonRunner family) so opaque
Python UDFs don't serialize the whole executor. The engine analog: a
persistent ``multiprocessing`` pool that evaluates row-UDF chunks in
parallel worker processes, with the engine process staying free for
device work. Workers are spawned lazily on first use and reused across
queries (daemon semantics); closures are shipped by pickle, so only
picklable UDFs are eligible. Unpicklable ones (lambdas in local scope,
closures over open handles) stay on the in-process path: that is the
pool's own rule for what it takes, not a fallback from the device.

Conf: spark.rapids.sql.python.workerPool.enabled (default on) and
spark.rapids.sql.python.workerPool.parallelism (default = cpu count,
capped at 8).

Workers are SPAWNED, never forked: the engine process has CUDA
initialised, and a forked child would inherit a CUDA context it cannot
use (and any mutex another thread held at the fork). A worker imports
this package, and through it torch, but never touches the card: nothing
on the package's import path calls ``torch.cuda``, and a worker only
unpickles the UDF and calls it on Python values. Cost note: that import
is seconds of latency and real RSS per worker, paid ONCE per process
lifetime because the pool persists; the row threshold is sized so only
batches that amortize it engage the pool.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import List, Optional

_POOL = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def _get_pool(size: int):
    """SPAWN-context pool that persists across queries. Guarded by a lock:
    partitions evaluate on a thread pool."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE != size:
            if _POOL is not None:
                _POOL.terminate()
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            _POOL = ctx.Pool(processes=size)
            _POOL_SIZE = size
        return _POOL


def shutdown_pool() -> None:
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.terminate()
            _POOL.join()
            _POOL = None


def _run_chunk(payload: bytes):
    """Worker body. UDF exceptions are RETURNED (tagged), not raised:
    the parent must distinguish 'the UDF failed' (propagate, matching
    in-process behavior) from 'the pool failed' (decline + in-process).
    Unpickling failures are the POOL's problem (e.g. a __main__-defined
    fn that pickles by reference but has no symbol in the spawn child),
    so they get their own tag and the caller declines."""
    try:
        fn, rows = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001
        return ("badenv", f"{type(e).__name__}: {e}")
    try:
        return ("ok", [fn(*args) for args in rows])
    except Exception as e:  # noqa: BLE001
        return ("err", f"{type(e).__name__}: {e}")


def eligible(fn) -> bool:
    """Picklable check (spawned workers need to reconstruct the fn)."""
    try:
        pickle.dumps(fn)
        return True
    except Exception:  # noqa: BLE001 - any pickling failure disqualifies
        return False


def map_rows(fn, rows: List[tuple], parallelism: int,
             min_rows_per_chunk: int = 8192) -> Optional[list]:
    """Evaluate fn over arg tuples across the worker pool; None when the
    pool declines (small input, unpicklable fn) and the caller should
    run in-process."""
    n = len(rows)
    if n < 2 * min_rows_per_chunk or parallelism <= 1 or not eligible(fn):
        return None
    size = min(parallelism, max(os.cpu_count() or 1, 1), 8)
    nchunks = min(size * 2, max(n // min_rows_per_chunk, 1))
    step = -(-n // nchunks)
    try:
        payloads = [pickle.dumps((fn, rows[off: off + step]))
                    for off in range(0, n, step)]
        pool = _get_pool(size)
        parts = pool.map(_run_chunk, payloads)
    except Exception:  # noqa: BLE001 - POOL failure: decline + reset
        shutdown_pool()
        return None
    if any(tag == "badenv" for tag, _ in parts):
        return None  # workers can't reconstruct the fn: run in-process
    out: list = []
    for tag, part in parts:
        if tag == "err":
            # the UDF itself failed — propagate like the in-process path
            raise RuntimeError(f"python UDF failed in worker: {part}")
        out.extend(part)
    return out
