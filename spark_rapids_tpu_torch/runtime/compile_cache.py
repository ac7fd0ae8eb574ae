"""The keyed stage cache: one process-wide cache of built stage functions.

Counterpart of the keyed layer of ``spark_rapids_tpu/runtime/
compile_cache.py``. Every per-batch stage function the engine builds
(``exec/fuse.fused``: fused stages, absorbed aggregate updates, exchange
and TopN steps; ``exec/compiled.run_stage``: expression lists) resolves
here by (exec class, semantic key, compile-relevant conf fingerprint). A
hit is one dict probe; a miss calls the builder once and keeps what it
returns.

Port differences. The JAX package's builder returns a Python body that
``jax.jit`` traces and XLA compiles on its first call, and that first
call is timed into the attribution's ``compile`` bucket. PyTorch runs
eagerly and nothing is traced, so here ``compile_ns`` times the
call of ``builder`` alone and nothing is attributed: a stage's first batch
stays in ``device_compute``, like every later one. The hand kernels'
``nvcc`` builds are attributed to ``compile`` by ``ops/_build.py``. The
JAX package's other layers wait for the second part of ROADMAP A11e:
``jit`` (its sanctioned module-level jit sites), the XLA monitoring
listener with its ``xla_compiles`` counters, and the persistent
``spark.rapids.compile.cacheDir`` with its ``persistent_*`` counters.

The obs registry reads ``stats()`` live as the gauges
``rapids_compile_cache_hits``, ``_misses`` and ``_entries``. A cached
function holds what its builder captured (expressions, static settings,
the device), never an operator: an operator's child tree can pin cached
batches on the card for the life of the process.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

from spark_rapids_tpu_torch.analysis import sanitizer as _san

_CACHE: Dict[Tuple, Callable] = {}
_LOCK = _san.lock("runtime.compile_cache")

#: plain-int counters: hits bump without a lock (a lost update under the
#: GIL costs a count, never correctness); misses and compile_ns move only
#: under _LOCK
_STATS = {
    "hits": 0,        # keyed entries resolved without building
    "misses": 0,      # fresh entries built
    "compile_ns": 0,  # summed builder calls of fresh entries
}

#: fingerprint of the most recently activated session conf: the fallback
#: for threads with no conf bound (service threads)
_FALLBACK_FP: Tuple = (False, True)


def publish_conf(conf) -> None:
    """Called by ``config.set_session_conf``: refresh the unbound-thread
    fallback fingerprint."""
    global _FALLBACK_FP
    _FALLBACK_FP = _fp_of(conf)


def _fp_of(c) -> Tuple:
    from spark_rapids_tpu_torch import config as C
    fp = getattr(c, "_compile_fp", None)
    if fp is None:
        fp = (bool(c.get(C.ANSI_ENABLED)),
              bool(c.get(C.IMPROVED_FLOAT_OPS)))
        try:
            c._compile_fp = fp
        except Exception:  # noqa: BLE001 - a frozen conf recomputes
            pass
    return fp


def _conf_fingerprint() -> Tuple:
    """The compile-relevant slice of the thread's session conf (ANSI and
    the float-op orderings), folded into every key: two sessions whose
    stage bodies differ must never share an entry. A thread with no conf
    bound uses the last-activated session's fingerprint."""
    from spark_rapids_tpu_torch import config as C
    c = getattr(C._local, "conf", None)
    if c is None:
        return _FALLBACK_FP
    return _fp_of(c)


def get(exec_class: str, key: Tuple, builder: Callable[[], Callable]
        ) -> Callable:
    """Resolve (exec class, key, conf fingerprint) to a stage function,
    calling ``builder`` on a miss. A builder that raises leaves no entry
    (the fused stages' fallback rests on that)."""
    full_key = (exec_class, key, _conf_fingerprint())
    fn = _CACHE.get(full_key)
    if fn is not None:
        _STATS["hits"] += 1
        return fn
    # the last cooperative checkpoint before a build, as in the JAX
    # package (there it precedes an uninterruptible compile)
    from spark_rapids_tpu_torch.runtime import lifecycle as _lc
    _lc.check_current()
    t0 = time.perf_counter_ns()
    built = builder()
    dt = time.perf_counter_ns() - t0
    with _LOCK:
        fn = _CACHE.get(full_key)
        if fn is not None:  # lost a build race: the first entry wins
            _STATS["hits"] += 1
            return fn
        _STATS["misses"] += 1
        _STATS["compile_ns"] += dt
        _CACHE[full_key] = built
    return built


def clear() -> None:
    """Drop every entry (tests; also releases what the builders
    captured)."""
    with _LOCK:
        _CACHE.clear()


def reset_stats_for_tests() -> None:
    for k in _STATS:
        _STATS[k] = 0


def stats() -> Dict[str, int]:
    """A point-in-time copy of the counters, with the live entry count."""
    out = dict(_STATS)
    out["entries"] = len(_CACHE)
    return out


def cache_keys() -> list:
    """Snapshot of the cached keys (profiling tools, tests)."""
    return list(_CACHE.keys())
