"""The keyed stage cache, the kernel-build counters and the build directory.

Counterpart of ``spark_rapids_tpu/runtime/compile_cache.py``. Three
layers, as in the JAX package:

1. **The keyed stage cache** (``get``). Every per-batch stage function
   the engine builds (``exec/fuse.fused``: fused stages, absorbed
   aggregate updates, exchange, TopN, window and join steps;
   ``exec/compiled.run_stage``: expression lists) resolves here by (exec
   class, semantic key, compile-relevant conf fingerprint). A hit is one
   dict probe; a miss calls the builder once and keeps what it returns.
   The JAX package's builder returns a Python body that ``jax.jit``
   traces and XLA compiles on its first call, timed into the
   attribution's ``compile`` bucket. PyTorch runs eagerly and nothing is
   traced, so here ``compile_ns`` times the call of ``builder`` alone and
   a stage's first batch stays in ``device_compute``, like every later
   one. With the kernel cost auditor armed (``set_auditor``), ``get``
   hands back the auditor's dispatch wrapper around the cached function.

2. **No sanctioned ``jit``.** The JAX package's module-level
   ``compile_cache.jit`` sites have no counterpart: eager PyTorch
   compiles nothing per signature. The port's only compiled code is its
   hand kernels, rostered in ``analysis/kernel_audit.KERNEL_PRIMITIVES``
   (every module that loads a ``csrc/*.cu`` library).

3. **The kernel-build counters and the build directory.** The JAX
   package counts XLA backend compiles and its persistent compilation
   cache's hits and misses through a ``jax.monitoring`` listener. Here
   the compiles are ``ops/_build.py``'s: a library compiled with
   ``nvcc`` (or the host compiler) counts into
   ``rapids_xla_compiles_total`` and ``rapids_xla_compile_seconds_total``
   and is a persistent-cache miss (``rapids_persistent_cache_misses_total``);
   a library found built on disk and only loaded is a hit
   (``rapids_persistent_cache_hits_total``). The series keep the JAX
   package's names so the obs roster and dashboards match; their HELP
   texts say what they count on the card. ``spark.rapids.compile.cacheDir``
   names the directory the libraries build into (``configure``); empty
   keeps ``build/torch_kernels`` at the root of the checkout.

The obs registry reads ``stats()`` live as the gauges
``rapids_compile_cache_hits``, ``_misses`` and ``_entries``, and
``doc()`` is ``/healthz``'s ``compile`` document. A cached function holds
what its builder captured (expressions, static settings, the device),
never an operator: an operator's child tree can pin cached batches on
the card for the life of the process.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

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
    "xla_compiles": 0,       # kernel libraries built (nvcc / host cc)
    "xla_compile_ns": 0,     # summed build walls
    "persistent_hits": 0,    # libraries found built on disk, only loaded
    "persistent_misses": 0,  # libraries that had to be built
}

#: the build directory named by spark.rapids.compile.cacheDir (None: the
#: default, build/torch_kernels)
_PERSISTENT_DIR: Optional[str] = None

#: the kernel cost auditor (analysis/kernel_audit.py) when armed, else
#: None: get() then returns its dispatch wrapper around every resolved
#: function. Disabled cost: this one module-global None check (the
#: fuse._DISPATCH_HOOK pattern).
_AUDITOR = None


def set_auditor(mod) -> None:
    """Arm or disarm the kernel cost auditor (kernel_audit.configure)."""
    global _AUDITOR
    _AUDITOR = mod

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
    # one read of the auditor global per call: a concurrent disarm must
    # not split the None check from the wrap
    auditor = _AUDITOR
    fn = _CACHE.get(full_key)
    if fn is not None:
        _STATS["hits"] += 1
        return fn if auditor is None else auditor.wrap(full_key, fn)
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
        else:
            _STATS["misses"] += 1
            _STATS["compile_ns"] += dt
            _CACHE[full_key] = fn = built
    if auditor is None:
        return fn
    auditor.mark_built(full_key)
    return auditor.wrap(full_key, fn)


def clear() -> None:
    """Drop every entry (tests; also releases what the builders
    captured)."""
    with _LOCK:
        _CACHE.clear()


def reset_stats_for_tests() -> None:
    for k in _STATS:
        _STATS[k] = 0


def stats() -> Dict[str, object]:
    """A point-in-time copy of the counters, with the live entry count
    and the build directory (the /healthz compile document and the smoke
    read this)."""
    out: Dict[str, object] = dict(_STATS)
    out["entries"] = len(_CACHE)
    out["persistent_dir"] = _PERSISTENT_DIR
    return out


def cache_keys() -> list:
    """Snapshot of the cached keys (profiling tools, tests)."""
    return list(_CACHE.keys())


# ---------------------------------------------------------------------------
# the kernel-build counters and the build directory
# ---------------------------------------------------------------------------

def _registry_inc(name: str, amount=None) -> None:
    try:
        from spark_rapids_tpu_torch.runtime import obs as _obs
        st = _obs.state()
        if st is None:
            return
        if amount is None:
            st.registry.counter(name).inc()
        else:
            st.registry.float_counter(name).inc(amount)
    except Exception:  # noqa: BLE001 - accounting never fails a build
        pass


def record_build(seconds: float) -> None:
    """One kernel library compiled (``ops/_build``): a compile and a
    persistent-cache miss."""
    with _LOCK:
        _STATS["xla_compiles"] += 1
        _STATS["xla_compile_ns"] += int(seconds * 1e9)
        _STATS["persistent_misses"] += 1
    _registry_inc("rapids_xla_compiles_total")
    _registry_inc("rapids_xla_compile_seconds_total", seconds)
    _registry_inc("rapids_persistent_cache_misses_total")
    if seconds >= 0.001:
        try:
            from spark_rapids_tpu_torch.runtime import trace as _tr
            _tr.instant("xlaCompile", cat="compile",
                        args={"seconds": round(seconds, 4)},
                        level=_tr.MODERATE)
        except Exception:  # noqa: BLE001 - tracing is advisory
            pass


def record_load_hit() -> None:
    """One kernel library found built on disk and only loaded: a
    persistent-cache hit."""
    with _LOCK:
        _STATS["persistent_hits"] += 1
    _registry_inc("rapids_persistent_cache_hits_total")


def build_root() -> Optional[str]:
    """The directory named by spark.rapids.compile.cacheDir, or None for
    the default (``ops/_build.BUILD_ROOT``)."""
    return _PERSISTENT_DIR


def configure(conf) -> None:
    """Apply the session's spark.rapids.compile.cacheDir (idempotent;
    called from the session). Process-global: the first directory named
    wins, and a later session naming another one keeps the first
    (logged)."""
    global _PERSISTENT_DIR
    from spark_rapids_tpu_torch import config as C
    d = str(conf.get(C.COMPILE_CACHE_DIR) or "").strip()
    if not d:
        return
    d = os.path.abspath(d)
    if _PERSISTENT_DIR is not None:
        if d != _PERSISTENT_DIR:
            import logging
            logging.getLogger("spark_rapids_tpu_torch").warning(
                "spark.rapids.compile.cacheDir=%s ignored: the kernels "
                "already build into %s", d, _PERSISTENT_DIR)
        return
    os.makedirs(d, exist_ok=True)
    _PERSISTENT_DIR = d


def reset_build_dir_for_tests() -> None:
    global _PERSISTENT_DIR
    _PERSISTENT_DIR = None


def doc() -> Dict[str, object]:
    """The /healthz compile document: the keyed cache's hits, misses and
    entries, and the kernel libraries' builds, build seconds, loads from
    disk and the build directory."""
    s = stats()
    return {
        "warm_entries": s["entries"],
        "hits": s["hits"],
        "misses": s["misses"],
        "compile_seconds": round(s["compile_ns"] / 1e9, 3),
        "xla_compiles": s["xla_compiles"],
        "xla_compile_seconds": round(s["xla_compile_ns"] / 1e9, 3),
        "persistent_dir": s["persistent_dir"],
        "persistent_hits": s["persistent_hits"],
        "persistent_misses": s["persistent_misses"],
    }
