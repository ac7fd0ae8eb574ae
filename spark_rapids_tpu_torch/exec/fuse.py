"""The per-batch dispatch choke point, and the stage bodies fusion composes.

Counterpart of ``spark_rapids_tpu/exec/fuse.py``. ``fused(key, builder)``
resolves an operator's per-batch stage function through the keyed stage
cache (``runtime/compile_cache.py``) and wraps it in the failure-domain
hooks every batch's device work passes: the cooperative cancel
checkpoint, the dispatch watchdog's guard and, inside it, the
``device.dispatch`` fault site (so a wedge there is what the watchdog
exists to detect). ``set_dispatch_hook`` installs a counter called with
the key of every dispatch (the dispatch-budget tests), and
``notify_dispatch`` reports a dispatch issued outside ``fused``
(``exec/compiled.run_stage``).

``StageBody`` separates a narrow operator's per-batch body from its
driver loop, so ``exec/stage_fusion.py`` can compose several into one
function a batch. Port difference: the JAX package's composed body is
traced into one XLA computation; here it runs eagerly, member after
member, on the current CUDA stream, and on the card each member still
launches its own kernels. What fusion keeps is one host call a batch
through this choke point, one cancel checkpoint, fault site and watchdog
guard, one ``stageDispatches`` count, and the keyed function a later
CUDA-graph capture would replay per (stage key, capacity bucket).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from spark_rapids_tpu_torch.runtime import compile_cache as _cc
from spark_rapids_tpu_torch.runtime import faults as _faults
from spark_rapids_tpu_torch.runtime import lifecycle as _lc
from spark_rapids_tpu_torch.runtime import watchdog as _watchdog

#: test/diagnostic hook called with the key of every dispatch issued
#: through fused() or reported by notify_dispatch; None in production
_DISPATCH_HOOK: Optional[Callable[[Tuple], None]] = None


def set_dispatch_hook(hook: Optional[Callable[[Tuple], None]]) -> None:
    global _DISPATCH_HOOK
    _DISPATCH_HOOK = hook


def notify_dispatch(key: Tuple) -> None:
    """Report a dispatch issued outside fused() to the budget hook."""
    if _DISPATCH_HOOK is not None:
        _DISPATCH_HOOK(key)


def fused(key: Tuple, builder: Callable[[], Callable]) -> Callable:
    """The stage function of ``key`` (built by ``builder`` on a miss),
    wrapped in the per-batch hooks. key[0] names the operator family
    ("fused_stage", "hash_exchange_compact", ...) and doubles as the
    cache's exec class. With nothing armed the wrapper is the cancel
    checkpoint alone."""
    exec_class = key[0] if key and isinstance(key[0], str) else "fuse"
    fn = _cc.get(exec_class, key, builder)
    if _DISPATCH_HOOK is None and not _faults.armed("device.dispatch") \
            and not _watchdog.active():

        def checked(*args, **kwargs):
            _lc.check_current()
            return fn(*args, **kwargs)

        return checked

    def counted(*args, **kwargs):
        _lc.check_current()
        if _DISPATCH_HOOK is not None:
            notify_dispatch(key)
        with _watchdog.guard("device.dispatch"):
            _faults.site("device.dispatch")
            return fn(*args, **kwargs)

    return counted


def stage_range(name: str):
    """A context factory: a ``torch.profiler`` range named ``name`` while
    a profiler records (so a trace can count the kernels a fused stage
    launches a batch and its host time), else a no-op (one flag read)."""
    import contextlib

    import torch

    if not getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return contextlib.nullcontext
    return lambda: torch.profiler.record_function(name)


def clear_cache() -> None:
    """Drop every cached stage function (delegates to the process-wide
    keyed cache)."""
    _cc.clear()


class StageBody:
    """One fusable operator's per-batch body, separated from its driver
    loop so ``exec/stage_fusion.py`` can compose several into one call.

    ``builder()`` returns ``fn(batch, pid, carry) -> (batch, errors,
    carry)``: ``pid`` is the partition index, ``carry`` the operator's
    per-partition loop state (a projection's row base, a limit's
    remaining budget; 0 for carry-free operators) and ``errors`` the ANSI
    error planes as a list of (code, mask). Builders capture expressions,
    static settings and the device, never the operator: its child tree
    can pin cached batches in the process-wide cache.

    ``bounds_map`` maps host-side column bounds (``ColumnVector.bounds``)
    across the operator: the input's per column -> the output's."""

    __slots__ = ("key", "builder", "carry_init", "bounds_map", "has_carry",
                 "exhausts", "name")

    def __init__(self, key: Tuple, builder: Callable[[], Callable],
                 carry_init: Optional[Callable] = None,
                 bounds_map: Optional[Callable] = None,
                 has_carry: bool = False, exhausts: bool = False,
                 name: str = ""):
        self.key = key
        self.builder = builder
        self.carry_init = carry_init
        self.bounds_map = bounds_map
        self.has_carry = has_carry
        #: carry == 0 means every later batch is all-dead (a limit's
        #: remaining budget): the fused driver may stop consuming input
        self.exhausts = exhausts
        self.name = name

    def init_carry(self):
        if self.carry_init is None:
            return 0
        return self.carry_init()
