"""Kernel cost auditor: bytes and operations a dispatch moves, and the roofline.

Counterpart of ``spark_rapids_tpu/analysis/kernel_audit.py``. The JAX
package reads XLA's ``cost_analysis()`` once for each (entry, argument
shape signature), at trace time. Eager PyTorch has no trace, so the count
is made by running a dispatch under a counting
``torch.utils._python_dispatch.TorchDispatchMode``.

Where each count is made
------------------------
``runtime/compile_cache.get`` resolves every per-batch stage function
(``exec/fuse.fused`` and ``exec/compiled.run_stage``); with the audit
armed it hands back :func:`wrap`'s dispatch wrapper. The wrapper computes
the call's input signature, the tuple of (dtype, shape) of the tensor
leaves passed in (numpy planes and byte strings of a host batch count as
leaves too; a lazy row count as a marker), tallies one dispatch of
(entry, signature) into the active query, and runs the FIRST call of each
(entry, signature) under the counting mode, entered on the thread that
dispatches (the mode stack is thread-local, and pipeline producers and
task waves run stages on other threads). Later calls of a known signature
cost the signature walk and one dict increment.

What the mode charges an aten op
--------------------------------
- **Bytes:** the bytes of its tensor inputs and outputs. In eager mode
  every op is its own kernel that reads its operands from device memory
  and writes its result back, so the sum is the traffic the card moves,
  not a model of it.
- **Operations:** ``torch.utils.flop_counter``'s formula where it has one
  (products); else one per output element for a pointwise op, and one per
  element of the largest input for every other op that reads a tensor
  (reductions, scans, sorts, gathers, scatters).
- **Nothing:** views and other aliasing ops, allocations (``empty*``),
  ``_local_scalar_dense`` and stream bookkeeping.
- **Copies between the host and the card** are PCIe traffic, not device
  memory traffic: they are counted apart (``pcie_bytes``) and kept out of
  the roofline's bytes. On the CPU such a copy does not dispatch at all,
  so the bytes agree between the CPU and the card.
- **The four hand kernels** (``KERNEL_PRIMITIVES``) are charged by
  formula (``KERNEL_COSTS``, the bounds ``chip_smoke.py`` uses), and the
  aten ops inside their wrappers (the plain version on the CPU, the
  output allocation on the card) are not counted. A query's charge is
  therefore the same on the CPU as on the card: the work is read the same
  whatever implements it.

The charge depends only on (entry, signature)
---------------------------------------------
An op whose output size depends on the values (``nonzero``,
``masked_select``, ``unique``, a boolean index: the ops tagged
``dynamic_output_shape``) is charged at the capacity bound of its input,
and an op reading such an output charges every operand of the same
leading size at that bound. bitslice's word reads are charged at the
whole word plane. The JAX package's own history shows why: auditing
whichever batch arrives first is nondeterministic across threads. What
the mode cannot see is a size computed on the host from a value read off
the card (a row count turned into a capacity); such a size is charged as
the audited call found it.

Per-query accounting
--------------------
:func:`note` tallies (entry, signature) -> dispatches into the active
query (one dict increment under a lock; with the audit off,
``compile_cache`` pays one module-global None check, the
``fuse._DISPATCH_HOOK`` pattern). :func:`finish_query` joins the tally
with the record table: each (entry, signature) is charged its own record
times its dispatches, exactly, with no mean-of-shapes apportioning. An
entry built while the audit was off is a finding (the JAX package's
"warm unaudited entry" rule): :func:`clear_for_cold_audit` rebuilds the
keyed cache so an audited cold run is complete.

:func:`roofline` joins a query's audited bytes and operations with
``attribution.classify_exec_times`` exactly as the JAX package joins
them: achieved GB/s and GFLOP/s per group, their share of
spark.rapids.obs.audit.peak*, a memory/compute/dispatch-overhead verdict
and the bucket ladder's padding exposure. Port difference in what the
seconds mean: the attribution's ``device_compute`` is the host's issue
time in the port (ROADMAP, PERF.md §7), so the achieved rates read low
where the card runs behind the host. Surfaced in ``explain("analyze")``,
history records, ``rapids_roofline_*`` gauges, the live console and
``tools/torch_roofline_report.py``.

Golden signatures: ``tools/torch_gen_cost_signatures.py`` pins the cost
signature of the NDS probe's first queries on the CPU
(``tests/torch_cost_signatures.json``; fresh session,
``gen_tables(0.002, seed=7)``, cleared caches, sorted query order).
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.analysis import sanitizer as _san

#: Modules that launch a hand kernel (package-relative paths): every
#: module that loads a ``csrc/*.cu`` library through ``ops/_build.load``
#: must be registered here (a test holds the roster), so the audit's
#: coverage statement, "every kernel launch is charged", is enforced.
KERNEL_PRIMITIVES: Dict[str, str] = {
    "ops/bitslice.py": "bitslice_u32: Parquet bit unpacking "
                       "(csrc/bitslice.cu)",
    "ops/case_map.py": "ASCII upper/lower of a byte plane "
                       "(csrc/case_map.cu)",
    "ops/murmur3_kernel.py": "Spark murmur3 of an int32 plane "
                             "(csrc/murmur3.cu)",
    "ops/segsum.py": "sorted segmented sums over digit lanes "
                     "(csrc/segsum.cu)",
}


def _murmur3_cost(values, seed) -> Tuple[int, int]:
    n = values.numel()
    return n * (12 if hasattr(seed, "numel") else 8), n


def _segsum_cost(gid, payload, outcap) -> Tuple[int, int]:
    return (gid.numel() * 4 + payload.numel() * 2
            + int(outcap) * payload.shape[0] * 4), payload.numel()


def _bitslice_cost(words, bitoff, mask) -> Tuple[int, int]:
    # chip_smoke.py's bound reads the words up to the offsets' maximum, a
    # value on the card; the audit charges the whole plane, its capacity
    n = bitoff.numel()
    if not n:
        return 0, 0
    return n * 16 + 4 * words.numel(), n


def _case_map_cost(raw, upper) -> Tuple[int, int]:
    n = raw.numel()
    return 2 * n, n


#: (bytes, operations) one launch of each hand kernel is charged, from the
#: operands its wrapper was given: each input read once, each output
#: written once, one operation an element
KERNEL_COSTS: Dict[str, Callable[..., Tuple[int, int]]] = {
    "murmur3_int32": _murmur3_cost,
    "segsum": _segsum_cost,
    "bitslice": _bitslice_cost,
    "case_map": _case_map_cost,
}

#: audit families whose device time lands in the attribution 'shuffle'
#: bucket (the exchanges' partitioning steps); everything else is
#: 'device_compute'
_SHUFFLE_FAMILY_MARKERS = ("exchange", "partition", "shuffle")

#: findings list hard cap (a pathological run must not grow unbounded)
_MAX_FINDINGS = 200

_LOCK = _san.lock("analysis.kernel_audit")

_ENABLED = False
_PEAK_GBPS = 3350.0
_PEAK_GFLOPS = 66900.0
_OVERHEAD_FACTOR = 10.0

#: full entry key (exec class, key, conf fingerprint) -> {signature:
#: record}. Process-global, persisting across queries like the keyed
#: cache it mirrors.
_RECORDS: Dict[Tuple, Dict[Tuple, dict]] = {}

#: full entry keys whose stage function was built while the audit was
#: armed; a dispatch of any other entry is unaudited (a finding)
_BUILT_ARMED: set = set()

#: the ACTIVE query's dispatch tally ((entry, signature) -> count); None
#: when no top-level action is running (the attribution aggregate's
#: pattern, with its concurrent-queries limit)
_AGG: Optional[Dict[Tuple, int]] = None

_FINDINGS: List[str] = []

_STATS = {"audited_shapes": 0, "resolved": 0, "resolve_failures": 0}

#: per thread: the stack of counting frames (None = a dispatch inside an
#: audited call whose own charge is counted elsewhere, or a hand
#: kernel's wrapper) and the depth of entered counting modes
_TLS = threading.local()


def enabled() -> bool:
    return _ENABLED


def configure(conf) -> None:
    """Apply the session conf (session construction and
    ``prepare_execution``): arm or disarm the audit and publish the
    roofline peaks. Arming installs this module as ``compile_cache``'s
    auditor; disarming uninstalls it."""
    global _ENABLED, _PEAK_GBPS, _PEAK_GFLOPS, _OVERHEAD_FACTOR
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.runtime import compile_cache as _cc
    _PEAK_GBPS = float(conf.get(C.OBS_AUDIT_PEAK_GBPS))
    _PEAK_GFLOPS = float(conf.get(C.OBS_AUDIT_PEAK_GFLOPS))
    _OVERHEAD_FACTOR = float(conf.get(C.OBS_AUDIT_OVERHEAD_FACTOR))
    on = bool(conf.get(C.OBS_AUDIT_ENABLED))
    if on == _ENABLED:
        return
    _ENABLED = on
    _cc.set_auditor(_MODULE if on else None)


def set_enabled(on: bool) -> None:
    """Direct arm or disarm (tests and tools; ``configure`` is the conf
    path)."""
    global _ENABLED
    from spark_rapids_tpu_torch.runtime import compile_cache as _cc
    _ENABLED = bool(on)
    _cc.set_auditor(_MODULE if _ENABLED else None)


def reset_for_tests(drop_records: bool = False) -> None:
    """Disarm and clear the per-query state. Records are kept by default:
    they mirror the process-wide keyed cache. ``drop_records=True`` pairs
    with ``compile_cache.clear()`` (see ``clear_for_cold_audit``)."""
    global _AGG
    set_enabled(False)
    with _LOCK:
        _AGG = None
        del _FINDINGS[:]
        if drop_records:
            _RECORDS.clear()
            _BUILT_ARMED.clear()
            for k in _STATS:
                _STATS[k] = 0


def clear_for_cold_audit() -> None:
    """Drop the keyed stage cache and the record table together, so the
    next audited run rebuilds every entry under the audit and is
    accounting-complete from a cold start (the golden generator's, the
    smoke's and the cold-prefix test's preamble)."""
    from spark_rapids_tpu_torch.runtime import compile_cache as _cc
    _cc.clear()
    with _LOCK:
        _RECORDS.clear()
        _BUILT_ARMED.clear()
        del _FINDINGS[:]


def findings() -> List[str]:
    with _LOCK:
        return list(_FINDINGS)


def stats() -> Dict[str, int]:
    with _LOCK:
        out = dict(_STATS)
        out["entries"] = len(_RECORDS)
        out["shapes"] = sum(len(v) for v in _RECORDS.values())
        out["pending"] = sum(1 for v in _RECORDS.values()
                             for r in v.values() if r.get("pending"))
        out["findings"] = len(_FINDINGS)
    return out


def _finding(msg: str) -> None:
    with _LOCK:
        if len(_FINDINGS) < _MAX_FINDINGS:
            _FINDINGS.append(msg)


# ---------------------------------------------------------------------------
# input signatures
# ---------------------------------------------------------------------------

_SCALARS = (int, float, bool, str, type(None), complex)


def _leaves(obj, out: list, depth: int = 0) -> None:
    """The leaves of a dispatch's arguments (or an op's), in a fixed
    order: tensors, numpy arrays and byte strings of a host batch, and
    lazy row counts, found through lists, tuples, dicts and the port's own
    objects (a batch, a column, a layout). Plain Python scalars (a
    partition id, a carry, a host row count) are not leaves."""
    import torch
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return
    if isinstance(obj, _SCALARS) or depth > 6:
        return
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _leaves(x, out, depth + 1)
        return
    if isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            _leaves(obj[k], out, depth + 1)
        return
    if isinstance(obj, (bytes, bytearray, memoryview)) \
            or type(obj).__name__ in ("ndarray", "LazyRowCount"):
        out.append(obj)
        return
    if not (type(obj).__module__ or "").startswith("spark_rapids_tpu_torch"):
        return
    fields = getattr(type(obj), "__dataclass_fields__", None)
    if fields is not None:
        names = list(fields)
    else:
        names = list(getattr(obj, "__dict__", {}))
        for cls in type(obj).__mro__:
            names += [s for s in getattr(cls, "__slots__", ())
                      if s not in names]
    for name in names:
        _leaves(getattr(obj, name, None), out, depth + 1)


def _leaf_sig(x) -> Tuple:
    import torch
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).replace("torch.", ""), tuple(x.shape))
    tname = type(x).__name__
    if tname == "ndarray":
        return ("np." + str(x.dtype), tuple(x.shape))
    if tname == "LazyRowCount":
        return ("rows", ())
    return ("bytes", (len(x),))


def signature(args, kwargs=None) -> Tuple:
    """The input signature of a dispatch: (dtype, shape) of each leaf."""
    out: list = []
    _leaves((args, kwargs or {}), out)
    return tuple(_leaf_sig(x) for x in out)


def _tensor_leaves(obj, out: list) -> None:
    import torch
    found: list = []
    _leaves(obj, found)
    out.extend(x for x in found if isinstance(x, torch.Tensor))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the counting dispatch mode
# ---------------------------------------------------------------------------

_FREE_OPS = frozenset((
    "aten::empty.memory_format", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::_local_scalar_dense",
    "aten::record_stream", "aten::resize_", "aten::set_.source_Storage",
    "aten::set_.source_Storage_storage_offset", "aten::set_.source_Tensor",
    "aten::_unsafe_view", "aten::lift_fresh", "aten::detach",
    "aten::alias", "aten::is_pinned", "aten::_pin_memory",
    "aten::is_nonzero", "aten::sym_size.int", "aten::sym_numel",
    "aten::sym_stride.int", "aten::sym_storage_offset",
))

_COPY_OPS = frozenset(("aten::_to_copy", "aten::copy_", "aten::_copy_from",
                       "aten::_copy_from_and_resize"))

_MODE_CLS = None


def _mode_cls():
    global _MODE_CLS
    if _MODE_CLS is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class CountingMode(TorchDispatchMode):
            """Charges each aten op run on this thread to the top
            counting frame (a None frame charges nothing)."""

            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                frames = getattr(_TLS, "frames", None)
                if frames and frames[-1] is not None:
                    try:
                        _charge(frames[-1], func, args, kwargs, out)
                    except Exception as e:  # noqa: BLE001 - the audit
                        # never fails a query
                        frames[-1]["errors"].append(
                            f"{func}: {type(e).__name__}: {e}")
                return out

        _MODE_CLS = CountingMode
    return _MODE_CLS


def _new_frame() -> dict:
    return {"bytes": 0, "flops": 0, "pcie_bytes": 0, "ops": {},
            "kernels": {}, "bounded": {}, "errors": []}


def _lead_bound(frame, t) -> Optional[Tuple[int, int]]:
    b = frame["bounded"].get(id(t))
    return (b[1], b[2]) if b is not None and b[0] is t else None


def _charged_numel(t, scale: Dict[int, int]) -> int:
    n = t.numel()
    if t.dim() and t.shape[0] in scale:
        lead = t.shape[0]
        per = n // lead if lead else 1
        return per * scale[lead]
    return n


def _charge(frame, func, args, kwargs, out) -> None:
    import torch
    name = func.name()
    if name in _FREE_OPS or func.is_view:
        return
    rets = func._schema.returns
    if rets and all(r.alias_info is not None and not r.alias_info.is_write
                    for r in rets):
        return  # an aliasing op (a view by another name)
    ins: list = []
    _tensor_leaves(args, ins)
    _tensor_leaves(kwargs, ins)
    outs: list = []
    _tensor_leaves(out, outs)
    if name in _COPY_OPS:
        devs = {t.device.type for t in ins + outs}
        if len(devs) > 1:
            frame["pcie_bytes"] += sum(_nbytes(t) for t in outs)
            return
    # data-dependent sizes: the capacity bound of the inputs
    scale: Dict[int, int] = {}
    for t in ins:
        b = _lead_bound(frame, t)
        if b is not None and b[1] > b[0]:
            scale[b[0]] = max(scale.get(b[0], 0), b[1])
    cap = max((t.numel() for t in ins), default=0)
    dynamic = torch.Tag.dynamic_output_shape in func.tags
    for o in outs:
        if not o.dim():
            continue
        lead = o.shape[0]
        if dynamic and cap > lead:
            bound = cap
        elif lead in scale:
            bound = scale[lead]
        else:
            continue
        frame["bounded"][id(o)] = (o, lead, bound)
        if dynamic and lead not in scale:
            scale[lead] = bound
    nbytes = sum(_charged_numel(t, scale) * t.element_size()
                 for t in ins + outs)
    flops = 0
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func.overloadpacket)
    if formula is not None:
        try:
            flops = int(formula(*args, **kwargs, out_val=out))
        except Exception:  # noqa: BLE001 - fall back to the element rule
            formula = None
    if formula is None:
        if torch.Tag.pointwise in func.tags:
            flops = sum(_charged_numel(t, scale) for t in outs)
        elif ins:
            flops = max(_charged_numel(t, scale) for t in ins)
    frame["bytes"] += nbytes
    frame["flops"] += flops
    slot = frame["ops"].setdefault(name, [0, 0])
    slot[0] += 1
    slot[1] += nbytes


def _frames() -> list:
    frames = getattr(_TLS, "frames", None)
    if frames is None:
        frames = _TLS.frames = []
    return frames


def charged(name: str, impl: Callable, *args):
    """Run a hand kernel's wrapper body ``impl(*args)``. Inside an audited
    dispatch the launch is charged ``KERNEL_COSTS[name]`` and the aten
    ops ``impl`` runs (its plain version, its allocations) are not
    counted; otherwise this is one thread-local read."""
    frames = getattr(_TLS, "frames", None)
    if not frames or frames[-1] is None:
        return impl(*args)
    frame = frames[-1]
    nbytes, flops = KERNEL_COSTS[name](*args)
    frame["bytes"] += nbytes
    frame["flops"] += flops
    slot = frame["kernels"].setdefault(name, [0, 0, 0])
    slot[0] += 1
    slot[1] += nbytes
    slot[2] += flops
    frames.append(None)
    try:
        return impl(*args)
    finally:
        frames.pop()


# ---------------------------------------------------------------------------
# the dispatch hook (installed into compile_cache)
# ---------------------------------------------------------------------------

def mark_built(full_key: Tuple) -> None:
    """A keyed entry was built while the audit is armed (compile_cache's
    miss path): its dispatches are audited."""
    with _LOCK:
        _BUILT_ARMED.add(full_key)


def wrap(full_key: Tuple, fn: Callable) -> Callable:
    """The dispatch wrapper compile_cache.get returns while the audit is
    armed: each call notes one dispatch of (entry, signature), and the
    first call of a signature of an entry built under the audit runs
    under the counting mode."""

    def audited(*args, **kwargs):
        if not _ENABLED:
            return fn(*args, **kwargs)
        sig = signature(args, kwargs)
        note(full_key, sig)
        frames = _frames()
        claim = False
        if full_key in _BUILT_ARMED:
            with _LOCK:
                shapes = _RECORDS.setdefault(full_key, {})
                if sig not in shapes:
                    shapes[sig] = {"pending": True}
                    _STATS["audited_shapes"] += 1
                    claim = True
        if not claim:
            if not getattr(_TLS, "modes", 0):
                return fn(*args, **kwargs)
            # inside another entry's audited call: this call's ops are
            # its own entry's, never the outer's
            frames.append(None)
            try:
                return fn(*args, **kwargs)
            finally:
                frames.pop()
        return _audit_call(full_key, sig, fn, args, kwargs, frames)

    return audited


def _audit_call(full_key, sig, fn, args, kwargs, frames):
    frame = _new_frame()
    frames.append(frame)
    depth = getattr(_TLS, "modes", 0)
    mode = None
    if not depth:
        mode = _mode_cls()()
        mode.__enter__()
    _TLS.modes = depth + 1
    ok = False
    try:
        out = fn(*args, **kwargs)
        ok = True
    finally:
        _TLS.modes = depth
        if mode is not None:
            mode.__exit__(None, None, None)
        frames.pop()
        if not ok:
            # a raised call (an OOM the retry framework replays, a
            # cancellation) leaves no record: the next call re-audits
            with _LOCK:
                _RECORDS.get(full_key, {}).pop(sig, None)
                _STATS["audited_shapes"] -= 1
    in_leaves: list = []
    _tensor_leaves((args, kwargs), in_leaves)
    out_leaves: list = []
    _tensor_leaves(out, out_leaves)
    rec = {
        "in_bytes": sum(_nbytes(t) for t in in_leaves),
        "out_bytes": sum(_nbytes(t) for t in out_leaves),
        "row_capacity": max([int(t.shape[0]) for t in in_leaves
                             if t.dim()] or [0]),
        "flops": float(frame["flops"]),
        "bytes_accessed": float(frame["bytes"]),
        "pcie_bytes": frame["pcie_bytes"],
        "ops": {k: tuple(v) for k, v in frame["ops"].items()},
        "kernels": {k: tuple(v) for k, v in frame["kernels"].items()},
        "error": "; ".join(frame["errors"][:3]) or None,
        "pending": False,
    }
    with _LOCK:
        _RECORDS.setdefault(full_key, {})[sig] = rec
        _STATS["resolved"] += 1
        if rec["error"]:
            _STATS["resolve_failures"] += 1
    if rec["error"]:
        _finding(f"cost count failed for {full_key[0]}: {rec['error']}")
    return out


def note(entry_key: Tuple, sig: Tuple = ()) -> None:
    """One dispatch of (entry, signature) into the active query's tally.
    No active query, or a warmup replay's thread: dropped."""
    if _AGG is None:
        return
    from spark_rapids_tpu_torch.runtime.obs import attribution as _attr
    if _attr.thread_suppressed():
        return  # a warmup replay: not this user query's dispatches
    with _LOCK:
        agg = _AGG
        if agg is not None:
            k = (entry_key, sig)
            agg[k] = agg.get(k, 0) + 1


#: what compile_cache stores as its auditor
_MODULE = sys.modules[__name__]


def resolve_pending() -> int:
    """The JAX package resolves queued cost analyses off the dispatch
    path here. The port counts a signature inside its first call, so
    nothing is queued; a record still pending belongs to a call that is
    still running. Returns the number resolved now: 0."""
    return 0


# ---------------------------------------------------------------------------
# padding-waste math (the bucket-ladder exposure)
# ---------------------------------------------------------------------------

#: plane itemsizes whose tile-aligned ladders a capacity may have come
#: from (None = the unaligned base ladder)
_LADDER_ITEMSIZES = (None, 1, 2, 4, 8)


def bucket_floor_live(capacity: int) -> Optional[int]:
    """Smallest live row count that buckets to ``capacity`` under the
    active shapes policy (None when ``capacity`` is off every ladder).
    The smallest floor over the per-itemsize ladders it lies on, so the
    reported waste is an upper bound."""
    from spark_rapids_tpu_torch.runtime import shapes
    cap = int(capacity)
    if cap <= 0:
        return None
    floors = []
    for itemsize in _LADDER_ITEMSIZES:
        if not shapes.is_bucketed(cap, 1, itemsize):
            continue
        lo, hi = 1, cap  # bucket_rows is monotone: bisect the threshold
        while lo < hi:
            mid = (lo + hi) // 2
            if shapes.bucket_rows(mid, 1, itemsize) >= cap:
                hi = mid
            else:
                lo = mid + 1
        floors.append(lo)
    return min(floors) if floors else None


def padding_waste(live_rows: int, capacity: int) -> float:
    """Fraction of ``capacity`` that is dead padding for a dispatch
    carrying ``live_rows`` live rows."""
    cap = int(capacity)
    if cap <= 0:
        return 0.0
    return max(0.0, (cap - int(live_rows)) / cap)


def max_padding_waste(capacity: int) -> float:
    """The ladder's worst-case waste ratio at ``capacity`` (0.0 off the
    ladder)."""
    floor = bucket_floor_live(capacity)
    if floor is None:
        return 0.0
    return padding_waste(floor, capacity)


# ---------------------------------------------------------------------------
# per-query summary and signature
# ---------------------------------------------------------------------------

def on_query_start(conf=None) -> None:
    """Open the active query's dispatch tally (a top-level collect). The
    session conf is applied first, so a mid-session ``conf.set`` arming
    the audit covers the very next query."""
    global _AGG
    if conf is not None:
        try:
            configure(conf)
        except Exception:  # noqa: BLE001 - prepare_execution re-raises
            pass
    if not _ENABLED:
        return
    with _LOCK:
        _AGG = {}


# A12: note_shards and _resolve_shards (the per-shard row skew of a
# sharded stage's waves, the summary's conditional "shards" key) come with
# multi-GPU execution.


def finish_query() -> Optional[dict]:
    """Close the active query and join its tally with the record table.
    Returns the query's audit summary (None when the audit is off or
    nothing dispatched)."""
    global _AGG
    with _LOCK:
        agg, _AGG = _AGG, None
    resolve_pending()
    if not agg:
        return None
    return _summarize(agg)


_CLASS_KEYS = ("dispatches", "entries", "shapes", "flops", "bytes_accessed",
               "in_bytes", "out_bytes", "padded_row_bytes_max_waste",
               "pcie_bytes")


def _summarize(agg: Dict[Tuple, int]) -> dict:
    classes: Dict[str, dict] = {}
    kernels: Dict[str, dict] = {}
    ops: Dict[str, float] = {}
    findings: List[str] = []
    entries_seen: Dict[str, set] = {}
    with _LOCK:
        for (entry_key, sig), count in sorted(
                agg.items(), key=lambda kv: (kv[0][0][0], repr(kv[0]))):
            family = entry_key[0]
            dst = classes.setdefault(family, {k: 0.0 if k not in (
                "dispatches", "entries", "shapes") else 0
                for k in _CLASS_KEYS})
            dst["dispatches"] += count
            seen = entries_seen.setdefault(family, set())
            if entry_key not in seen:
                seen.add(entry_key)
                dst["entries"] += 1
            rec = _RECORDS.get(entry_key, {}).get(sig)
            if rec is None or rec.get("pending"):
                findings.append(
                    f"{count} dispatch(es) of unaudited entry {family!r}: "
                    f"built before the audit armed; clear the keyed cache "
                    f"(clear_for_cold_audit) for complete accounting")
                continue
            dst["shapes"] += 1
            waste = max_padding_waste(rec.get("row_capacity") or 0)
            ib = rec.get("in_bytes") or 0
            dst["in_bytes"] += ib * count
            dst["padded_row_bytes_max_waste"] += ib * waste * count
            dst["flops"] += rec["flops"] * count
            dst["bytes_accessed"] += rec["bytes_accessed"] * count
            dst["out_bytes"] += (rec.get("out_bytes") or 0) * count
            dst["pcie_bytes"] += (rec.get("pcie_bytes") or 0) * count
            for kname, (n, kb, kf) in rec.get("kernels", {}).items():
                k = kernels.setdefault(kname, {"launches": 0, "bytes": 0,
                                               "flops": 0})
                k["launches"] += n * count
                k["bytes"] += kb * count
                k["flops"] += kf * count
            for oname, (_n, ob) in rec.get("ops", {}).items():
                ops[oname] = ops.get(oname, 0) + ob * count
    for msg in findings:
        _finding(msg)
    total = {k: 0 for k in _CLASS_KEYS}
    for c in classes.values():
        for k in total:
            total[k] += c[k]
    return {"classes": classes, "total": total, "kernels": kernels,
            "ops": ops, "query_findings": findings}


def family_bucket(family: str) -> str:
    """Which attribution bucket a family's device time lands in (the
    exchanges' partitioning steps time into 'shuffle')."""
    f = family.lower()
    if any(m in f for m in _SHUFFLE_FAMILY_MARKERS):
        return "shuffle"
    return "device_compute"


def query_signature(summary: Optional[dict]) -> Optional[dict]:
    """Canonical integer form of a query audit summary: what the golden
    cost-signature file pins."""
    if not summary:
        return None
    out = {}
    for family in sorted(summary["classes"]):
        c = summary["classes"][family]
        out[family] = {
            "dispatches": int(c["dispatches"]),
            "entries": int(c["entries"]),
            "shapes": int(c["shapes"]),
            "flops": int(round(c["flops"])),
            "bytes_accessed": int(round(c["bytes_accessed"])),
            "in_bytes": int(round(c["in_bytes"])),
            "out_bytes": int(round(c["out_bytes"])),
        }
    return out


#: the signature dimensions a golden diff reports, in severity order
_SIG_DIMS = ("dispatches", "entries", "shapes", "flops",
             "bytes_accessed", "in_bytes", "out_bytes")


def compare_signature(query: str, golden: Optional[dict],
                      got: Optional[dict],
                      rel_tol: float = 0.0) -> List[str]:
    """Diff one query's cost signature against its golden pin, naming
    the dimension that moved per family. ``rel_tol`` admits a relative
    slack on the byte and operation dimensions, never on the counts."""
    diffs: List[str] = []
    golden, got = golden or {}, got or {}
    for family in sorted(set(golden) | set(got)):
        g, a = golden.get(family), got.get(family)
        if g is None:
            diffs.append(f"{query}: unexpected new kernel class "
                         f"{family!r} ({a})")
            continue
        if a is None:
            diffs.append(f"{query}: kernel class {family!r} vanished "
                         f"(golden: {g})")
            continue
        for dim in _SIG_DIMS:
            gv, av = g.get(dim, 0), a.get(dim, 0)
            if gv == av:
                continue
            if rel_tol and dim in ("flops", "bytes_accessed", "in_bytes",
                                   "out_bytes"):
                if abs(av - gv) <= rel_tol * max(abs(gv), 1):
                    continue
            diffs.append(f"{query}: {family} {dim} regressed "
                         f"{gv} -> {av}")
    return diffs


# ---------------------------------------------------------------------------
# the roofline join
# ---------------------------------------------------------------------------

def roofline(summary: Optional[dict], snaps: Optional[Dict[str, dict]],
             duration_ns: int,
             extra: Optional[Dict[str, int]] = None) -> Optional[dict]:
    """Join one query's audited bytes and operations with its measured
    seconds, as the JAX package joins them: ``attribution.
    classify_exec_times`` over the same metric snapshot, with the same
    compile subtraction, so the 'device_compute' group's seconds equal
    the attribution bucket's by construction. Groups 'device_compute' and
    'shuffle', each with achieved GB/s and GFLOP/s, their share of the
    configured peaks, a verdict and the padding exposure."""
    if not summary:
        return None
    from spark_rapids_tpu_torch.runtime.obs import attribution as _attr
    per_cls = _attr.classify_exec_times(snaps)
    bucket_ns = {"device_compute": 0, "shuffle": 0}
    for buckets in per_cls.values():
        for b in bucket_ns:
            bucket_ns[b] += buckets.get(b, 0)
    _attr.subtract_compile(bucket_ns, (extra or {}).get("compile", 0))
    groups = {}
    for gname in ("device_compute", "shuffle"):
        gbytes = gflops = gin = gdisp = gwaste = 0.0
        for family, c in summary["classes"].items():
            if family_bucket(family) != gname:
                continue
            gbytes += c["bytes_accessed"]
            gflops += c["flops"]
            gin += c["in_bytes"]
            gdisp += c["dispatches"]
            gwaste += c["padded_row_bytes_max_waste"]
        secs = bucket_ns[gname] / 1e9
        if not gdisp and not secs:
            continue
        est_mem_s = gbytes / (_PEAK_GBPS * 1e9) if _PEAK_GBPS else 0.0
        est_flop_s = gflops / (_PEAK_GFLOPS * 1e9) if _PEAK_GFLOPS \
            else 0.0
        est = max(est_mem_s, est_flop_s)
        if secs > 0 and est > 0 and secs > _OVERHEAD_FACTOR * est:
            bound = "dispatch_overhead"
        elif est_mem_s >= est_flop_s:
            bound = "memory"
        else:
            bound = "compute"
        achieved_gbps = gbytes / secs / 1e9 if secs > 0 else 0.0
        achieved_gflops = gflops / secs / 1e9 if secs > 0 else 0.0
        groups[gname] = {
            "seconds": round(secs, 9),
            "dispatches": int(gdisp),
            "bytes_accessed": int(round(gbytes)),
            "flops": int(round(gflops)),
            "achieved_gbps": round(achieved_gbps, 4),
            "achieved_gflops": round(achieved_gflops, 4),
            "roofline_pct_bw": round(100.0 * achieved_gbps / _PEAK_GBPS, 4)
            if _PEAK_GBPS else None,
            "roofline_pct_flops": round(100.0 * achieved_gflops
                                        / _PEAK_GFLOPS, 4)
            if _PEAK_GFLOPS else None,
            "bound": bound,
            "padding_waste_ratio": round(gwaste / gin, 4) if gin else 0.0,
        }
    if not groups:
        return None
    tot_bytes = sum(g["bytes_accessed"] for g in groups.values())
    tot_flops = sum(g["flops"] for g in groups.values())
    tot_secs = sum(g["seconds"] for g in groups.values())
    return {
        "wall_seconds": round(int(duration_ns) / 1e9, 9),
        "peak_gbps": _PEAK_GBPS,
        "peak_gflops": _PEAK_GFLOPS,
        "groups": groups,
        "total": {
            "seconds": round(tot_secs, 9),
            "bytes_accessed": int(tot_bytes),
            "flops": int(tot_flops),
            "achieved_gbps": round(tot_bytes / tot_secs / 1e9, 4)
            if tot_secs > 0 else 0.0,
            "roofline_pct_bw": round(100.0 * tot_bytes / tot_secs / 1e9
                                     / _PEAK_GBPS, 4)
            if tot_secs > 0 and _PEAK_GBPS else 0.0,
        },
        "kernels": {family: {
            "bucket": family_bucket(family),
            "dispatches": int(c["dispatches"]),
            "bytes_accessed": int(round(c["bytes_accessed"])),
            "flops": int(round(c["flops"])),
            "est_memory_seconds": round(
                c["bytes_accessed"] / (_PEAK_GBPS * 1e9), 9)
            if _PEAK_GBPS else None,
            "est_compute_seconds": round(
                c["flops"] / (_PEAK_GFLOPS * 1e9), 9)
            if _PEAK_GFLOPS else None,
        } for family, c in sorted(summary["classes"].items())},
    }


def render_text(doc: Optional[dict], width: int = 24) -> List[str]:
    """Roofline lines for ``explain("analyze")``."""
    if not doc:
        return []
    lines = [f"-- roofline (audit; peaks {doc['peak_gbps']:g} GB/s, "
             f"{doc['peak_gflops']:g} GFLOP/s) --"]
    for gname in sorted(doc.get("groups", {})):
        g = doc["groups"][gname]
        pct = g.get("roofline_pct_bw") or 0.0
        bar = "#" * max(1, int(min(pct, 100.0) / 100.0 * width)) \
            if pct > 0 else ""
        lines.append(
            f"  {gname:<15} {g['seconds']:>8.3f}s "
            f"{g['achieved_gbps']:>9.2f} GB/s ({pct:>6.3f}% roofline) "
            f"{g['achieved_gflops']:>9.2f} GFLOP/s  {g['bound']}-bound"
            f"  waste<={g['padding_waste_ratio'] * 100:.0f}%"
            + (f"  {bar}" if bar else ""))
    t = doc.get("total") or {}
    if t:
        lines.append(
            f"  {'total':<15} {t['seconds']:>8.3f}s "
            f"{t['achieved_gbps']:>9.2f} GB/s "
            f"({t['roofline_pct_bw']:>6.3f}% roofline) "
            f"over {sum(g['dispatches'] for g in doc['groups'].values())}"
            f" audited dispatches")
    return lines


def records_doc(limit: int = 0) -> List[Dict[str, Any]]:
    """Flat view of the record table (report tools): one row per
    (entry, signature)."""
    out = []
    with _LOCK:
        for entry_key, shapes in _RECORDS.items():
            for sig, rec in shapes.items():
                if rec.get("pending"):
                    continue
                out.append({
                    "family": entry_key[0],
                    "shape_sig": repr(sig),
                    "row_capacity": rec.get("row_capacity"),
                    "in_bytes": rec.get("in_bytes"),
                    "out_bytes": rec.get("out_bytes"),
                    "flops": rec.get("flops"),
                    "bytes_accessed": rec.get("bytes_accessed"),
                    "pcie_bytes": rec.get("pcie_bytes"),
                    "kernels": dict(rec.get("kernels") or {}),
                    "max_padding_waste": max_padding_waste(
                        rec.get("row_capacity") or 0),
                    "error": rec.get("error"),
                })
    out.sort(key=lambda r: (-(r["bytes_accessed"] or 0), r["family"]))
    return out[:limit] if limit else out
