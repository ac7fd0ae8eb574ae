"""Range-compressed packed keys and the scatter-bucket reductions.

Counterpart of ``spark_rapids_tpu/ops/radix.py`` (``PackSpec``,
``probe_ranges``, ``plan_packing``, ``pack_keys``, the order-faithful
``pack_keys_sort`` of the window's packed route, ``unpack_keys``,
``_exponent_scale``, ``bucket_layout`` with the ``bucket_*`` reductions,
and ``group_layout`` with the ``seg_*`` reductions). All group keys pack
into one int64 plane: per key, ``code = value - min + 1`` in ``bits``
bits, slot 0 meaning NULL. When the packed key has at most BUCKET_BITS
bits, every reduction is a scatter into the dense bucket space; wider
keys sort (``group_layout``) and reduce by differences of inclusive
cumsums at the groups' first and last rows. Float sums are exact integer
digit scatters or limb cumsums either way, so the result matches the JAX
package bit for bit.

Where the JAX package picks a digit width with ``lax.cond`` on the
deepest bucket, this module reads that count on the host once per
reduction (one sync each, marked where it happens).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector

MAX_PACK_BITS = 62
_SENTINEL = 1 << MAX_PACK_BITS
_MIN64 = -(1 << 63)

KIND_INT = "int"
KIND_DICT = "dict"
KIND_BOOL = "bool"

#: max packed bits for the scatter-bucket route (8M-slot targets)
BUCKET_BITS = 23
_LIMB_COUNT_LIMIT = 1 << 14
_INT_LIMB_COUNT_LIMIT = 1 << 15
_LIMB2_COUNT_LIMIT = 1 << 6


@dataclass(frozen=True)
class PackSpec:
    kinds: Tuple[str, ...]
    bits: Tuple[int, ...]

    @property
    def total_bits(self) -> int:
        return sum(self.bits)


#: a decimal packs as its unscaled int64 value
_INT_KINDS = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type, T.DateType,
              T.DecimalType)


def packable_dtype(c: ColumnVector) -> Optional[str]:
    if c.is_dict:
        # codes stand for values only when the vocabulary holds each string
        # once: a vocabulary that may repeat one (upper() of a dictionary,
        # a gathered flat column) goes to the sort route, which keys on
        # the string's bytes
        return KIND_DICT if c.dict_unique else None
    if isinstance(c.dtype, T.BooleanType):
        return KIND_BOOL
    if isinstance(c.dtype, _INT_KINDS):
        return KIND_INT
    return None


def static_kinds(key_cols: Sequence[ColumnVector]) -> Optional[List[str]]:
    kinds = [packable_dtype(c) for c in key_cols]
    return None if any(k is None for k in kinds) else kinds


def probe_ranges(key_cols: Sequence[ColumnVector],
                 live: torch.Tensor) -> torch.Tensor:
    """int64 [min_0, max_0, min_1, max_1, ...] over valid live rows of the
    KIND_INT keys (zeros for the others)."""
    out = []
    for c in key_cols:
        if packable_dtype(c) != KIND_INT:
            out.extend([torch.zeros((), dtype=torch.int64, device=live.device)]
                       * 2)
            continue
        v = c.data.to(torch.int64)
        valid = live if c.validity is None else (live & c.validity)
        lo = torch.where(valid, v, 2 ** 62).min()
        hi = torch.where(valid, v, -2 ** 62).max()
        out.extend([torch.minimum(lo, hi), hi])
    return torch.stack(out)


def _round_bits(b: int) -> int:
    return max(2, -(-b // 2) * 2)


def plan_packing(key_cols: Sequence[ColumnVector],
                 ranges_host: np.ndarray) -> Optional[PackSpec]:
    """Host side: the static bit layout from the fetched ranges."""
    kinds = static_kinds(key_cols)
    if kinds is None:
        return None
    bits = []
    for i, (c, kind) in enumerate(zip(key_cols, kinds)):
        if kind == KIND_DICT:
            span = max(int(c.dict_size) - 1, 0)
        elif kind == KIND_BOOL:
            span = 1
        else:
            span = max(int(ranges_host[2 * i + 1]) - int(ranges_host[2 * i]),
                       0)
        bits.append(_round_bits(int(span + 2).bit_length()))
    spec = PackSpec(tuple(kinds), tuple(bits))
    return None if spec.total_bits > MAX_PACK_BITS else spec


def pack_keys(spec: PackSpec, key_cols: Sequence[ColumnVector],
              mins: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """One int64 plane of range-compressed key codes; dead rows get the
    above-range sentinel."""
    packed = torch.zeros(live.shape[0], dtype=torch.int64, device=live.device)
    for i, (c, kind, b) in enumerate(zip(key_cols, spec.kinds, spec.bits)):
        if kind == KIND_DICT:
            code = c.data["codes"].to(torch.int64)
        elif kind == KIND_BOOL:
            code = c.data.to(torch.int64)
        else:
            code = c.data.to(torch.int64) - mins[2 * i]
        code = code + 1  # slot 0 = NULL
        if c.validity is not None:
            code = torch.where(c.validity, code, 0)
        packed = (packed << b) | code.clamp(0, (1 << b) - 1)
    return torch.where(live, packed, _SENTINEL)


def pack_keys_sort(spec: PackSpec, key_cols: Sequence[ColumnVector],
                   mins: torch.Tensor, live: torch.Tensor,
                   flags: Sequence[Tuple[bool, bool]]) -> torch.Tensor:
    """The order-faithful ``pack_keys``: per key, (ascending, nulls_first)
    sets the field's encoding, so an ascending sort of the plane is the
    requested lexicographic order. Dictionary codes are not value-ordered,
    so callers put dictionary keys only in grouping positions, with
    (True, True), where any consistent order will do."""
    packed = torch.zeros(live.shape[0], dtype=torch.int64, device=live.device)
    for i, (c, kind, b, (asc, nf)) in enumerate(
            zip(key_cols, spec.kinds, spec.bits, flags)):
        if kind == KIND_DICT:
            v = c.data["codes"].to(torch.int64)
            lo, hi = 0, max(int(c.dict_size) - 1, 0)
        elif kind == KIND_BOOL:
            v = c.data.to(torch.int64)
            lo, hi = 0, 1
        else:
            v = c.data.to(torch.int64)
            lo, hi = mins[2 * i], mins[2 * i + 1]
        span_max = (1 << b) - 2
        code = ((v - lo) if asc else (hi - v)).clamp(0, span_max)
        if nf:
            code = code + 1
            null_code = 0
        else:
            null_code = span_max + 1
        if c.validity is not None:
            code = torch.where(c.validity, code, null_code)
        packed = (packed << b) | code
    return torch.where(live, packed, _SENTINEL)


def unpack_keys(spec: PackSpec, group_packed: torch.Tensor,
                mins: torch.Tensor, key_cols: Sequence[ColumnVector]
                ) -> List[ColumnVector]:
    """Key columns rebuilt arithmetically from packed group values."""
    fields = []
    rem = group_packed
    for b in reversed(spec.bits):
        fields.append(rem & ((1 << b) - 1))
        rem = rem >> b
    fields.reverse()
    out = []
    for i, (c, kind, code) in enumerate(zip(key_cols, spec.kinds, fields)):
        valid = code != 0
        v = code - 1
        if kind == KIND_DICT:
            data = {"codes": v.to(torch.int32),
                    "dict_offsets": c.data["dict_offsets"],
                    "dict_bytes": c.data["dict_bytes"]}
            out.append(ColumnVector(c.dtype, data, valid,
                                    dict_unique=c.dict_unique))
        elif kind == KIND_BOOL:
            out.append(ColumnVector(c.dtype, v.to(torch.bool), valid))
        else:
            out.append(ColumnVector(c.dtype, (v + mins[2 * i]).to(
                c.data.dtype), valid))
    return out


def _exponent_scale(m: torch.Tensor) -> torch.Tensor:
    """2^(36 - floor(log2(m))) for a positive f64 scalar m, by
    compare-and-multiply; m == 0 maps to 2^36 (sums are 0 anyway)."""
    x = torch.where(m > 0, m, torch.ones_like(m))
    scale = torch.full_like(m, 2.0 ** 36)
    for k in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        up = float(np.float64(2.0) ** k)
        down = float(np.float64(2.0) ** (-k))
        c = x >= up
        x = torch.where(c, x * down, x)
        scale = torch.where(c, scale * down, scale)
        c2 = x * up < 2.0
        x = torch.where(c2, x * up, x)
        scale = torch.where(c2, scale * up, scale)
    return scale


# ---------------------------------------------------------------------------
# The sorted segment layout (packed keys wider than BUCKET_BITS)
# ---------------------------------------------------------------------------

@dataclass
class GroupLayout:
    """What the segmented reductions need. Positions are in sorted row
    order; group g is output slot g in [0, n_groups); slots past it are
    padding (starts and ends -1)."""
    perm: torch.Tensor           # int64[cap] stable sort permutation
    sorted_packed: torch.Tensor  # int64[cap]
    boundary: torch.Tensor       # bool[cap] first sorted row of each group
    gid: torch.Tensor            # int32[cap] dense group id per sorted row
    safe_gid: torch.Tensor       # gid with dead rows routed to slot cap
    starts: torch.Tensor         # int64[cap] first sorted row of group g
    ends: torch.Tensor           # int64[cap] last sorted row of group g
    n_live: torch.Tensor         # 0-d int64
    n_groups: torch.Tensor       # 0-d int32
    cap: int


def group_layout(packed: torch.Tensor, live: torch.Tensor) -> GroupLayout:
    """Sort the packed keys (dead rows carry the sentinel and sort last)
    and number the groups; no host read."""
    cap = packed.shape[0]
    device = packed.device
    n_live = live.sum(dtype=torch.int64)
    sp, perm = torch.sort(packed, stable=True)
    pos = torch.arange(cap, dtype=torch.int64, device=device)
    in_range = pos < n_live
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                          sp[1:] != sp[:-1]]) & in_range
    gid = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = boundary.sum(dtype=torch.int32)
    safe_gid = torch.where(in_range, gid, cap)
    starts = torch.full((cap + 1,), -1, dtype=torch.int64, device=device)
    starts.scatter_(0, torch.where(boundary, gid.to(torch.int64), cap), pos)
    starts = starts[:cap]
    nxt = torch.cat([starts[1:], torch.full((1,), -1, dtype=torch.int64,
                                            device=device)])
    ends = torch.where(nxt >= 0, nxt - 1, n_live - 1)
    ends = torch.where(starts >= 0, ends, -1)
    return GroupLayout(perm, sp, boundary, gid, safe_gid, starts, ends,
                       n_live, n_groups, cap)


def _seg_diff(csum: torch.Tensor, x0: torch.Tensor,
              lay: GroupLayout) -> torch.Tensor:
    """Per-group total from an inclusive cumsum over the sorted rows:
    csum[end] - csum[start] + x[start]."""
    s = lay.starts.clamp(0, lay.cap - 1)
    e = lay.ends.clamp(0, lay.cap - 1)
    return csum[e] - csum[s] + x0[s]


def seg_count(valid_sorted: torch.Tensor, lay: GroupLayout) -> torch.Tensor:
    v = valid_sorted.to(torch.int32)
    return _seg_diff(torch.cumsum(v, 0, dtype=torch.int32), v,
                     lay).to(torch.int64)


def seg_count_all(lay: GroupLayout) -> torch.Tensor:
    return lay.ends - lay.starts + 1


def seg_sum_int(vals_sorted, valid_sorted, lay: GroupLayout) -> torch.Tensor:
    """Exact mod-2^64 segmented integer sum (wraps as Java does)."""
    v = torch.where(valid_sorted, vals_sorted.to(torch.int64), 0)
    return _seg_diff(torch.cumsum(v, 0), v, lay)


def seg_sum_f64(vals_sorted, valid_sorted, lay: GroupLayout) -> torch.Tensor:
    """Segmented float sum from two exact int64 limb cumsums below the
    batch's largest exponent (error within one ulp of the largest |value|);
    NaN and +-Inf follow Spark, counted per group the same way."""
    v = vals_sorted.to(torch.float64)
    nan = torch.isnan(v) & valid_sorted
    pinf = (v == float("inf")) & valid_sorted
    ninf = (v == float("-inf")) & valid_sorted
    finite = valid_sorted & ~nan & ~pinf & ~ninf
    clean = torch.where(finite, v, 0.0)
    scale = _exponent_scale(clean.abs().max())  # |clean| * scale < 2^37
    scaled = clean * scale
    hi = torch.floor(scaled)
    lo = torch.round((scaled - hi) * float(2.0 ** 36))
    hi64, lo64 = hi.to(torch.int64), lo.to(torch.int64)
    shi = _seg_diff(torch.cumsum(hi64, 0), hi64, lay)
    slo = _seg_diff(torch.cumsum(lo64, 0), lo64, lay)
    total = (shi.to(torch.float64)
             + slo.to(torch.float64) * float(2.0 ** -36)) / scale
    # special counts: (nan << 31 | pinf) in one int64 cumsum, ninf apart
    spec = (nan.to(torch.int64) << 31) | pinf.to(torch.int64)
    sspec = _seg_diff(torch.cumsum(spec, 0), spec, lay)
    n_nan = sspec >> 31
    n_pinf = sspec & ((1 << 31) - 1)
    ni = ninf.to(torch.int32)
    n_ninf = _seg_diff(torch.cumsum(ni, 0, dtype=torch.int32), ni, lay)
    out = torch.where(n_pinf > 0, float("inf"), total)
    out = torch.where(n_ninf > 0, float("-inf"), out)
    return torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)),
                       float("nan"), out)


def _scatter_red(op: str, vals: torch.Tensor, gid: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Per-group min or max into cap slots (slot cap takes dead rows);
    an empty group holds the dtype's identity."""
    info = torch.iinfo(vals.dtype)
    init = info.max if op == "min" else info.min
    out = torch.full((cap + 1,), init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, gid.to(torch.int64), vals,
                        reduce="amin" if op == "min" else "amax",
                        include_self=True)
    return out[:cap]


def seg_minmax_int(op: str, vals_sorted, valid_sorted,
                   lay: GroupLayout) -> torch.Tensor:
    """Segmented min/max of an integer plane (bool as int32)."""
    v = vals_sorted.to(torch.int32) if vals_sorted.dtype == torch.bool \
        else vals_sorted
    info = torch.iinfo(v.dtype)
    init = info.max if op == "min" else info.min
    out = _scatter_red(op, torch.where(valid_sorted, v, init), lay.safe_gid,
                       lay.cap)
    return out.to(vals_sorted.dtype)


def seg_minmax_f64(op: str, vals_sorted, valid_sorted,
                   lay: GroupLayout) -> torch.Tensor:
    """Through the order-preserving int64 image (NaN above +inf)."""
    o = _f64_order_i64(vals_sorted.to(torch.float64))
    return _i64_order_f64(seg_minmax_int(op, o, valid_sorted, lay))


def seg_minmax_f32(op: str, vals_sorted, valid_sorted,
                   lay: GroupLayout) -> torch.Tensor:
    min32 = -(1 << 31)
    w = seg_minmax_int(op, _f32_order_i32(vals_sorted.to(torch.float32)),
                       valid_sorted, lay)
    return torch.where(w < 0, ~(w ^ min32), w).view(torch.float32)


def seg_first_last(op: str, vals_sorted, valid_sorted, lay: GroupLayout):
    """(value, has one) of the first or last valid row per group: the
    stable sort keeps the rows' order within a group."""
    cap = lay.cap
    pos = torch.arange(cap, dtype=torch.int64, device=vals_sorted.device)
    if op == "first":
        sel = _scatter_red("min", torch.where(valid_sorted, pos, cap),
                           lay.safe_gid, cap)
        has = sel < cap
    else:
        sel = _scatter_red("max", torch.where(valid_sorted, pos, -1),
                           lay.safe_gid, cap)
        has = sel >= 0
    return vals_sorted[sel.clamp(0, cap - 1)], has


# ---------------------------------------------------------------------------
# Scatter-bucket aggregation (packed keys of at most BUCKET_BITS bits)
# ---------------------------------------------------------------------------

class BucketLayout:
    __slots__ = ("bucket", "nb", "counts", "occupied", "n_groups",
                 "max_cnt", "live")

    def __init__(self, bucket, nb, counts, occupied, n_groups, max_cnt,
                 live):
        self.bucket = bucket
        self.nb = nb
        self.counts = counts
        self.occupied = occupied
        self.n_groups = n_groups
        self.max_cnt = max_cnt
        self.live = live


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, nb: int
                 ) -> torch.Tensor:
    """Sums into nb+1 slots (slot nb collects dropped rows), first nb."""
    out = torch.zeros(nb + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx.to(torch.int64), vals)
    return out[:nb]


def _segment_reduce(op: str, vals: torch.Tensor, idx: torch.Tensor, nb: int,
                    init) -> torch.Tensor:
    out = torch.full((nb + 1,), init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, idx.to(torch.int64), vals,
                        reduce="amin" if op == "min" else "amax",
                        include_self=True)
    return out[:nb]


def bucket_layout(spec: PackSpec, key_cols, mins, live) -> BucketLayout:
    """int32 bucket id per row (dead rows -> overflow slot nb) + occupancy."""
    nb = 1 << spec.total_bits
    packed = pack_keys(spec, key_cols, mins, live)
    bucket = torch.where(live, packed, nb).to(torch.int32)
    counts = _segment_sum(torch.ones(bucket.shape[0], dtype=torch.int32,
                                     device=bucket.device), bucket, nb)
    occupied = counts > 0
    return BucketLayout(bucket, nb, counts, occupied,
                        occupied.sum(dtype=torch.int32), counts.max(), live)


def bucket_unpack_keys(spec: PackSpec, mins, key_cols) -> List[ColumnVector]:
    nb = 1 << spec.total_bits
    return unpack_keys(spec, torch.arange(nb, dtype=torch.int64,
                                          device=mins.device), mins, key_cols)


def _safe_bucket(lay: BucketLayout, valid) -> torch.Tensor:
    return torch.where(valid, lay.bucket, lay.nb)


def bucket_count(lay: BucketLayout, valid) -> torch.Tensor:
    return _segment_sum(valid.to(torch.int32), lay.bucket,
                        lay.nb).to(torch.int64)


def _max_cnt(lay: BucketLayout) -> int:
    # host read of the deepest bucket: one sync (a lax.cond on the device
    # in the JAX package)
    return int(lay.max_cnt.item())


def bucket_sum_int(lay: BucketLayout, vals, valid) -> torch.Tensor:
    """Exact mod-2^64 integer sum per bucket from balanced int32 limb
    scatters; the limb width follows the deepest bucket."""
    v = torch.where(valid, vals.to(torch.int64), 0)
    sb = _safe_bucket(lay, valid)
    depth = _max_cnt(lay)
    if depth > _INT_LIMB_COUNT_LIMIT:
        return _segment_sum(v, sb, lay.nb)
    width, nlimbs = (22, 3) if depth <= (1 << 9) else (16, 4)
    half = 1 << (width - 1)
    mask = (1 << width) - 1
    x = v
    acc = torch.zeros(lay.nb, dtype=torch.int64, device=v.device)
    for i in range(nlimbs):
        d = ((x + half) & mask) - half
        if i < nlimbs - 1:
            x = (x - d) >> width
        s = _segment_sum(d.to(torch.int32), sb, lay.nb)
        acc = acc + (s.to(torch.int64) << (width * i))
    return acc


def bucket_sum_f64(lay: BucketLayout, vals, valid) -> torch.Tensor:
    """Float sum per bucket via balanced fixed-point digit scatters of a
    47-bit representation below the batch max exponent; NaN/Inf follow
    Spark (flags scattered only when the batch holds a special value)."""
    v = vals.to(torch.float64)
    nan = torch.isnan(v) & valid
    pinf = (v == float("inf")) & valid
    ninf = (v == float("-inf")) & valid
    finite = valid & ~nan & ~pinf & ~ninf
    clean = torch.where(finite, v, 0.0)
    sb = _safe_bucket(lay, valid)
    m = clean.abs().max()
    scale = _exponent_scale(m) * float(2.0 ** 11)
    s = clean * scale
    depth = _max_cnt(lay)
    if depth <= _LIMB_COUNT_LIMIT:
        widths = (24, 24) if depth <= _LIMB2_COUNT_LIMIT else (16, 16, 16)
        tot = torch.zeros(lay.nb, dtype=torch.float64, device=v.device)
        rem = s
        shift = sum(widths)
        for w in widths:
            shift -= w
            if shift:
                d = torch.round(rem / float(2.0 ** shift))
                rem = rem - d * float(2.0 ** shift)
            else:
                d = torch.round(rem)
            acc = _segment_sum(d.to(torch.int32), sb, lay.nb)
            tot = tot + acc.to(torch.float64) * float(2.0 ** shift)
        total = tot / scale
    else:
        total = _segment_sum(clean, sb, lay.nb)
    # one sync: does the batch hold any NaN/Inf at all
    if bool((nan | pinf | ninf).any().item()):
        has_nan = _segment_sum(nan.to(torch.int32), sb, lay.nb) > 0
        has_pinf = _segment_sum(pinf.to(torch.int32), sb, lay.nb) > 0
        has_ninf = _segment_sum(ninf.to(torch.int32), sb, lay.nb) > 0
        total = torch.where(has_pinf, float("inf"), total)
        total = torch.where(has_ninf, float("-inf"), total)
        total = torch.where(has_nan | (has_pinf & has_ninf), float("nan"),
                            total)
    return total


def bucket_minmax_int(op, lay: BucketLayout, vals, valid) -> torch.Tensor:
    dt = vals.dtype
    info = torch.iinfo(dt)
    init = info.max if op == "min" else info.min
    v = torch.where(valid, vals, torch.full_like(vals, init))
    return _segment_reduce(op, v, _safe_bucket(lay, valid), lay.nb, init)


def bucket_first_last(op, lay: BucketLayout, vals, valid):
    """(value, has one) of the first or last valid row per bucket, in row
    order."""
    n = vals.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=vals.device)
    sb = _safe_bucket(lay, valid)
    if op == "first":
        sel = _segment_reduce("min", torch.where(valid, pos, n), sb, lay.nb,
                              n)
        has = sel < n
    else:
        sel = _segment_reduce("max", torch.where(valid, pos, -1), sb, lay.nb,
                              -1)
        has = sel >= 0
    return vals[sel.clamp(0, n - 1).to(torch.int64)], has


def _f64_order_i64(v: torch.Tensor) -> torch.Tensor:
    """f64 -> order-preserving int64 (NaN above +inf, -0.0 == 0.0)."""
    x = torch.where(torch.isnan(v), float("nan"), v)
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.view(torch.int64)
    u = torch.where(bits < 0, ~bits, bits | _MIN64)
    return u ^ _MIN64


def _f32_order_i32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> order-preserving int32 (NaN above +inf, -0.0 == 0.0)."""
    x = torch.where(torch.isnan(v), float("nan"), v)
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.view(torch.int32)
    return torch.where(bits < 0, ~bits ^ -(1 << 31), bits)


def _i64_order_f64(o: torch.Tensor) -> torch.Tensor:
    u = o ^ _MIN64
    raw = torch.where(u < 0, u ^ _MIN64, ~u)
    return raw.view(torch.float64)


def bucket_minmax_f64(op, lay: BucketLayout, vals, valid) -> torch.Tensor:
    o = _f64_order_i64(vals.to(torch.float64))
    return _i64_order_f64(bucket_minmax_int(op, lay, o, valid))


def bucket_minmax_f32(op, lay: BucketLayout, vals, valid) -> torch.Tensor:
    min32 = -(1 << 31)
    o = _f32_order_i32(vals.to(torch.float32))
    w = bucket_minmax_int(op, lay, o, valid)
    return torch.where(w < 0, ~(w ^ min32), w).view(torch.float32)
