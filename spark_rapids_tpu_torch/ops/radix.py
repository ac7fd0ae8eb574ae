"""Range-compressed packed keys and the scatter-bucket reductions.

Counterpart of ``spark_rapids_tpu/ops/radix.py`` (``PackSpec``,
``probe_ranges``, ``plan_packing``, ``pack_keys``, ``unpack_keys``,
``_exponent_scale`` and ``bucket_layout`` with the ``bucket_*``
reductions). All group keys pack into one int64 plane: per key,
``code = value - min + 1`` in ``bits`` bits, slot 0 meaning NULL. When the
packed key has at most BUCKET_BITS bits, every reduction is a scatter into
the dense bucket space, and float sums are exact integer digit scatters,
so the result matches the JAX package bit for bit.

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


_INT_KINDS = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type, T.DateType)


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
