"""Aggregate function descriptors: sum, count, avg, min, max, first,
last, the variance and standard deviation family, the segmented
aggregates min_by, max_by, percentile, approx_percentile, collect_list
and collect_set, and the grouping markers.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``; ``over(spec)``
makes a window aggregate (``expr/window.py``). Each function
declares its partial state columns (``state_schema``), the reduction that
builds each state from input rows (``update_ops``), the reduction that
merges partial states (``merge_ops``), and the final projection
(``evaluate``). A ``SegmentedAgg`` has no mergeable state: it runs once
over a whole partition's rows in group-sorted order
(``segmented_eval``), and the planner exchanges raw rows by group key
before it. The grouping markers (``grouping``, ``grouping_id``) are
resolved by the ROLLUP/CUBE lowering and never aggregate.
On the CPU backend a function is named by ``pandas_spec`` (the JAX
package's pandas reduction), and a segmented one computes per group id
(``eval_cpu_groups``).
``collect_list``/``collect_set`` are segmented too and give array
columns.
"""
from __future__ import annotations

import decimal
from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, SparkException


class AggFunction:
    def __init__(self, *children: Expression):
        self.children = list(children)

    def result_type(self) -> T.DataType:
        raise NotImplementedError

    def state_schema(self) -> List[Tuple[str, T.DataType]]:
        raise NotImplementedError

    def update_ops(self) -> List[Tuple[str, int]]:
        """[(reduction, input index)] producing each state column; index -1
        reads no input."""
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, state_cols: List[ColumnVector]) -> ColumnVector:
        return state_cols[0]

    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({kids})"

    def transform(self, fn) -> "AggFunction":
        return type(self)(*[c.transform(fn) for c in self.children])

    def alias(self, name: str) -> "NamedAgg":
        return NamedAgg(self, name)

    def over(self, spec):
        """agg OVER a window spec (pyspark's ``F.sum(c).over(w)``)."""
        from spark_rapids_tpu_torch.expr.window import over
        return over(self, spec)

    def __repr__(self):
        return self.fingerprint()


class NamedAgg:
    def __init__(self, fn: AggFunction, name: str):
        self.fn = fn
        self.name = name

    def transform(self, f) -> "NamedAgg":
        return NamedAgg(self.fn.transform(f), self.name)


class Sum(AggFunction):
    """Spark sum: integral inputs sum to long, floats to double, a
    decimal(p, s) to decimal(min(p + 10, 18), s); null when every input is
    null."""

    pandas_spec = "sum"

    def result_type(self):
        dt = self.children[0].data_type()
        if dt.is_integral:
            return T.INT64
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(min(dt.precision + 10, 18), dt.scale)
        return T.FLOAT64

    def state_schema(self):
        return [("sum", self.result_type())]

    def update_ops(self):
        return [("sum", 0)]

    def merge_ops(self):
        return ["sum"]


class Count(AggFunction):
    pandas_spec = "count"

    def result_type(self):
        return T.INT64

    def state_schema(self):
        return [("count", T.INT64)]

    def update_ops(self):
        return [("count", 0)]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, state_cols):
        return ColumnVector(T.INT64, state_cols[0].data, None)


class CountAll(AggFunction):
    """count(*)."""

    pandas_spec = "size"

    def __init__(self):
        super().__init__()

    def result_type(self):
        return T.INT64

    def state_schema(self):
        return [("count", T.INT64)]

    def update_ops(self):
        return [("count_all", -1)]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, state_cols):
        return ColumnVector(T.INT64, state_cols[0].data, None)

    def transform(self, fn):
        return self


class Min(AggFunction):
    pandas_spec = "min"

    def result_type(self):
        return self.children[0].data_type()

    def state_schema(self):
        return [("min", self.result_type())]

    def update_ops(self):
        return [("min", 0)]

    def merge_ops(self):
        return ["min"]


class Max(AggFunction):
    pandas_spec = "max"

    def result_type(self):
        return self.children[0].data_type()

    def state_schema(self):
        return [("max", self.result_type())]

    def update_ops(self):
        return [("max", 0)]

    def merge_ops(self):
        return ["max"]


class Average(AggFunction):
    """avg: states (sum: double, count: long); result double. A decimal
    sums its unscaled values as doubles and divides by 10^scale at the
    end, as the JAX package does."""

    pandas_spec = "mean"

    def result_type(self):
        return T.FLOAT64

    def state_schema(self):
        return [("sum", T.FLOAT64), ("count", T.INT64)]

    def update_ops(self):
        return [("sum", 0), ("count", 0)]

    def merge_ops(self):
        return ["sum", "sum"]

    def evaluate(self, state_cols):
        s, c = state_cols
        cnt = c.data.to(torch.float64)
        val = s.data.to(torch.float64) / torch.where(cnt == 0, 1.0, cnt)
        dt = self.children[0].data_type()
        if isinstance(dt, T.DecimalType):
            val = val / (10.0 ** dt.scale)
        return ColumnVector(T.FLOAT64, val, c.data > 0)


class First(AggFunction):
    """first(expr): the first non-null value in group-sorted order (the
    stable sort keeps the input's row order within a group)."""

    op = "first"
    pandas_spec = "first"

    def result_type(self):
        return self.children[0].data_type()

    def state_schema(self):
        return [("val", self.result_type())]

    def update_ops(self):
        return [(self.op, 0)]

    def merge_ops(self):
        return [self.op]


class Last(First):
    op = "last"
    pandas_spec = "last"


class _MomentAgg(AggFunction):
    """Variance and standard deviation from (n, sum, sumsq) states: m2 =
    sumsq - sum^2 / n, clamped at 0, over n - ddof."""

    ddof = 1  # 1: sample, 0: population

    def result_type(self):
        return T.FLOAT64

    def state_schema(self):
        return [("n", T.INT64), ("sum", T.FLOAT64), ("sumsq", T.FLOAT64)]

    def update_ops(self):
        return [("count", 0), ("sum", 0), ("sumsq", 0)]

    def merge_ops(self):
        return ["sum", "sum", "sum"]

    def _moments(self, state_cols):
        n = state_cols[0].data.to(torch.float64)
        s = state_cols[1].data.to(torch.float64)
        ss = state_cols[2].data.to(torch.float64)
        denom = n - self.ddof
        m2 = (ss - (s * s) / torch.where(n == 0, 1.0, n)).clamp(min=0.0)
        return n, denom, m2 / torch.where(denom <= 0, 1.0, denom)

    def _valid(self, n, denom):
        # a sample statistic of one row is null (Spark 3.1+)
        return (n > 0) & (denom > 0) if self.ddof else n > 0

    def evaluate(self, state_cols):
        n, denom, var = self._moments(state_cols)
        return ColumnVector(T.FLOAT64, var, self._valid(n, denom))


def _two_square(c):
    """c * c as an unevaluated sum p + e, exactly (Veltkamp's split)."""
    p = c * c
    t = c * 134217729.0  # 2**27 + 1
    hi = t - (t - c)
    lo = c - hi
    return p, ((hi * hi - p) + 2.0 * hi * lo) + lo * lo


def _sqrt_rn(x):
    """The square root rounded to nearest. torch's vectorized CPU sqrt can
    be an ulp off (CUDA's is exact): of the root and its two neighbours,
    keep the one whose exact square lies nearest x."""
    best = torch.sqrt(x)
    p, e = _two_square(best)
    err = ((p - x) + e).abs()
    for toward in (float("-inf"), float("inf")):
        c = torch.nextafter(best, torch.full_like(best, toward))
        p, e = _two_square(c)
        ce = ((p - x) + e).abs()
        closer = ce < err
        best = torch.where(closer, c, best)
        err = torch.where(closer, ce, err)
    return best


class VarianceSamp(_MomentAgg):
    ddof = 1
    pandas_spec = "var"


class VariancePop(_MomentAgg):
    ddof = 0
    pandas_spec = ("var", 0)


class StddevSamp(_MomentAgg):
    ddof = 1
    pandas_spec = "std"

    def evaluate(self, state_cols):
        n, denom, var = self._moments(state_cols)
        return ColumnVector(T.FLOAT64, _sqrt_rn(var), self._valid(n, denom))


class StddevPop(StddevSamp):
    ddof = 0
    pandas_spec = ("std", 0)


# ---------------------------------------------------------------------------
# Segmented aggregates: no fixed-width mergeable state. They run in
# complete mode only, over a partition's rows in group-sorted order.
# ---------------------------------------------------------------------------

class SegmentedAgg(AggFunction):
    no_partial = True

    def state_schema(self):
        return [("result", self.result_type())]

    def update_ops(self):
        return [("custom", 0)]

    def merge_ops(self):
        raise NotImplementedError(
            f"{type(self).__name__} has no mergeable partial state")

    def segmented_eval(self, inputs, perm, seg_ids, seg_cap: int, live,
                       num_rows) -> ColumnVector:
        """The result per group: ``inputs`` are the evaluated children in
        row order, ``perm`` the group-sorting permutation, ``seg_ids`` the
        group of each sorted position, ``live`` the rows that count."""
        raise NotImplementedError


def _valid_under(col: ColumnVector, live):
    return live if col.validity is None else (col.validity & live)


def _seg_reduce(vals, seg_ids, seg_cap: int, init, how: str):
    out = torch.full((seg_cap,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg_ids.to(torch.int64), vals, reduce=how,
                               include_self=True)


_INT64_MAX = (1 << 63) - 1


class _MinMaxBy(SegmentedAgg):
    """min_by/max_by(value, ordering): the value at the extreme ordering.
    Rows whose ordering is null are ignored; ties go to the earliest row
    in group-sorted order."""

    is_min = True

    def result_type(self):
        return self.children[0].data_type()

    def segmented_eval(self, inputs, perm, seg_ids, seg_cap, live, num_rows):
        from spark_rapids_tpu_torch.ops import kernels as K
        val, ordc = inputs
        if ordc.is_string:
            # planning tags it to the CPU (eval_cpu_groups)
            raise NotImplementedError(
                f"{type(self).__name__} ordered by a string column on the "
                f"device")
        cap = perm.shape[0]
        ok = _valid_under(ordc, live)
        # the sign-flipped int64 image orders like the JAX package's
        # unsigned key; ~ reverses it, and INT64_MAX is the sentinel
        okey, _ = K.normalize_key(ordc, num_rows, live=live)
        if not self.is_min:
            okey = ~okey
        key_s = torch.where(ok, okey, _INT64_MAX)[perm]
        gmin = _seg_reduce(key_s, seg_ids, seg_cap, _INT64_MAX, "amin")
        idx = seg_ids.to(torch.int64)
        hit = ok[perm] & (key_s == gmin[idx.clamp(max=seg_cap - 1)])
        pos = torch.where(hit, torch.arange(cap, device=perm.device), cap)
        sel = _seg_reduce(pos, seg_ids, seg_cap, cap, "amin")
        src = torch.where(sel < cap, perm[sel.clamp(0, cap - 1)], -1)
        return K.gather_column(val, src, cap)

    def eval_cpu_groups(self, inputs, gid, n_groups):
        from spark_rapids_tpu_torch.exec.cpu_backend import norm_key_np
        val, ordc = inputs
        okey, onull = norm_key_np(ordc)
        if not self.is_min:
            okey = ~okey
        best = {}
        for i, g in enumerate(gid):
            if onull[i]:
                continue
            if g not in best or okey[i] < okey[best[g]]:
                best[g] = i
        rt = self.result_type()
        vals = np.empty(n_groups, object) if isinstance(rt, T.StringType) \
            else np.zeros(n_groups, rt.np_dtype)
        ok = np.zeros(n_groups, np.bool_)
        for g, i in best.items():
            if val.valid[i]:
                vals[g] = val.values[i]
                ok[g] = True
        return CpuCol(rt, vals, ok)


class MinBy(_MinMaxBy):
    is_min = True


class MaxBy(_MinMaxBy):
    is_min = False


class Percentile(SegmentedAgg):
    """percentile(col, p): the exact percentile with linear interpolation
    between the closest ranks."""

    def __init__(self, child, percentage: float):
        super().__init__(child)
        self.percentage = float(percentage)
        if not 0.0 <= self.percentage <= 1.0:
            raise SparkException(
                f"percentage must be in [0, 1], got {percentage}")

    def fingerprint(self):
        return f"{type(self).__name__}({self.percentage};" + \
            ",".join(c.fingerprint() for c in self.children) + ")"

    def transform(self, fn):
        return type(self)(self.children[0].transform(fn), self.percentage)

    def result_type(self):
        return T.FLOAT64

    def segmented_eval(self, inputs, perm, seg_ids, seg_cap, live, num_rows):
        from spark_rapids_tpu_torch.ops import radix as R
        src = inputs[0]
        cap = perm.shape[0]
        device = perm.device
        keep = _valid_under(src, live)[perm]
        v = src.data.to(torch.float64)[perm]
        cdt = self.children[0].data_type()
        if isinstance(cdt, T.DecimalType):
            v = v / (10.0 ** cdt.scale)  # the unscaled values' value
        # kept rows to the front, group-major, values ascending. The JAX
        # package's sort treats -0.0 and 0.0 as equal and every NaN as
        # one value above +inf: the order of the floats' int64 image, with
        # stable sorts keeping ties in row order
        idx2 = torch.sort(R._f64_order_i64(v), stable=True).indices
        major = ((~keep).to(torch.int64) << 32) | seg_ids.to(torch.int64)
        idx2 = idx2[torch.sort(major[idx2], stable=True).indices]
        v2 = v[idx2]
        m = torch.zeros(seg_cap, dtype=torch.int64, device=device).index_add_(
            0, seg_ids.to(torch.int64), keep.to(torch.int64))
        starts = torch.cumsum(m, 0) - m
        rank = self.percentage * (m - 1).clamp(min=0).to(torch.float64)
        lo = torch.floor(rank).to(torch.int64)
        hi = torch.ceil(rank).to(torch.int64)
        frac = rank - lo.to(torch.float64)
        vlo = v2[(starts + lo).clamp(0, cap - 1)]
        vhi = v2[(starts + hi).clamp(0, cap - 1)]
        return ColumnVector(T.FLOAT64, vlo + (vhi - vlo) * frac, m > 0)

    def eval_cpu_groups(self, inputs, gid, n_groups):
        cdt = self.children[0].data_type()
        descale = 10.0 ** cdt.scale if isinstance(cdt, T.DecimalType) \
            else 1.0
        buckets = [[] for _ in range(n_groups)]
        for g, v, ok in zip(gid, inputs[0].values, inputs[0].valid):
            if ok:
                buckets[g].append(float(v) / descale)
        vals = np.zeros(n_groups, np.float64)
        okm = np.zeros(n_groups, np.bool_)
        for g, b in enumerate(buckets):
            if not b:
                continue
            b.sort()
            rank = self.percentage * (len(b) - 1)
            lo, hi = int(np.floor(rank)), int(np.ceil(rank))
            vals[g] = b[lo] + (b[hi] - b[lo]) * (rank - lo)
            okm[g] = True
        return CpuCol(T.FLOAT64, vals, okm)


class ApproxPercentile(Percentile):
    """approx_percentile(col, p[, accuracy]): answered exactly, as in the
    JAX package, which satisfies any accuracy."""

    def __init__(self, child, percentage: float, accuracy: int = 10000):
        super().__init__(child, percentage)
        self.accuracy = accuracy

    def transform(self, fn):
        return ApproxPercentile(self.children[0].transform(fn),
                                self.percentage, self.accuracy)


def _cpu_leaf_converter(dt: T.DataType):
    """An element of the CPU backend as Arrow's list builder takes it: a
    decimal's unscaled int64 becomes a python Decimal."""
    if isinstance(dt, T.DecimalType):
        scale = dt.scale
        return lambda v: decimal.Decimal(int(v)).scaleb(-scale)
    return lambda v: v.item() if isinstance(v, np.generic) else v


def _pack_valid_front(src: ColumnVector, perm: torch.Tensor,
                      keep_sorted: torch.Tensor, cap: int) -> ColumnVector:
    """The kept rows of the group-sorted order, gathered stably to the
    front of a column of the same capacity: an array's child."""
    from spark_rapids_tpu_torch.ops import kernels as K
    dest = torch.cumsum(keep_sorted.to(torch.int64), 0) - 1
    src_idx = torch.full((cap,), -1, dtype=torch.int64, device=perm.device)
    src_idx[dest[keep_sorted]] = perm[keep_sorted]
    return K.gather_column(src, src_idx, cap)


def _array_of(dtype, child: ColumnVector, keep_sorted, seg_ids,
              seg_cap: int) -> ColumnVector:
    """The array column of seg_cap groups whose elements are the kept
    sorted rows, group by group: offsets from the per-group counts."""
    counts = torch.zeros(seg_cap, dtype=torch.int64,
                         device=seg_ids.device).index_add_(
        0, seg_ids.to(torch.int64), keep_sorted.to(torch.int64))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=counts.device), counts.cumsum(0)])
    return ColumnVector(dtype, {"offsets": offsets.to(torch.int32),
                                "child": child}, None)


class CollectList(SegmentedAgg):
    """collect_list: a group's non-null values in the stable input order
    (the order after any exchange); an empty group gives []."""

    def result_type(self):
        return T.ArrayType(self.children[0].data_type(), contains_null=False)

    def segmented_eval(self, inputs, perm, seg_ids, seg_cap, live, num_rows):
        src = inputs[0]
        keep = _valid_under(src, live)[perm]
        child = _pack_valid_front(src, perm, keep, perm.shape[0])
        return _array_of(self.result_type(), child, keep, seg_ids, seg_cap)

    def eval_cpu_groups(self, inputs, gid, n_groups):
        src = inputs[0]
        conv = _cpu_leaf_converter(self.children[0].data_type())
        out = [[] for _ in range(n_groups)]
        for g, v, ok in zip(gid, src.values, src.valid):
            if ok and v is not None:
                out[g].append(conv(v))
        vals = np.empty(n_groups, object)
        vals[:] = out
        return CpuCol(self.result_type(), vals, np.ones(n_groups, np.bool_))


class CollectSet(SegmentedAgg):
    """collect_set: a group's distinct non-null values, ordered by their
    normalized key on the device (value order for numbers, the 64-bit
    string hash for strings, the code for a dictionary whose vocabulary
    holds each string once) and by value on the CPU, as in the JAX
    package; Spark leaves the order open. NaN is one member. A unique
    vocabulary deduplicates exactly by code; other strings by the 64-bit
    hash (collision odds ~2^-64 a pair), which planning gates behind
    spark.rapids.sql.incompatibleOps.enabled."""

    def result_type(self):
        return T.ArrayType(self.children[0].data_type(), contains_null=False)

    def segmented_eval(self, inputs, perm, seg_ids, seg_cap, live, num_rows):
        from spark_rapids_tpu_torch.ops import kernels as K
        src = inputs[0]
        keep = _valid_under(src, live)[perm]
        if src.is_dict and src.dict_unique:
            vkey = src.data["codes"].to(torch.int64)
        else:
            vkey, _ = K.normalize_key(src, num_rows, live=live)
        vkey_s = vkey[perm]
        # within each group, kept rows first in value order: duplicates
        # become adjacent runs (three stable sorts, the last key first)
        idx2 = torch.sort(vkey_s, stable=True).indices
        idx2 = idx2[torch.sort((~keep)[idx2].to(torch.uint8),
                               stable=True).indices]
        idx2 = idx2[torch.sort(seg_ids[idx2], stable=True).indices]
        seg2, vk2, keep2 = seg_ids[idx2], vkey_s[idx2], keep[idx2]
        first = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=perm.device),
                           (seg2[1:] != seg2[:-1]) | (vk2[1:] != vk2[:-1])])
        keep2 = keep2 & first
        child = _pack_valid_front(src, perm[idx2], keep2, perm.shape[0])
        return _array_of(self.result_type(), child, keep2, seg2, seg_cap)

    def eval_cpu_groups(self, inputs, gid, n_groups):
        src = inputs[0]
        conv = _cpu_leaf_converter(self.children[0].data_type())
        seen = [dict() for _ in range(n_groups)]
        for g, v, ok in zip(gid, src.values, src.valid):
            if ok and v is not None:
                v = conv(v)
                # NaN is one member; keying by the value would keep each
                key = "__nan__" if isinstance(v, float) and v != v else v
                seen[g].setdefault(key, v)

        def skey(x):
            return (2, 0) if isinstance(x, float) and x != x else (1, x)
        vals = np.empty(n_groups, object)
        vals[:] = [sorted(d.values(), key=skey) for d in seen]
        return CpuCol(self.result_type(), vals, np.ones(n_groups, np.bool_))


class GroupingMarker(AggFunction):
    """grouping(col) / grouping_id(): pseudo-aggregates valid only under
    ROLLUP, CUBE or GROUPING SETS. ``GroupedData.agg`` resolves them to
    bit reads of the Expand's ``__grouping_id`` key, and an ``Aggregate``
    node refuses one elsewhere, so they never aggregate."""


class Grouping(GroupingMarker):
    """grouping(col): 1 when the key is aggregated away in this output
    row, else 0 (Spark's ByteType)."""

    def result_type(self):
        return T.INT8


class GroupingID(GroupingMarker):
    """grouping_id(): the bitmask over the group-by keys (Spark's
    LongType)."""

    def result_type(self):
        return T.INT64
