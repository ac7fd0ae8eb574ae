"""Array collection operations (no lambdas).

Counterpart of ``spark_rapids_tpu/expr/array_ops.py``: ``ArrayMin``/
``ArrayMax``, ``ArrayPosition``, ``ArrayRemove``, ``Slice``, ``SortArray``,
``Flatten``, ``ArrayDistinct``, ``ArrayUnion``/``ArrayIntersect``/
``ArrayExcept``, ``ArraysOverlap``, ``MapEntries``, and the host tier
(``_CpuCollection``: ``ArrayRepeat``, ``ArrayJoin``, ``ArraysZip``,
``MapConcat``, ``MapFromArrays``, ``StrToMap``), which planning sends to
the CPU.

Every per-row set or sort operation is one pass over the flattened element
plane: two stable sorts put each row's elements together by (row, null,
value key), so distinct, membership, min/max and sort become segmented
scans, and a compaction rebuilds the offsets. Elements compare by
``ops/kernels.normalize_key``: exact for fixed-width types, the 64-bit
double hash for strings (the rule of ``array_distinct`` names it);
sort_array and array_min/max over strings run on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.complex import (
    _cmp_child_to_row, _element_segments, _leaf_cpu_col, _obj_col, _ones,
    _seg_any, _seg_max, _seg_min, _string_literal,
)
from spark_rapids_tpu_torch.expr.core import (
    BoundRef, Cast, CpuCol, EvalCtx, Expression, SparkException, _valid_of,
    _wrap,
)

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
_NESTED = (T.StringType, T.ArrayType, T.MapType, T.StructType)


def _offsets(col: ColumnVector):
    cap = col.capacity
    off = col.data["offsets"].to(torch.int64)
    return off[:cap], off[1: cap + 1] - off[:cap]


def _elem_layout(arr: ColumnVector):
    """(child, seg, e, in_range, start) of an array column: the owning
    row and index of each element, whether it lies inside a row, and the
    rows' starts (int64)."""
    cap = arr.capacity
    off = arr.data["offsets"].to(torch.int64)
    child = arr.data["child"]
    child_cap = child.capacity
    seg = _element_segments(off[: cap + 1], cap, child_cap)
    e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
    return child, seg, e, e < off[cap], off[:cap]


def _compact_elements(arr: ColumnVector, keep: torch.Tensor,
                      out_dtype: Optional[T.DataType] = None
                      ) -> ColumnVector:
    """A new array column of the elements where ``keep``, in order within
    each row: offsets recounted, the child gathered through one scatter
    of source positions (unkept elements write the overflow slot)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    child, seg, e, in_range, start = _elem_layout(arr)
    child_cap = child.capacity
    keep = keep & in_range
    k = keep.to(torch.int64)
    ex = torch.cumsum(k, 0) - k
    kept_per_row = torch.zeros(arr.capacity, dtype=torch.int64,
                               device=k.device).index_add_(0, seg, k)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=k.device),
                         torch.cumsum(kept_per_row, 0)])
    base = ex[start[seg].clamp(0, child_cap - 1)]
    dest = torch.where(keep, new_off[seg] + (ex - base), child_cap)
    src = torch.full((child_cap + 1,), -1, dtype=torch.int64,
                     device=k.device).scatter_(0, dest, e)[:child_cap]
    return ColumnVector(out_dtype or arr.dtype, {
        "offsets": new_off.to(torch.int32),
        "child": K.gather_column(child, src, child_cap)}, arr.validity)


def _elem_eq_key(child: ColumnVector, in_range: torch.Tensor):
    """A 64-bit equality key per element and its null flag. Elements are
    live where they lie inside a row; a child without a validity plane
    holds no null."""
    from spark_rapids_tpu_torch.ops import kernels as K
    return K.normalize_key(child, child.capacity, live=in_range)


def _grouped_order(seg_key: torch.Tensor, is_null: torch.Tensor,
                   key64: torch.Tensor) -> torch.Tensor:
    """The element order by (row, null flag, value key), ties in element
    order: two stable sorts (the row and the null flag share one key)."""
    perm = torch.sort(key64, stable=True).indices
    rn = seg_key * 2 + is_null.to(torch.int64)
    return perm[torch.sort(rn[perm], stable=True).indices]


def _group_starts(*planes) -> torch.Tensor:
    """True where a sorted element starts a new (row, null, value)
    group."""
    n = planes[0].shape[0]
    first = torch.ones(n, dtype=torch.bool, device=planes[0].device)
    if n > 1:
        diff = torch.zeros(n - 1, dtype=torch.bool, device=first.device)
        for p in planes:
            diff |= p[1:] != p[:-1]
        first[1:] = diff
    return first


def _group_first_flags(seg, key64, is_null, in_range, cap):
    """Per element: is it the first occurrence of its value in its row?
    Nulls form one value of their own per row."""
    seg_key = torch.where(in_range, seg, cap)
    si = _grouped_order(seg_key, is_null, key64)
    first = _group_starts(seg_key[si], is_null[si], key64[si])
    keep = torch.zeros_like(first)
    keep[si] = first
    return keep & in_range


def _membership_flags(a: ColumnVector, b: ColumnVector):
    """For each element of a: does an equal element lie in the same row
    of b? Returns (present over a's elements, a's layout, per-row "b
    holds a null", a's null flags). Both sides compare in their common
    element type (Spark's coercion), by one grouped order over both."""
    et = T.common_type(a.dtype.element, b.dtype.element)
    a, b = _retyped(a, T.ArrayType(et)), _retyped(b, T.ArrayType(et))
    a_child, a_seg, a_e, a_in, _ = _elem_layout(a)
    b_child, b_seg, _, b_in, _ = _elem_layout(b)
    cap = a.capacity
    ak, anull = _elem_eq_key(a_child, a_in)
    bk, bnull = _elem_eq_key(b_child, b_in)
    na, nb = a_child.capacity, b_child.capacity
    seg_u = torch.cat([torch.where(a_in, a_seg, cap),
                       torch.where(b_in, b_seg, cap)])
    null_u = torch.cat([anull, bnull])
    key_u = torch.cat([ak, bk])
    side_u = torch.cat([torch.zeros(na, dtype=torch.bool, device=ak.device),
                        torch.ones(nb, dtype=torch.bool, device=ak.device)])
    si = _grouped_order(seg_u, null_u, key_u)
    ss = seg_u[si]
    first = _group_starts(ss, null_u[si], key_u[si])
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    n = na + nb
    has_b = _seg_any(torch.where(ss < cap, gid, n), side_u[si], n)
    present = torch.zeros(n, dtype=torch.bool, device=ak.device)
    present[si] = has_b[gid]
    b_has_null = _seg_any(torch.where(b_in, b_seg, cap), bnull, cap)
    return present[:na], (a_child, a_seg, a_e, a_in), b_has_null, anull


def _order_key(child: ColumnVector) -> torch.Tensor:
    """An int64 whose order is the elements' (floats: NaN greatest)."""
    from spark_rapids_tpu_torch.ops import radix as R
    if isinstance(child.dtype, (T.Float32Type, T.Float64Type)):
        return R._f64_order_i64(child.data.to(torch.float64))
    return child.data.to(torch.int64)


def _from_order_key(w: torch.Tensor, et: T.DataType) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops import radix as R
    if isinstance(et, (T.Float32Type, T.Float64Type)):
        return R._i64_order_f64(w).to(et.torch_dtype)
    return w.to(et.torch_dtype)


class ArrayMin(Expression):
    """array_min(arr): the least non-null element (NaN above any
    number)."""

    _op = "min"

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type().element

    def with_children(self, children):
        return type(self)(children[0])

    def supported_on_tpu(self):
        return not isinstance(self.children[0].data_type().element, _NESTED)

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        child, seg, _, in_range, _ = _elem_layout(arr)
        cap = arr.capacity
        cv = child.validity if child.validity is not None \
            else _ones(child.capacity, child.device)
        ok = in_range & cv
        slot = torch.where(ok, seg, cap)
        o = _order_key(child)
        if self._op == "min":
            w = _seg_min(slot, torch.where(ok, o, _I64_MAX), cap, _I64_MAX)
        else:
            w = _seg_max(slot, torch.where(ok, o, _I64_MIN), cap, _I64_MIN)
        some = _seg_any(slot, ok, cap)
        et = self.data_type()
        return ColumnVector(et, _from_order_key(w, et),
                            _valid_of(arr, ctx) & some)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        pick = min if self._op == "min" else max
        for v, ok in zip(arr.values, arr.valid):
            vals = [x for x in (v or []) if x is not None] \
                if ok and v is not None else []
            if not vals:
                out_v.append(None)
                out_ok.append(False)
                continue
            nonnan = [x for x in vals
                      if not (isinstance(x, float) and np.isnan(x))]
            if len(nonnan) < len(vals) and (self._op == "max" or not nonnan):
                out_v.append(float("nan"))
            else:
                out_v.append(pick(nonnan))
            out_ok.append(True)
        return _leaf_cpu_col(self.data_type(), out_v, out_ok)


class ArrayMax(ArrayMin):
    """array_max(arr)."""

    _op = "max"


class ArrayPosition(Expression):
    """array_position(arr, v): the 1-based index of the first match, 0 if
    none; null if arr or v is null."""

    def __init__(self, child: Expression, value: Expression):
        self.children = [child, _wrap(value)]

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return ArrayPosition(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        val = self.children[1].eval(ctx)
        child, seg, e, in_range, start = _elem_layout(arr)
        eq, both = _cmp_child_to_row(child, val, seg,
                                     _string_literal(self.children[1]))
        cap = arr.capacity
        match = eq & both & in_range
        first = _seg_min(torch.where(match, seg, cap), e, cap, _I64_MAX)
        found = first < _I64_MAX
        pos = torch.where(found, first - start + 1, 0)
        return ColumnVector(T.INT64, pos,
                            _valid_of(arr, ctx) & _valid_of(val, ctx))

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        val = self.children[1].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (v, ok), (x, xok) in zip(zip(arr.values, arr.valid),
                                     zip(val.values, val.valid)):
            if not ok or v is None or not xok:
                out_v.append(0)
                out_ok.append(False)
                continue
            pos = 0
            for i, el in enumerate(v):
                if el is not None and el == x:
                    pos = i + 1
                    break
            out_v.append(pos)
            out_ok.append(True)
        return CpuCol(T.INT64, np.asarray(out_v, np.int64),
                      np.asarray(out_ok, np.bool_))


class ArrayRemove(Expression):
    """array_remove(arr, v): drops the elements equal to v (nulls
    stay)."""

    def __init__(self, child: Expression, value: Expression):
        self.children = [child, _wrap(value)]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return ArrayRemove(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        val = self.children[1].eval(ctx)
        child, seg, _, in_range, _ = _elem_layout(arr)
        eq, both = _cmp_child_to_row(child, val, seg,
                                     _string_literal(self.children[1]))
        out = _compact_elements(arr, ~(eq & both) & in_range)
        return ColumnVector(out.dtype, out.data,
                            _valid_of(arr, ctx) & _valid_of(val, ctx))

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        val = self.children[1].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (v, ok), (x, xok) in zip(zip(arr.values, arr.valid),
                                     zip(val.values, val.valid)):
            if not ok or v is None or not xok:
                out_v.append(None)
                out_ok.append(False)
                continue
            out_v.append([el for el in v if el is None or el != x])
            out_ok.append(True)
        return _obj_col(self.data_type(), out_v, np.asarray(out_ok, np.bool_))


class Slice(Expression):
    """slice(arr, start, length): 1-based; a negative start counts from
    the end; start 0 and a negative length are errors."""

    def __init__(self, child: Expression, start: Expression,
                 length: Expression):
        self.children = [child, _wrap(start), _wrap(length)]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return Slice(children[0], children[1], children[2])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        arr = self.children[0].eval(ctx)
        st = self.children[1].eval(ctx)
        ln = self.children[2].eval(ctx)
        child, _, _, _, start = _elem_layout(arr)
        cap = arr.capacity
        _, lens = _offsets(arr)
        valid = _valid_of(arr, ctx) & _valid_of(st, ctx) & _valid_of(ln, ctx)
        s = st.data.to(torch.int64)
        n = ln.data.to(torch.int64)
        ctx.add_error("SliceStartZero", valid & (s == 0))
        ctx.add_error("SliceNegativeLength", valid & (n < 0))
        begin = torch.where(s > 0, s - 1, lens + s)  # 0-based
        begin_c = torch.minimum(begin.clamp(min=0), lens)
        out_len = torch.minimum(n, lens - begin_c).clamp(min=0)
        out_len = torch.where(valid & (begin >= 0) & (begin < lens),
                              out_len, 0)
        new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                         device=s.device),
                             torch.cumsum(out_len, 0)])
        child_cap = child.capacity
        oe = torch.arange(child_cap, dtype=torch.int64, device=s.device)
        oseg = (torch.searchsorted(new_off, oe, right=True) - 1).clamp(
            0, cap - 1)
        src = torch.where(oe < new_off[cap],
                          start[oseg] + begin_c[oseg] + (oe - new_off[oseg]),
                          -1)
        return ColumnVector(self.data_type(), {
            "offsets": new_off.to(torch.int32),
            "child": K.gather_column(child, src, child_cap)}, valid)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        st = self.children[1].eval_cpu(cols, ansi)
        ln = self.children[2].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (v, ok), (s, sok), (n, nok) in zip(
                zip(arr.values, arr.valid), zip(st.values, st.valid),
                zip(ln.values, ln.valid)):
            if not ok or v is None or not sok or not nok:
                out_v.append(None)
                out_ok.append(False)
                continue
            s, n = int(s), int(n)
            if s == 0:
                raise SparkException("Unexpected value for start in slice: "
                                     "SQL array indices start at 1")
            if n < 0:
                raise SparkException(
                    f"Unexpected value for length in slice: {n}")
            b = s - 1 if s > 0 else len(v) + s
            out_v.append(v[b: b + n] if b >= 0 else [])
            out_ok.append(True)
        return _obj_col(self.data_type(), out_v, np.asarray(out_ok, np.bool_))


class SortArray(Expression):
    """sort_array(arr, asc): nulls first ascending, last descending (NaN
    above any number)."""

    def __init__(self, child: Expression, asc: bool = True):
        self.children = [child]
        self.asc = bool(asc)

    def _params(self):
        return str(self.asc)

    def with_children(self, children):
        return SortArray(children[0], self.asc)

    def data_type(self):
        return self.children[0].data_type()

    def supported_on_tpu(self):
        return not isinstance(self.children[0].data_type().element, _NESTED)

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        arr = self.children[0].eval(ctx)
        child, seg, _, in_range, _ = _elem_layout(arr)
        child_cap = child.capacity
        cap = arr.capacity
        o = _order_key(child)
        if not self.asc:
            o = ~o  # descending: a monotone bit reversal, no overflow
        cv = child.validity if child.validity is not None \
            else _ones(child_cap, child.device)
        # nulls first ascending, last descending: the least key of the
        # ascending sort of the (maybe reversed) key, or the greatest
        o = torch.where(cv, o, _I64_MIN if self.asc else _I64_MAX)
        seg_key = torch.where(in_range, seg, cap)
        perm = torch.sort(o, stable=True).indices
        perm = perm[torch.sort(seg_key[perm], stable=True).indices]
        # rows are contiguous in both layouts: sorted position i is the
        # destination of element perm[i]
        src = torch.where(seg_key[perm] < cap, perm, -1)
        return ColumnVector(self.data_type(), {
            "offsets": arr.data["offsets"],
            "child": K.gather_column(child, src, child_cap)}, arr.validity)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        out_v = []
        for v, ok in zip(arr.values, arr.valid):
            if not ok or v is None:
                out_v.append(None)
                continue
            nn = [x for x in v if x is not None]
            nulls = [None] * (len(v) - len(nn))
            key = (lambda x: (np.isnan(x), x)) \
                if nn and isinstance(nn[0], float) else (lambda x: x)
            nn.sort(key=key, reverse=not self.asc)
            out_v.append(nulls + nn if self.asc else nn + nulls)
        return _obj_col(self.data_type(), out_v, arr.valid.copy())


class Flatten(Expression):
    """flatten(arr<arr<T>>): null if the outer row or any inner array is
    null."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type().element

    def with_children(self, children):
        return Flatten(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        inner = arr.data["child"]  # array<T> over the middle elements
        cap = arr.capacity
        off = arr.data["offsets"].to(torch.int64)
        ioff = inner.data["offsets"].to(torch.int64)
        mid_cap = inner.capacity
        # the outer boundaries read through the inner offsets
        new_off = ioff[off[: cap + 1].clamp(0, mid_cap)]
        new_off = new_off - new_off[0]
        mid_valid = inner.validity if inner.validity is not None \
            else _ones(mid_cap, off.device)
        seg = _element_segments(off[: cap + 1], cap, mid_cap)
        m = torch.arange(mid_cap, dtype=torch.int64, device=off.device)
        has_null_inner = _seg_any(torch.where(m < off[cap], seg, cap),
                                  ~mid_valid, cap)
        return ColumnVector(self.data_type(), {
            "offsets": new_off.to(torch.int32),
            "child": inner.data["child"]},
            _valid_of(arr, ctx) & ~has_null_inner)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for v, ok in zip(arr.values, arr.valid):
            if not ok or v is None or any(x is None for x in v):
                out_v.append(None)
                out_ok.append(False)
                continue
            out_v.append([el for sub in v for el in sub])
            out_ok.append(True)
        return _obj_col(self.data_type(), out_v, np.asarray(out_ok, np.bool_))


class ArrayDistinct(Expression):
    """array_distinct(arr): first-occurrence order, at most one null.
    String elements dedup by the 64-bit double hash."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return ArrayDistinct(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        child, seg, _, in_range, _ = _elem_layout(arr)
        k, nulls = _elem_eq_key(child, in_range)
        keep = _group_first_flags(seg, k, nulls, in_range, arr.capacity)
        return _compact_elements(arr, keep)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        out_v = [None if (not ok or v is None) else _ArraySetBase._dedup(v)
                 for v, ok in zip(arr.values, arr.valid)]
        return _obj_col(self.data_type(), out_v, arr.valid.copy())


def _set_key(x):
    """An element's identity in the set operations: every NaN is one
    value, as on the device (Python's own NaNs are unequal)."""
    return _NAN_KEY if isinstance(x, float) and x != x else x


_NAN_KEY = ("NaN",)


class _ArraySetBase(Expression):
    """What union, intersect and except share."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self):
        lt = self.children[0].data_type()
        rt = self.children[1].data_type()
        return T.ArrayType(T.common_type(lt.element, rt.element))

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval_cpu(self, cols, ansi=False):
        a = self.children[0].eval_cpu(cols, ansi)
        b = self.children[1].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (av, aok), (bv, bok) in zip(zip(a.values, a.valid),
                                        zip(b.values, b.valid)):
            if not aok or av is None or not bok or bv is None:
                out_v.append(None)
                out_ok.append(False)
                continue
            out_v.append(self._combine(av, bv))
            out_ok.append(True)
        return _obj_col(self.data_type(), out_v, np.asarray(out_ok, np.bool_))

    @staticmethod
    def _dedup(vals):
        seen, out, saw_null = set(), [], False
        for el in vals:
            if el is None:
                if not saw_null:
                    saw_null = True
                    out.append(None)
            elif _set_key(el) not in seen:
                seen.add(_set_key(el))
                out.append(el)
        return out

    def _filtered(self, ctx: EvalCtx, want_present: bool) -> ColumnVector:
        """Intersect (want_present) or except: the distinct elements of a
        that are (not) in the same row of b; a null counts as present when
        b's row holds a null."""
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        present, (a_child, a_seg, _, a_in), b_has_null, _ = \
            _membership_flags(a, b)
        k, nulls = _elem_eq_key(a_child, a_in)
        first = _group_first_flags(a_seg, k, nulls, a_in, a.capacity)
        hit = torch.where(nulls, b_has_null[a_seg], present)
        keep = first & (hit if want_present else ~hit)
        out = _compact_elements(_retyped(a, self.data_type()), keep)
        return ColumnVector(out.dtype, out.data,
                            _valid_of(a, ctx) & _valid_of(b, ctx))


def _as_type(c: ColumnVector, dt: T.DataType) -> ColumnVector:
    """A column cast to ``dt`` (the element planes of a set operation
    whose sides differ in type)."""
    if c.dtype == dt:
        return c
    ctx = EvalCtx([c], c.capacity, c.capacity, c.device)
    return Cast(BoundRef(0, c.dtype), dt).eval(ctx)


def _retyped(arr: ColumnVector, dt: T.ArrayType) -> ColumnVector:
    if arr.dtype == dt:
        return arr
    return ColumnVector(dt, {"offsets": arr.data["offsets"],
                             "child": _as_type(arr.data["child"], dt.element)},
                        arr.validity)


class ArrayUnion(_ArraySetBase):
    """array_union(a, b): the distinct elements of a, then of b."""

    def _combine(self, av, bv):
        return self._dedup(list(av) + list(bv))

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        cat = _concat_arrays(a, b, self.data_type())
        child, seg, _, in_range, _ = _elem_layout(cat)
        k, nulls = _elem_eq_key(child, in_range)
        keep = _group_first_flags(seg, k, nulls, in_range, cat.capacity)
        out = _compact_elements(cat, keep)
        return ColumnVector(out.dtype, out.data,
                            _valid_of(a, ctx) & _valid_of(b, ctx))


class ArrayIntersect(_ArraySetBase):
    """array_intersect(a, b): the distinct elements of a present in b."""

    def _combine(self, av, bv):
        bs = set(_set_key(x) for x in bv if x is not None)
        bnull = any(x is None for x in bv)
        return self._dedup([x for x in av
                            if (x is None and bnull)
                            or (x is not None and _set_key(x) in bs)])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        return self._filtered(ctx, True)


class ArrayExcept(_ArraySetBase):
    """array_except(a, b): the distinct elements of a not in b."""

    def _combine(self, av, bv):
        bs = set(_set_key(x) for x in bv if x is not None)
        bnull = any(x is None for x in bv)
        return self._dedup([x for x in av
                            if (x is None and not bnull)
                            or (x is not None and _set_key(x) not in bs)])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        return self._filtered(ctx, False)


class ArraysOverlap(Expression):
    """arrays_overlap(a, b): true if a non-null element is common;
    otherwise null if either side holds a null (both non-empty); else
    false."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return ArraysOverlap(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        present, (_, a_seg, _, a_in), b_has_null, anull = \
            _membership_flags(a, b)
        cap = a.capacity
        slot = torch.where(a_in, a_seg, cap)
        common = _seg_any(slot, present & ~anull, cap)
        a_has_null = _seg_any(slot, anull, cap)
        _, alens = _offsets(a)
        _, blens = _offsets(b)
        unknown = (alens > 0) & (blens > 0) & (a_has_null | b_has_null) \
            & ~common
        return ColumnVector(T.BOOLEAN, common, _valid_of(a, ctx)
                            & _valid_of(b, ctx) & ~unknown)

    def eval_cpu(self, cols, ansi=False):
        a = self.children[0].eval_cpu(cols, ansi)
        b = self.children[1].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (av, aok), (bv, bok) in zip(zip(a.values, a.valid),
                                        zip(b.values, b.valid)):
            if not aok or av is None or not bok or bv is None:
                out_v.append(False)
                out_ok.append(False)
                continue
            bs = set(_set_key(x) for x in bv if x is not None)
            common = any(x is not None and _set_key(x) in bs for x in av)
            has_null = (any(x is None for x in av)
                        or any(x is None for x in bv))
            out_v.append(common)
            out_ok.append(not (len(av) > 0 and len(bv) > 0 and has_null
                               and not common))
        return CpuCol(T.BOOLEAN, np.asarray(out_v, np.bool_),
                      np.asarray(out_ok, np.bool_))


def _concat_arrays(a: ColumnVector, b: ColumnVector,
                   out_t: T.ArrayType) -> ColumnVector:
    """Row-wise a ++ b: the two children side by side in one plane of
    both capacities, gathered into row order (any element type)."""
    from spark_rapids_tpu_torch.ops import kernels as K
    cap = a.capacity
    astart, alens = _offsets(a)
    bstart, blens = _offsets(b)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=alens.device),
                         torch.cumsum(alens + blens, 0)])
    a_child = _as_type(a.data["child"], out_t.element)
    b_child = _as_type(b.data["child"], out_t.element)
    na, nb = a_child.capacity, b_child.capacity
    both = K._concat_columns([a_child, b_child], [na, nb], na + nb)
    e = torch.arange(na + nb, dtype=torch.int64, device=alens.device)
    seg = (torch.searchsorted(new_off, e, right=True) - 1).clamp(0, cap - 1)
    j = e - new_off[seg]
    from_a = j < alens[seg]
    src = torch.where(from_a, astart[seg] + j, na + bstart[seg]
                      + (j - alens[seg]))
    src = torch.where(e < new_off[cap], src, -1)
    return ColumnVector(out_t, {
        "offsets": new_off.to(torch.int32),
        "child": K.gather_column(both, src, na + nb)}, None)


class MapEntries(Expression):
    """map_entries(m) -> array<struct<key,value>>: the map's planes under
    another type (offsets + a struct of the key and value children)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        mt = self.children[0].data_type()
        return T.ArrayType(T.StructType((
            T.StructField("key", mt.key, False),
            T.StructField("value", mt.value))))

    def with_children(self, children):
        return MapEntries(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        m = self.children[0].eval(ctx)
        st = self.data_type().element
        child = ColumnVector(st, {"children": [m.data["keys"],
                                               m.data["values"]]}, None)
        return ColumnVector(self.data_type(), {"offsets": m.data["offsets"],
                                               "child": child}, m.validity)

    def eval_cpu(self, cols, ansi=False):
        m = self.children[0].eval_cpu(cols, ansi)
        out = [None if (not ok or v is None)
               else [{"key": k, "value": x} for k, x in v]
               for v, ok in zip(m.values, m.valid)]
        return _obj_col(self.data_type(), out, m.valid.copy())


# ---------------------------------------------------------------------------
# The host tier: planning sends these to the CPU, as the JAX package does
# ---------------------------------------------------------------------------

class _CpuCollection(Expression):
    def supported_on_tpu(self):
        return False

    def with_children(self, children):
        return type(self)(*children)

    def eval(self, ctx):
        raise NotImplementedError(f"{type(self).__name__} runs on CPU")


class ArrayRepeat(_CpuCollection):
    """array_repeat(v, n)."""

    def __init__(self, value: Expression, count: Expression):
        self.children = [_wrap(value), _wrap(count)]

    def data_type(self):
        return T.ArrayType(self.children[0].data_type())

    def eval_cpu(self, cols, ansi=False):
        v = self.children[0].eval_cpu(cols, ansi)
        n = self.children[1].eval_cpu(cols, ansi)
        out, ok = [], []
        for i, (cnt, cok) in enumerate(zip(n.values, n.valid)):
            if not cok:
                out.append(None)
                ok.append(False)
                continue
            val = v.values[i]
            val = val.item() if isinstance(val, np.generic) else val
            out.append([val if v.valid[i] else None] * max(int(cnt), 0))
            ok.append(True)
        return _obj_col(self.data_type(), out, np.asarray(ok, np.bool_))


class ArrayJoin(_CpuCollection):
    """array_join(arr, sep[, nullReplacement])."""

    def __init__(self, child: Expression, sep: str,
                 null_replacement: Optional[str] = None):
        self.children = [child]
        self.sep = sep
        self.null_replacement = null_replacement

    def _params(self):
        return f"{self.sep!r},{self.null_replacement!r}"

    def with_children(self, children):
        return ArrayJoin(children[0], self.sep, self.null_replacement)

    def data_type(self):
        return T.STRING

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        out = []
        for v, ok in zip(arr.values, arr.valid):
            if not ok or v is None:
                out.append(None)
                continue
            parts = []
            for el in v:
                if el is None:
                    if self.null_replacement is not None:
                        parts.append(self.null_replacement)
                else:
                    parts.append(el if isinstance(el, str) else str(el))
            out.append(self.sep.join(parts))
        return _obj_col(T.STRING, out, arr.valid.copy())


class ArraysZip(_CpuCollection):
    """arrays_zip(a, b, ...) -> array<struct<...>>, padded with nulls."""

    def __init__(self, children, names=None):
        self.children = list(children)
        self.names = list(names) if names else \
            [str(i) for i in range(len(self.children))]

    def _params(self):
        return ",".join(self.names)

    def with_children(self, children):
        return ArraysZip(children, self.names)

    def data_type(self):
        return T.ArrayType(T.StructType(tuple(
            T.StructField(n, c.data_type().element)
            for n, c in zip(self.names, self.children))))

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        out, ok = [], []
        for i in range(n):
            if not all(c.valid[i] and c.values[i] is not None for c in ins):
                out.append(None)
                ok.append(False)
                continue
            rows = [c.values[i] for c in ins]
            ln = max(len(r) for r in rows)
            out.append([{nm: (r[j] if j < len(r) else None)
                         for nm, r in zip(self.names, rows)}
                        for j in range(ln)])
            ok.append(True)
        return _obj_col(self.data_type(), out, np.asarray(ok, np.bool_))


class MapConcat(_CpuCollection):
    """map_concat(m1, m2, ...): a duplicate key is an error, Spark's
    default policy."""

    def __init__(self, children):
        self.children = list(children)

    def with_children(self, children):
        return MapConcat(children)

    def data_type(self):
        return self.children[0].data_type()

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        out, ok = [], []
        for i in range(n):
            if not all(c.valid[i] and c.values[i] is not None for c in ins):
                out.append(None)
                ok.append(False)
                continue
            seen, entries = set(), []
            for c in ins:
                for k, v in c.values[i]:
                    if k in seen:
                        raise SparkException(f"Duplicate map key {k}")
                    seen.add(k)
                    entries.append((k, v))
            out.append(entries)
            ok.append(True)
        return _obj_col(self.data_type(), out, np.asarray(ok, np.bool_))


class MapFromArrays(_CpuCollection):
    """map_from_arrays(keys, values)."""

    def __init__(self, keys: Expression, values: Expression):
        self.children = [keys, values]

    def data_type(self):
        return T.MapType(self.children[0].data_type().element,
                         self.children[1].data_type().element)

    def eval_cpu(self, cols, ansi=False):
        ks = self.children[0].eval_cpu(cols, ansi)
        vs = self.children[1].eval_cpu(cols, ansi)
        out, ok = [], []
        for (k, kok), (v, vok) in zip(zip(ks.values, ks.valid),
                                      zip(vs.values, vs.valid)):
            if not kok or k is None or not vok or v is None:
                out.append(None)
                ok.append(False)
                continue
            if len(k) != len(v):
                raise SparkException(
                    "map_from_arrays: key and value arrays differ in length")
            if any(x is None for x in k):
                raise SparkException("Cannot use null as map key")
            seen = set()
            for x in k:
                if x in seen:
                    raise SparkException(f"Duplicate map key {x}")
                seen.add(x)
            out.append(list(zip(k, v)))
            ok.append(True)
        return _obj_col(self.data_type(), out, np.asarray(ok, np.bool_))


class StrToMap(_CpuCollection):
    """str_to_map(s, pairDelim, keyValueDelim); both delimiters are
    regular expressions, as in Spark."""

    def __init__(self, child: Expression, pair_delim: str = ",",
                 kv_delim: str = ":"):
        self.children = [child]
        self.pair_delim = pair_delim
        self.kv_delim = kv_delim

    def _params(self):
        return f"{self.pair_delim!r},{self.kv_delim!r}"

    def with_children(self, children):
        return StrToMap(children[0], self.pair_delim, self.kv_delim)

    def data_type(self):
        return T.MapType(T.STRING, T.STRING)

    def eval_cpu(self, cols, ansi=False):
        import re
        c = self.children[0].eval_cpu(cols, ansi)
        pd = re.compile(self.pair_delim)
        kd = re.compile(self.kv_delim)
        out = []
        for s, ok in zip(c.values, c.valid):
            if not ok or not isinstance(s, str):
                out.append(None)
                continue
            entries, seen = [], set()
            for pair in pd.split(s):
                kv = kd.split(pair, maxsplit=1)
                k = kv[0]
                if k in seen:
                    raise SparkException(f"Duplicate map key {k!r}")
                seen.add(k)
                entries.append((k, kv[1] if len(kv) > 1 else None))
            out.append(entries)
        return _obj_col(self.data_type(), out, c.valid.copy())
