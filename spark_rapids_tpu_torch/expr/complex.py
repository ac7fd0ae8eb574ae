"""Complex-type expressions: arrays, structs and maps.

Counterpart of ``spark_rapids_tpu/expr/complex.py``: ``Size``,
``GetArrayItem``, ``ElementAt`` and ``GetMapValue`` (``_map_lookup``),
``GetStructField``, ``ArrayContains``, ``CreateArray``, ``MapKeys``,
``MapValues``, the generator markers ``Explode``/``ExplodeOuter``/
``PosExplode``/``PosExplodeOuter`` (``exec/nodes.GenerateExec`` does their
work) and ``Stack`` (``DataFrame.select`` lowers it onto an Expand).

Nested columns are offsets + child planes (``columnar/batch.py``).
Extraction is a gather of the child at each row's start + index; a
per-row question over the elements (contains, a map lookup) is a
scatter-min or scatter-any from each element to its owning row, found by
``searchsorted`` of the element index in the offsets. Every scatter goes
to a plane with one overflow slot more than it needs, which is cut away.
Each class has a numpy ``eval_cpu`` with the JAX package's Python
representation: an array row is a list, a struct row a dict, a map row a
list of (key, value) pairs.
"""
from __future__ import annotations

import datetime
import decimal
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import (
    Cast, CpuCol, EvalCtx, Expression, Literal, SparkException, _promote,
    _string_eq, _string_eq_literal, _valid_of, _wrap,
)

_OBJECT_TYPES = (T.StringType, T.ArrayType, T.StructType, T.MapType)


def _offsets_view(col: ColumnVector):
    """(int64 row starts, int64 row lengths) of an array or map column."""
    cap = col.capacity
    off = col.data["offsets"].to(torch.int64)
    return off[:cap], off[1: cap + 1] - off[:cap]


def _element_segments(off: torch.Tensor, cap: int,
                      child_cap: int) -> torch.Tensor:
    """Element index -> owning row index, int64 (elements past the last
    offset clip to the final row; callers mask them by an in-range
    test)."""
    off = off.to(torch.int64).contiguous()
    e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
    seg = torch.searchsorted(off, e, right=True) - 1
    return seg.clamp(0, cap - 1)


def _seg_any(slot: torch.Tensor, flag: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n]: does any element whose slot is r have ``flag`` set? Slots
    at n are the overflow slot."""
    acc = torch.zeros(n + 1, dtype=torch.int32, device=flag.device)
    acc.index_add_(0, slot, flag.to(torch.int32))
    return acc[:n] > 0


def _seg_min(slot: torch.Tensor, vals: torch.Tensor, n: int,
             init: int) -> torch.Tensor:
    """The least of ``vals`` per slot (``init`` where a slot has none)."""
    out = torch.full((n + 1,), init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, slot, vals, reduce="amin", include_self=True)
    return out[:n]


def _seg_max(slot: torch.Tensor, vals: torch.Tensor, n: int,
             init: int) -> torch.Tensor:
    out = torch.full((n + 1,), init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, slot, vals, reduce="amax", include_self=True)
    return out[:n]


def _gather_child(child: ColumnVector, pos: torch.Tensor) -> ColumnVector:
    from spark_rapids_tpu_torch.ops import kernels as K
    return K.gather_column(child, pos, child.capacity)


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def _cmp_child_to_row(child: ColumnVector, row_col: ColumnVector,
                      seg: torch.Tensor, row_literal=None):
    """Per element, child[e] == row_col[seg[e]]: (eq, both valid) bool
    planes over the child capacity. A string literal row value compares
    each element to its bytes directly."""
    from spark_rapids_tpu_torch.ops import kernels as K
    cv = child.validity if child.validity is not None \
        else _ones(child.capacity, child.device)
    if isinstance(child.dtype, T.StringType) and row_literal is not None:
        return _string_eq_literal(child, row_literal), cv
    row_at_e = K.gather_column(row_col, seg, row_col.capacity)
    rv = row_at_e.validity if row_at_e.validity is not None \
        else _ones(child.capacity, child.device)
    if isinstance(child.dtype, T.StringType):
        eq = _string_eq(child, row_at_e)
    else:
        out = T.common_type(child.dtype, row_at_e.dtype)
        l, r = _promote(child, row_at_e, out)
        eq = l == r
    return eq, cv & rv


def _string_literal(e: Expression) -> Optional[str]:
    if isinstance(e, Literal) and isinstance(e.dtype, T.StringType) \
            and e.value is not None:
        return e.value
    return None


def _np_scalar(v, dt: T.DataType):
    """A python value of the CPU representation as a numpy scalar of
    ``dt``: dates are days, timestamps microseconds and decimals their
    unscaled values."""
    if isinstance(v, datetime.datetime):
        if v.tzinfo is not None:
            v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        return (v - datetime.datetime(1970, 1, 1)) \
            // datetime.timedelta(microseconds=1)
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, decimal.Decimal):
        return int(v.scaleb(dt.scale).to_integral_value())
    return v


def _leaf_cpu_col(rt: T.DataType, vals: list, ok: list) -> CpuCol:
    valid = np.asarray(ok, np.bool_)
    if isinstance(rt, _OBJECT_TYPES):
        out = np.empty(len(vals), object)
        out[:] = vals
        return CpuCol(rt, out, valid)
    np_vals = np.array([0 if (v is None or not o) else _np_scalar(v, rt)
                        for v, o in zip(vals, ok)], rt.np_dtype)
    return CpuCol(rt, np_vals, valid)


def _py_value(c: CpuCol, i: int):
    """Row i of a CpuCol as the Python value an array element holds."""
    v = c.values[i]
    return v.item() if isinstance(v, np.generic) else v


class Size(Expression):
    """size(array|map); a null input is null (Spark's
    legacySizeOfNull=false)."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return Size(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        c = self.children[0].eval(ctx)
        _, lens = _offsets_view(c)
        return ColumnVector(T.INT32, lens.to(torch.int32), _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        vals = np.array([len(v) if ok and v is not None else 0
                         for v, ok in zip(c.values, c.valid)], np.int32)
        return CpuCol(T.INT32, vals, c.valid.copy())


class GetArrayItem(Expression):
    """arr[i]: 0-based; null when out of bounds (ANSI: an error)."""

    def __init__(self, child: Expression, ordinal: Expression):
        self.children = [child, _wrap(ordinal)]

    def data_type(self):
        return self.children[0].data_type().element

    def with_children(self, children):
        return GetArrayItem(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        idx = self.children[1].eval(ctx)
        start, lens = _offsets_view(arr)
        child = arr.data["child"]
        i = idx.data.to(torch.int64)
        both = _valid_of(arr, ctx) & _valid_of(idx, ctx)
        in_b = (i >= 0) & (i < lens)
        if ctx.ansi:
            ctx.add_error("ArrayIndexOutOfBounds", both & ~in_b)
        ok = both & in_b
        pos = torch.where(ok, (start + i).clamp(0, child.capacity - 1), -1)
        return _gather_child(child, pos)

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        idx = self.children[1].eval_cpu(cols, ansi)
        return _extract_cpu(self.data_type(), arr, idx, ansi)


def _extract_cpu(rt, arr: CpuCol, idx: CpuCol, ansi: bool) -> CpuCol:
    out_v, out_ok = [], []
    for (v, ok), (i, iok) in zip(zip(arr.values, arr.valid),
                                 zip(idx.values, idx.valid)):
        if not ok or not iok or v is None:
            out_v.append(None)
            out_ok.append(False)
            continue
        i = int(i)
        if 0 <= i < len(v):
            out_v.append(v[i])
            out_ok.append(v[i] is not None)
        else:
            if ansi:
                raise SparkException(
                    f"Index {i} out of bounds for array of {len(v)}")
            out_v.append(None)
            out_ok.append(False)
    return _leaf_cpu_col(rt, out_v, out_ok)


class ElementAt(Expression):
    """element_at(array, i): 1-based, a negative index counts from the
    end, index 0 is an error. element_at(map, key): the value or null."""

    def __init__(self, child: Expression, key: Expression):
        self.children = [child, _wrap(key)]

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, T.MapType):
            return dt.value
        return dt.element

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        c = self.children[0].eval(ctx)
        if isinstance(c.dtype, T.MapType):
            return _map_lookup(c, self.children[1], ctx)
        idx = self.children[1].eval(ctx)
        start, lens = _offsets_view(c)
        child = c.data["child"]
        i = idx.data.to(torch.int64)
        both = _valid_of(c, ctx) & _valid_of(idx, ctx)
        ctx.add_error("ElementAtIndexZero", both & (i == 0))
        eff = torch.where(i > 0, i - 1, lens + i)
        in_b = (eff >= 0) & (eff < lens)
        if ctx.ansi:
            ctx.add_error("ArrayIndexOutOfBounds", both & (i != 0) & ~in_b)
        ok = both & in_b & (i != 0)
        pos = torch.where(ok, (start + eff).clamp(0, child.capacity - 1), -1)
        return _gather_child(child, pos)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        k = self.children[1].eval_cpu(cols, ansi)
        if isinstance(self.children[0].data_type(), T.MapType):
            return _map_lookup_cpu(self.data_type(), c, k)
        out_v, out_ok = [], []
        for (v, ok), (i, iok) in zip(zip(c.values, c.valid),
                                     zip(k.values, k.valid)):
            if not ok or not iok or v is None:
                out_v.append(None)
                out_ok.append(False)
                continue
            i = int(i)
            if i == 0:
                raise SparkException("SQL array indices start at 1")
            eff = i - 1 if i > 0 else len(v) + i
            if 0 <= eff < len(v):
                out_v.append(v[eff])
                out_ok.append(v[eff] is not None)
            else:
                if ansi:
                    raise SparkException(
                        f"Index {i} out of bounds for array of {len(v)}")
                out_v.append(None)
                out_ok.append(False)
        return _leaf_cpu_col(self.data_type(), out_v, out_ok)


def _map_lookup(m: ColumnVector, key_expr: Expression,
                ctx: EvalCtx) -> ColumnVector:
    """The value of each row's first entry whose key equals the row's
    key: a scatter-min of the matching element indices to their rows."""
    key = key_expr.eval(ctx)
    keys, values = m.data["keys"], m.data["values"]
    cap = m.capacity
    off = m.data["offsets"].to(torch.int64)
    child_cap = keys.capacity
    seg = _element_segments(off[: cap + 1], cap, child_cap)
    eq, both = _cmp_child_to_row(keys, key, seg, _string_literal(key_expr))
    e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
    match = eq & both & (e < off[cap])
    first = _seg_min(seg, torch.where(match, e, child_cap), cap, child_cap)
    row_ok = _valid_of(m, ctx) & _valid_of(key, ctx) & (first < child_cap)
    pos = torch.where(row_ok, first.clamp(0, child_cap - 1), -1)
    return _gather_child(values, pos)


def _map_lookup_cpu(rt, m: CpuCol, k: CpuCol) -> CpuCol:
    out_v, out_ok = [], []
    for (v, ok), (key, kok) in zip(zip(m.values, m.valid),
                                   zip(k.values, k.valid)):
        hit = None
        if ok and kok and v is not None:
            for kk, vv in v:
                if kk == key:
                    hit = vv
                    break
        out_v.append(hit)
        out_ok.append(hit is not None)
    return _leaf_cpu_col(rt, out_v, out_ok)


class GetMapValue(ElementAt):
    """map[key], the same as element_at(map, key)."""


class GetStructField(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = [child]
        self.field_name = name

    def _field_index(self):
        st = self.children[0].data_type()
        for i, f in enumerate(st.fields):
            if f.name == self.field_name:
                return i
        raise SparkException(f"No such struct field {self.field_name} in "
                             f"{st!r}")

    def data_type(self):
        st = self.children[0].data_type()
        return st.fields[self._field_index()].dtype

    def _params(self):
        return self.field_name

    def with_children(self, children):
        return GetStructField(children[0], self.field_name)

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        c = self.children[0].eval(ctx)
        kid = c.data["children"][self._field_index()]
        kv = kid.validity if kid.validity is not None else ctx.row_mask
        return ColumnVector(kid.dtype, kid.data, kv & _valid_of(c, ctx),
                            dict_unique=kid.dict_unique)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        name = self.field_name
        vals = [None if (not ok or v is None) else v.get(name)
                for v, ok in zip(c.values, c.valid)]
        return _leaf_cpu_col(self.data_type(), vals,
                             [v is not None for v in vals])


class ArrayContains(Expression):
    """array_contains(arr, v), with Spark's nulls: null if arr or v is
    null; true when found; null when not found but the array holds a
    null; false otherwise."""

    def __init__(self, child: Expression, value: Expression):
        self.children = [child, _wrap(value)]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        val = self.children[1].eval(ctx)
        cap = arr.capacity
        off = arr.data["offsets"].to(torch.int64)
        child = arr.data["child"]
        child_cap = child.capacity
        seg = _element_segments(off[: cap + 1], cap, child_cap)
        eq, both = _cmp_child_to_row(child, val, seg,
                                     _string_literal(self.children[1]))
        e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
        in_range = e < off[cap]
        found = _seg_any(seg, eq & both & in_range, cap)
        cv = child.validity if child.validity is not None \
            else _ones(child_cap, child.device)
        has_null = _seg_any(seg, ~cv & in_range, cap)
        inputs_ok = _valid_of(arr, ctx) & _valid_of(val, ctx)
        return ColumnVector(T.BOOLEAN, found, inputs_ok & (found | ~has_null))

    def eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        val = self.children[1].eval_cpu(cols, ansi)
        out_v, out_ok = [], []
        for (v, ok), (x, xok) in zip(zip(arr.values, arr.valid),
                                     zip(val.values, val.valid)):
            if not ok or v is None or not xok:
                out_v.append(False)
                out_ok.append(False)
                continue
            found = any(el is not None and el == x for el in v)
            has_null = any(el is None for el in v)
            out_v.append(found)
            out_ok.append(found or not has_null)
        return CpuCol(T.BOOLEAN, np.asarray(out_v, np.bool_),
                      np.asarray(out_ok, np.bool_))


class CreateArray(Expression):
    """array(e1, e2, ...): fixed-width elements interleave into one child
    plane of capacity x k; other element types run on the CPU."""

    def __init__(self, children: List[Expression]):
        self.children = [_wrap(c) for c in children]

    def data_type(self):
        if not self.children:
            return T.ArrayType(T.NULL)
        dt = self.children[0].data_type()
        for c in self.children[1:]:
            dt = T.common_type(dt, c.data_type())
        return T.ArrayType(dt)

    def with_children(self, children):
        return CreateArray(children)

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        elem_t = self.data_type().element
        cap = ctx.capacity
        if not self.children:  # array(): an empty array<null> per row
            return ColumnVector(self.data_type(), {
                "offsets": torch.zeros(cap + 1, dtype=torch.int32,
                                       device=ctx.device),
                "child": Literal(None, T.NULL).eval(
                    EvalCtx([], 1, 1, ctx.device))}, None)
        cols = [(c if c.data_type() == elem_t else Cast(c, elem_t)).eval(ctx)
                for c in self.children]
        k = len(cols)
        data = torch.stack([c.data for c in cols], dim=1).reshape(-1)
        valid = torch.stack([_valid_of(c, ctx) for c in cols],
                            dim=1).reshape(-1)
        offsets = torch.arange(cap + 1, dtype=torch.int32,
                               device=ctx.device) * k
        return ColumnVector(self.data_type(), {
            "offsets": offsets, "child": ColumnVector(elem_t, data, valid)},
            None)

    def eval_cpu(self, cols, ansi=False):
        elem_t = self.data_type().element
        parts = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(parts[0].values) if parts else \
            (len(cols[0].values) if cols else 0)
        out = []
        for i in range(n):
            row = []
            for p in parts:
                if not p.valid[i]:
                    row.append(None)
                    continue
                v = _py_value(p, i)
                if elem_t.np_dtype is not None and v is not None \
                        and not isinstance(elem_t, T.StringType):
                    v = np.dtype(elem_t.np_dtype).type(v).item()
                row.append(v)
            out.append(row)
        vals = np.empty(n, object)
        vals[:] = out
        return CpuCol(self.data_type(), vals, np.ones(n, np.bool_))


class MapKeys(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return T.ArrayType(self.children[0].data_type().key,
                           contains_null=False)

    def with_children(self, children):
        return MapKeys(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        m = self.children[0].eval(ctx)
        return ColumnVector(self.data_type(), {"offsets": m.data["offsets"],
                                               "child": m.data["keys"]},
                            m.validity)

    def eval_cpu(self, cols, ansi=False):
        m = self.children[0].eval_cpu(cols, ansi)
        return _obj_col(self.data_type(),
                        [None if (not ok or v is None) else [k for k, _ in v]
                         for v, ok in zip(m.values, m.valid)], m.valid.copy())


class MapValues(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return T.ArrayType(self.children[0].data_type().value)

    def with_children(self, children):
        return MapValues(children[0])

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        m = self.children[0].eval(ctx)
        return ColumnVector(self.data_type(), {"offsets": m.data["offsets"],
                                               "child": m.data["values"]},
                            m.validity)

    def eval_cpu(self, cols, ansi=False):
        m = self.children[0].eval_cpu(cols, ansi)
        return _obj_col(self.data_type(),
                        [None if (not ok or v is None) else [x for _, x in v]
                         for v, ok in zip(m.values, m.valid)], m.valid.copy())


def _obj_col(dtype: T.DataType, rows: list, valid: np.ndarray) -> CpuCol:
    """An object column that never collapses equal-length rows into a 2-D
    array, as ``np.array(rows, object)`` would."""
    vals = np.empty(len(rows), object)
    for i, r in enumerate(rows):
        vals[i] = r
    return CpuCol(dtype, vals, valid)


# ---------------------------------------------------------------------------
# Generators: plan-level markers. ``DataFrame.select`` turns them into a
# Generate node, whose operator (exec/nodes.GenerateExec) does the work.
# ---------------------------------------------------------------------------

class Explode(Expression):
    """explode(array|map) / explode_outer: valid only as a select item."""

    outer = False
    position = False

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, T.MapType):
            return T.StructType((T.StructField("key", dt.key, False),
                                 T.StructField("value", dt.value)))
        return dt.element

    def with_children(self, children):
        return type(self)(children[0])

    def output_fields(self, alias: Optional[str] = None):
        dt = self.children[0].data_type()
        if not isinstance(dt, (T.ArrayType, T.MapType)):
            raise SparkException(
                f"explode() requires an array or map input, got {dt!r}")
        if isinstance(dt, T.MapType):
            return [("key", dt.key), ("value", dt.value)]
        return [(alias or "col", dt.element)]


class ExplodeOuter(Explode):
    outer = True


class PosExplode(Explode):
    position = True

    def output_fields(self, alias: Optional[str] = None):
        return [("pos", T.INT32)] + super().output_fields(alias)


class PosExplodeOuter(PosExplode):
    outer = True


class Stack(Expression):
    """stack(n, e1..ek): n output rows per input row, ceil(k/n) columns
    named col0..col{m-1}, short rows null-filled. ``DataFrame.select``
    lowers it onto an Expand of the n row projections, or a union of n
    selects when other items need their own lowering."""

    def __init__(self, n: int, *exprs):
        if n <= 0:
            raise SparkException("stack(): row count must be positive")
        if not exprs:
            raise SparkException("stack() needs at least one value")
        self.n = int(n)
        self.children = list(exprs)

    def _params(self):
        return str(self.n)

    def with_children(self, children):
        return Stack(self.n, *children)

    @property
    def ncols(self):
        return -(-len(self.children) // self.n)

    def output_fields(self):
        cols = []
        for j in range(self.ncols):
            dt = self.children[j].data_type()
            for r in range(1, self.n):
                i = r * self.ncols + j
                if i < len(self.children):
                    other = self.children[i].data_type()
                    if other != dt and not isinstance(dt, T.NullType):
                        if isinstance(other, T.NullType):
                            continue
                        raise SparkException(
                            f"stack(): column {j} mixes {dt!r} and "
                            f"{other!r}")
                    if isinstance(dt, T.NullType):
                        dt = other
            cols.append((f"col{j}", dt))
        return cols

    def row_exprs(self):
        """The n per-row projections, padded with typed nulls."""
        fields = self.output_fields()
        rows = []
        for r in range(self.n):
            row = []
            for j, (_, dt) in enumerate(fields):
                i = r * self.ncols + j
                if i >= len(self.children) or isinstance(
                        self.children[i].data_type(), T.NullType):
                    # an explicit NULL takes the merged column type: the
                    # Expand's schema is projection 0's
                    row.append(Literal(None, dt))
                else:
                    row.append(self.children[i])
            rows.append(row)
        return rows

    def data_type(self):
        raise SparkException("stack() is only valid in select()")

    def eval(self, ctx):
        raise SparkException("stack() is only valid in select()")

    def eval_cpu(self, cols, ansi=False):
        raise SparkException("stack() is only valid in select()")
