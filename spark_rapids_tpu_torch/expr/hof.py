"""Higher-order functions over arrays and maps (lambda expressions).

Counterpart of ``spark_rapids_tpu/expr/hof.py``: ``LambdaVar``,
``make_lambda``, ``ArrayTransform``, ``ArrayFilter``, ``ArrayExists``/
``ArrayForAll`` (Spark's three-valued logic), ``TransformValues``,
``TransformKeys``, ``MapFilter``, ``ZipWith`` and ``ArrayAggregate``.

A lambda body is an ordinary expression tree evaluated ONCE over the
element plane of the collection (its child column), not per row: lambda
variables bind to element columns through ``EvalCtx.lambda_bindings``,
and outer column references are gathered to element positions through
``ops/kernels.LazyGatheredCols`` with the element -> row map of
``expr/complex._element_segments``; an array or map read from outside
repeats once per element, so its gather grows the child planes
(``_gather_rows``). A nested lambda inherits its enclosing bindings,
gathered to its own element plane the same way (the JAX package passes
them on unchanged, at the outer plane's length: ROADMAP C17). Every
scatter from elements to rows (or from kept
elements to their compacted slots) goes to a plane with one overflow
slot more than it needs, which is cut away.

``aggregate``/``reduce`` is a sequential per-row fold with an arbitrary
merge lambda, so it runs on the CPU tier (``supported_on_tpu`` False), as
in the JAX package. The CPU tier (``eval_cpu``) binds lambda variables in
thread-local storage (``_bound_cpu``): partitions evaluate concurrently.
"""
from __future__ import annotations

import datetime
import decimal
import itertools
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector, LazyRowCount
from spark_rapids_tpu_torch.expr.complex import (
    _element_segments, _leaf_cpu_col, _obj_col, _seg_any,
)
from spark_rapids_tpu_torch.expr.core import (
    CpuCol, EvalCtx, Expression, SparkException, _valid_of, _wrap,
)

_ids = itertools.count()

#: lambda-variable bindings of the CPU tier (the device's ride on the
#: EvalCtx); thread-local, since partitions evaluate concurrently
_tls = threading.local()
_MISSING = object()


def _cpu_bindings() -> dict:
    if not hasattr(_tls, "b"):
        _tls.b = {}
    return _tls.b


class _bound_cpu:
    """Scoped CPU-tier lambda bindings: updates the live thread-local dict
    in place and restores what it shadowed on exit."""

    def __init__(self, bindings: dict):
        self.bindings = bindings

    def __enter__(self):
        b = _cpu_bindings()
        self.saved = {k: b.get(k, _MISSING) for k in self.bindings}
        b.update(self.bindings)

    def __exit__(self, *exc):
        b = _cpu_bindings()
        for k, v in self.saved.items():
            if v is _MISSING:
                b.pop(k, None)
            else:
                b[k] = v


class LambdaVar(Expression):
    """A named lambda parameter: a leaf that resolves to the column the
    enclosing higher-order function bound it to."""

    def __init__(self, dtype: T.DataType, name: str):
        self.children = []
        self.dtype = dtype
        self.name = name
        self.var_id = next(_ids)

    def data_type(self):
        return self.dtype

    def _params(self):
        # the id is not part of the fingerprint: two lambdas of the same
        # structure print alike
        return f"{self.name}:{self.dtype!r}"

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        binding = ctx.lambda_bindings.get(self.var_id)
        if binding is None:
            raise SparkException(f"unbound lambda variable {self.name}")
        return binding

    def eval_cpu(self, cols, ansi=False):
        binding = _cpu_bindings().get(self.var_id)
        if binding is None:
            raise SparkException(f"unbound lambda variable {self.name}")
        return binding


def make_lambda(fn: Callable, arg_types: Sequence[T.DataType],
                names: Sequence[str]) -> tuple:
    """(body, vars) from a Python callable over Expression arguments."""
    vs = [LambdaVar(dt, nm) for dt, nm in zip(arg_types, names)]
    return _wrap(fn(*vs)), vs


def bind_lambda_types(e: Expression) -> Expression:
    """Resolve the parameter types of every higher-order function in
    ``e``, outermost first (a nested lambda's collection may be typed by
    an enclosing parameter), before a bottom-up rewrite reads them."""
    if isinstance(e, _HofBase):
        e._bind_types()
    for c in e.children:
        bind_lambda_types(c)
    return e


def _gather_rows(col: ColumnVector, idx: torch.Tensor, src_rows,
                 src_live=None) -> ColumnVector:
    """Row gather that may repeat rows: ``ops/kernels.gather_column``,
    except that an array or map column (also inside a struct) gets child
    planes as large as the repeated rows need (one host read of the
    element count), where a permuting gather keeps the capacity."""
    from spark_rapids_tpu_torch.columnar.batch import round_capacity
    from spark_rapids_tpu_torch.ops import kernels as K
    if not col.is_nested:
        return K.gather_column(col, idx, src_rows, src_live=src_live)
    safe = idx.clamp(0, col.capacity - 1).to(torch.int64)
    if src_live is not None:
        src_valid = src_live if col.validity is None \
            else col.validity & src_live
    else:
        src_valid = col.validity_or_default(src_rows)
    valid = src_valid[safe] & (idx >= 0)
    if isinstance(col.dtype, T.StructType):
        kids = [_gather_rows(ch, idx, src_rows, src_live)
                for ch in col.data["children"]]
        return ColumnVector(col.dtype, {"children": kids}, valid)
    off = col.data["offsets"].to(torch.int64)
    lens = torch.where(valid, (off[1:] - off[:-1])[safe], 0)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=off.device), lens.cumsum(0)])
    total = int(new_off[-1].item())
    cap = round_capacity(max(total, 1))
    e = torch.arange(cap, dtype=torch.int64, device=off.device)
    orow = (torch.searchsorted(new_off, e, right=True) - 1).clamp(
        0, safe.shape[0] - 1)
    src_e = off[safe[orow]] + (e - new_off[orow])
    data = {"offsets": new_off.to(torch.int32)}
    for nm in K.element_planes(col):
        child = col.data[nm]
        data[nm] = _gather_rows(
            child, torch.where(e < total, src_e.clamp(0, child.capacity - 1),
                               -1), child.capacity)
    return ColumnVector(col.dtype, data, valid)


def _nested_ctx(ctx: EvalCtx, capacity: int, in_range, row_idx,
                bindings: dict) -> EvalCtx:
    """The EvalCtx of a lambda body over ``capacity`` element slots, of
    which ``in_range`` are live and ``row_idx`` name their outer rows:
    outer columns gathered lazily, the enclosing lambda's bindings
    gathered too, then ``bindings`` installed."""
    from spark_rapids_tpu_torch.ops import kernels as K
    ectx = EvalCtx([], LazyRowCount(in_range.sum(dtype=torch.int32)),
                   capacity, ctx.device, ctx.ansi, live=in_range,
                   partition_id=ctx.partition_id, row_base=ctx.row_base)
    idx = torch.where(in_range, row_idx, -1)
    ectx.columns = K.LazyGatheredCols(ctx.columns, idx, ctx.num_rows,
                                      src_live=ctx.live, gather=_gather_rows)
    ectx.lambda_bindings = {
        k: _gather_rows(v, idx, v.capacity, src_live=ctx.live)
        for k, v in ctx.lambda_bindings.items()}
    ectx.lambda_bindings.update(bindings)
    return ectx


def _element_ctx(ctx: EvalCtx, arr: ColumnVector, bindings: dict):
    """The EvalCtx over the element plane of an array or map column, with
    outer columns gathered lazily to element positions and ``bindings``
    (var_id -> element column) installed over the inherited ones.
    Returns (ectx, seg, in_range, start): the element -> row map, the
    elements of live valid rows, and each row's first element."""
    cap = arr.capacity
    off = arr.data["offsets"].to(torch.int64)
    first = arr.data["child"] if "child" in arr.data else arr.data["keys"]
    child_cap = first.capacity
    seg = _element_segments(off[: cap + 1], cap, child_cap)
    e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
    row_live = ctx.row_mask & _valid_of(arr, ctx)
    in_range = (e < off[cap]) & row_live[seg]
    ectx = _nested_ctx(ctx, child_cap, in_range, seg, bindings)
    return ectx, seg, in_range, off[:cap]


def _index_col(seg, start, in_range) -> ColumnVector:
    """The element's position within its row, as an int32 column."""
    e = torch.arange(seg.shape[0], dtype=torch.int64, device=seg.device)
    idx = torch.where(in_range, e - start[seg], 0).to(torch.int32)
    return ColumnVector(T.INT32, idx, in_range)


def _compact(keep: torch.Tensor, seg, start, cap: int, child_cap: int):
    """The stable compaction of the kept elements within each row: (new
    int32 offsets, source element of each output slot, -1 past the
    end)."""
    ki = keep.to(torch.int64)
    ex = torch.cumsum(ki, 0) - ki  # exclusive prefix
    slot = torch.where(keep, seg, cap)
    per_row = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    per_row.index_add_(0, slot, ki)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=keep.device),
                         torch.cumsum(per_row[:cap], 0)])
    base = ex[start[seg].clamp(0, child_cap - 1)]
    dest = torch.where(keep, new_off[seg] + (ex - base), child_cap)
    e = torch.arange(child_cap, dtype=torch.int64, device=keep.device)
    src = torch.full((child_cap + 1,), -1, dtype=torch.int64,
                     device=keep.device)
    src.scatter_(0, dest, e)
    return new_off.to(torch.int32), src[:child_cap]


def _pred_true(pred: ColumnVector) -> torch.Tensor:
    keep = pred.data.to(torch.bool)
    if pred.validity is not None:
        keep = keep & pred.validity
    return keep


def _py_elem(dt: T.DataType, v):
    """A CPU value as the Python object an array element holds (Arrow's
    ``to_pylist`` form)."""
    if v is None:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(dt, T.DateType) and isinstance(v, int):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
    if isinstance(dt, T.TimestampType) and isinstance(v, int):
        return datetime.datetime(1970, 1, 1) \
            + datetime.timedelta(microseconds=v)
    if isinstance(dt, T.DecimalType) and isinstance(v, int):
        return decimal.Decimal(v).scaleb(-dt.scale)
    return v


def _cpu_rows_of(res: CpuCol, lens, row_ok, dt: T.DataType) -> list:
    """Split a flat CPU result back into one list per row (None for a
    null row)."""
    out, pos = [], 0
    for n, ok in zip(lens, row_ok):
        if not ok:
            out.append(None)
            continue
        out.append([_py_elem(dt, res.values[pos + j])
                    if res.valid[pos + j] else None for j in range(n)])
        pos += n
    return out


def _repeat_bindings(lens) -> dict:
    """The live CPU bindings with each row repeated ``lens`` times."""
    return {k: CpuCol(c.dtype, np.repeat(c.values, lens),
                      np.repeat(c.valid, lens))
            for k, c in _cpu_bindings().items()}


class _HofBase(Expression):
    """children[0] is the collection and children[1] the lambda body;
    ``vars`` are its parameters. Their dtypes resolve lazily (the
    collection's element type is known only once column references are
    bound), so every dtype-dependent entry point calls ``_bind_types``
    first."""

    def __init__(self, child: Expression, body: Expression,
                 vars: List[LambdaVar]):
        self.children = [child, body]
        self.vars = vars

    def _bind_types(self) -> None:
        dt = self.children[0].data_type()
        if isinstance(dt, T.MapType):
            if len(self.vars) > 0:
                self.vars[0].dtype = dt.key
            if len(self.vars) > 1:
                self.vars[1].dtype = dt.value
        elif isinstance(dt, T.ArrayType):
            self.vars[0].dtype = dt.element
            if len(self.vars) > 1:
                self.vars[1].dtype = T.INT32

    def data_type(self):
        self._bind_types()
        return self._result_type()

    def _result_type(self):
        raise NotImplementedError

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        self._bind_types()
        return self._eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        self._bind_types()
        return self._eval_cpu(cols, ansi)

    @property
    def body(self):
        return self.children[1]

    def _params(self):
        return ",".join(v._params() for v in self.vars)

    def with_children(self, children):
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.children = list(children)
        return clone

    # -- the CPU tier -------------------------------------------------------
    def _cpu_eval_body(self, bindings: dict, outer: Sequence[CpuCol],
                       ansi: bool, lens) -> CpuCol:
        """The body over the flat elements: the enclosing lambda's
        bindings repeated per element like the outer columns, then
        ``bindings`` over them."""
        with _bound_cpu({**_repeat_bindings(lens), **bindings}):
            return self.body.eval_cpu(outer, ansi)

    @staticmethod
    def _flatten_cpu(arr_col: CpuCol, elem_t: T.DataType):
        """(flat element CpuCol, per-row lengths, row validity)."""
        lens, flat, flat_ok = [], [], []
        for v, ok in zip(arr_col.values, arr_col.valid):
            if not ok or v is None:
                lens.append(0)
                continue
            lens.append(len(v))
            for el in v:
                flat.append(el)
                flat_ok.append(el is not None)
        return (_leaf_cpu_col(elem_t, flat, flat_ok),
                np.asarray(lens, np.int64), np.asarray(arr_col.valid,
                                                       np.bool_))

    @staticmethod
    def _outer_repeat(outer: Sequence[CpuCol], lens) -> List[CpuCol]:
        return [CpuCol(c.dtype, np.repeat(c.values, lens),
                       np.repeat(c.valid, lens)) for c in outer]

    def _array_bindings_cpu(self, cols, ansi):
        """(array CpuCol, flat elements, lengths, row validity, bindings
        of x and, for two parameters, the element index)."""
        arr = self.children[0].eval_cpu(cols, ansi)
        elem_t = self.children[0].data_type().element
        flat, lens, row_ok = self._flatten_cpu(arr, elem_t)
        bind = {self.vars[0].var_id: flat}
        if len(self.vars) > 1:
            idx = np.concatenate([np.arange(n) for n in lens]) \
                if lens.sum() else np.zeros(0, np.int64)
            bind[self.vars[1].var_id] = CpuCol(
                T.INT32, idx.astype(np.int32), np.ones(len(idx), np.bool_))
        return arr, flat, lens, row_ok, bind


class ArrayTransform(_HofBase):
    """transform(arr, x -> expr) / transform(arr, (x, i) -> expr)."""

    def _result_type(self):
        return T.ArrayType(self.body.data_type())

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        arr = self.children[0].eval(ctx)
        ectx, seg, in_range, start = _element_ctx(
            ctx, arr, {self.vars[0].var_id: arr.data["child"]})
        if len(self.vars) > 1:
            ectx.lambda_bindings[self.vars[1].var_id] = \
                _index_col(seg, start, in_range)
        out_child = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        return ColumnVector(self.data_type(),
                            {"offsets": arr.data["offsets"],
                             "child": out_child}, arr.validity)

    def _eval_cpu(self, cols, ansi=False):
        _, _, lens, row_ok, bind = self._array_bindings_cpu(cols, ansi)
        res = self._cpu_eval_body(bind, self._outer_repeat(cols, lens), ansi,
                                   lens)
        return _obj_col(self.data_type(),
                        _cpu_rows_of(res, lens, row_ok,
                                     self.body.data_type()), row_ok)


class ArrayFilter(_HofBase):
    """filter(arr, x -> bool) / filter(arr, (x, i) -> bool)."""

    def _result_type(self):
        return self.children[0].data_type()

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        arr = self.children[0].eval(ctx)
        child = arr.data["child"]
        ectx, seg, in_range, start = _element_ctx(
            ctx, arr, {self.vars[0].var_id: child})
        if len(self.vars) > 1:
            ectx.lambda_bindings[self.vars[1].var_id] = \
                _index_col(seg, start, in_range)
        pred = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        keep = _pred_true(pred) & in_range
        new_off, src = _compact(keep, seg, start, arr.capacity,
                                child.capacity)
        return ColumnVector(self.data_type(),
                            {"offsets": new_off,
                             "child": K.gather_column(child, src,
                                                      child.capacity)},
                            arr.validity)

    def _eval_cpu(self, cols, ansi=False):
        _, flat, lens, row_ok, bind = self._array_bindings_cpu(cols, ansi)
        pred = self._cpu_eval_body(bind, self._outer_repeat(cols, lens), ansi,
                                   lens)
        elem_t = self.children[0].data_type().element
        out, pos = [], 0
        for n, ok in zip(lens, row_ok):
            if not ok:
                out.append(None)
                continue
            out.append([_py_elem(elem_t, flat.values[pos + j])
                        if flat.valid[pos + j] else None
                        for j in range(n)
                        if pred.valid[pos + j] and bool(pred.values[pos + j])])
            pos += n
        return _obj_col(self.data_type(), out, row_ok)


class _ArrayPredicateBase(_HofBase):
    """exists/forall: a per-row three-valued reduction of the lambda's
    predicate."""

    def _result_type(self):
        return T.BOOLEAN

    def _tristate(self, ctx):
        arr = self.children[0].eval(ctx)
        ectx, seg, in_range, _ = _element_ctx(
            ctx, arr, {self.vars[0].var_id: arr.data["child"]})
        pred = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        pv = pred.data.to(torch.bool)
        pok = pred.validity if pred.validity is not None \
            else torch.ones_like(pv)
        cap = arr.capacity
        slot = torch.where(in_range, seg, cap)
        return (arr, _seg_any(slot, pv & pok, cap),
                _seg_any(slot, ~pv & pok, cap), _seg_any(slot, ~pok, cap))

    def _tristate_cpu(self, cols, ansi):
        _, _, lens, row_ok, bind = self._array_bindings_cpu(cols, ansi)
        pred = self._cpu_eval_body({self.vars[0].var_id:
                                    bind[self.vars[0].var_id]},
                                   self._outer_repeat(cols, lens), ansi,
                                   lens)
        row = np.repeat(np.arange(len(lens)), lens)
        pv = pred.values.astype(np.bool_)
        at = np.zeros(len(lens), np.bool_)
        af = np.zeros(len(lens), np.bool_)
        an = np.zeros(len(lens), np.bool_)
        at[row[pred.valid & pv]] = True
        af[row[pred.valid & ~pv]] = True
        an[row[~pred.valid]] = True
        return at, af, an, row_ok


class ArrayExists(_ArrayPredicateBase):
    """exists(arr, p): true if any element is true, else null if any is
    null, else false."""

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        arr, any_true, _, any_null = self._tristate(ctx)
        return ColumnVector(T.BOOLEAN, any_true, _valid_of(arr, ctx)
                            & (any_true | ~any_null))

    def _eval_cpu(self, cols, ansi=False):
        at, _, an, row_ok = self._tristate_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, at, row_ok & (at | ~an))


class ArrayForAll(_ArrayPredicateBase):
    """forall(arr, p): false if any element is false, else null if any is
    null, else true."""

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        arr, _, any_false, any_null = self._tristate(ctx)
        return ColumnVector(T.BOOLEAN, ~any_false, _valid_of(arr, ctx)
                            & (any_false | ~any_null))

    def _eval_cpu(self, cols, ansi=False):
        _, af, an, row_ok = self._tristate_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, ~af, row_ok & (af | ~an))


def _map_flat_cpu(node: _HofBase, cols, ansi):
    """(map CpuCol, keys, values, lengths, key and value CpuCols, result
    of the body over the entries)."""
    m = node.children[0].eval_cpu(cols, ansi)
    mt = node.children[0].data_type()
    lens, fk, fv = [], [], []
    for v, ok in zip(m.values, m.valid):
        if not ok or v is None:
            lens.append(0)
            continue
        lens.append(len(v))
        for kk, vv in v:
            fk.append(kk)
            fv.append(vv)
    lens = np.asarray(lens, np.int64)
    kc = _leaf_cpu_col(mt.key, fk, [k is not None for k in fk])
    vc = _leaf_cpu_col(mt.value, fv, [x is not None for x in fv])
    res = node._cpu_eval_body(
        {node.vars[0].var_id: kc, node.vars[1].var_id: vc},
        node._outer_repeat(cols, lens), ansi, lens)
    return m, fk, fv, lens, res


class TransformValues(_HofBase):
    """transform_values(map, (k, v) -> expr)."""

    def _result_type(self):
        mt = self.children[0].data_type()
        return T.MapType(mt.key, self.body.data_type())

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        m = self.children[0].eval(ctx)
        keys, values = m.data["keys"], m.data["values"]
        ectx, _, _, _ = _element_ctx(ctx, m, {self.vars[0].var_id: keys,
                                              self.vars[1].var_id: values})
        out_vals = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        return ColumnVector(self.data_type(),
                            {"offsets": m.data["offsets"], "keys": keys,
                             "values": out_vals}, m.validity)

    def _eval_cpu(self, cols, ansi=False):
        m, fk, _, lens, res = _map_flat_cpu(self, cols, ansi)
        rt = self.body.data_type()
        out, pos = [], 0
        for n, ok in zip(lens, m.valid):
            if not ok:
                out.append(None)
                continue
            out.append([(fk[pos + j], _py_elem(rt, res.values[pos + j])
                         if res.valid[pos + j] else None)
                        for j in range(n)])
            pos += n
        return _obj_col(self.data_type(), out, np.asarray(m.valid, np.bool_))


class TransformKeys(_HofBase):
    """transform_keys(map, (k, v) -> expr). A null or duplicate produced
    key raises (Spark's default EXCEPTION dedup policy)."""

    def _result_type(self):
        mt = self.children[0].data_type()
        return T.MapType(self.body.data_type(), mt.value)

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        m = self.children[0].eval(ctx)
        keys, values = m.data["keys"], m.data["values"]
        ectx, seg, in_range, _ = _element_ctx(
            ctx, m, {self.vars[0].var_id: keys, self.vars[1].var_id: values})
        out_keys = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        cap = m.capacity
        slot = torch.where(in_range, seg, cap)
        if out_keys.validity is not None:
            ctx.add_error("NullMapKey",
                          _seg_any(slot, ~out_keys.validity & in_range, cap))
        # duplicates: sort by (row, key) and compare neighbours
        k64, _ = K.normalize_key(out_keys, ectx.num_rows, live=in_range)
        o1 = torch.sort(k64, stable=True).indices
        o2 = torch.sort(slot[o1], stable=True).indices
        order = o1[o2]
        ss, kk = slot[order], k64[order]
        dup = (ss[1:] == ss[:-1]) & (kk[1:] == kk[:-1]) & (ss[1:] < cap)
        ctx.add_error("DuplicateMapKey",
                      _seg_any(torch.where(dup, ss[1:], cap), dup, cap))
        return ColumnVector(self.data_type(),
                            {"offsets": m.data["offsets"], "keys": out_keys,
                             "values": values}, m.validity)

    def _eval_cpu(self, cols, ansi=False):
        m, _, fv, lens, res = _map_flat_cpu(self, cols, ansi)
        rt = self.body.data_type()
        out, pos = [], 0
        for n, ok in zip(lens, m.valid):
            if not ok:
                out.append(None)
                continue
            entries, seen = [], set()
            for j in range(n):
                r = _py_elem(rt, res.values[pos + j]) \
                    if res.valid[pos + j] else None
                if r is None:
                    raise SparkException("Cannot use null as map key")
                if r in seen:
                    raise SparkException(f"Duplicate map key {r}")
                seen.add(r)
                entries.append((r, fv[pos + j]))
            out.append(entries)
            pos += n
        return _obj_col(self.data_type(), out, np.asarray(m.valid, np.bool_))


class MapFilter(_HofBase):
    """map_filter(map, (k, v) -> bool)."""

    def _result_type(self):
        return self.children[0].data_type()

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        m = self.children[0].eval(ctx)
        keys, values = m.data["keys"], m.data["values"]
        ectx, seg, in_range, start = _element_ctx(
            ctx, m, {self.vars[0].var_id: keys, self.vars[1].var_id: values})
        pred = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        keep = _pred_true(pred) & in_range
        child_cap = keys.capacity
        new_off, src = _compact(keep, seg, start, m.capacity, child_cap)
        return ColumnVector(self.data_type(),
                            {"offsets": new_off,
                             "keys": K.gather_column(keys, src, child_cap),
                             "values": K.gather_column(values, src,
                                                       child_cap)},
                            m.validity)

    def _eval_cpu(self, cols, ansi=False):
        m, fk, fv, lens, pred = _map_flat_cpu(self, cols, ansi)
        out, pos = [], 0
        for n, ok in zip(lens, m.valid):
            if not ok:
                out.append(None)
                continue
            out.append([(fk[pos + j], fv[pos + j]) for j in range(n)
                        if pred.valid[pos + j]
                        and bool(pred.values[pos + j])])
            pos += n
        return _obj_col(self.data_type(), out, np.asarray(m.valid, np.bool_))


class ZipWith(_HofBase):
    """zip_with(a, b, (x, y) -> expr): element-wise over both arrays, the
    shorter padded with nulls. A row is null when either array is."""

    def __init__(self, left: Expression, right: Expression,
                 body: Expression, vars: List[LambdaVar]):
        self.children = [left, body, right]
        self.vars = vars

    def _bind_types(self) -> None:
        lt = self.children[0].data_type()
        rt = self.children[2].data_type()
        if isinstance(lt, T.ArrayType):
            self.vars[0].dtype = lt.element
        if isinstance(rt, T.ArrayType):
            self.vars[1].dtype = rt.element

    def _result_type(self):
        return T.ArrayType(self.body.data_type())

    def _eval(self, ctx: EvalCtx) -> ColumnVector:
        from spark_rapids_tpu_torch.ops import kernels as K
        a = self.children[0].eval(ctx)
        b = self.children[2].eval(ctx)
        cap = a.capacity
        ac, bc = a.data["child"], b.data["child"]
        aoff = a.data["offsets"].to(torch.int64)
        boff = b.data["offsets"].to(torch.int64)
        alen = aoff[1: cap + 1] - aoff[:cap]
        blen = boff[1: cap + 1] - boff[:cap]
        row_ok = ctx.row_mask & _valid_of(a, ctx) & _valid_of(b, ctx)
        olen = torch.where(row_ok, torch.maximum(alen, blen), 0)
        new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                         device=aoff.device),
                             torch.cumsum(olen, 0)])
        # an output row holds at most len(a) + len(b) elements
        out_cap = ac.capacity + bc.capacity
        e = torch.arange(out_cap, dtype=torch.int64, device=aoff.device)
        seg = (torch.searchsorted(new_off, e, right=True) - 1).clamp(
            0, cap - 1)
        in_range = e < new_off[cap]
        j = e - new_off[seg]
        a_idx = torch.where(in_range & (j < alen[seg]), aoff[seg] + j, -1)
        b_idx = torch.where(in_range & (j < blen[seg]), boff[seg] + j, -1)
        ectx = _nested_ctx(ctx, out_cap, in_range, seg, {
            self.vars[0].var_id: K.gather_column(ac, a_idx, ac.capacity),
            self.vars[1].var_id: K.gather_column(bc, b_idx, bc.capacity)})
        out_child = self.body.eval(ectx)
        ctx.errors.extend(ectx.errors)
        return ColumnVector(self.data_type(),
                            {"offsets": new_off.to(torch.int32),
                             "child": out_child}, row_ok)

    def _eval_cpu(self, cols, ansi=False):
        a = self.children[0].eval_cpu(cols, ansi)
        b = self.children[2].eval_cpu(cols, ansi)
        at = self.children[0].data_type().element
        bt = self.children[2].data_type().element
        lens, fa, fb, row_ok = [], [], [], []
        for av, aok, bv, bok in zip(a.values, a.valid, b.values, b.valid):
            ok = bool(aok and bok and av is not None and bv is not None)
            row_ok.append(ok)
            if not ok:
                lens.append(0)
                continue
            n = max(len(av), len(bv))
            lens.append(n)
            for j in range(n):
                fa.append(av[j] if j < len(av) else None)
                fb.append(bv[j] if j < len(bv) else None)
        lens = np.asarray(lens, np.int64)
        row_ok = np.asarray(row_ok, np.bool_)
        res = self._cpu_eval_body(
            {self.vars[0].var_id: _leaf_cpu_col(at, fa,
                                                [v is not None for v in fa]),
             self.vars[1].var_id: _leaf_cpu_col(bt, fb,
                                                [v is not None for v in fb])},
            self._outer_repeat(cols, lens), ansi, lens)
        return _obj_col(self.data_type(),
                        _cpu_rows_of(res, lens, row_ok,
                                     self.body.data_type()), row_ok)


class ArrayAggregate(_HofBase):
    """aggregate(arr, zero, (acc, x) -> merge[, acc -> finish]): a
    sequential per-row fold, order-dependent with an arbitrary merge
    lambda, so it runs on the CPU tier, as in the JAX package."""

    def __init__(self, child: Expression, zero: Expression,
                 merge_body: Expression, merge_vars: List[LambdaVar],
                 finish_body: Optional[Expression] = None,
                 finish_vars: Optional[List[LambdaVar]] = None):
        self.children = [child, merge_body, _wrap(zero)] + \
            ([finish_body] if finish_body is not None else [])
        self.vars = merge_vars
        self.finish_vars = finish_vars or []

    @property
    def merge_body(self):
        return self.children[1]

    @property
    def finish_body(self):
        return self.children[3] if len(self.children) > 3 else None

    def _result_type(self):
        fb = self.finish_body
        return fb.data_type() if fb is not None \
            else self.merge_body.data_type()

    def supported_on_tpu(self):
        return False

    def _bind_types(self) -> None:
        dt = self.children[0].data_type()
        if isinstance(dt, T.ArrayType):
            self.vars[1].dtype = dt.element
        self.vars[0].dtype = self.children[2].data_type()
        if self.finish_vars:
            self.finish_vars[0].dtype = self.merge_body.data_type()

    def _eval(self, ctx):
        raise NotImplementedError("aggregate() folds run on the CPU")

    def _eval_cpu(self, cols, ansi=False):
        arr = self.children[0].eval_cpu(cols, ansi)
        zero = self.children[2].eval_cpu(cols, ansi)
        elem_t = self.children[0].data_type().element
        acc_t = self.merge_body.data_type()
        n = len(arr.values)
        acc_vals = list(zero.values)
        acc_ok = list(zero.valid)
        lens = [len(v) if ok and v is not None else 0
                for v, ok in zip(arr.values, arr.valid)]
        for step in range(max(lens, default=0)):
            active = [i for i in range(n) if step < lens[i]]
            xs = [arr.values[i][step] for i in active]
            sub_acc = _leaf_cpu_col(acc_t, [acc_vals[i] for i in active],
                                    [acc_ok[i] for i in active])
            sub_x = _leaf_cpu_col(elem_t, xs, [x is not None for x in xs])
            idx = np.asarray(active, np.int64)
            inherited = {k: CpuCol(c.dtype, c.values[idx], c.valid[idx])
                         for k, c in _cpu_bindings().items()}
            with _bound_cpu({**inherited, self.vars[0].var_id: sub_acc,
                             self.vars[1].var_id: sub_x}):
                res = self.merge_body.eval_cpu(
                    [CpuCol(c.dtype, c.values[idx], c.valid[idx])
                     for c in cols], ansi)
            for j, i in enumerate(active):
                acc_vals[i] = res.values[j]
                acc_ok[i] = bool(res.valid[j])
        row_ok = np.asarray(arr.valid, np.bool_)
        if self.finish_body is not None:
            acc = _leaf_cpu_col(acc_t, acc_vals, acc_ok)
            with _bound_cpu({self.finish_vars[0].var_id: acc}):
                res = self.finish_body.eval_cpu(cols, ansi)
            return CpuCol(self.data_type(), res.values, res.valid & row_ok)
        out_ok = [bool(a and o) for a, o in zip(row_ok, acc_ok)]
        return _leaf_cpu_col(self.data_type(),
                             [v if ok else None
                              for v, ok in zip(acc_vals, out_ok)], out_ok)
