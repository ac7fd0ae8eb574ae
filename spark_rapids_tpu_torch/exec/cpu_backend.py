"""The CPU backend: a numpy/pandas interpreter of the plan algebra.

Counterpart of ``spark_rapids_tpu/exec/cpu_backend.py``, adapted to this
engine's types and plan nodes (decimals as unscaled int64 values; nested
rows in the JAX package's Python form: an array row is a list, a struct
row a dict, a map row a list of (key, value) pairs; no shuffle-file
scans yet). It runs an operator that planning tags
off the device (``exec/nodes.CpuFallbackExec``, ``apply_node``) and a
whole plan in ``spark.rapids.sql.mode=explainOnly`` or
``DataFrame.collect_cpu`` (``execute_cpu``). Its arithmetic is the JAX
package's, step for step, so a fallback answers exactly as the JAX
package's fallback does.

- Data currency is a list of ``CpuCol`` (numpy values + validity), one
  per column of the plan node's schema.
- Grouping and joining keys are normalized to exact integer codes first
  (``norm_key_np``), so SQL semantics hold where pandas' own NaN and NA
  rules differ: NaN groups with NaN, nulls group together, null join keys
  never match.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import decimal_arrow, decimal_unscaled
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import window as WE
from spark_rapids_tpu_torch.expr.complex import _leaf_cpu_col
from spark_rapids_tpu_torch.expr.core import CpuCol
from spark_rapids_tpu_torch.plan import nodes as P


# ---------------------------------------------------------------------------
# pyarrow <-> CpuCol
# ---------------------------------------------------------------------------

def table_to_cols(table: pa.Table) -> List[CpuCol]:
    out = []
    for i, field in enumerate(table.schema):
        dtype = T.from_arrow(field.type)
        arr = table.column(i).combine_chunks()
        valid = np.ones(len(arr), np.bool_) if arr.null_count == 0 \
            else np.asarray(arr.is_valid())
        if _is_object(dtype):
            vals = np.empty(len(arr), object)
            vals[:] = arr.to_pylist()
        elif isinstance(dtype, T.DecimalType):
            vals = decimal_unscaled(arr, dtype, valid)
        elif isinstance(dtype, T.TimestampType):
            vals = np.asarray(arr.cast(pa.timestamp("us")).fill_null(0)) \
                .astype("datetime64[us]").astype(np.int64)
        elif isinstance(dtype, T.DateType):
            vals = np.asarray(arr.fill_null(0)).astype("datetime64[D]") \
                .astype(np.int32)
        elif isinstance(dtype, T.NullType):
            vals = np.zeros(len(arr), np.int8)
            valid = np.zeros(len(arr), np.bool_)
        else:
            fill = False if pa.types.is_boolean(arr.type) else 0
            vals = np.asarray(arr.fill_null(fill)).astype(dtype.np_dtype)
        out.append(CpuCol(dtype, vals, valid))
    return out


def cols_to_table(cols: List[CpuCol], names: List[str]) -> pa.Table:
    arrays, fields = [], []
    for c, name in zip(cols, names):
        at = T.to_arrow(c.dtype)
        if isinstance(c.dtype, T.StringType):
            vals = [v if (ok and isinstance(v, str)) else None
                    for v, ok in zip(c.values, c.valid)]
            arr = pa.array(vals, type=at)
        elif isinstance(c.dtype, (T.ArrayType, T.StructType, T.MapType)):
            arr = pa.array([v if ok else None
                            for v, ok in zip(c.values, c.valid)], type=at)
        elif isinstance(c.dtype, T.NullType):
            arr = pa.nulls(len(c.values), type=at)
        elif isinstance(c.dtype, T.DecimalType):
            arr = decimal_arrow(c.values, c.dtype, c.valid)
        elif isinstance(c.dtype, T.TimestampType):
            arr = pa.array(c.values.astype("datetime64[us]"), type=at,
                           mask=~c.valid)
        elif isinstance(c.dtype, T.DateType):
            arr = pa.array(c.values.astype(np.int32).astype("datetime64[D]"),
                           type=at, mask=~c.valid)
        else:
            arr = pa.array(c.values.astype(c.dtype.np_dtype), type=at,
                           mask=~c.valid)
        arrays.append(arr)
        fields.append(pa.field(name, at))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _is_object(dtype: T.DataType) -> bool:
    """Strings and nested types hold python objects on the CPU."""
    return isinstance(dtype, (T.StringType, T.ArrayType, T.StructType,
                              T.MapType))


def _gather_cols(cols: List[CpuCol], idx: np.ndarray) -> List[CpuCol]:
    """Row gather; an index of -1 gives a null."""
    out = []
    oob = idx < 0
    safe = np.where(oob, 0, idx)
    for c in cols:
        is_str = _is_object(c.dtype)
        if len(c.values) == 0:
            out.append(CpuCol(c.dtype, np.zeros(len(idx), object if is_str
                                                else c.dtype.np_dtype),
                              np.zeros(len(idx), np.bool_)))
            continue
        vals = c.values[safe]
        if is_str:
            vals = vals.copy()
            vals[oob] = None
        out.append(CpuCol(c.dtype, vals, c.valid[safe] & ~oob))
    return out


# ---------------------------------------------------------------------------
# Key normalization for grouping, joining and sorting (exact SQL semantics)
# ---------------------------------------------------------------------------

def norm_key_np(c: CpuCol, shared_dict: Optional[dict] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(uint64 order-preserving codes, null mask). ``shared_dict`` lets
    the two sides of a join share one string dictionary."""
    nulls = ~c.valid
    if isinstance(c.dtype, T.StringType):
        if shared_dict is None:
            shared_dict = _shared_string_dict(c)
        codes = np.array([shared_dict.get(v, 0) if ok else 0
                          for v, ok in zip(c.values, c.valid)], np.uint64)
        return codes, nulls
    if isinstance(c.dtype, (T.Float32Type, T.Float64Type)):
        v = c.values.astype(np.float64)
        v = np.where(v == 0.0, 0.0, v)  # -0.0 -> +0.0
        bits = np.where(np.isnan(v), np.uint64(0x7FF8000000000000),
                        v.view(np.uint64))
        neg = (bits >> np.uint64(63)) != 0
        key = np.where(neg, ~bits, bits | np.uint64(1 << 63))
        return np.where(nulls, np.uint64(0), key), nulls
    if isinstance(c.dtype, (T.ArrayType, T.StructType)):
        # Spark's nested order: lexicographic, a null element first, NaN
        # greatest; rows rank by a recursive tuple encoding
        keys = [(_encode_sortable(v, c.dtype) if ok else ())
                for v, ok in zip(c.values, c.valid)]
        ranks = np.zeros(len(keys), np.uint64)
        for pos, idx in enumerate(sorted(range(len(keys)),
                                         key=lambda i: keys[i])):
            ranks[idx] = pos
        return np.where(nulls, np.uint64(0), ranks), nulls
    if isinstance(c.dtype, T.MapType):
        from spark_rapids_tpu_torch.expr.core import SparkException
        raise SparkException("map type cannot be used in ORDER BY or "
                             "grouping keys")
    key = c.values.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    return np.where(nulls, np.uint64(0), key), nulls


def _encode_sortable(v, dt: T.DataType):
    """A tuple whose Python order is Spark's order of the nested value (a
    null element first, NaN greatest, -0.0 equal to 0.0)."""
    if isinstance(dt, T.ArrayType):
        return tuple((0,) if x is None
                     else (1, _encode_sortable(x, dt.element)) for x in v)
    if isinstance(dt, T.StructType):
        return tuple((0,) if v.get(f.name) is None
                     else (1, _encode_sortable(v[f.name], f.dtype))
                     for f in dt.fields)
    if isinstance(dt, (T.Float32Type, T.Float64Type)):
        fv = float(v)
        return (2, 0.0) if fv != fv else (1, 0.0 + fv)
    return (1, v)


def _shared_string_dict(*cols: CpuCol) -> dict:
    uniq = set()
    for c in cols:
        uniq |= {v for v, ok in zip(c.values, c.valid)
                 if ok and v is not None}
    return {s: i for i, s in enumerate(sorted(uniq))}


def _null_plane(nulls: np.ndarray, nulls_first: bool) -> np.ndarray:
    return np.where(nulls, 0 if nulls_first else 1,
                    1 if nulls_first else 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# Node interpreters
# ---------------------------------------------------------------------------

def execute_cpu(plan: P.PlanNode, ansi: bool = False) -> pa.Table:
    """The whole plan on the CPU."""
    return cols_to_table(_exec(plan, ansi), plan.schema.names)


def _exec(plan: P.PlanNode, ansi: bool) -> List[CpuCol]:
    return apply_node(plan, [_exec(c, ansi) for c in plan.children], ansi)


def apply_node(plan: P.PlanNode, children: List[List[CpuCol]],
               ansi: bool = False) -> List[CpuCol]:
    """One plan node over its children's results: the whole-plan
    interpreter's step, and a CPU fallback's work."""
    if isinstance(plan, P.InMemorySource):
        return table_to_cols(plan.table)
    if isinstance(plan, P.ParquetScan):
        import pyarrow.parquet as pq
        names = plan.file_columns if plan.columns else None
        tables = [plan.with_partition_cols(pq.read_table(p, columns=names), i)
                  for i, p in enumerate(plan.paths)]
        return table_to_cols(pa.concat_tables(tables,
                                              promote_options="permissive"))
    if isinstance(plan, P.TextScan):
        tables = [plan.read_host(p) for p in plan.paths]
        return table_to_cols(pa.concat_tables(tables,
                                              promote_options="permissive"))
    if isinstance(plan, P.CachedRelation):
        return children[0]
    if isinstance(plan, P.ShuffleFileScan):
        from spark_rapids_tpu_torch.columnar.batch import to_arrow
        from spark_rapids_tpu_torch.shuffle.exchange_files import (
            read_partition_batches,
        )
        tables = [to_arrow(b, plan.schema.names)
                  for r in range(plan.n_reduce)
                  for b in read_partition_batches(plan.root, r)]
        table = pa.concat_tables(tables) if tables else pa.table(
            {n: pa.array([], T.to_arrow(t))
             for n, t in zip(plan.schema.names, plan.schema.types)})
        return table_to_cols(table)
    if isinstance(plan, P.Range):
        vals = np.arange(plan.start, plan.end, plan.step, np.int64)
        return [CpuCol(T.INT64, vals, np.ones(len(vals), np.bool_))]
    if isinstance(plan, P.Project):
        return [e.eval_cpu(children[0], ansi) for e in plan.exprs]
    if isinstance(plan, P.Filter):
        pred = plan.condition.eval_cpu(children[0], ansi)
        keep = pred.values.astype(np.bool_) & pred.valid
        return _gather_cols(children[0], np.nonzero(keep)[0])
    if isinstance(plan, P.Aggregate):
        return _exec_aggregate(plan, children[0], ansi)
    if isinstance(plan, P.Sort):
        return _exec_sort(plan, children[0], ansi)
    if isinstance(plan, P.Limit):
        child = children[0]
        n = len(child[0].values) if child else 0
        return _gather_cols(child, np.arange(min(plan.n, n)))
    if isinstance(plan, P.Union):
        return _exec_union(plan, children)
    if isinstance(plan, P.Repartition):
        # partitioning is a physical layout: row-wise the result is the
        # child unchanged (comparisons downstream ignore order)
        return children[0]
    if isinstance(plan, P.WindowNode):
        return _exec_window(plan, children[0], ansi)
    if isinstance(plan, P.Join):
        return _exec_join(plan, children[0], children[1], ansi)
    if isinstance(plan, P.Generate):
        return _exec_generate(plan, children[0], ansi)
    if isinstance(plan, P.Expand):
        child = children[0]
        parts = [[e.eval_cpu(child, ansi) for e in proj]
                 for proj in plan.projections]
        out = []
        for i, dt in enumerate(plan.schema.types):
            vals = np.concatenate([_cast_vals(p[i], dt) for p in parts])
            valid = np.concatenate([p[i].valid for p in parts])
            out.append(CpuCol(dt, vals, valid))
        return out
    raise NotImplementedError(f"CPU backend: {type(plan).__name__}")


def _cast_vals(c: CpuCol, dt: T.DataType):
    if _is_object(dt):
        return c.values
    return c.values.astype(dt.np_dtype)


def _exec_generate(plan: P.Generate, child: List[CpuCol], ansi: bool
                   ) -> List[CpuCol]:
    gen = plan.generator
    src = gen.children[0].eval_cpu(child, ansi)
    is_map = isinstance(gen.children[0].data_type(), T.MapType)
    parent_idx: List[int] = []
    pos_vals: List = []
    gen_vals: List[list] = [[] for _ in plan.gen_fields]
    g_off = 1 if gen.position else 0
    for i, (v, ok) in enumerate(zip(src.values, src.valid)):
        items = v if (ok and v is not None) else None
        if not items:
            if gen.outer:
                parent_idx.append(i)
                pos_vals.append(None)
                for g in gen_vals:
                    g.append(None)
            continue
        for j, el in enumerate(items):
            parent_idx.append(i)
            pos_vals.append(j)
            if is_map:
                gen_vals[g_off].append(el[0])
                gen_vals[g_off + 1].append(el[1])
            else:
                gen_vals[g_off].append(el)
    if gen.position:
        gen_vals[0] = pos_vals
    out = _gather_cols([child[i] for i in plan.required],
                       np.asarray(parent_idx, np.int64))
    for (_, dt), vals in zip(plan.gen_fields, gen_vals):
        out.append(_leaf_cpu_col(dt, vals, [v is not None for v in vals]))
    return out


def _exec_union(plan: P.Union, parts: List[List[CpuCol]]) -> List[CpuCol]:
    out = []
    for i, f in enumerate(plan.schema.fields):
        vals = np.concatenate([_cast_vals(p[i], f.dtype) for p in parts])
        valid = np.concatenate([p[i].valid for p in parts])
        out.append(CpuCol(f.dtype, vals, valid))
    return out


def _exec_window(plan: P.WindowNode, child: List[CpuCol], ansi: bool
                 ) -> List[CpuCol]:
    """Window functions row by row per sorted partition; the rows come out
    in (partition, order) order. Every expression of a node shares its
    spec."""
    n = len(child[0].values) if child else 0
    spec = plan.window_exprs[0].spec
    pc = [norm_key_np(e.eval_cpu(child, ansi)) for e in spec.partition_exprs]
    oc = [norm_key_np(o.expr.eval_cpu(child, ansi)) for o in spec.order_specs]
    # lexsort's last key is primary: order keys first, then partition keys
    keys = []
    for (code, nulls), o in zip(reversed(oc), reversed(spec.order_specs)):
        keys.append(code if o.ascending else ~code)
        keys.append(_null_plane(nulls, o.resolved_nulls_first()))
    for code, nulls in reversed(pc):
        keys.append(code)
        keys.append(nulls.astype(np.uint8))
    perm = np.lexsort(keys) if keys else np.arange(n)
    out = _gather_cols(child, perm)

    def boundary(cols_codes):
        b = np.zeros(n, np.bool_)
        if n:
            b[0] = True
        for code, nulls in cols_codes:
            cs, ns = code[perm], nulls[perm]
            b[1:] |= (cs[1:] != cs[:-1]) | (ns[1:] != ns[:-1])
        return b

    segb = boundary(pc)
    peerb = (segb | boundary(oc)) if oc else segb.copy()
    for w in plan.window_exprs:
        out.append(_one_window_cpu(w, child, perm, segb, peerb, n, ansi))
    return out


def _one_window_cpu(w, child, perm, segb, peerb, n, ansi) -> CpuCol:
    fn = w.fn
    rt = fn.result_type()
    frame = w.spec.resolved_frame()
    starts = np.flatnonzero(segb)
    bounds = list(starts) + [n]
    vals = np.zeros(n, object)
    valid = np.ones(n, np.bool_)
    src = None
    if fn.children:
        src = fn.children[0].eval_cpu(child, ansi)
        src = CpuCol(src.dtype, src.values[perm], src.valid[perm])
    for gi in range(len(starts)):
        lo, hi = bounds[gi], bounds[gi + 1]
        rows = range(lo, hi)
        if isinstance(fn, WE.RowNumber):
            for i in rows:
                vals[i] = i - lo + 1
        elif isinstance(fn, (WE.Rank, WE.DenseRank)):
            r = d = 0
            for i in rows:
                if peerb[i] or i == lo:
                    r = i - lo + 1
                    d += 1
                vals[i] = r if isinstance(fn, WE.Rank) else d
        elif isinstance(fn, WE.NTile):
            size = hi - lo
            base, rem = divmod(size, fn.n)
            for i in rows:
                pos = i - lo
                cut = (base + 1) * rem
                vals[i] = (pos // (base + 1) if pos < cut
                           else rem + (pos - cut) // max(base, 1)) + 1
        elif isinstance(fn, WE.LeadLag):
            off = fn.offset if fn.is_lead else -fn.offset
            for i in rows:
                j = i + off
                if lo <= j < hi:
                    vals[i] = src.values[j]
                    valid[i] = bool(src.valid[j])
                elif fn.default is not None:
                    vals[i] = fn.default
                else:
                    valid[i] = False
        elif isinstance(fn, WE.PercentRank):
            size = hi - lo
            r = 0
            for i in rows:
                if peerb[i] or i == lo:
                    r = i - lo + 1
                vals[i] = 0.0 if size <= 1 else (r - 1) / (size - 1)
        elif isinstance(fn, WE.CumeDist):
            size = hi - lo
            for i in rows:
                e = i
                while e + 1 < hi and not peerb[e + 1]:
                    e += 1
                vals[i] = (e - lo + 1) / size
        elif isinstance(fn, (WE.NthValue, WE.FirstValue, WE.LastValue)):
            for i in rows:
                if frame.upper is None:
                    fe = hi - 1
                elif frame.kind == "rows":
                    fe = min(i + frame.upper, hi - 1)
                else:  # range: the frame ends at the end of the peer group
                    fe = i
                    while fe + 1 < hi and not peerb[fe + 1]:
                        fe += 1
                fs = lo
                if frame.lower is not None and frame.kind == "rows":
                    fs = max(i + frame.lower, lo)
                if isinstance(fn, WE.LastValue):
                    pos = fe
                elif isinstance(fn, WE.FirstValue):
                    pos = fs
                else:
                    pos = fs + fn.n - 1
                    if pos > fe:
                        valid[i] = False
                        continue
                if pos < fs or pos > fe:
                    valid[i] = False
                    continue
                vals[i] = src.values[pos]
                valid[i] = bool(src.valid[pos])
        elif isinstance(fn, WE.WindowAgg):
            agg = fn.fn
            for i in rows:
                if frame.kind == "range" and frame.upper == 0:
                    e = i
                    while e + 1 < hi and not peerb[e + 1]:
                        e += 1
                    a, b = lo, e
                elif frame.lower is None and frame.upper is None:
                    a, b = lo, hi - 1
                elif frame.kind == "rows":
                    a = lo if frame.lower is None else max(i + frame.lower,
                                                           lo)
                    b = hi - 1 if frame.upper is None \
                        else min(i + frame.upper, hi - 1)
                else:
                    a, b = lo, i
                if isinstance(agg, A.CountAll):
                    vals[i] = max(b - a + 1, 0)
                    continue
                window_vals = [src.values[j] for j in range(a, b + 1)
                               if src.valid[j]] if b >= a else []
                if isinstance(agg, A.Count):
                    vals[i] = len(window_vals)
                elif not window_vals:
                    valid[i] = False
                elif isinstance(agg, A.Sum):
                    vals[i] = sum(window_vals)
                elif isinstance(agg, A.Average):
                    vals[i] = float(sum(window_vals)) / len(window_vals)
                elif isinstance(agg, (A.Min, A.Max)):
                    def key(x):
                        return (isinstance(x, float) and math.isnan(x), x)
                    vals[i] = (min if isinstance(agg, A.Min) else max)(
                        window_vals, key=key)
                elif isinstance(agg, (A.First, A.Last)):
                    vals[i] = window_vals[-1 if isinstance(agg, A.Last)
                                          else 0]
                elif isinstance(agg, A._MomentAgg):
                    arr = np.asarray(window_vals, np.float64)
                    if len(arr) <= agg.ddof:
                        valid[i] = False
                    elif isinstance(agg, A.StddevSamp):
                        vals[i] = float(np.std(arr, ddof=agg.ddof))
                    else:
                        vals[i] = float(np.var(arr, ddof=agg.ddof))
                else:
                    raise NotImplementedError(type(agg).__name__)
        else:
            raise NotImplementedError(type(fn).__name__)
    if isinstance(rt, T.StringType):
        np_vals = np.array([v if valid[i] else None
                            for i, v in enumerate(vals)], object)
    else:
        np_vals = np.array([v if valid[i] else 0
                            for i, v in enumerate(vals)]).astype(rt.np_dtype)
    return CpuCol(rt, np_vals, valid)


def _exec_sort(plan: P.Sort, child: List[CpuCol], ansi: bool
               ) -> List[CpuCol]:
    n = len(child[0].values) if child else 0
    if n == 0:
        return child
    keys = []  # np.lexsort: the last key is primary
    for o in reversed(plan.orders):
        code, nulls = norm_key_np(o.expr.eval_cpu(child, ansi))
        keys.append(code if o.ascending else ~code)
        keys.append(_null_plane(nulls, o.resolved_nulls_first()))
    return _gather_cols(child, np.lexsort(keys))


def _exec_aggregate(plan: P.Aggregate, child: List[CpuCol], ansi: bool
                    ) -> List[CpuCol]:
    n = len(child[0].values) if child else 0
    key_cols = [e.eval_cpu(child, ansi) for e in plan.group_exprs]
    # every input of each aggregate (min_by/max_by take two)
    agg_inputs: List[Optional[List[CpuCol]]] = [
        None if isinstance(a.fn, A.CountAll) or not a.fn.children
        else [c.eval_cpu(child, ansi) for c in a.fn.children]
        for a in plan.aggs]
    if not key_cols:
        return _global_agg(plan, agg_inputs, n)
    # group ids by the normalized codes, groups in key order, nulls last
    df_data = {}
    for i, kc in enumerate(key_cols):
        code, nulls = norm_key_np(kc)
        s = pd.array(code.view(np.int64), dtype="Int64")
        s[nulls] = pd.NA
        df_data[f"__k{i}"] = s
    df = pd.DataFrame(df_data)
    gid = df.groupby(list(df_data), dropna=False, sort=True).ngroup() \
        .to_numpy()
    # every id in [0, n_groups) occurs: its first row, in id order
    first_idx = np.unique(gid, return_index=True)[1]
    n_groups = len(first_idx)
    out: List[CpuCol] = [_gather_cols([kc], first_idx)[0] for kc in key_cols]
    for a, inp in zip(plan.aggs, agg_inputs):
        out.append(_agg_by_gid(a, inp, gid, n_groups))
    return out


def _agg_by_gid(a: A.NamedAgg, inp, gid: np.ndarray, n_groups: int
                ) -> CpuCol:
    if isinstance(a.fn, A.SegmentedAgg):
        return a.fn.eval_cpu_groups(inp, gid, n_groups)
    spec = a.fn.pandas_spec
    rt = a.fn.result_type()
    if spec == "size":
        cnt = np.bincount(gid, minlength=n_groups).astype(np.int64)
        return CpuCol(T.INT64, cnt, np.ones(n_groups, np.bool_))
    inp = inp[0]
    if isinstance(inp.dtype, (T.Float32Type, T.Float64Type)):
        # pandas conflates NaN with null; floats take Spark's semantics
        # (NaN is a value: sums and averages propagate it, min/max order
        # it above +inf)
        return _agg_float_np(spec, rt, inp, gid, n_groups)
    valid = inp.valid
    if isinstance(inp.dtype, T.StringType):
        ser = pd.Series([v if ok else None for v, ok in zip(inp.values,
                                                            valid)],
                        dtype=object)
    else:
        ser = pd.Series(pd.array(inp.values.astype(np.int64),
                                 dtype="Int64"))
        ser[~valid] = pd.NA
    g = ser.groupby(pd.Series(gid))
    ddof = None
    if isinstance(spec, tuple):
        spec, ddof = spec
    if spec == "sum":
        res = g.sum(min_count=1)
    elif spec in ("std", "var"):
        res = getattr(g, spec)(ddof=1 if ddof is None else ddof)
    else:
        res = getattr(g, spec)()
    res = res.reindex(range(n_groups))
    na = res.isna().to_numpy()
    if isinstance(rt, T.StringType):
        return CpuCol(rt, res.to_numpy(dtype=object), ~na)
    # no float64 round trip: int64 sums and extrema beyond 2^53 stay exact
    if np.dtype(rt.np_dtype).kind in "iub":
        filled = res.fillna(0).to_numpy(dtype=np.int64)
    else:
        filled = res.fillna(0).to_numpy(dtype=np.float64)
    if spec == "mean" and isinstance(inp.dtype, T.DecimalType):
        # a decimal's state is unscaled: the mean must be a value
        filled = filled / 10.0 ** inp.dtype.scale
    return CpuCol(rt, filled.astype(rt.np_dtype), ~na)


def _agg_float_np(spec, rt, inp: CpuCol, gid: np.ndarray, n_groups: int
                  ) -> CpuCol:
    ddof = None
    if isinstance(spec, tuple):
        spec, ddof = spec
    v = inp.values.astype(np.float64)
    order = np.argsort(gid, kind="stable")
    gs, vs, oks = gid[order], v[order], inp.valid[order]
    starts = np.searchsorted(gs, np.arange(n_groups), side="left")
    nvalid = np.bincount(gs, weights=oks.astype(np.float64),
                         minlength=n_groups).astype(np.int64)
    has = nvalid > 0
    with np.errstate(all="ignore"):
        if spec == "count":
            return CpuCol(T.INT64, nvalid, np.ones(n_groups, np.bool_))
        if spec in ("sum", "mean", "std", "var"):
            sums = np.add.reduceat(np.where(oks, vs, 0.0), starts) \
                if n_groups else np.zeros(0)
            if spec == "sum":
                return CpuCol(rt, sums, has)
            if spec == "mean":
                return CpuCol(rt, sums / np.maximum(nvalid, 1), has)
            sq = np.add.reduceat(np.where(oks, vs * vs, 0.0), starts) \
                if n_groups else np.zeros(0)
            n_ = nvalid.astype(np.float64)
            m2 = np.maximum(sq - sums * sums / np.maximum(n_, 1.0), 0.0)
            # NaN sums carry into m2
            m2 = np.where(np.isnan(sums) | np.isnan(sq), np.nan, m2)
            denom = n_ - (1 if ddof is None else ddof)
            var = np.where(denom <= 0, np.nan,
                           m2 / np.where(denom <= 0, 1.0, denom))
            return CpuCol(rt, np.sqrt(var) if spec == "std" else var, has)
        if spec in ("min", "max"):
            # a reduction over the total order's bits
            vv = np.where(vs == 0.0, 0.0, vs)
            bits = vv.view(np.uint64)
            neg = (bits >> np.uint64(63)) != 0
            key = np.where(neg, ~bits, bits | np.uint64(1 << 63))
            ident = np.uint64(0xFFFFFFFFFFFFFFFF) if spec == "min" \
                else np.uint64(0)
            key = np.where(oks, key, ident)
            red = np.minimum if spec == "min" else np.maximum
            out_key = red.reduceat(key, starts) if n_groups else key[:0]
            pos = (out_key & np.uint64(1 << 63)) != 0
            raw = np.where(pos, out_key ^ np.uint64(1 << 63), ~out_key)
            return CpuCol(rt, raw.view(np.float64).astype(rt.np_dtype), has)
        if spec in ("first", "last"):
            pos = np.where(oks, np.arange(len(vs)),
                           len(vs) if spec == "first" else -1)
            red = np.minimum if spec == "first" else np.maximum
            sel = red.reduceat(pos, starts) if n_groups else pos[:0]
            ok = (sel >= 0) & (sel < len(vs))
            out = vs[np.clip(sel, 0, max(len(vs) - 1, 0))]
            return CpuCol(rt, out.astype(rt.np_dtype), has & ok)
    raise NotImplementedError(spec)


def _global_agg(plan: P.Aggregate, agg_inputs, n: int) -> List[CpuCol]:
    out = []
    gid = np.zeros(max(n, 0), np.int64)
    for a, inp in zip(plan.aggs, agg_inputs):
        if n:
            out.append(_agg_by_gid(a, inp, gid, 1))
            continue
        rt = a.fn.result_type()
        if isinstance(rt, T.ArrayType):  # collect_* of no rows is []
            vals = np.empty(1, object)
            vals[0] = []
            out.append(CpuCol(rt, vals, np.ones(1, np.bool_)))
            continue
        if getattr(a.fn, "pandas_spec", None) in ("size", "count"):
            out.append(CpuCol(T.INT64, np.zeros(1, np.int64),
                              np.ones(1, np.bool_)))
        else:
            npdt = object if isinstance(rt, T.StringType) else rt.np_dtype
            out.append(CpuCol(rt, np.zeros(1, npdt), np.zeros(1, np.bool_)))
    return out


def _exec_join(plan: P.Join, left: List[CpuCol], right: List[CpuCol],
               ansi: bool) -> List[CpuCol]:
    ln = len(left[0].values) if left else 0
    rn = len(right[0].values) if right else 0
    if plan.how == "cross" or not plan.left_keys:
        # every pair; the condition below prunes, outer rows follow
        lidx = np.repeat(np.arange(ln), rn)
        ridx = np.tile(np.arange(rn), ln)
    else:
        # pairs by normalized codes: null keys never match, NaN matches
        # NaN
        lk = [e.eval_cpu(left, ansi) for e in plan.left_keys]
        rk = [e.eval_cpu(right, ansi) for e in plan.right_keys]
        lcodes, rcodes = [], []
        lnull = np.zeros(ln, np.bool_)
        rnull = np.zeros(rn, np.bool_)
        for lc, rc in zip(lk, rk):
            shared = _shared_string_dict(lc, rc) \
                if isinstance(lc.dtype, T.StringType) else None
            lcd, lnu = norm_key_np(lc, shared)
            rcd, rnu = norm_key_np(rc, shared)
            lcodes.append(lcd)
            rcodes.append(rcd)
            lnull |= lnu
            rnull |= rnu
        ldf = pd.DataFrame({f"k{i}": c.view(np.int64)
                            for i, c in enumerate(lcodes)})
        rdf = pd.DataFrame({f"k{i}": c.view(np.int64)
                            for i, c in enumerate(rcodes)})
        ldf["_l"] = np.arange(ln)
        rdf["_r"] = np.arange(rn)
        merged = ldf[~lnull].merge(rdf[~rnull],
                                   on=[f"k{i}" for i in range(len(lcodes))],
                                   how="inner")
        lidx = merged["_l"].to_numpy()
        ridx = merged["_r"].to_numpy()
    if plan.condition is not None:
        pair_cols = _gather_cols(left, lidx) + _gather_cols(right, ridx)
        pred = plan.condition.eval_cpu(pair_cols, ansi)
        keep = pred.values.astype(np.bool_) & pred.valid
        lidx, ridx = lidx[keep], ridx[keep]
    how = plan.how
    if how in ("left", "full"):
        matched = np.zeros(ln, np.bool_)
        matched[lidx] = True
        lex = np.nonzero(~matched)[0]
    if how in ("right", "full"):
        matched = np.zeros(rn, np.bool_)
        matched[ridx] = True
        rex = np.nonzero(~matched)[0]
    if how == "left":
        lidx = np.concatenate([lidx, lex])
        ridx = np.concatenate([ridx, np.full(len(lex), -1)])
    elif how == "right":
        lidx = np.concatenate([lidx, np.full(len(rex), -1)])
        ridx = np.concatenate([ridx, rex])
    elif how == "full":
        lidx = np.concatenate([lidx, lex, np.full(len(rex), -1)])
        ridx = np.concatenate([ridx, np.full(len(lex), -1), rex])
    elif how in ("left_semi", "left_anti"):
        hit = np.zeros(ln, np.bool_)
        hit[lidx] = True
        return _gather_cols(left, np.nonzero(
            hit if how == "left_semi" else ~hit)[0])
    return _gather_cols(left, lidx) + _gather_cols(right, ridx)
