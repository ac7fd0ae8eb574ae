"""Footer-statistics row-group pruning and hive partition-file pruning.

Counterpart of ``spark_rapids_tpu/io/parquet_pruning.py`` (without
``In``, which the pushdown does not hand over). Row groups whose column
min/max statistics prove that no row can satisfy a pushed-down conjunct
are never read (Spark RAPIDS ``GpuParquetScan`` filterBlocks), and
neither is a file whose hive partition values refute one
(``prune_partition_file``).

The evaluator is a conservative tri-state interval check: a conjunct may
only drop a row group when the statistics prove no row can satisfy it
under IEEE comparison semantics. Anything unrecognized (an expression
shape outside the supported set, a missing statistic, a type mismatch)
keeps the group. Parquet writers leave NaN out of float min/max, and NaN
fails every comparison, so pruning float columns by min/max is sound.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.expr import core as E


class _ColStats:
    __slots__ = ("min", "max", "null_count", "num_values", "all_null")

    def __init__(self, min_v, max_v, null_count, num_values):
        self.min = min_v
        self.max = max_v
        self.null_count = null_count
        self.num_values = num_values
        self.all_null = (null_count is not None and num_values is not None
                         and null_count >= num_values)


def _normalize(v):
    """Bring a stats/literal value into a directly comparable python form."""
    if isinstance(v, datetime.datetime):
        # naive means UTC (Literal._scalar convention); tz-aware converts
        # to UTC first — stripping tzinfo directly would compare wall-clock
        # in the literal's zone against UTC footer stats
        if v.tzinfo is not None:
            v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        return ("ts", v)
    if isinstance(v, datetime.date):
        return ("date", v)
    if isinstance(v, bool):
        return ("num", int(v))
    if isinstance(v, (int, float)):
        return ("num", v)
    if isinstance(v, str):
        return ("str", v)
    if isinstance(v, bytes):
        try:
            return ("str", v.decode("utf-8"))
        except UnicodeDecodeError:
            return None
    return None


def _cmp_pair(a, b) -> Optional[Tuple]:
    na, nb = _normalize(a), _normalize(b)
    if na is None or nb is None or na[0] != nb[0]:
        return None
    return na[1], nb[1]


def _ref_and_lit(e: E.Expression):
    """Match `col <op> lit` / `lit <op> col`; returns (name, value, flipped)."""
    l, r = e.children
    if isinstance(l, E.BoundRef) and isinstance(r, E.Literal):
        return l.name, r.value, False
    if isinstance(l, E.Literal) and isinstance(r, E.BoundRef):
        return r.name, l.value, True
    return None


def _may_match(e: E.Expression, stats: Dict[str, _ColStats]) -> bool:
    """True unless the statistics prove no row in the group satisfies e."""
    if isinstance(e, E.And):
        return all(_may_match(c, stats) for c in e.children)
    if isinstance(e, E.Or):
        return any(_may_match(c, stats) for c in e.children)
    if isinstance(e, E.IsNull):
        c = e.children[0]
        if isinstance(c, E.BoundRef) and c.name in stats:
            s = stats[c.name]
            return s.null_count is None or s.null_count > 0
        return True
    if isinstance(e, E.IsNotNull):
        c = e.children[0]
        if isinstance(c, E.BoundRef) and c.name in stats:
            return not stats[c.name].all_null
        return True
    op = type(e).__name__
    if op in ("EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
              "GreaterThanOrEqual"):
        m = _ref_and_lit(e)
        if m is None:
            return True
        name, lit, flipped = m
        if lit is None:
            return False  # comparison with NULL is never true
        s = stats.get(name)
        if s is None:
            return True
        if s.all_null:
            return False
        if s.min is None or s.max is None:
            return True
        pair_lo = _cmp_pair(s.min, lit)
        pair_hi = _cmp_pair(s.max, lit)
        if pair_lo is None or pair_hi is None:
            return True
        lo, v = pair_lo
        hi, _ = pair_hi
        if flipped:  # lit <op> col  ==  col <flip(op)> lit
            op = {"LessThan": "GreaterThan", "GreaterThan": "LessThan",
                  "LessThanOrEqual": "GreaterThanOrEqual",
                  "GreaterThanOrEqual": "LessThanOrEqual",
                  "EqualTo": "EqualTo"}[op]
        if op == "EqualTo":
            return lo <= v <= hi
        if op == "LessThan":
            return lo < v
        if op == "LessThanOrEqual":
            return lo <= v
        if op == "GreaterThan":
            return hi > v
        if op == "GreaterThanOrEqual":
            return hi >= v
    return True


def split_conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        out = []
        for c in e.children:
            out.extend(split_conjuncts(c))
        return out
    return [e]


def _group_stats(md_rg) -> Dict[str, _ColStats]:
    out: Dict[str, _ColStats] = {}
    for ci in range(md_rg.num_columns):
        col = md_rg.column(ci)
        name = col.path_in_schema
        if "." in name:
            # nested leaf (struct field / list element): its value-level
            # stats do not describe the root column's rows — attributing
            # them to the root makes IsNull/IsNotNull pruning unsound.
            # Unknown columns keep the group (the module's contract).
            continue
        st = col.statistics
        if st is None:
            out[name] = _ColStats(None, None, None, None)
            continue
        mn = st.min if st.has_min_max else None
        mx = st.max if st.has_min_max else None
        nulls = st.null_count if st.has_null_count else None
        out[name] = _ColStats(mn, mx, nulls, md_rg.num_rows)
    return out


def prune_row_groups(metadata, filters: Sequence[E.Expression]
                     ) -> Tuple[List[int], int]:
    """Returns (kept_group_indices, total_groups) for one file footer."""
    total = metadata.num_row_groups
    if not filters:
        return list(range(total)), total
    kept = []
    for g in range(total):
        stats = _group_stats(metadata.row_group(g))
        if all(_may_match(f, stats) for f in filters):
            kept.append(g)
    return kept, total


def prune_partition_file(partition_values: Dict[str, Optional[str]],
                         schema, filters: Sequence[E.Expression]) -> bool:
    """False when a file's hive partition values refute a pushed conjunct.
    Partition values arrive as strings (or None); they are cast to the
    scan schema's column type before the interval check."""
    from spark_rapids_tpu_torch import types as T
    stats: Dict[str, _ColStats] = {}
    for k, v in partition_values.items():
        if v is None:
            stats[k] = _ColStats(None, None, 1, 1)
            continue
        dt = None
        for f in schema.fields:
            if f.name == k:
                dt = f.dtype
        pv: object = v
        try:
            if isinstance(dt, T.IntegralType):
                pv = int(v)
            elif isinstance(dt, (T.Float32Type, T.Float64Type)):
                pv = float(v)
            elif isinstance(dt, T.DateType):
                pv = datetime.date.fromisoformat(v)
            elif isinstance(dt, T.BooleanType):
                pv = v.lower() == "true"
        except ValueError:
            pass
        stats[k] = _ColStats(pv, pv, 0, 1)
    return all(_may_match(f, stats) for f in filters)
