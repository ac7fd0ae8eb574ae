"""DataFrame API over the plan nodes (counterpart of
``spark_rapids_tpu/sql/dataframe.py``): ``select`` (which hoists window
expressions into ``WindowNode``s, lowers ``explode`` and its kin onto a
``Generate`` and ``stack`` onto an ``Expand``), ``with_column``,
``with_column_renamed``, ``drop``, ``filter``, ``group_by(...).agg(...)`` with
``count`` and ``pivot``, ``rollup``, ``cube`` and ``grouping_sets`` (the
Expand lowering), ``agg``, ``order_by`` (``orderBy``, ``sort``), ``limit``,
``join``, ``union`` (``unionAll``), ``intersect``, ``subtract``,
``repartition``, ``cache``, ``distinct``, ``drop_duplicates``
(``dropDuplicates``), ``dropna``, ``fillna``, ``sample``,
``random_split``, the actions ``count``, ``collect``, ``collect_cpu``,
``to_pydict``, ``to_pandas``, ``show``, ``head``, ``take`` and
``first``, ``to_device_batches`` (the batches on the session's device),
``write`` (``io/writer.DataFrameWriter``), the schema accessors,
``explain`` (the placement report, the fused stages, and EXPLAIN
ANALYZE), and the statistics ``describe``, ``corr``, ``cov``,
``crosstab`` and ``approx_quantile``."""
from __future__ import annotations

import copy
import math
from typing import List, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import complex as CX
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import window as WE
from spark_rapids_tpu_torch.expr.aggregates import (
    AggFunction, CountAll, NamedAgg,
)
from spark_rapids_tpu_torch.expr.math import BitwiseAnd, ShiftRight
from spark_rapids_tpu_torch.expr.misc import Rand
from spark_rapids_tpu_torch.plan import nodes as P


def _e(x) -> E.Expression:
    if isinstance(x, E.Expression):
        return x
    return E.col(x) if isinstance(x, str) else E.lit(x)


def _default_agg_name(a: AggFunction, i: int) -> str:
    base = type(a).__name__.lower()
    if a.children and isinstance(a.children[0], E.Col):
        return f"{base}({a.children[0].name})"
    return f"{base}_{i}"


def _is_marker(e: E.Expression, cls) -> bool:
    """A select item that is the generator ``cls``, bare or aliased."""
    return isinstance(e, cls) or (isinstance(e, E.Alias)
                                  and isinstance(e.children[0], cls))


def _plain(e: E.Expression) -> bool:
    """No window, explode or stack marker anywhere in e."""
    if isinstance(e, (WE.WindowExpr, CX.Explode, CX.Stack)):
        return False
    return all(_plain(c) for c in e.children)


def _col_refs(e: E.Expression) -> set:
    """The column names an expression reads."""
    out = {e.name} if isinstance(e, E.Col) else set()
    for c in e.children:
        out |= _col_refs(c)
    return out


_JOIN_ALIASES = {"leftsemi": "left_semi", "semi": "left_semi",
                 "leftanti": "left_anti", "anti": "left_anti",
                 "outer": "full", "fullouter": "full", "left_outer": "left",
                 "right_outer": "right"}


class DataFrame:
    def __init__(self, plan: P.PlanNode, session):
        self.plan = plan
        self.session = session

    @property
    def columns(self) -> List[str]:
        return self.plan.schema.names

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    @property
    def dtypes(self):
        return [(f.name, repr(f.dtype)) for f in self.plan.schema.fields]

    def print_schema(self) -> None:
        print("root")
        for f in self.plan.schema.fields:
            null = "true" if f.nullable else "false"
            print(f" |-- {f.name}: {f.dtype!r} (nullable = {null})")

    printSchema = print_schema

    def _extract_windows(self, exprs):
        """Hoist the window expressions of a projection into WindowNodes
        below it, one per spec (Catalyst's ExtractWindowExpressions). A
        bare window expression is named after its function."""
        found = []

        def repl(node):
            if isinstance(node, WE.WindowExpr):
                name = f"__w{len(found)}"
                found.append((node, name))
                return E.col(name)
            return node

        new_exprs = []
        for e in exprs:
            if isinstance(e, WE.WindowExpr):
                new_exprs.append(E.Alias(repl(e), type(e.fn).__name__.lower()))
            else:
                new_exprs.append(e.transform(repl))
        if not found:
            return exprs, self.plan
        plan = self.plan
        groups = {}
        for w, name in found:
            groups.setdefault(w.spec.fingerprint(), []).append((w, name))
        for items in groups.values():
            plan = P.WindowNode([w for w, _ in items], [n for _, n in items],
                                plan)
        return new_exprs, plan

    def select(self, *exprs) -> "DataFrame":
        es = [_e(x) for x in exprs]
        stacks = [(i, e) for i, e in enumerate(es) if _is_marker(e, CX.Stack)]
        if stacks:
            return self._select_stack(es, stacks)
        gens = [(i, e) for i, e in enumerate(es) if _is_marker(e, CX.Explode)]
        if gens:
            return self._select_generate(es, gens)
        es, plan = self._extract_windows(es)
        return DataFrame(P.Project(es, plan), self.session)

    def _select_stack(self, es, stacks) -> "DataFrame":
        """stack(n, ...) as one Expand of its n row projections when the
        other items are plain, else a union of one select per row."""
        if len(stacks) > 1:
            raise E.SparkException(
                "only one generator allowed per select clause")
        i, se = stacks[0]
        alias = se.name if isinstance(se, E.Alias) else None
        raw = se.children[0] if isinstance(se, E.Alias) else se
        st = CX.Stack(raw.n, *[P.bind_expr(c, self.plan.schema)
                               for c in raw.children])
        names = [n for n, _ in st.output_fields()]
        if alias is not None:
            if len(names) != 1:
                raise E.SparkException(
                    "stack() alias needs a single output column, "
                    f"got {len(names)}")
            names = [alias]
        rest = es[:i] + es[i + 1:]
        if all(_plain(e) for e in rest):
            out_names = ([P.expr_name(e, j) for j, e in enumerate(es[:i])]
                         + names
                         + [P.expr_name(e, i + 1 + j)
                            for j, e in enumerate(es[i + 1:])])
            projections = [es[:i] + row + es[i + 1:]
                           for row in st.row_exprs()]
            return DataFrame(P.Expand(projections, out_names, self.plan),
                             self.session)
        # other items carry window or explode markers that need their own
        # lowering: one select per stack row, of the stack's unbound
        # values (each select binds them against the node it builds)
        vals = raw.children
        rows = [[vals[r * st.ncols + j] if r * st.ncols + j < len(vals)
                 else pad for j, pad in enumerate(row)]
                for r, row in enumerate(st.row_exprs())]
        out = None
        for row in rows:
            part = self.select(*(es[:i] + [E.Alias(c, n)
                                           for c, n in zip(row, names)]
                                 + es[i + 1:]))
            out = part if out is None else out.union(part)
        return out

    def _select_generate(self, es, gens) -> "DataFrame":
        """An explode-family item as a Generate below the projection,
        carrying only the child columns the projection reads."""
        if len(gens) > 1:
            raise E.SparkException(
                "only one generator allowed per select clause")
        i, ge = gens[0]
        alias = ge.name if isinstance(ge, E.Alias) else None
        gen = ge.children[0] if isinstance(ge, E.Alias) else ge
        gen = type(gen)(P.bind_expr(gen.children[0], self.plan.schema))
        names = [n for n, _ in gen.output_fields(alias)]
        new_exprs = es[:i] + [E.col(n) for n in names] + es[i + 1:]
        refs = set()
        for e in new_exprs:
            refs |= {r.lower() for r in _col_refs(e)}
        required = [j for j, f in enumerate(self.plan.schema.fields)
                    if f.name.lower() in refs]
        gplan = P.Generate(gen, names, self.plan, required=required)
        return DataFrame(P.Project(new_exprs, gplan), self.session)

    def with_column(self, name: str, expr) -> "DataFrame":
        keep = [E.col(n) for n in self.plan.schema.names
                if n.lower() != name.lower()]
        return self.select(*keep, _e(expr).alias(name))

    def with_column_renamed(self, existing: str, new: str) -> "DataFrame":
        return self.select(*[E.Alias(E.col(n), new)
                             if n.lower() == existing.lower() else E.col(n)
                             for n in self.plan.schema.names])

    withColumnRenamed = with_column_renamed

    def drop(self, *cols) -> "DataFrame":
        """Drop columns by name; unknown names are ignored (pyspark)."""
        gone = {(c if isinstance(c, str) else c.name).lower() for c in cols}
        keep = [E.col(n) for n in self.plan.schema.names
                if n.lower() not in gone]
        if not keep:
            raise E.SparkException("drop() would remove every column")
        return self.select(*keep)

    def filter(self, condition) -> "DataFrame":
        return DataFrame(P.Filter(_e(condition), self.plan), self.session)

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData([_e(k) for k in keys], self)

    def rollup(self, *keys) -> "GroupedData":
        """Hierarchical grouping sets (all keys, all but the last, ...,
        the grand total), lowered onto Expand."""
        ks = [_e(k) for k in keys]
        sets = [tuple(range(i)) for i in range(len(ks), -1, -1)]
        return GroupedData(ks, self, grouping_sets=sets)

    def cube(self, *keys) -> "GroupedData":
        """All 2^n combinations of the keys, lowered onto Expand."""
        ks = [_e(k) for k in keys]
        n = len(ks)
        sets = [tuple(j for j in range(n) if not (m >> (n - 1 - j)) & 1)
                for m in range(1 << n)]
        return GroupedData(ks, self, grouping_sets=sets)

    def grouping_sets(self, sets, *keys) -> "GroupedData":
        """Explicit GROUPING SETS: each set lists key indices, or key
        names or expressions matched against ``keys``."""
        ks = [_e(k) for k in keys]
        fps = [k.fingerprint() for k in ks]
        norm = []
        for s in sets:
            idx = []
            for item in s:
                if isinstance(item, int):
                    idx.append(item)
                    continue
                fp = _e(item).fingerprint()
                if fp not in fps:
                    raise E.SparkException(f"GROUPING SETS item {item!r} is "
                                           f"not a group-by key")
                idx.append(fps.index(fp))
            norm.append(tuple(idx))
        return GroupedData(ks, self, grouping_sets=norm)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData([], self).agg(*aggs)

    def order_by(self, *orders) -> "DataFrame":
        os = [o if isinstance(o, P.SortOrder) else P.SortOrder(_e(o))
              for o in orders]
        return DataFrame(P.Sort(os, self.plan), self.session)

    orderBy = sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(P.Limit(n, self.plan), self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position; columns widen to their common type."""
        return DataFrame(P.Union([self.plan, other.plan]), self.session)

    unionAll = union

    def repartition(self, n: int, *cols) -> "DataFrame":
        """Hash-partition by ``cols`` into n partitions; round-robin when
        no columns are given (Spark's repartition)."""
        return DataFrame(P.Repartition(n, [_e(c) for c in cols], self.plan),
                         self.session)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on column names (one output key column, PySpark's
        rule) or on (left, right) expression pairs; ``on`` an expression
        is a non-equi join and ``None`` a cross join."""
        how = _JOIN_ALIASES.get(how, how)
        if how == "cross" or on is None:
            return DataFrame(P.Join(self.plan, other.plan, [], [], "cross"),
                             self.session)
        if isinstance(on, E.Expression):
            return DataFrame(P.Join(self.plan, other.plan, [], [], how,
                                    condition=on), self.session)
        if isinstance(on, str):
            on = [on]
        dedupe = None
        if isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            lk = [E.col(k) for k in on]
            rk = [E.col(k) for k in on]
            dedupe = {k.lower() for k in on}
        elif isinstance(on, (list, tuple)):
            lk, rk = (list(x) for x in zip(*on))
        else:
            raise TypeError("join on= must be column name(s) or (left, "
                            "right) pairs")
        joined = DataFrame(P.Join(self.plan, other.plan, lk, rk, how),
                           self.session)
        if dedupe and how not in ("left_semi", "left_anti"):
            joined = joined._dedupe_keys(len(self.plan.schema), dedupe, how)
        return joined

    def _dedupe_keys(self, nleft: int, keys, how: str) -> "DataFrame":
        """One column per key name: the right side's copy goes; for right
        and full joins the kept column takes whichever side is not null."""
        fields = self.plan.schema.fields
        rnames = [f.name.lower() for f in fields[nleft:]]
        out = []
        for i, f in enumerate(fields):
            if f.name.lower() not in keys:
                out.append(E.BoundRef(i, f.dtype, f.name).alias(f.name))
            elif i < nleft:
                ref = E.BoundRef(i, f.dtype, f.name)
                if how in ("right", "full"):
                    ri = nleft + rnames.index(f.name.lower())
                    ref = E.Coalesce(ref, E.BoundRef(ri, fields[ri].dtype,
                                                     f.name))
                out.append(ref.alias(f.name))
        return DataFrame(P.Project(out, self.plan), self.session)

    def cache(self) -> "DataFrame":
        """Keep this DataFrame's result resident on the device; later
        queries over it skip the scan and the upload."""
        return DataFrame(P.CachedRelation(self.plan), self.session)

    @property
    def write(self):
        """df.write.mode(...).partition_by(...).parquet(path)."""
        from spark_rapids_tpu_torch.io.writer import DataFrameWriter
        return DataFrameWriter(self)


    def collect(self, timeout_seconds: Optional[float] = None):
        """Run the query; returns a pyarrow Table. ``timeout_seconds``
        overrides spark.rapids.query.timeoutSeconds for this action: the
        query is cancelled (QueryCancelledError, reason ``deadline``)
        when it lapses."""
        return self.session.collect(self.plan,
                                    timeout_seconds=timeout_seconds)

    def collect_cpu(self):
        """Run the whole query on the CPU backend (localized to the
        session timezone, as the device plan is)."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.exec.cpu_backend import execute_cpu
        from spark_rapids_tpu_torch.plan.overrides import localize_plan
        conf = self.session.conf
        return execute_cpu(localize_plan(self.plan, conf),
                           conf.get(C.ANSI_ENABLED))

    def explain(self, mode: str = "placement") -> str:
        """Print and return a report. 'placement' (default): every
        operator, ``*`` where it runs on the device and ``!`` where it
        falls back to the CPU, with an ``@ cannot run on GPU because:``
        line per reason. 'stages': the operator tree after stage fusion,
        each fused stage and absorbed chain marked ``*(N)`` and its
        members ``[fused]``. 'analyze': run the query, then the operator
        tree annotated with the rows, batches and time each operator
        recorded, the wall-time attribution and the adaptive decisions
        (``session.explain_analyze()``)."""
        if mode == "analyze":
            self.collect()
            s = self.session.explain_analyze()
        elif mode == "stages":
            # the tree without convert_plan's action-time side effects
            # (the LORE dumper, test mode's fallback assertions)
            from spark_rapids_tpu_torch.exec.stage_fusion import fuse_stages
            from spark_rapids_tpu_torch.plan.overrides import (
                apply_cost_optimizer, wrap_and_tag,
            )
            from spark_rapids_tpu_torch.plan.prune import prune_plan
            conf = self.session.conf
            meta = wrap_and_tag(prune_plan(self.plan), conf)
            apply_cost_optimizer(meta, conf)
            s = fuse_stages(meta.convert(self.session.device),
                            conf).tree_string()
        elif mode == "placement":
            from spark_rapids_tpu_torch.plan.overrides import explain_plan
            s = explain_plan(self.plan, self.session.conf, all_ops=True)
        else:
            raise NotImplementedError(f"explain mode {mode!r}")
        print(s)
        return s

    def to_device_batches(self) -> list:
        """Run the plan and return its compacted ``ColumnarBatch``es (flat,
        in partition order) with their tensors on the session's device:
        the hand-off of device tables to torch code without a host round
        trip (reference ColumnarRdd / InternalColumnarRddConverter). Each
        batch's live rows are gathered to the front, which reads its row
        count off the device; no column plane is downloaded."""
        from spark_rapids_tpu_torch.ops.kernels import compact_batch
        root, _ = self.session.prepare_execution(self.plan)
        return self.session.run_partitions(root, compact_batch)

    def to_pydict(self):
        return self.collect().to_pydict()

    def to_pandas(self):
        return self.collect().to_pandas()

    toPandas = to_pandas

    def show(self, n: int = 20, truncate=True) -> None:
        """Print the first n rows as pyspark's ASCII grid; ``truncate`` is
        a bool (cut at 20 characters) or a width."""
        tbl = self.limit(n + 1).collect()
        more = tbl.num_rows > n
        tbl = tbl.slice(0, n)
        names = list(self.plan.schema.names)
        width = (20 if truncate else 0) if isinstance(truncate, bool) \
            else int(truncate)

        def cell(v):
            s = "NULL" if v is None else "true" if v is True \
                else "false" if v is False else str(v)
            if width and len(s) > width:
                s = s[: max(width - 3, 0)] + "..."
            return s
        # by position: duplicate output names show their own values
        cols = [tbl.column(i).to_pylist() for i in range(tbl.num_columns)]
        grid = [[cell(cols[i][r]) for i in range(len(names))]
                for r in range(tbl.num_rows)]
        widths = [max(len(c), *(len(g[i]) for g in grid)) if grid
                  else len(c) for i, c in enumerate(names)]
        sep = "+" + "+".join("-" * w for w in widths) + "+"
        print(sep)
        print("|" + "|".join(c.rjust(w) for c, w in zip(names, widths)) + "|")
        print(sep)
        for g in grid:
            print("|" + "|".join(c.rjust(w) for c, w in zip(g, widths))
                  + "|")
        print(sep)
        if more:
            print(f"only showing top {n} rows")

    def head(self, n: Optional[int] = None):
        """head() is one row (or None); head(n), even head(1), a list."""
        rows = self.limit(n if n is not None else 1).collect().to_pylist()
        if n is None:
            return rows[0] if rows else None
        return rows

    def take(self, n: int):
        return self.limit(n).collect().to_pylist()

    def first(self):
        return self.head(1)

    def distinct(self) -> "DataFrame":
        keys = [E.col(n) for n in self.plan.schema.names]
        return DataFrame(P.Aggregate(keys, [], self.plan), self.session)

    def drop_duplicates(self, subset: Optional[List[str]] = None
                        ) -> "DataFrame":
        """One whole input row per distinct ``subset`` key (all columns
        when no subset is given): a row_number over the key, ordered by a
        constant, keeps an arbitrary row of each."""
        if not subset:
            return self.distinct()
        from spark_rapids_tpu_torch.sql import functions as F
        names = self.plan.schema.names
        spec = WE.Window.partition_by(*[E.col(c) for c in subset]) \
            .order_by(E.lit(1))
        marked = self.select(*[E.col(n) for n in names],
                             F.row_number().over(spec).alias("__rn"))
        return (marked.filter(E.col("__rn") == E.lit(1))
                .select(*[E.col(n) for n in names]))

    dropDuplicates = drop_duplicates

    def count(self) -> int:
        plan = P.Aggregate([], [NamedAgg(CountAll(), "count")], self.plan)
        return int(self.session.collect(plan).column(0)[0].as_py())

    def dropna(self, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[List[str]] = None) -> "DataFrame":
        """Keep the rows with enough non-null cells (NaN counts as
        missing): ``thresh`` wins over ``how``; 'any' wants every cell,
        'all' at least one (Spark's AtLeastNNonNulls filter)."""
        if how not in ("any", "all"):
            raise ValueError(f"how must be 'any' or 'all', got {how!r}")
        names = subset or list(self.plan.schema.names)
        if thresh is None:
            thresh = len(names) if how == "any" else 1
        return self.filter(E.AtLeastNNonNulls(int(thresh),
                                              *[E.col(n) for n in names]))

    def fillna(self, value, subset: Optional[List[str]] = None
               ) -> "DataFrame":
        """Replace nulls in the columns of a compatible type (a number
        fills numeric columns, a string fills string columns), cast to
        the column's type; other columns pass untouched."""
        names = {c.lower() for c in subset} if subset else None
        numeric = isinstance(value, (int, float)) \
            and not isinstance(value, bool)
        out = []
        for f in self.plan.schema.fields:
            compat = f.dtype.is_numeric if numeric \
                else isinstance(f.dtype, type(E.lit(value).dtype))
            if (names is None or f.name.lower() in names) and compat:
                out.append(E.Alias(E.Coalesce(
                    E.col(f.name), E.Cast(E.lit(value), f.dtype)), f.name))
            else:
                out.append(E.col(f.name))
        return self.select(*out)

    def sample(self, fraction: float, seed: int = 0,
               with_replacement: bool = False) -> "DataFrame":
        """Bernoulli sample: the rows with rand(seed) < fraction. The
        filter reads rand over the input collected into one partition,
        as the JAX package's CPU placement of it does, so both keep the
        same rows."""
        if with_replacement:
            raise E.SparkException(
                "sample(withReplacement=True) is not implemented")
        return self.filter(Rand(seed) < E.lit(float(fraction)))

    def random_split(self, weights: List[float], seed: int = 0
                     ) -> List["DataFrame"]:
        """Split by disjoint ranges of one rand(seed) stream, in
        proportion to the weights, so the splits partition the input."""
        total = float(sum(weights))
        out, lo = [], 0.0
        for i, w in enumerate(weights):
            hi = 1.0 if i == len(weights) - 1 else lo + w / total
            r = Rand(seed)
            out.append(self.filter((r >= E.lit(lo)) & (r < E.lit(hi))))
            lo = hi
        return out

    randomSplit = random_split

    def _null_safe_on(self):
        """EXCEPT/INTERSECT take NULL equal to NULL: each column becomes
        an (is-null flag, null-coalesced value) key pair."""
        on = []
        for f in self.plan.schema.fields:
            c = E.col(f.name)
            flag = E.If(E.IsNull(c), E.lit(1), E.lit(0))
            default = E.lit("") if isinstance(f.dtype, T.StringType) \
                else E.Cast(E.lit(0), f.dtype)
            coal = E.Coalesce(c, default)
            on.append((flag, flag))
            on.append((coal, coal))
        return on

    def _align_positional(self, other: "DataFrame") -> "DataFrame":
        """Set operations pair columns by position: other's columns take
        this frame's names."""
        mine, theirs = self.plan.schema.names, other.plan.schema.names
        if len(mine) != len(theirs):
            raise E.SparkException(
                f"set operation needs the same number of columns: "
                f"{len(mine)} vs {len(theirs)}")
        return other.select(*[E.Alias(E.col(t), m)
                              for t, m in zip(theirs, mine)])

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """EXCEPT DISTINCT: the distinct rows of this frame absent from
        other (a left anti join on the null-safe key pairs)."""
        return self.distinct().join(self._align_positional(other),
                                    on=self._null_safe_on(),
                                    how="left_anti")

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """INTERSECT DISTINCT (a left semi join on the null-safe key
        pairs)."""
        return self.distinct().join(self._align_positional(other),
                                    on=self._null_safe_on(),
                                    how="left_semi")

    def describe(self, *cols) -> "DataFrame":
        """count/mean/stddev/min/max rows over the named columns (by
        default every numeric and string column), rendered as strings.
        Strings get count/min/max only; min/max over strings is tagged to
        the CPU, as in the JAX package, so such a describe aggregates on
        the host."""
        from spark_rapids_tpu_torch.sql import functions as F
        fields = {f.name: f for f in self.plan.schema.fields}
        names = list(cols) or [f.name for f in self.plan.schema.fields
                               if f.dtype.is_numeric
                               or isinstance(f.dtype, T.StringType)]
        for n in names:
            if n not in fields:
                raise E.SparkException(f"describe: no column {n!r}")
            if n == "summary":
                raise E.SparkException(
                    "describe over a column named 'summary' is not "
                    "supported (it collides with the stat-label column)")
        stats = ["count", "mean", "stddev", "min", "max"]
        if not names:
            return self.session.create_dataframe(pa.table({"summary": stats}))
        aggs = []
        for n in names:
            aggs += [NamedAgg(F.count(E.col(n)), f"__cnt_{n}"),
                     NamedAgg(F.min(E.col(n)), f"__min_{n}"),
                     NamedAgg(F.max(E.col(n)), f"__max_{n}")]
            if fields[n].dtype.is_numeric:
                aggs += [NamedAgg(F.avg(E.col(n)), f"__avg_{n}"),
                         NamedAgg(F.stddev(E.col(n)), f"__std_{n}")]
        row = self.agg(*aggs).collect().to_pylist()[0]
        data = {"summary": stats}
        for n in names:
            data[n] = [None if row.get(f"__{k}_{n}") is None
                       else str(row[f"__{k}_{n}"])
                       for k in ("cnt", "avg", "std", "min", "max")]
        return self.session.create_dataframe(pa.table(data))

    def corr(self, c1: str, c2: str) -> float:
        """Pearson correlation (df.stat.corr)."""
        m = self._moments(c1, c2)
        # E[x^2] - mean^2 can round a hair negative for a constant column
        den = math.sqrt(max(m["vx"], 0.0) * max(m["vy"], 0.0))
        return float("nan") if den == 0 else m["cov"] / den

    def cov(self, c1: str, c2: str) -> float:
        """Sample covariance (df.stat.cov, n - 1 denominator)."""
        m = self._moments(c1, c2)
        return 0.0 if m["n"] < 2 else m["cov_sum"] / (m["n"] - 1)

    def _moments(self, c1: str, c2: str):
        """The sums behind corr and cov over the rows where both columns
        are non-null."""
        from spark_rapids_tpu_torch.sql import functions as F
        both = E.IsNotNull(E.col(c1)) & E.IsNotNull(E.col(c2))
        types = {f.name: f.dtype for f in self.plan.schema.fields}
        x = E.If(both, E.col(c1), E.Literal(None, types[c1]))
        y = E.If(both, E.col(c2), E.Literal(None, types[c2]))
        row = self.agg(
            NamedAgg(F.count(x), "n"), NamedAgg(F.sum(x), "sx"),
            NamedAgg(F.sum(y), "sy"), NamedAgg(F.sum(x * y), "sxy"),
            NamedAgg(F.sum(x * x), "sxx"),
            NamedAgg(F.sum(y * y), "syy")).collect().to_pylist()[0]
        n = row["n"] or 0
        if n == 0:
            return {"n": 0, "cov": 0.0, "cov_sum": 0.0, "vx": 0.0,
                    "vy": 0.0}
        sx, sy = float(row["sx"]), float(row["sy"])
        cov_sum = float(row["sxy"]) - sx * sy / n
        return {"n": n, "cov_sum": cov_sum, "cov": cov_sum / n,
                "vx": float(row["sxx"]) / n - (sx / n) ** 2,
                "vy": float(row["syy"]) / n - (sy / n) ** 2}

    def crosstab(self, c1: str, c2: str) -> "DataFrame":
        """Pairwise frequency table (df.stat.crosstab): a row per c1
        value, a column per c2 value, 0 for an absent pair."""
        from spark_rapids_tpu_torch.sql import functions as F
        # a reserved key name: a c2 value equal to c1's name cannot
        # collide with the key column
        key = "__crosstab_key"
        piv = (self.select(E.Alias(E.col(c1), key), E.col(c2))
               .group_by(E.col(key)).pivot(E.col(c2)).agg(F.count()))
        out = [E.Alias(E.col(n), f"{c1}_{c2}") if n == key
               else E.Alias(E.Coalesce(E.col(n), E.lit(0)), n)
               for n in piv.plan.schema.names]
        return piv.select(*out)

    def approx_quantile(self, col_name: str, probabilities: List[float],
                        relative_error: float = 1e-4):
        """df.stat.approxQuantile over one column: the non-null values
        collected once, then numpy's exact quantile per probability
        (exact answers satisfy any relative_error)."""
        vals = (self.select(E.col(col_name)).dropna().collect()
                .column(0).to_numpy(zero_copy_only=False))
        if vals.size == 0:
            return [float("nan")] * len(probabilities)
        return [float(np.quantile(vals, p)) for p in probabilities]

    approxQuantile = approx_quantile


class GroupedData:
    def __init__(self, keys: List[E.Expression], df: DataFrame,
                 grouping_sets=None):
        self.keys = keys
        self.df = df
        #: per grouping set, the indices of the keys it keeps
        self.grouping_sets = grouping_sets

    def agg(self, *aggs) -> DataFrame:
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append(a)
            elif isinstance(a, AggFunction):
                named.append(NamedAgg(a, _default_agg_name(a, i)))
            else:
                raise TypeError(f"not an aggregate: {a!r}")
        if self.grouping_sets is not None:
            return self._agg_grouping_sets(named)
        return DataFrame(P.Aggregate(self.keys, named, self.df.plan),
                         self.df.session)

    def _agg_grouping_sets(self, named: List[NamedAgg]) -> DataFrame:
        """ROLLUP/CUBE/GROUPING SETS (Catalyst's Expand rewrite): each row
        once per grouping set, the keys it drops as typed nulls, and a
        ``__grouping_id`` bitmask key; aggregate over the keys and the id,
        read the grouping()/grouping_id() markers off the id, then drop
        it."""
        df, keys, sets = self.df, self.keys, self.grouping_sets
        nk = len(keys)
        src = df.columns
        gk = [f"__gkey{j}" for j in range(nk)]
        pre = df.select(*[E.col(n) for n in src],
                        *[E.Alias(k, gk[j]) for j, k in enumerate(keys)])
        ktypes = {f.name: f.dtype for f in pre.schema.fields}
        projections = []
        for s in sets:
            gid = 0
            row: List[E.Expression] = [E.col(n) for n in src]
            for j in range(nk):
                if j in s:
                    row.append(E.col(gk[j]))
                else:
                    row.append(E.Literal(None, ktypes[gk[j]]))
                    gid |= 1 << (nk - 1 - j)
            row.append(E.Cast(E.lit(gid), T.INT64))
            projections.append(row)
        expanded = P.Expand(projections, src + gk + ["__grouping_id"],
                            pre.plan)
        key_fps = [k.fingerprint() for k in keys]

        def marker_expr(fn: A.GroupingMarker) -> E.Expression:
            if isinstance(fn, A.GroupingID):
                return E.col("__grouping_id")
            child = fn.children[0]
            fp = child.fingerprint()
            if fp in key_fps:
                j = key_fps.index(fp)
            elif isinstance(child, E.Col) and child.name in gk:
                j = gk.index(child.name)
            else:
                raise E.SparkException(f"grouping() argument {child!r} is "
                                       f"not a group-by key")
            return E.Cast(BitwiseAnd(
                ShiftRight(E.col("__grouping_id"),
                           E.Cast(E.lit(nk - 1 - j), T.INT32)),
                E.Cast(E.lit(1), T.INT64)), T.INT8)

        real, post = [], []
        for na in named:
            if isinstance(na.fn, A.GroupingMarker):
                post.append(E.Alias(marker_expr(na.fn), na.name))
            else:
                real.append(na)
                post.append(E.col(na.name))
        grouped = DataFrame(P.Aggregate(
            [E.col(n) for n in gk] + [E.col("__grouping_id")], real,
            expanded), df.session)
        out_keys = [E.Alias(E.col(gk[j]), P.expr_name(keys[j], j))
                    for j in range(nk)]
        return grouped.select(*out_keys, *post)

    def count(self) -> DataFrame:
        return self.agg(NamedAgg(CountAll(), "count"))

    def pivot(self, pivot_col, values=None) -> "PivotedData":
        """Spark's GroupedData.pivot, lowered to one conditional aggregate
        per value. Without values, the distinct values are computed
        eagerly (at most 10000), nulls first."""
        pc = _e(pivot_col)
        if values is None:
            rows = (self.df.select(pc.alias("__pv")).distinct()
                    .limit(10_001).collect().column("__pv").to_pylist())
            if len(rows) > 10_000:
                raise E.SparkException(
                    "pivot: more than 10000 distinct values; pass an "
                    "explicit value list")
            values = sorted(rows, key=lambda v: (v is not None, v))
        return PivotedData(self.keys, self.df, pc, list(values))


class PivotedData:
    def __init__(self, keys, df: DataFrame, pivot_col, values):
        self.keys = keys
        self.df = df
        self.pivot_col = pivot_col
        self.values = values

    def agg(self, *aggs) -> DataFrame:
        """One aggregate per (value, aggregate) with every child gated on
        the pivot value (null-safe for a null value). A count of a value
        with no rows stays null, as in Spark: a presence marker per value
        tells "no rows" from "rows whose counted value is null"."""
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append((a.fn, a.name if len(aggs) > 1 else None))
            elif isinstance(a, AggFunction):
                named.append((a, _default_agg_name(a, i)
                              if len(aggs) > 1 else None))
            else:
                raise TypeError(f"not an aggregate: {a!r}")
        schema = self.df.plan.schema
        pc = P.bind_expr(self.pivot_col, schema)
        has_count = any(isinstance(a, (CountAll, A.Count)) for a, _ in named)
        out, post = [], {}  # post: count column -> its presence marker
        for vi, v in enumerate(self.values):
            cond = E.IsNull(pc) if v is None else pc == E.lit(v)
            marker = None
            if has_count:
                marker = f"__present{vi}"
                out.append(NamedAgg(A.Max(E.If(
                    cond, E.lit(1), E.Literal(None, T.INT32))), marker))
            for a, suffix in named:
                if isinstance(a, CountAll):
                    cell = A.Count(E.If(cond, E.lit(1),
                                        E.Literal(None, T.INT32)))
                else:
                    # every child is gated: min_by's ordering column must
                    # not see other values' rows
                    cell = copy.copy(a)  # keeps parameters such as p
                    cell.children = [
                        E.If(cond, ch, E.Literal(None, ch.data_type()))
                        for ch in (P.bind_expr(c, schema)
                                   for c in a.children)]
                vs = "null" if v is None else str(v)
                name = vs if suffix is None else f"{vs}_{suffix}"
                if isinstance(a, (CountAll, A.Count)):
                    post[name] = marker
                out.append(NamedAgg(cell, name))
        agged = DataFrame(P.Aggregate(self.keys, out, self.df.plan),
                          self.df.session)
        if not post:
            return agged
        finals = []
        for n in agged.plan.schema.names:
            if n.startswith("__present"):
                continue
            if n in post:
                finals.append(E.Alias(E.If(E.IsNull(E.col(post[n])),
                                           E.Literal(None, T.INT64),
                                           E.col(n)), n))
            else:
                finals.append(E.col(n))
        return agged.select(*finals)
