"""DataFrame API over the plan nodes (counterpart of
``spark_rapids_tpu/sql/dataframe.py``): ``select`` (which hoists window
expressions into ``WindowNode``s), ``with_column``, ``filter``,
``group_by(...).agg(...)``, ``agg``, ``order_by`` (``orderBy``, ``sort``),
``limit``, ``join``, ``repartition``, ``cache``, ``distinct``,
``drop_duplicates`` (``dropDuplicates``), ``count``, ``collect`` and
``to_pydict``."""
from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import window as WE
from spark_rapids_tpu_torch.expr.aggregates import (
    AggFunction, CountAll, NamedAgg,
)
from spark_rapids_tpu_torch.plan import nodes as P


def _e(x) -> E.Expression:
    if isinstance(x, E.Expression):
        return x
    return E.col(x) if isinstance(x, str) else E.lit(x)


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
        es, plan = self._extract_windows([_e(x) for x in exprs])
        return DataFrame(P.Project(es, plan), self.session)

    def with_column(self, name: str, expr) -> "DataFrame":
        keep = [E.col(n) for n in self.plan.schema.names
                if n.lower() != name.lower()]
        return self.select(*keep, _e(expr).alias(name))

    def filter(self, condition) -> "DataFrame":
        return DataFrame(P.Filter(_e(condition), self.plan), self.session)

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData([_e(k) for k in keys], self)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData([], self).agg(*aggs)

    def order_by(self, *orders) -> "DataFrame":
        os = [o if isinstance(o, P.SortOrder) else P.SortOrder(_e(o))
              for o in orders]
        return DataFrame(P.Sort(os, self.plan), self.session)

    orderBy = sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(P.Limit(n, self.plan), self.session)

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

    def collect(self):
        """Run the query; returns a pyarrow Table."""
        return self.session.collect(self.plan)

    def to_pydict(self):
        return self.collect().to_pydict()

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


class GroupedData:
    def __init__(self, keys: List[E.Expression], df: DataFrame):
        self.keys = keys
        self.df = df

    def agg(self, *aggs) -> DataFrame:
        named = []
        for i, a in enumerate(aggs):
            if isinstance(a, NamedAgg):
                named.append(a)
            elif isinstance(a, AggFunction):
                base = type(a).__name__.lower()
                name = f"{base}({a.children[0].name})" \
                    if a.children and isinstance(a.children[0], E.Col) \
                    else f"{base}_{i}"
                named.append(NamedAgg(a, name))
            else:
                raise TypeError(f"not an aggregate: {a!r}")
        return DataFrame(P.Aggregate(self.keys, named, self.df.plan),
                         self.df.session)
