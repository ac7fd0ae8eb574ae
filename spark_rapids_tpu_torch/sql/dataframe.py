"""DataFrame API over the plan nodes (counterpart of
``spark_rapids_tpu/sql/dataframe.py``): ``select``, ``with_column``,
``filter``, ``group_by(...).agg(...)``, ``agg``, ``repartition``,
``cache``, ``count``, ``collect`` and ``to_pydict``."""
from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.aggregates import (
    AggFunction, CountAll, NamedAgg,
)
from spark_rapids_tpu_torch.plan import nodes as P


def _e(x) -> E.Expression:
    if isinstance(x, E.Expression):
        return x
    return E.col(x) if isinstance(x, str) else E.lit(x)


class DataFrame:
    def __init__(self, plan: P.PlanNode, session):
        self.plan = plan
        self.session = session

    @property
    def columns(self) -> List[str]:
        return self.plan.schema.names

    def select(self, *exprs) -> "DataFrame":
        return DataFrame(P.Project([_e(x) for x in exprs], self.plan),
                         self.session)

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

    def repartition(self, n: int, *cols) -> "DataFrame":
        return DataFrame(P.Repartition(n, [_e(c) for c in cols], self.plan),
                         self.session)

    def cache(self) -> "DataFrame":
        """Keep this DataFrame's result resident on the device; later
        queries over it skip the scan and the upload."""
        return DataFrame(P.CachedRelation(self.plan), self.session)

    def collect(self):
        """Run the query; returns a pyarrow Table."""
        return self.session.collect(self.plan)

    def to_pydict(self):
        return self.collect().to_pydict()

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
