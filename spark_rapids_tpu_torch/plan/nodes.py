"""Logical plan nodes with schema inference and name binding.

Counterpart of ``spark_rapids_tpu/plan/nodes.py`` for the nodes this
engine runs: ``InMemorySource``, ``ParquetScan``, ``CachedRelation`` (the
``df.cache()`` marker), ``Project``, ``Filter``, ``Aggregate`` and
``Repartition``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.aggregates import NamedAgg
from spark_rapids_tpu_torch.expr.core import Alias, BoundRef, Col, Expression


class PlanNode:
    children: List["PlanNode"] = []

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError


def bind_expr(e: Expression, schema: T.Schema) -> Expression:
    """Resolve Col names to BoundRefs against a child schema: an exact
    match first, then a case-insensitive one (Spark's default)."""
    def binder(node):
        if isinstance(node, Col):
            for i, f in enumerate(schema.fields):
                if f.name == node.name:
                    return BoundRef(i, f.dtype, f.name)
            for i, f in enumerate(schema.fields):
                if f.name.lower() == node.name.lower():
                    return BoundRef(i, f.dtype, f.name)
            raise KeyError(f"column {node.name!r} not found in "
                           f"{schema.names}")
        return node
    return e.transform(binder)


def expr_name(e: Expression, idx: int) -> str:
    if isinstance(e, (Alias, Col)):
        return e.name
    if isinstance(e, BoundRef):
        return e.name or f"c{idx}"
    return f"col{idx}"


class InMemorySource(PlanNode):
    """A pyarrow Table split into partitions."""

    def __init__(self, table, num_partitions: int = 1):
        self.table = table
        self.num_partitions = max(1, num_partitions)
        self.children = []

    @property
    def schema(self):
        return T.Schema(tuple(T.StructField(f.name, T.from_arrow(f.type))
                              for f in self.table.schema))


class ParquetScan(PlanNode):
    """Parquet files, one partition per file. The schema is read from the
    first file's footer (cut to ``columns``, in their order). Filter
    pushdown (plan/overrides.py) fills ``pushed_filters``, which prune
    row groups by footer statistics; the filter itself stays in the
    plan."""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[List[str]] = None):
        self.paths = list(paths)
        self.columns = list(columns) if columns else None
        self.pushed_filters: List[Expression] = []
        self._schema: Optional[T.Schema] = None
        self.children = []

    @property
    def schema(self):
        if self._schema is None:
            import pyarrow.parquet as pq
            arrow = pq.read_schema(self.paths[0])
            names = self.columns or arrow.names
            missing = [c for c in names if c not in arrow.names]
            if missing:
                raise KeyError(f"columns {missing} not in {self.paths[0]!r}")
            # only the read columns need a type the engine carries
            self._schema = T.Schema(tuple(
                T.StructField(n, T.from_arrow(arrow.field(n).type))
                for n in names))
        return self._schema


class CachedRelation(PlanNode):
    """``df.cache()``: the child's result is materialized once on the card
    and reused by every later query over this node."""

    def __init__(self, child: PlanNode):
        self.children = [child]
        self.materialized = None  # List[List[ColumnarBatch]] once cached

    @property
    def schema(self):
        return self.children[0].schema


class Project(PlanNode):
    def __init__(self, exprs: List[Expression], child: PlanNode):
        self.children = [child]
        self.exprs = [bind_expr(e, child.schema) for e in exprs]
        self.names = [expr_name(e, i) for i, e in enumerate(exprs)]

    @property
    def schema(self):
        return T.Schema(tuple(T.StructField(n, e.data_type())
                              for n, e in zip(self.names, self.exprs)))


class Filter(PlanNode):
    def __init__(self, condition: Expression, child: PlanNode):
        self.children = [child]
        self.condition = bind_expr(condition, child.schema)

    @property
    def schema(self):
        return self.children[0].schema


class Aggregate(PlanNode):
    """Group-by aggregate; empty group_exprs = global aggregation."""

    def __init__(self, group_exprs: List[Expression], aggs: List[NamedAgg],
                 child: PlanNode):
        self.children = [child]
        self.group_exprs = [bind_expr(e, child.schema) for e in group_exprs]
        self.group_names = [expr_name(e, i) for i, e in enumerate(group_exprs)]
        self.aggs = [a.transform(lambda n: bind_expr(n, child.schema))
                     for a in aggs]

    @property
    def schema(self):
        fields = [T.StructField(n, e.data_type())
                  for n, e in zip(self.group_names, self.group_exprs)]
        fields += [T.StructField(a.name, a.fn.result_type())
                   for a in self.aggs]
        return T.Schema(tuple(fields))


class Repartition(PlanNode):
    """``df.repartition(n, *cols)``: hash-partition by keys into n_out."""

    def __init__(self, n_out: int, keys: List[Expression], child: PlanNode):
        self.children = [child]
        self.n_out = max(1, int(n_out))
        self.keys = [bind_expr(e, child.schema) for e in keys]

    @property
    def schema(self):
        return self.children[0].schema
