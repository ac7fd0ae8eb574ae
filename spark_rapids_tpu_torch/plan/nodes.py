"""Logical plan nodes with schema inference and name binding.

Counterpart of ``spark_rapids_tpu/plan/nodes.py`` for the nodes this
engine runs: ``InMemorySource``, ``ParquetScan`` (with hive partition
columns), ``TextScan`` (CSV, JSON lines, Avro, ORC), ``Range``,
``CachedRelation`` (the ``df.cache()`` marker), ``Project``, ``Filter``, ``Aggregate``,
``Repartition``, ``Sort`` (with ``SortOrder``), ``Limit``, ``Join``,
``WindowNode``, ``Union``, ``Expand``, ``Generate`` and ``ShuffleFileScan``
(a cross-process shuffle directory). ``describe()`` is a node's line
in the placement report (``plan/overrides.py`` ``explain``), in the JAX
package's words.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.aggregates import GroupingMarker, NamedAgg
from spark_rapids_tpu_torch.expr.core import (
    Alias, BoundRef, Col, Expression, SparkException,
)


class PlanNode:
    children: List["PlanNode"] = []

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def estimated_rows(self) -> Optional[int]:
        """Best-effort row count for physical planning (the join strategy
        reads it); None = unknown."""
        if isinstance(self, InMemorySource):
            return self.table.num_rows
        if isinstance(self, ParquetScan):
            if getattr(self, "_est_rows", None) is None:
                import pyarrow.parquet as pq
                try:
                    self._est_rows = sum(pq.ParquetFile(p).metadata.num_rows
                                         for p in self.paths)
                except OSError:  # the statistics are advisory
                    self._est_rows = -1
            return None if self._est_rows < 0 else self._est_rows
        if isinstance(self, Range):
            return self.num_rows()
        if isinstance(self, Union):
            parts = [c.estimated_rows() for c in self.children]
            return None if any(p is None for p in parts) else sum(parts)
        if isinstance(self, Filter):
            c = self.children[0].estimated_rows()
            return None if c is None else max(c // 2, 1)
        if isinstance(self, Limit):
            c = self.children[0].estimated_rows()
            return self.n if c is None else min(self.n, c)
        if isinstance(self, Aggregate):
            # a grouped aggregate's cardinality depends on the data
            return 1 if not self.group_exprs else None
        if self.children:
            return self.children[0].estimated_rows()
        return None


def _case_sensitive_now() -> bool:
    from spark_rapids_tpu_torch import config as C
    return bool(C.session_conf().get(C.CASE_SENSITIVE))


def _coerce_bool_compare(node: Expression) -> Expression:
    """Spark's coercion of a comparison between a STRING and a BOOLEAN:
    the string side is cast to a boolean (``'true'``, ``'t'``, ``'yes'``,
    ``'y'``, ``'1'`` and their negations, trimmed, any case; else
    null)."""
    from spark_rapids_tpu_torch.expr.core import BinaryComparison, Cast
    if not isinstance(node, BinaryComparison):
        return node
    lt, rt = node.left.data_type(), node.right.data_type()
    if isinstance(lt, T.StringType) and isinstance(rt, T.BooleanType):
        return node.with_children([Cast(node.left, T.BOOLEAN), node.right])
    if isinstance(lt, T.BooleanType) and isinstance(rt, T.StringType):
        return node.with_children([node.left, Cast(node.right, T.BOOLEAN)])
    return node


def make_binder(schema: T.Schema, case_sensitive: Optional[bool] = None):
    """The node function of ``bind_expr``: a Col becomes a BoundRef under
    spark.sql.caseSensitive (the thread's session conf unless forced):
    sensitive, the exact name; insensitive (Spark's default), the name in
    any case, and two fields whose names differ only in case are an
    ambiguous reference, as Spark's AMBIGUOUS_REFERENCE (ROADMAP C23).
    Fields with one exact name (a join's two sides) resolve to the
    first. A comparison of a string with a boolean casts the string."""
    def binder(node):
        if isinstance(node, Col):
            cs = _case_sensitive_now() if case_sensitive is None \
                else case_sensitive
            name = node.name
            hits = [i for i, f in enumerate(schema.fields)
                    if f.name == name
                    or (not cs and f.name.lower() == name.lower())]
            if not hits:
                raise KeyError(f"column {name!r} not found in "
                               f"{schema.names}")
            names = {schema.fields[i].name for i in hits}
            if len(names) > 1:
                raise SparkException(
                    f"[AMBIGUOUS_REFERENCE] Reference {name!r} is "
                    f"ambiguous, could be: {sorted(names)}")
            f = schema.fields[hits[0]]
            return BoundRef(hits[0], f.dtype, f.name)
        return _coerce_bool_compare(node)
    return binder


def bind_expr(e: Expression, schema: T.Schema,
              case_sensitive: Optional[bool] = None) -> Expression:
    """Resolve Col names to BoundRefs against a child schema (case
    sensitivity from spark.sql.caseSensitive unless forced)."""
    return e.transform(make_binder(schema, case_sensitive))


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

    def describe(self):
        return (f"InMemorySource[{self.table.num_rows} rows, "
                f"{self.num_partitions} parts]")


class ShuffleFileScan(PlanNode):
    """Scan of a cross-process shuffle directory written by
    ``shuffle/exchange_files.write_exchange`` (of either package): one
    partition per reduce partition, self-describing kudo frames and a
    manifest."""

    def __init__(self, root: str):
        from spark_rapids_tpu_torch.shuffle.exchange_files import (
            read_manifest,
        )
        from spark_rapids_tpu_torch.shuffle.serde import dtype_from_json
        self.children = []
        self.root = root
        m = read_manifest(root)
        self.n_reduce = int(m["n_reduce"])
        self._schema = T.Schema(tuple(
            T.StructField(n, dtype_from_json(t))
            for n, t in zip(m["names"], m["types"])))

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"ShuffleFileScan[{self.root}, n={self.n_reduce}]"


class TextScan(PlanNode):
    """A CSV, JSON-lines, Avro or ORC file scan, one partition per file:
    a host parse into a pyarrow table (pyarrow's readers, or
    ``io/avro.read_avro``), then the standard upload (reference
    GpuCSVScan / GpuJsonScan / GpuOrcScan / GpuAvroScan)."""

    FORMATS = ("csv", "json", "orc", "avro")

    def __init__(self, fmt: str, paths: Sequence[str],
                 schema: Optional[T.Schema] = None,
                 columns: Optional[List[str]] = None,
                 options: Optional[dict] = None):
        if fmt not in self.FORMATS:
            raise ValueError(f"text scan format {fmt!r} is not one of "
                             f"{self.FORMATS}")
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = schema
        self.columns = columns
        self.options = options or {}
        self.children = []

    def _csv_read_options(self, **kw):
        import pyarrow.csv as pcsv
        opts = self.options
        return pcsv.ReadOptions(
            column_names=opts.get("column_names"),
            autogenerate_column_names=not opts.get("header", True)
            and not opts.get("column_names"), **kw)

    def read_host(self, path: str):
        """One file as a pyarrow Table (the host parse)."""
        if self.fmt == "csv":
            import pyarrow.csv as pcsv
            # the column types are pinned to the PLAN schema (inferred
            # from the first block): a whole-file inference could disagree
            # with what the plan was built for
            column_types = None
            if self._schema is not None:
                column_types = {f.name: T.to_arrow(f.dtype)
                                for f in self._schema.fields}
            return pcsv.read_csv(
                path, read_options=self._csv_read_options(),
                parse_options=pcsv.ParseOptions(
                    delimiter=self.options.get("sep", ",")),
                convert_options=pcsv.ConvertOptions(
                    include_columns=self.columns or None,
                    column_types=column_types))
        if self.fmt == "json":
            import pyarrow.json as pjson
            t = pjson.read_json(path)
        elif self.fmt == "avro":
            from spark_rapids_tpu_torch.io.avro import read_avro
            t = read_avro(path)
        else:
            import pyarrow.orc as porc
            return porc.ORCFile(path).read(columns=self.columns)
        return t.select(self.columns) if self.columns else t

    @property
    def schema(self) -> T.Schema:
        if self._schema is None:
            if not self.paths:
                raise FileNotFoundError("TextScan: no input files")
            if self.fmt == "orc":
                import pyarrow.orc as porc
                pa_schema = porc.ORCFile(self.paths[0]).schema
            elif self.fmt == "csv":
                import pyarrow.csv as pcsv
                # the schema of the first block only
                with pcsv.open_csv(
                        self.paths[0],
                        read_options=self._csv_read_options(
                            block_size=1 << 20),
                        parse_options=pcsv.ParseOptions(
                            delimiter=self.options.get("sep", ","))) as r:
                    pa_schema = r.schema
            else:  # json and avro: parse the first file
                pa_schema = self.read_host(self.paths[0]).schema
            fields = [T.StructField(f.name, T.from_arrow(f.type))
                      for f in pa_schema]
            if self.columns:
                # the data comes back in the REQUESTED order: the schema
                # follows it, or names would bind to the wrong columns
                by_name = {f.name: f for f in fields}
                fields = [by_name[c] for c in self.columns]
            self._schema = T.Schema(tuple(fields))
        return self._schema

    def describe(self):
        return f"TextScan[{self.fmt}, {len(self.paths)} files]"


class ParquetScan(PlanNode):
    """Parquet files, one partition per file. The schema is read from the
    first file's footer (cut to ``columns``, in their order), then the
    hive partition columns, last. Filter pushdown (plan/overrides.py)
    fills ``pushed_filters``, which prune partition files by their
    partition values and row groups by footer statistics; the filter
    itself stays in the plan."""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[List[str]] = None,
                 partition_values: Optional[List[dict]] = None):
        self.paths = list(paths)
        self.columns = list(columns) if columns else None
        self.pushed_filters: List[Expression] = []
        #: hive-layout partition values per file (key -> str or None),
        #: appended as constant columns
        self.partition_values = partition_values
        #: the columns to read from the FILES: partition columns are not
        #: in them
        self.file_columns = self.columns
        if self.columns and partition_values:
            pkeys = {k for v in partition_values for k in v}
            self.file_columns = [c for c in self.columns if c not in pkeys]
        self._schema: Optional[T.Schema] = None
        self.children = []

    def partition_fields(self) -> List[T.StructField]:
        """The partition columns, in discovery order: INT64 when every
        non-null value parses as an integer, else STRING."""
        if not self.partition_values:
            return []
        keys: List[str] = []
        for vals in self.partition_values:
            for k in vals:
                if k not in keys:
                    keys.append(k)
        if self.columns:
            keys = [k for k in keys if k in self.columns]
        fields = []
        for k in keys:
            non_null = [v.get(k) for v in self.partition_values
                        if v.get(k) is not None]
            dt = T.STRING
            if non_null:
                try:
                    for v in non_null:
                        int(v)
                    dt = T.INT64
                except ValueError:
                    pass
            fields.append(T.StructField(k, dt))
        return fields

    def partition_arrays(self, file_idx: int, n: int):
        """(field, pyarrow array of n equal values) of each partition
        column of one file."""
        import pyarrow as pa
        vals = self.partition_values[file_idx] if self.partition_values \
            else {}
        out = []
        for f in self.partition_fields():
            v = vals.get(f.name)
            if v is not None and f.dtype == T.INT64:
                v = int(v)
            out.append((f, pa.array([v] * n, type=T.to_arrow(f.dtype))))
        return out

    def with_partition_cols(self, table, file_idx: int):
        """A host table of one file with its constant partition columns
        appended."""
        for f, arr in self.partition_arrays(file_idx, table.num_rows):
            table = table.append_column(f.name, arr)
        return table

    @property
    def schema(self):
        if self._schema is None:
            import pyarrow.parquet as pq
            arrow = pq.read_schema(self.paths[0])
            names = self.file_columns if self.columns else arrow.names
            missing = [c for c in names if c not in arrow.names]
            if missing:
                raise KeyError(f"columns {missing} not in {self.paths[0]!r}")
            # only the read columns need a type the engine carries
            self._schema = T.Schema(tuple(
                T.StructField(n, T.from_arrow(arrow.field(n).type))
                for n in names) + tuple(self.partition_fields()))
        return self._schema

    def describe(self):
        return f"ParquetScan[{len(self.paths)} files]"


class Range(PlanNode):
    """``session.range(start, end, step)``: one int64 column ``id``."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start = int(start)
        self.end = int(end)
        self.step = int(step)
        self.num_partitions = max(1, num_partitions)
        self.children = []

    def num_rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    @property
    def schema(self):
        return T.Schema((T.StructField("id", T.INT64),))

    def describe(self):
        return f"Range[{self.start},{self.end},{self.step}]"


class CachedRelation(PlanNode):
    """``df.cache()``: the child's result is materialized once on the card
    and reused by every later query over this node."""

    def __init__(self, child: PlanNode):
        self.children = [child]
        self.materialized = None  # List[List[ColumnarBatch]] once cached

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        state = "hot" if self.materialized is not None else "cold"
        return f"CachedRelation[{state}]"


class Project(PlanNode):
    def __init__(self, exprs: List[Expression], child: PlanNode):
        self.children = [child]
        self.exprs = [bind_expr(e, child.schema) for e in exprs]
        self.names = [expr_name(e, i) for i, e in enumerate(exprs)]

    @property
    def schema(self):
        return T.Schema(tuple(T.StructField(n, e.data_type())
                              for n, e in zip(self.names, self.exprs)))

    def describe(self):
        return f"Project[{', '.join(self.names)}]"


class Filter(PlanNode):
    def __init__(self, condition: Expression, child: PlanNode):
        self.children = [child]
        self.condition = bind_expr(condition, child.schema)
        dt = self.condition.data_type()
        if not isinstance(dt, (T.BooleanType, T.NullType)):
            # Spark's DATATYPE_MISMATCH.FILTER_NOT_BOOLEAN, at plan time
            # (ROADMAP C24)
            raise SparkException(
                f"[DATATYPE_MISMATCH.FILTER_NOT_BOOLEAN] Cannot resolve "
                f"filter {self.condition!r}: the condition has type "
                f"{dt!r}, not BOOLEAN")

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Filter[{self.condition!r}]"


class Aggregate(PlanNode):
    """Group-by aggregate; empty group_exprs = global aggregation."""

    def __init__(self, group_exprs: List[Expression], aggs: List[NamedAgg],
                 child: PlanNode):
        self.children = [child]
        self.group_exprs = [bind_expr(e, child.schema) for e in group_exprs]
        self.group_names = [expr_name(e, i) for i, e in enumerate(group_exprs)]
        self.aggs = [a.transform(lambda n: bind_expr(n, child.schema))
                     for a in aggs]
        if any(isinstance(a.fn, GroupingMarker) for a in self.aggs):
            raise SparkException("grouping()/grouping_id() is only valid "
                                 "with ROLLUP/CUBE/GROUPING SETS")

    @property
    def schema(self):
        fields = [T.StructField(n, e.data_type())
                  for n, e in zip(self.group_names, self.group_exprs)]
        fields += [T.StructField(a.name, a.fn.result_type())
                   for a in self.aggs]
        return T.Schema(tuple(fields))

    def describe(self):
        return (f"Aggregate[keys=[{', '.join(self.group_names)}], "
                f"aggs=[{', '.join(a.name for a in self.aggs)}]]")


class Repartition(PlanNode):
    """``df.repartition(n, *cols)``: hash-partition by keys into n_out, or
    round-robin when no keys are given."""

    def __init__(self, n_out: int, keys: List[Expression], child: PlanNode):
        self.children = [child]
        self.n_out = max(1, int(n_out))
        self.keys = [bind_expr(e, child.schema) for e in keys]

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        how = f"hash{self.keys!r}" if self.keys else "roundrobin"
        return f"Repartition[{how}, n={self.n_out}]"


@dataclasses.dataclass
class SortOrder:
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # Spark's default: nulls first iff asc

    def resolved_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


class Sort(PlanNode):
    def __init__(self, orders: List[SortOrder], child: PlanNode,
                 global_sort: bool = True):
        self.children = [child]
        self.orders = [SortOrder(bind_expr(o.expr, child.schema), o.ascending,
                                 o.nulls_first) for o in orders]
        self.global_sort = global_sort

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        parts = [f"{o.expr!r} {'ASC' if o.ascending else 'DESC'}"
                 for o in self.orders]
        return f"Sort[{', '.join(parts)}]"


class WindowNode(PlanNode):
    """Appends one column per window expression to the child's schema.
    The expressions of one node share one spec (``DataFrame.select``
    makes a node per spec and chains them)."""

    def __init__(self, window_exprs, names: List[str], child: PlanNode):
        from spark_rapids_tpu_torch.expr.window import WindowExpr, WindowSpec
        self.children = [child]
        self.names = names
        binder = make_binder(child.schema)
        bound = []
        for w in window_exprs:
            spec = w.spec
            if w.fn.needs_order and not spec.order_specs:
                # Spark raises AnalysisException: over an arbitrary order
                # the result would be meaningless
                raise ValueError(
                    f"{type(w.fn).__name__} requires the window to be "
                    f"ordered (add ORDER BY to the window spec)")
            bspec = WindowSpec(
                [bind_expr(e, child.schema) for e in spec.partition_exprs],
                [SortOrder(bind_expr(o.expr, child.schema), o.ascending,
                           o.nulls_first) for o in spec.order_specs],
                spec.frame)
            bound.append(WindowExpr(w.fn.transform(binder), bspec))
        self.window_exprs = bound

    @property
    def schema(self):
        fields = list(self.children[0].schema.fields)
        for w, n in zip(self.window_exprs, self.names):
            fields.append(T.StructField(n, w.fn.result_type()))
        return T.Schema(tuple(fields))

    def describe(self):
        return f"Window[{', '.join(self.names)}]"


class Limit(PlanNode):
    def __init__(self, n: int, child: PlanNode):
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Limit[{self.n}]"


def _nullable(fields):
    return [T.StructField(f.name, f.dtype, True) for f in fields]


class Join(PlanNode):
    """Equi-join with an optional extra condition, which binds against the
    left schema followed by the right one; the planner picks the physical
    strategy."""

    KINDS = ("inner", "left", "right", "full", "left_semi", "left_anti",
             "cross")

    def __init__(self, left: PlanNode, right: PlanNode,
                 left_keys: List[Expression], right_keys: List[Expression],
                 how: str = "inner", condition: Optional[Expression] = None):
        if how not in self.KINDS:
            raise ValueError(f"join type {how!r} is not one of {self.KINDS}")
        self.children = [left, right]
        self.left_keys = [bind_expr(e, left.schema) for e in left_keys]
        self.right_keys = [bind_expr(e, right.schema) for e in right_keys]
        self.how = how
        self.condition = (bind_expr(condition, self._concat_schema())
                          if condition is not None else None)

    def _concat_schema(self) -> T.Schema:
        return T.Schema(tuple(self.children[0].schema.fields)
                        + tuple(self.children[1].schema.fields))

    @property
    def schema(self):
        lf = list(self.children[0].schema.fields)
        rf = list(self.children[1].schema.fields)
        if self.how in ("left_semi", "left_anti"):
            return self.children[0].schema
        if self.how in ("right", "full"):
            lf = _nullable(lf)
        if self.how in ("left", "full"):
            rf = _nullable(rf)
        return T.Schema(tuple(lf + rf))

    def describe(self):
        keys = ", ".join(f"{l!r}={r!r}"
                         for l, r in zip(self.left_keys, self.right_keys))
        return f"Join[{self.how}, {keys}]"


class Union(PlanNode):
    """UNION ALL by position: each column widens to the children's common
    type; the names are the first child's."""

    def __init__(self, children: List[PlanNode]):
        if not children:
            raise ValueError("a union needs at least one child")
        arity = len(children[0].schema)
        for c in children[1:]:
            if len(c.schema) != arity:
                raise ValueError(f"UNION arity mismatch: {arity} vs "
                                 f"{len(c.schema)} columns")
        self.children = list(children)

    @property
    def schema(self):
        schemas = [c.schema for c in self.children]
        fields = []
        for i, f in enumerate(schemas[0].fields):
            dt = f.dtype
            for s in schemas[1:]:
                dt = T.common_type(dt, s.fields[i].dtype)
            fields.append(T.StructField(f.name, dt))
        return T.Schema(tuple(fields))

    def describe(self):
        return f"Union[{len(self.children)}]"


class Expand(PlanNode):
    """Several projections of each input row (the ROLLUP/CUBE/GROUPING
    SETS lowering); the output types are the first projection's."""

    def __init__(self, projections: List[List[Expression]],
                 names: List[str], child: PlanNode):
        self.children = [child]
        self.projections = [[bind_expr(e, child.schema) for e in p]
                            for p in projections]
        self.names = list(names)

    @property
    def schema(self):
        return T.Schema(tuple(T.StructField(n, e.data_type()) for n, e in
                              zip(self.names, self.projections[0])))

    def describe(self):
        return f"Expand[{len(self.projections)} projections]"


class Generate(PlanNode):
    """One output row per element of a generator over each input row
    (explode and posexplode, plain and outer). The output schema is the
    required child columns followed by the generated ones."""

    def __init__(self, generator, gen_names: List[str], child: PlanNode,
                 required: Optional[List[int]] = None):
        from spark_rapids_tpu_torch.expr.complex import Explode
        self.children = [child]
        assert isinstance(generator, Explode), type(generator)
        gen = type(generator)(bind_expr(generator.children[0], child.schema))
        self.generator = gen
        dt = gen.children[0].data_type()
        if not isinstance(dt, (T.ArrayType, T.MapType)):
            raise SparkException(
                f"explode() requires an array or map input, got {dt!r}")
        fields = gen.output_fields()
        if gen_names:
            assert len(gen_names) == len(fields), \
                f"generator yields {len(fields)} columns, got names {gen_names}"
            fields = [(n, t) for n, (_, t) in zip(gen_names, fields)]
        self.gen_fields = fields
        #: the child columns carried through (Spark's requiredChildOutput),
        #: all by default; the operator duplicates each of them per element
        n_child = len(child.schema.fields)
        self.required = list(range(n_child)) if required is None \
            else list(required)

    @property
    def schema(self):
        base = [self.children[0].schema.fields[i] for i in self.required]
        gen = [T.StructField(n, t) for n, t in self.gen_fields]
        return T.Schema(tuple(base + gen))

    def describe(self):
        kind = type(self.generator).__name__
        return f"Generate[{kind}({self.generator.children[0]!r})]"
