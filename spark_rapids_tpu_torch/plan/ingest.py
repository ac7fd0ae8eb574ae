"""Physical-plan ingestion: the versioned JSON plan contract (counterpart
of ``spark_rapids_tpu/plan/ingest.py``).

A Spark-side hook (a ColumnarRule or a listener serializing the physical
plan and its expressions) emits ``{"version": 1, "plan": <node>}`` and
this module converts it onto the engine's plan algebra; nothing below this
seam knows where a plan came from. ``plan/catalyst.py`` reads Spark's own
``executedPlan.toJSON`` instead.

Node grammar (version 1):
  {"node": "parquet_scan", "paths": [...], "columns": [...]?}
  {"node": "text_scan", "format": "csv|json|orc|avro", "paths": [...]}
  {"node": "in_memory", "rows": {col: [values...]}, "num_partitions": n?}
  {"node": "project", "exprs": [<expr>...], "child": <node>}
  {"node": "filter", "condition": <expr>, "child": <node>}
  {"node": "aggregate", "keys": [<expr>...], "aggs": [<agg>...], "child": ...}
  {"node": "join", "how": ..., "left_keys": [...], "right_keys": [...],
   "condition": <expr>?, "left": ..., "right": ...}
  {"node": "sort", "orders": [{"expr": <expr>, "ascending": bool,
   "nulls_first": bool?}...], "child": ...}
  {"node": "limit", "n": int, "child": ...}
  {"node": "union", "children": [...]}
  {"node": "generate", "generator": "explode|posexplode[_outer]",
   "input": <expr>, "child": ...}

Expression grammar:
  {"expr": "col", "name": str}
  {"expr": "lit", "value": ..., "type": <type-string>?}
  {"expr": "<binary-op>", "left": ..., "right": ...}   (add/sub/mul/div/
      mod/eq/ne/lt/le/gt/ge/and/or)
  {"expr": "not"|"is_null"|"is_not_null", "child": ...}
  {"expr": "cast", "type": <type-string>, "child": ...}
  {"expr": "call", "fn": <functions.py name>, "args": [...]}
  {"expr": "alias", "name": str, "child": ...}

Aggregates: {"fn": "sum|count|min|max|avg|...", "child": <expr>?,
"alias": str}. Types use the supported-ops spelling: int, long, double,
string, date, timestamp, decimal(p,s) (p at most 18: DECIMAL64), array<T>.

Scans: {"node": "parquet_scan", "paths": [...], "columns": [...]?} and
{"node": "text_scan", "format": "csv|json|orc|avro", "paths": [...],
"columns": [...]?}.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import nodes as P

VERSION = 1

_BINOPS = {
    "add": E.Add, "sub": E.Subtract, "mul": E.Multiply, "div": E.Divide,
    "mod": E.Remainder, "eq": E.EqualTo, "lt": E.LessThan,
    "le": E.LessThanOrEqual, "gt": E.GreaterThan,
    "ge": E.GreaterThanOrEqual, "and": E.And, "or": E.Or,
}

_TYPES = {
    "boolean": T.BOOLEAN, "byte": T.INT8, "short": T.INT16, "int": T.INT32,
    "long": T.INT64, "float": T.FLOAT32, "double": T.FLOAT64,
    "string": T.STRING, "date": T.DATE, "timestamp": T.TIMESTAMP,
}


def decimal_type(precision: int, scale: int, where: str) -> T.DecimalType:
    if precision > T.DecimalType.MAX_INT64_PRECISION:
        raise SparkException(
            f"{where}: decimal({precision},{scale}) has more than "
            f"{T.DecimalType.MAX_INT64_PRECISION} digits; this engine "
            f"carries DECIMAL64 only")
    return T.DecimalType(precision, scale)


def function(name: str, where: str):
    """The ``sql/functions.py`` function of that name."""
    from spark_rapids_tpu_torch.sql import functions as F
    return getattr(F, name, None)


def parse_type(s: str) -> T.DataType:
    s = s.strip()
    if s in _TYPES:
        return _TYPES[s]
    if s.startswith("decimal(") and s.endswith(")"):
        p, sc = s[8:-1].split(",")
        return decimal_type(int(p), int(sc), "plan ingestion")
    if s.startswith("array<") and s.endswith(">"):
        return T.ArrayType(parse_type(s[6:-1]))
    raise SparkException(f"plan ingestion: unknown type {s!r}")


def parse_expr(d) -> E.Expression:
    if not isinstance(d, dict) or "expr" not in d:
        raise SparkException(f"plan ingestion: bad expression {d!r}")
    op = d["expr"]
    if op == "col":
        return E.col(d["name"])
    if op == "lit":
        lit = E.lit(d["value"])
        if "type" in d:
            return E.Cast(lit, parse_type(d["type"]))
        return lit
    if op == "alias":
        return parse_expr(d["child"]).alias(d["name"])
    if op == "cast":
        return E.Cast(parse_expr(d["child"]), parse_type(d["type"]))
    if op == "ne":
        return E.Not(E.EqualTo(parse_expr(d["left"]), parse_expr(d["right"])))
    if op in _BINOPS:
        return _BINOPS[op](parse_expr(d["left"]), parse_expr(d["right"]))
    if op == "not":
        return E.Not(parse_expr(d["child"]))
    if op == "is_null":
        return E.IsNull(parse_expr(d["child"]))
    if op == "is_not_null":
        return E.IsNotNull(parse_expr(d["child"]))
    if op == "call":
        fn = function(d["fn"], "plan ingestion")
        if fn is None:
            raise SparkException(
                f"plan ingestion: unknown function {d['fn']!r}")
        return fn(*[parse_expr(a) for a in d.get("args", [])])
    raise SparkException(f"plan ingestion: unknown expression op {op!r}")


def _parse_agg(d):
    fn = function(d["fn"], "plan ingestion")
    if fn is None:
        raise SparkException(f"plan ingestion: unknown aggregate {d['fn']!r}")
    agg = fn(parse_expr(d["child"])) if "child" in d else fn()
    return agg.alias(d["alias"]) if "alias" in d else agg


def parse_node(d) -> P.PlanNode:
    node = d.get("node")
    if node == "parquet_scan":
        return P.ParquetScan(list(d["paths"]), columns=d.get("columns"))
    if node == "text_scan":
        return P.TextScan(d["format"], list(d["paths"]),
                          columns=d.get("columns"))
    if node == "in_memory":
        import pyarrow as pa
        return P.InMemorySource(pa.table(d["rows"]),
                                d.get("num_partitions", 1))
    if node == "project":
        return P.Project([parse_expr(e) for e in d["exprs"]],
                         parse_node(d["child"]))
    if node == "filter":
        return P.Filter(parse_expr(d["condition"]), parse_node(d["child"]))
    if node == "aggregate":
        return P.Aggregate([parse_expr(e) for e in d.get("keys", [])],
                           [_parse_agg(a) for a in d["aggs"]],
                           parse_node(d["child"]))
    if node == "join":
        return P.Join(parse_node(d["left"]), parse_node(d["right"]),
                      [parse_expr(e) for e in d.get("left_keys", [])],
                      [parse_expr(e) for e in d.get("right_keys", [])],
                      d.get("how", "inner"),
                      condition=(parse_expr(d["condition"])
                                 if "condition" in d else None))
    if node == "sort":
        orders = [P.SortOrder(parse_expr(o["expr"]),
                              bool(o.get("ascending", True)),
                              o.get("nulls_first"))
                  for o in d["orders"]]
        return P.Sort(orders, parse_node(d["child"]))
    if node == "limit":
        return P.Limit(int(d["n"]), parse_node(d["child"]))
    if node == "union":
        return P.Union([parse_node(c) for c in d["children"]])
    if node == "generate":
        from spark_rapids_tpu_torch.expr import complex as CX
        gens = {"explode": CX.Explode, "explode_outer": CX.ExplodeOuter,
                "posexplode": CX.PosExplode,
                "posexplode_outer": CX.PosExplodeOuter}
        if d["generator"] not in gens:
            raise SparkException(
                f"plan ingestion: unknown generator {d['generator']!r}")
        child = parse_node(d["child"])
        gen = gens[d["generator"]](
            P.bind_expr(parse_expr(d["input"]), child.schema))
        return P.Generate(gen, [], child)
    raise SparkException(f"plan ingestion: unknown node {node!r}")


def ingest(doc, session):
    """Versioned JSON physical plan -> DataFrame on this engine."""
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    if doc.get("version") != VERSION:
        raise SparkException(
            f"plan ingestion: unsupported version {doc.get('version')!r} "
            f"(this engine speaks version {VERSION})")
    return DataFrame(parse_node(doc["plan"]), session)
