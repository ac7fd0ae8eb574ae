"""Catalyst physical-plan JSON: Spark's own wire format (counterpart of
``spark_rapids_tpu/plan/catalyst.py``).

The reference receives live Catalyst physical plans in
``ColumnarRule.preColumnarTransitions`` (Plugin.scala:53-60) and rewrites
them node by node (GpuOverrides.scala:4744). Without a JVM the boundary is
Spark's serialized plan, ``df.queryExecution.executedPlan.toJSON``, which
every Spark 3.x build emits with no plugin code; this module lowers its
node and expression classes onto the engine's plan algebra.

Format facts (TreeNode.scala jsonValue):
- a tree serializes as a JSON array of node objects in preorder; each
  carries "class" and "num-children", and its children follow it (rebuilt
  by arity, like Polish notation);
- a field that is one of the node's children serializes as the child's
  index (Cast's "child": 0); other TreeNode fields (a plan's expression
  lists) serialize as nested arrays;
- enum-like objects serialize as {"object": "org.apache...Inner$"}, an
  ExprId as {"product-class": ..., "id": N, "jvmId": uuid};
- a Literal's value is the string form of Spark's internal value (dates
  in epoch days, timestamps in epoch microseconds, decimals as the
  unscaled string).

An unsupported class raises SparkException naming it, in the JAX
package's words. Where the port lacks what the JAX package maps, it raises
as well: a decimal above 18 digits (DECIMAL64).
"""
from __future__ import annotations

import json
import re
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import nodes as P


class _TN:
    """One decoded TreeNode: raw field dict + decoded children."""

    __slots__ = ("obj", "children")

    def __init__(self, obj: dict, children: List["_TN"]):
        self.obj = obj
        self.children = children

    @property
    def cls(self) -> str:
        return self.obj.get("class", "").rsplit(".", 1)[-1]

    def field(self, name, default=None):
        return self.obj.get(name, default)


def _decode(arr: List[dict]) -> _TN:
    """Preorder array -> tree (children reconstructed by num-children)."""

    def rec(i: int) -> Tuple[_TN, int]:
        obj = arr[i]
        n = int(obj.get("num-children", 0))
        kids, j = [], i + 1
        for _ in range(n):
            node, j = rec(j)
            kids.append(node)
        return _TN(obj, kids), j

    node, j = rec(0)
    if j != len(arr):
        raise SparkException(
            f"catalyst plan: {len(arr) - j} trailing nodes after preorder "
            "reconstruction (malformed num-children)")
    return node


def _expr_tree(v) -> _TN:
    """An expression FIELD value (nested preorder array) -> tree."""
    if isinstance(v, list) and v and isinstance(v[0], dict) \
            and "class" in v[0]:
        return _decode(v)
    raise SparkException(f"catalyst plan: expected expression array, "
                         f"got {type(v).__name__}")


def _enum_name(v) -> str:
    """{"object": "org...Inner$"} / "Inner" -> "Inner"."""
    if isinstance(v, dict):
        v = v.get("object") or v.get("product-class") or ""
    return str(v).rstrip("$").rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# Types + literals
# ---------------------------------------------------------------------------

_DTYPES = {
    "boolean": T.BOOLEAN, "byte": T.INT8, "short": T.INT16,
    "integer": T.INT32, "long": T.INT64, "float": T.FLOAT32,
    "double": T.FLOAT64, "string": T.STRING, "date": T.DATE,
    "timestamp": T.TIMESTAMP, "null": T.NULL,
}


def _dtype(s) -> T.DataType:
    if isinstance(s, str):
        s = s.strip()
        if s in _DTYPES:
            return _DTYPES[s]
        m = re.fullmatch(r"decimal\((\d+),(\d+)\)", s)
        if m:
            from spark_rapids_tpu_torch.plan.ingest import decimal_type
            return decimal_type(int(m.group(1)), int(m.group(2)),
                                "catalyst plan")
    raise SparkException(f"catalyst plan: unsupported dataType {s!r}")


def _literal(node: _TN) -> E.Expression:
    dt = _dtype(node.field("dataType"))
    v = node.field("value")
    if v is None:
        return E.Literal(None, dt)
    if isinstance(dt, (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type,
                       T.DateType, T.TimestampType)):
        iv = int(v)
        if isinstance(dt, T.DateType):
            import datetime
            return E.Literal(datetime.date(1970, 1, 1)
                             + datetime.timedelta(days=iv), dt)
        if isinstance(dt, T.TimestampType):
            # the engine's timestamp plane holds UTC epoch microseconds
            return E.Literal(iv, dt)
        return E.Literal(iv, dt)
    if isinstance(dt, (T.Float32Type, T.Float64Type)):
        return E.Literal(float(v), dt)
    if isinstance(dt, T.BooleanType):
        return E.Literal(str(v).lower() == "true", dt)
    if isinstance(dt, T.DecimalType):
        import decimal
        return E.Literal(decimal.Decimal(str(v)), dt)
    return E.Literal(str(v), dt)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

_BIN = {
    "Add": E.Add, "Subtract": E.Subtract, "Multiply": E.Multiply,
    "Divide": E.Divide, "Remainder": E.Remainder, "Pmod": None,
    "EqualTo": E.EqualTo, "LessThan": E.LessThan,
    "LessThanOrEqual": E.LessThanOrEqual, "GreaterThan": E.GreaterThan,
    "GreaterThanOrEqual": E.GreaterThanOrEqual, "And": E.And, "Or": E.Or,
}

_AGG_FNS = {
    "Sum": "sum", "Count": "count", "Min": "min", "Max": "max",
    "Average": "avg", "First": "first", "Last": "last",
    "StddevSamp": "stddev", "VarianceSamp": "variance",
    "CollectList": "collect_list", "CollectSet": "collect_set",
}


def expr(node: _TN) -> E.Expression:
    c = node.cls
    if c == "AttributeReference":
        return E.col(node.field("name"))
    if c == "Literal":
        return _literal(node)
    if c == "Alias":
        return E.Alias(expr(node.children[0]), node.field("name"))
    if c == "Cast" or c == "AnsiCast":
        return E.Cast(expr(node.children[0]),
                      _dtype(node.field("dataType")))
    if c in _BIN and _BIN[c] is not None:
        return _BIN[c](expr(node.children[0]), expr(node.children[1]))
    if c == "Not":
        return E.Not(expr(node.children[0]))
    if c == "IsNull":
        return E.IsNull(expr(node.children[0]))
    if c == "IsNotNull":
        return E.IsNotNull(expr(node.children[0]))
    if c == "In":
        return E.In(expr(node.children[0]),
                    [expr(k) for k in node.children[1:]])
    if c == "InSet":
        vals = node.field("hset") or []
        return E.In(expr(node.children[0]), [E.lit(v) for v in vals])
    if c == "CaseWhen":
        # children = [cond1, val1, cond2, val2, ..., else?]
        kids = node.children
        pairs, default = [], None
        n2 = len(kids) // 2 * 2
        for i in range(0, n2, 2):
            pairs.append((expr(kids[i]), expr(kids[i + 1])))
        if len(kids) % 2:
            default = expr(kids[-1])
        return E.CaseWhen(pairs, default)
    if c == "Coalesce":
        from spark_rapids_tpu_torch.sql import functions as F
        return F.coalesce(*[expr(k) for k in node.children])
    if c == "Substring":
        from spark_rapids_tpu_torch.expr.strings import Substring
        pos, ln = expr(node.children[1]), expr(node.children[2])
        if not (isinstance(pos, E.Literal) and isinstance(ln, E.Literal)):
            raise SparkException(
                "catalyst plan: substring needs literal pos/len")
        return Substring(expr(node.children[0]), int(pos.value),
                         int(ln.value))
    if c == "Like":
        from spark_rapids_tpu_torch.expr.strings import Like
        pat = expr(node.children[1])
        if not isinstance(pat, E.Literal):
            raise SparkException("catalyst plan: LIKE needs literal pattern")
        return Like(expr(node.children[0]), pat.value)
    if c == "UnaryMinus":
        return E.UnaryMinus(expr(node.children[0]))
    if c == "AggregateExpression":
        return _agg_fn(node.children[0])
    if c in _AGG_FNS:
        return _agg_fn(node)
    if c == "SortOrder":
        # consumed by _sort_orders; appearing elsewhere is a bug
        raise SparkException("catalyst plan: SortOrder outside sort field")
    raise SparkException(
        f"catalyst plan: unsupported expression class "
        f"{node.obj.get('class')!r}")


def _agg_fn(node: _TN):
    from spark_rapids_tpu_torch.sql import functions as F
    c = node.cls
    if c == "AggregateExpression":
        # DISTINCT and FILTER (WHERE ...) change the aggregate's input
        # row set; silently dropping them is a wrong-results class of bug
        # (reference GpuOverrides tags these unsupported, falling back)
        if node.field("isDistinct"):
            raise SparkException(
                "catalyst plan: DISTINCT aggregates are not supported "
                "(AggregateExpression.isDistinct)")
        if node.field("filter") is not None:
            raise SparkException(
                "catalyst plan: FILTER (WHERE ...) aggregate clauses are "
                "not supported (AggregateExpression.filter)")
        return _agg_fn(node.children[0])
    if c not in _AGG_FNS:
        raise SparkException(
            f"catalyst plan: unsupported aggregate {node.obj.get('class')!r}")
    fn = getattr(F, _AGG_FNS[c])
    if c == "Count":
        kids = [expr(k) for k in node.children]
        if len(kids) == 1 and isinstance(kids[0], E.Literal):
            return F.count("*")
        return fn(kids[0])
    return fn(expr(node.children[0]))


def _sort_orders(v) -> List[P.SortOrder]:
    out = []
    for item in v:
        t = _expr_tree(item)
        if t.cls != "SortOrder":
            raise SparkException("catalyst plan: expected SortOrder")
        asc = _enum_name(t.field("direction")) == "Ascending"
        nf = _enum_name(t.field("nullOrdering")) == "NullsFirst"
        out.append(P.SortOrder(expr(t.children[0]), ascending=asc,
                               nulls_first=nf))
    return out


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------

_WRAPPERS = {
    "WholeStageCodegenExec", "InputAdapter", "AdaptiveSparkPlanExec",
    "ShuffleExchangeExec", "BroadcastExchangeExec",
    "ColumnarToRowExec", "RowToColumnarExec", "ShuffleQueryStageExec",
    "BroadcastQueryStageExec", "SortExec__removed",
}

_JOIN_TYPES = {
    "Inner": "inner", "LeftOuter": "left", "RightOuter": "right",
    "FullOuter": "full", "LeftSemi": "left_semi", "LeftAnti": "left_anti",
    "Cross": "cross",
}


def _scan_paths(node: _TN) -> List[str]:
    md = node.field("metadata") or {}
    loc = md.get("Location", "")
    m = re.search(r"\[(.*)\]", loc)
    if m:
        return [p.strip().replace("file:", "")
                for p in m.group(1).split(",") if p.strip()]
    if node.field("paths"):
        return list(node.field("paths"))
    raise SparkException("catalyst plan: scan without a Location")


def _output_names(node: _TN) -> Optional[List[str]]:
    out = node.field("output")
    if not out:
        return None
    names = []
    for a in out:
        t = _expr_tree(a)
        names.append(t.field("name"))
    return names


def plan(node: _TN) -> P.PlanNode:
    c = node.cls
    if c == "ReusedExchangeExec":
        # NOT an unwrappable wrapper: it references another exchange by id
        # and carries NO child in the TreeNode JSON (unwrapping via
        # children[0] dies with IndexError)
        raise SparkException(
            "catalyst plan: ReusedExchangeExec references a subtree by id "
            "and cannot be reconstructed from the serialized plan; re-run "
            "with spark.sql.exchange.reuse=false")
    if c in _WRAPPERS:
        return plan(node.children[0])
    if c == "ProjectExec":
        return P.Project([expr(_expr_tree(e))
                          for e in node.field("projectList")],
                         plan(node.children[0]))
    if c == "FilterExec":
        return P.Filter(expr(_expr_tree(node.field("condition"))),
                        plan(node.children[0]))
    if c in ("HashAggregateExec", "SortAggregateExec",
             "ObjectHashAggregateExec"):
        return _aggregate(node)
    if c in ("SortMergeJoinExec", "ShuffledHashJoinExec",
             "BroadcastHashJoinExec"):
        how = _JOIN_TYPES.get(_enum_name(node.field("joinType")))
        if how is None:
            raise SparkException(
                f"catalyst plan: join type "
                f"{node.field('joinType')!r} unsupported")
        lk = [expr(_expr_tree(e)) for e in node.field("leftKeys") or []]
        rk = [expr(_expr_tree(e)) for e in node.field("rightKeys") or []]
        cond = node.field("condition")
        return P.Join(plan(node.children[0]), plan(node.children[1]),
                      lk, rk, how,
                      condition=(expr(_expr_tree(cond))
                                 if cond else None))
    if c == "BroadcastNestedLoopJoinExec" or c == "CartesianProductExec":
        how = _JOIN_TYPES.get(_enum_name(node.field("joinType", "Cross")),
                              "cross")
        cond = node.field("condition")
        return P.Join(plan(node.children[0]), plan(node.children[1]),
                      [], [], how if c != "CartesianProductExec"
                      else "cross",
                      condition=(expr(_expr_tree(cond))
                                 if cond else None))
    if c == "SortExec":
        return P.Sort(_sort_orders(node.field("sortOrder")),
                      plan(node.children[0]))
    if c in ("GlobalLimitExec", "LocalLimitExec", "CollectLimitExec"):
        return P.Limit(int(node.field("limit")), plan(node.children[0]))
    if c == "TakeOrderedAndProjectExec":
        child = P.Limit(int(node.field("limit")),
                        P.Sort(_sort_orders(node.field("sortOrder")),
                               plan(node.children[0])))
        pl = node.field("projectList")
        if pl:
            return P.Project([expr(_expr_tree(e)) for e in pl], child)
        return child
    if c == "UnionExec":
        return P.Union([plan(k) for k in node.children])
    if c == "ExpandExec":
        projections = [[expr(_expr_tree(e)) for e in row]
                       for row in node.field("projections")]
        names = _output_names(node) or [
            P.expr_name(e, i) for i, e in enumerate(projections[0])]
        return P.Expand(projections, names, plan(node.children[0]))
    if c == "FileSourceScanExec":
        return P.ParquetScan(_scan_paths(node),
                             columns=_output_names(node))
    raise SparkException(
        f"catalyst plan: unsupported plan class {node.obj.get('class')!r}")


def _skip_to_partial_child(node: _TN) -> Tuple[Optional[_TN], _TN]:
    """From a FINAL aggregate's child, walk through exchanges to the
    PARTIAL aggregate (if present) and return (partial, its child)."""
    cur = node
    while cur.cls in _WRAPPERS:
        cur = cur.children[0]
    if cur.cls in ("HashAggregateExec", "SortAggregateExec",
                   "ObjectHashAggregateExec"):
        modes = {_enum_name(_expr_tree(a).field("mode"))
                 for a in cur.field("aggregateExpressions") or []}
        if modes <= {"Partial", "PartialMerge"}:
            return cur, cur.children[0]
    return None, node


def _aggregate(node: _TN) -> P.PlanNode:
    """Partial/Final Catalyst aggregate pairs collapse onto ONE engine
    Aggregate: the Final node carries the original agg functions (their
    children still reference the input attributes), so the partial stage
    and its exchange are planner artifacts the engine re-derives."""
    from spark_rapids_tpu_torch.expr.aggregates import NamedAgg
    aggs_raw = node.field("aggregateExpressions") or []
    modes = {_enum_name(_expr_tree(a).field("mode")) for a in aggs_raw}
    if modes & {"Partial", "PartialMerge"} and not (modes & {"Final",
                                                            "Complete"}):
        # a bare partial node reaching here means the caller started at
        # the partial: plan it as a complete aggregation
        child = plan(node.children[0])
    else:
        partial, below = _skip_to_partial_child(node.children[0])
        child = plan(below if partial is not None else node.children[0])
    keys = [expr(_expr_tree(e))
            for e in node.field("groupingExpressions") or []]
    fns = [_agg_fn(_expr_tree(a)) for a in aggs_raw]
    # result names: resultExpressions = [keys..., Alias(aggAttr, name)...]
    names: List[str] = []
    for e in node.field("resultExpressions") or []:
        t = _expr_tree(e)
        if t.cls == "Alias":
            names.append(t.field("name"))
    if len(names) < len(fns):
        names += [f"agg{i}" for i in range(len(names), len(fns))]
    named = [NamedAgg(fn, nm) for fn, nm in zip(fns, names)]
    return P.Aggregate(keys, named, child)


def ingest_catalyst(doc, session):
    """`executedPlan.toJSON` (string or decoded array) -> DataFrame."""
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    if isinstance(doc, str):
        doc = json.loads(doc)
    if isinstance(doc, dict):  # {"plan": [...]} envelope tolerated
        doc = doc.get("plan", doc)
    return DataFrame(plan(_decode(doc)), session)
