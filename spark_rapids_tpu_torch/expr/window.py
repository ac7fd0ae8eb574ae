"""Window expressions.

Counterpart of ``spark_rapids_tpu/expr/window.py``. A ``WindowExpr`` pairs
a window function with a ``WindowSpec`` (partition-by, order-by, frame).
``DataFrame.select`` hoists window expressions into ``WindowNode``s, one
per spec; ``WindowExec`` sorts once per node and evaluates every function
of it as segmented scans over the sorted rows (``ops/window.py``).

Frames are (kind, lower, upper) with kind "rows" or "range"; a None bound
is UNBOUNDED, 0 is CURRENT ROW, other ints are offsets. Spark's defaults:
an ordered spec gets ("range", None, 0), running with ties; an unordered
one gets ("rows", None, None), the whole partition.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.aggregates import AggFunction
from spark_rapids_tpu_torch.expr.core import Expression, SparkException, col


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: str = "range"          # "rows" | "range"
    lower: Optional[int] = None  # None = UNBOUNDED PRECEDING
    upper: Optional[int] = 0     # None = UNBOUNDED FOLLOWING; 0 = CURRENT

    def fingerprint(self) -> str:
        return f"{self.kind}[{self.lower},{self.upper}]"


class WindowSpec:
    """Builder: Window.partition_by(...).order_by(...).rows_between(a, b)."""

    def __init__(self, partition_by=None, order_by=None,
                 frame: Optional[Frame] = None):
        self.partition_exprs: List[Expression] = list(partition_by or [])
        self.order_specs = list(order_by or [])  # plan.nodes.SortOrder
        self.frame = frame

    def partition_by(self, *exprs) -> "WindowSpec":
        es = [col(e) if isinstance(e, str) else e for e in exprs]
        return WindowSpec(es, self.order_specs, self.frame)

    def order_by(self, *orders) -> "WindowSpec":
        from spark_rapids_tpu_torch.plan.nodes import SortOrder
        os = [o if isinstance(o, SortOrder)
              else SortOrder(col(o) if isinstance(o, str) else o)
              for o in orders]
        return WindowSpec(self.partition_exprs, os, self.frame)

    def rows_between(self, lower, upper) -> "WindowSpec":
        return WindowSpec(self.partition_exprs, self.order_specs,
                          Frame("rows", lower, upper))

    def resolved_frame(self) -> Frame:
        if self.frame is not None:
            return self.frame
        if self.order_specs:
            return Frame("range", None, 0)
        return Frame("rows", None, None)

    def fingerprint(self) -> str:
        ps = ",".join(e.fingerprint() for e in self.partition_exprs)
        os = ",".join(f"{o.expr.fingerprint()}:{o.ascending}:"
                      f"{o.resolved_nulls_first()}" for o in self.order_specs)
        return f"spec({ps}|{os}|{self.resolved_frame().fingerprint()})"


class Window:
    """Entry points mirroring pyspark.sql.Window."""

    #: frame bound sentinels
    unboundedPreceding = None
    unboundedFollowing = None
    currentRow = 0

    @staticmethod
    def partition_by(*exprs) -> WindowSpec:
        return WindowSpec().partition_by(*exprs)

    partitionBy = partition_by

    @staticmethod
    def order_by(*orders) -> WindowSpec:
        return WindowSpec().order_by(*orders)

    orderBy = order_by


class WindowFunction:
    """Base of the window functions (rank family, lead/lag, ...)."""

    children: List[Expression] = []
    needs_order = True

    def result_type(self) -> T.DataType:
        raise NotImplementedError

    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({kids};{self._params()})"

    def _params(self) -> str:
        return ""

    def transform(self, fn) -> "WindowFunction":
        """A copy with ``fn`` applied to the child expressions' nodes."""
        return self

    def over(self, spec: WindowSpec) -> "WindowExpr":
        return WindowExpr(self, spec)


class RowNumber(WindowFunction):
    def result_type(self):
        return T.INT32


class Rank(WindowFunction):
    def result_type(self):
        return T.INT32


class DenseRank(WindowFunction):
    def result_type(self):
        return T.INT32


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.n = n

    def _params(self):
        return str(self.n)

    def result_type(self):
        return T.INT32


class LeadLag(WindowFunction):
    is_lead = True

    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.children = [child]
        self.offset = offset
        self.default = default

    def _params(self):
        return f"{self.offset},{self.default!r}"

    def result_type(self):
        return self.children[0].data_type()

    def transform(self, fn):
        return type(self)(self.children[0].transform(fn), self.offset,
                          self.default)


class Lead(LeadLag):
    is_lead = True


class Lag(LeadLag):
    is_lead = False


class PercentRank(WindowFunction):
    """(rank - 1) / (partition rows - 1); 0.0 for single-row partitions."""

    def result_type(self):
        return T.FLOAT64


class CumeDist(WindowFunction):
    """Rows ordering at or before the current one (peers included) over
    the partition's rows."""

    def result_type(self):
        return T.FLOAT64


class NthValue(WindowFunction):
    """nth_value(col, n): the partition's nth value once the frame has
    reached it, null before (Spark's default-frame semantics)."""

    def __init__(self, child: Expression, n: int):
        if n < 1:
            raise SparkException("nth_value offset must be >= 1")
        self.children = [child]
        self.n = n

    def _params(self):
        return str(self.n)

    def result_type(self):
        return self.children[0].data_type()

    def transform(self, fn):
        return NthValue(self.children[0].transform(fn), self.n)


class FirstValue(WindowFunction):
    def __init__(self, child: Expression):
        self.children = [child]

    def result_type(self):
        return self.children[0].data_type()

    def transform(self, fn):
        return FirstValue(self.children[0].transform(fn))


class LastValue(WindowFunction):
    """last_value over the frame: with Spark's default frame (unbounded
    preceding to the current row) that is the current peer group's last
    row."""

    def __init__(self, child: Expression):
        self.children = [child]

    def result_type(self):
        return self.children[0].data_type()

    def transform(self, fn):
        return LastValue(self.children[0].transform(fn))


class WindowAgg(WindowFunction):
    """An aggregate function evaluated over a window frame."""

    needs_order = False

    def __init__(self, fn: AggFunction):
        self.fn = fn
        self.children = list(fn.children)

    def _params(self):
        return type(self.fn).__name__

    def result_type(self):
        return self.fn.result_type()

    def transform(self, fn):
        return WindowAgg(self.fn.transform(fn))


class WindowExpr(Expression):
    """function OVER spec, in a projection list; ``DataFrame.select``
    hoists it into a ``WindowNode``."""

    def __init__(self, fn: WindowFunction, spec: WindowSpec):
        self.fn = fn
        self.spec = spec
        self.children = []

    def data_type(self) -> T.DataType:
        return self.fn.result_type()

    def fingerprint(self) -> str:
        return f"winexpr({self.fn.fingerprint()} over " \
               f"{self.spec.fingerprint()})"


def over(fn_or_agg, spec: WindowSpec) -> WindowExpr:
    if isinstance(fn_or_agg, AggFunction):
        fn_or_agg = WindowAgg(fn_or_agg)
    if not isinstance(fn_or_agg, WindowFunction):
        raise TypeError(f"not a window function: {fn_or_agg!r}")
    return WindowExpr(fn_or_agg, spec)
