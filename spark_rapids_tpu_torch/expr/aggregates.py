"""Aggregate function descriptors: sum, count, avg, min, max.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py``; ``over(spec)``
makes a window aggregate (``expr/window.py``). Each function
declares its partial state columns (``state_schema``), the reduction that
builds each state from input rows (``update_ops``), the reduction that
merges partial states (``merge_ops``), and the final projection
(``evaluate``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import Expression


class AggFunction:
    def __init__(self, *children: Expression):
        self.children = list(children)

    def result_type(self) -> T.DataType:
        raise NotImplementedError

    def state_schema(self) -> List[Tuple[str, T.DataType]]:
        raise NotImplementedError

    def update_ops(self) -> List[Tuple[str, int]]:
        """[(reduction, input index)] producing each state column; index -1
        reads no input."""
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, state_cols: List[ColumnVector]) -> ColumnVector:
        return state_cols[0]

    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({kids})"

    def transform(self, fn) -> "AggFunction":
        return type(self)(*[c.transform(fn) for c in self.children])

    def alias(self, name: str) -> "NamedAgg":
        return NamedAgg(self, name)

    def over(self, spec):
        """agg OVER a window spec (pyspark's ``F.sum(c).over(w)``)."""
        from spark_rapids_tpu_torch.expr.window import over
        return over(self, spec)

    def __repr__(self):
        return self.fingerprint()


class NamedAgg:
    def __init__(self, fn: AggFunction, name: str):
        self.fn = fn
        self.name = name

    def transform(self, f) -> "NamedAgg":
        return NamedAgg(self.fn.transform(f), self.name)


class Sum(AggFunction):
    """Spark sum: integral inputs sum to long, floats to double; null when
    every input is null."""

    def result_type(self):
        return T.INT64 if self.children[0].data_type().is_integral \
            else T.FLOAT64

    def state_schema(self):
        return [("sum", self.result_type())]

    def update_ops(self):
        return [("sum", 0)]

    def merge_ops(self):
        return ["sum"]


class Count(AggFunction):
    def result_type(self):
        return T.INT64

    def state_schema(self):
        return [("count", T.INT64)]

    def update_ops(self):
        return [("count", 0)]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, state_cols):
        return ColumnVector(T.INT64, state_cols[0].data, None)


class CountAll(AggFunction):
    """count(*)."""

    def __init__(self):
        super().__init__()

    def result_type(self):
        return T.INT64

    def state_schema(self):
        return [("count", T.INT64)]

    def update_ops(self):
        return [("count_all", -1)]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, state_cols):
        return ColumnVector(T.INT64, state_cols[0].data, None)

    def transform(self, fn):
        return self


class Min(AggFunction):
    def result_type(self):
        return self.children[0].data_type()

    def state_schema(self):
        return [("min", self.result_type())]

    def update_ops(self):
        return [("min", 0)]

    def merge_ops(self):
        return ["min"]


class Max(AggFunction):
    def result_type(self):
        return self.children[0].data_type()

    def state_schema(self):
        return [("max", self.result_type())]

    def update_ops(self):
        return [("max", 0)]

    def merge_ops(self):
        return ["max"]


class Average(AggFunction):
    """avg: states (sum: double, count: long); result double."""

    def result_type(self):
        return T.FLOAT64

    def state_schema(self):
        return [("sum", T.FLOAT64), ("count", T.INT64)]

    def update_ops(self):
        return [("sum", 0), ("count", 0)]

    def merge_ops(self):
        return ["sum", "sum"]

    def evaluate(self, state_cols):
        s, c = state_cols
        cnt = c.data.to(torch.float64)
        val = s.data.to(torch.float64) / torch.where(cnt == 0, 1.0, cnt)
        return ColumnVector(T.FLOAT64, val, c.data > 0)
