"""Aggregate functions of the DataFrame API (counterpart of
``spark_rapids_tpu/sql/functions.py``): ``sum``, ``count``, ``avg``,
``min`` and ``max``."""
from __future__ import annotations

from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr.core import Expression, col, lit


def _e(c) -> Expression:
    return c if isinstance(c, Expression) else (col(c) if isinstance(c, str)
                                                else lit(c))


def sum(c):  # noqa: A001
    return A.Sum(_e(c))


def count(c="*"):
    if isinstance(c, str) and c == "*":
        return A.CountAll()
    return A.Count(_e(c))


def avg(c):
    return A.Average(_e(c))


def min(c):  # noqa: A001
    return A.Min(_e(c))


def max(c):  # noqa: A001
    return A.Max(_e(c))
