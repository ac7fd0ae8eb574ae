"""Functions of the DataFrame API (counterpart of
``spark_rapids_tpu/sql/functions.py``): the aggregates ``sum``, ``count``,
``avg``, ``min`` and ``max``, and the string functions ``length``,
``upper``, ``lower``, ``substring``, ``concat``, ``startswith``,
``endswith``, ``contains`` and ``like``."""
from __future__ import annotations

from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import strings as S
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


# strings --------------------------------------------------------------------
def length(c):
    return S.StringLength(_e(c))


def upper(c):
    return S.Upper(_e(c))


def lower(c):
    return S.Lower(_e(c))


def substring(c, pos, length_):
    return S.Substring(_e(c), pos, length_)


def concat(*cs):
    return S.ConcatStrings(*[_e(c) for c in cs])


def startswith(c, prefix):
    return S.StartsWith(_e(c), prefix)


def endswith(c, suffix):
    return S.EndsWith(_e(c), suffix)


def contains(c, s):
    return S.Contains(_e(c), s)


def like(c, pattern):
    return S.Like(_e(c), pattern)
