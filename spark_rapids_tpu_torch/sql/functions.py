"""Functions of the DataFrame API (counterpart of
``spark_rapids_tpu/sql/functions.py``): the aggregates ``sum``, ``count``,
``avg``, ``min`` and ``max``, and the string functions ``length``,
``upper``, ``lower``, ``substring``, ``concat``, ``startswith``,
``endswith``, ``contains`` and ``like``, and the window functions
``row_number``, ``rank``, ``dense_rank``, ``ntile``, ``percent_rank``,
``cume_dist``, ``nth_value``, ``first_value``, ``last_value``, ``lead`` and
``lag`` (``expr/window.py``; an aggregate's ``over`` makes the others)."""
from __future__ import annotations

from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr import window as W
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


# window ---------------------------------------------------------------------
def row_number():
    return W.RowNumber()


def rank():
    return W.Rank()


def dense_rank():
    return W.DenseRank()


def ntile(n: int):
    return W.NTile(n)


def percent_rank():
    return W.PercentRank()


def cume_dist():
    return W.CumeDist()


def nth_value(c, n: int):
    return W.NthValue(_e(c), n)


def first_value(c):
    return W.FirstValue(_e(c))


def last_value(c):
    return W.LastValue(_e(c))


def lead(c, offset: int = 1, default=None):
    return W.Lead(_e(c), offset, default)


def lag(c, offset: int = 1, default=None):
    return W.Lag(_e(c), offset, default)
