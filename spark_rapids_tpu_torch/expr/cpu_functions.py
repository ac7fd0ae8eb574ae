"""CPU-only expressions: functions without a device implementation.

Counterpart of the datetime part of ``spark_rapids_tpu/expr/
cpu_functions.py`` (reference parity: the per-operator fallback keeps a
query running when an expression has no GPU implementation). Each is a
row function over python values, evaluated by the CPU backend; planning
tags the enclosing operator off the device with the JAX package's reason,
so it runs in ``CpuFallbackExec``. ``ALL_CPU_FUNCTIONS`` lists the ones
this engine has: the datetime formats ``date_format``, ``to_date`` and
``from_unixtime``. The JAX package's other row functions (reverse,
concat_ws, lpad/rpad, translate, substring_index, md5, sha2,
format_number and the second tier) wait for ROADMAP A9.
"""
from __future__ import annotations

import datetime as _dt
from typing import List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, \
    SparkException


class CpuRowFunction(Expression):
    """An expression evaluated row by row on the host (CPU backend
    only)."""

    #: subclasses set these
    name = "cpu_fn"
    result = T.STRING

    def __init__(self, *children, params=()):
        self.children = list(children)
        self.params = tuple(params)

    def data_type(self):
        return self.result

    def _params(self):
        return repr(self.params)

    def with_children(self, children):
        return type(self)(*children, params=self.params)

    def supported_on_tpu(self):
        return False

    def eval(self, ctx):
        raise NotImplementedError(f"{self.name} has no device kernel yet")

    def row_fn(self, *vals):
        raise NotImplementedError

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        valid = np.ones(n, np.bool_)
        for c in ins:
            valid = valid & c.valid
        out: List = []
        out_valid = valid.copy()
        # row functions are pure: each distinct input row is computed once
        # (a date column holds a few thousand days over millions of rows)
        memo = {}
        for i in range(n):
            if not valid[i]:
                out.append(None)
                continue
            args = tuple(c.values[i] for c in ins)
            r = memo.get(args, memo)
            if r is memo:
                r = memo[args] = self.row_fn(*args)
            if r is None:
                out_valid[i] = False
            out.append(r)
        if isinstance(self.result, T.StringType):
            vals = np.empty(n, object)
            vals[:] = out
        else:
            vals = np.array([0 if v is None else v for v in out]
                            ).astype(self.result.np_dtype)
        return CpuCol(self.result, vals, out_valid)


def _java_fmt_to_py(pattern: str) -> str:
    """Transpile the supported Java datetime-pattern subset to strftime,
    rejecting anything unhandled: a pattern like 'd/M/yyyy' or 'EEE' must
    raise, not silently emit literal 'd/M/2024'."""
    tokens = [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
              ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]
    out = []
    i = 0
    while i < len(pattern):
        for j, p in tokens:
            if pattern.startswith(j, i):
                out.append(p)
                i += len(j)
                break
        else:
            ch = pattern[i]
            if ch.isalpha() or ch in "%'":
                raise SparkException(
                    f"unsupported datetime pattern {pattern!r}: "
                    f"unhandled character {ch!r}")
            out.append(ch)
            i += 1
    return "".join(out)


class _Formatted(CpuRowFunction):
    """A row function with a Java datetime pattern as its parameter,
    checked when the expression is built."""

    default_fmt = "yyyy-MM-dd"

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        self._py = _java_fmt_to_py(params[0] if params
                                   else self.default_fmt)


class DateFormat(_Formatted):
    """date_format(date/ts, java-pattern-subset)."""

    name = "date_format"
    result = T.STRING

    def row_fn(self, v):
        src = self.children[0].data_type()
        if isinstance(src, T.TimestampType):
            d = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(v))
        else:
            d = _dt.datetime(1970, 1, 1) + _dt.timedelta(days=int(v))
        return d.strftime(self._py)


class ToDateFmt(_Formatted):
    """to_date(str, fmt): a string that does not parse is null (non-ANSI
    Spark)."""

    name = "to_date"
    result = T.DATE

    def row_fn(self, s):
        try:
            d = _dt.datetime.strptime(s, self._py).date()
        except (ValueError, TypeError):
            return None
        return (d - _dt.date(1970, 1, 1)).days


class FromUnixtime(_Formatted):
    """from_unixtime(seconds, fmt) -> string."""

    name = "from_unixtime"
    result = T.STRING
    default_fmt = "yyyy-MM-dd HH:mm:ss"

    def row_fn(self, v):
        return (_dt.datetime(1970, 1, 1)
                + _dt.timedelta(seconds=int(v))).strftime(self._py)


ALL_CPU_FUNCTIONS = [DateFormat, ToDateFmt, FromUnixtime]
