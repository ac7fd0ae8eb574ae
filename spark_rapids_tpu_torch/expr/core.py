"""Expression trees evaluated on torch tensors.

Counterpart of ``spark_rapids_tpu/expr/core.py``: column references,
literals (strings and nulls included), aliases, the partition context
(``SparkPartitionID``, ``MonotonicallyIncreasingID``), ``NullOf``,
``+ - * / %``, ``IntegralDivide``, ``UnaryMinus``, ``Abs``, comparisons
(strings: equality only, as on the JAX package's device), ``EqualNullSafe``,
``And``/``Or``/``Not``, ``IsNull``/``IsNotNull``/``IsNaN``, ``In``, ``If``
and ``CaseWhen``, the optimizer's markers (``KnownNotNull``,
``KnownFloatingPointNormalized``, ``NormalizeNaNAndZero``,
``AtLeastNNonNulls``), ``Coalesce``, the numeric, decimal, date,
timestamp and string casts, and the sort-order sugar (``asc``/``desc``
and their null-ordering forms). Decimals (DECIMAL64) compute on their unscaled
int64 values with the JAX package's rescaling rules (``_promote``).
The string functions are in ``expr/strings.py``, ``Greatest``/``Least`` in
``expr/math.py``. Null semantics follow Spark SQL, as in the JAX package:
arithmetic and comparisons propagate nulls, AND/OR are Kleene, division or
remainder by zero is null (or an error in ANSI mode).

``eval(ctx)`` runs eagerly over a batch's planes; a column whose validity
is None is valid on every live row. ``eval_cpu(cols, ansi)`` is the CPU
backend's path (``exec/cpu_backend.py``): numpy values and a validity
plane per column (``CpuCol``), the JAX package's ``eval_cpu`` arithmetic,
so an operator that falls back to the CPU answers as the JAX package's
fallback does.
"""
from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, round_capacity, rows_tensor,
)


class SparkException(Exception):
    """An ANSI-mode runtime error (division by zero, cast overflow)."""


@dataclasses.dataclass
class CpuCol:
    """The CPU backend's column: numpy values and a bool validity plane
    (True = valid). Strings are object arrays of python str."""
    dtype: T.DataType
    values: np.ndarray
    valid: np.ndarray


def _rows(cols: Sequence[CpuCol]) -> int:
    return len(cols[0].values) if cols else 0


class EvalCtx:
    """Input columns of one batch, its live mask, the ANSI error planes
    collected while evaluating, the lambda bindings of a higher-order
    function's element context, and the partition context a projection
    threads (``partition_id``, and ``row_base``: the live rows of the
    partition's earlier batches); other operators leave ``partition_id``
    None."""

    def __init__(self, columns: Sequence[ColumnVector], num_rows,
                 capacity: int, device, ansi: bool = False,
                 live: Optional[torch.Tensor] = None,
                 partition_id: Optional[int] = None, row_base=0):
        self.columns = list(columns)
        self.num_rows = num_rows
        self.capacity = capacity
        self.device = torch.device(device)
        self.ansi = ansi
        self.live = live
        self.partition_id = partition_id
        self.row_base = row_base
        self.errors: List[Tuple[str, torch.Tensor]] = []
        #: lambda variable id -> the element column it is bound to
        #: (``expr/hof.py``; inherited by a nested lambda's context)
        self.lambda_bindings: dict = {}

    @property
    def row_mask(self) -> torch.Tensor:
        if self.live is not None:
            return self.live
        pos = torch.arange(self.capacity, device=self.device)
        return pos < rows_tensor(self.num_rows)

    def add_error(self, code: str, mask: torch.Tensor) -> None:
        self.errors.append((code, mask & self.row_mask))


def raise_errors(errors: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Raise the first ANSI error any live row hit (one sync per plane)."""
    for code, mask in errors:
        if bool(mask.any().item()):
            raise SparkException(f"[{code}] ANSI mode error")


class Expression:
    children: List["Expression"] = []

    def data_type(self) -> T.DataType:
        raise NotImplementedError

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        raise NotImplementedError(f"{type(self).__name__} on the device")

    def eval_cpu(self, cols: Sequence[CpuCol], ansi: bool = False) -> CpuCol:
        raise NotImplementedError(f"{type(self).__name__} on the CPU")

    def static_range(self):
        """Optional (lo, hi) int bounds derivable from the expression alone
        (``x % 1000``); lets radix packing skip its range probe."""
        return None

    def _params(self) -> str:
        return ""

    def fingerprint(self) -> str:
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{type(self).__name__}({self._params()};{kids})"

    def with_children(self, children: List["Expression"]) -> "Expression":
        return self

    def transform(self, fn) -> "Expression":
        new = self.with_children([c.transform(fn) for c in self.children])
        return fn(new)

    def __repr__(self):
        return self.fingerprint()

    def __add__(self, o): return Add(self, _wrap(o))
    def __radd__(self, o): return Add(_wrap(o), self)
    def __sub__(self, o): return Subtract(self, _wrap(o))
    def __rsub__(self, o): return Subtract(_wrap(o), self)
    def __mul__(self, o): return Multiply(self, _wrap(o))
    def __rmul__(self, o): return Multiply(_wrap(o), self)
    def __truediv__(self, o): return Divide(self, _wrap(o))
    def __mod__(self, o): return Remainder(self, _wrap(o))
    def __neg__(self): return UnaryMinus(self)
    def __eq__(self, o): return EqualTo(self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return Not(EqualTo(self, _wrap(o)))  # type: ignore[override]
    def __lt__(self, o): return LessThan(self, _wrap(o))
    def __le__(self, o): return LessThanOrEqual(self, _wrap(o))
    def __gt__(self, o): return GreaterThan(self, _wrap(o))
    def __ge__(self, o): return GreaterThanOrEqual(self, _wrap(o))
    def __and__(self, o): return And(self, _wrap(o))
    def __or__(self, o): return Or(self, _wrap(o))
    def __invert__(self): return Not(self)

    def __hash__(self):
        return hash(self.fingerprint())

    def is_null(self): return IsNull(self)
    def is_not_null(self): return IsNotNull(self)
    def alias(self, name): return Alias(self, name)
    def cast(self, dtype): return Cast(self, dtype)

    def isin(self, *vals):
        # a null in the list is a null of the tested column's type
        return In(self, [NullOf(self) if v is None else _wrap(v)
                         for v in vals])

    def substr(self, pos, length):
        """pyspark Column.substr (1-based)."""
        from spark_rapids_tpu_torch.expr.strings import Substring
        return Substring(self, pos, length)

    # complex-type sugar (Spark's Column.getItem/getField)
    def get_item(self, key):
        from spark_rapids_tpu_torch.expr import complex as CX
        if isinstance(key, str):
            return CX.GetMapValue(self, _wrap(key))
        return CX.GetArrayItem(self, _wrap(key))

    getItem = get_item

    def get_field(self, name: str):
        from spark_rapids_tpu_torch.expr import complex as CX
        return CX.GetStructField(self, name)

    getField = get_field

    # sort-order sugar (Spark's Column.asc/desc family)
    def _order(self, ascending, nulls_first=None):
        from spark_rapids_tpu_torch.plan.nodes import SortOrder
        return SortOrder(self, ascending, nulls_first)

    def asc(self): return self._order(True)
    def desc(self): return self._order(False)
    def asc_nulls_first(self): return self._order(True, True)
    def asc_nulls_last(self): return self._order(True, False)
    def desc_nulls_first(self): return self._order(False, True)
    def desc_nulls_last(self): return self._order(False, False)


def _wrap(v) -> Expression:
    return v if isinstance(v, Expression) else Literal.infer(v)


def col(name: str) -> "Col":
    return Col(name)


def lit(v) -> "Literal":
    return Literal.infer(v)


def _valid_of(c: ColumnVector, ctx: EvalCtx) -> torch.Tensor:
    # validity None means valid wherever the row is live
    return c.validity if c.validity is not None else ctx.row_mask


def _typed(c: ColumnVector, dt: T.DataType, ctx: EvalCtx) -> ColumnVector:
    """An untyped NULL column as the all-null column of ``dt``; any other
    column unchanged."""
    if isinstance(c.dtype, T.NullType) and not isinstance(dt, T.NullType):
        return Literal(None, dt).eval(ctx)
    return c


def _typed_cpu(c: CpuCol, dt: T.DataType) -> CpuCol:
    if isinstance(c.dtype, T.NullType) and not isinstance(dt, T.NullType):
        n = len(c.values)
        vals = np.zeros(n, object if isinstance(dt, (
            T.StringType, T.ArrayType, T.StructType, T.MapType))
            else dt.np_dtype)
        return CpuCol(dt, vals, np.zeros(n, np.bool_))
    return c


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class Col(Expression):
    """Unresolved column name; binding rewrites it to a BoundRef."""

    def __init__(self, name: str):
        self.name = name
        self.children = []

    def data_type(self):
        raise RuntimeError(f"unresolved column {self.name!r}")

    def _params(self):
        return self.name


class BoundRef(Expression):
    def __init__(self, index: int, dtype: T.DataType, name: str = ""):
        self.index = index
        self.dtype = dtype
        self.name = name
        self.children = []

    def data_type(self):
        return self.dtype

    def _params(self):
        return f"{self.index}:{self.dtype!r}"

    def eval(self, ctx):
        return ctx.columns[self.index]

    def eval_cpu(self, cols, ansi=False):
        return cols[self.index]


class Literal(Expression):
    def __init__(self, value, dtype: T.DataType):
        self.value = value
        self.dtype = dtype
        self.children = []

    @staticmethod
    def infer(v) -> "Literal":
        if v is None:
            return Literal(None, T.NULL)
        if isinstance(v, bool):
            return Literal(v, T.BOOLEAN)
        if isinstance(v, int):
            return Literal(v, T.INT32 if -(2 ** 31) <= v < 2 ** 31
                           else T.INT64)
        if isinstance(v, float):
            return Literal(v, T.FLOAT64)
        if isinstance(v, str):
            return Literal(v, T.STRING)
        if isinstance(v, decimal.Decimal):
            _, digits, exp = v.as_tuple()
            scale = max(0, -exp)
            return Literal(v, T.DecimalType(max(len(digits), scale + 1),
                                            scale))
        # before the date arm: a datetime is a date too
        if isinstance(v, datetime.datetime):
            return Literal(v, T.TIMESTAMP)
        if isinstance(v, datetime.date):
            return Literal(v, T.DATE)
        raise TypeError(f"cannot infer literal type for {v!r}")

    def data_type(self):
        return self.dtype

    def static_range(self):
        if self.dtype.is_integral:
            return (int(self.value), int(self.value))
        return None

    def _params(self):
        return f"{self.value!r}:{self.dtype!r}"

    def _scalar(self):
        if isinstance(self.dtype, T.TimestampType) \
                and isinstance(self.value, datetime.datetime):
            # epoch microseconds, exact: naive means UTC, an aware value
            # converts by its own offset
            v = self.value
            if v.tzinfo is None:
                v = v.replace(tzinfo=datetime.timezone.utc)
            epoch = datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
            return (v - epoch) // datetime.timedelta(microseconds=1)
        if isinstance(self.dtype, T.DateType) \
                and isinstance(self.value, datetime.date):
            return (self.value - datetime.date(1970, 1, 1)).days
        if isinstance(self.dtype, T.DecimalType):
            # the unscaled value at the type's scale
            return int(decimal.Decimal(self.value).scaleb(
                self.dtype.scale).to_integral_value())
        return self.value

    def eval(self, ctx):
        cap = ctx.capacity
        if self.value is None:
            if isinstance(self.dtype, T.StringType):
                data = {"offsets": torch.zeros(cap + 1, dtype=torch.int32,
                                               device=ctx.device),
                        "bytes": torch.zeros(8, dtype=torch.uint8,
                                             device=ctx.device)}
            else:
                data = torch.zeros(cap, dtype=self.dtype.torch_dtype,
                                   device=ctx.device)
            return ColumnVector(self.dtype, data, torch.zeros(
                cap, dtype=torch.bool, device=ctx.device))
        if isinstance(self.dtype, T.StringType):
            # the value repeated on every row, as flat planes
            bs = self.value.encode("utf-8")
            n = cap * len(bs)
            raw = torch.zeros(round_capacity(max(n, 1)), dtype=torch.uint8,
                              device=ctx.device)
            if bs:
                raw[:n] = torch.tensor(list(bs), dtype=torch.uint8,
                                       device=ctx.device).repeat(cap)
            offsets = torch.arange(cap + 1, dtype=torch.int32,
                                   device=ctx.device) * len(bs)
            return ColumnVector(self.dtype, {"offsets": offsets,
                                             "bytes": raw},
                                torch.ones(cap, dtype=torch.bool,
                                           device=ctx.device))
        data = torch.full((ctx.capacity,), self._scalar(),
                          dtype=self.dtype.torch_dtype, device=ctx.device)
        return ColumnVector(self.dtype, data,
                            torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, cols, ansi=False):
        n = _rows(cols)
        is_str = isinstance(self.dtype, T.StringType)
        if self.value is None:
            vals = np.zeros(n, object if is_str else self.dtype.np_dtype)
            return CpuCol(self.dtype, vals, np.zeros(n, np.bool_))
        if is_str:
            return CpuCol(self.dtype, np.array([self.value] * n, object),
                          np.ones(n, np.bool_))
        return CpuCol(self.dtype, np.full(n, self._scalar(),
                                          self.dtype.np_dtype),
                      np.ones(n, np.bool_))


def _partition_ctx(ctx: EvalCtx, name: str) -> int:
    if ctx.partition_id is None:
        # the JAX package tags these to the CPU outside a projection
        raise NotImplementedError(
            f"{name} outside a projection (a CPU fallback in the JAX "
            f"package; ROADMAP A3)")
    return ctx.partition_id


class SparkPartitionID(Expression):
    """spark_partition_id(): the index of the partition being projected."""

    #: evaluates only with a projection's partition context
    #: (``needs_partition_context``)
    reads_partition = True

    def __init__(self):
        self.children = []

    def data_type(self):
        return T.INT32

    def eval(self, ctx):
        pid = _partition_ctx(ctx, "spark_partition_id()")
        return ColumnVector(T.INT32, torch.full(
            (ctx.capacity,), pid, dtype=torch.int32, device=ctx.device), None)

    def eval_cpu(self, cols, ansi=False):
        # the CPU backend runs over its input collected into partition 0
        n = _rows(cols)
        return CpuCol(T.INT32, np.zeros(n, np.int32), np.ones(n, np.bool_))


class MonotonicallyIncreasingID(Expression):
    """monotonically_increasing_id(): (partition_id << 33) + the row's
    index among the partition's live rows (Spark's layout); dead rows get
    values that are masked downstream."""

    reads_partition = True
    #: reads the partition's earlier live rows (``needs_row_base``)
    reads_row_base = True

    def __init__(self):
        self.children = []

    def data_type(self):
        return T.INT64

    def eval(self, ctx):
        pid = _partition_ctx(ctx, "monotonically_increasing_id()")
        idx = torch.cumsum(ctx.row_mask.to(torch.int64), 0) - 1
        return ColumnVector(T.INT64, idx + ctx.row_base + (pid << 33), None)

    def eval_cpu(self, cols, ansi=False):
        # partition 0 of the collected input: the ids count from 0
        n = _rows(cols)
        return CpuCol(T.INT64, np.arange(n, dtype=np.int64),
                      np.ones(n, np.bool_))


def needs_row_base(e: Expression) -> bool:
    """Does e read the running live-row count a projection threads
    (monotonically_increasing_id, rand)?"""
    return getattr(e, "reads_row_base", False) \
        or any(needs_row_base(c) for c in e.children)


def needs_partition_context(e: Expression) -> bool:
    """Does e read the partition context (spark_partition_id,
    monotonically_increasing_id, rand)?"""
    return getattr(e, "reads_partition", False) \
        or any(needs_partition_context(c) for c in e.children)


class NullOf(Expression):
    """An all-null column of its child's type (after binding), for
    rewrites such as nullif that need a typed null before names resolve;
    the child is not evaluated."""

    def __init__(self, child: Expression):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return NullOf(children[0])

    def eval(self, ctx):
        return Literal(None, self.data_type()).eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        return Literal(None, self.data_type()).eval_cpu(cols, ansi)


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = [child]
        self.name = name

    def data_type(self):
        return self.children[0].data_type()

    def static_range(self):
        return self.children[0].static_range()

    def _params(self):
        return self.name

    def with_children(self, children):
        return Alias(children[0], self.name)

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        return self.children[0].eval_cpu(cols, ansi)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _dec_shift(src: T.DataType, out: T.DecimalType) -> int:
    """The power of ten that brings src's unscaled values to out's scale
    (an integer is a decimal of scale 0)."""
    src_scale = src.scale if isinstance(src, T.DecimalType) else 0
    return out.scale - src_scale


def _promote(l: ColumnVector, r: ColumnVector, out: T.DataType):
    """Both operands in the type ``out``: a decimal result rescales the
    unscaled int64 values; a decimal meeting a float becomes its value."""
    def conv(c):
        if isinstance(c.dtype, T.NullType):
            return torch.zeros(c.data.shape, dtype=out.torch_dtype,
                               device=c.data.device)
        if isinstance(out, T.DecimalType):
            sh = _dec_shift(c.dtype, out)
            d = c.data.to(torch.int64)
            return d * (10 ** sh) if sh else d
        d = c.data.to(out.torch_dtype)
        if isinstance(c.dtype, T.DecimalType):
            d = d / (10.0 ** c.dtype.scale)
        return d
    return conv(l), conv(r)


def _promote_cpu(l: CpuCol, r: CpuCol, out: T.DataType):
    def conv(c):
        if isinstance(c.dtype, T.NullType):
            return np.zeros(len(c.values), out.np_dtype)
        if isinstance(out, T.DecimalType):
            sh = _dec_shift(c.dtype, out)
            d = c.values.astype(np.int64)
            return d * (10 ** sh) if sh else d
        d = c.values.astype(out.np_dtype, copy=False)
        if isinstance(c.dtype, T.DecimalType):
            d = d / np.float64(10.0 ** c.dtype.scale)
        return d
    return conv(l), conv(r)


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])


class BinaryArithmetic(BinaryExpression):
    @staticmethod
    def op(a, b):
        raise NotImplementedError

    def data_type(self):
        return T.common_type(self.left.data_type(), self.right.data_type())

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        out = self.data_type()
        ld, rd = _promote(l, r, out)
        return ColumnVector(out, type(self).op(ld, rd),
                            _valid_of(l, ctx) & _valid_of(r, ctx))

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        out = self.data_type()
        ld, rd = _promote_cpu(l, r, out)
        with np.errstate(all="ignore"):
            data = type(self).op(ld, rd)
        return CpuCol(out, data.astype(out.np_dtype, copy=False),
                      l.valid & r.valid)


class Add(BinaryArithmetic):
    op = staticmethod(lambda a, b: a + b)


class Subtract(BinaryArithmetic):
    op = staticmethod(lambda a, b: a - b)


class Multiply(BinaryArithmetic):
    """``*``. Two decimals multiply their unscaled values (precision p1 +
    p2 + 1, scale s1 + s2); past 18 digits the product is FLOAT64, and so
    is a decimal times an integer whose digits could pass 18 (the JAX
    package's rules)."""

    op = staticmethod(lambda a, b: a * b)

    def data_type(self):
        lt, rt = self.left.data_type(), self.right.data_type()
        if not (isinstance(lt, T.DecimalType)
                or isinstance(rt, T.DecimalType)):
            return T.common_type(lt, rt)
        if isinstance(lt, T.DecimalType) and isinstance(rt, T.DecimalType):
            if lt.scale + rt.scale > 18 \
                    or lt.precision + rt.precision + 1 > 18:
                return T.FLOAT64
            return T.DecimalType(lt.precision + rt.precision + 1,
                                 lt.scale + rt.scale)
        dec = lt if isinstance(lt, T.DecimalType) else rt
        other = rt if dec is lt else lt
        if other.is_integral:
            int_prec = {1: 3, 2: 5, 4: 10, 8: 19}.get(
                other.np_dtype.itemsize, 19)
            if dec.precision + int_prec > 18:
                return T.FLOAT64
            return T.DecimalType(18, dec.scale)
        return T.FLOAT64

    def eval(self, ctx):
        out = self.data_type()
        if not isinstance(out, T.DecimalType):
            return super().eval(ctx)
        # the scales add: the unscaled values multiply directly
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        return ColumnVector(out, l.data.to(torch.int64)
                            * r.data.to(torch.int64),
                            _valid_of(l, ctx) & _valid_of(r, ctx))

    def eval_cpu(self, cols, ansi=False):
        out = self.data_type()
        if not isinstance(out, T.DecimalType):
            return super().eval_cpu(cols, ansi)
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        with np.errstate(all="ignore"):
            data = l.values.astype(np.int64) * r.values.astype(np.int64)
        return CpuCol(out, data, l.valid & r.valid)


class Divide(BinaryExpression):
    """Spark ``/``: double result (a decimal divides as its value);
    division by zero is null (ANSI: error)."""

    def data_type(self):
        return T.FLOAT64

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        ld = l.data.to(torch.float64)
        rd = r.data.to(torch.float64)
        if isinstance(l.dtype, T.DecimalType):
            ld = ld / (10.0 ** l.dtype.scale)
        if isinstance(r.dtype, T.DecimalType):
            rd = rd / (10.0 ** r.dtype.scale)
        zero = rd == 0.0
        valid = _valid_of(l, ctx) & _valid_of(r, ctx)
        if ctx.ansi:
            ctx.add_error("DIVIDE_BY_ZERO", zero & valid)
        data = ld / torch.where(zero, 1.0, rd)
        return ColumnVector(T.FLOAT64, torch.where(zero, 0.0, data),
                            valid & ~zero)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        ld = l.values.astype(np.float64)
        rd = r.values.astype(np.float64)
        if isinstance(l.dtype, T.DecimalType):
            ld = ld / (10.0 ** l.dtype.scale)
        if isinstance(r.dtype, T.DecimalType):
            rd = rd / (10.0 ** r.dtype.scale)
        zero = rd == 0.0
        valid = l.valid & r.valid
        if ansi and bool((zero & valid).any()):
            raise SparkException("[DIVIDE_BY_ZERO] Division by zero")
        with np.errstate(all="ignore"):
            data = np.where(zero, 0.0, ld / np.where(zero, 1.0, rd))
        return CpuCol(T.FLOAT64, data, valid & ~zero)


class IntegralDivide(BinaryExpression):
    """Spark ``div``: long division truncated toward zero; division by
    zero is null (ANSI: error)."""

    def data_type(self):
        return T.INT64

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        ld = _to_int(l.data, torch.int64)
        rd = _to_int(r.data, torch.int64)
        zero = rd == 0
        valid = _valid_of(l, ctx) & _valid_of(r, ctx)
        if ctx.ansi:
            ctx.add_error("DIVIDE_BY_ZERO", zero & valid)
        q = _java_int_div(ld, torch.where(zero, torch.ones_like(rd), rd))
        return ColumnVector(T.INT64, torch.where(zero, torch.zeros_like(q), q),
                            valid & ~zero)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        ld = l.values.astype(np.int64)
        rd = r.values.astype(np.int64)
        zero = rd == 0
        valid = l.valid & r.valid
        if ansi and bool((zero & valid).any()):
            raise SparkException("[DIVIDE_BY_ZERO] Division by zero")
        safe = np.where(zero, 1, rd)
        with np.errstate(all="ignore"):
            q = ld // safe
            rem = ld - q * safe
            # numpy floors; Java truncates toward zero
            q = np.where((rem != 0) & ((ld < 0) != (safe < 0)), q + 1, q)
        return CpuCol(T.INT64, np.where(zero, 0, q), valid & ~zero)


def _java_int_div(a, b):
    """Truncated (toward-zero) integer division, Java semantics; b is
    never 0. MIN_VALUE / -1 wraps to MIN_VALUE, as in Java and XLA (the
    CPU's divide instruction traps on it, so -1 divides by negation)."""
    neg1 = b == -1
    q = torch.div(a, torch.where(neg1, torch.ones_like(b), b),
                  rounding_mode="trunc")
    return torch.where(neg1, -a, q)


class Remainder(BinaryExpression):
    """Spark ``%``: the sign follows the dividend; a zero divisor is null."""

    def data_type(self):
        return T.common_type(self.left.data_type(), self.right.data_type())

    def static_range(self):
        r = self.right.static_range()
        if r is None or not self.data_type().is_integral:
            return None
        m = max(abs(r[0]), abs(r[1]))
        if m == 0:
            return None
        lr = self.left.static_range()
        lo = 0 if (lr is not None and lr[0] >= 0) else -(m - 1)
        return (lo, m - 1)

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        out = self.data_type()
        ld, rd = _promote(l, r, out)
        valid = _valid_of(l, ctx) & _valid_of(r, ctx)
        if out.is_integral or isinstance(out, T.DecimalType):
            # decimals rescale to unscaled int64 lanes: integer arithmetic
            zero = rd == 0
            if ctx.ansi:
                ctx.add_error("DIVIDE_BY_ZERO", zero & valid)
            safe = torch.where(zero, torch.ones_like(rd), rd)
            rem = ld - _java_int_div(ld, safe) * safe
            return ColumnVector(out, torch.where(zero, torch.zeros_like(rem),
                                                 rem), valid & ~zero)
        return ColumnVector(out, torch.where(rd == 0, float("nan"),
                                             torch.fmod(ld, rd)), valid)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        out = self.data_type()
        ld, rd = _promote_cpu(l, r, out)
        valid = l.valid & r.valid
        with np.errstate(all="ignore"):
            if out.is_integral or isinstance(out, T.DecimalType):
                zero = rd == 0
                if ansi and bool((zero & valid).any()):
                    raise SparkException("[DIVIDE_BY_ZERO] Division by zero")
                rem = np.fmod(ld, np.where(zero, 1, rd))
                return CpuCol(out, np.where(zero, 0, rem), valid & ~zero)
            return CpuCol(out, np.fmod(ld, rd), valid)


class UnaryMinus(Expression):
    """Negation; integers wrap (non-ANSI Spark, as the JAX package)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return UnaryMinus(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(c.dtype, -c.data, _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        with np.errstate(all="ignore"):
            return CpuCol(c.dtype, -c.values, c.valid)


class Abs(Expression):
    """abs(); an integer MIN_VALUE stays MIN_VALUE, as in the JAX
    package."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return Abs(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(c.dtype, torch.abs(c.data), _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        with np.errstate(all="ignore"):
            return CpuCol(c.dtype, np.abs(c.values), c.valid)


# ---------------------------------------------------------------------------
# Comparisons and boolean logic
# ---------------------------------------------------------------------------

def window_eq(raw: torch.Tensor, base: torch.Tensor, pat: bytes
              ) -> torch.Tensor:
    """bool per row: raw[base + k] == pat[k] for every k (positions
    clamped into the plane; callers check that the window fits)."""
    base = base.to(torch.int64)
    eq = torch.ones(base.shape[0], dtype=torch.bool, device=base.device)
    if raw.shape[0] == 0:
        return eq if not pat else torch.zeros_like(eq)
    last = raw.shape[0] - 1
    for k, b in enumerate(pat):
        eq &= raw[torch.clamp(base + k, 0, last)] == b
    return eq


def _equals_bytes(off: torch.Tensor, raw: torch.Tensor, value: bytes
                  ) -> torch.Tensor:
    """bool per row of a flat (offsets, bytes) pair: the row is ``value``."""
    return ((off[1:] - off[:-1]) == len(value)) & window_eq(raw, off[:-1],
                                                            value)


def _string_eq_literal(c: ColumnVector, value: str) -> torch.Tensor:
    """Row equality of a string column with a literal; a dictionary
    column compares its vocabulary once and maps back by code."""
    target = value.encode("utf-8")
    if c.is_dict:
        veq = _equals_bytes(c.data["dict_offsets"], c.data["dict_bytes"],
                            target)
        if not veq.shape[0]:
            return torch.zeros(c.capacity, dtype=torch.bool, device=c.device)
        return veq[c.data["codes"].to(torch.int64).clamp(
            0, veq.shape[0] - 1)]
    return _equals_bytes(c.data["offsets"], c.data["bytes"], target)


def _string_eq(l: ColumnVector, r: ColumnVector) -> torch.Tensor:
    """Exact per-row string equality: equal lengths and equal bytes,
    compared byte by byte up to the longest string of equal length (one
    host read for it). Dictionary pairs sharing one vocabulary that holds
    each string once compare codes."""
    from spark_rapids_tpu_torch.ops.kernels import flatten_dict_column
    if l.is_dict and r.is_dict and l.dict_unique and r.dict_unique \
            and l.data["dict_offsets"] is r.data["dict_offsets"] \
            and l.data["dict_bytes"] is r.data["dict_bytes"]:
        return l.data["codes"] == r.data["codes"]
    if l.is_dict:
        l = flatten_dict_column(l, l.capacity)
    if r.is_dict:
        r = flatten_dict_column(r, r.capacity)
    lo = l.data["offsets"].to(torch.int64)
    ro = r.data["offsets"].to(torch.int64)
    lb, rb = l.data["bytes"], r.data["bytes"]
    ll = lo[1:] - lo[:-1]
    eq = ll == (ro[1:] - ro[:-1])
    maxlen = int(torch.where(eq, ll, 0).max().item()) if eq.numel() else 0
    for p in range(maxlen):
        active = p < ll
        lv = lb[torch.clamp(lo[:-1] + p, 0, max(lb.shape[0] - 1, 0))]
        rv = rb[torch.clamp(ro[:-1] + p, 0, max(rb.shape[0] - 1, 0))]
        eq &= ~active | (lv == rv)
    return eq


class BinaryComparison(BinaryExpression):
    @staticmethod
    def op(a, b):
        raise NotImplementedError

    def data_type(self):
        return T.BOOLEAN

    def eval(self, ctx):
        lt, rt = self.left.data_type(), self.right.data_type()
        if isinstance(lt, T.NullType) or isinstance(rt, T.NullType):
            return Literal(None, T.BOOLEAN).eval(ctx)
        if isinstance(lt, T.StringType):
            return self._string_compare(ctx)
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        out = T.common_type(l.dtype, r.dtype)
        ld, rd = _promote(l, r, out)
        return ColumnVector(T.BOOLEAN, type(self).op(ld, rd),
                            _valid_of(l, ctx) & _valid_of(r, ctx))

    def _compare_cpu(self, l: CpuCol, r: CpuCol):
        if isinstance(l.dtype, T.StringType):
            # a null row holds None, which python cannot order against a
            # str: compare "" there (the row's result is null anyway)
            lv = np.where(l.valid, l.values, "")
            rv = np.where(r.valid, r.values, "")
            return type(self).op(lv, rv).astype(np.bool_)
        ld, rd = _promote_cpu(l, r, T.common_type(l.dtype, r.dtype))
        with np.errstate(all="ignore"):
            return type(self).op(ld, rd)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        if isinstance(l.dtype, T.NullType) or isinstance(r.dtype, T.NullType):
            return Literal(None, T.BOOLEAN).eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, self._compare_cpu(l, r), l.valid & r.valid)

    def _string_compare(self, ctx):
        if type(self) is not EqualTo:
            # planning tags string ordering comparisons to the CPU
            raise NotImplementedError("string ordering comparison on the "
                                      "device")
        left, right = self.left, self.right
        if isinstance(left, Literal) and not isinstance(right, Literal):
            left, right = right, left
        l = left.eval(ctx)
        if isinstance(right, Literal) and right.value is not None:
            # no per-row copy of the literal
            return ColumnVector(T.BOOLEAN,
                                _string_eq_literal(l, right.value),
                                _valid_of(l, ctx))
        r = right.eval(ctx)
        return ColumnVector(T.BOOLEAN, _string_eq(l, r),
                            _valid_of(l, ctx) & _valid_of(r, ctx))


class EqualTo(BinaryComparison):
    op = staticmethod(lambda a, b: a == b)


class LessThan(BinaryComparison):
    op = staticmethod(lambda a, b: a < b)


class LessThanOrEqual(BinaryComparison):
    op = staticmethod(lambda a, b: a <= b)


class GreaterThan(BinaryComparison):
    op = staticmethod(lambda a, b: a > b)


class GreaterThanOrEqual(BinaryComparison):
    op = staticmethod(lambda a, b: a >= b)


class EqualNullSafe(BinaryComparison):
    """``<=>``: null <=> null is true, and the result is never null."""

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        if isinstance(l.dtype, T.StringType):
            cmp = _string_eq(l, r)
        else:
            ld, rd = _promote(l, r, T.common_type(l.dtype, r.dtype))
            cmp = ld == rd
        lv, rv = _valid_of(l, ctx), _valid_of(r, ctx)
        return ColumnVector(T.BOOLEAN, torch.where(lv & rv, cmp, ~lv & ~rv),
                            torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        cmp = self._compare_cpu(l, r)
        val = np.where(l.valid & r.valid, cmp, ~l.valid & ~r.valid)
        return CpuCol(T.BOOLEAN, val, np.ones(len(val), np.bool_))


class And(BinaryExpression):
    def data_type(self):
        return T.BOOLEAN

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        lv, rv = _valid_of(l, ctx), _valid_of(r, ctx)
        ld, rd = l.data.to(torch.bool), r.data.to(torch.bool)
        valid = (lv & rv) | (lv & ~ld) | (rv & ~rd)
        return ColumnVector(T.BOOLEAN, ld & rd & lv & rv, valid)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        ld = l.values.astype(np.bool_)
        rd = r.values.astype(np.bool_)
        valid = (l.valid & r.valid) | (l.valid & ~ld) | (r.valid & ~rd)
        return CpuCol(T.BOOLEAN, ld & rd & l.valid & r.valid, valid)


class Or(BinaryExpression):
    def data_type(self):
        return T.BOOLEAN

    def eval(self, ctx):
        l = self.left.eval(ctx)
        r = self.right.eval(ctx)
        lv, rv = _valid_of(l, ctx), _valid_of(r, ctx)
        ld = l.data.to(torch.bool) & lv
        rd = r.data.to(torch.bool) & rv
        return ColumnVector(T.BOOLEAN, ld | rd, (lv & rv) | ld | rd)

    def eval_cpu(self, cols, ansi=False):
        l = self.left.eval_cpu(cols, ansi)
        r = self.right.eval_cpu(cols, ansi)
        ld = l.values.astype(np.bool_) & l.valid
        rd = r.values.astype(np.bool_) & r.valid
        return CpuCol(T.BOOLEAN, ld | rd, (l.valid & r.valid) | ld | rd)


class Not(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return Not(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(T.BOOLEAN, ~c.data.to(torch.bool),
                            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, ~c.values.astype(np.bool_), c.valid)


class IsNull(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return IsNull(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(T.BOOLEAN, ~_valid_of(c, ctx),
                            torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, ~c.valid, np.ones(len(c.valid), np.bool_))


class IsNotNull(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return IsNotNull(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(T.BOOLEAN, _valid_of(c, ctx).clone(),
                            torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, c.valid.copy(), np.ones(len(c.valid),
                                                         np.bool_))


class IsNaN(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return IsNaN(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(T.BOOLEAN, torch.isnan(c.data), _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, np.isnan(c.values.astype(np.float64)),
                      c.valid)


class _RawCol(Expression):
    """An already evaluated column as an expression."""

    def __init__(self, col: ColumnVector):
        self.col = col
        self.children = []

    def data_type(self):
        return self.col.dtype

    def eval(self, ctx):
        return self.col


class _RawCpu(Expression):
    """An already evaluated CPU column as an expression."""

    def __init__(self, col: CpuCol):
        self.col = col
        self.children = []

    def data_type(self):
        return self.col.dtype

    def eval_cpu(self, cols, ansi=False):
        return self.col


class In(Expression):
    """``x IN (v1, ...)``, folded as ``x = v1 OR x = v2 ...`` over the
    evaluated column, so nulls come out Kleene: no match and a null in the
    list (or a null x) is null."""

    def __init__(self, child, values: List[Expression]):
        self.children = [child] + list(values)

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return In(children[0], children[1:])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        acc = None
        for v in self.children[1:]:
            if isinstance(v, NullOf) or (isinstance(v, Literal)
                                         and v.value is None):
                # x = NULL is null on every row
                eq = ColumnVector(T.BOOLEAN, torch.zeros(
                    ctx.capacity, dtype=torch.bool, device=ctx.device),
                    torch.zeros(ctx.capacity, dtype=torch.bool,
                                device=ctx.device))
            else:
                eq = EqualTo(_RawCol(c), v).eval(ctx)
            acc = eq if acc is None else Or(_RawCol(acc), _RawCol(eq)).eval(ctx)
        return acc

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        acc = None
        for v in self.children[1:]:
            eq = EqualTo(_RawCpu(c), v).eval_cpu(cols, ansi)
            acc = eq if acc is None \
                else Or(_RawCpu(acc), _RawCpu(eq)).eval_cpu(cols, ansi)
        return acc


class If(Expression):
    """``if(p, a, b)``: a where p is true, b where it is false or null; the
    result takes the branches' common type."""

    def __init__(self, pred, then, otherwise):
        self.children = [pred, then, otherwise]

    def data_type(self):
        return T.common_type(self.children[1].data_type(),
                             self.children[2].data_type())

    def with_children(self, children):
        return If(children[0], children[1], children[2])

    def eval(self, ctx):
        out = self.data_type()
        p = self.children[0].eval(ctx)
        t = _typed(self.children[1].eval(ctx), out, ctx)
        f = _typed(self.children[2].eval(ctx), out, ctx)
        take_then = p.data.to(torch.bool) & _valid_of(p, ctx)
        valid = torch.where(take_then, _valid_of(t, ctx), _valid_of(f, ctx))
        if isinstance(out, T.StringType):
            from spark_rapids_tpu_torch.expr.strings import select_strings
            return select_strings(take_then, t, f, valid)
        td, fd = _promote(t, f, out)
        return ColumnVector(out, torch.where(take_then, td, fd), valid)

    def eval_cpu(self, cols, ansi=False):
        out = self.data_type()
        p = self.children[0].eval_cpu(cols, ansi)
        t = _typed_cpu(self.children[1].eval_cpu(cols, ansi), out)
        f = _typed_cpu(self.children[2].eval_cpu(cols, ansi), out)
        take_then = p.values.astype(np.bool_) & p.valid
        if isinstance(out, T.StringType):
            vals = np.where(take_then, t.values, f.values)
        else:
            td, fd = _promote_cpu(t, f, out)
            vals = np.where(take_then, td, fd)
        return CpuCol(out, vals, np.where(take_then, t.valid, f.valid))


class CaseWhen(Expression):
    """``CASE WHEN p1 THEN v1 ... ELSE e END``, folded as nested ``If``s.
    Without an ELSE the result is null of the first branch's type."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 otherwise: Optional[Expression] = None):
        self.branches = list(branches)
        self.otherwise_expr = otherwise if otherwise is not None \
            else NullOf(self.branches[0][1])
        self.children = [e for b in self.branches for e in b] \
            + [self.otherwise_expr]

    def _fold(self) -> Expression:
        out = self.otherwise_expr
        for p, v in reversed(self.branches):
            out = If(p, v, out)
        return out

    def data_type(self):
        return self._fold().data_type()

    def with_children(self, children):
        nb = len(self.branches)
        return CaseWhen([(children[2 * i], children[2 * i + 1])
                         for i in range(nb)], children[-1])

    def eval(self, ctx):
        return self._fold().eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        return self._fold().eval_cpu(cols, ansi)


class KnownNotNull(Expression):
    """Catalyst's marker that the child was proven non-null: a
    pass-through."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        return self.children[0].eval_cpu(cols, ansi)


class KnownFloatingPointNormalized(KnownNotNull):
    """Pass-through marker: the child's NaN and -0.0 are already
    canonical."""


class NormalizeNaNAndZero(Expression):
    """Canonical floats for grouping and join keys: -0.0 becomes 0.0 and
    every NaN the canonical NaN."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return NormalizeNaNAndZero(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.data
        if v.dtype in (torch.float32, torch.float64):
            v = torch.where(v == 0, torch.zeros_like(v), v)
            v = torch.where(torch.isnan(v), float("nan"), v)
        return ColumnVector(c.dtype, v, _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        v = c.values
        with np.errstate(all="ignore"):
            v = np.where(v == 0, np.zeros((), v.dtype), v)
            v = np.where(np.isnan(v), np.nan, v)
        return CpuCol(c.dtype, v, c.valid)


class AtLeastNNonNulls(Expression):
    """Catalyst's dropna predicate: at least n children are non-null (and,
    for floats, not NaN, which Spark counts as missing here); never
    null."""

    def __init__(self, n: int, *children):
        self.n = int(n)
        self.children = list(children)

    def _params(self):
        return str(self.n)

    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def eval(self, ctx):
        cnt = torch.zeros(ctx.capacity, dtype=torch.int32, device=ctx.device)
        for c in self.children:
            cc = c.eval(ctx)
            ok = _valid_of(cc, ctx)
            if isinstance(cc.dtype, (T.Float32Type, T.Float64Type)):
                ok = ok & ~torch.isnan(cc.data)
            cnt = cnt + ok.to(torch.int32)
        return ColumnVector(T.BOOLEAN, cnt >= self.n,
                            torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, cols, ansi=False):
        cnt = np.zeros(_rows(cols), np.int32)
        for c in self.children:
            cc = c.eval_cpu(cols, ansi)
            ok = cc.valid
            if isinstance(cc.dtype, (T.Float32Type, T.Float64Type)):
                with np.errstate(all="ignore"):
                    ok = ok & ~np.isnan(cc.values)
            cnt = cnt + ok.astype(np.int32)
        return CpuCol(T.BOOLEAN, cnt >= self.n, np.ones(len(cnt), np.bool_))


class Coalesce(Expression):
    """The first non-null child per row, in the children's common type."""

    def __init__(self, *exprs):
        self.children = list(exprs)

    def data_type(self):
        dt = self.children[0].data_type()
        for c in self.children[1:]:
            dt = T.common_type(dt, c.data_type())
        return dt

    def with_children(self, children):
        return Coalesce(*children)

    def eval(self, ctx):
        out = self.data_type()
        acc = _typed(self.children[0].eval(ctx), out, ctx)
        acc_valid = _valid_of(acc, ctx)
        if not isinstance(out, T.StringType) and acc.dtype != out:
            acc = ColumnVector(out, acc.data.to(out.torch_dtype), acc_valid)
        for c in self.children[1:]:
            nxt = _typed(c.eval(ctx), out, ctx)
            nxt_valid = _valid_of(nxt, ctx)
            if isinstance(out, T.StringType):
                from spark_rapids_tpu_torch.expr.strings import select_strings
                acc = select_strings(acc_valid, acc, nxt,
                                     acc_valid | nxt_valid)
            else:
                acc = ColumnVector(out, torch.where(
                    acc_valid, acc.data, nxt.data.to(out.torch_dtype)),
                    acc_valid | nxt_valid)
            acc_valid = acc.validity
        return acc

    def eval_cpu(self, cols, ansi=False):
        out = self.data_type()

        def values(c):
            return c.values if isinstance(out, T.StringType) \
                else c.values.astype(out.np_dtype)
        acc = _typed_cpu(self.children[0].eval_cpu(cols, ansi), out)
        vals, valid = values(acc), acc.valid.copy()
        for c in self.children[1:]:
            nxt = _typed_cpu(c.eval_cpu(cols, ansi), out)
            vals = np.where(valid, vals, values(nxt))
            valid = valid | nxt.valid
        return CpuCol(out, vals, valid)


_INT_BOUNDS = {
    torch.int8: (-(2 ** 7), 2 ** 7 - 1),
    torch.int16: (-(2 ** 15), 2 ** 15 - 1),
    torch.int32: (-(2 ** 31), 2 ** 31 - 1),
    torch.int64: (-(2 ** 63), 2 ** 63 - 1),
}


def _to_int(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """data as an integer plane; floats convert as XLA does (and Spark's
    cast): truncated, saturated at the type's bounds, NaN to 0."""
    if data.dtype not in (torch.float32, torch.float64):
        return data.to(dtype)
    lo, hi = _INT_BOUNDS[dtype]
    v = data.to(torch.float64)
    clamped = torch.where(torch.isnan(v), 0.0, v).clamp(lo, hi)
    out = torch.trunc(clamped).to(dtype)
    if dtype == torch.int64:
        # 2**63 - 1 rounds to 2.0**63 as a double, which the CPU converts
        # to MIN_VALUE: saturate on the integer result
        out = torch.where(clamped >= 2.0 ** 63, hi, out)
    return out


def _float_to_int_np(v: np.ndarray, np_dtype) -> np.ndarray:
    """The CPU backend's float to integer conversion, as ``_to_int``:
    truncated, NaN to 0, saturated at the type's bounds. The bounds are
    compared in float64 before the conversion: the long maximum rounds
    up to 2.0**63 as a double, which no int64 holds (ROADMAP C22)."""
    info = np.iinfo(np_dtype)
    v = np.where(np.isnan(v), 0.0, v)
    hi, lo = v >= float(info.max), v <= float(info.min)
    out = np.trunc(np.where(hi | lo, 0.0, v)).astype(np_dtype)
    return np.where(hi, info.max, np.where(lo, info.min, out)).astype(
        np_dtype)


class Cast(Expression):
    """Numeric, bool, decimal, date and timestamp casts (Spark non-ANSI
    semantics: float to int truncates and saturates, NaN becomes 0;
    integer narrowing wraps; a decimal scale-down rounds HALF_UP, a value
    past the target precision is null; decimal to integer truncates;
    timestamp to date and to integers floors to days and seconds; date and
    integers to timestamp scale to microseconds, wrapping in int64). The
    arms run in the JAX package's order. Casts to and from strings run in
    ``expr/strings.cast_string_device`` (the CPU backend's in
    ``cast_string_cpu``)."""

    def __init__(self, child: Expression, to: T.DataType):
        self.children = [child]
        self.to = to

    def data_type(self):
        return self.to

    def _params(self):
        return repr(self.to)

    def with_children(self, children):
        return Cast(children[0], self.to)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        src, dst = c.dtype, self.to
        if src == dst:
            return c
        if isinstance(src, T.NullType):
            return Literal(None, dst).eval(ctx)
        if isinstance(src, T.StringType) or isinstance(dst, T.StringType):
            from spark_rapids_tpu_torch.expr.strings import cast_string_device
            return cast_string_device(c, dst, ctx)
        valid = _valid_of(c, ctx)
        if isinstance(src, T.BooleanType):
            return ColumnVector(dst, c.data.to(dst.torch_dtype), valid)
        if isinstance(dst, T.BooleanType):
            return ColumnVector(dst, c.data != 0, valid)
        if isinstance(dst, (T.Float32Type, T.Float64Type)):
            if isinstance(src, T.DecimalType):
                # the JAX package's steps: the unscaled value in dst's
                # type, divided in double
                data = c.data.to(dst.torch_dtype).to(torch.float64) \
                    / (10.0 ** src.scale)
                return ColumnVector(dst, data.to(dst.torch_dtype), valid)
            return ColumnVector(dst, c.data.to(dst.torch_dtype), valid)
        if isinstance(dst, T.DecimalType):
            return self._to_decimal(c, dst, ctx, valid)
        if isinstance(src, T.DecimalType) and dst.is_integral:
            q = _java_int_div(c.data, torch.full_like(c.data,
                                                      10 ** src.scale))
            return ColumnVector(dst, q.to(dst.torch_dtype), valid)
        if isinstance(src, (T.Float32Type, T.Float64Type)) and dst.is_integral:
            lo, hi = _INT_BOUNDS[dst.torch_dtype]
            v = c.data.to(torch.float64)
            if ctx.ansi:
                ctx.add_error("CAST_OVERFLOW",
                              (torch.isnan(v) | (v < lo) | (v > hi)) & valid)
            return ColumnVector(dst, _to_int(v, dst.torch_dtype), valid)
        # integral, date or timestamp to integral, date or timestamp
        data = _to_int(c.data, torch.int64)
        if isinstance(src, T.TimestampType) and isinstance(dst, T.DateType):
            days = torch.div(data, _MICROS_PER_DAY, rounding_mode="floor")
            return ColumnVector(dst, days.to(torch.int32), valid)
        if isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
            return ColumnVector(dst, data * _MICROS_PER_DAY, valid)
        if isinstance(src, T.TimestampType) and dst.is_integral:
            data = torch.div(data, 1_000_000, rounding_mode="floor")
        if isinstance(dst, T.TimestampType) and src.is_integral:
            return ColumnVector(dst, data * 1_000_000, valid)
        if ctx.ansi and dst.is_integral:
            lo, hi = _INT_BOUNDS[dst.torch_dtype]
            ctx.add_error("CAST_OVERFLOW", ((data < lo) | (data > hi)) & valid)
        return ColumnVector(dst, data.to(dst.torch_dtype), valid)

    @staticmethod
    def _to_decimal(c, dst, ctx, valid):
        """To a decimal: rescale (a scale-down rounds HALF_UP), scale an
        integer up, or round a float's scaled value half to even (XLA's
        round, like ``torch.round``); a value past the precision is null
        (ANSI: an error), and so is a NaN, as in Spark (the JAX package
        gives 0 there)."""
        src = c.dtype
        bound = 10 ** min(dst.precision, 18)
        if isinstance(src, (T.Float32Type, T.Float64Type)):
            # range-checked before the conversion, whose result for NaN
            # and out-of-range values differs between devices
            scaled = torch.round(c.data.to(torch.float64)
                                 * (10.0 ** dst.scale))
            overflow = ~(scaled.abs() < bound)
            data = torch.where(overflow, 0.0, scaled).to(torch.int64)
        else:
            if isinstance(src, T.DecimalType):
                shift = dst.scale - src.scale
                data = c.data * (10 ** shift) if shift >= 0 \
                    else _round_half_up_div(c.data, 10 ** (-shift))
            else:
                data = c.data.to(torch.int64) * (10 ** dst.scale)
            overflow = (data <= -bound) | (data >= bound)
        if ctx.ansi:
            ctx.add_error("CAST_OVERFLOW", overflow & valid)
        return ColumnVector(dst, torch.where(overflow, 0, data),
                            valid & ~overflow)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        src, dst = c.dtype, self.to
        valid = c.valid
        if src == dst:
            return c
        if isinstance(src, T.NullType):
            return _typed_cpu(c, dst)
        if isinstance(dst, T.StringType) or isinstance(src, T.StringType):
            from spark_rapids_tpu_torch.expr.strings import cast_string_cpu
            return cast_string_cpu(c, dst, ansi)
        with np.errstate(all="ignore"):
            if isinstance(src, T.BooleanType):
                return CpuCol(dst, c.values.astype(dst.np_dtype), valid)
            if isinstance(dst, T.BooleanType):
                return CpuCol(dst, c.values != 0, valid)
            if isinstance(dst, (T.Float32Type, T.Float64Type)):
                vals = c.values.astype(np.float64)
                if isinstance(src, T.DecimalType):
                    vals = vals / (10.0 ** src.scale)
                return CpuCol(dst, vals.astype(dst.np_dtype), valid)
            if isinstance(dst, T.DecimalType):
                if isinstance(src, T.DecimalType):
                    shift = dst.scale - src.scale
                    vals = c.values * (10 ** shift) if shift >= 0 \
                        else _round_half_up_div_np(c.values, 10 ** (-shift))
                elif src.is_integral:
                    vals = c.values.astype(np.int64) * (10 ** dst.scale)
                else:
                    scaled = np.round(c.values.astype(np.float64)
                                      * (10.0 ** dst.scale))
                    big = ~(np.abs(scaled) < 10 ** min(dst.precision, 18))
                    vals = np.where(big, 0.0, scaled).astype(np.int64)
                bound = 10 ** min(dst.precision, 18)
                overflow = (vals <= -bound) | (vals >= bound)
                if not (isinstance(src, T.DecimalType) or src.is_integral):
                    overflow = overflow | big
                if ansi and bool((overflow & valid).any()):
                    raise SparkException("[CAST_OVERFLOW]")
                return CpuCol(dst, np.where(overflow, 0, vals),
                              valid & ~overflow)
            if isinstance(src, T.DecimalType) and dst.is_integral:
                q = (np.abs(c.values) // (10 ** src.scale)) \
                    * np.sign(c.values)
                return CpuCol(dst, q.astype(dst.np_dtype), valid)
            if isinstance(src, (T.Float32Type, T.Float64Type)) \
                    and dst.is_integral:
                info = np.iinfo(dst.np_dtype)
                v = c.values.astype(np.float64)
                if ansi and bool(((np.isnan(v) | (v < info.min)
                                   | (v > info.max)) & valid).any()):
                    raise SparkException("[CAST_OVERFLOW]")
                return CpuCol(dst, _float_to_int_np(v, dst.np_dtype),
                              valid)
            data = c.values.astype(np.int64)
            if isinstance(src, T.TimestampType) \
                    and isinstance(dst, T.DateType):
                return CpuCol(dst, np.floor_divide(
                    data, _MICROS_PER_DAY).astype(np.int32), valid)
            if isinstance(src, T.DateType) \
                    and isinstance(dst, T.TimestampType):
                return CpuCol(dst, data * _MICROS_PER_DAY, valid)
            if isinstance(src, T.TimestampType) and dst.is_integral:
                data = np.floor_divide(data, 1_000_000)
            if isinstance(dst, T.TimestampType) and src.is_integral:
                return CpuCol(dst, data * 1_000_000, valid)
            if ansi and dst.is_integral:
                info = np.iinfo(dst.np_dtype)
                if bool((((data < info.min) | (data > info.max))
                         & valid).any()):
                    raise SparkException("[CAST_OVERFLOW]")
            return CpuCol(dst, data.astype(dst.np_dtype), valid)


_MICROS_PER_DAY = 86_400_000_000


def _round_half_up_div(v: torch.Tensor, d: int) -> torch.Tensor:
    """A decimal scale-down by d, rounding HALF_UP (away from zero at .5),
    Spark's decimal rounding."""
    return torch.sign(v) * torch.div(v.abs() + d // 2, d,
                                      rounding_mode="floor")


def _round_half_up_div_np(v: np.ndarray, d: int) -> np.ndarray:
    return np.sign(v) * ((np.abs(v) + d // 2) // d)
