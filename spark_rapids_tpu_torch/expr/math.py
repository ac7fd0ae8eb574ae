"""Math expressions (counterpart of ``spark_rapids_tpu/expr/math.py``):
``Greatest`` and ``Least``, the bitwise and shift family, the unary
double functions (``Sqrt``, ``Exp``, the logs, the trigonometric and
hyperbolic functions, ``Signum``, ``Cbrt``, ``Cot``/``Sec``/``Csc``,
``ToDegrees``/``ToRadians``, ``Expm1``, ``Log1p``, ``Rint``), ``Ceil``,
``Floor``, ``Round``, ``BRound``, ``Pow``, ``Atan2``, ``Hypot``,
``Logarithm``, ``Factorial``, ``Pmod``, ``UnaryPositive``,
``WidthBucket``, ``NaNvl``, ``BitwiseCount``, ``BitwiseGet`` and
``Murmur3Hash`` (``hash``). The device code follows the
JAX package's XLA arithmetic step for step (so rounding and halfway cases
agree bit for bit); each class also evaluates on the CPU backend
(``eval_cpu``, the JAX package's numpy arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import (
    CpuCol, Expression, _float_to_int_np, _valid_of,
)


class Greatest(Expression):
    """greatest(...): the largest non-null value per row, in the children's
    common type; null only when every child is null. A NaN never replaces
    a value already taken (the comparison is false), as in the JAX
    package."""

    largest = True

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self):
        dt = self.children[0].data_type()
        for c in self.children[1:]:
            dt = T.common_type(dt, c.data_type())
        return dt

    def with_children(self, children):
        return type(self)(*children)

    def eval(self, ctx):
        out = self.data_type()
        acc = acc_valid = None
        for child in self.children:
            c = child.eval(ctx)
            v = c.data.to(out.torch_dtype)
            cv = _valid_of(c, ctx)
            if acc is None:
                acc, acc_valid = v, cv
                continue
            better = v > acc if self.largest else v < acc
            pick_new = cv & (~acc_valid | better)
            acc = torch.where(pick_new, v, acc)
            acc_valid = acc_valid | cv
        return ColumnVector(out, acc, acc_valid)

    def eval_cpu(self, cols, ansi=False):
        out = self.data_type()
        acc = acc_valid = None
        with np.errstate(all="ignore"):
            for child in self.children:
                c = child.eval_cpu(cols, ansi)
                v = c.values.astype(out.np_dtype)
                if acc is None:
                    acc, acc_valid = v.copy(), c.valid.copy()
                    continue
                better = v > acc if self.largest else v < acc
                pick_new = c.valid & (~acc_valid | better)
                acc = np.where(pick_new, v, acc)
                acc_valid = acc_valid | c.valid
        return CpuCol(out, acc, acc_valid)


class Least(Greatest):
    """least(...): the smallest non-null value per row."""

    largest = False


class _Bitwise(Expression):
    """Bitwise and/or/xor over integral types, in the children's common
    type."""

    op = "and"

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.common_type(self.children[0].data_type(),
                             self.children[1].data_type())

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        left = self.children[0].eval(ctx)
        right = self.children[1].eval(ctx)
        dt = self.data_type()
        a = left.data.to(dt.torch_dtype)
        b = right.data.to(dt.torch_dtype)
        out = {"and": torch.bitwise_and, "or": torch.bitwise_or,
               "xor": torch.bitwise_xor}[self.op](a, b)
        return ColumnVector(dt, out, _valid_of(left, ctx)
                            & _valid_of(right, ctx))

    def eval_cpu(self, cols, ansi=False):
        left = self.children[0].eval_cpu(cols, ansi)
        right = self.children[1].eval_cpu(cols, ansi)
        dt = self.data_type()
        out = {"and": np.bitwise_and, "or": np.bitwise_or,
               "xor": np.bitwise_xor}[self.op](
            left.values.astype(dt.np_dtype), right.values.astype(dt.np_dtype))
        return CpuCol(dt, out, left.valid & right.valid)


class BitwiseAnd(_Bitwise):
    op = "and"


class BitwiseOr(_Bitwise):
    op = "or"


class BitwiseXor(_Bitwise):
    op = "xor"


class BitwiseNot(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return BitwiseNot(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return ColumnVector(c.dtype, torch.bitwise_not(c.data),
                            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(c.dtype, ~c.values, c.valid)


class _Shift(Expression):
    """shiftleft/shiftright/shiftrightunsigned with Java's semantics: the
    distance is cast to the value's type, then wraps as ``n mod width``
    (floor modulo, so -1 shifts an int by 31) before the shift, so no
    shift reaches the width."""

    left = True
    arithmetic = True

    def __init__(self, value, amount):
        self.children = [value, amount]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def _shift(self, v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        width = v.element_size() * 8
        n = torch.remainder(n.to(v.dtype), width)
        if self.left:
            return v << n
        if self.arithmetic:
            return v >> n
        # logical: an arithmetic shift, then the sign copies masked off
        # (torch has no >> for unsigned types on the CPU)
        if width < 64:
            u = v.to(torch.int64) & ((1 << width) - 1)
            return (u >> n.to(torch.int64)).to(v.dtype)
        # the mask's shift stays below 64 (n == 0 keeps v as it is)
        keep = torch.bitwise_not(torch.full_like(v, -1)
                                 << (64 - n.clamp(min=1)))
        return torch.where(n == 0, v, (v >> n) & keep)

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        n = self.children[1].eval(ctx)
        return ColumnVector(v.dtype, self._shift(v.data, n.data),
                            _valid_of(v, ctx) & _valid_of(n, ctx))

    def eval_cpu(self, cols, ansi=False):
        v = self.children[0].eval_cpu(cols, ansi)
        n = self.children[1].eval_cpu(cols, ansi)
        vals = v.values
        width = vals.dtype.itemsize * 8
        k = n.values.astype(vals.dtype) % width
        if self.left:
            out = vals << k
        elif self.arithmetic:
            out = vals >> k
        else:
            # logical: through the unsigned view
            udt = np.dtype(f"uint{width}")
            out = (vals.astype(udt) >> k.astype(udt)).astype(vals.dtype)
        return CpuCol(v.dtype, out, v.valid & n.valid)


class ShiftLeft(_Shift):
    left = True


class ShiftRight(_Shift):
    left = False
    arithmetic = True


class ShiftRightUnsigned(_Shift):
    left = False
    arithmetic = False


class Murmur3Hash(Expression):
    """hash(...): Spark's Murmur3 (seed 42) over any number of columns,
    chained per row (``ops/kernels.spark_murmur3_batch``); an int32-family
    column hashes through the murmur3 kernel on the card, with the
    running per-row seed after the first column."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return Murmur3Hash(*children)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.ops import kernels as K
        cols = [c.eval(ctx) for c in self.children]
        h = K.spark_murmur3_batch(cols, ctx.num_rows, live=ctx.row_mask)
        return ColumnVector(T.INT32, h, None)

    def eval_cpu(self, cols, ansi=False):
        # the CPU backend's columns as a batch on the CPU: the same code,
        # on the kernel's plain version
        from spark_rapids_tpu_torch.expr.misc import cpu_batch
        from spark_rapids_tpu_torch.ops import kernels as K
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        if n == 0:
            return CpuCol(T.INT32, np.zeros(0, np.int32), np.ones(0, bool))
        batch = cpu_batch(ins)
        h = K.spark_murmur3_batch(batch.columns, n)
        return CpuCol(T.INT32, h[:n].numpy().copy(), np.ones(n, np.bool_))


# ---------------------------------------------------------------------------
# Unary double functions
# ---------------------------------------------------------------------------

def _f64(c: ColumnVector) -> torch.Tensor:
    """The values as doubles; a decimal reads unscaled / 10^scale."""
    v = c.data.to(torch.float64)
    if isinstance(c.dtype, T.DecimalType) and c.dtype.scale:
        v = v / (10.0 ** c.dtype.scale)
    return v


def _f64_np(c: CpuCol) -> np.ndarray:
    v = c.values.astype(np.float64)
    if isinstance(c.dtype, T.DecimalType) and c.dtype.scale:
        v = v / (10.0 ** c.dtype.scale)
    return v


def _dec_round_type(dt: T.DecimalType, d: int) -> T.DecimalType:
    """Spark's type of round(x, d) / bround(x, d) for x of ``dt`` (capped
    at DECIMAL64's 18 digits)."""
    p, s = dt.precision, dt.scale
    cap = T.DecimalType.MAX_INT64_PRECISION
    if d >= 0:
        return T.DecimalType(min(p - s + 1 + min(s, d), cap), min(s, d))
    return T.DecimalType(min(max(p - s + 1, 1 - d), cap), 0)


def _dec_round(v, dt: T.DecimalType, d: int, half_even: bool, floordiv):
    """The unscaled values of a decimal rounded to d places (HALF_UP, or
    HALF_EVEN), at the result type's scale: integer arithmetic on the
    unscaled values, for torch and numpy planes alike."""
    if d >= dt.scale:
        return v
    q = 10 ** (dt.scale - d)
    if half_even:
        base = floordiv(v, q)
        rem = v - base * q
        up = (rem > q // 2) | ((rem == q // 2) & (base % 2 != 0))
        r = base + up * 1
    else:
        mag = floordiv(abs(v) + q // 2, q)
        r = (mag * ((v > 0) * 1 - (v < 0) * 1))
    return r * (10 ** (-d)) if d < 0 else r


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    # torch's vectorized CPU sqrt can be an ulp off; CUDA's is exact
    if v.device.type == "cpu":
        from spark_rapids_tpu_torch.expr.aggregates import _sqrt_rn
        return _sqrt_rn(v)
    return torch.sqrt(v)


class _UnaryDouble(Expression):
    """A double function of one argument, null-propagating. ``domain``
    marks the inputs the function is defined on; the others are null
    (Spark's log of a non-positive value). ``fn`` runs on the device's
    float64 plane, ``fn_cpu`` on numpy's (the JAX package's CPU
    backend)."""

    fn = None
    fn_cpu = None
    domain = None

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.FLOAT64

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = _f64(c)
        valid = _valid_of(c, ctx)
        if type(self).domain is not None:
            ok = type(self).domain(v)
            valid = valid & ok
            v = torch.where(ok, v, 1.0)
        return ColumnVector(T.FLOAT64, type(self).fn(v), valid)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        v = _f64_np(c)
        valid = c.valid
        with np.errstate(all="ignore"):
            if type(self).domain is not None:
                ok = type(self).domain(v)
                valid = valid & ok
                v = np.where(ok, v, 1.0)
            return CpuCol(T.FLOAT64, type(self).fn_cpu(v), valid)


def _sign(v: torch.Tensor) -> torch.Tensor:
    """numpy's sign: NaN and -0.0 stay as they are (torch.sign makes both
    +0.0)."""
    return torch.where((v == 0) | torch.isnan(v), v, torch.sign(v))


def _positive(v):
    return v > 0


def _unary(name, fn, fn_cpu, domain=None, doc=None):
    cls = type(name, (_UnaryDouble,),
               {"fn": staticmethod(fn), "fn_cpu": staticmethod(fn_cpu),
                "domain": staticmethod(domain) if domain else None,
                "__doc__": doc or f"{name.lower()}(x) as a double."})
    cls.__module__ = __name__
    return cls


Sqrt = _unary("Sqrt", _sqrt, np.sqrt)
Exp = _unary("Exp", torch.exp, np.exp)
Log = _unary("Log", torch.log, np.log, _positive,
             "ln(x); null where x <= 0.")
Log10 = _unary("Log10", torch.log10, np.log10, _positive,
               "log10(x); null where x <= 0.")
Log2 = _unary("Log2", torch.log2, np.log2, _positive,
              "log2(x); null where x <= 0.")
Acosh = _unary("Acosh", torch.acosh, np.arccosh, doc=(
    "acosh(x): inputs outside the domain give NaN, as Spark's formula "
    "does, not null."))
Asinh = _unary("Asinh", torch.asinh, np.arcsinh)
Atanh = _unary("Atanh", torch.atanh, np.arctanh)
Sin = _unary("Sin", torch.sin, np.sin)
Cos = _unary("Cos", torch.cos, np.cos)
Tan = _unary("Tan", torch.tan, np.tan)
Asin = _unary("Asin", torch.asin, np.arcsin)
Acos = _unary("Acos", torch.acos, np.arccos)
Atan = _unary("Atan", torch.atan, np.arctan)
Sinh = _unary("Sinh", torch.sinh, np.sinh)
Cosh = _unary("Cosh", torch.cosh, np.cosh)
Tanh = _unary("Tanh", torch.tanh, np.tanh)
Signum = _unary("Signum", _sign, np.sign)


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    """torch has no cbrt: |v|^(1/3), then one Newton step, which takes
    the power's error (1/3 is not a double) back to an ulp."""
    a = v.abs()
    y = a.pow(1.0 / 3.0)
    step = y - (y * y * y - a) / (3.0 * y * y)
    y = torch.where((y > 0) & torch.isfinite(y), step, y)
    return torch.copysign(y, v)


Cbrt = _unary("Cbrt", _cbrt, np.cbrt)
Cot = _unary("Cot", lambda v: 1.0 / torch.tan(v), lambda v: 1.0 / np.tan(v))
Sec = _unary("Sec", lambda v: 1.0 / torch.cos(v), lambda v: 1.0 / np.cos(v))
Csc = _unary("Csc", lambda v: 1.0 / torch.sin(v), lambda v: 1.0 / np.sin(v))
ToDegrees = _unary("ToDegrees", torch.rad2deg, np.degrees)
ToRadians = _unary("ToRadians", torch.deg2rad, np.radians)
Expm1 = _unary("Expm1", torch.expm1, np.expm1)
Log1p = _unary("Log1p", torch.log1p, np.log1p, lambda v: v > -1,
               "ln(1 + x); null where x <= -1.")
Rint = _unary("Rint", torch.round, np.rint,
              doc="rint(x): the nearest integer, ties to even.")


# ---------------------------------------------------------------------------
# Rounding to integers
# ---------------------------------------------------------------------------

def _double_to_long_np(v):
    """Scala's Double.toLong on the CPU: NaN to 0, saturated at the long
    range (``core._float_to_int_np``)."""
    return _float_to_int_np(v, np.int64)


class _ToLong(Expression):
    """ceil/floor: a long, through Scala's Double.toLong (NaN to 0,
    saturated at the long range: ``core._to_int``). Over ``decimal(p, s)``
    Spark's answer: integer arithmetic on the unscaled values, typed
    ``decimal(p - s + 1, 0)``."""

    fn = None
    fn_cpu = None
    #: floor (False) or ceil (True) of a decimal
    up = False

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(min(dt.precision - dt.scale + 1,
                                     T.DecimalType.MAX_INT64_PRECISION), 0)
        return T.INT64

    def with_children(self, children):
        return type(self)(children[0])

    def _dec(self, v, dt, floordiv):
        q = 10 ** dt.scale
        return -floordiv(-v, q) if self.up else floordiv(v, q)

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.core import _to_int
        c = self.children[0].eval(ctx)
        if isinstance(c.dtype, T.DecimalType):
            return ColumnVector(self.data_type(),
                                self._dec(c.data, c.dtype, _floor_div),
                                _valid_of(c, ctx))
        return ColumnVector(T.INT64,
                            _to_int(type(self).fn(_f64(c)), torch.int64),
                            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        if isinstance(c.dtype, T.DecimalType):
            return CpuCol(self.data_type(),
                          self._dec(c.values.astype(np.int64), c.dtype,
                                    np.floor_divide), c.valid)
        with np.errstate(all="ignore"):
            v = type(self).fn_cpu(c.values.astype(np.float64))
            return CpuCol(T.INT64, _double_to_long_np(v), c.valid)


class Ceil(_ToLong):
    fn = staticmethod(torch.ceil)
    fn_cpu = staticmethod(np.ceil)
    up = True


class Floor(_ToLong):
    fn = staticmethod(torch.floor)
    fn_cpu = staticmethod(np.floor)


def _floor_div(a: torch.Tensor, q: int) -> torch.Tensor:
    return torch.div(a, q, rounding_mode="floor")


class Round(Expression):
    """round(x, d), HALF_UP (away from zero) on every type, as Spark's
    BigDecimal rounding. A float rescales by multiplying with 10^-d (not
    dividing), as the JAX package does, so both engines agree bit for bit
    (within an ulp of Spark's BigDecimal rounding); like the JAX package's
    result, it is a double for a float input too. A decimal rounds its
    unscaled value (``_dec_round``) into Spark's result type."""

    half_even = False

    def __init__(self, child, scale: int = 0):
        self.children = [child]
        self.scale = scale

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, T.DecimalType):
            return _dec_round_type(dt, self.scale)
        return dt if dt.is_integral else T.FLOAT64

    def _params(self):
        return str(self.scale)

    def with_children(self, children):
        return Round(children[0], self.scale)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        valid = _valid_of(c, ctx)
        dt = self.data_type()
        if isinstance(c.dtype, T.DecimalType):
            return ColumnVector(dt, _dec_round(c.data, c.dtype, self.scale,
                                               self.half_even, _floor_div),
                                valid)
        if dt.is_integral:
            if self.scale >= 0:
                return c
            f = 10 ** (-self.scale)
            v = c.data.to(torch.int64)
            out = torch.sign(v) * (_floor_div(v.abs() + f // 2, f) * f)
            return ColumnVector(dt, out.to(dt.torch_dtype), valid)
        scaled = _f64(c) * (10.0 ** self.scale)
        r = _sign(scaled) * torch.floor(scaled.abs() + 0.5)
        return ColumnVector(dt, (r * 10.0 ** (-self.scale))
                            .to(dt.torch_dtype), valid)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        dt = self.data_type()
        if isinstance(c.dtype, T.DecimalType):
            return CpuCol(dt, _dec_round(c.values.astype(np.int64), c.dtype,
                                         self.scale, self.half_even,
                                         np.floor_divide), c.valid)
        with np.errstate(all="ignore"):
            if dt.is_integral:
                if self.scale >= 0:
                    return c
                f = 10 ** (-self.scale)
                sign = np.sign(c.values)
                mag = np.abs(c.values.astype(np.int64))
                v = sign * (((mag + f // 2) // f) * f)
                return CpuCol(dt, v.astype(dt.np_dtype), c.valid)
            scaled = c.values.astype(np.float64) * (10.0 ** self.scale)
            r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
            return CpuCol(dt, (r * 10.0 ** (-self.scale))
                          .astype(dt.np_dtype), c.valid)


class BRound(Expression):
    """bround(x, d): HALF_EVEN rounding (Spark's Round is HALF_UP); a
    decimal as in ``Round``."""

    half_even = True

    def __init__(self, child, scale: int = 0):
        self.children = [child]
        self.scale = int(scale)

    def _params(self):
        return str(self.scale)

    def with_children(self, children):
        return BRound(children[0], self.scale)

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, T.DecimalType):
            return _dec_round_type(dt, self.scale)
        return dt if not isinstance(dt, T.Float32Type) else T.FLOAT32

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        dt = self.data_type()
        valid = _valid_of(c, ctx)
        if isinstance(c.dtype, T.DecimalType):
            return ColumnVector(dt, _dec_round(c.data, c.dtype, self.scale,
                                               True, _floor_div), valid)
        if dt.is_integral:
            if self.scale >= 0:
                return ColumnVector(dt, c.data, valid)
            q = 10 ** (-self.scale)
            v = c.data.to(torch.int64)
            base = _floor_div(v, q)
            rem = v - base * q
            up = (rem > q // 2) | ((rem == q // 2) & (base % 2 != 0))
            return ColumnVector(dt, ((base + up.to(torch.int64)) * q)
                                .to(dt.torch_dtype), valid)
        p = 10.0 ** self.scale
        # torch.round ties to even; XLA turns the JAX package's division
        # by the constant into a multiply by its reciprocal, and so does
        # this
        out = torch.round(_f64(c) * p) * (1.0 / p)
        return ColumnVector(dt, out.to(dt.torch_dtype), valid)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        dt = self.data_type()
        if isinstance(c.dtype, T.DecimalType):
            return CpuCol(dt, _dec_round(c.values.astype(np.int64), c.dtype,
                                         self.scale, True, np.floor_divide),
                          c.valid)
        if dt.is_integral:
            if self.scale >= 0:
                return CpuCol(dt, c.values, c.valid)
            q = 10 ** (-self.scale)
            v = c.values.astype(np.int64)
            base = np.floor_divide(v, q)
            rem = v - base * q
            up = (rem > q // 2) | ((rem == q // 2) & (base % 2 != 0))
            return CpuCol(dt, ((base + up) * q).astype(dt.np_dtype), c.valid)
        p = 10.0 ** self.scale
        out = np.round(c.values.astype(np.float64) * p) / p
        return CpuCol(dt, out.astype(dt.np_dtype), c.valid)


# ---------------------------------------------------------------------------
# Binary and n-ary functions
# ---------------------------------------------------------------------------

class _BinaryDouble(Expression):
    """A double function of two arguments, null when either is null."""

    fn = None
    fn_cpu = None

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.FLOAT64

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        l, r = (c.eval(ctx) for c in self.children)
        return ColumnVector(T.FLOAT64, type(self).fn(_f64(l), _f64(r)),
                            _valid_of(l, ctx) & _valid_of(r, ctx))

    def eval_cpu(self, cols, ansi=False):
        l, r = (c.eval_cpu(cols, ansi) for c in self.children)
        with np.errstate(all="ignore"):
            v = type(self).fn_cpu(_f64_np(l), _f64_np(r))
        return CpuCol(T.FLOAT64, v, l.valid & r.valid)


class Pow(_BinaryDouble):
    fn = staticmethod(torch.pow)
    fn_cpu = staticmethod(np.power)


class Atan2(_BinaryDouble):
    fn = staticmethod(torch.atan2)
    fn_cpu = staticmethod(np.arctan2)


class Hypot(_BinaryDouble):
    fn = staticmethod(torch.hypot)
    fn_cpu = staticmethod(np.hypot)


class Logarithm(Expression):
    """log(base, x) = ln(x) / ln(base), null when either is not positive
    (non-ANSI strictness; base 1 keeps the division's Inf/NaN)."""

    def __init__(self, base, child):
        self.children = [base, child]

    def data_type(self):
        return T.FLOAT64

    def with_children(self, children):
        return Logarithm(children[0], children[1])

    def eval(self, ctx):
        b, c = (x.eval(ctx) for x in self.children)
        bv, cv = _f64(b), _f64(c)
        ok = (bv > 0) & (cv > 0)
        v = torch.log(torch.where(ok, cv, 1.0)) \
            / torch.log(torch.where(ok, bv, 2.0))
        return ColumnVector(T.FLOAT64, v,
                            _valid_of(b, ctx) & _valid_of(c, ctx) & ok)

    def eval_cpu(self, cols, ansi=False):
        b, c = (x.eval_cpu(cols, ansi) for x in self.children)
        bv, cv = _f64_np(b), _f64_np(c)
        ok = (bv > 0) & (cv > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.log(np.where(ok, cv, 1.0)) / np.log(np.where(ok, bv, 2.0))
        return CpuCol(T.FLOAT64, v, b.valid & c.valid & ok)


#: 0! .. 20! fit a long; Spark's factorial is null outside [0, 20]
_FACTORIALS = np.cumprod([1] + list(range(1, 21)), dtype=np.int64)


class Factorial(Expression):
    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return Factorial(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.data.to(torch.int64)  # range-checked before any narrowing
        ok = (v >= 0) & (v <= 20)
        table = torch.tensor(_FACTORIALS, device=v.device)
        return ColumnVector(T.INT64, table[v.clamp(0, 20)],
                            _valid_of(c, ctx) & ok)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        v = c.values.astype(np.int64)
        ok = (v >= 0) & (v <= 20)
        return CpuCol(T.INT64, _FACTORIALS[np.clip(v, 0, 20)], c.valid & ok)


class Pmod(Expression):
    """pmod(a, b): Java's ``%`` (the sign of the dividend), then one
    conditional fold, ``r < 0 ? (r + b) % b : r``, in the operands' common
    type (Remainder's promotion: decimals rescale their unscaled values);
    b == 0 is null outside ANSI. Integer ``%`` goes through
    ``core._java_int_div``, so MIN_VALUE % -1 is 0 and does not trap."""

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.common_type(self.children[0].data_type(),
                             self.children[1].data_type())

    def with_children(self, children):
        return Pmod(children[0], children[1])

    def eval(self, ctx):
        from spark_rapids_tpu_torch.expr.core import _java_int_div, _promote
        l, r = (c.eval(ctx) for c in self.children)
        out = self.data_type()
        ld, rd = _promote(l, r, out)
        valid = _valid_of(l, ctx) & _valid_of(r, ctx)
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        if out.is_integral or isinstance(out, T.DecimalType):
            def rem_of(a):
                return a - _java_int_div(a, safe) * safe
            null_value = 0
        else:
            def rem_of(a):
                return torch.fmod(a, safe)
            null_value = float("nan")
        rem = rem_of(ld)
        rem = torch.where(rem < 0, rem_of(rem + safe), rem)
        return ColumnVector(out, torch.where(zero, null_value, rem),
                            valid & ~zero)

    def eval_cpu(self, cols, ansi=False):
        from spark_rapids_tpu_torch.expr.core import _promote_cpu
        l, r = (c.eval_cpu(cols, ansi) for c in self.children)
        out = self.data_type()
        ld, rd = _promote_cpu(l, r, out)
        with np.errstate(all="ignore"):
            zero = rd == 0
            safe = np.where(zero, 1, rd)
            rem = np.fmod(ld, safe)
            rem = np.where(rem < 0, np.fmod(rem + safe, safe), rem)
            rem = np.where(zero, 0, rem)
        return CpuCol(out, rem, l.valid & r.valid & ~zero)


class UnaryPositive(Expression):
    """+x: the identity."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.children[0].data_type()

    def with_children(self, children):
        return UnaryPositive(children[0])

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        return self.children[0].eval_cpu(cols, ansi)


class WidthBucket(Expression):
    """width_bucket(v, lo, hi, n): the 1-based equi-width bucket, 0 below
    the range and n + 1 above it (reversed for lo > hi); null for n <= 0,
    lo == hi or a non-finite v, lo or hi."""

    def __init__(self, value, lo, hi, nb):
        self.children = [value, lo, hi, nb]

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return WidthBucket(*children)

    def eval(self, ctx):
        cs = [c.eval(ctx) for c in self.children]
        v, lo, hi, nb = (_f64(c) for c in cs)
        ok = (nb > 0) & (lo != hi) & torch.isfinite(v) & torch.isfinite(lo) \
            & torch.isfinite(hi)
        span = torch.where(ok, hi - lo, 1.0)
        raw = torch.floor((v - lo) / span * nb) + 1
        raw = torch.minimum(torch.maximum(raw, torch.zeros_like(raw)),
                            nb + 1)
        valid = ok
        for c in cs:
            valid = valid & _valid_of(c, ctx)
        from spark_rapids_tpu_torch.expr.core import _to_int
        return ColumnVector(T.INT64, _to_int(raw, torch.int64), valid)

    def eval_cpu(self, cols, ansi=False):
        cs = [c.eval_cpu(cols, ansi) for c in self.children]
        v, lo, hi, nb = (_f64_np(c) for c in cs)
        with np.errstate(all="ignore"):
            ok = (nb > 0) & (lo != hi) & np.isfinite(v) & np.isfinite(lo) \
                & np.isfinite(hi)
            span = np.where(ok, hi - lo, 1.0)
            raw = np.clip(np.floor((v - lo) / span * nb) + 1, 0, nb + 1)
        valid = ok
        for c in cs:
            valid = valid & c.valid
        return CpuCol(T.INT64, raw.astype(np.int64), valid)


class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN."""

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.FLOAT64

    def with_children(self, children):
        return NaNvl(children[0], children[1])

    def eval(self, ctx):
        l, r = (c.eval(ctx) for c in self.children)
        lv = _f64(l)
        nan = torch.isnan(lv)
        return ColumnVector(T.FLOAT64, torch.where(nan, _f64(r), lv),
                            torch.where(nan, _valid_of(r, ctx),
                                        _valid_of(l, ctx)))

    def eval_cpu(self, cols, ansi=False):
        l, r = (c.eval_cpu(cols, ansi) for c in self.children)
        lv = l.values.astype(np.float64)
        nan = np.isnan(lv)
        return CpuCol(T.FLOAT64, np.where(nan, r.values.astype(np.float64),
                                          lv), np.where(nan, r.valid, l.valid))


# ---------------------------------------------------------------------------
# Bits
# ---------------------------------------------------------------------------

def _popcount64(u: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (SWAR). The masks clear what an arithmetic
    shift copies of the sign, so the signed shifts count as logical
    ones."""
    u = u - ((u >> 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + ((u >> 2) & 0x3333333333333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F0F0F0F0F
    return ((u * 0x0101010101010101) >> 56) & 0x7F


class BitwiseCount(Expression):
    """bit_count(x): the set bits of x's two's complement in its own
    width (a boolean counts 0 or 1); an int."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return BitwiseCount(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if isinstance(c.dtype, T.BooleanType):
            out = c.data.to(torch.int32)
        else:
            u = c.data.to(torch.int64)
            nbits = c.data.element_size() * 8
            if nbits < 64:
                u = u & ((1 << nbits) - 1)
            out = _popcount64(u).to(torch.int32)
        return ColumnVector(T.INT32, out, _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        if isinstance(c.dtype, T.BooleanType):
            out = c.values.astype(np.int32)
        else:
            nbits = np.dtype(c.dtype.np_dtype).itemsize * 8
            u = c.values.astype(np.int64).astype(np.uint64)
            if nbits < 64:
                u = u & np.uint64((1 << nbits) - 1)
            out = np.array([bin(int(x)).count("1") for x in u], np.int32)
        return CpuCol(T.INT32, out, c.valid)


class BitwiseGet(Expression):
    """getbit(x, pos): the bit at pos (0 = the lowest) as a byte; a
    position outside x's width is null, or an error under ANSI."""

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.INT8

    def with_children(self, children):
        return BitwiseGet(children[0], children[1])

    def eval(self, ctx):
        c, p = (x.eval(ctx) for x in self.children)
        nbits = c.data.element_size() * 8
        pos = p.data.to(torch.int64)
        in_range = (pos >= 0) & (pos < nbits)
        if ctx.ansi:
            ctx.add_error("BitPosOutOfRange", _valid_of(p, ctx) & ~in_range)
        out = ((c.data.to(torch.int64) >> pos.clamp(0, nbits - 1)) & 1) \
            .to(torch.int8)
        return ColumnVector(T.INT8, out,
                            _valid_of(c, ctx) & _valid_of(p, ctx) & in_range)

    def eval_cpu(self, cols, ansi=False):
        from spark_rapids_tpu_torch.expr.core import SparkException
        c, p = (x.eval_cpu(cols, ansi) for x in self.children)
        nbits = np.dtype(c.dtype.np_dtype).itemsize * 8
        pos = p.values.astype(np.int64)
        in_range = (pos >= 0) & (pos < nbits)
        if ansi and bool((p.valid & ~in_range).any()):
            raise SparkException("bit position out of range")
        out = ((c.values.astype(np.int64) >> np.clip(pos, 0, nbits - 1))
               & 1).astype(np.int8)
        return CpuCol(T.INT8, out, c.valid & p.valid & in_range)
