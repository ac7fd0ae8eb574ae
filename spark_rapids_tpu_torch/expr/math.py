"""Math expressions (counterpart of ``spark_rapids_tpu/expr/math.py``):
``Greatest`` and ``Least``, and the bitwise and shift family
(``BitwiseAnd``/``Or``/``Xor``, ``BitwiseNot``, ``ShiftLeft``,
``ShiftRight``, ``ShiftRightUnsigned``) so far; the rest of the module is
ROADMAP A9. Each class also evaluates on the CPU backend (``eval_cpu``,
the JAX package's numpy arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, _valid_of


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
