"""Math expressions (counterpart of ``spark_rapids_tpu/expr/math.py``):
``Greatest`` and ``Least`` so far; the rest of the module is ROADMAP A9.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import Expression, _valid_of


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


class Least(Greatest):
    """least(...): the smallest non-null value per row."""

    largest = False
