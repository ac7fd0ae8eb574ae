"""Miscellaneous expressions (counterpart of
``spark_rapids_tpu/expr/misc.py``): ``Rand`` so far; the rest of the
module is ROADMAP A9.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, _partition_ctx

_M64 = (1 << 64) - 1


def _signed64(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 plane by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 planes: multiplication wraps in
    int64 as in uint64, and the right shifts are logical."""
    x = x + _signed64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _signed64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _signed64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


class Rand(Expression):
    """rand([seed]): uniform [0, 1) doubles, deterministic per (seed,
    partition, row position): splitmix64 of ``position + (partition id <<
    40) + seed``, whose top 53 bits scale into [0, 1). The position counts
    the partition's live rows, so it needs the partition context that a
    projection (or a filter over one partition) threads. The stream is the
    JAX package's, not Spark's XORShiftRandom; the CPU backend
    (``eval_cpu``) draws the same one over its input collected into
    partition 0."""

    reads_partition = True
    reads_row_base = True

    def __init__(self, seed: int = 0):
        self.children = []
        self.seed = int(seed)

    def data_type(self):
        return T.FLOAT64

    def _params(self):
        return str(self.seed)

    def with_children(self, children):
        return self

    def eval(self, ctx):
        pid = _partition_ctx(ctx, "rand()")
        idx = torch.cumsum(ctx.row_mask.to(torch.int64), 0) - 1
        x = idx + ctx.row_base + _signed64((pid << 40) + self.seed)
        top = _shr(splitmix64(x), 11)
        return ColumnVector(T.FLOAT64,
                            top.to(torch.float64) / float(1 << 53), None)

    def eval_cpu(self, cols, ansi=False):
        n = len(cols[0].values) if cols else 0
        m = np.uint64
        x = np.arange(n, dtype=np.uint64) + m(self.seed & _M64)
        with np.errstate(over="ignore"):
            x = x + m(0x9E3779B97F4A7C15)
            x = (x ^ (x >> m(30))) * m(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> m(27))) * m(0x94D049BB133111EB)
        x = x ^ (x >> m(31))
        return CpuCol(T.FLOAT64, (x >> m(11)).astype(np.float64)
                      / np.float64(1 << 53), np.ones(n, np.bool_))
