"""Miscellaneous expressions (counterpart of
``spark_rapids_tpu/expr/misc.py``): ``Rand`` and ``XxHash64`` so far; the
rest of the module is ROADMAP A9.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, _partition_ctx
from spark_rapids_tpu_torch.ops.kernels import shr64 as _shr
from spark_rapids_tpu_torch.ops.kernels import signed64 as _signed64

_M64 = (1 << 64) - 1


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


def cpu_batch(cols):
    """CPU backend columns as a batch on the CPU, named c0, c1, ..."""
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    from spark_rapids_tpu_torch.exec.cpu_backend import cols_to_table
    table = cols_to_table(cols, [f"c{i}" for i in range(len(cols))])
    return from_arrow(table, "cpu")


class XxHash64(Expression):
    """xxhash64(cols..., seed 42): Spark's chained xxhash64 over
    fixed-width columns. Types of at most 4 bytes go through
    XXH64.hashInt, 8-byte ones through hashLong, as Spark's
    XxHash64Function dispatches; each row's hash seeds the next column's,
    and a null field passes the running seed through. Floats hash their
    bits with -0.0 as 0.0 and one NaN. String and nested columns run on
    the CPU (the tag of ``plan/overrides.py``), where a string hashes its
    UTF-8 bytes with XXH64 as Spark does (``xxhash64_bytes``; the JAX
    package's CPU evaluation raises there, ROADMAP C5)."""

    def __init__(self, children):
        self.children = list(children)

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return XxHash64(children)

    def supported_on_tpu(self):
        return not any(isinstance(c.data_type(), (T.StringType, T.ArrayType))
                       for c in self.children)

    @staticmethod
    def _norm(col: ColumnVector):
        """(plane, is_int32) by Spark's per-type hash dispatch."""
        d = col.dtype
        if isinstance(d, (T.Float32Type, T.Float64Type)):
            v = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                            col.data)
            v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")),
                            v)
            if isinstance(d, T.Float32Type):
                return v.view(torch.int32), True
            return v.view(torch.int64), False
        if isinstance(d, (T.BooleanType, T.Int8Type, T.Int16Type,
                          T.Int32Type, T.DateType)):
            return col.data.to(torch.int32), True
        return col.data.to(torch.int64), False

    @classmethod
    def hash_columns(cls, cols, num_rows, live) -> torch.Tensor:
        from spark_rapids_tpu_torch.ops import kernels as K
        h = torch.full((cols[0].capacity,), 42, dtype=torch.int64,
                       device=cols[0].device)
        for c in cols:
            v, is32 = cls._norm(c)
            valid = c.validity_or_default(num_rows) & live
            h2 = K.xxhash64_int32(v, h) if is32 else K.xxhash64_int64(v, h)
            h = torch.where(valid, h2, h)
        return h

    def eval(self, ctx):
        cols = [c.eval(ctx) for c in self.children]
        return ColumnVector(T.INT64, self.hash_columns(
            cols, ctx.num_rows, ctx.row_mask), None)

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values) if ins else 0
        h = np.full(n, 42, np.int64)
        for c in ins:
            if isinstance(c.dtype, T.StringType):
                h2 = np.array([xxhash64_bytes(str(v).encode(), int(s))
                               if ok else s
                               for v, s, ok in zip(c.values, h, c.valid)],
                              np.int64).reshape(n)
            else:
                batch = cpu_batch([c])
                v, is32 = self._norm(batch.columns[0])
                seed = torch.from_numpy(h.copy())
                pad = batch.capacity - n
                if pad:
                    seed = torch.cat([seed, torch.zeros(pad,
                                                        dtype=torch.int64)])
                from spark_rapids_tpu_torch.ops import kernels as K
                h2 = (K.xxhash64_int32(v, seed) if is32
                      else K.xxhash64_int64(v, seed))[:n].numpy()
            h = np.where(c.valid, h2, h)
        return CpuCol(T.INT64, h, np.ones(n, np.bool_))


def xxhash64_bytes(data: bytes, seed: int) -> int:
    """XXH64 of a byte string (Spark's XXH64.hashUnsafeBytes over a
    string's UTF-8 bytes), as the int64 that holds the hash."""
    m = _M64
    p1, p2, p3, p4, p5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                          0x27D4EB2F165667C5)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    def word(i, width):
        return int.from_bytes(data[i:i + width], "little")

    seed &= m
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed, (seed - p1) & m]
        while i <= n - 32:
            v = [rnd(v[j], word(i + 8 * j, 8)) for j in range(4)]
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & m
        for lane in v:
            h = ((h ^ rnd(0, lane)) * p1 + p4) & m
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, word(i, 8)), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (word(i, 4) * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h = (h ^ (h >> 33)) * p2 & m
    h = (h ^ (h >> 29)) * p3 & m
    return _signed64(h ^ (h >> 32))
