"""Miscellaneous expressions (counterpart of
``spark_rapids_tpu/expr/misc.py``; reference parity: GpuRandomExpressions,
GpuParseUrl (JNI ParseURI), RaiseError, HashFunctions' hive hash, jni
Hash): ``Rand``, ``XxHash64``, ``HiveHash`` and ``Crc32`` on the device;
``Sequence``, ``ParseUrl`` and ``RaiseError`` as CPU row functions
(``MISC_CPU_FUNCTIONS``).
"""
from __future__ import annotations

from typing import List
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import (
    CpuCol, EvalCtx, Expression, SparkException, _partition_ctx, _valid_of,
)
from spark_rapids_tpu_torch.expr.cpu_functions import CpuRowFunction
from spark_rapids_tpu_torch.expr.strings import _lift_unary
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
    UTF-8 bytes with XXH64 and a nested value chains its elements or
    fields, as Spark does (``xxhash64_bytes``, ``_xx_value``; the JAX
    package's CPU evaluation raises on both, ROADMAP C5)."""

    def __init__(self, children):
        self.children = list(children)

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return XxHash64(children)

    def supported_on_tpu(self):
        return not any(isinstance(c.data_type(), (T.StringType, T.ArrayType,
                                                  T.MapType, T.StructType))
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
            if isinstance(c.dtype, (T.ArrayType, T.StructType, T.MapType)):
                h2 = np.array([_xx_value(v, c.dtype, int(s)) if ok else s
                               for v, s, ok in zip(c.values, h, c.valid)],
                              np.int64).reshape(n)
            elif isinstance(c.dtype, T.StringType):
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


def _xx_value(v, dt: T.DataType, seed: int) -> int:
    """Spark's xxhash64 of one value of the CPU representation, seeded:
    a null keeps the seed, an array or map chains its elements (a map
    each key then its value), a struct its fields, in order."""
    import struct
    if v is None:
        return seed
    if isinstance(dt, T.ArrayType):
        for x in v:
            seed = _xx_value(x, dt.element, seed)
        return seed
    if isinstance(dt, T.MapType):
        for k, x in v:
            seed = _xx_value(x, dt.value, _xx_value(k, dt.key, seed))
        return seed
    if isinstance(dt, T.StructType):
        for f in dt.fields:
            seed = _xx_value(v.get(f.name), f.dtype, seed)
        return seed
    if isinstance(dt, T.StringType):
        return xxhash64_bytes(v.encode(), seed)
    if isinstance(dt, T.Float32Type):
        v = float("nan") if v != v else (0.0 if v == 0 else v)
        return xxhash64_bytes(struct.pack("<f", v), seed)
    if isinstance(dt, T.Float64Type):
        v = float("nan") if v != v else (0.0 if v == 0 else v)
        return xxhash64_bytes(struct.pack("<d", v), seed)
    from spark_rapids_tpu_torch.expr.complex import _np_scalar
    v = int(_np_scalar(v, dt))
    if isinstance(dt, (T.BooleanType, T.Int8Type, T.Int16Type,
                       T.Int32Type, T.DateType)):
        return xxhash64_bytes((v & 0xFFFFFFFF).to_bytes(4, "little"), seed)
    return xxhash64_bytes((v & _M64).to_bytes(8, "little"), seed)


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


class Sequence(CpuRowFunction):
    """sequence(start, stop[, step]) -> array<long>, on the host (the
    output's length depends on the data)."""

    name = "sequence"

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        self.result = T.ArrayType(T.INT64, contains_null=False)

    def row_fn(self, *vals):
        if len(vals) == 3:
            start, stop, step = int(vals[0]), int(vals[1]), int(vals[2])
        else:
            start, stop = int(vals[0]), int(vals[1])
            step = 1 if stop >= start else -1
        if step == 0:
            raise SparkException("sequence step must not be zero")
        if (stop - start) * step < 0:
            return []
        n = (stop - start) // step + 1
        if n > 10_000_000:
            raise SparkException("sequence too long")
        return list(range(start, start + n * step, step))

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values)
        out, ok = [], []
        for i in range(n):
            if all(c.valid[i] for c in ins):
                out.append(self.row_fn(*(c.values[i] for c in ins)))
                ok.append(True)
            else:
                out.append(None)
                ok.append(False)
        vals = np.empty(n, object)
        for i, r in enumerate(out):  # rows of one length stay lists
            vals[i] = r
        return CpuCol(self.result, vals, np.asarray(ok, np.bool_))


class ParseUrl(CpuRowFunction):
    """parse_url(url, part[, key]) (host tier; reference JNI ParseURI)."""

    name = "parse_url"
    result = T.STRING
    PARTS = ("HOST", "PATH", "QUERY", "REF", "PROTOCOL", "FILE",
             "AUTHORITY", "USERINFO")

    def __init__(self, *children, params=()):
        super().__init__(*children, params=params)
        part = (params[0] or "").upper()
        if part not in self.PARTS:
            raise SparkException(f"parse_url: unknown part {params[0]!r}")
        self.part = part
        self.key = params[1] if len(params) > 1 else None

    def row_fn(self, url):
        try:
            u = urlparse(url)
        except ValueError:
            return None
        if self.part == "HOST":
            return u.hostname
        if self.part == "PATH":
            return u.path or None if u.scheme else None
        if self.part == "QUERY":
            if self.key is not None:
                v = parse_qs(u.query).get(self.key)
                return v[0] if v else None
            return u.query or None
        if self.part == "REF":
            return u.fragment or None
        if self.part == "PROTOCOL":
            return u.scheme or None
        if self.part == "FILE":
            return (u.path + ("?" + u.query if u.query else "")) or None
        if self.part == "AUTHORITY":
            return u.netloc or None
        if u.username is None:  # USERINFO
            return None
        return u.username + (":" + u.password if u.password else "")


class RaiseError(CpuRowFunction):
    """raise_error(msg): fails the query when evaluated on any live row."""

    name = "raise_error"
    result = T.NULL

    def row_fn(self, msg):
        raise SparkException(str(msg))


MISC_CPU_FUNCTIONS = [Sequence, ParseUrl, RaiseError]


def _to_int32(h: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 plane as the int32 that holds them."""
    h = h & 0xFFFFFFFF
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


class HiveHash(Expression):
    """hive hash over columns (reference jni.Hash hiveHash): each column's
    Hive hashCode chained as h = 31 * h + column hash, wrapping like a
    Java int; a null field hashes to 0. Strings hash their UTF-8 bytes
    (Java String.hashCode over signed bytes) in one walk over the longest
    row, a dictionary column over its vocabulary. The arithmetic runs in
    int64 masked to 32 bits."""

    def __init__(self, children: List[Expression]):
        self.children = list(children)

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return HiveHash(children)

    def eval(self, ctx: EvalCtx) -> ColumnVector:
        h = torch.zeros(ctx.capacity, dtype=torch.int64, device=ctx.device)
        for c in self.children:
            col = c.eval(ctx)
            ch = torch.where(_valid_of(col, ctx), _hive_hash_col(col), 0)
            h = (h * 31 + ch) & 0xFFFFFFFF
        return ColumnVector(T.INT32, _to_int32(h), None)

    def eval_cpu(self, cols, ansi=False):
        n = len(cols[0].values) if cols else 0
        h = np.zeros(n, np.int32)
        for c in self.children:
            cc = c.eval_cpu(cols, ansi)
            ch = np.where(cc.valid, hive_hash_col_np(cc), 0).astype(np.int32)
            with np.errstate(over="ignore"):
                h = (h.astype(np.int64) * 31 + ch).astype(np.int32)
        return CpuCol(T.INT32, h, np.ones(n, np.bool_))


def _hive_hash_col(col: ColumnVector) -> torch.Tensor:
    """int64 plane of each row's Hive hash (its low 32 bits)."""
    d = col.dtype
    if isinstance(d, T.StringType):
        if col.is_dict:
            voc = hive_string_hash(col.data["dict_offsets"],
                                   col.data["dict_bytes"])
            if not voc.shape[0]:
                return torch.zeros(col.capacity, dtype=torch.int64,
                                   device=voc.device)
            return voc[col.data["codes"].to(torch.int64).clamp(
                0, voc.shape[0] - 1)]
        return hive_string_hash(col.data["offsets"], col.data["bytes"])
    if isinstance(d, (T.BooleanType, T.Int8Type, T.Int16Type, T.Int32Type,
                      T.DateType)):
        return col.data.to(torch.int64)
    if isinstance(d, T.Float32Type):
        v = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                        col.data)
        return v.view(torch.int32).to(torch.int64)
    if isinstance(d, T.Float64Type):
        v = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                        col.data)
        bits = v.view(torch.int64)
    else:  # int64, timestamp, decimal
        bits = col.data.to(torch.int64)
    return (bits ^ _shr(bits, 32)) & 0xFFFFFFFF


def hive_string_hash(offsets: torch.Tensor, raw: torch.Tensor
                     ) -> torch.Tensor:
    """Java String.hashCode over each row's bytes taken as signed: h = 31 *
    h + b, in int64 masked to 32 bits; one step per byte position up to
    the longest row (one host read)."""
    o = offsets.to(torch.int64)
    starts, lens = o[:-1], o[1:] - o[:-1]
    h = torch.zeros(lens.shape[0], dtype=torch.int64, device=raw.device)
    nb = raw.shape[0]
    maxlen = int(lens.max().item()) if lens.shape[0] and nb else 0
    for i in range(maxlen):
        b = raw[(starts + i).clamp_(0, nb - 1)].to(torch.int8).to(
            torch.int64)
        h = torch.where(lens > i, (h * 31 + b) & 0xFFFFFFFF, h)
    return h


def hive_hash_col_np(c: CpuCol) -> np.ndarray:
    """The JAX package's numpy Hive hash of one CPU column (int32)."""
    d = c.dtype
    with np.errstate(over="ignore"):
        if isinstance(d, T.StringType):
            out = np.zeros(len(c.values), np.int32)
            for i, v in enumerate(c.values):
                if isinstance(v, str):
                    h = 0
                    for b in v.encode("utf-8"):
                        h = (h * 31 + (b if b < 128 else b - 256)) \
                            & 0xFFFFFFFF
                    out[i] = np.uint32(h).astype(np.int32)
            return out
        if isinstance(d, (T.BooleanType, T.Int8Type, T.Int16Type,
                          T.Int32Type, T.DateType)):
            return c.values.astype(np.int32)
        if isinstance(d, T.Float32Type):
            v = np.where(c.values == 0.0, 0.0, c.values).astype(np.float32)
            return v.view(np.int32)
        if isinstance(d, T.Float64Type):
            v = np.where(c.values == 0.0, 0.0, c.values).astype(np.float64)
            bits = v.view(np.uint64)
        else:
            bits = c.values.astype(np.int64).view(np.uint64)
        return ((bits ^ (bits >> np.uint64(32))) & np.uint64(0xFFFFFFFF)) \
            .astype(np.uint32).astype(np.int32)


def _crc32_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = 0xEDB88320 ^ (c >> 1) if c & 1 else c >> 1
        t[i] = c
    return t


_CRC32_TABLE = _crc32_table()


class Crc32(Expression):
    """crc32(string) -> bigint: the table-driven CRC-32 of each row's
    UTF-8 bytes, one step per byte position up to the longest row (one
    host read), in int64 with 32-bit masks; a dictionary column runs over
    its vocabulary."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT64

    def with_children(self, children):
        return Crc32(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            o = flat.data["offsets"][: cap + 1].to(torch.int64)
            raw = flat.data["bytes"]
            starts, lens = o[:-1], o[1:] - o[:-1]
            nb = raw.shape[0]
            table = torch.as_tensor(_CRC32_TABLE, device=raw.device)
            crc = torch.full((cap,), 0xFFFFFFFF, dtype=torch.int64,
                             device=raw.device)
            maxlen = int(lens.max().item()) if cap and nb else 0
            for i in range(maxlen):
                b = raw[(starts + i).clamp_(0, nb - 1)].to(torch.int64)
                nxt = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
                crc = torch.where(lens > i, nxt, crc)
            return ColumnVector(T.INT64, crc ^ 0xFFFFFFFF, None)

        out = _lift_unary(ctx, c, compute)
        return ColumnVector(T.INT64, out.data, _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        import zlib
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.INT64, np.array(
            [zlib.crc32(v.encode() if isinstance(v, str) else (v or b""))
             for v in c.values], np.int64), c.valid)
