"""Hashing, sort keys, gathers, compaction and concatenation on torch
tensors.

Counterpart of ``spark_rapids_tpu/ops/kernels.py`` (murmur3 family,
``spark_hash_column``, ``spark_murmur3_batch``, ``partition_hash_batch``,
the xxhash64 pair ``xxhash64_int32``/``xxhash64_int64``, ``normalize_key``,
``string_chunk_count``, ``string_chunk_keys``, ``lexsort_indices``,
``gather_*``, ``LazyGatheredCols``, ``flat_string_as_dict``, ``filter_indices``,
``mask_filter_batch``, ``compact_batch``, ``slice_batch``,
``concat_batches``, and ``expand_ranges`` in two forms: per-row lengths,
and the JAX package's join form over [lo, hi) ranges,
``expand_candidate_ranges``).

Hash planes are int32 tensors holding the uint32 bit pattern. Only the
int32 hash has a kernel (``ops/murmur3_kernel.py``); the int64 and byte
hashes are plain tensor code, as they are plain XLA in the JAX package.
xxhash64 works on int64 planes holding the uint64 bit pattern: products
and sums wrap alike in both, and right shifts are made logical by hand
(the CPU build of torch has no uint64 shifts).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, LazyRowCount, round_capacity, rows_tensor,
)
from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
from spark_rapids_tpu_torch.ops import radix as R

SPARK_MURMUR3_SEED = 42

Seed = Union[int, torch.Tensor]


def murmur3_int32(values: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Spark hashInt of an int32 plane (the murmur3 kernel on the card)."""
    return MK.murmur3_int32(values.to(torch.int32), seed)


def _seed64(seed: Seed, n: int, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return MK.to_u32(seed)
    return torch.full((n,), int(seed) & 0xFFFFFFFF, dtype=torch.int64,
                      device=device)


def murmur3_int64(values: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Spark hashLong: low word then high word, fmix with len = 8."""
    v = values.to(torch.int64)
    low = v & 0xFFFFFFFF
    high = (v >> 32) & 0xFFFFFFFF
    h1 = _seed64(seed, v.shape[0], v.device)
    h1 = MK.mix_h1(h1, MK.mix_k1(low))
    h1 = MK.mix_h1(h1, MK.mix_k1(high))
    return MK.from_u32(MK.fmix(h1, 8))


def murmur3_bytes(starts: torch.Tensor, lens: torch.Tensor,
                  raw: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Spark hashUnsafeBytes of byte slices raw[starts[i]:starts[i]+lens[i]]:
    4-byte little-endian words for the aligned prefix, then each trailing
    byte as a sign-extended int."""
    n = starts.shape[0]
    device = starts.device
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    last = max(int(raw.shape[0]) - 1, 0)

    def byte_at(pos):
        # gather the bytes first: a widened copy of a whole byte plane
        # would cost 8 bytes per byte
        return raw[torch.clamp(pos, 0, last)].to(torch.int64)

    h1 = _seed64(seed, n, device)
    max_len = int(lens.max().item()) if n else 0
    for i in range(max_len // 4):
        pos = starts + 4 * i
        k1 = (byte_at(pos) | (byte_at(pos + 1) << 8)
              | (byte_at(pos + 2) << 16) | (byte_at(pos + 3) << 24))
        mixed = MK.mix_h1(h1, MK.mix_k1(k1))
        h1 = torch.where((i + 1) * 4 <= lens, mixed, h1)
    aligned = lens - lens % 4
    for j in range(3):
        b = byte_at(starts + aligned + j)
        b = torch.where(b >= 128, b - 256, b) & 0xFFFFFFFF
        mixed = MK.mix_h1(h1, MK.mix_k1(b))
        h1 = torch.where(aligned + j < lens, mixed, h1)
    return MK.from_u32(MK.fmix(h1, lens & 0xFFFFFFFF))


def _vocab_hash(col: ColumnVector, seed: Seed) -> torch.Tensor:
    off = col.data["dict_offsets"]
    return murmur3_bytes(off[:-1], off[1:] - off[:-1],
                         col.data["dict_bytes"], seed)


def spark_hash_column(col: ColumnVector, num_rows, seed: Seed,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spark Murmur3Hash of one column; null fields pass the running seed
    through unchanged."""
    d = col.dtype
    if col.is_dict:
        codes = col.data["codes"].to(torch.int64)
        if not isinstance(seed, torch.Tensor):
            h = _vocab_hash(col, seed)[codes.clamp(0, max(col.dict_size - 1,
                                                           0))]
        else:
            off = col.data["dict_offsets"].to(torch.int64)
            c = codes.clamp(0, max(col.dict_size - 1, 0))
            h = murmur3_bytes(off[c], off[c + 1] - off[c],
                              col.data["dict_bytes"], seed)
    elif isinstance(d, T.StringType):
        off = col.data["offsets"]
        h = murmur3_bytes(off[:-1], off[1:] - off[:-1], col.data["bytes"],
                          seed)
    elif isinstance(d, (T.BooleanType, T.Int8Type, T.Int16Type, T.Int32Type,
                        T.DateType)):
        h = murmur3_int32(col.data.to(torch.int32), seed)
    elif isinstance(d, T.Float32Type):
        v = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                        col.data)  # -0.0 -> +0.0
        h = murmur3_int32(v.view(torch.int32), seed)
    elif isinstance(d, T.Float64Type):
        v = torch.where(col.data == 0.0, torch.zeros_like(col.data),
                        col.data)
        h = murmur3_int64(v.view(torch.int64), seed)
    else:
        h = murmur3_int64(col.data.to(torch.int64), seed)
    if live is not None:
        valid = live if col.validity is None else (col.validity & live)
    else:
        valid = col.validity_or_default(num_rows)
    if isinstance(seed, torch.Tensor):
        seed_plane = seed
    else:
        seed_plane = MK.from_u32(torch.full_like(h, int(seed) & 0xFFFFFFFF,
                                                 dtype=torch.int64))
    return torch.where(valid, h, seed_plane)


def spark_murmur3_batch(cols: Sequence[ColumnVector], num_rows,
                        seed: int = SPARK_MURMUR3_SEED,
                        live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spark's Murmur3Hash(cols, 42), chained per row: each column's hash
    seeds the next. The seed stays a scalar until the first column makes
    it a plane, so a leading dictionary column hashes its vocabulary once;
    an int32-family column after it takes the murmur3 kernel with the
    running per-row seed."""
    h: Seed = seed
    for c in cols:
        h = spark_hash_column(c, num_rows, h, live=live)
    if not isinstance(h, torch.Tensor):
        h = MK.from_u32(torch.full((cols[0].capacity,), h & 0xFFFFFFFF,
                                   dtype=torch.int64,
                                   device=cols[0].device))
    return h


def partition_hash_batch(cols: Sequence[ColumnVector], num_rows,
                         seed: int = SPARK_MURMUR3_SEED,
                         live: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Exchange partitioning hash: Spark murmur3 chained over the columns,
    except that a dict-string column in a non-leading position mixes its
    vocab hash as an int32 (the JAX package's partition_hash_batch rule)."""
    h: Seed = seed
    for c in cols:
        if c.is_dict and isinstance(h, torch.Tensor):
            vh = _vocab_hash(c, SPARK_MURMUR3_SEED)
            codes = c.data["codes"].to(torch.int64).clamp(
                0, max(c.dict_size - 1, 0))
            lifted = ColumnVector(T.INT32, vh[codes], c.validity)
            h = spark_hash_column(lifted, num_rows, h, live=live)
        else:
            h = spark_hash_column(c, num_rows, h, live=live)
    if not isinstance(h, torch.Tensor):
        h = MK.from_u32(torch.full((cols[0].capacity,), h & 0xFFFFFFFF,
                                   dtype=torch.int64,
                                   device=cols[0].device))
    return h


# ---------------------------------------------------------------------------
# xxhash64 (Spark's XxHash64Function for fixed-width values)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def signed64(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def shr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 plane by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr64(x, 64 - r)


_XXP1 = signed64(0x9E3779B185EBCA87)
_XXP2 = signed64(0xC2B2AE3D27D4EB4F)
_XXP3 = signed64(0x165667B19E3779F9)
_XXP4 = signed64(0x85EBCA77C2B2AE63)
_XXP5 = signed64(0x27D4EB2F165667C5)


def _xx_avalanche(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ shr64(h, 33)) * _XXP2
    h = (h ^ shr64(h, 29)) * _XXP3
    return h ^ shr64(h, 32)


def _xx_seed(seed: Seed, add: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64) + signed64(_XXP5 + add)
    return torch.full_like(like, signed64(int(seed) + _XXP5 + add),
                           dtype=torch.int64)


def xxhash64_int64(values: torch.Tensor, seed: Seed = 42) -> torch.Tensor:
    """XXH64.hashLong of an int64 plane; seed is a scalar or a per-row
    int64 plane (Spark chains column hashes through the seed)."""
    v = values.to(torch.int64)
    h = _xx_seed(seed, 8, v)
    h = h ^ (_rotl64(v * _XXP2, 31) * _XXP1)
    return _xx_avalanche(_rotl64(h, 27) * _XXP1 + _XXP4)


def xxhash64_int32(values: torch.Tensor, seed: Seed = 42) -> torch.Tensor:
    """XXH64.hashInt (Spark's hash of fixed types of at most 4 bytes): the
    value's uint32 pattern."""
    v = values.to(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = _xx_seed(seed, 4, v)
    h = h ^ (v * _XXP1)
    return _xx_avalanche(_rotl64(h, 23) * _XXP2 + _XXP3)


# ---------------------------------------------------------------------------
# Sort keys (the sort route of the aggregate)
# ---------------------------------------------------------------------------

_MIN64 = -(1 << 63)
_M32 = 0xFFFFFFFF


def _string_key(off: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """The JAX package's 64-bit string key, (murmur3(bytes, 0x12345671) << 32)
    | murmur3(bytes, 0x89ABCDE3), as an int64 bit pattern with the sign bit
    flipped, so that signed order is the key's unsigned order."""
    starts, lens = off[:-1], off[1:] - off[:-1]
    h1 = murmur3_bytes(starts, lens, raw, 0x12345671).to(torch.int64) & _M32
    h2 = murmur3_bytes(starts, lens, raw, 0x89ABCDE3).to(torch.int64) & _M32
    return ((h1 << 32) | h2) ^ _MIN64


def normalize_key(col: ColumnVector, num_rows,
                  live: Optional[torch.Tensor] = None):
    """Returns (int64 key, null flags). Equal values get equal keys, and for
    fixed-width types signed key order is value order (floats: NaN above
    +inf, all NaNs equal, -0.0 == 0.0). Strings and dictionary vocabularies
    get the JAX package's 64-bit double hash of their bytes: equality-
    faithful up to hash collisions, not order-faithful. Null and dead rows
    get key 0."""
    d = col.dtype
    if live is not None:
        valid = live if col.validity is None else (col.validity & live)
    else:
        valid = col.validity_or_default(num_rows)
    if col.is_dict:
        if col.dict_size:
            vkey = _string_key(col.data["dict_offsets"].to(torch.int64),
                               col.data["dict_bytes"])
            key = vkey[col.data["codes"].to(torch.int64).clamp(
                0, col.dict_size - 1)]
        else:
            key = torch.zeros(col.capacity, dtype=torch.int64,
                              device=col.device)
    elif isinstance(d, T.StringType):
        key = _string_key(col.data["offsets"].to(torch.int64),
                          col.data["bytes"])
    elif isinstance(d, T.Float64Type):
        key = R._f64_order_i64(col.data)
    elif isinstance(d, T.Float32Type):
        key = R._f32_order_i32(col.data.to(torch.float32)).to(torch.int64)
    else:
        key = col.data.to(torch.int64)
    return torch.where(valid, key, 0), ~valid


def string_chunk_count(col: ColumnVector) -> int:
    """8-byte chunks covering the longest string of the column (or of its
    vocabulary), rounded up to a power of two; one host read."""
    off = col.data["dict_offsets"] if col.is_dict else col.data["offsets"]
    if off.shape[0] < 2:
        return 1
    mx = int((off[1:] - off[:-1]).max().item())
    return round_capacity(max(1, -(-mx // 8)), minimum=1)


def string_chunk_keys(col: ColumnVector, num_rows, n_chunks: int,
                      live: Optional[torch.Tensor] = None):
    """Exact string order as ``n_chunks`` (int64 key, null flags) pairs,
    most significant first: chunk j holds bytes [8j, 8j + 8) of the UTF-8
    string big-endian, zero padded, with the sign bit flipped, so signed
    lexicographic order over the chunks is byte order (Spark's binary
    string order; an embedded NUL ties with the end of the string). A
    dictionary column builds the chunks over its vocabulary and gathers
    them by code."""
    if live is not None:
        valid = live if col.validity is None else (col.validity & live)
    else:
        valid = col.validity_or_default(num_rows)
    nulls = ~valid
    if col.is_dict:
        off, raw = col.data["dict_offsets"], col.data["dict_bytes"]
    else:
        off, raw = col.data["offsets"], col.data["bytes"]
    starts = off[:-1].to(torch.int64)
    ends = off[1:].to(torch.int64)
    last = max(int(raw.shape[0]) - 1, 0)
    lane = torch.arange(8, dtype=torch.int64, device=raw.device)
    shifts = 8 * (7 - lane)
    codes = col.data["codes"].to(torch.int64).clamp(
        0, max(starts.shape[0] - 1, 0)) if col.is_dict else None
    out = []
    for j in range(n_chunks):
        pos = starts[:, None] + 8 * j + lane[None, :]
        b = torch.where(pos < ends[:, None],
                        raw[pos.clamp(0, last)].to(torch.int64), 0)
        key = (b << shifts[None, :]).sum(dim=1) ^ _MIN64
        if codes is not None:
            key = key[codes]
        out.append((key, nulls))
    return out


def lexsort_indices(keys, num_rows, live: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Stable lexicographic argsort. keys = [(int64 key, null flags,
    ascending, nulls_first)]; dead rows (``live`` False, or at or past
    ``num_rows``) sort to the very end. torch has no lexsort, so this is
    one stable sort per operand, the last operand first. Returns an int64
    permutation of the full capacity."""
    cap = keys[0][0].shape[0]
    device = keys[0][0].device
    in_range = live if live is not None else \
        torch.arange(cap, device=device) < rows_tensor(num_rows)
    operands = [(~in_range).to(torch.uint8)]
    for key, nulls, asc, nulls_first in keys:
        rank = nulls if not nulls_first else ~nulls
        operands.append(rank.to(torch.uint8))
        operands.append(key if asc else ~key)
    perm = torch.arange(cap, dtype=torch.int64, device=device)
    for op in reversed(operands):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    return perm


def expand_ranges(lens: torch.Tensor):
    """For per-row lengths (>= 0): the row and the position within the
    row of every element of the concatenated ranges, as int32 planes, and
    their count (one host read). The byte-level loops of the string
    expressions and of ``to_arrow`` run over these."""
    n = lens.shape[0]
    lens = lens.to(torch.int32)
    total = int(lens.sum(dtype=torch.int64).item()) if n else 0
    device = lens.device
    if total == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return empty, empty, 0
    row = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=device), lens,
        output_size=total)
    starts = torch.cumsum(lens, 0, dtype=torch.int32) - lens
    within = torch.arange(total, dtype=torch.int32, device=device) \
        - starts[row]
    return row, within, total


def expand_candidate_ranges(lo: torch.Tensor, hi: torch.Tensor,
                            total: int):
    """The JAX package's ``expand_ranges(lo, hi, total)``: per-row
    candidate ranges [lo, hi) become flat (row, position) pairs, row-major,
    in int64 planes of capacity round_capacity(total); entries at or past
    ``total`` (a host int, the sum of hi - lo) are -1."""
    out_cap = round_capacity(max(total, 1))
    device = lo.device
    counts = (hi - lo).to(torch.int64)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum(counts, 0)])
    r = torch.arange(out_cap, dtype=torch.int64, device=device)
    row = torch.searchsorted(offsets, r, right=True) - 1
    row = row.clamp(0, max(lo.shape[0] - 1, 0))
    pos = lo.to(torch.int64)[row] + (r - offsets[row])
    in_range = r < total
    return torch.where(in_range, row, -1), torch.where(in_range, pos, -1)


# ---------------------------------------------------------------------------
# Gathers, filter, compaction, concatenation
# ---------------------------------------------------------------------------

def gather_column(col: ColumnVector, indices: torch.Tensor, src_rows,
                  src_live: Optional[torch.Tensor] = None) -> ColumnVector:
    """Row gather; index -1 emits null. Dead source rows gather as null."""
    oob = indices < 0
    safe = indices.clamp(0, col.capacity - 1).to(torch.int64)
    if src_live is not None:
        src_valid = src_live if col.validity is None \
            else (col.validity & src_live)
    else:
        src_valid = col.validity_or_default(src_rows)
    valid = src_valid[safe] & ~oob
    if isinstance(col.dtype, T.StructType):
        kids = [gather_column(ch, indices, src_rows, src_live=src_live)
                for ch in col.data["children"]]
        return ColumnVector(col.dtype, {"children": kids}, valid)
    if col.is_nested:
        return _gather_list_like(col, safe, valid)
    if col.is_string and not col.is_dict:
        # a byte-plane gather could not repeat rows within the plane's
        # capacity: flat strings gather as codes into their own planes
        col = flat_string_as_dict(col)
    if col.is_dict:
        data = {"codes": col.data["codes"][safe],
                "dict_offsets": col.data["dict_offsets"],
                "dict_bytes": col.data["dict_bytes"]}
        return ColumnVector(col.dtype, data, valid,
                            dict_unique=col.dict_unique, bounds=col.bounds)
    return ColumnVector(col.dtype, col.data[safe], valid, bounds=col.bounds)


def element_planes(col: ColumnVector) -> List[str]:
    """The element children of an array ("child") or a map ("keys",
    "values") column."""
    return ["child"] if "child" in col.data else ["keys", "values"]


def _gather_list_like(col: ColumnVector, safe: torch.Tensor,
                      valid: torch.Tensor) -> ColumnVector:
    """Gather an array or map column: offsets rebuilt from the gathered
    rows' lengths (a null row gets an empty slice), then each output
    element mapped back to its source element and the child planes
    gathered. The child capacity is kept: permuting gathers (sort, filter
    compaction, limit, an explode's pass-through) never grow the element
    count, as in the JAX package; a row-duplicating gather of a list-like
    column is tagged off the device instead."""
    off = col.data["offsets"].to(torch.int64)
    out_cap = safe.shape[0]
    lens = torch.where(valid, (off[1:] - off[:-1])[safe], 0)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=off.device), lens.cumsum(0)])
    names = element_planes(col)
    child_cap = col.data[names[0]].capacity
    e = torch.arange(child_cap, dtype=torch.int64, device=off.device)
    orow = (torch.searchsorted(new_off, e, right=True) - 1).clamp(
        0, out_cap - 1)
    src_e = off[safe[orow]] + (e - new_off[orow])
    child_idx = torch.where(e < new_off[-1], src_e.clamp(0, child_cap - 1),
                            -1)
    data = {"offsets": new_off.to(torch.int32)}
    for nm in names:
        data[nm] = gather_column(col.data[nm], child_idx, child_cap)
    return ColumnVector(col.dtype, data, valid)


def flat_string_as_dict(col: ColumnVector) -> ColumnVector:
    """A flat offsets + bytes string column viewed as a dictionary column
    with identity codes, without a copy: the vocabulary is the source
    planes. ``dict_unique`` is False, since source rows may repeat
    values."""
    if col.is_dict or not col.is_string:
        return col
    return ColumnVector(col.dtype, {
        "codes": torch.arange(col.capacity, dtype=torch.int32,
                              device=col.device),
        "dict_offsets": col.data["offsets"],
        "dict_bytes": col.data["bytes"]}, col.validity, dict_unique=False)


class LazyGatheredCols:
    """A column list that gathers each source column by a shared index
    plane on its first access, and keeps the result: window functions
    evaluate over sorted row order, and a lambda body over the element
    plane (``expr/hof.py``), where most columns are never read.
    ``src_live`` marks the source's live rows where a mask selects
    them."""

    def __init__(self, cols, indices, num_rows, src_live=None,
                 gather=None):
        self._cols = cols
        self._idx = indices
        self._rows = num_rows
        self._live = src_live
        self._gather = gather or gather_column
        self._cache = {}

    def __len__(self):
        return len(self._cols)

    def __getitem__(self, i):
        out = self._cache.get(i)
        if out is None:
            out = self._gather(self._cols[i], self._idx, self._rows,
                               src_live=self._live)
            self._cache[i] = out
        return out

    def __iter__(self):
        return (self[i] for i in range(len(self._cols)))


def gather_batch(batch: ColumnarBatch, indices: torch.Tensor,
                 out_rows) -> ColumnarBatch:
    live = batch.live_mask() if batch.row_mask is not None else None
    return ColumnarBatch([gather_column(c, indices, batch.num_rows,
                                        src_live=live)
                          for c in batch.columns], out_rows)


def mask_filter_batch(batch: ColumnarBatch,
                      pred_mask: torch.Tensor) -> ColumnarBatch:
    """Filter without a gather or a sync: survivors are marked in the
    selection mask and the count stays on the device."""
    live = batch.live_mask() & pred_mask
    return ColumnarBatch(batch.columns,
                         LazyRowCount(live.sum(dtype=torch.int32)), live)


def _compact_indices(mask: torch.Tensor, out_cap: int) -> torch.Tensor:
    """int32[out_cap]: positions of the set rows of mask in order, -1 pad."""
    pos = torch.nonzero(mask).flatten().to(torch.int32)[:out_cap]
    out = torch.full((out_cap,), -1, dtype=torch.int32, device=mask.device)
    out[: pos.shape[0]] = pos
    return out


def filter_indices(mask: torch.Tensor, num_rows) -> tuple:
    """(int64 positions of the set rows of mask below num_rows, in order,
    -1 padded to round_capacity(count); count). One host read."""
    cap = mask.shape[0]
    if int(num_rows) < cap:
        mask = mask & (torch.arange(cap, device=mask.device) < int(num_rows))
    count = int(mask.sum(dtype=torch.int64).item())
    out_cap = round_capacity(max(count, 1))
    return _compact_indices(mask, out_cap).to(torch.int64), count


def compact_batch(batch: ColumnarBatch) -> ColumnarBatch:
    """Gather live rows to the front and drop the selection mask; shrink
    the capacity to the row count's bucket. Costs one count sync."""
    n = int(batch.num_rows)
    out_cap = round_capacity(n)
    if batch.row_mask is None:
        if out_cap >= batch.capacity:
            return ColumnarBatch(batch.columns, n)
        idx = torch.arange(out_cap, dtype=torch.int32, device=batch.device)
        idx = torch.where(idx < n, idx, -1)
    else:
        idx = _compact_indices(batch.row_mask, out_cap)
    return ColumnarBatch(gather_batch(batch, idx, n).columns, n)


def slice_batch(batch: ColumnarBatch, start: int, length: int
                ) -> ColumnarBatch:
    """Rows [start, start + length) of an unmasked batch, at the capacity
    of length's bucket."""
    out_cap = round_capacity(max(length, 1))
    idx = torch.arange(out_cap, dtype=torch.int64, device=batch.device)
    idx = torch.where(idx < length, idx + start, -1)
    return gather_batch(batch, idx, length)


def _union_bounds(cols: List[ColumnVector]):
    bs = [c.bounds for c in cols]
    if any(b is None for b in bs):
        return None
    return (min(b[0] for b in bs), max(b[1] for b in bs))


def unify_vocabs(cols: List[ColumnVector]):
    """Union the vocabularies of dict-string columns on the host: equal
    strings map to one code. Returns (offsets int32, bytes uint8, remaps)."""
    union: dict = {}
    remaps = []
    for c in cols:
        off = c.data["dict_offsets"].cpu().numpy()
        by = c.data["dict_bytes"].cpu().numpy()
        remap = np.zeros(len(off) - 1, np.int32)
        for k in range(len(off) - 1):
            remap[k] = union.setdefault(bytes(by[off[k]: off[k + 1]]),
                                        len(union))
        remaps.append(remap)
    uoff = np.zeros(len(union) + 1, np.int32)
    uoff[1:] = np.cumsum([len(s) for s in union])
    ub = b"".join(union)
    ubytes = np.frombuffer(ub, np.uint8).copy() if ub else np.zeros(1, np.uint8)
    return uoff, ubytes, remaps


def flatten_dict_column(col: ColumnVector, n: int) -> ColumnVector:
    """The first n rows of a dict-string column as flat offsets + bytes
    (null rows become empty strings); costs one sync for the byte count."""
    voff = col.data["dict_offsets"].to(torch.int64)
    vlens = voff[1:] - voff[:-1]
    codes = col.data["codes"][:n].to(torch.int64).clamp(
        0, max(col.dict_size - 1, 0))
    lens = vlens[codes] if col.dict_size else torch.zeros_like(codes)
    if col.validity is not None:
        lens = torch.where(col.validity[:n], lens, 0)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=codes.device), lens.cumsum(0)])
    nbytes = int(offsets[-1].item())
    b = torch.arange(nbytes, device=codes.device)
    row = torch.searchsorted(offsets, b, right=True) - 1
    src = voff[codes[row]] + (b - offsets[row]) if nbytes else b
    raw = col.data["dict_bytes"][src] if nbytes \
        else torch.zeros(0, dtype=torch.uint8, device=codes.device)
    return ColumnVector(col.dtype, {"offsets": offsets.to(torch.int32),
                                    "bytes": raw}, col.validity)


def _concat_flat_strings(cols, rows, cap, validity) -> ColumnVector:
    offs, raws, base = [], [], 0
    for c, r in zip(cols, rows):
        off = c.data["offsets"][: r + 1].to(torch.int64)
        lo, hi = int(off[0]), int(off[-1])
        offs.append(off[1:] - lo + base)
        raws.append(c.data["bytes"][lo:hi])
        base += hi - lo
    device = cols[0].device
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=device)]
                        + offs)
    offsets = torch.cat([offsets, offsets[-1:].expand(cap + 1 -
                                                      offsets.shape[0])])
    raw = torch.cat(raws)
    byte_cap = round_capacity(max(base, 1), minimum=8)
    raw = torch.cat([raw, torch.zeros(byte_cap - base, dtype=torch.uint8,
                                      device=device)])
    return ColumnVector(cols[0].dtype, {"offsets": offsets.to(torch.int32),
                                        "bytes": raw}, validity)


def _concat_arrays(cols, rows, cap, validity) -> ColumnVector:
    """Row-prefix concat of array or map columns: one host read of each
    part's element count sizes the children, whose planes concatenate
    recursively."""
    device = cols[0].device
    elem = [int(c.data["offsets"][r].item()) for c, r in zip(cols, rows)]
    parts, base = [torch.zeros(1, dtype=torch.int64, device=device)], 0
    for c, r, el in zip(cols, rows, elem):
        parts.append(c.data["offsets"][1: r + 1].to(torch.int64) + base)
        base += el
    offsets = torch.cat(parts)
    offsets = torch.cat([offsets, offsets[-1:].expand(cap + 1 -
                                                      offsets.shape[0])])
    data = {"offsets": offsets.to(torch.int32)}
    for nm in element_planes(cols[0]):
        data[nm] = _concat_columns([c.data[nm] for c in cols], elem,
                                   round_capacity(max(base, 1)))
    return ColumnVector(cols[0].dtype, data, validity)


def _concat_columns(cols: List[ColumnVector], rows: List[int],
                    cap: int) -> ColumnVector:
    """Row-prefix concat of columns, padded to cap."""
    dtype = cols[0].dtype
    device = cols[0].device
    total = sum(rows)
    pad = cap - total

    def cat(planes, fill_dtype):
        parts = list(planes)
        if pad > 0:
            parts.append(torch.zeros(pad, dtype=fill_dtype, device=device))
        return torch.cat(parts)

    validity = None
    if any(c.validity is not None for c in cols):
        validity = cat([c.validity_or_default(r)[:r]
                        for c, r in zip(cols, rows)], torch.bool)
    if isinstance(dtype, T.StructType):
        kids = [_concat_columns([c.data["children"][k] for c in cols],
                                rows, cap)
                for k in range(len(dtype.fields))]
        return ColumnVector(dtype, {"children": kids}, validity)
    if cols[0].is_nested:
        return _concat_arrays(cols, rows, cap, validity)
    bounds = _union_bounds(cols)
    shared = all(c.is_dict for c in cols) and all(
        c.data["dict_offsets"] is cols[0].data["dict_offsets"]
        and c.data["dict_bytes"] is cols[0].data["dict_bytes"]
        for c in cols[1:])
    if cols[0].is_string and not shared and not all(
            c.is_dict and c.dict_unique for c in cols):
        # a flat column, or a vocabulary that may repeat a string (often a
        # whole source plane behind identity codes): concatenate the rows'
        # bytes rather than union the vocabularies on the host
        flat = [flatten_dict_column(c, r) if c.is_dict else c
                for c, r in zip(cols, rows)]
        return _concat_flat_strings(flat, rows, cap, validity)
    if cols[0].is_dict:
        if shared:
            doff, dby = cols[0].data["dict_offsets"], cols[0].data["dict_bytes"]
            parts = [c.data["codes"][:r] for c, r in zip(cols, rows)]
        else:
            uoff, ubytes, remaps = unify_vocabs(cols)
            doff = torch.from_numpy(uoff).to(device)
            dby = torch.from_numpy(ubytes).to(device)
            parts = [torch.from_numpy(rm).to(device)[
                c.data["codes"][:r].to(torch.int64).clamp(0, max(len(rm) - 1,
                                                                 0))]
                for c, r, rm in zip(cols, rows, remaps)]
        # a unified vocabulary holds each string once
        unique = all(c.dict_unique for c in cols) if shared else True
        return ColumnVector(dtype, {"codes": cat(parts, torch.int32),
                                    "dict_offsets": doff, "dict_bytes": dby},
                            validity, dict_unique=unique)
    data = cat([c.data[:r] for c, r in zip(cols, rows)], cols[0].data.dtype)
    return ColumnVector(dtype, data, validity, bounds=bounds)


def concat_batches(batches: List[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate batches. Masked inputs stack their full planes and
    masks (no gather); unmasked inputs concatenate their live prefixes."""
    nonempty = [b for b in batches if int(b.num_rows) > 0]
    if not nonempty:
        return batches[0]
    if len(nonempty) == 1:
        return nonempty[0]
    total = sum(int(b.num_rows) for b in nonempty)
    if any(b.row_mask is not None for b in nonempty):
        mask = torch.cat([b.live_mask() for b in nonempty])
        caps = [b.capacity for b in nonempty]
        cols = []
        for ci in range(len(nonempty[0].columns)):
            parts = [b.columns[ci] for b in nonempty]
            c = _concat_columns(
                [ColumnVector(p.dtype, p.data, p.validity_or_default(p.capacity)
                              if p.validity is not None else
                              torch.ones(p.capacity, dtype=torch.bool,
                                         device=p.device),
                              p.dict_unique, p.bounds) for p in parts],
                caps, sum(caps))
            cols.append(c)
        return ColumnarBatch(cols, total, mask)
    rows = [int(b.num_rows) for b in nonempty]
    cap = round_capacity(total)
    return ColumnarBatch([_concat_columns([b.columns[ci] for b in nonempty],
                                          rows, cap)
                          for ci in range(len(nonempty[0].columns))], total)
