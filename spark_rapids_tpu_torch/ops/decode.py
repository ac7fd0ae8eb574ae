"""Device-side Parquet decode: expansion of the encoded planes of
``io/encoded.py`` into columns on the card.

Counterpart of ``spark_rapids_tpu/ops/pallas_decode.py`` (all but the
bit-slice, which is ``ops/bitslice.py``):

- run expansion  = searchsorted(cum, row) + the bitslice kernel per row
- dictionary     = one gather through the vocabulary plane
- delta          = cumsum with per-stream (page) restarts
- null placement = cumsum of the definition levels and a gather, with
  nulls filled with 0 and the padded tail zero, as the host route's
  ``from_arrow`` leaves them

PyTorch runs eagerly, so each column decodes as a short chain of tensor
operations per batch. The non-null count and the capacities are host
ints (``EncodedColumn.nnz`` and its meta), so the decode reads nothing
back from the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector, ColumnarBatch
from spark_rapids_tpu_torch.ops import bitslice as BS


def _segments(cum: torch.Tensor, vcap: int) -> torch.Tensor:
    """The run (or stream) of every output position: searchsorted into
    the cumulative ends, clamped to the table; positions past the encoded
    total land on the sentinel-padded slots io/encoded.py guarantees."""
    i = torch.arange(vcap, dtype=torch.int32, device=cum.device)
    return torch.searchsorted(cum, i, right=True).clamp(0, cum.shape[0] - 1)


def run_bits(planes: Dict[str, torch.Tensor], prefix: str, vcap: int):
    """The bitslice kernel's operands for a run table expanded to
    ``vcap`` positions: (words, bit offsets, masks, run of each
    position)."""
    cum = planes[prefix + "cum"]
    seg = _segments(cum, vcap)
    i = torch.arange(vcap, dtype=torch.int64, device=cum.device)
    s_start = planes[prefix + "start"][seg]
    width = planes.get(prefix + "width")
    if width is None:  # constant width 1 (def levels, booleans)
        w64 = 1
        mask = torch.ones(vcap, dtype=torch.int32, device=cum.device)
    else:
        s_width = width[seg]
        mask = BS.width_mask(s_width)
        w64 = s_width.to(torch.int64)
    bitoff = planes[prefix + "bitbase"][seg] + (i - s_start) * w64
    return BS.words_of(planes[prefix + "pool"]), bitoff, mask, seg


def expand_runs(planes: Dict[str, torch.Tensor], prefix: str,
                vcap: int) -> torch.Tensor:
    """Expand an RLE/bit-packed run table to ``vcap`` int32 values;
    positions past the encoded total decode to exact 0."""
    words, bitoff, mask, seg = run_bits(planes, prefix, vcap)
    ext = BS.bitslice(words, bitoff, mask)
    out = torch.where(planes[prefix + "packed"][seg], ext,
                      planes[prefix + "val"][seg])
    base = planes.get(prefix + "base")
    if base is not None:
        out = out + base[seg]
    return out


def _expand_delta(planes: Dict[str, torch.Tensor], vcap: int, vpm: int,
                  nnz: int) -> torch.Tensor:
    """DELTA_BINARY_PACKED -> int64 values: a miniblock bit-slice per
    element, then one cumsum with per-stream (page) restarts."""
    s_cum = planes["s_cum"]
    seg = _segments(s_cum, vcap)
    j = torch.arange(vcap, dtype=torch.int64, device=s_cum.device)
    a = planes["s_start"][seg].to(torch.int64)
    rel = j - a - 1  # delta index within the stream; -1 at stream starts
    live = rel >= 0
    mb = (planes["s_mbbase"][seg] + torch.where(live, rel // vpm, 0)).clamp(
        0, planes["mb_width"].shape[0] - 1)
    within = torch.where(live, rel % vpm, 0)
    w = planes["mb_width"][mb]
    bitoff = planes["mb_bitbase"][mb] + within * w.to(torch.int64)
    ext = BS.bitslice(BS.words_of(planes["pool"]), bitoff, BS.width_mask(w))
    # the extracted field is unsigned: zero-extend it
    d = (ext.to(torch.int64) & 0xFFFFFFFF) + planes["mb_min"][mb]
    d = torch.where(live & (j < nnz), d, 0)
    c = torch.cumsum(d, 0)
    # value[j] = first[stream] + sum of deltas in (stream_start, j]
    return planes["s_first"][seg] + c - c[a.clamp(0, vcap - 1)]


def _plain_values(pool: torch.Tensor, w: int) -> torch.Tensor:
    """PLAIN fixed-width little-endian bytes as int32 or int64 lanes (a
    view of the pool, no copy)."""
    return pool.view(torch.int32 if w == 4 else torch.int64)


def _cast(vals: torch.Tensor, dtype: T.DataType) -> torch.Tensor:
    """Decoded lanes -> the engine plane dtype. Integer lanes of a float
    column are its bit patterns and are reinterpreted, not converted."""
    if isinstance(dtype, T.BooleanType):
        return vals != 0
    td = dtype.torch_dtype
    if td.is_floating_point and not vals.dtype.is_floating_point:
        return vals.view(td)
    return vals.to(td)


def _decode_column(ec, cap: int) -> ColumnVector:
    """One EncodedColumn -> ColumnVector."""
    if ec.kind == "decoded":
        return ec.cv
    meta = dict(ec.meta)
    vcap = meta["vcap"]
    planes = ec.planes
    if ec.kind == "plain":
        vals = _plain_values(planes["pool"], meta["w"])
    elif ec.kind == "bool":
        vals = expand_runs(planes, "", vcap)
    elif ec.kind == "dict":
        codes = expand_runs(planes, "", vcap)
        vocab = planes["vocab"]
        vals = vocab[codes.clamp(0, vocab.shape[0] - 1)]
    else:  # delta
        vals = _expand_delta(planes, vcap, meta["vpm"], ec.nnz)
    vals = _cast(vals, ec.dtype)
    # zero the padded tail: the host route's from_arrow zero-fills pad
    # rows, and the aggregate routes that trust column bounds rely on it
    # (a new tensor: a plain column's values are a view of its pool)
    pos = torch.arange(vcap, device=vals.device)
    vals = torch.where(pos < ec.nnz, vals, torch.zeros((), dtype=vals.dtype,
                                                       device=vals.device))
    if "d_cum" in planes:
        # sparse values -> row positions via the definition levels: a
        # valid row gathers the next value, a null row takes 0
        valid = expand_runs(planes, "d_", cap) == 1
        src = (torch.cumsum(valid.to(torch.int32), 0) - 1).clamp(0, vcap - 1)
        data = torch.where(valid, vals[src], torch.zeros(
            (), dtype=vals.dtype, device=vals.device))
        return ColumnVector(ec.dtype, data, valid, bounds=ec.bounds)
    return ColumnVector(ec.dtype, vals, None, bounds=ec.bounds)


def decode_batch(eb) -> ColumnarBatch:
    """EncodedBatch -> ColumnarBatch with the host row count."""
    return ColumnarBatch([_decode_column(c, eb.capacity) for c in eb.columns],
                         eb.num_rows, None)
