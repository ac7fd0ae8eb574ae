"""The capacity bucket policy: THE padding ladder of device planes.

Counterpart of ``spark_rapids_tpu/runtime/shapes.py``. Every batch
capacity the engine decides snaps to a small set of buckets, so the
stages keyed by capacity (the fused stages of ``exec/stage_fusion.py``,
the keyed entries of ``runtime/compile_cache.py``) repeat across batches
and queries. The JAX package needs the ladder because XLA compiles per
static shape; eager PyTorch does not, but the port keeps the JAX
package's ladder so that both engines pad to the same capacities (the
parity tests compare planes at their capacities) and so that a later
capture of a fused stage per (stage key, capacity bucket) meets few
buckets.

This module is the one home of the policy (``columnar.batch.
round_capacity`` delegates here). Two knobs shape the ladder:

- ``spark.rapids.compile.shapes.growthFactor``: buckets grow
  geometrically by this factor; 2.0 (the default) is the next power of
  two. Clamped to [1.0625, 4.0].
- ``spark.rapids.compile.shapes.dtypeAlign``: a bucket requested with an
  itemsize rounds up to a whole number of the JAX package's tiles for
  that width (8x128 elements for 4- and 8-byte lanes, 16x128 for 2-byte,
  32x128 for 1-byte). The rule is kept as the JAX package's padding rule
  so that capacities match; a power of two past one tile is aligned
  already.

``config.set_session_conf`` publishes the active values as module
globals. The bucket function is pure and monotone: bucket(n) >= n and
bucket(bucket(n)) == bucket(n), the fixpoint ``is_bucketed`` checks and
``ensure_bucketed`` restores for foreign batches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

#: geometric growth factor between buckets; 2.0 == next power of two
GROWTH_FACTOR: float = 2.0
#: snap buckets to whole tiles for the plane's dtype width
DTYPE_ALIGN: bool = True

#: elements per tile at each itemsize (the JAX package's (sublanes, 128)
#: tiles; 8-byte lanes share the 4-byte tile)
_TILE_ELEMS = {1: 32 * 128, 2: 16 * 128, 4: 8 * 128, 8: 8 * 128}


def configure(growth_factor: float, dtype_align: bool) -> None:
    """Publish the session policy (``config.set_session_conf``). A factor
    at or below 1.0 would make every row count its own bucket, so the
    factor is clamped to [1.0625, 4.0]."""
    global GROWTH_FACTOR, DTYPE_ALIGN
    g = float(growth_factor)
    GROWTH_FACTOR = min(max(g, 1.0625), 4.0)
    DTYPE_ALIGN = bool(dtype_align)


def _align_for(itemsize: Optional[int]) -> int:
    if not DTYPE_ALIGN or not itemsize:
        return 1
    return _TILE_ELEMS.get(int(itemsize), 8 * 128)


def bucket_rows(n: int, minimum: int, itemsize: Optional[int] = None
                ) -> int:
    """Smallest bucket >= max(n, 1, minimum): geometric growth by
    GROWTH_FACTOR, tile-aligned for ``itemsize`` once buckets pass one
    tile. At the default factor 2.0 this is the next power of two."""
    n = max(int(n), 1, int(minimum))
    g = GROWTH_FACTOR
    align = _align_for(itemsize)
    if g == 2.0:
        cap = 1 << (n - 1).bit_length()
        if align > 1 and cap > align:
            cap = ((cap + align - 1) // align) * align
        return cap
    # one ladder anchored at 1 (b0 = 1, b_{k+1} = align(ceil(b_k * g))),
    # walked in integer steps: every ladder value maps to itself, and
    # call sites with different floors share the same buckets (`minimum`
    # is a floor on the result, not the anchor)
    cap = 1
    while cap < n:
        nxt = math.ceil(cap * g)
        if align > 1 and nxt > align:
            nxt = ((nxt + align - 1) // align) * align
        cap = nxt
    return cap


def bucket_pool_bytes(nbytes: int, slack: int = 8) -> int:
    """Capacity of a raw byte pool (the encoded Parquet bit pools of
    ``io/encoded.py``): the 1-byte ladder with a floor of 32 over nbytes
    plus ``slack`` guard bytes, so a 32-bit word pair read at the last bit
    offset stays in bounds, in whole u32 words, so the pool views as an
    int32 word plane without a copy."""
    cap = bucket_rows(int(nbytes) + int(slack), 32, 1)
    return ((cap + 3) // 4) * 4


def is_bucketed(capacity: int, minimum: int,
                itemsize: Optional[int] = None) -> bool:
    """Is ``capacity`` already a bucket of the ladder?"""
    return int(capacity) == bucket_rows(int(capacity), minimum, itemsize)


def ensure_bucketed(batch):
    """Pad a batch whose row capacity is off the ladder up to its bucket:
    the canonicalizer for foreign batches (hand-built tests, planes handed
    in from outside). Engine batches are bucketed by construction and pass
    untouched. Padded rows are invalid and dead, so no result changes. A
    batch with a nested column is returned as it is (its child planes
    carry capacities of their own)."""
    from spark_rapids_tpu_torch.columnar import batch as B

    cap = batch.capacity
    if is_bucketed(cap, 1) or not batch.columns:
        return batch
    pad = bucket_rows(cap, 1) - cap

    def zpad(t):
        return torch.cat([t, torch.zeros(pad, dtype=t.dtype,
                                         device=t.device)])

    cols = []
    for c in batch.columns:
        if c.is_nested:
            return batch
        if isinstance(c.data, dict):
            data = dict(c.data)
            if c.is_dict:
                data["codes"] = zpad(c.data["codes"])
            else:  # flat string: the tail rows own empty slices
                off = c.data["offsets"]
                data["offsets"] = torch.cat([off, off[-1:].expand(pad)])
        else:
            data = zpad(c.data)
        # validity=None means valid below num_rows, which padding keeps
        validity = None if c.validity is None else zpad(c.validity)
        cols.append(B.ColumnVector(c.dtype, data, validity,
                                   dict_unique=c.dict_unique,
                                   bounds=c.bounds))
    row_mask = None if batch.row_mask is None else zpad(batch.row_mask)
    return B.ColumnarBatch(cols, batch.num_rows, row_mask)
