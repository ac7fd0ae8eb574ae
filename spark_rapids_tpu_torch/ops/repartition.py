"""Counting-sort repartition: the compact exchange tail.

Counterpart of ``spark_rapids_tpu/ops/repartition.py`` (``partition_counts``,
``counting_sort_by_pid``, ``compact_slices``, ``slice_rows``). A stable
sort by target partition makes each partition's rows contiguous in input
order; the n_out+1 offsets vector is the only thing the host fetches, and
each partition becomes a right-sized sub-batch sliced from the sorted
planes. ``masked_slices`` is the masked mode's tail: n_out sub-batches
sharing the input's planes under their own live masks.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, LazyRowCount, round_capacity,
)
from spark_rapids_tpu_torch.ops import kernels as K


def partition_counts(pid: torch.Tensor, live: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """int64[n_out] live rows per target partition (dead rows fall into an
    overflow bucket that is cut away)."""
    slot = torch.where(live, pid, n_out).to(torch.int64)
    return torch.bincount(slot, minlength=n_out + 1)[:n_out]


def counting_sort_by_pid(batch: ColumnarBatch, pid: torch.Tensor,
                         n_out: int
                         ) -> Tuple[ColumnarBatch, torch.Tensor]:
    """(sorted batch, offsets[n_out+1]): partition p's rows occupy
    [offsets[p], offsets[p+1]) in input order; dead rows sort last."""
    live = batch.live_mask()
    cnt = partition_counts(pid, live, n_out)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=pid.device),
                         torch.cumsum(cnt, 0)])
    slot = torch.where(live, pid, n_out).to(torch.int32)
    order = torch.sort(slot, stable=True).indices.to(torch.int32)
    pos = torch.arange(batch.capacity, dtype=torch.int32, device=pid.device)
    idx = torch.where(pos < offsets[n_out], order, -1)
    return K.gather_batch(batch, idx, int(batch.capacity)), offsets


def _slice_column(c: ColumnVector, start: int, n: int,
                  cap: int) -> ColumnVector:
    def cut(t, fill_dtype):
        part = t[start: start + n]
        if cap > n:
            part = torch.cat([part, torch.zeros(cap - n, dtype=fill_dtype,
                                                device=t.device)])
        return part

    validity = None if c.validity is None else cut(c.validity, torch.bool)
    if isinstance(c.dtype, T.StructType):
        return ColumnVector(c.dtype, {"children": [
            _slice_column(k, start, n, cap) for k in c.data["children"]]},
            validity)
    if c.is_nested:
        # offsets + element planes: a row gather rebuilds the offsets
        pos = torch.arange(cap, dtype=torch.int64, device=c.device)
        return K.gather_column(c, torch.where(pos < n, pos + start, -1),
                               start + n)
    if c.is_dict:
        data = {"codes": cut(c.data["codes"], torch.int32),
                "dict_offsets": c.data["dict_offsets"],
                "dict_bytes": c.data["dict_bytes"]}
        return ColumnVector(c.dtype, data, validity,
                            dict_unique=c.dict_unique)
    return ColumnVector(c.dtype, cut(c.data, c.data.dtype), validity)


def compact_slices(sorted_batch: ColumnarBatch, offsets: np.ndarray,
                   n_out: int) -> List[Optional[ColumnarBatch]]:
    """Per-partition contiguous sub-batches of the sorted planes, each at
    capacity round_capacity(rows) with a host-int row count; empty
    partitions yield None."""
    out: List[Optional[ColumnarBatch]] = []
    for p in range(n_out):
        start = int(offsets[p])
        n = int(offsets[p + 1]) - start
        if n <= 0:
            out.append(None)
            continue
        cap = round_capacity(n)
        out.append(ColumnarBatch([_slice_column(c, start, n, cap)
                                  for c in sorted_batch.columns], n))
    return out


def slice_rows(batch: ColumnarBatch, start: int, length: int
               ) -> ColumnarBatch:
    """Rows [start, start + length) of an unmasked batch with a host-int
    count, as a sub-batch at round_capacity(length), the capacity bucket
    the compact exchange's own slices use (the skew split's primitive)."""
    sub = K.slice_batch(batch, int(start), int(length))
    return ColumnarBatch(sub.columns, int(length))


def masked_slices(batch: ColumnarBatch, pid: torch.Tensor,
                  n_out: int) -> List[ColumnarBatch]:
    """The masked mode: per target partition a sub-batch sharing the
    batch's planes, live where the batch is live and pid is that
    partition, its count left on the device."""
    live = batch.live_mask()
    out = []
    for p in range(n_out):
        m = live & (pid == p)
        out.append(ColumnarBatch(batch.columns,
                                 LazyRowCount(m.sum(dtype=torch.int32)), m))
    return out
