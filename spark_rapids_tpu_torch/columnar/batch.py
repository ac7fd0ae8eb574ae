"""Device columnar batches on torch tensors.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``. The layout is the
same, so the two packages' batches can be compared plane by plane:

- A column is a data plane (or, for strings, a dict of planes) plus an
  optional bool validity plane (True = valid). ``validity=None`` means
  every row below ``num_rows`` is valid.
- Planes are padded to a power-of-two row capacity; rows at or past
  ``num_rows`` hold defined garbage that kernels mask out.
- Strings are dictionary-encoded when the vocabulary is small (int32 codes
  + int32 vocab offsets + uint8 vocab bytes), else flat offsets + bytes.
- Decimals are their unscaled int64 values (DECIMAL64, precision <= 18).
- An array column is int32 offsets (capacity + 1) plus a child
  ``ColumnVector`` holding the elements back to back; a null row owns an
  empty slice. A map column is the same offsets plus ``keys`` and
  ``values`` child columns of one element capacity. A struct column is
  ``{"children": [...]}``, one child per field at the row capacity, plus
  the struct's own validity (a null struct row may have valid children).
- ``row_mask`` is a selection vector: a filter marks rows dead instead of
  gathering the survivors, and the surviving count stays on the device as
  a ``LazyRowCount`` until the host needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

#: capacity floor (the JAX package's session default of
#: spark.rapids.tpu.batchCapacityMinRows)
MIN_CAPACITY = 1024


def round_capacity(n: int, minimum: Optional[int] = None) -> int:
    """Round a row count up to its capacity bucket: the next power of two
    at or above max(n, 1, minimum) (the JAX package's default ladder)."""
    if minimum is None:
        minimum = MIN_CAPACITY
    return bucket_rows(n, minimum)


def bucket_rows(n: int, minimum: int) -> int:
    """The power-of-two ladder: the next power of two at or above
    max(n, 1, minimum). (The JAX package also aligns buckets to TPU
    tiles; a power of two past one tile is aligned already, so the
    default ladders agree.)"""
    n = max(int(n), 1, int(minimum))
    return 1 << (n - 1).bit_length()


def bucket_pool_bytes(nbytes: int, slack: int = 8) -> int:
    """Capacity of a raw byte pool (the encoded Parquet bit pools of
    io/encoded.py): the ladder with a floor of 32 over nbytes plus
    ``slack`` guard bytes, so a 32-bit word pair read at the last bit
    offset stays in bounds, in whole u32 words, so the pool views as an
    int32 word plane without a copy."""
    cap = bucket_rows(int(nbytes) + int(slack), 32)
    return ((cap + 3) // 4) * 4


class LazyRowCount:
    """A row count held as a 0-d device tensor until a host consumer needs
    the int; reading it costs one device-to-host sync."""

    __slots__ = ("_dev", "_val")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._val: Optional[int] = None

    def materialize(self) -> int:
        if self._val is None:
            self._val = int(self._dev.item())
        return self._val

    def __int__(self):
        return self.materialize()

    __index__ = __int__

    def __repr__(self):
        return (f"LazyRowCount({self._val})" if self._val is not None
                else "LazyRowCount(<device>)")


def rows_tensor(n) -> Union[int, torch.Tensor]:
    """num_rows without a sync: the device scalar of a lazy count, or the
    host int."""
    if isinstance(n, LazyRowCount):
        return n._dev if n._val is None else n._val
    return n


@dataclasses.dataclass
class ColumnVector:
    """One device-resident column (see the module docstring for planes)."""

    dtype: T.DataType
    data: Union[torch.Tensor, Dict[str, torch.Tensor]]
    validity: Optional[torch.Tensor] = None
    #: dict columns only: vocab entries are known distinct
    dict_unique: bool = True
    #: optional host-side (min, max) int bounds from cache-time column
    #: stats; radix packing uses them instead of a device range probe
    bounds: Optional[Tuple[int, int]] = None

    @property
    def capacity(self) -> int:
        if isinstance(self.data, dict):
            if "codes" in self.data:
                return int(self.data["codes"].shape[0])
            if "children" in self.data:  # struct: its first child's
                return self.data["children"][0].capacity
            return int(self.data["offsets"].shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        if isinstance(self.data, dict):
            if "children" in self.data:
                return self.data["children"][0].device
            return next(iter(self.data.values())).device
        return self.data.device

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    @property
    def is_dict(self) -> bool:
        return isinstance(self.data, dict) and "codes" in self.data

    @property
    def is_nested(self) -> bool:
        return isinstance(self.dtype, (T.ArrayType, T.StructType,
                                       T.MapType))

    @property
    def dict_size(self) -> int:
        return int(self.data["dict_offsets"].shape[0]) - 1

    def validity_or_default(self, num_rows) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        pos = torch.arange(self.capacity, device=self.device)
        return pos < rows_tensor(num_rows)

    def device_memory_size(self) -> int:
        planes = list(self.data.get("children", self.data.values())) \
            if isinstance(self.data, dict) else [self.data]
        if self.validity is not None:
            planes.append(self.validity)
        return sum(p.device_memory_size() if isinstance(p, ColumnVector)
                   else p.numel() * p.element_size() for p in planes)


@dataclasses.dataclass
class ColumnarBatch:
    """Equal-capacity columns, the row count, and an optional selection
    mask (bool[capacity], True = live). Dead rows are nonexistent."""

    columns: List[ColumnVector]
    num_rows: Union[int, LazyRowCount]
    row_mask: Optional[torch.Tensor] = None
    #: the concatenation of several batches (a coalesce's output): a
    #: final aggregate merges it even as a single input batch
    coalesced: bool = False

    @property
    def capacity(self) -> int:
        if not self.columns:
            return round_capacity(int(self.num_rows))
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def live_mask(self) -> torch.Tensor:
        if self.row_mask is not None:
            return self.row_mask
        pos = torch.arange(self.capacity, device=self.device)
        return pos < rows_tensor(self.num_rows)

    def device_memory_size(self) -> int:
        return sum(c.device_memory_size() for c in self.columns)


def map_planes(batch: ColumnarBatch, fn) -> ColumnarBatch:
    """The batch with fn applied to every plane: each column's data,
    validity, string offsets, bytes, codes and vocabulary, the child
    columns of arrays, maps and structs, the row mask and a row count
    still on the device. Host objects (column bounds, a host-int row
    count, the flags) are kept. A leaf is anything that is not a column,
    a dict, a list or None, so fn may turn tensors into other leaves and
    a second map turns them back (the spill framework's tiers; the JAX
    package flattens the batch's pytree instead)."""

    def leaf(x):
        if x is None:
            return None
        if isinstance(x, ColumnVector):
            return col(x)
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        return fn(x)

    def col(c: ColumnVector) -> ColumnVector:
        return dataclasses.replace(c, data=leaf(c.data),
                                   validity=leaf(c.validity))

    n = batch.num_rows
    if isinstance(n, LazyRowCount):
        n = n._val if n._val is not None else LazyRowCount(fn(n._dev))
    return dataclasses.replace(batch, columns=[col(c) for c in batch.columns],
                               num_rows=n, row_mask=leaf(batch.row_mask))


def batch_to(batch: ColumnarBatch, device) -> ColumnarBatch:
    """The batch with every plane copied to ``device`` (a blocking copy:
    the source planes may be dropped as soon as this returns)."""
    device = torch.device(device)
    return map_planes(batch, lambda t: t.to(device))


# ---------------------------------------------------------------------------
# Arrow in and out
# ---------------------------------------------------------------------------

def _pad_to(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if arr.shape[0] == capacity:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``. On the card, a non-blocking copy from
    pinned host memory on the current stream (so a pipeline producer's
    uploads run on its side stream, runtime/pipeline.py): the host
    tensor may be dropped as soon as this returns. On the CPU, the
    tensor itself."""
    device = torch.device(device)
    if device.type != "cuda" or t.numel() == 0:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    return to_device(torch.from_numpy(np.ascontiguousarray(arr)), device)


def _fixed_width_view(arr, np_dtype) -> np.ndarray:
    buf = arr.buffers()[1]
    view = np.frombuffer(buf, dtype=np_dtype, count=arr.offset + len(arr))
    return view[arr.offset:]


def _string_planes(arr) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 offsets rebased to 0, uint8 bytes) of a string array."""
    import pyarrow as pa
    import pyarrow.compute as pc
    arr = pc.fill_null(arr, "")
    if not pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.large_string())
    off = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    off = off[arr.offset: arr.offset + len(arr) + 1]
    base = int(off[0])
    nbytes = int(off[-1]) - base
    raw = np.frombuffer(arr.buffers()[2] or b"", dtype=np.uint8)
    return off - base, raw[base: base + nbytes]


def column_from_arrow(arr, dtype: T.DataType, capacity: int,
                      device) -> ColumnVector:
    """Build a device ColumnVector from one pyarrow Array."""
    import pyarrow as pa
    import pyarrow.compute as pc

    n = len(arr)
    valid_np = None if arr.null_count == 0 \
        else np.asarray(arr.is_valid()).astype(np.bool_)
    if isinstance(dtype, (T.ArrayType, T.MapType)):
        return _list_like_from_arrow(arr, dtype, capacity, device, valid_np)
    if isinstance(dtype, T.StructType):
        if not dtype.fields:
            raise TypeError("empty struct columns are not supported")
        kids = [column_from_arrow(arr.field(i), f.dtype, capacity, device)
                for i, f in enumerate(dtype.fields)]
        validity = None if valid_np is None \
            else _upload(_pad_to(valid_np, capacity, fill=False), device)
        return ColumnVector(dtype, {"children": kids}, validity)
    if isinstance(dtype, T.NullType):
        return ColumnVector(
            dtype, torch.zeros(capacity, dtype=torch.int8, device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device))
    if isinstance(dtype, T.DecimalType):
        data = _upload(_pad_to(decimal_unscaled(arr, dtype, valid_np),
                               capacity), device)
    elif isinstance(dtype, T.StringType):
        denc = arr if pa.types.is_dictionary(arr.type) \
            else arr.dictionary_encode()
        vocab = denc.dictionary
        if len(vocab) <= max(64, n // 2):
            codes = denc.indices
            if codes.null_count:
                codes = pc.fill_null(codes, 0)
            voff, vbytes = _string_planes(vocab)
            data = {
                "codes": _upload(_pad_to(np.asarray(codes).astype(np.int32),
                                         capacity), device),
                "dict_offsets": _upload(voff.astype(np.int32), device),
                "dict_bytes": _upload(vbytes if len(vbytes)
                                      else np.zeros(1, np.uint8), device),
            }
        else:
            if pa.types.is_dictionary(arr.type):
                arr = arr.dictionary_decode()
            off, raw = _string_planes(arr)
            off_padded = np.full(capacity + 1, off[-1], dtype=np.int32)
            off_padded[: n + 1] = off
            byte_cap = round_capacity(max(len(raw), 1), minimum=8)
            data = {"offsets": _upload(off_padded, device),
                    "bytes": _upload(_pad_to(raw, byte_cap), device)}
    elif isinstance(dtype, T.BooleanType):
        np_arr = np.asarray(pc.fill_null(arr, False), dtype=np.bool_)
        data = _upload(_pad_to(np_arr, capacity), device)
    else:
        if isinstance(dtype, T.TimestampType):
            arr = arr.cast(pa.timestamp("us"))
        if arr.null_count:
            arr = pc.fill_null(arr, 0)
        np_arr = _fixed_width_view(arr, dtype.np_dtype)
        data = _upload(_pad_to(np_arr, capacity), device)
    validity = None if valid_np is None \
        else _upload(_pad_to(valid_np, capacity, fill=False), device)
    return ColumnVector(dtype, data, validity)


def decimal_unscaled(arr, dtype: T.DecimalType,
                       valid_np: Optional[np.ndarray]) -> np.ndarray:
    """The unscaled values of a decimal128 array at ``dtype``'s scale, as
    int64, read from the buffer's low words. A valid value whose high word
    is not its low word's sign extension does not fit in 64 bits: it
    raises, as the JAX package's int64 conversion does."""
    import pyarrow as pa
    at = pa.decimal128(dtype.precision, dtype.scale)
    if arr.type != at:
        arr = arr.cast(at)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * (arr.offset + len(arr)))
    words = words[2 * arr.offset:]
    low, high = words[0::2], words[1::2]
    bad = high != (low >> 63)
    if valid_np is not None:
        bad &= valid_np
        low = np.where(valid_np, low, 0)
    if bad.any():
        i = int(np.argmax(bad))
        raise OverflowError(f"decimal value at row {i} does not fit in "
                            f"64 bits ({dtype!r})")
    return np.ascontiguousarray(low)


def _list_like_from_arrow(arr, dtype, capacity: int, device,
                          valid_np: Optional[np.ndarray]) -> ColumnVector:
    """An Arrow list or map array as offsets + child columns, from
    buffers. Arrow lets a null row own a non-empty slice; here it owns an
    empty one, so the child planes hold only the valid rows' elements."""
    import pyarrow as pa
    if isinstance(dtype, T.ArrayType) and pa.types.is_large_list(arr.type):
        arr = arr.cast(pa.list_(arr.type.value_type))
    off = np.asarray(arr.offsets, dtype=np.int64)
    lens = np.diff(off)
    n = len(arr)
    if valid_np is not None and (lens[~valid_np] != 0).any():
        lens = np.where(valid_np, lens, 0)
        keep = np.repeat(valid_np, np.diff(off))
        elems = pa.array(np.arange(off[0], off[-1])[keep])
    else:
        elems = None
    offsets = np.zeros(capacity + 1, np.int64)
    offsets[1: n + 1] = np.cumsum(lens)
    offsets[n + 1:] = offsets[n]
    total = int(offsets[n])
    child_cap = round_capacity(max(total, 1))

    def child(values, dt):
        # the rows' elements: the plane between the first and the last
        # offset, or the valid rows' elements where a null row owns some
        values = values.slice(int(off[0]), int(off[-1] - off[0])) \
            if elems is None else values.take(elems)
        return column_from_arrow(values, dt, child_cap, device)

    data = {"offsets": _upload(offsets.astype(np.int32), device)}
    if isinstance(dtype, T.MapType):
        data["keys"] = child(arr.keys, dtype.key)
        data["values"] = child(arr.items, dtype.value)
    else:
        data["child"] = child(arr.values, dtype.element)
    validity = None if valid_np is None \
        else _upload(_pad_to(valid_np, capacity, fill=False), device)
    return ColumnVector(dtype, data, validity)


def from_arrow(table, device) -> ColumnarBatch:
    """pyarrow Table -> ColumnarBatch on ``device`` (one upload per
    plane). The device has no default: an upload that forgot it would
    quietly land on the host."""
    table = table.combine_chunks()
    n = table.num_rows
    cap = round_capacity(n)
    cols = []
    for i, field in enumerate(table.schema):
        dtype = T.from_arrow(field.type)
        chunked = table.column(i)
        arr = chunked.chunk(0) if chunked.num_chunks \
            else chunked.combine_chunks()
        cols.append(column_from_arrow(arr, dtype, cap, torch.device(device)))
    return ColumnarBatch(cols, n)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _string_rows_arrow(col: ColumnVector, idx: torch.Tensor,
                       valid: Optional[np.ndarray]):
    """The selected rows of a string column as an Arrow string array. The
    rows' bytes are gathered on the device, so only they are downloaded
    (a flat plane, or the vocabulary behind a gathered flat column, may
    hold a gigabyte), and the array is built from buffers, without a
    Python string per row."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops.kernels import expand_ranges
    n = idx.shape[0]
    if col.is_dict:
        off = col.data["dict_offsets"].to(torch.int64)
        raw = col.data["dict_bytes"]
        if col.dict_size == 0:
            valid = np.zeros(n, np.bool_)
            starts = torch.zeros(n, dtype=torch.int64, device=idx.device)
            lens = starts
        else:
            codes = col.data["codes"][idx].to(torch.int64).clamp(
                0, col.dict_size - 1)
            starts = off[codes]
            lens = off[codes + 1] - starts
    else:
        off = col.data["offsets"].to(torch.int64)
        raw = col.data["bytes"]
        starts = off[idx]
        lens = off[idx + 1] - starts
    if valid is not None:
        lens = torch.where(torch.from_numpy(valid).to(lens.device), lens, 0)
    row, within, total = expand_ranges(lens)
    data = raw[starts[row.to(torch.int64)] + within] if total \
        else torch.zeros(0, dtype=torch.uint8, device=raw.device)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=lens.device), lens.cumsum(0)])
    bitmap = None if valid is None \
        else pa.py_buffer(np.packbits(valid, bitorder="little"))
    arr = pa.LargeStringArray.from_buffers(
        n, pa.py_buffer(_host(new_off)), pa.py_buffer(_host(data)), bitmap)
    return arr.cast(pa.string())


def decimal_arrow(vals: np.ndarray, dtype: T.DecimalType,
                        valid: Optional[np.ndarray]):
    """int64 unscaled values as an Arrow decimal128 array, built from
    buffers: each value's high word is its sign extension."""
    import pyarrow as pa
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    words = np.empty(2 * vals.shape[0], np.int64)
    words[0::2] = vals
    words[1::2] = vals >> 63
    bitmap = None if valid is None \
        else pa.py_buffer(np.packbits(valid, bitorder="little"))
    return pa.Array.from_buffers(T.to_arrow(dtype), vals.shape[0],
                                 [bitmap, pa.py_buffer(words)])


def _child_rows_arrow(child: ColumnVector, idx: torch.Tensor):
    valid = None if child.validity is None else _host(child.validity[idx])
    return _column_rows_arrow(child, idx, valid)


def _list_rows_arrow(col: ColumnVector, idx: torch.Tensor,
                     valid: Optional[np.ndarray]):
    """The selected rows of an array or map column as an Arrow list or
    map array: the rows' elements are gathered on the device
    (``expand_ranges``), the children convert recursively, and the
    offsets are rebuilt."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.ops.kernels import expand_ranges
    off = col.data["offsets"].to(torch.int64)
    starts = off[idx]
    lens = off[idx + 1] - starts
    if valid is not None:
        lens = torch.where(torch.from_numpy(valid).to(lens.device), lens, 0)
    row, within, total = expand_ranges(lens)
    eidx = starts[row.to(torch.int64)] + within if total \
        else torch.zeros(0, dtype=torch.int64, device=off.device)
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=lens.device), lens.cumsum(0)])
    offsets = pa.array(_host(new_off).astype(np.int32))
    mask = None if valid is None else pa.array(~valid)
    if isinstance(col.dtype, T.MapType):
        return pa.MapArray.from_arrays(
            offsets, _child_rows_arrow(col.data["keys"], eidx),
            _child_rows_arrow(col.data["values"], eidx),
            type=T.to_arrow(col.dtype), mask=mask)
    return pa.ListArray.from_arrays(
        offsets, _child_rows_arrow(col.data["child"], eidx),
        type=T.to_arrow(col.dtype), mask=mask)


def _struct_rows_arrow(col: ColumnVector, idx: torch.Tensor,
                       valid: Optional[np.ndarray]):
    import pyarrow as pa
    kids = [_child_rows_arrow(ch, idx) for ch in col.data["children"]]
    return pa.StructArray.from_arrays(
        kids, fields=list(T.to_arrow(col.dtype)),
        mask=None if valid is None else pa.array(~valid))


def _column_rows_arrow(col: ColumnVector, idx: torch.Tensor,
                       valid: Optional[np.ndarray]):
    """The rows ``idx`` of one column as an Arrow array; ``valid`` is the
    rows' validity on the host, or None when every row is valid."""
    import pyarrow as pa
    if col.is_string:
        return _string_rows_arrow(col, idx, valid)
    if isinstance(col.dtype, T.StructType):
        return _struct_rows_arrow(col, idx, valid)
    if col.is_nested:
        return _list_rows_arrow(col, idx, valid)
    if isinstance(col.dtype, T.NullType):
        return pa.nulls(int(idx.shape[0]))
    vals = _host(col.data[idx])
    if isinstance(col.dtype, T.DecimalType):
        return decimal_arrow(vals, col.dtype, valid)
    mask = None if valid is None else ~valid
    if isinstance(col.dtype, T.DateType):
        vals = vals.astype("datetime64[D]")
    elif isinstance(col.dtype, T.TimestampType):
        vals = vals.astype("datetime64[us]")
    return pa.array(vals, type=T.to_arrow(col.dtype), mask=mask)


def to_arrow(batch: ColumnarBatch, names: Optional[Sequence[str]] = None):
    """Device ColumnarBatch -> pyarrow Table. The live rows are selected on
    the device and only they are downloaded; callers compact large sparse
    batches on the device first (session.collect)."""
    import pyarrow as pa
    n = int(batch.num_rows)
    if batch.row_mask is not None:
        idx = torch.nonzero(batch.row_mask).flatten()
        n = int(idx.shape[0])
    else:
        idx = torch.arange(n, device=batch.device) if batch.columns \
            else None
    arrays, fields = [], []
    for i, col in enumerate(batch.columns):
        name = names[i] if names else f"c{i}"
        valid = None if col.validity is None else _host(col.validity[idx])
        arrays.append(_column_rows_arrow(col, idx, valid))
        fields.append(pa.field(name, T.to_arrow(col.dtype)))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
