"""Still-encoded Parquet column chunks, extracted on the host for decode on
the card.

Counterpart of ``spark_rapids_tpu/io/encoded.py``: the host half of a
GPU Parquet reader. The host keeps the control plane (footer metadata,
thrift compact page headers, page decompression through ``pa.Codec``),
which is small, branchy and byte-serial; everything of size O(rows)
stays encoded and goes up to the card, where ``ops/decode.py`` expands
it.

- RLE/bit-packed hybrid streams become run tables: per run its output
  start, length, RLE value or bit-pool offset, and bit width, at a host
  cost of O(runs). The card expands them with a searchsorted and the
  bitslice kernel.
- DELTA_BINARY_PACKED pages become a per-page stream table and a global
  miniblock table over one bit pool; the card decodes them with a cumsum
  that restarts at each page.
- A column outside the supported set falls back to pyarrow on the host,
  per column, with its reason (``HostEncodedBatch.fallback``); one batch
  mixes device-decoded and host-decoded columns.

Supported: flat required or optional columns (max definition level <= 1,
no repetition) of INT32/INT64/FLOAT/DOUBLE/BOOLEAN physical type under
PLAIN, PLAIN_DICTIONARY/RLE_DICTIONARY, RLE (booleans) and
DELTA_BINARY_PACKED, in data page v1. Strings, decimals, INT96, nested
columns, data page v2 and unknown codecs fall back.

The planes are numpy arrays until ``upload`` moves them to a device. The
row count and the non-null count of each column stay host ints, so the
decode needs no device-to-host read.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    bucket_pool_bytes, bucket_rows, round_capacity, to_device,
)

# -- parquet wire enums -----------------------------------------------------

PAGE_DATA = 0
PAGE_DICT = 2
PAGE_DATA_V2 = 3

ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_DELTA_BINARY_PACKED = 5
ENC_RLE_DICTIONARY = 8

_ENC_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
              5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
              7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
              9: "BYTE_STREAM_SPLIT"}

#: physical type -> (bytes per value, raw little-endian numpy dtype)
_PHYS = {"INT32": (4, np.dtype("<i4")), "INT64": (8, np.dtype("<i8")),
         "FLOAT": (4, np.dtype("<f4")), "DOUBLE": (8, np.dtype("<f8")),
         "BOOLEAN": (0, np.dtype(np.bool_))}

#: int32 sentinel padding run-table cum planes so searchsorted never
#: lands a live row in the padded tail
_CUM_SENTINEL = np.int32(2**31 - 1)


class Unsupported(Exception):
    """This column cannot take the device-decode path; the message is the
    per-column fallback reason."""


# ---------------------------------------------------------------------------
# Thrift compact protocol (PageHeader lives outside the pyarrow API surface:
# the footer tells us where a chunk STARTS, but page boundaries/encodings
# are only in the per-page headers, hand-parsed here)
# ---------------------------------------------------------------------------

class _Compact:
    """Minimal thrift compact-protocol struct reader over a memoryview."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise Unsupported("malformed thrift varint")

    def zigzag(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def _value(self, wtype: int):
        if wtype == 1:
            return True
        if wtype == 2:
            return False
        if wtype == 3:  # single signed byte
            v = self._byte()
            return v - 256 if v >= 128 else v
        if wtype in (4, 5, 6):  # i16/i32/i64: zigzag varints
            return self.zigzag()
        if wtype == 7:  # double: 8 LE bytes
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if wtype == 8:  # binary: length-prefixed bytes
            n = self.uvarint()
            v = bytes(self.buf[self.pos: self.pos + n])
            self.pos += n
            return v
        if wtype in (9, 10):
            return self._list()
        if wtype == 11:
            return self._map()
        if wtype == 12:
            return self.read_struct()
        raise Unsupported(f"thrift compact wire type {wtype}")

    def _list(self):
        h = self._byte()
        n = h >> 4
        et = h & 0x0F
        if n == 15:
            n = self.uvarint()
        if et in (1, 2):  # bools are one byte each inside containers
            out = [self._byte() == 1 for _ in range(n)]
        else:
            out = [self._value(et) for _ in range(n)]
        return out

    def _map(self):
        n = self.uvarint()
        if n == 0:
            return {}
        kv = self._byte()
        kt, vt = kv >> 4, kv & 0x0F
        return {self._value(kt): self._value(vt) for _ in range(n)}

    def read_struct(self) -> Dict[int, object]:
        fields: Dict[int, object] = {}
        fid = 0
        while True:
            h = self._byte()
            if h == 0:
                return fields
            delta = h >> 4
            wtype = h & 0x0F
            fid = fid + delta if delta else self.zigzag()
            fields[fid] = self._value(wtype)


class _PageHeader:
    __slots__ = ("type", "uncompressed", "compressed", "num_values",
                 "encoding", "def_encoding", "end")


def _read_page_header(view, pos: int) -> _PageHeader:
    rd = _Compact(view, pos)
    f = rd.read_struct()
    ph = _PageHeader()
    ph.type = f.get(1)
    ph.uncompressed = f.get(2)
    ph.compressed = f.get(3)
    ph.end = rd.pos  # first byte of the page payload
    ph.num_values = None
    ph.encoding = None
    ph.def_encoding = None
    if ph.type == PAGE_DATA and isinstance(f.get(5), dict):
        hdr = f[5]
        ph.num_values = hdr.get(1)
        ph.encoding = hdr.get(2)
        ph.def_encoding = hdr.get(3)
    elif ph.type == PAGE_DICT and isinstance(f.get(7), dict):
        hdr = f[7]
        ph.num_values = hdr.get(1)
        ph.encoding = hdr.get(2)
    if ph.type is None or ph.compressed is None:
        raise Unsupported("malformed page header")
    return ph


def _uvarint(view, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = view[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise Unsupported("malformed varint")


def _svarint(view, pos: int) -> Tuple[int, int]:
    v, pos = _uvarint(view, pos)
    return (v >> 1) ^ -(v & 1), pos


# ---------------------------------------------------------------------------
# Host-side run/stream accumulators (cost O(#runs), never O(#values))
# ---------------------------------------------------------------------------

class _Runs:
    """One RLE/bit-packed hybrid stream as a run table + shared bit pool.
    Coalescing row groups/pages is concatenation with offset bumps."""

    __slots__ = ("start", "length", "value", "base", "width", "packed",
                 "bitbase", "pool", "total")

    def __init__(self):
        self.start: List[int] = []
        self.length: List[int] = []
        self.value: List[int] = []
        self.base: List[int] = []
        self.width: List[int] = []
        self.packed: List[bool] = []
        self.bitbase: List[int] = []
        self.pool = bytearray()
        self.total = 0  # values encoded so far == next output offset

    def add_rle(self, n: int, value: int, width: int, base: int) -> None:
        self.start.append(self.total)
        self.length.append(n)
        self.value.append(value)
        self.base.append(base)
        self.width.append(width)
        self.packed.append(False)
        self.bitbase.append(0)
        self.total += n

    def add_packed(self, n: int, data, width: int, base: int) -> None:
        self.start.append(self.total)
        self.length.append(n)
        self.value.append(0)
        self.base.append(base)
        self.width.append(width)
        self.packed.append(True)
        self.bitbase.append(len(self.pool) * 8)
        self.pool += data
        self.total += n


def _parse_hybrid(view, pos: int, end: int, width: int, count: int,
                  runs: _Runs, base: int = 0) -> int:
    """Consume `count` values of one RLE/bit-packed hybrid stream starting
    at `pos`; returns the position after the consumed bytes."""
    if width == 0:
        # width-0 streams carry no bytes: every value is 0
        if count:
            runs.add_rle(count, 0, 0, base)
        return pos
    if width > 32:
        raise Unsupported(f"RLE bit width {width} > 32")
    remaining = count
    vbytes = (width + 7) // 8
    while remaining > 0:
        if pos >= end:
            raise Unsupported("truncated RLE/bit-packed stream")
        header, pos = _uvarint(view, pos)
        if header & 1:  # bit-packed groups of 8 values
            groups = header >> 1
            nbytes = groups * width
            if pos + nbytes > end:
                raise Unsupported("truncated bit-packed run")
            n = min(groups * 8, remaining)
            runs.add_packed(n, view[pos: pos + nbytes], width, base)
            pos += nbytes
        else:  # RLE run
            run = header >> 1
            if run <= 0:
                raise Unsupported("zero-length RLE run")
            if pos + vbytes > end:
                raise Unsupported("truncated RLE run value")
            v = int.from_bytes(view[pos: pos + vbytes], "little")
            pos += vbytes
            n = min(run, remaining)
            runs.add_rle(n, v, width, base)
        remaining -= n
    return pos


def _valid_count(view, start: int, end: int, count: int) -> Tuple[_Runs, int]:
    """Parse a definition-level hybrid (width 1) and return (runs,
    non-null count). The popcount is the one O(values/8) host touch —
    needed because data page v1 headers do not carry a null count and the
    value stream length depends on it."""
    runs = _Runs()
    _parse_hybrid(view, start, end, 1, count, runs)
    nnz = 0
    for i in range(len(runs.start)):
        if runs.packed[i]:
            b0 = runs.bitbase[i] // 8
            nbits = runs.length[i]
            chunk = np.frombuffer(runs.pool, np.uint8,
                                  count=(nbits + 7) // 8, offset=b0)
            nnz += int(np.unpackbits(chunk, bitorder="little")[:nbits].sum())
        elif runs.value[i] == 1:
            nnz += runs.length[i]
    return runs, nnz


class _Delta:
    """DELTA_BINARY_PACKED streams: per-stream (page) header records plus
    a global miniblock table. Each page is an independent delta sequence
    (its own first value); the device restarts the cumulative sum at
    stream boundaries, so multi-page and coalesced multi-group chunks
    decode in one pass."""

    __slots__ = ("s_start", "s_count", "s_first", "s_mbbase",
                 "mb_width", "mb_bitbase", "mb_min", "pool", "vpm", "total")

    def __init__(self):
        self.s_start: List[int] = []
        self.s_count: List[int] = []
        self.s_first: List[int] = []
        self.s_mbbase: List[int] = []
        self.mb_width: List[int] = []
        self.mb_bitbase: List[int] = []
        self.mb_min: List[int] = []
        self.pool = bytearray()
        self.vpm: Optional[int] = None
        self.total = 0


def _parse_delta(view, pos: int, end: int, expected: int, dl: _Delta,
                 max_bits: int) -> None:
    """One DELTA_BINARY_PACKED page payload -> one stream record."""
    block, pos = _uvarint(view, pos)
    mbs, pos = _uvarint(view, pos)
    total, pos = _uvarint(view, pos)
    first, pos = _svarint(view, pos)
    if mbs <= 0 or block % mbs:
        raise Unsupported("malformed delta header")
    vpm = block // mbs
    if dl.vpm is None:
        dl.vpm = vpm
    elif dl.vpm != vpm:
        raise Unsupported("delta miniblock size varies across pages")
    if total != expected:
        raise Unsupported("delta stream count mismatch")
    dl.s_start.append(dl.total)
    dl.s_count.append(total)
    dl.s_first.append(first)
    dl.s_mbbase.append(len(dl.mb_width))
    dl.total += total
    remaining = total - 1 if total > 0 else 0
    while remaining > 0:
        if pos >= end:
            raise Unsupported("truncated delta stream")
        mind, pos = _svarint(view, pos)
        widths = bytes(view[pos: pos + mbs])
        if len(widths) < mbs:
            raise Unsupported("truncated delta bit widths")
        pos += mbs
        for w in widths:
            if remaining <= 0:
                break  # trailing miniblocks of the last block are omitted
            if w > max_bits or w > 32:
                raise Unsupported(f"delta bit width {w} > {min(max_bits, 32)}")
            nbytes = vpm * w // 8
            if pos + nbytes > end:
                raise Unsupported("truncated delta miniblock")
            dl.mb_width.append(w)
            dl.mb_bitbase.append(len(dl.pool) * 8)
            dl.mb_min.append(mind)
            dl.pool += view[pos: pos + nbytes]
            pos += nbytes
            remaining -= min(vpm, remaining)


# ---------------------------------------------------------------------------
# Encoded columns and batches
# ---------------------------------------------------------------------------

class EncodedColumn:
    """One column's still-encoded planes and its decode recipe.

    kind:
      - "dict":  run table + bit pool of dictionary codes, and the
                 PLAIN-decoded vocabulary plane the codes gather through
      - "plain": raw little-endian value bytes of the non-null values
      - "bool":  bit-packed booleans as a run table (PLAIN booleans are
                 one packed run per page; RLE booleans map one to one)
      - "delta": DELTA_BINARY_PACKED stream and miniblock tables + bit pool
      - "decoded": host-decoded fallback, a ready ColumnVector in ``cv``
    planes: name -> numpy array (host) or tensor (after ``upload``); see
    ops/decode.py for the decode. Planes prefixed "d_" hold the
    definition-level run table; absent means no nulls. meta is the
    static recipe ((key, value) pairs: vcap, w, vpm, nulls). nnz is the
    host count of non-null values; bounds the host-side (min, max) footer
    statistics of an integer column, carried onto ColumnVector.bounds.
    """

    __slots__ = ("kind", "dtype", "planes", "meta", "cv", "bounds", "nnz")

    def __init__(self, kind: str, dtype, planes: Dict[str, object],
                 meta: Tuple = (), cv=None, bounds=None, nnz: int = 0):
        self.kind = kind
        self.dtype = dtype
        self.planes = planes
        self.meta = meta
        self.cv = cv
        self.bounds = bounds
        self.nnz = nnz

    def device_memory_size(self) -> int:
        if self.kind == "decoded":
            return self.cv.device_memory_size()
        return sum(int(a.nbytes) for a in self.planes.values())

    def decoded_size(self, cap: int) -> int:
        """Bytes the decode materializes for this column at row capacity
        ``cap`` (decodedBytes, beside encodedBytes: what crossed the
        host-to-device link)."""
        if self.kind == "decoded":
            return self.cv.device_memory_size()
        item = 1 if isinstance(self.dtype, T.BooleanType) \
            else np.dtype(self.dtype.np_dtype).itemsize
        has_nulls = bool(dict(self.meta).get("nulls"))
        return cap * item + (cap if has_nulls else 0)


class EncodedBatch:
    """Encoded columns covering the same ``num_rows`` rows (a host int) at
    row capacity ``cap``; ``groups`` are the file's row groups it holds."""

    __slots__ = ("columns", "num_rows", "cap", "groups")

    def __init__(self, columns: List[EncodedColumn], num_rows: int,
                 cap: int, groups: Sequence[int] = ()):
        self.columns = columns
        self.num_rows = num_rows
        self.cap = cap
        self.groups = list(groups)

    @property
    def capacity(self) -> int:
        return self.cap

    def device_memory_size(self) -> int:
        return sum(c.device_memory_size() for c in self.columns)

    def decoded_size(self) -> int:
        return sum(c.decoded_size(self.cap) for c in self.columns)


# ---------------------------------------------------------------------------
# Plane assembly: host accumulators -> bucket-padded numpy planes
# ---------------------------------------------------------------------------

def _pad32(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _pool_plane(pool: bytearray) -> np.ndarray:
    cap = bucket_pool_bytes(len(pool))
    out = np.zeros(cap, np.uint8)
    out[: len(pool)] = np.frombuffer(pool, np.uint8)
    return out


def _run_planes(runs: _Runs, prefix: str = "",
                with_width: bool = True) -> Dict[str, np.ndarray]:
    s = len(runs.start)
    # s + 1: at least one sentinel slot so positions past the encoded
    # total always land on a zero pad run, never a live run's tail
    cap = bucket_rows(s + 1, 8)
    cum = np.cumsum(np.asarray(runs.length, np.int64)).astype(np.int32) \
        if s else np.zeros(0, np.int32)
    planes = {
        prefix + "cum": _pad32(cum, cap, _CUM_SENTINEL),
        prefix + "start": _pad32(np.asarray(runs.start, np.int32), cap),
        prefix + "val": _pad32(np.asarray(runs.value, np.int32), cap),
        prefix + "packed": _pad32(np.asarray(runs.packed, np.bool_), cap,
                                  False),
        prefix + "bitbase": _pad32(np.asarray(runs.bitbase, np.int64), cap),
        prefix + "pool": _pool_plane(runs.pool),
    }
    if with_width:
        planes[prefix + "width"] = _pad32(
            np.asarray(runs.width, np.int32), cap)
        planes[prefix + "base"] = _pad32(
            np.asarray(runs.base, np.int32), cap)
    return planes


def _delta_planes(dl: _Delta) -> Dict[str, np.ndarray]:
    s = len(dl.s_start)
    scap = bucket_rows(s + 1, 8)  # ensure a sentinel slot
    m = len(dl.mb_width)
    mcap = bucket_rows(m + 1, 8)
    cum = np.cumsum(np.asarray(dl.s_count, np.int64)).astype(np.int32) \
        if s else np.zeros(0, np.int32)
    return {
        "s_cum": _pad32(cum, scap, _CUM_SENTINEL),
        "s_start": _pad32(np.asarray(dl.s_start, np.int32), scap),
        "s_first": _pad32(np.asarray(dl.s_first, np.int64), scap),
        "s_mbbase": _pad32(np.asarray(dl.s_mbbase, np.int32), scap),
        "mb_width": _pad32(np.asarray(dl.mb_width, np.int32), mcap),
        "mb_bitbase": _pad32(np.asarray(dl.mb_bitbase, np.int64), mcap),
        "mb_min": _pad32(np.asarray(dl.mb_min, np.int64), mcap),
        "pool": _pool_plane(dl.pool),
    }


# ---------------------------------------------------------------------------
# Per-column chunk extraction
# ---------------------------------------------------------------------------

#: engine types eligible for device decode
_SUPPORTED_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type,
                    T.Float32Type, T.Float64Type, T.BooleanType,
                    T.DateType, T.TimestampType)


def _codec(name: str):
    import pyarrow as pa
    name = (name or "UNCOMPRESSED").upper()
    if name == "UNCOMPRESSED":
        return None
    try:
        codec = pa.Codec(name.lower())
    except Exception as ex:  # noqa: BLE001 - unknown/unbuilt codec
        raise Unsupported(f"codec {name} unavailable: {ex}")
    return codec


def check_column_static(schema_col, col_md, dtype) -> None:
    """Static (footer-only) support screen; raises Unsupported with the
    fallback reason. Page-level surprises are caught later, per chunk."""
    if not isinstance(dtype, _SUPPORTED_TYPES):
        raise Unsupported(f"type {type(dtype).__name__} not device-decodable")
    if schema_col.max_repetition_level != 0:
        raise Unsupported("repeated (nested) column")
    if schema_col.max_definition_level > 1:
        raise Unsupported(
            f"max_definition_level {schema_col.max_definition_level} > 1")
    phys = str(col_md.physical_type).upper()
    if phys not in _PHYS:
        raise Unsupported(f"physical type {phys} not device-decodable")
    if isinstance(dtype, T.TimestampType):
        lt = str(getattr(schema_col, "logical_type", "")).upper()
        if "TIMESTAMP" in lt and "MICROS" not in lt:
            raise Unsupported(f"timestamp unit not micros ({lt})")
    _codec(str(col_md.compression))


class _ColumnBuilder:
    """Accumulates ONE logical column's encoded planes across the row
    groups coalesced into a batch."""

    def __init__(self, name: str, dtype, max_def: int, max_bits: int,
                 delta_enabled: bool):
        self.name = name
        self.dtype = dtype
        self.max_def = max_def
        self.max_bits = max_bits
        self.delta_enabled = delta_enabled
        self.kind: Optional[str] = None
        self.runs = _Runs()         # dict codes / bool bits
        self.delta = _Delta()
        self.plain = bytearray()    # PLAIN fixed-width value bytes
        self.dlv = _Runs()          # definition-level runs (width 1)
        self.has_nulls = False
        self.vocab: List[np.ndarray] = []
        self.vocab_size = 0
        self.nnz = 0
        self.rows = 0
        self.phys_width = 0
        self.bounds: Optional[Tuple[int, int]] = None

    def _set_kind(self, kind: str) -> None:
        if self.kind is None:
            self.kind = kind
        elif self.kind != kind:
            raise Unsupported(
                f"mixed encodings across pages ({self.kind} vs {kind})")

    def _merge_bounds(self, st) -> None:
        if st is None or not st.has_min_max:
            self.bounds = None
            return
        if not isinstance(self.dtype, (T.Int8Type, T.Int16Type, T.Int32Type,
                                       T.Int64Type, T.DateType)):
            self.bounds = None
            return
        if self.rows == 0 or self.bounds is not None:
            try:
                lo, hi = int(st.min), int(st.max)
            except (TypeError, ValueError):
                self.bounds = None
                return
            if self.rows == 0:
                self.bounds = (lo, hi)
            else:
                self.bounds = (min(self.bounds[0], lo),
                               max(self.bounds[1], hi))

    def add_group(self, raw: memoryview, col_md, phys_width: int,
                  raw_dtype: np.dtype) -> None:
        """Parse one row group's column chunk (raw = the chunk's bytes,
        page headers + compressed payloads)."""
        codec = _codec(str(col_md.compression))
        self.phys_width = phys_width
        self._merge_bounds(col_md.statistics)
        group_rows = 0
        vocab_base = self.vocab_size
        saw_dict = False
        pos = 0
        expect = col_md.num_values
        while group_rows < expect:
            ph = _read_page_header(raw, pos)
            payload = raw[ph.end: ph.end + ph.compressed]
            pos = ph.end + ph.compressed
            if ph.type == PAGE_DATA_V2:
                raise Unsupported("data page v2")
            if ph.type not in (PAGE_DATA, PAGE_DICT):
                continue  # index pages etc: skip
            if codec is not None:
                payload = memoryview(
                    codec.decompress(payload, ph.uncompressed))
            if ph.type == PAGE_DICT:
                if ph.encoding not in (ENC_PLAIN, ENC_PLAIN_DICTIONARY):
                    raise Unsupported(
                        "dictionary page encoding "
                        f"{_ENC_NAMES.get(ph.encoding, ph.encoding)}")
                if phys_width == 0:
                    raise Unsupported("dictionary-encoded booleans")
                want = ph.num_values * phys_width
                if len(payload) < want:
                    raise Unsupported("truncated dictionary page")
                self.vocab.append(np.frombuffer(
                    payload, raw_dtype, count=ph.num_values))
                self.vocab_size += ph.num_values
                saw_dict = True
                continue
            group_rows += ph.num_values
            self._add_data_page(payload, ph, phys_width, vocab_base,
                                saw_dict)
        self.rows += group_rows

    def _add_data_page(self, payload, ph: _PageHeader, phys_width: int,
                       vocab_base: int, saw_dict: bool) -> None:
        end = len(payload)
        pos = 0
        count = ph.num_values
        nnz = count
        if self.max_def:
            if ph.def_encoding != ENC_RLE:
                raise Unsupported(
                    "definition-level encoding "
                    f"{_ENC_NAMES.get(ph.def_encoding, ph.def_encoding)}")
            dl_len = int.from_bytes(payload[pos: pos + 4], "little")
            dl_runs, nnz = _valid_count(payload, pos + 4, pos + 4 + dl_len,
                                        count)
            pos += 4 + dl_len
            if nnz < count:
                self.has_nulls = True
            # splice the page's def runs onto the batch-wide stream
            for i in range(len(dl_runs.start)):
                if dl_runs.packed[i]:
                    b0 = dl_runs.bitbase[i] // 8
                    nbytes = (dl_runs.length[i] + 7) // 8
                    self.dlv.add_packed(
                        dl_runs.length[i],
                        dl_runs.pool[b0: b0 + nbytes], 1, 0)
                else:
                    self.dlv.add_rle(dl_runs.length[i], dl_runs.value[i],
                                     1, 0)
        enc = ph.encoding
        if enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
            if not saw_dict:
                raise Unsupported("dictionary-encoded page without a "
                                  "dictionary page")
            self._set_kind("dict")
            width = payload[pos] if pos < end else 0
            if width > self.max_bits or width > 32:
                raise Unsupported(f"dictionary bit width {width} > "
                                  f"{min(self.max_bits, 32)}")
            _parse_hybrid(payload, pos + 1, end, width, nnz, self.runs,
                          base=vocab_base)
        elif enc == ENC_PLAIN and phys_width == 0:  # booleans: LSB packed
            self._set_kind("bool")
            nbytes = (nnz + 7) // 8
            if end - pos < nbytes:
                raise Unsupported("truncated boolean page")
            self.runs.add_packed(nnz, payload[pos: pos + nbytes], 1, 0)
        elif enc == ENC_RLE and phys_width == 0:
            self._set_kind("bool")
            rl_len = int.from_bytes(payload[pos: pos + 4], "little")
            _parse_hybrid(payload, pos + 4, pos + 4 + rl_len, 1, nnz,
                          self.runs)
        elif enc == ENC_PLAIN:
            self._set_kind("plain")
            want = nnz * phys_width
            if end - pos < want:
                raise Unsupported("truncated PLAIN page")
            self.plain += payload[pos: pos + want]
        elif enc == ENC_DELTA_BINARY_PACKED:
            if not self.delta_enabled:
                raise Unsupported("DELTA_BINARY_PACKED disabled by "
                                  "spark.rapids.sql.decode.device.delta."
                                  "enabled")
            self._set_kind("delta")
            _parse_delta(payload, pos, end, nnz, self.delta, self.max_bits)
        else:
            raise Unsupported(
                f"encoding {_ENC_NAMES.get(enc, enc)} not device-decodable")
        self.nnz += nnz

    def finish(self, n_rows: int, cap: int) -> EncodedColumn:
        """Assemble the bucket-padded numpy planes for `n_rows` rows at
        row capacity `cap` (the decoded batch's capacity bucket)."""
        if self.kind is None:
            raise Unsupported("no data pages seen")
        if self.rows != n_rows:
            raise Unsupported(
                f"value count mismatch ({self.rows} != {n_rows})")
        if not self.has_nulls and self.nnz != n_rows:
            raise Unsupported(
                f"value/row count mismatch ({self.nnz} != {n_rows})")
        meta: List[Tuple[str, object]] = []
        # without nulls the value stream IS the row stream: expand it at
        # the row capacity so decode is a pure gather with no placement
        # pass; with nulls it gets its own (smaller) bucket
        vcap = cap if not self.has_nulls \
            else bucket_rows(max(self.nnz, 1), 8)
        meta.append(("vcap", vcap))
        if self.kind == "plain":
            w = self.phys_width or 4
            pool = np.zeros(vcap * w, np.uint8)
            pool[: len(self.plain)] = np.frombuffer(self.plain, np.uint8)
            planes: Dict[str, np.ndarray] = {"pool": pool}
            meta.append(("w", w))
        elif self.kind == "bool":
            planes = _run_planes(self.runs, with_width=False)
        elif self.kind == "dict":
            planes = _run_planes(self.runs)
            raw_dtype = self.vocab[0].dtype if self.vocab else np.dtype("<i4")
            vocab = (np.concatenate(self.vocab) if len(self.vocab) > 1
                     else (self.vocab[0] if self.vocab
                           else np.zeros(0, raw_dtype)))
            vc = bucket_rows(max(len(vocab), 1), 8)
            planes["vocab"] = _pad32(vocab, vc)
        else:  # delta
            planes = _delta_planes(self.delta)
            meta.append(("vpm", self.delta.vpm))
        if self.has_nulls:
            planes.update(_run_planes(self.dlv, prefix="d_",
                                      with_width=False))
        meta.append(("nulls", self.has_nulls))
        return EncodedColumn(self.kind, self.dtype, planes, tuple(meta),
                             bounds=self.bounds, nnz=self.nnz)


# ---------------------------------------------------------------------------
# File-level extraction
# ---------------------------------------------------------------------------

def _chunk_bytes(f, col_md) -> memoryview:
    start = col_md.data_page_offset
    if col_md.dictionary_page_offset is not None:
        start = min(start, col_md.dictionary_page_offset)
    f.seek(start)
    return memoryview(f.read(col_md.total_compressed_size))


def _leaf_index(metadata, name: str) -> Optional[int]:
    rg0 = metadata.row_group(0)
    for ci in range(rg0.num_columns):
        if rg0.column(ci).path_in_schema == name:
            return ci
    return None


def probe_support(path: str, fields: Sequence[T.StructField]
                  ) -> Dict[str, str]:
    """Static (footer-only) per-column fallback reasons for one file, the
    plan-time view; page-level surprises are caught at execute time."""
    import pyarrow.parquet as pq
    out: Dict[str, str] = {}
    try:
        pf = pq.ParquetFile(path)
        md = pf.metadata
    except Exception as ex:  # noqa: BLE001 - unreadable file: scan raises
        return {f.name: f"footer unreadable: {ex}" for f in fields}
    if md.num_row_groups == 0:
        return {f.name: "file has no row groups" for f in fields}
    for fld in fields:
        ci = _leaf_index(md, fld.name)
        if ci is None:
            out[fld.name] = "column not in file"
            continue
        try:
            check_column_static(pf.schema.column(ci),
                                md.row_group(0).column(ci), fld.dtype)
        except Unsupported as ex:
            out[fld.name] = str(ex)
    return out


class HostEncodedBatch:
    """One coalesced set of row groups before the upload: numpy planes
    and the per-column fallback bookkeeping."""

    __slots__ = ("columns", "num_rows", "cap", "fallback", "encoded_bytes",
                 "groups")

    def __init__(self, columns, num_rows, cap, fallback, encoded_bytes,
                 groups):
        self.columns = columns          # List[EncodedColumn | None]; None
        self.num_rows = num_rows        # = host-decode this column
        self.cap = cap
        self.fallback = fallback        # Dict[name, reason]
        self.encoded_bytes = encoded_bytes
        self.groups = groups            # row-group ids in this batch


def _group_sets(metadata, groups: List[int], batch_rows: int
                ) -> Iterator[List[int]]:
    pending: List[int] = []
    rows = 0
    for g in groups:
        pending.append(g)
        rows += metadata.row_group(g).num_rows
        if rows >= batch_rows:
            yield pending
            pending, rows = [], 0
    if pending:
        yield pending


def read_encoded_batches(path: str, metadata, groups: List[int],
                         fields: Sequence[T.StructField], batch_rows: int,
                         max_bits: int = 32, delta_enabled: bool = True
                         ) -> Iterator[HostEncodedBatch]:
    """Extract the kept row groups of one file as encoded batches.
    ``groups`` is the already-pruned list (io/parquet_pruning.py), so a
    pruned group is never read, let alone uploaded. Columns that cannot
    take the device path come back as None entries with their reason in
    ``fallback``; the caller host-decodes exactly those."""
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path)
    static_reasons: Dict[str, str] = {}
    col_idx: Dict[str, int] = {}
    for fld in fields:
        ci = _leaf_index(metadata, fld.name)
        if ci is None:
            static_reasons[fld.name] = "column not in file"
            continue
        col_idx[fld.name] = ci
        try:
            check_column_static(pf.schema.column(ci),
                                metadata.row_group(groups[0]).column(ci),
                                fld.dtype)
        except Unsupported as ex:
            static_reasons[fld.name] = str(ex)

    with open(path, "rb") as f:
        for gset in _group_sets(metadata, groups, batch_rows):
            n = sum(metadata.row_group(g).num_rows for g in gset)
            cap = round_capacity(n)
            cols: List[Optional[EncodedColumn]] = []
            fallback = dict(static_reasons)
            enc_bytes = 0
            for fld in fields:
                if fld.name in static_reasons:
                    cols.append(None)
                    continue
                ci = col_idx[fld.name]
                sc = pf.schema.column(ci)
                builder = _ColumnBuilder(fld.name, fld.dtype,
                                         sc.max_definition_level,
                                         max_bits, delta_enabled)
                try:
                    for g in gset:
                        cm = metadata.row_group(g).column(ci)
                        phys_width, raw_dtype = _PHYS[
                            str(cm.physical_type).upper()]
                        builder.add_group(_chunk_bytes(f, cm), cm,
                                          phys_width, raw_dtype)
                    ec = builder.finish(n, cap)
                except Unsupported as ex:
                    fallback[fld.name] = str(ex)
                    cols.append(None)
                    continue
                enc_bytes += ec.device_memory_size()
                cols.append(ec)
            yield HostEncodedBatch(cols, n, cap, fallback, enc_bytes, gset)


def upload(hb: HostEncodedBatch, decoded_cols: Dict[int, object],
           device) -> EncodedBatch:
    """Numpy planes -> tensors on ``device`` (the host-to-device
    boundary). ``decoded_cols`` maps column index -> host-decoded
    ColumnVector for the fallback columns. On the card each plane is a
    non-blocking copy from pinned memory (``columnar/batch.to_device``);
    on the CPU the tensors share the numpy planes' memory, so the decode
    never writes a plane."""
    device = torch.device(device)
    out: List[EncodedColumn] = []
    for i, c in enumerate(hb.columns):
        if c is None:
            cv = decoded_cols[i]
            out.append(EncodedColumn("decoded", cv.dtype, {}, (), cv=cv,
                                     bounds=cv.bounds))
            continue
        planes = {k: to_device(torch.from_numpy(v), device)
                  for k, v in c.planes.items()}
        out.append(EncodedColumn(c.kind, c.dtype, planes, c.meta,
                                 bounds=c.bounds, nnz=c.nnz))
    return EncodedBatch(out, hb.num_rows, hb.cap, hb.groups)
