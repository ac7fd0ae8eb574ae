"""Columnar batch <-> wire bytes: the kudo wire format (counterpart of
``spark_rapids_tpu/shuffle/serde.py``, byte for byte the same format).

Reference parity: GpuColumnarBatchSerializer.scala:132 (kudo wire format
via jni.kudo.KudoSerializer) + TableCompressionCodec. Frame assembly and
parsing and the frame's xxhash64 run in host C++ (``csrc/kudo.cpp``,
built by ``ops/_build.load``; a library that fails to build or load
raises ``KernelError``, where the JAX package falls back to Python
quietly). The pure-Python packer below (``_py_pack_frame``,
``_py_xxhash64``, ``_py_unpack_frame``) is the packer's plain version,
which the tests hold byte for byte against it. Compression wraps the
whole frame: 1 codec byte + codec payload ('none' | 'zstd' | 'zlib', the
spark.rapids.shuffle.compression.codec conf).

Planes are TRIMMED to live sizes on the wire (capacity padding never
ships) and re-padded to this engine's capacity buckets on read, so a
blob written by either package reads in the other. A masked batch is
compacted before it ships.

Integrity: the wire header carries a CRC32 over the codec byte + the
(possibly compressed) payload, verified on read before decompression, so
corruption anywhere in the blob raises ShuffleCorruptionError; the frame
body keeps its xxhash64 as a second, codec-independent check. Readers
(``exec/nodes._LazyShuffleBlobs``) re-fetch a failing blob from the
shuffle store once before surfacing the error.

The write is split for the serialized exchange: ``describe_batch``
downloads a sub-batch's trimmed planes on the thread that partitions (one
synchronization a sub-batch, into pinned staging buffers), ``pack``
builds, compresses and checksums the frame on the host pool (zlib and
the C packer release the interpreter lock). The read is split the same
way: ``deserialize_host`` verifies, decompresses, parses and pads the
planes into writable (pinned, when the target is the card) host tensors
on the host pool, and ``upload`` moves them on the consuming thread.
``pack`` and ``deserialize_host`` run inside DEBUG-level trace spans
(shuffle.serialize, shuffle.deserialize), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, map_planes, round_capacity,
)
from spark_rapids_tpu_torch.runtime import trace

_MAGIC = 0x54505544554B4F31
_VERSION = 1

CODEC_NONE = 0
CODEC_ZSTD = 1
CODEC_ZLIB = 2
_CODEC_NAMES = {"none": CODEC_NONE, "zstd": CODEC_ZSTD, "zlib": CODEC_ZLIB}

#: wire layout: [codec byte][CRC32 LE u32 over codec byte + payload][payload]
_WIRE_HEADER = 5


class ShuffleCorruptionError(ValueError):
    """A shuffle blob failed integrity verification (wire CRC or frame
    checksum). Readers catch this type to drive the one-shot re-fetch."""


_AUTO_CODEC: Optional[str] = None


def resolve_codec(name: str) -> str:
    """The codec a conf value names: 'auto' is zstd when the zstandard
    package imports, else zlib (probed once)."""
    global _AUTO_CODEC
    key = (name or "none").lower()
    if key != "auto":
        return key
    if _AUTO_CODEC is None:
        try:
            import zstandard  # noqa: F401
            _AUTO_CODEC = "zstd"
        except ImportError:
            _AUTO_CODEC = "zlib"
    return _AUTO_CODEC


def codec_id(name: str) -> int:
    key = resolve_codec(name)
    if key == "lz4":
        raise ValueError(
            "shuffle codec 'lz4' is unavailable in this build; use 'zstd', "
            "'zlib', or 'none' (spark.rapids.shuffle.compression.codec)")
    if key not in _CODEC_NAMES:
        raise ValueError(f"unknown shuffle codec {name!r}")
    if key == "zstd":
        try:  # fail fast here, not mid-serialization on a writer thread
            import zstandard  # noqa: F401
        except ImportError as e:
            raise ValueError(
                "shuffle codec 'zstd' needs the zstandard package; use "
                "'zlib' or 'none'") from e
    return _CODEC_NAMES[key]


# ---------------------------------------------------------------------------
# dtype <-> json
# ---------------------------------------------------------------------------

def dtype_to_json(dt: T.DataType):
    if isinstance(dt, T.DecimalType):
        return {"t": "decimal", "p": dt.precision, "s": dt.scale}
    if isinstance(dt, T.ArrayType):
        return {"t": "array", "e": dtype_to_json(dt.element)}
    if isinstance(dt, T.MapType):
        return {"t": "map", "k": dtype_to_json(dt.key),
                "v": dtype_to_json(dt.value)}
    if isinstance(dt, T.StructType):
        return {"t": "struct",
                "f": [[f.name, dtype_to_json(f.dtype)] for f in dt.fields]}
    return {"t": type(dt).__name__}


_SIMPLE = {cls.__name__: cls() for cls in
           (T.NullType, T.BooleanType, T.Int8Type, T.Int16Type, T.Int32Type,
            T.Int64Type, T.Float32Type, T.Float64Type, T.StringType,
            T.DateType, T.TimestampType)}


def dtype_from_json(d) -> T.DataType:
    t = d["t"]
    if t == "decimal":
        return T.DecimalType(d["p"], d["s"])
    if t == "array":
        return T.ArrayType(dtype_from_json(d["e"]))
    if t == "map":
        return T.MapType(dtype_from_json(d["k"]), dtype_from_json(d["v"]))
    if t == "struct":
        return T.StructType(tuple(T.StructField(n, dtype_from_json(x))
                                  for n, x in d["f"]))
    return _SIMPLE[t]


# ---------------------------------------------------------------------------
# column <-> (descriptor, planes)
# ---------------------------------------------------------------------------

def _last(off: torch.Tensor) -> int:
    return int(off[-1]) if off.numel() else 0


def _describe_column(col: ColumnVector, n: int,
                     planes: List[torch.Tensor]):
    """Append the column's planes, trimmed to live sizes, to ``planes``
    (tensors where the column lives); return a json-able descriptor. A
    string, array or map column reads its last offset (one host read)."""
    def add(t) -> int:
        planes.append(t)
        return len(planes) - 1

    valid_idx = None
    if col.validity is not None:
        valid_idx = add(col.validity[:n])
    d: Dict = {"dtype": dtype_to_json(col.dtype), "valid": valid_idx}
    if col.is_dict:
        d["kind"] = "dict"
        d["unique"] = bool(col.dict_unique)
        d["planes"] = [add(col.data["codes"][:n]),
                       add(col.data["dict_offsets"]),
                       add(col.data["dict_bytes"])]
    elif isinstance(col.dtype, T.StringType):
        off = col.data["offsets"][: n + 1]
        d["kind"] = "str"
        d["planes"] = [add(off), add(col.data["bytes"][:_last(off)])]
    elif isinstance(col.dtype, T.ArrayType):
        off = col.data["offsets"][: n + 1]
        d["kind"] = "array"
        d["planes"] = [add(off)]
        d["child"] = _describe_column(col.data["child"], _last(off), planes)
    elif isinstance(col.dtype, T.MapType):
        off = col.data["offsets"][: n + 1]
        n_el = _last(off)
        d["kind"] = "map"
        d["planes"] = [add(off)]
        d["keys"] = _describe_column(col.data["keys"], n_el, planes)
        d["values"] = _describe_column(col.data["values"], n_el, planes)
    elif isinstance(col.dtype, T.StructType):
        d["kind"] = "struct"
        d["planes"] = []
        d["children"] = [_describe_column(ch, n, planes)
                         for ch in col.data["children"]]
    else:
        d["kind"] = "fixed"
        d["planes"] = [add(col.data[:n])]
    return d


def _download(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host numpy copies of the planes: card planes copy into pinned
    staging buffers without blocking, then one synchronization waits for
    all of them; host planes are viewed as they are."""
    staged, stream = [], None
    for t in tensors:
        if t.device.type == "cpu":
            staged.append(t.contiguous())
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        staged.append(h)
        stream = torch.cuda.current_stream(t.device)
    if stream is not None:
        stream.synchronize()
    return [t.numpy() for t in staged]


def describe_batch(batch: ColumnarBatch) -> Tuple[bytes, List[np.ndarray]]:
    """(meta json, host planes) of a batch, its live rows only: a masked
    batch is compacted first. The planes are downloaded here."""
    if batch.row_mask is not None:
        from spark_rapids_tpu_torch.ops import kernels as K
        batch = K.compact_batch(batch)
    n = int(batch.num_rows)
    planes: List[torch.Tensor] = []
    cols = [_describe_column(c, n, planes) for c in batch.columns]
    meta = json.dumps({"n": n, "cols": cols}).encode()
    return meta, _download(planes)


def _plane(buffers, idx, np_dtype) -> np.ndarray:
    return np.frombuffer(buffers[idx], dtype=np_dtype)


def _staging(n: int, np_dtype, pinned: bool) -> torch.Tensor:
    tdt = torch.from_numpy(np.empty(0, np_dtype)).dtype
    return torch.empty(n, dtype=tdt, pin_memory=pinned)


def _pad(arr: np.ndarray, cap: int, pinned: bool, fill=0) -> torch.Tensor:
    """A writable host tensor of ``cap`` rows holding arr, then fill."""
    out = _staging(cap, arr.dtype, pinned)
    view = out.numpy()
    view[: len(arr)] = arr
    view[len(arr):] = fill
    return out


def _offsets(off: np.ndarray, cap: int, pinned: bool) -> torch.Tensor:
    return _pad(off.astype(np.int32, copy=False), cap + 1, pinned,
                fill=off[-1] if len(off) else 0)


def _rebuild_column(d, buffers, n: int, cap: int,
                    pinned: bool) -> ColumnVector:
    dt = dtype_from_json(d["dtype"])
    validity = None
    if d["valid"] is not None:
        validity = _pad(_plane(buffers, d["valid"], np.bool_), cap, pinned,
                        False)
    kind = d["kind"]
    if kind == "dict":
        codes = _pad(_plane(buffers, d["planes"][0], np.int32), cap, pinned)
        doff = _plane(buffers, d["planes"][1], np.int32)
        dby = _plane(buffers, d["planes"][2], np.uint8)
        if not len(dby):
            dby = np.zeros(1, np.uint8)
        return ColumnVector(dt, {"codes": codes,
                                 "dict_offsets": _pad(doff, len(doff),
                                                      pinned),
                                 "dict_bytes": _pad(dby, len(dby), pinned)},
                            validity, dict_unique=bool(d.get("unique", True)))
    if kind == "str":
        off = _plane(buffers, d["planes"][0], np.int32)
        by = _plane(buffers, d["planes"][1], np.uint8)
        bcap = round_capacity(max(len(by), 1), minimum=8)
        return ColumnVector(dt, {"offsets": _offsets(off, cap, pinned),
                                 "bytes": _pad(by, bcap, pinned)}, validity)
    if kind in ("array", "map"):
        off = _plane(buffers, d["planes"][0], np.int32)
        n_el = int(off[-1]) if len(off) else 0
        ccap = round_capacity(max(n_el, 1))
        data = {"offsets": _offsets(off, cap, pinned)}
        if kind == "array":
            data["child"] = _rebuild_column(d["child"], buffers, n_el, ccap,
                                            pinned)
        else:
            data["keys"] = _rebuild_column(d["keys"], buffers, n_el, ccap,
                                           pinned)
            data["values"] = _rebuild_column(d["values"], buffers, n_el,
                                             ccap, pinned)
        return ColumnVector(dt, data, validity)
    if kind == "struct":
        kids = [_rebuild_column(c, buffers, n, cap, pinned)
                for c in d["children"]]
        return ColumnVector(dt, {"children": kids}, validity)
    data = _pad(_plane(buffers, d["planes"][0], np.dtype(dt.np_dtype)), cap,
                pinned)
    return ColumnVector(dt, data, validity)


# ---------------------------------------------------------------------------
# frame pack/unpack: the C packer, and its plain version (same layout)
# ---------------------------------------------------------------------------

_KUDO: Optional[ctypes.CDLL] = None
_KUDO_LOCK = threading.Lock()


def kudo_lib() -> ctypes.CDLL:
    """``csrc/kudo.cpp``, built at first use and loaded; a build or load
    failure raises ``ops/_build.KernelError``."""
    global _KUDO
    if _KUDO is None:
        from spark_rapids_tpu_torch.ops import _build
        with _KUDO_LOCK:
            if _KUDO is None:
                lib = _build.load("kudo")
                u64, u32, i64 = ctypes.c_uint64, ctypes.c_uint32, \
                    ctypes.c_int64
                pu8 = ctypes.POINTER(ctypes.c_uint8)
                lib.kudo_xxhash64.restype = u64
                lib.kudo_xxhash64.argtypes = [pu8, u64, u64]
                lib.kudo_frame_size.restype = u64
                lib.kudo_frame_size.argtypes = [u64, u32,
                                                ctypes.POINTER(u64)]
                lib.kudo_pack.restype = u64
                lib.kudo_pack.argtypes = [pu8, u64, u32, ctypes.POINTER(pu8),
                                          ctypes.POINTER(u64), pu8]
                lib.kudo_unpack.restype = i64
                lib.kudo_unpack.argtypes = [
                    pu8, u64, ctypes.POINTER(u64), ctypes.POINTER(u64),
                    ctypes.POINTER(u32), ctypes.POINTER(u64),
                    ctypes.POINTER(u64), u32, ctypes.c_int32]
                _KUDO = lib
    return _KUDO


def _align8(x: int) -> int:
    return (x + 7) & ~7


def _raw(planes: List[np.ndarray]) -> List[np.ndarray]:
    return [np.ascontiguousarray(p).view(np.uint8).reshape(-1)
            for p in planes]


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _pack_frame(meta: bytes, planes: List[np.ndarray]) -> bytes:
    """The frame of meta + planes, built by the C packer."""
    lib = kudo_lib()
    raw = _raw(planes)
    n = len(raw)
    lens_arr = (ctypes.c_uint64 * n)(*[int(r.nbytes) for r in raw])
    size = lib.kudo_frame_size(len(meta), n, lens_arr)
    out = np.empty(size, np.uint8)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8p(r) for r in raw])
    meta_arr = np.frombuffer(meta or b"\0", np.uint8)
    written = lib.kudo_pack(_u8p(meta_arr), len(meta), n, ptrs, lens_arr,
                            _u8p(out))
    if written != size:
        raise AssertionError(f"kudo_pack wrote {written} of {size} bytes")
    return out.tobytes()


def _py_pack_frame(meta: bytes, planes: List[np.ndarray]) -> bytes:
    """The plain version of ``_pack_frame``: the identical layout in
    Python."""
    raw = _raw(planes)
    lens = [int(r.nbytes) for r in raw]
    parts = [struct.pack("<QII", _MAGIC, _VERSION, len(raw)),
             struct.pack("<Q", len(meta)), meta,
             b"\0" * (_align8(len(meta)) - len(meta))]
    for ln in lens:
        parts.append(struct.pack("<Q", ln))
    for r, ln in zip(raw, lens):
        parts.append(r.tobytes())
        parts.append(b"\0" * (_align8(ln) - ln))
    body = b"".join(parts)
    return body + struct.pack("<Q", _py_xxhash64(body))


def _py_xxhash64(data: bytes, seed: int = 0) -> int:
    """xxhash64 from the spec in Python (the plain version of
    ``kudo_xxhash64``; slow)."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1
    data = bytes(data)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def rnd(acc, inp):
        return (rotl((acc + inp * P2) & M, 31) * P1) & M

    n = len(data)
    p = 0
    if n >= 32:
        v1, v2, v3, v4 = ((seed + P1 + P2) & M, (seed + P2) & M, seed & M,
                          (seed - P1) & M)
        while p + 32 <= n:
            v1 = rnd(v1, int.from_bytes(data[p:p + 8], "little")); p += 8
            v2 = rnd(v2, int.from_bytes(data[p:p + 8], "little")); p += 8
            v3 = rnd(v3, int.from_bytes(data[p:p + 8], "little")); p += 8
            v4 = rnd(v4, int.from_bytes(data[p:p + 8], "little")); p += 8
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            h = ((h ^ rnd(0, v)) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while p + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[p:p + 8], "little")), 27)
             * P1 + P4) & M
        p += 8
    if p + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * P1) & M, 23)
             * P2 + P3) & M
        p += 4
    while p < n:
        h = (rotl(h ^ (data[p] * P5) & M, 11) * P1) & M
        p += 1
    h = ((h ^ (h >> 33)) * P2) & M
    h = ((h ^ (h >> 29)) * P3) & M
    return h ^ (h >> 32)


def _unpack_frame(data, verify: bool = True
                  ) -> Tuple[bytes, List[memoryview]]:
    """(meta, buffers) of a frame, parsed by the C packer; the buffers are
    views into ``data``."""
    lib = kudo_lib()
    mv = memoryview(data).cast("B")
    arr = np.frombuffer(mv, np.uint8)
    # size the descriptor tables from the header's own buffer count,
    # clamped by what the frame could hold (a corrupt header must not
    # trigger a giant allocation)
    hdr_bufs = struct.unpack_from("<I", mv, 12)[0] if len(mv) >= 16 else 0
    max_bufs = max(1, min(hdr_bufs, len(mv) // 8))
    meta_off, meta_len = ctypes.c_uint64(), ctypes.c_uint64()
    n_bufs = ctypes.c_uint32()
    offs = (ctypes.c_uint64 * max_bufs)()
    lens = (ctypes.c_uint64 * max_bufs)()
    rc = lib.kudo_unpack(_u8p(arr), len(mv), ctypes.byref(meta_off),
                         ctypes.byref(meta_len), ctypes.byref(n_bufs), offs,
                         lens, max_bufs, 1 if verify else 0)
    if rc < 0:
        raise ShuffleCorruptionError(f"kudo frame parse failed (code {rc})")
    meta = bytes(mv[meta_off.value: meta_off.value + meta_len.value])
    return meta, [mv[offs[i]: offs[i] + lens[i]]
                  for i in range(n_bufs.value)]


def _py_unpack_frame(data, verify: bool = True
                     ) -> Tuple[bytes, List[memoryview]]:
    """The plain version of ``_unpack_frame``."""
    mv = memoryview(data).cast("B")
    if len(mv) < 32:
        raise ShuffleCorruptionError("truncated kudo frame")
    magic, version, nb = struct.unpack_from("<QII", mv, 0)
    if magic != _MAGIC:
        raise ShuffleCorruptionError("bad kudo magic")
    if version != _VERSION:
        raise ShuffleCorruptionError(f"unsupported kudo version {version}")
    (ml,) = struct.unpack_from("<Q", mv, 16)
    pos = 24
    if ml > len(mv) - pos:
        raise ShuffleCorruptionError("truncated kudo frame")
    meta = bytes(mv[pos: pos + ml])
    pos += _align8(ml)
    if pos + 8 * nb + 8 > len(mv):
        raise ShuffleCorruptionError("truncated kudo frame")
    lens = list(struct.unpack_from(f"<{nb}Q", mv, pos))
    pos += 8 * nb
    bufs = []
    for ln in lens:
        if pos + _align8(ln) + 8 > len(mv):
            raise ShuffleCorruptionError("truncated kudo frame")
        bufs.append(mv[pos: pos + ln])
        pos += _align8(ln)
    if verify:
        (want,) = struct.unpack_from("<Q", mv, pos)
        if _py_xxhash64(mv[:pos]) != want:
            raise ShuffleCorruptionError("kudo frame checksum mismatch")
    return meta, bufs


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def pack(meta: bytes, planes: List[np.ndarray], codec: str = "auto",
         native: bool = True) -> bytes:
    """Wire bytes of a described batch: the frame (the C packer, or its
    plain version with ``native=False``), compressed, behind the codec
    byte and the CRC32."""
    with trace.span("shuffle.serialize", cat="shuffle", level=trace.DEBUG):
        frame = _pack_frame(meta, planes) if native \
            else _py_pack_frame(meta, planes)
        cid = codec_id(codec)
        if cid == CODEC_ZSTD:
            import zstandard
            payload = zstandard.ZstdCompressor(level=1).compress(frame)
        elif cid == CODEC_ZLIB:
            payload = zlib.compress(frame, 1)
        else:
            payload = frame
        head = bytes([cid])
        crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
        return b"".join((head, struct.pack("<I", crc), payload))


def serialize_batch(batch: ColumnarBatch, codec: str = "auto",
                    native: bool = True) -> bytes:
    """Batch -> wire bytes (live rows only)."""
    meta, planes = describe_batch(batch)
    return pack(meta, planes, codec, native)


def deserialize_host(data, verify: bool = True, pinned: bool = False,
                     native: bool = True) -> ColumnarBatch:
    """Wire bytes -> a batch of writable host tensors at this engine's
    capacity buckets (pinned when ``pinned``)."""
    with trace.span("shuffle.deserialize", cat="shuffle",
                    level=trace.DEBUG, args={"wire_bytes": len(data)}):
        mv = memoryview(data).cast("B")
        if len(mv) < _WIRE_HEADER:
            raise ShuffleCorruptionError(
                f"short shuffle blob ({len(mv)} bytes)")
        cid = mv[0]
        (want,) = struct.unpack_from("<I", mv, 1)
        payload = mv[_WIRE_HEADER:]
        if verify:
            got = zlib.crc32(payload, zlib.crc32(mv[:1])) & 0xFFFFFFFF
            if got != want:
                raise ShuffleCorruptionError(
                    f"shuffle blob CRC mismatch (stored {want:#010x}, "
                    f"computed {got:#010x}, {len(mv)} wire bytes)")
        if cid == CODEC_ZSTD:
            import zstandard
            frame = zstandard.ZstdDecompressor().decompress(payload)
        elif cid == CODEC_ZLIB:
            frame = zlib.decompress(payload)
        elif cid == CODEC_NONE:
            frame = payload
        else:
            raise ShuffleCorruptionError(f"unknown codec id {cid}")
        meta, bufs = (_unpack_frame if native else _py_unpack_frame)(
            frame, verify=verify)
        desc = json.loads(meta.decode())
        n = desc["n"]
        cap = round_capacity(max(n, 1))
        return ColumnarBatch([_rebuild_column(d, bufs, n, cap, pinned)
                              for d in desc["cols"]], n)


def upload(host: ColumnarBatch, device) -> ColumnarBatch:
    """A host batch of ``deserialize_host`` on ``device`` (the CPU: the
    batch itself)."""
    device = torch.device(device)
    if device.type == "cpu":
        return host
    return map_planes(host, lambda t: t.to(device, non_blocking=True))


def deserialize_batch(data, verify: bool = True, device="cpu",
                      native: bool = True) -> ColumnarBatch:
    """Wire bytes -> a batch on ``device``."""
    pinned = torch.device(device).type == "cuda"
    return upload(deserialize_host(data, verify, pinned, native), device)
