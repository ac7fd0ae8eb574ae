"""Avro Object Container File reader (and a minimal writer for tests).

Counterpart of ``spark_rapids_tpu/io/avro.py``, whole (a copy: the port
imports nothing of the JAX package). Reference parity: GpuAvroScan.scala
+ AvroDataFileReader.scala — the reference ships its own pure-Scala Avro
block parser instead of depending on avro-java; same approach here in
Python, with no Avro library. Scope: flat record schemas over the Avro primitives
(null/boolean/int/long/float/double/bytes/string), nullable unions
(["null", X] in either order), and the date / timestamp-millis /
timestamp-micros logical types; codecs null and deflate (zlib). Nested
records/arrays/maps are rejected with a clear error.

The decode is host-side (like every text-format scan in this engine) and
lands in a pyarrow Table that uploads through the normal scan path.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"Obj\x01"


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# binary decode primitives
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos: self.pos + n]
        if len(b) < n:
            raise AvroError("truncated avro data")
        self.pos += n
        return b

    def long(self) -> int:
        """zigzag varint"""
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise AvroError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def eof(self) -> bool:
        return self.pos >= len(self.buf)


def _nullable_dec(base, null_index: int):
    """Wrap a decoder for a [null, X] union branch."""
    def dec(r: _Reader):
        if r.long() == null_index:
            return None
        return base(r)
    return dec


def _field_decoder(ftype):
    """Returns (decode_fn(reader)->python value, arrow_type_name)."""
    import pyarrow as pa
    nullable = False
    null_index = 0
    if isinstance(ftype, list):
        # union: support exactly [null, X] / [X, null]
        non_null = [t for t in ftype if t != "null"]
        if len(non_null) != 1 or len(ftype) > 2:
            raise AvroError(f"unsupported avro union {ftype}")
        nullable = len(ftype) == 2
        null_index = ftype.index("null") if "null" in ftype else -1
        ftype = non_null[0]
    logical = None
    if isinstance(ftype, dict) and ftype.get("type") not in ("record",
                                                             "array"):
        logical = ftype.get("logicalType")
        ftype = ftype["type"]

    def base(r: _Reader):
        if ftype == "boolean":
            return r.read(1)[0] != 0
        if ftype in ("int", "long"):
            return r.long()
        if ftype == "float":
            return struct.unpack("<f", r.read(4))[0]
        if ftype == "double":
            return struct.unpack("<d", r.read(8))[0]
        if ftype == "string":
            return r.read(r.long()).decode("utf-8")
        if ftype == "bytes":
            return r.read(r.long())
        if ftype == "null":
            return None
        raise AvroError(f"unsupported avro type {ftype!r}")

    if isinstance(ftype, dict) and ftype.get("type") == "record":
        # nested record -> python dict + arrow struct (Iceberg manifest
        # entries carry a nested data_file record)
        sub = [(f["name"],) + _field_decoder(f["type"])
               for f in ftype["fields"]]

        def base(r: _Reader):  # noqa: F811 - intentional override
            return {name: dec(r) for name, dec, _ in sub}

        at = pa.struct([pa.field(name, t) for name, _, t in sub])
        return (base if not nullable
                else _nullable_dec(base, null_index)), at
    if isinstance(ftype, dict) and ftype.get("type") == "array":
        item_dec, item_t = _field_decoder(ftype["items"])

        def base(r: _Reader):  # noqa: F811 - intentional override
            out = []
            while True:
                n = r.long()
                if n == 0:
                    break
                if n < 0:
                    r.long()  # block byte size (skippable form)
                    n = -n
                for _ in range(n):
                    out.append(item_dec(r))
            return out

        at = pa.list_(item_t)
        return (base if not nullable
                else _nullable_dec(base, null_index)), at
    if ftype == "boolean":
        at = pa.bool_()
    elif ftype == "int":
        at = pa.int32()
    elif ftype == "long":
        at = pa.int64()
    elif ftype == "float":
        at = pa.float32()
    elif ftype == "double":
        at = pa.float64()
    elif ftype in ("string",):
        at = pa.string()
    elif ftype == "bytes":
        at = pa.binary()
    elif ftype == "null":
        at = pa.null()
    else:
        raise AvroError(f"unsupported avro type {ftype!r} (maps are not "
                        f"supported by this reader)")
    if logical == "date" and ftype == "int":
        at = pa.date32()
    elif logical == "timestamp-millis" and ftype == "long":
        at = pa.timestamp("ms")
    elif logical == "timestamp-micros" and ftype == "long":
        at = pa.timestamp("us")

    return (base if not nullable
            else _nullable_dec(base, null_index)), at


def read_avro(path: str):
    """Avro OCF -> pyarrow Table."""
    import pyarrow as pa
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise AvroError(f"{path}: not an avro object container file")
    r = _Reader(data)
    r.pos = 4
    meta = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:  # block with explicit byte size
            r.long()
            n = -n
        for _ in range(n):
            k = r.read(r.long()).decode()
            v = r.read(r.long())
            meta[k] = v
    sync = r.read(16)
    schema = json.loads(meta[b"avro.schema".decode()].decode()
                        if isinstance(meta.get("avro.schema"), bytes)
                        else meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported avro codec {codec!r}")
    if schema.get("type") != "record":
        raise AvroError("top-level avro schema must be a record")
    fields = schema["fields"]
    decoders = []
    arrow_fields = []
    for fld in fields:
        dec, at = _field_decoder(fld["type"])
        decoders.append(dec)
        arrow_fields.append(pa.field(fld["name"], at))

    cols: List[list] = [[] for _ in fields]
    while not r.eof():
        count = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        br = _Reader(block)
        for _ in range(count):
            for ci, dec in enumerate(decoders):
                cols[ci].append(dec(br))
        if r.read(16) != sync:
            raise AvroError("avro sync marker mismatch")

    arrays = []
    for vals, fld in zip(cols, arrow_fields):
        if pa.types.is_timestamp(fld.type):
            unit = fld.type.unit
            arrays.append(pa.array(vals, type=pa.timestamp(unit)))
        else:
            arrays.append(pa.array(vals, type=fld.type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(arrow_fields))


# ---------------------------------------------------------------------------
# minimal writer (tests + tooling; the reference is read-only for Avro)
# ---------------------------------------------------------------------------

def _zigzag(v: int) -> bytes:
    v = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_avro(path: str, table, codec: str = "null") -> None:
    """pyarrow Table -> Avro OCF (flat primitive schemas)."""
    import pyarrow as pa

    def avro_type(at):
        if pa.types.is_boolean(at):
            return "boolean"
        if pa.types.is_int32(at):
            return "int"
        if pa.types.is_int64(at):
            return "long"
        if pa.types.is_float32(at):
            return "float"
        if pa.types.is_float64(at):
            return "double"
        if pa.types.is_string(at):
            return "string"
        if pa.types.is_binary(at):
            return "bytes"
        if pa.types.is_date32(at):
            return {"type": "int", "logicalType": "date"}
        if pa.types.is_timestamp(at):
            lt = "timestamp-micros" if at.unit == "us" else "timestamp-millis"
            return {"type": "long", "logicalType": lt}
        if pa.types.is_struct(at):
            avro_type._n = getattr(avro_type, "_n", 0) + 1
            return {"type": "record", "name": f"r{avro_type._n}",
                    "fields": [{"name": f.name,
                                "type": ["null", avro_type(f.type)]}
                               for f in at]}
        if pa.types.is_list(at):
            return {"type": "array",
                    "items": ["null", avro_type(at.value_type)]}
        raise AvroError(f"cannot write arrow type {at} to avro")

    schema = {"type": "record", "name": "row", "fields": [
        {"name": f.name, "type": ["null", avro_type(f.type)]}
        for f in table.schema]}

    def enc_val(at, v) -> bytes:
        if pa.types.is_boolean(at):
            return bytes([1 if v else 0])
        if pa.types.is_date32(at):
            import datetime
            if isinstance(v, datetime.date):
                v = (v - datetime.date(1970, 1, 1)).days
            return _zigzag(int(v))
        if pa.types.is_timestamp(at):
            import datetime
            if isinstance(v, datetime.datetime):
                epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
                us = int((v - epoch).total_seconds() * 1_000_000)
                v = us if at.unit == "us" else us // 1000
            return _zigzag(int(v))
        if pa.types.is_int32(at) or pa.types.is_int64(at):
            return _zigzag(int(v))
        if pa.types.is_float32(at):
            return struct.pack("<f", v)
        if pa.types.is_float64(at):
            return struct.pack("<d", v)
        if pa.types.is_string(at):
            b = v.encode("utf-8")
            return _zigzag(len(b)) + b
        if pa.types.is_struct(at):
            # fields mirror the top-level convention: nullable union per
            # field, branch 1 = the value
            out = bytearray()
            for f in at:
                fv = v.get(f.name) if isinstance(v, dict) else None
                if fv is None:
                    out += _zigzag(0)
                else:
                    out += _zigzag(1) + enc_val(f.type, fv)
            return bytes(out)
        if pa.types.is_list(at):
            out = bytearray()
            if v:
                out += _zigzag(len(v))
                for item in v:
                    if item is None:
                        out += _zigzag(0)
                    else:
                        out += _zigzag(1) + enc_val(at.value_type, item)
            out += _zigzag(0)
            return bytes(out)
        b = bytes(v)
        return _zigzag(len(b)) + b

    rows = table.num_rows
    body = bytearray()
    pydata = [table.column(i) for i in range(table.num_columns)]
    for i in range(rows):
        for ci, f in enumerate(table.schema):
            cell = pydata[ci][i]
            if not cell.is_valid:
                body += _zigzag(0)  # union branch: null
            else:
                v = cell.value if pa.types.is_timestamp(f.type) else cell.as_py()
                if pa.types.is_date32(f.type):
                    import datetime
                    v = (cell.as_py() - datetime.date(1970, 1, 1)).days
                body += _zigzag(1) + enc_val(f.type, v)
    payload = bytes(body)
    if codec == "deflate":
        co = zlib.compressobj(wbits=-15)
        payload = co.compress(payload) + co.flush()
    elif codec != "null":
        raise AvroError(f"unsupported codec {codec!r}")

    sync = os.urandom(16)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    out = bytearray(MAGIC)
    out += _zigzag(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        out += _zigzag(len(kb)) + kb + _zigzag(len(v)) + v
    out += _zigzag(0)
    out += sync
    out += _zigzag(rows) + _zigzag(len(payload)) + payload + sync
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(bytes(out))
    os.replace(tmp, path)
