"""Apache Iceberg table format (v1 subset) over the engine (counterpart
of ``spark_rapids_tpu/sql/iceberg.py``; the same layout, so a table
written by either package reads in the other).

Reference parity: sql-plugin/src/main/java/com/nvidia/spark/rapids/
iceberg/ (31 files wiring Iceberg scans to the GPU parquet reader).
This module implements the table FORMAT itself against the spec's v1
layout so the engine can read and write Iceberg tables standalone:

- ``metadata/vN.metadata.json`` with table uuid, schema, snapshot log;
  ``version-hint.text`` points at the current version; commits claim
  ``vN.metadata.json`` with an exclusive create (optimistic concurrency,
  same discipline as sql/delta.py).
- snapshots reference an Avro MANIFEST LIST whose entries point at Avro
  MANIFEST files; manifest entries carry a nested ``data_file`` record
  (file path, format, record count, size) — written and read with the
  engine's own OCF machinery (io/avro.py nested-record support).
- reads replay the current (or time-traveled) snapshot's manifests,
  keep entries with status EXISTING/ADDED, and scan the parquet files
  through the normal DataFrame path.

Subset notes (documented): unpartitioned tables, parquet data files,
no delete files / positional deletes, single-schema evolution (the
current schema applies to all snapshots).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.io.avro import read_avro, write_avro
from spark_rapids_tpu_torch.io import read_parquet_file as _read_pq


class IcebergConcurrentCommit(SparkException):
    pass


_STATUS_ADDED = 1
_STATUS_DELETED = 2


def _iceberg_schema(schema: pa.Schema) -> dict:
    def ftype(t):
        if pa.types.is_int64(t):
            return "long"
        if pa.types.is_int32(t):
            return "int"
        if pa.types.is_float64(t):
            return "double"
        if pa.types.is_float32(t):
            return "float"
        if pa.types.is_boolean(t):
            return "boolean"
        if pa.types.is_date32(t):
            return "date"
        if pa.types.is_timestamp(t):
            return "timestamp"
        return "string"
    return {"type": "struct",
            "schema-id": 0,
            "fields": [{"id": i + 1, "name": f.name, "required": False,
                        "type": ftype(f.type)}
                       for i, f in enumerate(schema)]}


_FROM_ICEBERG_TYPE = {
    "long": pa.int64(), "int": pa.int32(), "double": pa.float64(),
    "float": pa.float32(), "boolean": pa.bool_(), "date": pa.date32(),
    "timestamp": pa.timestamp("us"), "string": pa.string()}


def _arrow_schema(ice_schema: dict) -> pa.Schema:
    fields = []
    for f in ice_schema["fields"]:
        if f["type"] not in _FROM_ICEBERG_TYPE:
            # only foreign tables can hit this: _iceberg_schema never
            # writes other type names
            raise SparkException(
                f"unsupported iceberg type {f['type']!r} for {f['name']!r}")
        fields.append(pa.field(f["name"], _FROM_ICEBERG_TYPE[f["type"]]))
    return pa.schema(fields)


class IcebergTable:
    """Read/write an Iceberg v1-subset table directory."""

    def __init__(self, session, path: str):
        self.session = session
        self.path = path
        self.meta_dir = os.path.join(path, "metadata")

    # -- metadata plumbing --------------------------------------------------

    def _current_version(self) -> int:
        hint = os.path.join(self.meta_dir, "version-hint.text")
        if not os.path.isfile(hint):
            raise SparkException(f"{self.path} is not an Iceberg table")
        with open(hint) as f:
            return int(f.read().strip())

    def _metadata(self, version: Optional[int] = None) -> dict:
        v = self._current_version() if version is None else version
        with open(os.path.join(self.meta_dir,
                               f"v{v}.metadata.json")) as f:
            return json.load(f)

    def _commit_metadata(self, version: int, meta: dict) -> None:
        os.makedirs(self.meta_dir, exist_ok=True)
        target = os.path.join(self.meta_dir, f"v{version}.metadata.json")
        try:
            with open(target, "x") as f:
                json.dump(meta, f, indent=1)
        except FileExistsError:
            raise IcebergConcurrentCommit(
                f"metadata v{version} of {self.path} was committed "
                f"concurrently") from None
        with open(os.path.join(self.meta_dir, "version-hint.text"),
                  "w") as f:
            f.write(str(version))

    # -- manifests ----------------------------------------------------------

    def _write_data_files(self, table: pa.Table) -> List[dict]:
        os.makedirs(os.path.join(self.path, "data"), exist_ok=True)
        name = f"data/{uuid.uuid4().hex}.parquet"
        fp = os.path.join(self.path, name)
        pq.write_table(table, fp, compression="snappy")
        return [{"file_path": name, "file_format": "PARQUET",
                 "record_count": table.num_rows,
                 "file_size_in_bytes": os.path.getsize(fp)}]

    def _write_manifest(self, snapshot_id: int, data_files: List[dict]
                        ) -> dict:
        entries = pa.table({
            "status": pa.array([_STATUS_ADDED] * len(data_files),
                               pa.int32()),
            "snapshot_id": pa.array([snapshot_id] * len(data_files),
                                    pa.int64()),
            "data_file": pa.array(data_files, pa.struct([
                ("file_path", pa.string()),
                ("file_format", pa.string()),
                ("record_count", pa.int64()),
                ("file_size_in_bytes", pa.int64()),
            ])),
        })
        os.makedirs(self.meta_dir, exist_ok=True)
        name = f"metadata/snap-m-{uuid.uuid4().hex}.avro"
        write_avro(os.path.join(self.path, name), entries)
        total = sum(d["record_count"] for d in data_files)
        return {"manifest_path": name,
                "manifest_length": os.path.getsize(
                    os.path.join(self.path, name)),
                "partition_spec_id": 0,
                "added_snapshot_id": snapshot_id,
                "added_data_files_count": len(data_files),
                "added_rows_count": total}

    def _write_manifest_list(self, snapshot_id: int,
                             manifests: List[dict]) -> str:
        t = pa.table({k: pa.array([m[k] for m in manifests])
                      for k in ("manifest_path", "manifest_length",
                                "partition_spec_id", "added_snapshot_id",
                                "added_data_files_count",
                                "added_rows_count")})
        name = f"metadata/snap-{snapshot_id}-{uuid.uuid4().hex}.avro"
        write_avro(os.path.join(self.path, name), t)
        return name

    def _snapshot_manifests(self, meta: dict, snapshot_id: int
                            ) -> List[dict]:
        snap = next(s for s in meta["snapshots"]
                    if s["snapshot-id"] == snapshot_id)
        ml = read_avro(os.path.join(self.path, snap["manifest-list"]))
        return ml.to_pylist()

    # -- public API ---------------------------------------------------------

    @staticmethod
    def create(session, path: str, df) -> "IcebergTable":
        t = IcebergTable(session, path)
        table = df.collect() if hasattr(df, "collect") else df
        os.makedirs(path, exist_ok=True)
        snapshot_id = int(time.time() * 1000)
        files = t._write_data_files(table)
        manifest = t._write_manifest(snapshot_id, files)
        ml = t._write_manifest_list(snapshot_id, [manifest])
        meta = {
            "format-version": 1,
            "table-uuid": str(uuid.uuid4()),
            "location": path,
            "last-updated-ms": int(time.time() * 1000),
            "last-column-id": table.num_columns,
            "schema": _iceberg_schema(table.schema),
            "partition-spec": [],
            "properties": {},
            "current-snapshot-id": snapshot_id,
            "snapshots": [{"snapshot-id": snapshot_id,
                           "timestamp-ms": int(time.time() * 1000),
                           "manifest-list": ml,
                           "summary": {"operation": "append"}}],
        }
        t._commit_metadata(1, meta)
        return t

    @staticmethod
    def for_path(session, path: str) -> "IcebergTable":
        t = IcebergTable(session, path)
        t._metadata()  # validates
        return t

    def append(self, df) -> None:
        table = df.collect() if hasattr(df, "collect") else df
        v = self._current_version()
        meta = self._metadata(v)
        old_manifests = self._snapshot_manifests(
            meta, meta["current-snapshot-id"]) \
            if meta.get("current-snapshot-id") else []
        snapshot_id = max(int(time.time() * 1000),
                          meta["current-snapshot-id"] + 1)
        files = self._write_data_files(table)
        manifest = self._write_manifest(snapshot_id, files)
        ml = self._write_manifest_list(snapshot_id,
                                       old_manifests + [manifest])
        meta = dict(meta)
        meta["current-snapshot-id"] = snapshot_id
        meta["last-updated-ms"] = int(time.time() * 1000)
        meta["snapshots"] = meta["snapshots"] + [
            {"snapshot-id": snapshot_id,
             "timestamp-ms": int(time.time() * 1000),
             "manifest-list": ml,
             "summary": {"operation": "append"}}]
        self._commit_metadata(v + 1, meta)

    def data_files(self, snapshot_id: Optional[int] = None) -> List[dict]:
        meta = self._metadata()
        sid = snapshot_id if snapshot_id is not None \
            else meta["current-snapshot-id"]
        out = []
        for m in self._snapshot_manifests(meta, sid):
            entries = read_avro(
                os.path.join(self.path, m["manifest_path"]))
            for e in entries.to_pylist():
                if e["status"] != _STATUS_DELETED:
                    out.append(e["data_file"])
        return out

    def to_df(self, snapshot_id: Optional[int] = None):
        files = self.data_files(snapshot_id)
        if not files:
            # Empty snapshot: the metadata carries the schema.
            schema = _arrow_schema(self._metadata()["schema"])
            return self.session.create_dataframe(schema.empty_table())
        table = pa.concat_tables([
            _read_pq(os.path.join(self.path, f["file_path"]))
            for f in files])
        return self.session.create_dataframe(table)

    def snapshots(self) -> List[dict]:
        return [{"snapshot_id": s["snapshot-id"],
                 "timestamp_ms": s["timestamp-ms"],
                 "operation": s["summary"].get("operation")}
                for s in self._metadata()["snapshots"]]
