"""Delta Lake table format: transaction log, ACID commands, time travel
(counterpart of ``spark_rapids_tpu/sql/delta.py``; the same log layout,
so a table written by either package reads and updates in the other).

Reference parity: delta-lake/ (GpuOptimisticTransaction,
GpuMergeIntoCommand, GpuDeleteCommand, GpuUpdateCommand — 40k LoC across
version shims). This module implements the open Delta PROTOCOL (v1
reader/writer: JSON commit files + parquet checkpoints + _last_checkpoint
pointer) over the native engine:

- every command (create/append/delete/update/merge) is an OPTIMISTIC
  TRANSACTION: data files are written first, then the commit file
  ``_delta_log/<version>.json`` is claimed with an exclusive create —
  a concurrent writer that claimed the version first wins and this
  commit raises ConcurrentModification (the GpuOptimisticTransaction
  retry seam).
- the log replays exactly like Delta's Snapshot: actions from the latest
  parquet checkpoint (if any) plus all later JSON commits, last-writer-
  wins per path; `remove` tombstones drop files.
- DELETE/UPDATE/MERGE follow the copy-on-write path (no deletion
  vectors): affected files are rewritten and swapped atomically in one
  commit — the same remove+add action shape the reference emits.
- compute runs on the session's device: the scan of live files feeds
  the normal DataFrame operators; the row-level commands build their
  keep/transform masks with device expressions.

Out of scope (documented): deletion vectors, column mapping,
generated columns, constraints — protocol features beyond
minReaderVersion=1/minWriterVersion=2.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr.core import SparkException, col
from spark_rapids_tpu_torch.io import read_parquet_file as _read_pq


class ConcurrentModification(SparkException):
    """Another writer claimed the commit version first."""


_LOG_DIR = "_delta_log"
_LAST_CHECKPOINT = "_last_checkpoint"
#: write a parquet checkpoint every N commits (delta default is 10)
CHECKPOINT_INTERVAL = 10


def _version_name(v: int) -> str:
    return f"{v:020d}.json"


def _checkpoint_name(v: int) -> str:
    return f"{v:020d}.checkpoint.parquet"


def _schema_string(schema: pa.Schema) -> str:
    """Delta metaData.schemaString (Spark StructType JSON)."""
    def field_json(f: pa.Field):
        t = f.type
        if pa.types.is_int64(t):
            sp = "long"
        elif pa.types.is_int32(t):
            sp = "integer"
        elif pa.types.is_float64(t):
            sp = "double"
        elif pa.types.is_float32(t):
            sp = "float"
        elif pa.types.is_boolean(t):
            sp = "boolean"
        elif pa.types.is_date32(t):
            sp = "date"
        elif pa.types.is_timestamp(t):
            sp = "timestamp"
        else:
            sp = "string"
        return {"name": f.name, "type": sp, "nullable": True,
                "metadata": {}}
    return json.dumps({"type": "struct",
                       "fields": [field_json(f) for f in schema]})


#: Delta spec checkpoint schema (the subset of action fields this writer
#: emits; struct columns, null when the row is a different action kind).
_MAP_SS = pa.map_(pa.string(), pa.string())
_CHECKPOINT_SCHEMA = pa.schema([
    ("protocol", pa.struct([("minReaderVersion", pa.int32()),
                            ("minWriterVersion", pa.int32())])),
    ("metaData", pa.struct([
        ("id", pa.string()), ("name", pa.string()),
        ("description", pa.string()),
        ("format", pa.struct([("provider", pa.string()),
                              ("options", _MAP_SS)])),
        ("schemaString", pa.string()),
        ("partitionColumns", pa.list_(pa.string())),
        ("configuration", _MAP_SS),
        ("createdTime", pa.int64())])),
    ("add", pa.struct([
        ("path", pa.string()), ("partitionValues", _MAP_SS),
        ("size", pa.int64()), ("modificationTime", pa.int64()),
        ("dataChange", pa.bool_()), ("stats", pa.string())])),
    ("remove", pa.struct([
        ("path", pa.string()), ("deletionTimestamp", pa.int64()),
        ("dataChange", pa.bool_())])),
])


def _typed_metadata(meta: dict) -> dict:
    """metaData action dict → checkpoint row (maps as key/value pairs)."""
    fmt = meta.get("format") or {}
    return {"id": meta.get("id"), "name": meta.get("name"),
            "description": meta.get("description"),
            "format": {"provider": fmt.get("provider", "parquet"),
                       "options": sorted((fmt.get("options") or {}).items())},
            "schemaString": meta.get("schemaString"),
            "partitionColumns": meta.get("partitionColumns") or [],
            "configuration": sorted((meta.get("configuration") or {}).items()),
            "createdTime": meta.get("createdTime")}


class DeltaLog:
    """Replay + commit machinery for one table directory."""

    def __init__(self, path: str):
        self.path = path
        self.log_path = os.path.join(path, _LOG_DIR)

    # -- replay ------------------------------------------------------------

    def _checkpoint_start(self):
        """(checkpoint_version, actions) from _last_checkpoint, or
        (-1, [])."""
        lc = os.path.join(self.log_path, _LAST_CHECKPOINT)
        if not os.path.isfile(lc):
            return -1, []
        with open(lc) as f:
            v = int(json.load(f)["version"])
        t = _read_pq(os.path.join(self.log_path, _checkpoint_name(v)))
        if "kind" in t.schema.names and "payload" in t.schema.names:
            # pre-round-5 checkpoint layout (kind + JSON payload columns)
            return v, [{row["kind"]: json.loads(row["payload"])}
                       for row in t.to_pylist()]
        actions = []
        for row in t.to_pylist():
            for kind in ("protocol", "metaData", "add", "remove"):
                a = row.get(kind)
                if a is not None:
                    if "partitionValues" in a:
                        a["partitionValues"] = dict(
                            a["partitionValues"] or [])
                    if kind == "metaData":
                        a["configuration"] = dict(a["configuration"] or [])
                        if a.get("format"):
                            a["format"]["options"] = dict(
                                a["format"]["options"] or [])
                    actions.append({kind: a})
        return v, actions

    def versions_on_disk(self) -> List[int]:
        if not os.path.isdir(self.log_path):
            return []
        out = []
        for name in os.listdir(self.log_path):
            if name.endswith(".json") and name[:20].isdigit():
                out.append(int(name[:20]))
        return sorted(out)

    def snapshot(self, version: Optional[int] = None) -> "Snapshot":
        """Replay the log to `version` (time travel) or to HEAD."""
        cp_v, actions = self._checkpoint_start()
        if version is not None and cp_v > version:
            cp_v, actions = -1, []  # checkpoint is past the asked version
        versions = [v for v in self.versions_on_disk() if v > cp_v
                    and (version is None or v <= version)]
        if cp_v < 0 and not versions:
            raise SparkException(f"{self.path} is not a Delta table")
        for v in versions:
            with open(os.path.join(self.log_path, _version_name(v))) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        actions.append(json.loads(line))
        live: Dict[str, dict] = {}
        meta = proto = None
        for a in actions:
            if "add" in a:
                live[a["add"]["path"]] = a["add"]
            elif "remove" in a:
                live.pop(a["remove"]["path"], None)
            elif "metaData" in a:
                meta = a["metaData"]
            elif "protocol" in a:
                proto = a["protocol"]
        head = versions[-1] if versions else cp_v
        return Snapshot(self, head, live, meta, proto)

    # -- commit ------------------------------------------------------------

    def commit(self, version: int, actions: List[dict], op: str) -> None:
        """Atomically claim `version` (exclusive create). Raises
        ConcurrentModification if a concurrent writer won."""
        os.makedirs(self.log_path, exist_ok=True)
        info = {"commitInfo": {
            "timestamp": int(time.time() * 1000), "operation": op,
            "engineInfo": "spark-rapids-tpu-torch/0.1.0"}}
        payload = "\n".join(json.dumps(a) for a in [info] + actions) + "\n"
        target = os.path.join(self.log_path, _version_name(version))
        try:
            with open(target, "x") as f:
                f.write(payload)
        except FileExistsError:
            raise ConcurrentModification(
                f"version {version} of {self.path} was committed "
                f"concurrently") from None
        if version > 0 and version % CHECKPOINT_INTERVAL == 0:
            self._write_checkpoint(version)

    def _write_checkpoint(self, version: int) -> None:
        # One action per row in the Delta spec's typed checkpoint schema
        # (protocol / metaData / add struct columns, non-applicable
        # columns null) so external Delta readers that follow
        # _last_checkpoint can replay it.
        snap = self.snapshot(version)
        rows = [{"protocol": snap.protocol},
                {"metaData": _typed_metadata(snap.metadata)}]
        for add in snap.files.values():
            a = dict(add)
            a["partitionValues"] = sorted(
                (a.get("partitionValues") or {}).items())
            rows.append({"add": {k: a.get(k) for k in
                                 ("path", "partitionValues", "size",
                                  "modificationTime", "dataChange",
                                  "stats")}})
        pq.write_table(
            pa.Table.from_pylist(rows, schema=_CHECKPOINT_SCHEMA),
            os.path.join(self.log_path, _checkpoint_name(version)))
        with open(os.path.join(self.log_path, _LAST_CHECKPOINT), "w") as f:
            json.dump({"version": version, "size": len(rows)}, f)


class Snapshot:
    def __init__(self, log: DeltaLog, version: int, files: Dict[str, dict],
                 metadata, protocol):
        self.log = log
        self.version = version
        self.files = files
        self.metadata = metadata
        self.protocol = protocol

    def file_paths(self) -> List[str]:
        return [os.path.join(self.log.path, p) for p in sorted(self.files)]


class DeltaTable:
    """User-facing Delta table over the engine (reference
    io.delta.tables.DeltaTable surface)."""

    def __init__(self, session, path: str):
        self.session = session
        self.path = path
        self.log = DeltaLog(path)

    # -- creation ----------------------------------------------------------

    @staticmethod
    def create(session, path: str, df) -> "DeltaTable":
        """CREATE TABLE AS: write the DataFrame's rows as version 0."""
        t = DeltaTable(session, path)
        table = df.collect() if hasattr(df, "collect") else df
        os.makedirs(path, exist_ok=True)
        adds = t._write_files(table)
        meta = {"metaData": {
            "id": str(uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": _schema_string(table.schema),
            "partitionColumns": [], "configuration": {},
            "createdTime": int(time.time() * 1000)}}
        proto = {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}}
        t.log.commit(0, [proto, meta] + adds, "CREATE TABLE AS SELECT")
        return t

    @staticmethod
    def for_path(session, path: str) -> "DeltaTable":
        t = DeltaTable(session, path)
        t.log.snapshot()  # validates it IS a delta table
        return t

    def _write_files(self, table: pa.Table, max_rows: int = 1 << 20
                     ) -> List[dict]:
        adds = []
        for off in range(0, max(table.num_rows, 1), max_rows):
            part = table.slice(off, min(max_rows, table.num_rows - off))
            name = f"part-{uuid.uuid4().hex}.snappy.parquet"
            fp = os.path.join(self.path, name)
            pq.write_table(part, fp, compression="snappy")
            adds.append({"add": {
                "path": name, "partitionValues": {},
                "size": os.path.getsize(fp),
                "modificationTime": int(time.time() * 1000),
                "dataChange": True,
                "stats": json.dumps({"numRecords": part.num_rows})}})
            if table.num_rows == 0:
                break
        return adds

    # -- reads -------------------------------------------------------------

    def to_df(self, version: Optional[int] = None):
        snap = self.log.snapshot(version)
        paths = snap.file_paths()
        if not paths:
            schema = _schema_from_string(snap.metadata["schemaString"])
            return self.session.create_dataframe(schema.empty_table())
        table = pa.concat_tables([_read_pq(p) for p in paths])
        return self.session.create_dataframe(table)

    def history(self) -> List[dict]:
        out = []
        for v in reversed(self.log.versions_on_disk()):
            with open(os.path.join(self.log.log_path,
                                   _version_name(v))) as f:
                first = json.loads(f.readline())
            info = first.get("commitInfo", {})
            out.append({"version": v, "operation": info.get("operation"),
                        "timestamp": info.get("timestamp")})
        return out

    # -- transactional commands --------------------------------------------

    def append(self, df) -> None:
        table = df.collect() if hasattr(df, "collect") else df
        snap = self.log.snapshot()
        adds = self._write_files(table)
        self.log.commit(snap.version + 1, adds, "WRITE")

    def delete(self, condition: Optional[E.Expression] = None) -> int:
        """DELETE FROM: copy-on-write rewrite of files containing matches.
        Returns the number of deleted rows."""
        snap = self.log.snapshot()
        if condition is None:
            removes = self._removes(snap)
            n = sum(pq.ParquetFile(p).metadata.num_rows
                    for p in snap.file_paths())
            self.log.commit(snap.version + 1, removes, "DELETE")
            return n
        deleted = 0
        actions: List[dict] = []
        for rel, add in snap.files.items():
            fp = os.path.join(self.path, rel)
            table = _read_pq(fp)
            df = self.session.create_dataframe(table)
            # DELETE removes only rows where the condition is TRUE; rows
            # where it evaluates to NULL are kept (Spark DeleteCommand).
            pred = _as_pred(condition)
            kept = df.filter(pred.is_null() | ~pred).collect()
            if kept.num_rows == table.num_rows:
                continue  # file untouched
            deleted += table.num_rows - kept.num_rows
            actions.append(_remove_action(rel))
            if kept.num_rows:
                actions.extend(self._write_files(kept))
        if actions:
            self.log.commit(snap.version + 1, actions, "DELETE")
        return deleted

    def update(self, set_exprs: Dict[str, E.Expression],
               condition: Optional[E.Expression] = None) -> int:
        """UPDATE SET: rewrite affected files with conditional
        projections (device expressions). Returns updated rows."""
        snap = self.log.snapshot()
        updated = 0
        actions: List[dict] = []
        for rel, add in snap.files.items():
            fp = os.path.join(self.path, rel)
            table = _read_pq(fp)
            df = self.session.create_dataframe(table)
            pred = _as_pred(condition) if condition is not None else None
            if pred is not None:
                nmatch = df.filter(pred).count()
                if nmatch == 0:
                    continue
            else:
                nmatch = table.num_rows
                if nmatch == 0:
                    continue
            cols = []
            from spark_rapids_tpu_torch.sql import functions as F
            for name in table.schema.names:
                if name in set_exprs:
                    newv = set_exprs[name]
                    if pred is not None:
                        newv = F.when(pred, newv).otherwise(col(name))
                    cols.append(newv.alias(name))
                else:
                    cols.append(col(name))
            rewritten = df.select(*cols).collect()
            updated += nmatch
            actions.append(_remove_action(rel))
            actions.extend(self._write_files(rewritten))
        if actions:
            self.log.commit(snap.version + 1, actions, "UPDATE")
        return updated

    def merge(self, source, on: List[str]) -> "DeltaMergeBuilder":
        return DeltaMergeBuilder(self, source, on)

    def checkpoint(self) -> None:
        self.log._write_checkpoint(self.log.snapshot().version)

    def vacuum(self, retain_hours: float = 168.0) -> List[str]:
        """Remove data files no longer referenced by the current
        snapshot (simplified: no tombstone retention window check against
        `remove` timestamps beyond the file mtime)."""
        snap = self.log.snapshot()
        live = set(snap.files)
        cutoff = time.time() - retain_hours * 3600
        dropped = []
        for name in os.listdir(self.path):
            if not name.endswith(".parquet") or name in live:
                continue
            fp = os.path.join(self.path, name)
            if os.path.getmtime(fp) < cutoff:
                os.unlink(fp)
                dropped.append(name)
        return dropped

    def _removes(self, snap: Snapshot) -> List[dict]:
        return [_remove_action(rel) for rel in snap.files]


def _remove_action(rel: str) -> dict:
    return {"remove": {"path": rel,
                       "deletionTimestamp": int(time.time() * 1000),
                       "dataChange": True}}


def _as_pred(e: E.Expression) -> E.Expression:
    return e


class DeltaMergeBuilder:
    """MERGE INTO committed as a Delta transaction: the in-memory merge
    (sql/merge.py device operators) computes the new table image; the
    commit swaps the whole matched file set atomically (coarse
    copy-on-write: source tables are small relative to targets in the
    upsert pattern this serves; file-pruned rewrite is a planned
    refinement)."""

    def __init__(self, table: DeltaTable, source, on: List[str]):
        from spark_rapids_tpu_torch.sql.merge import MergeInto
        self.table = table
        snap = table.log.snapshot()
        self._snap = snap
        target_df = table.to_df()
        self._m = MergeInto(target_df, source, on)

    def when_matched_update(self, set_exprs, condition=None):
        self._m.when_matched_update(set_exprs, condition)
        return self

    def when_matched_delete(self, condition=None):
        self._m.when_matched_delete(condition)
        return self

    def when_not_matched_insert(self, values=None, condition=None):
        self._m.when_not_matched_insert(values, condition)
        return self

    def execute(self) -> None:
        merged = self._m.result().collect()
        actions = self.table._removes(self._snap)
        actions.extend(self.table._write_files(merged))
        self.table.log.commit(self._snap.version + 1, actions, "MERGE")


def _schema_from_string(s: str):
    """Minimal inverse of _schema_string for empty-table reads."""
    spec = json.loads(s)
    m = {"long": pa.int64(), "integer": pa.int32(), "double": pa.float64(),
         "float": pa.float32(), "boolean": pa.bool_(), "date": pa.date32(),
         "timestamp": pa.timestamp("us"), "string": pa.string()}

    class _S:
        def __init__(self, fields):
            self.fields = fields

        def empty_table(self):
            return pa.table({f["name"]: pa.array([], m.get(f["type"],
                                                           pa.string()))
                             for f in self.fields})

    return _S(spec["fields"])
