"""Columnar file writer (counterpart of ``spark_rapids_tpu/io/writer.py``).

Reference parity: ColumnarOutputWriter.scala + GpuFileFormatDataWriter
(dynamic partitioning, per-task part files, maxRecordsPerFile splitting,
_SUCCESS marker) + GpuParquetFileFormat/GpuOrcFileFormat/
GpuHiveFileFormat + BasicColumnarWriteJobStatsTracker (per-write
numFiles/numOutputRows/numOutputBytes/numParts). The query's partitions
run as a task wave (``runtime/host_pool.run_task_wave``); device batches
download once per output batch (the C2R boundary) and encode host-side
with pyarrow's native writers; writes go through the ThrottlingExecutor
so buffered output bytes are bounded (reference io/async
TrafficController).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import List, Optional
from urllib.parse import quote

import pyarrow as pa

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.io.async_io import (
    ThrottlingExecutor, TrafficController,
)

_FORMATS = ("parquet", "csv", "orc", "json")
#: the directory name of a null partition value (Hive's)
HIVE_DEFAULT = "__HIVE_DEFAULT_PARTITION__"


def _write_one(table: pa.Table, path: str, fmt: str, options: dict) -> None:
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(table, path,
                       compression=options.get("compression", "snappy"))
    elif fmt == "orc":
        import pyarrow.orc as porc
        porc.write_table(table, path)
    elif fmt == "csv":
        import pyarrow.csv as pcsv
        opts = pcsv.WriteOptions(include_header=options.get("header", True),
                                 delimiter=options.get("sep", ","))
        pcsv.write_csv(table, path, write_options=opts)
    else:  # json lines
        with open(path, "wb") as f:
            for row in table.to_pylist():
                f.write(json.dumps(row, default=str).encode())
                f.write(b"\n")


def _partition_dirs(table: pa.Table, partition_by: List[str]):
    """Split a table into (subdir, sub_table_without_partition_cols) pairs
    (reference GpuFileFormatDataWriter dynamic partitioning)."""
    import pyarrow.compute as pc
    if not partition_by:
        yield "", table
        return
    keys = table.select(partition_by)
    # unique combos via group_by count
    combos = keys.group_by(partition_by).aggregate([([], "count_all")])
    rest = [n for n in table.schema.names if n not in partition_by]
    for row in combos.select(partition_by).to_pylist():
        mask = None
        for k, v in row.items():
            e = pc.is_null(table[k]) if v is None else pc.equal(table[k], v)
            mask = e if mask is None else pc.and_(mask, e)
        sub = table.filter(mask).select(rest)
        subdir = "/".join(
            f"{k}={HIVE_DEFAULT if v is None else quote(str(v), safe='')}"
            for k, v in row.items())
        yield subdir, sub


class WriteStats:
    """BasicColumnarWriteJobStatsTracker analog: one per write job,
    readable afterwards via DataFrameWriter.last_write_stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self.num_files = 0
        self.num_output_rows = 0
        self.num_output_bytes = 0
        self.partition_dirs = set()

    def record(self, rows: int, nbytes: int, subdir: str) -> None:
        with self._lock:
            self.num_files += 1
            self.num_output_rows += rows
            self.num_output_bytes += nbytes
            if subdir:
                self.partition_dirs.add(subdir)

    def as_dict(self) -> dict:
        return {"numFiles": self.num_files,
                "numOutputRows": self.num_output_rows,
                "numOutputBytes": self.num_output_bytes,
                "numParts": len(self.partition_dirs)}


class DataFrameWriter:
    """df.write.mode(...).partition_by(...).parquet(path) — the writer
    facade (reference GpuDataWritingCommandExec + InsertIntoHadoopFs)."""

    def __init__(self, df):
        self._df = df
        self._mode = "error"
        self._partition_by: List[str] = []
        self._options: dict = {}
        #: stats of the most recent write job (tracker analog)
        self.last_write_stats: Optional[dict] = None

    def mode(self, m: str) -> "DataFrameWriter":
        assert m in ("error", "errorifexists", "overwrite", "append"), m
        self._mode = "error" if m == "errorifexists" else m
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    def option(self, k: str, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def parquet(self, path: str) -> None:
        self._write(path, "parquet")

    def orc(self, path: str) -> None:
        self._write(path, "orc")

    def csv(self, path: str) -> None:
        self._write(path, "csv")

    def json(self, path: str) -> None:
        self._write(path, "json")

    # -- engine ------------------------------------------------------------

    def _write(self, path: str, fmt: str) -> None:
        assert fmt in _FORMATS
        if os.path.exists(path):
            if self._mode == "error":
                raise FileExistsError(
                    f"path {path} already exists (mode=error)")
            if self._mode == "overwrite":
                shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)

        df = self._df
        session = df.session
        conf = session.conf
        from spark_rapids_tpu_torch.exec.nodes import host_table
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        exec_root, _ = session.prepare_execution(df.plan)
        names = df.plan.schema.names
        controller = TrafficController(conf.get(C.ASYNC_WRITE_MAX_INFLIGHT))
        pool = ThrottlingExecutor(conf.get(C.WRITER_THREADS), controller)
        ext = {"parquet": "parquet", "orc": "orc", "csv": "csv",
               "json": "json"}[fmt]
        futures = []
        futures_lock = threading.Lock()
        # unique suffix per write so append mode never collides
        job = uuid.uuid4().hex[:8]

        stats = WriteStats()
        max_records = int(self._options.get(
            "maxRecordsPerFile", conf.get(C.MAX_RECORDS_PER_FILE)) or 0)

        def write_tracked(sub, fpath, subdir):
            _write_one(sub, fpath, fmt, self._options)
            stats.record(sub.num_rows, os.path.getsize(fpath), subdir)

        def run_partition(p: int) -> None:
            with TaskContext(partition_id=p):
                tables = [host_table(b, names)
                          for b in exec_root.execute_partition(p)]
            if not tables:
                return
            table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
            if table.num_rows == 0:
                return
            for subdir, sub in _partition_dirs(table, self._partition_by):
                d = os.path.join(path, subdir) if subdir else path
                os.makedirs(d, exist_ok=True)
                # maxRecordsPerFile: roll to a new numbered part file
                if max_records > 0 and sub.num_rows > max_records:
                    chunks = [sub.slice(off, min(max_records,
                                                 sub.num_rows - off))
                              for off in range(0, sub.num_rows, max_records)]
                else:
                    chunks = [sub]
                for seq, chunk in enumerate(chunks):
                    fpath = os.path.join(
                        d, f"part-{p:05d}-{seq:04d}-{job}.{ext}")
                    with futures_lock:
                        futures.append(pool.submit(
                            chunk.nbytes, write_tracked, chunk, fpath,
                            subdir))

        try:
            nparts = exec_root.num_partitions
            if nparts == 1:
                run_partition(0)
            else:
                from spark_rapids_tpu_torch.runtime.host_pool import (
                    run_task_wave,
                )
                run_task_wave(run_partition, range(nparts))
            for f in futures:
                f.result()
            with open(os.path.join(path, "_SUCCESS"), "w"):
                pass
            self.last_write_stats = stats.as_dict()
            # df.write is a new writer on each access: stash where callers
            # can actually reach them afterwards
            self._df.last_write_stats = self.last_write_stats
            session.last_write_stats = self.last_write_stats
        finally:
            pool.shutdown()
