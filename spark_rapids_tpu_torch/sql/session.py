"""The session: entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/sql/session.py`` ``TpuSession``
(``create_dataframe``, ``range``, the readers: ``read_parquet`` with hive
partition discovery, ``read_csv``, ``read_json``, ``read_avro`` and
``read_orc``; the SQL front door:
``create_or_replace_temp_view``, ``table`` and ``sql``, ``collect``,
``last_aqe`` and ``explain_aqe``, and the device-side compaction of sparse
results before the download).
``collect`` tags the plan and converts it (``plan/overrides.py``): what
is tagged off the device runs one operator at a time on the CPU backend.
spark.rapids.sql.explain=NOT_ON_TPU|ALL logs the placement report, and
spark.rapids.sql.mode=explainOnly tags, logs and answers with the CPU
backend alone.
"""
from __future__ import annotations

import glob
import logging
import os
import threading
from typing import Dict, List, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import adaptive as AQ
from spark_rapids_tpu_torch.exec.cpu_backend import execute_cpu
from spark_rapids_tpu_torch.exec.nodes import empty_table, host_table
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.plan.overrides import (
    convert_plan, localize_plan, wrap_and_tag,
)
from spark_rapids_tpu_torch.sql.dataframe import DataFrame

_LOG = logging.getLogger("spark_rapids_tpu_torch")


def _discover_hive(root: str):
    """Walk a directory for hive-layout partitions (``k=v`` directories):
    (files, each file's partition values) or (files, None) when the
    layout is flat (reference: Spark's PartitioningAwareFileIndex). A
    value ``__HIVE_DEFAULT_PARTITION__`` is null, the others are
    URL-unescaped; Parquet files in a directory that is not a partition
    raise."""
    from urllib.parse import unquote
    files, vals = [], []
    found_parts = False
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        rel = os.path.relpath(dirpath, root)
        parts = {}
        if rel != ".":
            for seg in rel.split(os.sep):
                if "=" not in seg:
                    if any(f.endswith(".parquet") for f in filenames):
                        raise ValueError(
                            f"mixed layout under {root!r}: parquet files in "
                            f"non-partition directory {dirpath!r}")
                    parts = None
                    break
                k, _, v = seg.partition("=")
                parts[k] = (None if v == "__HIVE_DEFAULT_PARTITION__"
                            else unquote(v))
            if parts:
                found_parts = True
        if parts is None:
            continue
        for f in sorted(filenames):
            if f.endswith(".parquet") and not f.startswith("_"):
                files.append(os.path.join(dirpath, f))
                vals.append(parts)
    if not files:
        raise FileNotFoundError(f"no parquet files under {root!r}")
    return files, (vals if found_parts else None)

#: per-thread collect nesting depth: only a top-level action (depth 0 at
#: entry) opens and closes the adaptive decision list
_COLLECT_DEPTH = threading.local()


class TorchSession:
    """Runs DataFrame queries on one device: the CUDA card by default, the
    CPU when ``device="cpu"`` (kernels then run their plain versions).
    Asking for the card where none is available raises."""

    def __init__(self, conf: Optional[Dict] = None, device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchSession(device='cuda'): no CUDA device "
                               "is available; pass device='cpu' to run on "
                               "the CPU")
        self.conf = C.RapidsConf(conf)
        #: the root operator of the last collect, for reading its counters,
        #: and its tagged plan (``SparkPlanMeta``: placement and reasons)
        self.last_exec = None
        self.last_meta = None
        self._views: Dict[str, DataFrame] = {}
        self._last_aqe: Optional[dict] = None

    # -- the SQL front door ------------------------------------------------
    def create_or_replace_temp_view(self, name: str, df: DataFrame) -> None:
        """Register a DataFrame for ``sql`` FROM resolution (names are
        case-insensitive). Registering advances the table epoch, which
        empties the cross-query broadcast build cache."""
        self._views[name.lower()] = df
        AQ.bump_table_version()

    createOrReplaceTempView = create_or_replace_temp_view

    def table(self, name: str) -> DataFrame:
        if name.lower() not in self._views:
            raise SparkException(f"table or view not found: {name}")
        return self._views[name.lower()]

    def sql(self, query: str) -> DataFrame:
        """A SQL string over the registered temp views (the grammar of
        ``sql/parser.py``). An uncorrelated scalar subquery runs here, on
        this session's device."""
        from spark_rapids_tpu_torch.sql.parser import parse_sql
        return parse_sql(query, self)

    def create_dataframe(self, data, num_partitions: int = 1) -> DataFrame:
        if isinstance(data, dict):
            data = pa.table(data)
        if not isinstance(data, pa.Table):
            raise TypeError(type(data))
        return DataFrame(P.InMemorySource(data, num_partitions), self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> DataFrame:
        """spark.range: one int64 column ``id`` from start (inclusive) to
        end (exclusive) by step; range(n) counts from 0. The values are
        made on the device."""
        if end is None:
            start, end = 0, start
        return DataFrame(P.Range(start, end, step, num_partitions), self)

    def read_parquet(self, *paths, columns=None) -> DataFrame:
        """Parquet files, directories of them (``*.parquet``, names
        starting with ``_`` skipped) or glob patterns; one partition per
        file. One directory in a hive layout (``k=v`` subdirectories)
        gives its partition columns, last in the schema. Decoded on the
        device unless spark.rapids.sql.decode.device.enabled is false."""
        if len(paths) == 1 and os.path.isdir(paths[0]):
            files, part_vals = _discover_hive(paths[0])
            if part_vals is not None:
                return DataFrame(P.ParquetScan(
                    files, columns, partition_values=part_vals), self)
        return DataFrame(P.ParquetScan(
            self._expand_paths(paths, suffix=".parquet"), columns), self)

    @staticmethod
    def _expand_paths(paths, suffix: str = "") -> List[str]:
        """Files, a directory's files ending in ``suffix`` (names starting
        with ``_`` skipped) and glob patterns, in sorted order."""
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    f for f in glob.glob(os.path.join(p, "*" + suffix))
                    if os.path.isfile(f)
                    and not os.path.basename(f).startswith("_")))
            elif any(ch in p for ch in "*?["):
                files.extend(sorted(glob.glob(p)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no input files matched {list(paths)!r}")
        return files

    def read_csv(self, *paths, header: bool = True, sep: str = ",",
                 columns=None) -> DataFrame:
        """CSV files, parsed on the host; the column types are inferred
        from the first file's first block and pinned for every file."""
        return DataFrame(P.TextScan("csv", self._expand_paths(paths),
                                    columns=columns,
                                    options={"header": header, "sep": sep}),
                         self)

    def read_json(self, *paths, columns=None) -> DataFrame:
        """JSON-lines files, parsed on the host (nested objects become
        structs, arrays arrays)."""
        return DataFrame(P.TextScan("json", self._expand_paths(paths),
                                    columns=columns), self)

    def read_avro(self, *paths, columns=None) -> DataFrame:
        """Avro object container files (``io/avro.py``)."""
        return DataFrame(P.TextScan("avro", self._expand_paths(paths),
                                    columns=columns), self)

    def read_orc(self, *paths, columns=None) -> DataFrame:
        """ORC files, read through pyarrow."""
        return DataFrame(P.TextScan("orc", self._expand_paths(paths),
                                    columns=columns), self)

    def collect(self, plan: P.PlanNode) -> pa.Table:
        depth = getattr(_COLLECT_DEPTH, "d", 0)
        _COLLECT_DEPTH.d = depth + 1
        if depth == 0:
            AQ.on_query_start(self.conf)
        try:
            return self._collect(plan)
        finally:
            _COLLECT_DEPTH.d = depth
            if depth == 0:
                self._last_aqe = AQ.finish_query()

    def last_aqe(self) -> Optional[dict]:
        """The adaptive decisions of the last top-level action: the
        decision list (``decisions``), per-kind ``counts`` and the total
        ``dispatches_saved``; None when it made no decision."""
        return self._last_aqe

    def explain_aqe(self) -> List[str]:
        """The last action's adaptive decisions as report lines
        (``render_text``): a header, then one line a decision."""
        return AQ.render_text(self._last_aqe)

    def _collect(self, plan: P.PlanNode) -> pa.Table:
        if self.conf.get(C.SQL_MODE).lower() == "explainonly":
            self.last_exec = None
            self.last_meta = wrap_and_tag(plan, self.conf)
            _LOG.info("\n%s", self.last_meta.explain(all_ops=True))
            return execute_cpu(localize_plan(plan, self.conf),
                               self.conf.get(C.ANSI_ENABLED))
        root, meta = convert_plan(plan, self.conf, self.device)
        self.last_exec, self.last_meta = root, meta
        explain_mode = self.conf.get(C.SQL_EXPLAIN).upper()
        if explain_mode == "ALL" or (explain_mode == "NOT_ON_TPU"
                                     and not all(m.can_run_on_tpu
                                                 for m in meta.walk())):
            _LOG.info("\n%s", meta.explain(all_ops=explain_mode == "ALL"))
        names = plan.schema.names
        tables = [host_table(b, names) for p in range(root.num_partitions)
                  for b in root.execute_partition(p)]
        return pa.concat_tables(tables) if tables \
            else empty_table(plan.schema)
