"""The session: entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/sql/session.py`` ``TpuSession``
(``create_dataframe``, ``range``, ``read_parquet``, ``collect``, and the device-side
compaction of sparse results before the download).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.plan.overrides import convert_plan
from spark_rapids_tpu_torch.sql.dataframe import DataFrame


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
        #: the root operator of the last collect, for reading its counters
        self.last_exec = None

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
        """Parquet files, flat directories of them (``*.parquet``, names
        starting with ``_`` skipped) or glob patterns; one partition per
        file. Decoded on the device unless
        spark.rapids.sql.decode.device.enabled is false."""
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                if any("=" in d.name for d in os.scandir(p) if d.is_dir()):
                    raise NotImplementedError(
                        f"hive partition discovery (k=v directories under "
                        f"{p!r}) is not ported yet")
                files.extend(sorted(
                    f for f in glob.glob(os.path.join(p, "*.parquet"))
                    if os.path.isfile(f)
                    and not os.path.basename(f).startswith("_")))
            elif any(ch in p for ch in "*?["):
                files.extend(sorted(glob.glob(p)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no input files matched {list(paths)!r}")
        return DataFrame(P.ParquetScan(files, columns), self)

    def collect(self, plan: P.PlanNode) -> pa.Table:
        root = convert_plan(plan, self.conf, self.device)
        self.last_exec = root
        names = plan.schema.names
        tables = []
        for p in range(root.num_partitions):
            for b in root.execute_partition(p):
                # compact sparse masked results on the device before the
                # download (a bucket-route output can be a few-percent
                # occupied 2^18-slot batch)
                if b.row_mask is not None and b.capacity > 16384:
                    b = K.compact_batch(b)
                tables.append(B.to_arrow(b, names))
        if not tables:
            fields = [pa.field(f.name, T.to_arrow(f.dtype))
                      for f in plan.schema.fields]
            return pa.Table.from_arrays([pa.array([], f.type) for f in fields],
                                        schema=pa.schema(fields))
        return pa.concat_tables(tables)
