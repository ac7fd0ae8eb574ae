"""Cross-process exchange over shuffle files (counterpart of
``spark_rapids_tpu/shuffle/exchange_files.py``; the same layout, so a
directory written by either package reads in the other).

Reference parity: the reference's shuffle rides Spark's shuffle files
(RapidsShuffleThreadedWriterBase writePartitionedData -> standard
shuffle files), so any executor can fetch any map output. Here the same
contract: a writer process hash-partitions a DataFrame (murmur3 pmod,
bit for bit the in-process exchange's, so every key lands in the reduce
partition the JAX package puts it in) and writes one kudo-framed file
per (map partition, reduce partition) plus a manifest; any other
process mounts the directory as a scan (``plan/nodes.ShuffleFileScan``).
Files are self-describing (the schema in the manifest, checksummed
frames), so the reader shares no memory with the writer.
"""
from __future__ import annotations

import json
import os
from typing import List

from spark_rapids_tpu_torch.shuffle import serde
from spark_rapids_tpu_torch.shuffle.store import (
    read_reduce_partition, write_shuffle_file,
)

MANIFEST = "manifest.json"


def write_exchange(df, root: str, keys: List[str], n_out: int,
                   codec: str = "auto") -> None:
    """Hash-partition ``df`` by ``keys`` on the session's device and
    write the shuffle files and the manifest under root."""
    from spark_rapids_tpu_torch.exec import nodes as X
    from spark_rapids_tpu_torch.expr.core import col
    from spark_rapids_tpu_torch.plan.nodes import bind_expr
    from spark_rapids_tpu_torch.runtime.task import TaskContext

    session = df.session
    child, _ = session.prepare_execution(df.plan)
    ex = X.ShuffleExchangeExec(
        df.plan, [child], session.conf, session.device,
        [bind_expr(col(k), df.plan.schema) for k in keys], n_out=n_out)
    os.makedirs(root, exist_ok=True)
    for r in range(n_out):
        with TaskContext(partition_id=r):
            blobs = [serde.serialize_batch(batch, codec)
                     for batch in ex.execute_partition(r)]
        write_shuffle_file(root, 0, r, blobs)
    schema = df.plan.schema
    manifest = {"n_reduce": n_out,
                "names": list(schema.names),
                "types": [serde.dtype_to_json(t) for t in schema.types]}
    with open(os.path.join(root, MANIFEST), "w") as f:
        json.dump(manifest, f)


def read_manifest(root: str) -> dict:
    with open(os.path.join(root, MANIFEST)) as f:
        return json.load(f)


def read_exchange(session, root: str):
    """Mount a shuffle directory as a DataFrame (one partition per reduce
    partition)."""
    from spark_rapids_tpu_torch.plan import nodes as P
    from spark_rapids_tpu_torch.sql.dataframe import DataFrame
    return DataFrame(P.ShuffleFileScan(root), session)


def read_partition_batches(root: str, reduce_id: int, device="cpu"):
    """One reduce partition's batches, in map order, on ``device``."""
    for blob in read_reduce_partition(root, reduce_id):
        yield serde.deserialize_batch(blob, device=device)
