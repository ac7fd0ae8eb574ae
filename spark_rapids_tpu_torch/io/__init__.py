"""I/O: Parquet input (still-encoded column chunks and footer pruning),
the Avro container format, the columnar file writer and async write
throttling; counterpart of ``spark_rapids_tpu/io``."""
from __future__ import annotations

from typing import Optional, Sequence


def read_parquet_file(path: str, columns: Optional[Sequence[str]] = None):
    """Read ONE parquet file with no dataset-level magic. pyarrow >= 13's
    ``pq.read_table(path)`` goes through the dataset API, which infers
    hive partition columns from ``k=v`` segments anywhere in the path, so
    a partition file's read would duplicate the partition key the scan
    appends itself. ``ParquetFile.read`` is the file-scoped reader."""
    import pyarrow.parquet as pq
    # [] is a real projection (zero data columns): only None means "all"
    return pq.ParquetFile(path).read(
        columns=None if columns is None else list(columns))
