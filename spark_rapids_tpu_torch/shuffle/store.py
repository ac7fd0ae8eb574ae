"""Spillable shuffle store: serialized partitions under a host budget
(counterpart of ``spark_rapids_tpu/shuffle/store.py``).

Reference parity: ShuffleBufferCatalog.scala / ShuffleReceivedBufferCatalog
(spillable shuffle data) + RapidsShuffleThreadedWriterBase's file output.
Blobs land in host memory; when the store exceeds
spark.rapids.shuffle.hostSpillBudget the largest resident partitions flush
to per-partition spill files (append-only segments). Readers stream blobs
back in insertion order from memory or disk transparently.

This is what stops the exchange being a full in-memory barrier: device
batches are serialized (device planes freed) and the serialized bytes
themselves page out to disk under pressure.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san


class _DiskSeg:
    __slots__ = ("path", "off", "length")

    def __init__(self, path: str, off: int, length: int):
        self.path = path
        self.off = off
        self.length = length

    def read(self) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(self.off)
            return f.read(self.length)


class ShuffleStore:
    """One exchange's worth of serialized partitions."""

    def __init__(self, n_partitions: int, host_budget_bytes: int,
                 spill_dir: Optional[str] = None):
        self.n_partitions = n_partitions
        self.host_budget = host_budget_bytes
        self._lock = _san.lock("shuffle.store")
        #: partition -> ordered blob list; bytes = resident, _DiskSeg = spilled
        self._parts: List[List[object]] = [[] for _ in range(n_partitions)]
        #: per-partition row tally (writer-supplied host ints): the skew
        #: split sizes serialized partitions from this instead of decoding
        #: blobs, the same free decision as the compact path's offsets
        self._rows: List[int] = [0] * n_partitions
        self._resident = 0
        self.bytes_written = 0
        self.bytes_spilled = 0
        self._dir = spill_dir
        self._owns_dir = spill_dir is None
        self._closed = False
        #: partitions with a spill write in flight (guards a victim from
        #: concurrent spills while the file write runs outside the lock)
        self._spilling: set = set()

    def _spill_path(self, p: int) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="torch_shuffle_")
            # spill dirs must not outlive the store: clean on GC/exit even
            # when close() is never called explicitly
            import weakref
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, self._dir, True)
        return os.path.join(self._dir, f"part_{p}.bin")

    def add(self, partition: int, blob: bytes, rows: int = 0) -> None:
        with self._lock:
            assert not self._closed
            self._parts[partition].append(blob)
            self._rows[partition] += int(rows)
            self._resident += len(blob)
            self.bytes_written += len(blob)
        self._enforce_budget()

    def partition_rows(self, partition: int) -> int:
        """Writer-tallied row count for one partition (0 when the writer
        predates the tally or the partition is empty)."""
        with self._lock:
            return self._rows[partition]

    def _enforce_budget(self) -> None:
        # flush the partitions holding the most resident bytes first
        # (largest-victim-first, the spill framework's discipline). The
        # spill-file write runs OUTSIDE self._lock (disk latency must not
        # block every concurrent writer's add() bookkeeping): victim
        # selection and the bookkeeping swap
        # take the lock, `_spilling` keeps two spills off one partition
        # file, and blob indexes stay stable because partition lists
        # only ever append (always under the lock).
        while True:
            with self._lock:
                if self._closed or self._resident <= self.host_budget:
                    return
                sizes = [(sum(len(b) for b in part if isinstance(b, bytes)),
                          p)
                         for p, part in enumerate(self._parts)
                         if p not in self._spilling]
                if not sizes:
                    return  # every candidate is already being spilled
                size, victim = max(sizes)
                if size == 0:
                    return
                self._spilling.add(victim)
                snapshot = list(self._parts[victim])
                path = self._spill_path(victim)
            try:
                from spark_rapids_tpu_torch.runtime import faults as _faults
                segs = []
                try:
                    # injected disk faults surface exactly like real ones
                    # (the OSError handling below)
                    _faults.site("spill.disk")
                    with open(path, "ab") as f:
                        for i, b in enumerate(snapshot):
                            if isinstance(b, bytes):
                                off = f.tell()
                                f.write(b)
                                segs.append((i, off, len(b)))
                except OSError:
                    if self._closed:  # close() raced the spill: the dir
                        return        # is gone and so is the data's owner
                    raise
                with self._lock:
                    if self._closed:
                        return
                    part = self._parts[victim]
                    for i, off, ln in segs:
                        if isinstance(part[i], bytes):
                            part[i] = _DiskSeg(path, off, ln)
                            self._resident -= ln
                            self.bytes_spilled += ln
            finally:
                with self._lock:
                    self._spilling.discard(victim)

    def totals(self) -> dict:
        """Byte totals for the exchange's shuffleBytesWritten/Spilled
        metrics, read once per materialization (never on the per-blob
        path)."""
        with self._lock:
            return {"bytes_written": self.bytes_written,
                    "bytes_spilled": self.bytes_spilled,
                    "bytes_resident": self._resident}

    def iter_partition(self, partition: int) -> Iterator[bytes]:
        for b in list(self._parts[partition]):
            yield b if isinstance(b, bytes) else b.read()

    def num_blobs(self, partition: int) -> int:
        with self._lock:
            return len(self._parts[partition])

    def read_blob(self, partition: int, index: int) -> bytes:
        """One blob by stable index (partition lists only ever append).
        Disk-resident blobs re-read their file segment on every call —
        the integrity-recovery path re-fetches a corrupt blob through
        here, so a transient disk read error heals on the second pass."""
        with self._lock:
            b = self._parts[partition][index]
        return b if isinstance(b, bytes) else b.read()

    def partition_bytes(self, partition: int) -> int:
        return sum(len(b) if isinstance(b, bytes) else b.length
                   for b in self._parts[partition])

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._parts = [[] for _ in range(self.n_partitions)]
            self._resident = 0
            rm_dir, self._dir = (self._dir if self._owns_dir else None), \
                (None if self._owns_dir else self._dir)
        # directory removal OUTSIDE the lock: _closed already fences every
        # other method, and rmtree of a large spill dir is unbounded I/O
        if rm_dir and os.path.isdir(rm_dir):
            shutil.rmtree(rm_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Cross-process shuffle files (the Spark-shuffle-files analog): a stable
# on-disk layout one process writes and another reads. Format per file:
# repeated [u64 little-endian blob length][blob bytes]; one file per
# (map partition, reduce partition).
# ---------------------------------------------------------------------------

def shuffle_file(root: str, map_id: int, reduce_id: int) -> str:
    return os.path.join(root, f"map_{map_id}_reduce_{reduce_id}.shuf")


def write_shuffle_file(root: str, map_id: int, reduce_id: int,
                       blobs: List[bytes]) -> str:
    os.makedirs(root, exist_ok=True)
    path = shuffle_file(root, map_id, reduce_id)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        for b in blobs:
            f.write(len(b).to_bytes(8, "little"))
            f.write(b)
    os.replace(tmp, path)
    return path


def read_shuffle_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            ln = int.from_bytes(hdr, "little")
            yield f.read(ln)


def read_reduce_partition(root: str, reduce_id: int) -> Iterator[bytes]:
    """All map outputs for one reduce partition, map order."""
    import glob
    import re
    paths = glob.glob(os.path.join(root, f"map_*_reduce_{reduce_id}.shuf"))

    def map_of(p):
        m = re.search(r"map_(\d+)_reduce_", os.path.basename(p))
        return int(m.group(1))

    for p in sorted(paths, key=map_of):
        yield from read_shuffle_file(p)
