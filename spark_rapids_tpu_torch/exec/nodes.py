"""Physical operators: per-partition iterators of device batches.

Counterpart of ``spark_rapids_tpu/exec/tpu_nodes.py`` for this engine's
operators: ``InMemoryScanExec``, the Parquet scans (``ParquetScanExec``,
which decodes on the host, and the device-decode pair
``EncodedParquetSourceExec`` + ``DeviceDecodeScanExec``; both prune hive
partition files and append the partition columns), ``TextScanExec``
(CSV, JSON lines, Avro and ORC, parsed on the host),
``ShuffleFileScanExec`` (a cross-process shuffle directory),
``CachedScanExec``, ``ProjectExec``,
``FilterExec``, ``CoalesceBatchesExec``, ``RangeExec``, ``UnionExec``,
``ExpandExec``, ``GenerateExec``, ``CollectExchangeExec``, the
in-process exchanges (``ShuffleExchangeExec``, ``RoundRobinExchangeExec``,
``RangeExchangeExec``: compact or masked, with tiny coalescing and the
skew split on read; the hash exchange also has the SERIALIZED mode, a
kudo-framed spillable host store read back through
``_LazyShuffleBlobs``), ``HashAggregateExec``
(partial, final or complete) with ``_AggKernels``, ``LimitExec``, ``TopNExec``, ``SortExec``,
``WindowExec``, the hash joins (``BroadcastHashJoinExec``,
``ShuffledHashJoinExec``, and ``AdaptiveJoinExec`` with
``_MaterializedExec``, which pick between them at run time; the other
adaptive join is ``exec/adaptive.py``'s), the nested-loop and cartesian joins
(``BroadcastNestedLoopJoinExec``, ``CartesianProductExec``), and
``CpuFallbackExec``, which runs one plan node that planning tagged off
the device on the CPU backend (``exec/cpu_backend.py``).

PyTorch runs eagerly, so each operator is plain tensor code per batch.
Each operator's per-batch device work passes the dispatch choke point
``exec/fuse.fused`` under the JAX package's key families, and the narrow
operators (projection, filter, Expand, limit, the device decode) expose
their per-batch bodies as ``stage_body()`` (module-level builders that
capture expressions, static settings and the device, never the operator),
which ``exec/stage_fusion.py`` composes into fused stages and aggregates'
absorbed pre-chains.

The query runtime (``runtime/``) is wired where the JAX package wires it.
``execute_partition(pidx)`` keeps its signature: an operator reads its
task from the thread (``TaskContext.peek()``) instead of a passed ctx.
``_acquire`` admits the task to the device semaphore where an operator
first touches the card; a cache, an exchange or a build side runs each
child partition as a task of its own, one after another (the JAX
package runs an exchange's as a task wave; here they would share one
CUDA stream), a cache keeps each partition as a
``SpillableColumnarBatch``, and the aggregate's update runs under
``with_retry``.

The hash aggregate picks a route per batch, in the JAX package's order:

1. tiny-bucket: dict-string keys whose vocabulary holds each string
   once, and bool keys, with at most 4096 key combinations
   (``ops/groupby.bucket_agg``);
2. packed radix: integer, date, bool and such dict keys packed into one
   int64 plane (``ops/radix``). With 11-24 packed bits and 1-2 float sums
   plus counts it takes the segsum kernel (``ops/segsum``), per
   CHUNK_ROWS slice for large batches; otherwise, or when a group
   outgrows the kernel's exact range or a NaN/Inf appears, the
   scatter-bucket reductions. Packed keys wider than 23 bits take the
   packed sort route: a stable sort of the packed plane and segmented
   reductions by cumsum differences (``ops/radix.group_layout``);
3. the sort route for every other key (flat strings, dictionaries that
   may repeat a string, floats): stable sorts on 64-bit keys, then
   segmented reductions (``ops/groupby.group_segments``). Partial states
   merge in the same order: tiny-bucket, packed, then this route.

A segmented aggregate (percentile, min_by/max_by) has no mergeable state:
it takes the sort route over the partition's batches concatenated (or the
global route without keys), and computes its result from the
group-sorted rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, LazyRowCount, column_from_arrow, from_arrow,
    round_capacity, to_arrow,
)
from spark_rapids_tpu_torch.exec import compiled
from spark_rapids_tpu_torch.exec import cpu_backend as CPU
from spark_rapids_tpu_torch.exec import fuse
from spark_rapids_tpu_torch.expr import aggregates as A
from spark_rapids_tpu_torch.expr import window as WE
from spark_rapids_tpu_torch.expr.core import (
    Alias, BoundRef, Cast, EvalCtx, Expression, needs_partition_context,
    needs_row_base, raise_errors,
)
from spark_rapids_tpu_torch.io import encoded as ENC
from spark_rapids_tpu_torch.io.parquet_pruning import (
    prune_partition_file, prune_row_groups,
)
from spark_rapids_tpu_torch.ops import decode as D
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import join as J
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import radix as R
from spark_rapids_tpu_torch.ops import repartition as RP
from spark_rapids_tpu_torch.ops import segsum as S
from spark_rapids_tpu_torch.ops import window as W
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.runtime import faults as FLT
from spark_rapids_tpu_torch.runtime import lifecycle as LC
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import trace as TR
from spark_rapids_tpu_torch.runtime.semaphore import (
    get_semaphore, peek_semaphore,
)
from spark_rapids_tpu_torch.runtime.task import TaskContext

_LOG = logging.getLogger("spark_rapids_tpu_torch")


class TorchExec:
    """One physical operator. ``metrics`` is its ``MetricsRegistry``
    (``runtime/metrics.py``) under the JAX package's names; the session's
    ``last_metrics()`` snapshots every operator of the last action.

    The timers (``span``) run on the host clock around the operator's own
    work on a batch, the child's iteration left out. On the card that is
    the time the host spent issuing the batch's kernels (and waiting in
    any device-to-host read the work itself makes), not the kernels'
    device time: CUDA work is asynchronous, and no timer synchronizes."""

    def __init__(self, plan, children: List["TorchExec"], conf, device):
        self.plan = plan
        self.children = children
        self.conf = conf
        self.device = torch.device(device)
        self.metrics = M.MetricsRegistry(M.metrics_level_from_conf(conf))

    def span(self, metric):
        """Trace span + the paired GpuMetric timer as ONE instrumentation
        point (the NvtxWithMetrics contract): tracing off returns the
        metric's own timer; tracing on also emits an
        ``ExecName.metricName`` complete event on this task's track and
        opens a torch.profiler range of that name."""
        return TR.exec_span(self, metric)

    @property
    def schema(self) -> T.Schema:
        """The schema of the batches this operator yields."""
        return self.plan.schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def execute_partition(self, pidx: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def walk(self) -> Iterator["TorchExec"]:
        """This operator and every operator below it, depth first; a fused
        stage's members and an aggregate's absorbed pre-chain are visited
        after their node, an adaptive node is followed into the operator
        it chose at run time and then into its own children, each
        operator visited once."""
        seen = set()

        def visit(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            yield n
            for m in (getattr(n, "members", None) or []) + (
                    getattr(n, "pre_chain_members", None) or []):
                yield from visit(m)
            chosen = getattr(n, "_chosen", None)
            for c in ([chosen] if chosen is not None else []) + n.children:
                yield from visit(c)

        yield from visit(self)

    def name(self) -> str:
        mode = getattr(self, "mode", None)
        return type(self).__name__ + (f"({mode})" if mode else "")

    def tree_string(self, indent: int = 0) -> str:
        """The operator tree, one ``name <- plan node`` line each, in the
        JAX package's layout (an aggregate names its mode); an adaptive
        node shows the operator it chose, once it has chosen."""
        lines = [f"{'  ' * indent}{self.name()} <- {self.plan.describe()}"]
        chosen = getattr(self, "_chosen", None)
        lines += [c.tree_string(indent + 1)
                  for c in ([chosen] if chosen is not None
                            else self.children)]
        return "\n".join(lines)

    def _ctx(self, batch: ColumnarBatch, live=None, **part) -> EvalCtx:
        return EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                       self.device, self.conf.get(C.ANSI_ENABLED),
                       live=batch.live_mask() if live is None else live,
                       **part)

    def _acquire(self) -> None:
        """Admit the thread's task to the device (the semaphore) where it
        first touches the card; an operator driven outside any task
        admits nothing."""
        ctx = TaskContext.peek()
        if ctx is None:
            return
        get_semaphore(self.conf).acquire_if_necessary(ctx)
        ctx.holds_device_data = True


@contextlib.contextmanager
def _materializing(lock):
    """Hold a materialization lock (a cache, an exchange, a build side).
    A task that would block on it, because another thread materializes,
    gives its device permit back first, so that thread can be admitted
    while it waits."""
    if not lock.acquire(blocking=False):
        ctx = TaskContext.peek()
        sem = peek_semaphore()
        if ctx is not None and sem is not None:
            sem.release_for_wait(ctx)
        lock.acquire()
    try:
        yield
    finally:
        lock.release()


def _partitions(child: "TorchExec"):
    """Each partition of a child, run to its end as a task of its own
    (nested in the calling task): [batches of partition p, ...]."""
    out = []
    for p in range(child.num_partitions):
        with TaskContext(partition_id=p):
            out.append(list(child.execute_partition(p)))
    return out


def _task_batches(child: "TorchExec"):
    """The batches of every partition of a child, streamed in partition
    order, each partition run as a task of its own (nested in the calling
    task). Close the generator when done with it, so the last task
    completes however the consumer ends."""
    for p in range(child.num_partitions):
        with TaskContext(partition_id=p):
            yield from child.execute_partition(p)


def _split_rows(total: int, parts: int):
    base, rem = divmod(total, parts)
    out, start = [], 0
    for i in range(parts):
        n = base + (1 if i < rem else 0)
        out.append((start, n))
        start += n
    return out


class InMemoryScanExec(TorchExec):
    """Slices a pyarrow table into partitions and batches and uploads."""

    @property
    def num_partitions(self):
        return self.plan.num_partitions

    def execute_partition(self, pidx):
        table = self.plan.table
        start, n = _split_rows(table.num_rows, self.num_partitions)[pidx]
        max_rows = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        copy_t = self.metrics.metric(M.COPY_TO_DEVICE_TIME)
        off = 0
        while off < n or (n == 0 and off == 0):
            take = min(max_rows, n - off)
            self._acquire()
            FLT.site("scan.decode")
            with self.span(copy_t):
                b = from_arrow(table.slice(start + off, take), self.device)
            out_rows.add(take)
            out_batches.add(1)
            yield b
            off += max(take, 1)


# ---------------------------------------------------------------------------
# Parquet scans
# ---------------------------------------------------------------------------

def _prefetched(items, load_fn, n_threads: int, conf=None):
    """load_fn(item) for each item, in order, with at most n_threads loads
    running ahead of the consumer on the process-wide host pool
    (reference MultiFileReaderThreadPool), so host decode overlaps the
    upload and the device work without buffering a whole file."""
    if n_threads <= 1 or len(items) <= 1:
        for it in items:
            yield load_fn(it)
        return
    from spark_rapids_tpu_torch.runtime.host_pool import get_host_pool
    yield from get_host_pool(conf).map_ordered(load_fn, items,
                                               max_concurrency=n_threads)


def _host_coalesced(tables, target_rows: int):
    """Concatenate host tables until the target row count is reached, so
    one upload carries many small row groups (the COALESCING reader)."""
    import pyarrow as pa
    pending, rows = [], 0
    for t in tables:
        pending.append(t)
        rows += t.num_rows
        if rows >= target_rows:
            yield pa.concat_tables(pending) if len(pending) > 1 else pending[0]
            pending, rows = [], 0
    if pending:
        yield pa.concat_tables(pending) if len(pending) > 1 else pending[0]


class _ParquetExec(TorchExec):
    """One partition per kept file: a file whose hive partition values
    refute a pushed filter is dropped when the operator is built, and row
    groups are pruned by the pushed filters against the footer
    statistics. ``metrics`` holds the JAX package's scan metrics
    (gpuDecodeTime for its tpuDecodeTime), and ``numFiles`` and
    ``numFilesPruned``."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        # a snapshot: a later pushdown over a plan sharing this scan must
        # not change the filters under a converted exec
        self._pushed = list(plan.pushed_filters)
        pv = plan.partition_values
        n = len(plan.paths)
        self._kept_files = [i for i in range(n) if prune_partition_file(
            pv[i], plan.schema, self._pushed)] if pv and self._pushed \
            else list(range(n))
        self.metrics.metric(M.NUM_FILES).set(n)
        self.metrics.metric(M.NUM_FILES_PRUNED).set(
            n - len(self._kept_files))

    @property
    def num_partitions(self):
        return max(1, len(self._kept_files))

    def _file(self, pidx):
        """(file index, path) of partition pidx, or None when every file
        was pruned."""
        if not self._kept_files:
            return None
        fidx = self._kept_files[pidx]
        return fidx, self.plan.paths[fidx]

    def _file_fields(self):
        """The schema's fields that live in the files (the partition
        columns come last and are not read)."""
        n_part = len(self.plan.partition_fields())
        fields = list(self.plan.schema.fields)
        return fields[: len(fields) - n_part] if n_part else fields

    def _groups(self, metadata):
        groups, total = prune_row_groups(metadata, self._pushed)
        self.metrics.metric(M.NUM_ROW_GROUPS).add(total)
        self.metrics.metric(M.NUM_ROW_GROUPS_PRUNED).add(total - len(groups))
        self.metrics.metric(M.READ_BYTES).add(sum(
            metadata.row_group(g).total_byte_size for g in groups))
        return groups, total

    def _emitted(self, rows: int) -> None:
        self.metrics.metric(M.NUM_OUTPUT_ROWS).add(rows)
        self.metrics.metric(M.NUM_OUTPUT_BATCHES).add(1)


class ParquetScanExec(_ParquetExec):
    """The host-decode scan: pyarrow reads and decodes each kept row
    group, then one upload per batch. Reader strategies
    (spark.rapids.sql.format.parquet.reader.type): PERFILE loads row
    groups one by one; MULTITHREADED prefetches them on a bounded pool;
    COALESCING and AUTO also concatenate them on the host up to the
    reader batch size."""

    def execute_partition(self, pidx):
        import pyarrow.parquet as pq
        got = self._file(pidx)
        if got is None:
            return
        fidx, path = got
        names = [f.name for f in self._file_fields()]
        mode = str(self.conf.get(C.MULTIFILE_READER_TYPE)).upper()
        threads = 1 if mode == "PERFILE" \
            else int(self.conf.get(C.MULTIFILE_READER_THREADS))
        decode_t = self.metrics.metric(M.DECODE_TIME)
        copy_t = self.metrics.metric(M.COPY_TO_DEVICE_TIME)
        groups, total = self._groups(pq.ParquetFile(path).metadata)
        if not groups:
            if total:
                return  # every row group refuted
            groups = [-1]  # a file without row groups: read it whole

        def load(g):
            # one ParquetFile per load: parquet-cpp readers are not
            # thread-safe, and loads run on the prefetch workers
            FLT.site("scan.decode")
            with self.span(decode_t):
                f = pq.ParquetFile(path)
                return f.read(columns=names) if g < 0 \
                    else f.read_row_group(g, columns=names)

        batch_rows = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        tables = _prefetched(groups, load, threads, self.conf)
        if mode in ("COALESCING", "AUTO"):
            tables = _host_coalesced(tables, batch_rows)
        for tbl in tables:
            tbl = self.plan.with_partition_cols(tbl, fidx)
            off = 0
            while off < tbl.num_rows or (tbl.num_rows == 0 and off == 0):
                chunk = tbl.slice(off, batch_rows)
                self._emitted(chunk.num_rows)
                self._acquire()
                with self.span(copy_t):
                    b = from_arrow(chunk, self.device)
                yield b
                off += max(chunk.num_rows, 1)


class EncodedParquetSourceExec(_ParquetExec):
    """The leaf of the device-decode scan: instead of decoding through
    pyarrow it extracts the still-encoded column chunks (io/encoded.py)
    and uploads those planes as EncodedBatches. Columns outside the
    supported matrix are host-decoded here, per column, and ride in the
    batch as ready columns; their reasons gather in
    ``fallback_columns`` (a footer probe at plan time, then what the
    pages showed)."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        self.fallback_columns: Dict[str, str] = ENC.probe_support(
            plan.paths[self._kept_files[0]], self._file_fields()) \
            if self._kept_files else {}

    def _partition_columns(self, fidx, n, cap):
        """The file's constant partition columns as decoded columns
        beside the encoded ones (so the decode reads the file's own
        columns only)."""
        out = []
        for f, arr in self.plan.partition_arrays(fidx, n):
            cv = column_from_arrow(arr, f.dtype, cap, self.device)
            out.append(ENC.EncodedColumn("decoded", f.dtype, {}, (), cv=cv,
                                         bounds=cv.bounds))
        return out

    def execute_partition(self, pidx):
        import pyarrow as pa
        import pyarrow.parquet as pq
        got = self._file(pidx)
        if got is None:
            return
        fidx, path = got
        fields = self._file_fields()
        decode_t = self.metrics.metric(M.DECODE_TIME)
        copy_t = self.metrics.metric(M.COPY_TO_DEVICE_TIME)
        enc_bytes = self.metrics.metric(M.ENCODED_BYTES)
        dec_bytes = self.metrics.metric(M.DECODED_BYTES)
        fb_cols = self.metrics.metric(M.NUM_DECODE_FALLBACK_COLUMNS)
        pf = pq.ParquetFile(path)
        groups, total = self._groups(pf.metadata)
        if not groups:
            if total:
                return  # every row group refuted: nothing read or uploaded
            # a file without row groups: host read, every column decoded
            FLT.site("scan.decode")
            with self.span(decode_t):
                tbl = self.plan.with_partition_cols(
                    pf.read(columns=[f.name for f in fields]), fidx)
            self._acquire()
            with self.span(copy_t):
                b = from_arrow(tbl, self.device)
            self._emitted(int(b.num_rows))
            yield ENC.EncodedBatch(
                [ENC.EncodedColumn("decoded", c.dtype, {}, cv=c,
                                   bounds=c.bounds) for c in b.columns],
                int(b.num_rows), b.capacity)
            return
        hbs = ENC.read_encoded_batches(
            path, pf.metadata, groups, fields,
            self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS),
            min(32, int(self.conf.get(C.DEVICE_DECODE_MAX_BITS))),
            bool(self.conf.get(C.DEVICE_DECODE_DELTA)))
        while True:
            FLT.site("scan.decode")
            with self.span(decode_t):
                hb = next(hbs, None)
            if hb is None:
                return
            self.fallback_columns.update(hb.fallback)
            fb_idx = [i for i, c in enumerate(hb.columns) if c is None]
            tbl = None
            if fb_idx:
                fb_cols.add(len(fb_idx))
                with self.span(decode_t):
                    parts = [pf.read_row_group(g, columns=[
                        fields[i].name for i in fb_idx]) for g in hb.groups]
                    tbl = (pa.concat_tables(parts) if len(parts) > 1
                           else parts[0]).combine_chunks()
            self._acquire()
            with self.span(copy_t):
                decoded = {}
                for j, i in enumerate(fb_idx):
                    arr = tbl.column(j)
                    arr = arr.chunk(0) if arr.num_chunks \
                        else arr.combine_chunks()
                    decoded[i] = column_from_arrow(arr, fields[i].dtype,
                                                   hb.cap, self.device)
                eb = ENC.upload(hb, decoded, self.device)
                eb.columns.extend(self._partition_columns(
                    fidx, hb.num_rows, hb.cap))
            enc_bytes.add(hb.encoded_bytes)
            dec_bytes.add(eb.decoded_size())
            self._emitted(hb.num_rows)
            yield eb


class TextScanExec(TorchExec):
    """A CSV, JSON-lines, Avro or ORC scan, one partition per file: the
    host parse (``TextScan.read_host``), then uploads of at most
    spark.rapids.sql.reader.batchSizeRows rows (reference GpuCSVScan /
    GpuJsonScan / GpuOrcScan). ``metrics``: decode (the parse) and copy
    times, rows and batches."""

    @property
    def num_partitions(self):
        return max(1, len(self.plan.paths))

    def execute_partition(self, pidx):
        decode_t = self.metrics.metric(M.DECODE_TIME)
        copy_t = self.metrics.metric(M.COPY_TO_DEVICE_TIME)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        FLT.site("scan.decode")
        with self.span(decode_t):
            table = self.plan.read_host(self.plan.paths[pidx])
        batch_rows = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        n = table.num_rows
        off = 0
        while off < n or (n == 0 and off == 0):
            take = min(batch_rows, n - off)
            self._acquire()
            with self.span(copy_t):
                b = from_arrow(table.slice(off, take), self.device)
            out_rows.add(take)
            out_batches.add(1)
            yield b
            off += max(take, 1)


def device_decode_stage_body() -> fuse.StageBody:
    """The device decode as a fusable stage body: its input is the
    EncodedBatch and it runs the decode (ops/decode.py, with the
    bitslice kernel) first, so a Filter or an aggregate's update composes
    after it into one call a batch over encoded bytes. An already decoded
    batch (the unfused fallback's replay) passes through."""
    def build():
        def fn(batch, pid, carry):
            if isinstance(batch, ColumnarBatch):
                return batch, [], carry
            return D.decode_batch(batch), [], carry
        return fn

    return fuse.StageBody(("device_decode",), build,
                          bounds_map=lambda bs: list(bs),
                          name="DeviceDecode")


class DeviceDecodeScanExec(TorchExec):
    """Expands the child's EncodedBatches into ColumnarBatches on the
    device, one batch at a time, through its stage body. The row count
    stays the host int the source knew, so no device read is needed for
    it."""

    def stage_body(self) -> fuse.StageBody:
        return device_decode_stage_body()

    def execute_partition(self, pidx):
        op_t = self.metrics.metric(M.OP_TIME)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        body = self.stage_body()
        fn = fuse.fused(body.key, body.builder)
        carry = body.init_carry()
        for eb in self.children[0].execute_partition(pidx):
            self._acquire()
            with self.span(op_t):
                out, errs, carry = fn(eb, pidx, carry)
            compiled.raise_errors(errs)
            out_rows.add(eb.num_rows)
            out_batches.add(1)
            yield out


class ShuffleFileScanExec(TorchExec):
    """Reads a cross-process shuffle directory
    (``shuffle/exchange_files.py``): each reduce partition streams its map
    outputs' kudo frames, parsed on the host into pinned staging planes,
    onto the device under the task's permit (reference: the shuffle
    reader fetching map outputs). ``metrics``: decode and copy times,
    rows and batches."""

    @property
    def num_partitions(self):
        return max(1, self.plan.n_reduce)

    def execute_partition(self, pidx):
        from spark_rapids_tpu_torch.shuffle import serde
        from spark_rapids_tpu_torch.shuffle.store import (
            read_reduce_partition,
        )
        decode_t = self.metrics.metric(M.DECODE_TIME)
        copy_t = self.metrics.metric(M.COPY_TO_DEVICE_TIME)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        pinned = self.device.type == "cuda"
        for blob in read_reduce_partition(self.plan.root, pidx):
            with self.span(decode_t):
                host = serde.deserialize_host(blob, pinned=pinned)
            self._acquire()
            with self.span(copy_t):
                b = serde.upload(host, self.device)
            out_rows.add(b.num_rows)
            out_batches.add(1)
            yield b


class CachedScanExec(TorchExec):
    """Materializes the child once into one batch per partition, each
    registered with the spill framework (``SpillableColumnarBatch``) and
    stored on the CachedRelation node; later scans stream from it, and
    under memory pressure a partition pages out to the host or the disk
    and back instead of failing. The handles close when the relation
    node is collected. Each relation has its own reentrant lock: a cached
    relation over another one materializes the inner one under it."""

    #: guards the creation of each relation's own lock
    _lock = threading.Lock()

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def num_partitions(self):
        if self.plan.materialized is not None:
            return len(self.plan.materialized)
        return self.children[0].num_partitions

    def _relation_lock(self):
        """The relation's own lock, shared by every scan of it: a cache
        under an exchange under another cache materializes on a task-wave
        thread while the outer one holds its lock."""
        with CachedScanExec._lock:
            lk = getattr(self.plan, "_materialize_lock", None)
            if lk is None:
                lk = self.plan._materialize_lock = threading.RLock()
        return lk

    def _materialize(self):
        from spark_rapids_tpu_torch.runtime.memory import (
            SpillableColumnarBatch,
        )
        if self.plan.materialized is not None:
            return self.plan.materialized
        with _materializing(self._relation_lock()):
            if self.plan.materialized is None:
                child = self.children[0]
                out = []
                for p in range(child.num_partitions):
                    with TaskContext(partition_id=p):
                        batches = list(child.execute_partition(p))
                    if batches:
                        merged = K.compact_batch(K.concat_batches(batches))
                        _attach_column_stats(merged)
                        del batches
                        batches = [SpillableColumnarBatch(merged)]
                        del merged
                    out.append(batches)
                self.plan.materialized = out
                weakref.finalize(self.plan, _close_cached, out)
        return self.plan.materialized

    def execute_partition(self, pidx):
        for sb in self._materialize()[pidx]:
            yield sb.get_batch()


def _close_cached(parts) -> None:
    """Release a collected relation's handles (their device or host
    planes, and any spill files)."""
    for batches in parts:
        for sb in batches:
            sb.close()


_STAT_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type, T.DateType,
               T.DecimalType)


def _attach_column_stats(batch: ColumnarBatch) -> None:
    """Cache-time (min, max) of every integer column, fetched in one
    transfer and carried as ColumnVector.bounds."""
    idxs, pending = [], []
    for i, c in enumerate(batch.columns):
        if c.is_string or not isinstance(c.dtype, _STAT_TYPES):
            continue
        v = c.data.to(torch.int64)
        valid = c.validity_or_default(batch.num_rows)
        pending.extend([torch.where(valid, v, 2 ** 62).min(),
                        torch.where(valid, v, -2 ** 62).max()])
        idxs.append(i)
    if not idxs:
        return
    vals = torch.stack(pending).cpu().tolist()
    for j, i in enumerate(idxs):
        lo, hi = vals[2 * j], vals[2 * j + 1]
        if lo <= hi:
            batch.columns[i].bounds = (lo, hi)


def live_rows(batch: ColumnarBatch):
    """The live rows of a batch as a host int or a LazyRowCount, never a
    sync: the row count where it counts the live rows, else the sum of
    the selection mask left on the device."""
    if batch.row_mask is None or isinstance(batch.num_rows, LazyRowCount):
        return batch.num_rows
    return LazyRowCount(batch.row_mask.sum(dtype=torch.int64))


# ---------------------------------------------------------------------------
# Stage bodies: the narrow operators' per-batch work as fuse.StageBody
# records (JAX tpu_nodes.py:625-773), composed by exec/stage_fusion.py.
# Builders are module-level and capture expressions, static settings and
# the device, never the operator.
# ---------------------------------------------------------------------------

def _project_bounds_map(exprs):
    """Column bounds across a projection: passthrough references carry
    their input column's bounds."""
    def bmap(in_bounds):
        out = []
        for e in exprs:
            inner = e.children[0] if isinstance(e, Alias) else e
            if isinstance(inner, BoundRef) and inner.index < len(in_bounds):
                out.append(in_bounds[inner.index])
            else:
                out.append(None)
        return out
    return bmap


def project_stage_body(exprs, ansi: bool, device,
                       trivial=None) -> fuse.StageBody:
    """A projection's body. The partition context (the partition index,
    and the live rows of the partition's earlier batches when an
    expression reads them) rides as the row-base carry."""
    dev = str(device)
    if trivial is not None:
        idx = tuple(trivial)

        def build_trivial():
            def fn(batch, pid, carry):
                return (ColumnarBatch([batch.columns[i] for i in idx],
                                      batch.num_rows, batch.row_mask),
                        [], carry)
            return fn

        return fuse.StageBody(
            ("project_trivial", idx), build_trivial,
            bounds_map=lambda bs: [bs[i] if i < len(bs) else None
                                   for i in idx],
            name="Project")

    needs_part_ctx = any(needs_partition_context(e) for e in exprs)
    count_rows = any(needs_row_base(e) for e in exprs)

    def build():
        def fn(batch, pid, row_base):
            ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                          device, ansi, live=batch.live_mask(),
                          partition_id=pid, row_base=row_base)
            cols = [e.eval(ctx) for e in exprs]
            if count_rows:  # only pay the count when ids need it
                row_base = row_base + ctx.row_mask.sum(dtype=torch.int64)
            return (ColumnarBatch(cols, batch.num_rows, batch.row_mask),
                    list(ctx.errors), row_base)
        return fn

    key = ("project", tuple(e.fingerprint() for e in exprs), ansi,
           needs_part_ctx, dev)
    return fuse.StageBody(key, build, bounds_map=_project_bounds_map(exprs),
                          has_carry=needs_part_ctx, name="Project")


def filter_stage_body(cond, ansi: bool, device) -> fuse.StageBody:
    """A filter's body: failing rows marked dead in the selection mask,
    the survivors' count left on the device. A condition that reads the
    partition context (``rand``) gets a projection's, with the row-base
    carry (the port runs such a filter on the device; the planner keeps
    it out of fused stages, as the JAX package runs it on the CPU)."""
    part = needs_partition_context(cond)
    count_rows = needs_row_base(cond)

    def build():
        def fn(batch, pid, carry):
            live = batch.live_mask()
            ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                          device, ansi, live=live,
                          partition_id=pid if part else None,
                          row_base=carry if part else 0)
            pred = cond.eval(ctx)
            if count_rows:
                carry = carry + ctx.row_mask.sum(dtype=torch.int64)
            # validity=None means valid on every live row (a masked
            # input keeps live rows past the live count)
            valid = pred.validity if pred.validity is not None \
                else ctx.row_mask
            return (K.mask_filter_batch(batch,
                                        pred.data.to(torch.bool) & valid),
                    list(ctx.errors), carry)
        return fn

    # a filter's output columns are row subsets of its input: bounds pass
    return fuse.StageBody(("filter", cond.fingerprint(), ansi, part,
                           str(device)), build,
                          bounds_map=lambda bs: list(bs),
                          has_carry=part, name="Filter")


def expand_stage_body(proj_exprs, n_cols: int, device) -> fuse.StageBody:
    """Every projection of an Expand evaluated and stacked into one batch
    of n_proj x capacity with the live mask tiled (the unfused operator
    yields one batch per projection). Built only for fixed-width outputs
    (``stage_fusion._fusable``). No column bounds pass."""
    nproj = len(proj_exprs)

    def build():
        def fn(batch, pid, carry):
            live = batch.live_mask()
            errs = []
            per_proj = []
            for exprs in proj_exprs:
                ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                              device, False, live=live)
                per_proj.append([e.eval(ctx) for e in exprs])
                errs.extend(ctx.errors)
            out_cols = []
            for ci in range(n_cols):
                parts = [p[ci] for p in per_proj]
                out_cols.append(ColumnVector(
                    parts[0].dtype, torch.cat([c.data for c in parts]),
                    torch.cat([c.validity if c.validity is not None
                               else live for c in parts])))
            mask = live.repeat(nproj)
            return (ColumnarBatch(out_cols, LazyRowCount(mask.sum(
                dtype=torch.int32)), mask), errs, carry)
        return fn

    key = ("expand_stage",
           tuple(tuple(e.fingerprint() for e in p) for p in proj_exprs),
           str(device))
    return fuse.StageBody(key, build,
                          bounds_map=lambda bs: [None] * n_cols,
                          name="Expand")


def limit_stage_body(n: int, device) -> fuse.StageBody:
    """A device LIMIT: rows past the remaining budget are masked dead and
    the budget rides as a device carry. The fused driver reads the carry
    each batch to stop consuming input once it reaches zero
    (``exhausts``)."""
    def build():
        def fn(batch, pid, remaining):
            live = batch.live_mask()
            pos = torch.cumsum(live.to(torch.int64), 0)
            keep = live & (pos <= remaining)
            taken = keep.sum(dtype=torch.int64)
            count = keep.sum(dtype=torch.int32)
            return (ColumnarBatch(batch.columns, LazyRowCount(count), keep),
                    [], torch.clamp(remaining - taken, min=0))
        return fn

    # n reaches the body only as the carry: one entry serves every LIMIT
    return fuse.StageBody(("limit_stage", str(device)), build,
                          carry_init=lambda: torch.tensor(
                              n, dtype=torch.int64, device=device),
                          bounds_map=lambda bs: list(bs),
                          has_carry=True, exhausts=True, name="Limit")


class ProjectExec(TorchExec):
    def _trivial_indices(self):
        """Pure column selection costs no work: planes are re-listed."""
        idx = []
        for e in self.plan.exprs:
            inner = e.children[0] if isinstance(e, Alias) else e
            if not (isinstance(inner, BoundRef)
                    and inner.dtype == e.data_type()):
                return None
            idx.append(inner.index)
        return idx

    def stage_body(self) -> fuse.StageBody:
        return project_stage_body(self.plan.exprs,
                                  self.conf.get(C.ANSI_ENABLED), self.device,
                                  trivial=self._trivial_indices())

    def execute_partition(self, pidx):
        """Evaluates the expressions per batch with the partition context:
        the partition's index, and the live rows of its earlier batches
        (counted only when an expression reads them)."""
        op_t = self.metrics.metric(M.OP_TIME)
        trivial = self._trivial_indices()
        if trivial is not None:
            for batch in self.children[0].execute_partition(pidx):
                yield ColumnarBatch([batch.columns[i] for i in trivial],
                                    batch.num_rows, batch.row_mask)
            return
        body = self.stage_body()
        fn = fuse.fused(body.key, body.builder)
        row_base = body.init_carry()
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            with self.span(op_t):
                out, errs, row_base = fn(batch, pidx, row_base)
                compiled.raise_errors(errs)
            compiled.carry_bounds(self.plan.exprs, batch.columns,
                                  out.columns)
            yield out


class FilterExec(TorchExec):
    """Marks failing rows dead in the selection mask; no gather, no sync.
    A condition that reads the partition context (``rand``, the partition
    ids) gets a projection's: the planner collects such a filter's input
    into one partition first, as the JAX package's CPU placement of it
    does."""

    def stage_body(self) -> fuse.StageBody:
        return filter_stage_body(self.plan.condition,
                                 self.conf.get(C.ANSI_ENABLED), self.device)

    def execute_partition(self, pidx):
        op_t = self.metrics.metric(M.FILTER_TIME)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        body = self.stage_body()
        fn = fuse.fused(body.key, body.builder)
        carry = body.init_carry()
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            with self.span(op_t):
                out, errs, carry = fn(batch, pidx, carry)
                compiled.raise_errors(errs)
            out_rows.add(out.num_rows)
            yield out


class CoalesceBatchesExec(TorchExec):
    """Concatenates batches up to spark.rapids.sql.batchSizeBytes."""

    @property
    def schema(self):
        return self.children[0].schema

    def execute_partition(self, pidx):
        concat_t = self.metrics.metric(M.CONCAT_TIME)
        n_in = self.metrics.metric(M.NUM_INPUT_BATCHES)
        n_out = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        target = self.conf.get(C.TARGET_BATCH_SIZE)
        pending: List[ColumnarBatch] = []
        pending_bytes = 0

        def flush():
            n_out.add(1)
            with self.span(concat_t):
                return _coalesced(pending)

        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            pending.append(batch)
            n_in.add(1)
            pending_bytes += batch.device_memory_size()
            if pending_bytes >= target:
                yield flush()
                pending, pending_bytes = [], 0
        if pending:
            yield flush()


def _coalesced(batches: List[ColumnarBatch]) -> ColumnarBatch:
    """The batches concatenated; a concatenation of several is flagged, so
    a final aggregate merges it even though it arrives as one batch."""
    out = K.concat_batches(batches)
    if len(batches) > 1:
        out = dataclasses.replace(out, coalesced=True)
    return out


class RangeExec(TorchExec):
    """``session.range``: the ids split into contiguous per-partition
    slices, in batches of spark.rapids.sql.reader.batchSizeRows rows made
    on the device; an empty partition yields one empty batch. Values wrap
    in int64."""

    @property
    def num_partitions(self):
        return self.plan.num_partitions

    def execute_partition(self, pidx):
        p = self.plan
        start_i, n = _split_rows(p.num_rows(), self.num_partitions)[pidx]
        self._acquire()
        max_rows = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        off = 0
        while True:
            take = min(max_rows, n - off)
            cap = round_capacity(max(take, 1))
            pos = torch.arange(cap, dtype=torch.int64, device=self.device)
            base = _wrap64(p.start + (start_i + off) * p.step)
            vals = base + pos * _wrap64(p.step)
            yield ColumnarBatch([ColumnVector(T.INT64, vals, pos < take)],
                                take)
            off += take
            if off >= n:
                return


def _wrap64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


class UnionExec(TorchExec):
    """UNION ALL: the children's partition spaces concatenated; a child
    whose column types differ from the union's goes through a projection
    of casts."""

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def _cast_exprs(self, child_schema):
        out = []
        for i, (f_out, f_in) in enumerate(zip(self.plan.schema.fields,
                                              child_schema.fields)):
            ref = BoundRef(i, f_in.dtype, f_in.name)
            out.append(ref if f_in.dtype == f_out.dtype
                       else Cast(ref, f_out.dtype))
        return out

    def execute_partition(self, pidx):
        for child, cplan in zip(self.children, self.plan.children):
            if pidx < child.num_partitions:
                exprs = self._cast_exprs(cplan.schema)
                needs_cast = any(isinstance(e, Cast) for e in exprs)
                for batch in child.execute_partition(pidx):
                    self._acquire()
                    yield compiled.run_projection(exprs, batch,
                                                  self.device) \
                        if needs_cast else batch
                return
            pidx -= child.num_partitions
        raise IndexError(pidx)


class ExpandExec(TorchExec):
    """Every projection of each input batch, in one of the JAX package's
    two forms. Unfused, one batch per projection. As a member of a fused
    stage or of an aggregate's absorbed pre-chain (``stacked``, set by
    ``exec/stage_fusion.py``), its stage body evaluates all projections
    into one batch of n_proj x capacity with the live mask tiled. The
    form decides what the aggregate above sees: its route (batch capacity
    against the chunk gates) and the per-batch scaling of float sums."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        #: runs as a stage body (fused or absorbed)
        self.stacked = False

    def _proj_exprs(self):
        out_types = self.plan.schema.types
        return [[e if e.data_type() == dt else Cast(e, dt)
                 for e, dt in zip(proj, out_types)]
                for proj in self.plan.projections]

    def stage_body(self) -> fuse.StageBody:
        return expand_stage_body(self._proj_exprs(),
                                 len(self.plan.schema.types), self.device)

    def execute_partition(self, pidx):
        projs = self._proj_exprs()
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            for exprs in projs:
                yield compiled.run_projection(exprs, batch, self.device)


class GenerateExec(TorchExec):
    """explode / posexplode over array and map columns, plain and outer.

    The output stays at the capacity of the child planes: the generated
    columns are those planes themselves, the parent columns gather through
    the element -> row map (``searchsorted`` of each element in the
    offsets), and liveness is a mask (elements of dead or null rows are
    masked, not compacted). The outer forms place each element and one
    null row per empty or null input in input order, by one scatter of
    source rows and elements into child capacity + row capacity slots
    (the slot past them is the overflow slot of the rest)."""

    def execute_partition(self, pidx):
        op_t = self.metrics.metric(M.OP_TIME)
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        gen, required, device = (self.plan.generator,
                                 tuple(self.plan.required), self.device)
        key = ("generate", gen.fingerprint(), gen.outer, gen.position,
               required, str(device))
        fn = fuse.fused(key, lambda: lambda b: _generate(gen, required,
                                                         device, b))
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            with self.span(op_t):
                out = fn(batch)
            out_rows.add(out.num_rows)
            yield out


def _generate(gen, required, device, batch: ColumnarBatch) -> ColumnarBatch:
    """One batch of a GenerateExec (its class docstring)."""
    live = batch.live_mask()
    ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                  device, live=live)
    arr = gen.children[0].eval(ctx)
    cap = batch.capacity
    off = arr.data["offsets"][: cap + 1].to(torch.int64)
    kids = [arr.data[nm] for nm in K.element_planes(arr)]
    child_cap = kids[0].capacity
    dev = off.device
    e = torch.arange(child_cap, dtype=torch.int64, device=dev)
    seg = (torch.searchsorted(off, e, right=True) - 1).clamp(0, cap - 1)
    arr_valid = arr.validity if arr.validity is not None \
        else torch.ones(cap, dtype=torch.bool, device=dev)
    elem_live = (e < off[cap]) & live[seg] & arr_valid[seg]
    req = [batch.columns[i] for i in required]
    if not gen.outer:
        parent = [K.gather_column(c, seg, batch.num_rows, src_live=live)
                  for c in req]
        gen_cols = []
        if gen.position:
            gen_cols.append(ColumnVector(
                T.INT32, (e - off[seg]).to(torch.int32), None))
        gen_cols.extend(kids)
        return ColumnarBatch(parent + gen_cols, LazyRowCount(
            elem_live.sum(dtype=torch.int32)), elem_live)
    out_cap = round_capacity(child_cap + cap)
    lens = off[1:] - off[:-1]
    empty = live & (~arr_valid | (lens == 0))
    ei = empty.to(torch.int64)
    cume = torch.cumsum(ei, 0) - ei
    dest_e = torch.where(elem_live, e + cume[seg], out_cap)
    src_row = torch.full((out_cap + 1,), -1, dtype=torch.int64,
                         device=dev)
    src_elem = src_row.clone()
    src_row.scatter_(0, dest_e, seg)
    src_elem.scatter_(0, dest_e, e)
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    src_row.scatter_(0, torch.where(empty, off[:cap] + cume, out_cap),
                     rows)
    src_row, src_elem = src_row[:out_cap], src_elem[:out_cap]
    live_out = src_row >= 0
    parent = [K.gather_column(c, src_row, batch.num_rows, src_live=live)
              for c in req]
    gen_cols = []
    if gen.position:
        pos = src_elem - off[src_row.clamp(0, cap - 1)]
        gen_cols.append(ColumnVector(T.INT32, pos.to(torch.int32),
                                     src_elem >= 0))
    gen_cols.extend(K.gather_column(k, src_elem, child_cap)
                    for k in kids)
    return ColumnarBatch(parent + gen_cols, LazyRowCount(
        live_out.sum(dtype=torch.int32)), live_out)


class CollectExchangeExec(TorchExec):
    """N -> 1 exchange: every child partition's batches, in order."""

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, pidx):
        child = self.children[0]
        for p in range(child.num_partitions):
            yield from child.execute_partition(p)


def partitioning_mode(conf) -> str:
    """spark.rapids.shuffle.partitioning: 'compact' (the default) or
    'masked'; anything else raises, as the JAX package's exchange does."""
    v = str(conf.get(C.SHUFFLE_PARTITIONING)).strip().lower()
    if v not in ("compact", "masked"):
        raise ValueError(
            "spark.rapids.shuffle.partitioning must be 'compact' or "
            f"'masked', got {v!r}")
    return v


class _ExchangeExec(TorchExec):
    """An in-process exchange. Per input batch, in one dispatch
    (``fuse.fused`` under the JAX package's key, ``_fused_key``), a target
    partition per row (``_pid_fn``), then, in the compact mode (the
    default), one stable
    counting sort, one fetch of the offsets vector and contiguous
    right-sized sub-batches per target partition; in the masked mode,
    n_out full-capacity sub-batches that share the batch's planes, each
    with its own live mask and its row count left on the device. The
    whole child is partitioned once, on the first read of any output
    partition, which counts its partitioning dispatches and host fetches
    (the partitionDispatches and partitionHostFetches metrics, read as
    ``partition_dispatches`` and ``partition_fetches``: the adaptive join
    reads them as the work a conversion saves) and times each input
    batch's partitioning as partitionTime.

    Reading a partition coalesces adjacent tiny sub-batches
    (spark.rapids.shuffle.coalesceTinyRows), then splits a partition
    whose rows exceed spark.rapids.sql.adaptive.skewFactor x the median
    into in-order slices, both from host-int row counts only."""

    def __init__(self, plan, children, conf, device, n_out: int):
        super().__init__(plan, children, conf, device)
        self.n_out = n_out
        #: the measured cost pass's coalesceTinyRows for this plan, taken
        #: at conversion (the thread's hints are gone by execution)
        from spark_rapids_tpu_torch.plan import cost as COST
        h = COST.current_hints()
        self._tiny_override: Optional[int] = (
            h.coalesce_tiny_rows if h is not None else None)
        self._lock = threading.Lock()
        self._out: Optional[List[List[ColumnarBatch]]] = None
        self._masked = False
        self._skew_decision = None
        #: where sub-batches go instead of the output lists (the
        #: serialized exchange's writer), set while it partitions
        self._emit_sink = None

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def num_partitions(self):
        return self.n_out

    @property
    def partition_dispatches(self) -> int:
        return self.metrics.metric(M.PARTITION_DISPATCHES).value

    @property
    def partition_fetches(self) -> int:
        return self.metrics.metric(M.PARTITION_HOST_FETCHES).value

    @property
    def coalesced_batches(self) -> int:
        """Sub-batches merged by tiny coalescing."""
        return self.metrics.metric(M.SHUFFLE_COALESCED_BATCHES).value

    def _pid_fn(self):
        """A function batch -> int64 target partition per row, capturing
        only expressions, static settings and the device."""
        raise NotImplementedError

    def _fused_key(self, compact: bool) -> tuple:
        raise NotImplementedError

    def _step(self):
        """The per-batch partitioning through the dispatch choke point:
        the compact mode's fn(batch) -> (sorted batch, offsets), the
        masked mode's fn(batch) -> n_out sub-batches."""
        compact = not self._masked
        pid_of, n_out = self._pid_fn(), self.n_out

        def build():
            if compact:
                def fn(batch):
                    return RP.counting_sort_by_pid(batch, pid_of(batch),
                                                   n_out)
            else:
                def fn(batch):
                    return RP.masked_slices(batch, pid_of(batch), n_out)
            return fn
        return fuse.fused(self._fused_key(compact), build)

    def _emit(self, batch: ColumnarBatch, step, out) -> None:
        """Partition one batch through ``step`` and emit the result."""
        if self._masked:
            self._emit_masked(batch, step(batch), out)
        else:
            self._emit_compact(batch, self._dispatch_compact(batch, step),
                               out)

    def _dispatch_compact(self, batch: ColumnarBatch, step):
        """One batch's counting sort (``step``), and the start of its
        offsets' copy to the host: (sorted batch, pending offsets)."""
        from spark_rapids_tpu_torch.runtime.pipeline import start_d2h
        sorted_b, off = step(batch)
        self.metrics.metric(M.PARTITION_DISPATCHES).add(1)
        return sorted_b, start_d2h(off)

    def _emit_compact(self, batch: ColumnarBatch, dispatched, out) -> None:
        sorted_b, off = dispatched
        # per-batch exchange checkpoint: the offsets sync is where a
        # shuffle blocks
        LC.check_current()
        FLT.site("exchange.fetch")
        offsets = off.numpy()  # the one sync per input batch
        self.metrics.metric(M.PARTITION_HOST_FETCHES).add(1)
        rows_m = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        for p, sub in enumerate(RP.compact_slices(sorted_b, offsets,
                                                  self.n_out)):
            if sub is None:
                continue
            for ic, oc in zip(batch.columns, sub.columns):
                oc.bounds = ic.bounds
            rows_m.add(sub.num_rows)
            self._put(out, p, sub)

    def _emit_masked(self, batch: ColumnarBatch, subs, out) -> None:
        """n_out sub-batches sharing the planes; each costs a partition
        mask and a count that syncs when read."""
        self.metrics.metric(M.PARTITION_DISPATCHES).add(self.n_out)
        self.metrics.metric(M.PARTITION_HOST_FETCHES).add(self.n_out)
        rows_m = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        for p, sub in enumerate(subs):
            rows_m.add(sub.num_rows)
            self._put(out, p, sub)

    def _put(self, out, p: int, sub: ColumnarBatch) -> None:
        if self._emit_sink is None:
            out[p].append(sub)
        else:
            self._emit_sink(p, sub)

    def _partition_device(self, batches: Iterator[ColumnarBatch]):
        """The device partitioning of the child's batches: the output
        lists, or, while a sink is set, every sub-batch handed to it."""
        if self.n_out == 1:
            # every row lands in the one output partition: the batches
            # pass unchanged, no partitioning kernel, no sizing fetch
            rows_m = self.metrics.metric(M.NUM_OUTPUT_ROWS)
            flat = []
            for b in batches:
                rows_m.add(b.num_rows)
                if self._emit_sink is None:
                    flat.append(b)
                else:
                    self._emit_sink(0, b)
            return [flat]
        return self._repartition(batches)

    def _repartition(self, batches: Iterator[ColumnarBatch]):
        """Partition each batch. The compact mode, with pipelining on,
        defers each batch's offsets fetch by one batch (the JAX package's
        _compact_stream): batch i+1's counting sort is dispatched and its
        offsets' copy started before batch i's offsets are read, so the
        transfer rides under device work. Emission order, and so every
        result, is the eager loop's."""
        from spark_rapids_tpu_torch.runtime.pipeline import pipeline_conf
        part_t = self.metrics.metric(M.PARTITION_TIME)
        out: List[List[ColumnarBatch]] = [[] for _ in range(self.n_out)]
        step = self._step()
        if self._masked or pipeline_conf(self.conf) <= 0:
            for batch in batches:
                self._acquire()
                with self.span(part_t):
                    self._emit(batch, step, out)
            return out
        pending = None
        for batch in batches:
            self._acquire()
            with self.span(part_t):
                dispatched = self._dispatch_compact(batch, step)
            if pending is not None:
                with self.span(part_t):
                    self._emit_compact(*pending, out)
            pending = (batch, dispatched)
        if pending is not None:
            with self.span(part_t):
                self._emit_compact(*pending, out)
        return out

    def _materialize(self):
        """The child partitions run once, one after another, each a task
        of its own, and their batches stream into the partitioning. The
        JAX package runs them as a task wave (tpu_nodes.py:3066-3088);
        here every task queues on the one CUDA stream, so a wave overlaps
        no device work and each offsets sync waits for the other tasks'
        kernels (measured in PERF.md §6)."""
        with _materializing(self._lock):
            if self._out is None:
                self._masked = partitioning_mode(self.conf) == "masked"
                batches = _task_batches(self.children[0])
                try:
                    self._out = self._partitioned(batches)
                finally:
                    batches.close()
        return self._out

    def _partitioned(self, batches: Iterator[ColumnarBatch]):
        return self._partition_device(batches)

    def execute_partition(self, pidx):
        out = self._materialize()

        def decoded():
            for item in out[pidx]:
                if isinstance(item, _LazyShuffleBlobs):
                    yield from item.batches()
                else:
                    yield item

        # coalesce first, then split: a split slice must never merge back
        # into the partition it came from. Deserialized blobs coalesce
        # like device sub-batches; a lazy partition is sized for the skew
        # split by its writer-side row tally, never by decoding.
        yield from self._split_skewed(self._coalesce_tiny(decoded()), pidx)

    @staticmethod
    def _item_rows(b: ColumnarBatch) -> Optional[int]:
        """The host-int row count of an output batch, or None when
        counting would sync."""
        if b.row_mask is None and isinstance(b.num_rows, int):
            return b.num_rows
        return None

    def _skew_plan(self):
        """(threshold_rows, target_rows, totals), decided once per
        exchange from the materialized output's host-int counts, or None
        when no partition qualifies. A partition with a count that would
        sync stays out of the median and never splits."""
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        with self._lock:
            if self._skew_decision is None:
                totals: List[Optional[int]] = []
                for part in self._out or []:
                    n: Optional[int] = 0
                    for b in part:
                        r = b.rows if isinstance(b, _LazyShuffleBlobs) \
                            else self._item_rows(b)
                        if r is None:
                            n = None
                            break
                        n += r
                    totals.append(n)
                t = AQ.skew_threshold(self.conf, totals)
                self._skew_decision = False if t is None \
                    else (t[0], t[1], totals)
        return self._skew_decision or None

    def _split_skewed(self, batches, pidx):
        """A partition above skewFactor x the median splits each batch of
        more than twice the median rows into in-order slices of
        max(median, ceil(rows / 8)) rows, each keeping its column bounds:
        every result is unchanged, one hot key range just stops running
        as a single giant batch."""
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        if self.n_out <= 1 or not AQ.enabled(self.conf) \
                or float(self.conf.get(C.ADAPTIVE_SKEW_FACTOR)) <= 0:
            return batches
        sp = self._skew_plan()
        if sp is None:
            return batches
        threshold, target, totals = sp
        total = totals[pidx] if pidx < len(totals) else None
        if total is None or total <= threshold:
            return batches
        return self._split_stream(batches, pidx, total, threshold, target)

    def _split_stream(self, batches, pidx, total, threshold, target):
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        nsplits = 0
        for b in batches:
            n = self._item_rows(b)
            if n is None or n <= 2 * target:
                yield b
                continue
            step = max(target, -(-n // 8))
            for start in range(0, n, step):
                sub = RP.slice_rows(b, start, min(step, n - start))
                for ic, oc in zip(b.columns, sub.columns):
                    oc.bounds = ic.bounds
                sub.coalesced = b.coalesced
                nsplits += 1
                yield sub
        if nsplits:
            AQ.record(AQ.SKEW_SPLIT, partition=pidx, rows=int(total),
                      median=int(target), threshold_rows=int(threshold),
                      splits=nsplits)

    def _coalesce_tiny(self, batches):
        """Adjacent sub-batches of fewer than coalesceTinyRows rows merge,
        up to 4x that many rows a merged batch, flagged ``coalesced`` so a
        final aggregate merges it. Only host-int counts decide: masked
        batches pass untouched. The measured cost pass's threshold,
        when it set one at conversion, replaces the conf's."""
        tiny = int(self._tiny_override) if self._tiny_override is not None \
            else int(self.conf.get(C.SHUFFLE_COALESCE_TINY_ROWS))
        if tiny <= 0 or self.n_out <= 1:
            yield from batches
            return
        budget = tiny * 4
        run: List[ColumnarBatch] = []
        run_rows = 0
        for b in batches:
            n = self._item_rows(b)
            small = n is not None and 0 < n < tiny
            if small and run_rows + n <= budget:
                run.append(b)
                run_rows += n
                continue
            yield from self._flush_run(run)
            if small:
                run, run_rows = [b], n
            else:
                run, run_rows = [], 0
                yield b
        yield from self._flush_run(run)

    def _flush_run(self, run):
        if len(run) > 1:
            self.metrics.metric(M.SHUFFLE_COALESCED_BATCHES).add(len(run))
            yield _coalesced(run)
        elif run:
            yield run[0]


def shuffle_mode(conf) -> str:
    """spark.rapids.shuffle.mode, upper case: MULTITHREADED (the device
    exchange), SERIALIZED, or ICI, which on one card takes the device
    exchange, as the JAX package's does there (ROADMAP A12)."""
    return str(conf.get(C.SHUFFLE_MODE)).strip().upper()


class ShuffleExchangeExec(_ExchangeExec):
    """Hash exchange: murmur3 of the keys (the murmur3 kernel for int32
    planes), pmod n_out.

    Under spark.rapids.shuffle.mode=SERIALIZED the device partitioning's
    sub-batches go through the kudo wire format into a spillable host
    store (``shuffle/store.py``) instead of staying on the card
    (reference RapidsShuffleThreadedWriterBase:291-513 +
    ShuffleBufferCatalog): each sub-batch is downloaded on the thread
    that partitions, packed and compressed on the shared host pool (at
    most spark.rapids.shuffle.multiThreaded.writer.threads at once), and
    its blob added to the store in submission order, so each
    partition's blob order is the synchronous path's. Blobs page to disk
    past spark.rapids.shuffle.hostSpillBudget. Each output partition is
    then one ``_LazyShuffleBlobs``, decoded at read time. ``metrics``:
    shuffleBytesWritten and shuffleBytesSpilled."""

    def __init__(self, plan, children, conf, device,
                 keys: List[Expression], n_out: int):
        super().__init__(plan, children, conf, device, n_out)
        self.keys = keys
        self.metrics.metric(M.SHUFFLE_BYTES_WRITTEN)
        self.metrics.metric(M.SHUFFLE_BYTES_SPILLED)
        #: the serialized mode's store, once materialized
        self._store = None

    def _pid_fn(self):
        keys, n_out, device = self.keys, self.n_out, self.device

        def pids(batch):
            live = batch.live_mask()
            ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                          device, live=live)
            key_cols = [e.eval(ctx) for e in keys]
            h = K.partition_hash_batch(key_cols, batch.num_rows, live=live)
            return torch.remainder(h, n_out)
        return pids

    def _fused_key(self, compact: bool) -> tuple:
        return ("hash_exchange_compact" if compact else "hash_exchange",
                tuple(e.fingerprint() for e in self.keys), self.n_out,
                str(self.device))

    def _partitioned(self, batches):
        if shuffle_mode(self.conf) == "SERIALIZED":
            return self._repartition_serialized(batches)
        return self._partition_device(batches)

    def _repartition_serialized(self, batches):
        """The device partitioning, then each sub-batch serialized into
        the store: streamed, as the partitioning produces it, when the
        pipeline is on and more than one writer thread is allowed (the
        JAX package's default), else after the whole partitioning."""
        from spark_rapids_tpu_torch.runtime.host_pool import get_host_pool
        from spark_rapids_tpu_torch.runtime.pipeline import pipeline_conf
        from spark_rapids_tpu_torch.shuffle import serde
        from spark_rapids_tpu_torch.shuffle.store import ShuffleStore
        codec = serde.resolve_codec(self.conf.get(C.SHUFFLE_COMPRESSION))
        serde.codec_id(codec)  # validate up front
        store = ShuffleStore(self.n_out,
                             int(self.conf.get(C.SHUFFLE_HOST_BUDGET)))
        nthreads = max(1, int(self.conf.get(C.SHUFFLE_WRITER_THREADS)))

        def describe(p, b):
            # on the partitioning thread: the download (one sync); empty
            # sub-batches never ship. The row count rides into the
            # store's per-partition tally for the skew split.
            n = int(b.num_rows)
            if n == 0:
                return None
            meta, planes = serde.describe_batch(b)
            return p, meta, planes, n

        def pack(item):
            p, meta, planes, n = item
            blob = serde.pack(meta, planes, codec)
            return p, FLT.site_bytes("shuffle.write", blob), n

        if pipeline_conf(self.conf) > 0 and nthreads > 1:
            self._serialize_streaming(batches, store, describe, pack,
                                      nthreads)
        else:
            parted = self._partition_device(batches)
            items = (it for it in (describe(p, b)
                                   for p, part in enumerate(parted)
                                   for b in part) if it is not None)
            for p, blob, n in get_host_pool(self.conf).map_ordered(
                    pack, items, max_concurrency=nthreads):
                store.add(p, blob, rows=n)
        self._store = store
        tot = store.totals()
        self.metrics.metric(M.SHUFFLE_BYTES_WRITTEN).add(
            tot["bytes_written"])
        self.metrics.metric(M.SHUFFLE_BYTES_SPILLED).add(
            tot["bytes_spilled"])
        rthreads = int(self.conf.get(C.SHUFFLE_READER_THREADS))
        return [[_LazyShuffleBlobs(store, p, self, rthreads)]
                if store.num_blobs(p) else [] for p in range(self.n_out)]

    def _serialize_streaming(self, batches, store, describe, pack,
                             nthreads: int) -> None:
        """The sink submits each sub-batch for packing the moment the
        device partitioning produces it, so packing overlaps the next
        batch's partitioning. A TrafficController caps the host bytes in
        flight; finished blobs drain into the store in submission order
        (the queue's head gates on done()), so each partition's blob
        order, and every result, is the synchronous path's."""
        from collections import deque

        from spark_rapids_tpu_torch.io.async_io import (
            ThrottlingExecutor, TrafficController,
        )
        from spark_rapids_tpu_torch.runtime.host_pool import get_host_pool
        ctrl = TrafficController(
            int(self.conf.get(C.ASYNC_WRITE_MAX_INFLIGHT)),
            stall_warn_s=self.conf.get(C.ASYNC_WRITE_STALL_WARN_S) or None)
        # packing runs on the shared host pool; the controller's byte
        # budget is the per-exchange admission bound
        ex = ThrottlingExecutor(nthreads, ctrl,
                                pool=get_host_pool(self.conf))
        futures = deque()

        def drain(block: bool) -> None:
            while futures and (block or futures[0].done()):
                p, blob, n = futures.popleft().result()
                store.add(p, blob, rows=n)

        def sink(p, b):
            item = describe(p, b)
            if item is None:
                return
            nbytes = sum(a.nbytes for a in item[2])
            futures.append(ex.submit(nbytes, pack, item))
            drain(False)

        self._emit_sink = sink
        ok = False
        try:
            self._partition_device(batches)
            ok = True
        finally:
            self._emit_sink = None
            if ok:
                drain(True)
            else:
                # the partitioning raised: settle the packing in flight
                # without letting its errors mask the propagating one
                try:
                    drain(True)
                except Exception:  # noqa: BLE001
                    pass
            ex.shutdown()


class _LazyShuffleBlobs:
    """A reduce partition's serialized blobs, decoded at read time: the
    wire check, decompression, frame parsing and padding run on the
    shared host pool (at most spark.rapids.shuffle.multiThreaded.reader.
    threads at once) into pinned host planes, and the upload runs in order on the
    consuming task's thread, under its permit.

    Integrity recovery: a ShuffleCorruptionError (spark.rapids.shuffle.
    verifyChecksums) triggers ONE re-fetch of the same blob from the
    store (a disk-resident blob re-reads its spill-file segment, so a
    transient read corruption heals), counted in the consuming task's
    shuffleCorruptionRetries accumulator before a second failure
    surfaces."""

    def __init__(self, store, partition: int, exchange: "_ExchangeExec",
                 reader_threads: int = 1):
        self.store = store
        self.partition = partition
        self.exchange = exchange
        self.reader_threads = max(1, reader_threads)
        self.verify = bool(exchange.conf.get(C.SHUFFLE_VERIFY_CHECKSUMS))
        self.pinned = exchange.device.type == "cuda"
        self._task_ctx = None

    @property
    def rows(self) -> Optional[int]:
        """The writer-side row tally, or None when it is 0."""
        n = self.store.partition_rows(self.partition)
        return n if n > 0 else None

    def _read(self, index: int) -> bytes:
        return FLT.site_bytes(
            "shuffle.read", self.store.read_blob(self.partition, index))

    def _decode(self, index: int) -> ColumnarBatch:
        from spark_rapids_tpu_torch.shuffle import serde
        try:
            return serde.deserialize_host(self._read(index), self.verify,
                                          self.pinned)
        except serde.ShuffleCorruptionError as e:
            # decode runs on a reader-pool thread with no task bound: the
            # retry counts to the consuming task captured in batches()
            ctx = TaskContext.peek() or self._task_ctx
            if ctx is not None:
                ctx.metric(M.SHUFFLE_CORRUPTION_RETRIES).add(1)
            _LOG.warning(
                "shuffle blob %d of partition %d failed verification "
                "(%s); re-fetching from the store once", index,
                self.partition, e)
            return serde.deserialize_host(self._read(index), self.verify,
                                          self.pinned)

    def batches(self):
        from spark_rapids_tpu_torch.runtime.host_pool import get_host_pool
        from spark_rapids_tpu_torch.shuffle import serde
        self._task_ctx = TaskContext.peek()
        n = self.store.num_blobs(self.partition)
        if self.reader_threads > 1 and n > 1:
            hosts = get_host_pool(self.exchange.conf).map_ordered(
                self._decode, range(n), max_concurrency=self.reader_threads)
        else:
            hosts = (self._decode(i) for i in range(n))
        for host in hosts:
            self.exchange._acquire()
            yield serde.upload(host, self.exchange.device)


class RoundRobinExchangeExec(_ExchangeExec):
    """``repartition(n)`` without keys: the k-th live row of a batch goes
    to partition k mod n (counting from 1, as the JAX package does)."""

    def _pid_fn(self):
        n_out = self.n_out

        def pids(batch):
            live = batch.live_mask()
            return torch.remainder(torch.cumsum(live.to(torch.int32), 0),
                                   n_out)
        return pids

    def _fused_key(self, compact: bool) -> tuple:
        return ("rr_exchange_compact" if compact else "rr_exchange",
                self.n_out)


class RangeExchangeExec(_ExchangeExec):
    """Range exchange by sort keys: per order a null-rank plane and a key
    plane (``normalize_key``, complemented when descending); a host sample
    of each batch's rows gives n_out - 1 bounds, and each row goes to the
    partition after every bound it orders after, so partition p's rows
    order before partition p + 1's and a per-partition sort orders the
    whole."""

    def __init__(self, plan, children, conf, device, orders, n_out: int):
        super().__init__(plan, children, conf, device, n_out)
        self.orders = orders

    def _planes_fn(self):
        """The per-batch key planes through the dispatch choke point
        (the JAX package's ``range_keys``)."""
        orders, device = self.orders, self.device

        def build():
            def fn(batch):
                live = batch.live_mask()
                ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                              device, live=live)
                planes = []
                for o in orders:
                    k, nulls = K.normalize_key(o.expr.eval(ctx),
                                               batch.num_rows, live=live)
                    first = o.resolved_nulls_first()
                    planes.append(torch.where(
                        nulls, 0 if first else 1,
                        1 if first else 0).to(torch.int64))
                    planes.append(k if o.ascending else ~k)
                return planes, live
            return fn
        return fuse.fused(
            ("range_keys", tuple((o.expr.fingerprint(), o.ascending,
                                  o.resolved_nulls_first())
                                 for o in self.orders), str(self.device)),
            build)

    def _range_step(self, bounds):
        """Rows to partitions by the sampled bounds, then the compact or
        masked split, as one dispatch a batch."""
        compact, n_out = not self._masked, self.n_out

        def build():
            def fn(batch, planes, bounds):
                dev = planes[0].device
                pid = torch.zeros(batch.capacity, dtype=torch.int64,
                                  device=dev)
                for b in bounds:
                    after = torch.zeros(batch.capacity, dtype=torch.bool,
                                        device=dev)
                    eq = torch.ones_like(after)
                    for v, plane in zip(b, planes):
                        after = after | (eq & (plane > v))
                        eq = eq & (plane == v)
                    pid += after
                if compact:
                    return RP.counting_sort_by_pid(batch, pid, n_out)
                return RP.masked_slices(batch, pid, n_out)
            return fn
        return fuse.fused(("range_exchange_compact" if compact
                           else "range_exchange", n_out,
                           tuple((o.expr.fingerprint(), o.ascending)
                                 for o in self.orders)), build)

    def _repartition(self, batches):
        part_t = self.metrics.metric(M.PARTITION_TIME)
        budget = int(self.conf.get(C.RANGE_PARTITION_SAMPLE)) * self.n_out
        per_batch, samples = [], []
        planes_of = self._planes_fn()
        for batch in batches:
            self._acquire()
            with self.span(part_t):
                planes, live = planes_of(batch)
                per_batch.append((batch, planes))
                idx = torch.nonzero(live).flatten()
                if idx.numel() > budget:
                    # a ceil stride spans the whole batch: a prefix would
                    # bias the bounds on input that is already ordered
                    idx = idx[::-(-idx.numel() // budget)][:budget]
                host = torch.stack([p[idx] for p in planes],
                                   1).cpu().tolist()
                samples.extend(map(tuple, host))
        out: List[List[ColumnarBatch]] = [[] for _ in range(self.n_out)]
        if not samples:
            return out
        samples.sort()
        bounds = [samples[len(samples) * (i + 1) // self.n_out]
                  for i in range(self.n_out - 1)]
        step = self._range_step(bounds)
        for batch, planes in per_batch:
            with self.span(part_t):
                self._emit(batch, lambda b, p=planes: step(b, p, bounds),
                           out)
        return out


# ---------------------------------------------------------------------------
# Hash aggregate
# ---------------------------------------------------------------------------

def _static_expr_ranges(key_cols, kinds, key_exprs):
    """Host-known (lo, hi) for every KIND_INT key, from the expression or
    from column-stat bounds, or None if any is unknown."""
    rs = []
    for i, (c, kind) in enumerate(zip(key_cols, kinds)):
        if kind == R.KIND_INT:
            r = key_exprs[i].static_range() if key_exprs is not None else None
            if r is None:
                r = c.bounds
            if r is None:
                return None
            rs.extend(r)
        else:
            rs.extend((0, 0))
    return np.asarray(rs, np.int64)


def _probe_pack_spec(key_cols, live, key_exprs=None):
    """Can these keys pack into one int64 plane? Returns (spec, ranges on
    the device, ranges on the host) or (None, None, None). Costs one small
    fetch when an integer key's range is not known on the host."""
    kinds = R.static_kinds(key_cols)
    if kinds is None:
        return None, None, None
    ranges_host = None
    if any(k == R.KIND_INT for k in kinds):
        ranges_host = _static_expr_ranges(key_cols, kinds, key_exprs)
        if ranges_host is None:
            probe = fuse.fused(("radix_probe", tuple(kinds)),
                               lambda: R.probe_ranges)
            ranges_host = probe(key_cols, live).cpu().numpy()
    if ranges_host is None:
        ranges_host = np.zeros(2 * len(key_cols), np.int64)
    ranges = torch.from_numpy(ranges_host).to(live.device)
    return R.plan_packing(key_cols, ranges_host), ranges, ranges_host


def _attach_key_bounds(out_batch, spec, ranges_host) -> None:
    for i, kind in enumerate(spec.kinds):
        if kind == R.KIND_INT:
            lo, hi = int(ranges_host[2 * i]), int(ranges_host[2 * i + 1])
            if lo <= hi:
                out_batch.columns[i].bounds = (lo, hi)


def _zeros(n: int, dtype: T.DataType, device) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype.torch_dtype, device=device)


def _resize_plane(vals, valid, dtype: T.DataType, cap: int) -> ColumnVector:
    n = vals.shape[0]
    if n > cap:
        vals, valid = vals[:cap], valid[:cap]
    elif n < cap:
        vals = torch.cat([vals, torch.zeros(cap - n, dtype=vals.dtype,
                                            device=vals.device)])
        valid = torch.cat([valid, torch.zeros(cap - n, dtype=torch.bool,
                                              device=valid.device)])
    return ColumnVector(dtype, vals.to(dtype.torch_dtype), valid)


def _resize_col(c: ColumnVector, cap: int) -> ColumnVector:
    if c.capacity == cap:
        return c
    idx = torch.arange(cap, device=c.device)
    return K.gather_column(c, torch.where(idx < c.capacity, idx, -1),
                           c.capacity)


#: planning tags min, max, first and last over strings to the CPU, as the
#: JAX package does: no device route carries string state
_STRING_STATE = "string aggregate state on the device"


def _rows_slice(c: Optional[ColumnVector], off: int, n: int):
    if c is None:
        return None
    if c.is_dict:
        data = {"codes": c.data["codes"][off:off + n],
                "dict_offsets": c.data["dict_offsets"],
                "dict_bytes": c.data["dict_bytes"]}
    else:
        data = c.data[off:off + n]
    v = None if c.validity is None else c.validity[off:off + n]
    return ColumnVector(c.dtype, data, v, dict_unique=c.dict_unique,
                        bounds=c.bounds)


class _AggKernels:
    """The aggregation routes, holding only expression-level state."""

    _BUCKET_LIMIT = 4096
    _MATMUL_LIMIT = 64
    _SIMPLE_OPS = frozenset({"sum", "sumsq", "count", "count_all", "min",
                             "max", "first", "last"})
    #: segsum route gate: packed key bits in [11, 24]
    _SEG_MIN_BITS = 11
    _SEG_MAX_BITS = 24

    def __init__(self, group_exprs, aggs, pre_filter, segsum_enabled: bool):
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.pre_filter = pre_filter
        self.segsum_enabled = segsum_enabled
        self._packed_ok = self._packed_static_ok()

    def _packed_static_ok(self) -> bool:
        if not self.group_exprs:
            return False
        for e in self.group_exprs:
            if not isinstance(e.data_type(), (
                    T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type,
                    T.DateType, T.BooleanType, T.DecimalType, T.StringType)):
                return False
        for a in self.aggs:
            if isinstance(a.fn, A.SegmentedAgg):
                return False
            for (_, sdt), (op, _) in zip(a.fn.state_schema(),
                                         a.fn.update_ops()):
                if op not in self._SIMPLE_OPS or isinstance(sdt,
                                                            T.StringType):
                    return False
        return True

    @property
    def has_custom(self) -> bool:
        return any(isinstance(a.fn, A.SegmentedAgg) for a in self.aggs)

    def _fp(self):
        """The semantic key of this aggregation's stage functions (the
        JAX package's, with the segsum switch: it picks the route)."""
        return (tuple(e.fingerprint() for e in self.group_exprs),
                tuple(a.fn.fingerprint() for a in self.aggs),
                self.pre_filter.fingerprint()
                if self.pre_filter is not None else None,
                self.segsum_enabled)

    # -- entry points ------------------------------------------------------

    def _filtered(self, batch: ColumnarBatch, ctx_of):
        """Apply the absorbed filter: returns (batch, live, errors)."""
        live = batch.live_mask()
        errs = []
        if self.pre_filter is not None:
            pctx = ctx_of(batch, live)
            pred = self.pre_filter.eval(pctx)
            live = live & pred.data.to(torch.bool)
            if pred.validity is not None:
                live = live & pred.validity
            batch = ColumnarBatch(batch.columns,
                                  LazyRowCount(live.sum(dtype=torch.int32)),
                                  live)
            errs.extend(pctx.errors)
        return batch, live, errs

    def _inputs(self, batch, live, ctx_of, keys=None):
        """Evaluate the keys, unless ``keys`` holds them (the key columns
        over the same live rows, and their error planes), and every
        aggregate's inputs."""
        ctx = ctx_of(batch, live)
        key_cols, key_errs = keys if keys is not None else (
            [e.eval(ctx) for e in self.group_exprs], [])
        input_cols = [[e.eval(ctx) for e in a.fn.children] for a in self.aggs]
        return key_cols, input_cols, key_errs + ctx.errors

    def update(self, batch: ColumnarBatch, ctx_of, ansi: bool = False):
        """The update phase: tiny-bucket, packed radix, or the sort and
        global routes, each through its dispatch (the JAX package's key
        families: the keys' run_stage, the range probe, then
        ``hashagg_packed_update`` or ``hashagg_update``). Returns (state
        batch, ANSI error planes)."""
        keys = None
        if self._packed_ok:
            fuse.notify_dispatch(
                ("run_stage", tuple(e.fingerprint()
                                    for e in self.group_exprs)))
            kctx = ctx_of(batch, batch.live_mask())
            key_cols = [e.eval(kctx) for e in self.group_exprs]
            # without an absorbed filter these are the keys of the update
            # too: a key computed in the aggregate is evaluated once
            if self.pre_filter is None:
                keys = (key_cols, kctx.errors)
            if self._bucket_sizes(key_cols) is None:
                spec, ranges, rh = _probe_pack_spec(
                    key_cols, batch.live_mask(), self.group_exprs)
                if spec is not None:
                    fn = fuse.fused(("hashagg_packed_update", self._fp(),
                                     (spec.kinds, spec.bits), ansi),
                                    lambda: self._packed_update)
                    out, errs = fn(batch, ctx_of, keys, spec, ranges)
                    _attach_key_bounds(out, spec, rh)
                    return out, errs
        fn = fuse.fused(("hashagg_update", self._fp(), ansi),
                        lambda: self.general_update)
        return fn(batch, ctx_of, keys)

    def _packed_update(self, batch, ctx_of, keys, spec, ranges):
        batch, live, errs = self._filtered(batch, ctx_of)
        key_cols, input_cols, ierrs = self._inputs(batch, live, ctx_of, keys)
        out = self._packed_agg(live, key_cols,
                               self._update_specs(input_cols), spec, ranges)
        return out, errs + ierrs

    def general_update(self, batch, ctx_of, keys=None):
        """The tiny-bucket, sort and global routes of the update (what an
        absorbed pre-chain composes with: the packed route needs host
        probes of the evaluated keys)."""
        batch, live, errs = self._filtered(batch, ctx_of)
        key_cols, input_cols, ierrs = self._inputs(batch, live, ctx_of, keys)
        if not key_cols:
            return self._global_update(batch, live, input_cols), errs + ierrs
        # segmented aggregates need the group-sorted rows: the sort route
        sizes = None if self.has_custom else self._bucket_sizes(key_cols)
        specs = self._update_specs(input_cols)
        if sizes is None:
            return self._sort_agg(live, key_cols, specs,
                                  batch.num_rows), errs + ierrs
        return self._bucket_update(live, key_cols, specs,
                                   sizes), errs + ierrs

    def _update_specs(self, input_cols):
        """(reduction, input column or None, state type) per state; a
        segmented aggregate's is ("custom", (function, its inputs),
        result type)."""
        specs = []
        for ai, a in enumerate(self.aggs):
            if isinstance(a.fn, A.SegmentedAgg):
                specs.append(("custom", (a.fn, input_cols[ai]),
                              a.fn.result_type()))
                continue
            for (_, sdt), (op, idx) in zip(a.fn.state_schema(),
                                           a.fn.update_ops()):
                specs.append((op, input_cols[ai][idx] if idx >= 0 else None,
                              sdt))
        return specs

    def merge(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Fold partial states that share keys, through the packed
        route's dispatch (``hashagg_packed_merge``) when the keys pack and
        do not take the tiny-bucket route, else ``hashagg_merge``."""
        nkeys = len(self.group_exprs)
        if self._packed_ok and nkeys:
            key_cols = list(batch.columns[:nkeys])
            if self._bucket_sizes(key_cols) is None:
                spec, ranges, rh = _probe_pack_spec(key_cols,
                                                    batch.live_mask())
                if spec is not None:
                    fn = fuse.fused(("hashagg_packed_merge", self._fp(),
                                     (spec.kinds, spec.bits)),
                                    lambda: self._packed_merge)
                    out = fn(batch, spec, ranges)
                    _attach_key_bounds(out, spec, rh)
                    return out
        fn = fuse.fused(("hashagg_merge", self._fp()),
                        lambda: self._merge_states)
        return fn(batch)

    def _merge_states_of(self, batch):
        nkeys = len(self.group_exprs)
        states = []
        ci = nkeys
        for a in self.aggs:
            for (_, sdt), op in zip(a.fn.state_schema(), a.fn.merge_ops()):
                states.append((op, batch.columns[ci], sdt))
                ci += 1
        return states

    def _packed_merge(self, batch, spec, ranges):
        key_cols = list(batch.columns[:len(self.group_exprs)])
        return self._packed_agg(batch.live_mask(), key_cols,
                                self._merge_states_of(batch), spec, ranges)

    def _merge_states(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The global, tiny-bucket and sort routes of the merge."""
        nkeys = len(self.group_exprs)
        live = batch.live_mask()
        states = self._merge_states_of(batch)
        if nkeys == 0:
            cols = []
            for op, src, sdt in states:
                valid = live if src.validity is None else (src.validity & live)
                ov, oval = G.global_agg(op, src.data, valid)
                cols.append(_resize_plane(ov, oval, sdt, round_capacity(1)))
            return ColumnarBatch(cols, 1)
        key_cols = list(batch.columns[:nkeys])
        if self._packed_ok:
            sizes = self._bucket_sizes(key_cols)
            if sizes is not None:
                # the update's route order: tiny-bucket keys merge by
                # plain float adds too. The packed scatter route sums
                # floats in fixed point scaled to the batch's largest
                # |value|, so one outlier partial would quantize every
                # other group's sum (ROADMAP C, "known")
                return self._bucket_update(live, key_cols, states, sizes)
        return self._sort_agg(live, key_cols, states, batch.num_rows)

    def evaluate_states(self, state: ColumnarBatch) -> ColumnarBatch:
        """The final projection of merged states into result columns."""
        nkeys = len(self.group_exprs)
        out_cols = list(state.columns[:nkeys])
        ci = nkeys
        for a in self.aggs:
            n_state = len(a.fn.state_schema())
            res = a.fn.evaluate(state.columns[ci: ci + n_state])
            ci += n_state
            rt = a.fn.result_type()
            if not (res.is_string or res.is_nested) \
                    and res.data.dtype != rt.torch_dtype:
                res = ColumnVector(rt, res.data.to(rt.torch_dtype),
                                   res.validity)
            out_cols.append(res)
        return ColumnarBatch(out_cols, state.num_rows if nkeys else 1,
                             state.row_mask)

    # -- global (no keys) --------------------------------------------------

    def _global_update(self, batch, live, input_cols) -> ColumnarBatch:
        cap = batch.capacity
        out_cols = []
        for ai, a in enumerate(self.aggs):
            if isinstance(a.fn, A.SegmentedAgg):
                # one group over every row
                res = a.fn.segmented_eval(
                    input_cols[ai],
                    torch.arange(cap, device=live.device),
                    torch.zeros(cap, dtype=torch.int32, device=live.device),
                    1, live, batch.num_rows)
                out_cols.append(_resize_col(res, round_capacity(1)))
                continue
            for (_, sdt), (op, idx) in zip(a.fn.state_schema(),
                                           a.fn.update_ops()):
                if idx >= 0:
                    src = input_cols[ai][idx]
                    if src.is_string:
                        if op not in ("count", "count_all"):
                            raise NotImplementedError(_STRING_STATE)
                        vals = _zeros(cap, sdt, live.device)
                    else:
                        vals = src.data.to(sdt.torch_dtype)
                    valid = live if src.validity is None \
                        else (src.validity & live)
                else:
                    vals, valid = _zeros(cap, sdt, live.device), live
                ov, oval = G.global_agg(op, vals, valid)
                out_cols.append(_resize_plane(ov, oval, sdt,
                                              round_capacity(1)))
        return ColumnarBatch(out_cols, 1)

    # -- sort route ----------------------------------------------------------

    def _sort_agg(self, live, key_cols, state_specs, num_rows
                  ) -> ColumnarBatch:
        """Group by sorting (``ops/groupby.group_segments``): the groups
        come out packed to the front of the input's capacity, their count
        kept on the device."""
        cap = live.shape[0]
        perm, seg_ids, boundary = G.group_segments(key_cols, num_rows,
                                                   live=live)
        out_cols = G.gather_group_keys(key_cols, perm, boundary, num_rows,
                                       live=live)
        for op, src, sdt in state_specs:
            if op == "custom":
                fn, inputs = src
                out_cols.append(fn.segmented_eval(inputs, perm, seg_ids, cap,
                                                  live, num_rows))
                continue
            if src is None:
                vals, valid = _zeros(cap, sdt, live.device), live
            else:
                if src.is_string and op not in ("count", "count_all"):
                    raise NotImplementedError(_STRING_STATE)
                vals = _zeros(cap, sdt, live.device) if src.is_string \
                    else src.data.to(sdt.torch_dtype)
                valid = live if src.validity is None else (src.validity & live)
            ov, oval = G.segmented_agg(op, vals[perm], valid[perm], seg_ids,
                                       cap)
            out_cols.append(ColumnVector(sdt, ov.to(sdt.torch_dtype), oval))
        return ColumnarBatch(out_cols,
                             LazyRowCount(boundary.sum(dtype=torch.int32)))

    # -- tiny-bucket route -------------------------------------------------

    def _bucket_sizes(self, key_cols):
        """Per-key cardinality + 1 (a NULL slot) when every key is a unique
        dict-string or a bool and the product stays small, else None."""
        sizes, total = [], 1
        for c in key_cols:
            if c.is_dict and c.dict_unique:
                sizes.append(c.dict_size + 1)
            elif isinstance(c.dtype, T.BooleanType):
                sizes.append(3)
            else:
                return None
            total *= sizes[-1]
            if total > self._BUCKET_LIMIT:
                return None
        return sizes

    def _bucket_update(self, live, key_cols, state_specs, sizes):
        device = live.device
        cap = live.shape[0]
        B = int(np.prod(sizes))
        bucket = torch.zeros(cap, dtype=torch.int32, device=device)
        for c, s in zip(key_cols, sizes):
            code = (c.data["codes"] if c.is_dict else c.data).to(torch.int32)
            if c.validity is not None:
                code = torch.where(c.validity, code, s - 1)
            bucket = bucket * s + code.clamp(0, s - 1)
        matmul_ok = B <= self._MATMUL_LIMIT
        if matmul_ok:
            occupancy = torch.stack([(live & (bucket == b)).any()
                                     for b in range(B)])
        else:
            occ = torch.zeros(B + 1, dtype=torch.int32, device=device)
            occ.index_add_(0, torch.where(live, bucket, B).to(torch.int64),
                           live.to(torch.int32))
            occupancy = occ[:B] > 0
        codes = []
        rem = torch.arange(B, dtype=torch.int32, device=device)
        for s in reversed(sizes):
            codes.append(rem % s)
            rem = rem // s
        codes.reverse()
        out_cols: List[ColumnVector] = []
        for c, s, code in zip(key_cols, sizes, codes):
            kvalid = code < (s - 1)
            if c.is_dict:
                out_cols.append(ColumnVector(c.dtype, {
                    "codes": code, "dict_offsets": c.data["dict_offsets"],
                    "dict_bytes": c.data["dict_bytes"]}, kvalid))
            else:
                out_cols.append(ColumnVector(c.dtype, code.to(c.data.dtype),
                                             kvalid))
        for op, src, sdt in state_specs:
            if src is not None:
                if src.is_string and op not in ("count", "count_all"):
                    raise NotImplementedError(_STRING_STATE)
                vals = _zeros(cap, sdt, device) if src.is_string \
                    else src.data.to(sdt.torch_dtype)
                valid = live if src.validity is None else (src.validity & live)
            else:
                vals, valid = _zeros(cap, sdt, device), live
            ov, oval = G.bucket_agg(op, vals, valid, bucket, B, matmul_ok)
            out_cols.append(ColumnVector(sdt, ov, oval))
        return ColumnarBatch(out_cols,
                             LazyRowCount(occupancy.sum(dtype=torch.int32)),
                             occupancy)

    # -- packed radix route ------------------------------------------------

    def _packed_agg(self, live, key_cols, state_specs, spec, ranges):
        """Packed keys of at most BUCKET_BITS bits scatter into the dense
        bucket space; wider ones take the packed sort route."""
        if spec.total_bits <= R.BUCKET_BITS:
            return self._bucket_scatter_agg(live, key_cols, state_specs,
                                            spec, ranges)
        return self._packed_sort_agg(live, key_cols, state_specs, spec,
                                     ranges)

    def _packed_sort_agg(self, live, key_cols, state_specs, spec, ranges):
        """Sort the packed keys (``ops/radix.group_layout``) and reduce by
        cumsum differences; the groups come out packed to the front, their
        count on the device."""
        lay = R.group_layout(R.pack_keys(spec, key_cols, ranges, live), live)
        group_packed = lay.sorted_packed[lay.starts.clamp(0, lay.cap - 1)]
        pad_ok = lay.starts >= 0
        out_cols: List[ColumnVector] = []
        for c in R.unpack_keys(spec, group_packed, ranges, key_cols):
            v = c.validity & pad_ok if c.validity is not None else pad_ok
            out_cols.append(ColumnVector(c.dtype, c.data, v,
                                         dict_unique=c.dict_unique))
        for op, src, sdt in state_specs:
            ov, oval = self._packed_op(op, src, sdt, live, lay)
            out_cols.append(ColumnVector(sdt, ov.to(sdt.torch_dtype), oval))
        return ColumnarBatch(out_cols, LazyRowCount(lay.n_groups))

    def _packed_op(self, op, src, sdt, live, lay):
        cap = lay.cap
        device = live.device
        if src is not None:
            if src.is_string and op not in ("count", "count_all"):
                raise NotImplementedError(_STRING_STATE)
            valid = (live if src.validity is None
                     else (src.validity & live))[lay.perm]
            vals = _zeros(cap, sdt, device) if src.is_string \
                else src.data[lay.perm]
        else:
            valid = live[lay.perm]
            vals = _zeros(cap, sdt, device)
        ones = torch.ones(cap, dtype=torch.bool, device=device)
        if op == "count":
            return R.seg_count(valid, lay), ones
        if op == "count_all":
            return R.seg_count_all(lay), ones
        some = R.seg_count(valid, lay) > 0
        if op in ("sum", "sumsq"):
            # the square in the input's own type, as the JAX package does
            v = vals * vals if op == "sumsq" else vals
            if isinstance(sdt, (T.Float64Type, T.Float32Type)):
                return R.seg_sum_f64(v, valid, lay), some
            return R.seg_sum_int(v, valid, lay), some
        if op in ("min", "max"):
            if vals.dtype == torch.float64:
                return R.seg_minmax_f64(op, vals, valid, lay), some
            if vals.dtype == torch.float32:
                return R.seg_minmax_f32(op, vals, valid, lay), some
            return R.seg_minmax_int(op, vals, valid, lay), some
        if op in ("first", "last"):
            v, has = R.seg_first_last(op, vals, valid, lay)
            return v, has & some
        raise ValueError(f"unknown packed op {op}")

    def _segsum_ops_ok(self, state_specs) -> bool:
        n_sums = 0
        for op, src, sdt in state_specs:
            if op in ("count", "count_all"):
                continue
            if op == "sum" and src is not None and not src.is_string \
                    and isinstance(sdt, (T.Float64Type, T.Float32Type)):
                n_sums += 1
                continue
            return False
        return 1 <= n_sums <= 2

    def _segsum_bits_ok(self, spec) -> bool:
        return (self.segsum_enabled
                and self._SEG_MIN_BITS <= spec.total_bits
                <= self._SEG_MAX_BITS)

    def _segsum_eligible(self, live, state_specs, spec) -> bool:
        cap = live.shape[0]
        if not self._segsum_bits_ok(spec) or cap % S.TILE \
                or cap < 4 * S.TILE or cap > S.CHUNK_ROWS:
            return False
        return self._segsum_ops_ok(state_specs)

    def _segsum_chunks(self, live, state_specs, spec) -> int:
        """Chunk count for the chunked segsum route (0 = ineligible): only
        when the merge of the k dense partials is itself cheap."""
        cap = live.shape[0]
        if not self._segsum_bits_ok(spec) \
                or not self._segsum_ops_ok(state_specs) \
                or cap <= S.CHUNK_ROWS or cap % S.CHUNK_ROWS:
            return 0
        k = cap // S.CHUNK_ROWS
        return 0 if k * (1 << spec.total_bits) > S.CHUNK_ROWS else k

    def _bucket_scatter_agg(self, live, key_cols, state_specs, spec, ranges):
        if self._segsum_eligible(live, state_specs, spec):
            return self._segsum_or_fallback(live, key_cols, state_specs,
                                            spec, ranges)
        k = self._segsum_chunks(live, state_specs, spec)
        if k:
            return self._chunked_segsum_agg(live, key_cols, state_specs,
                                            spec, ranges, k)
        return self._scatter_agg(live, key_cols, state_specs, spec, ranges)

    def _segsum_or_fallback(self, live, key_cols, state_specs, spec, ranges):
        post, max_cnt, has_specials = self._segsum_agg(
            live, key_cols, state_specs, spec, ranges)
        # host if on one .item(): one sync. The kernel's sums are kept
        # only while every group is within the exact-digit bound and no
        # NaN/Inf was seen; otherwise the scatter route recomputes them.
        ok = (max_cnt <= S.MAX_GROUP_ROWS) & ~has_specials
        if bool(ok.item()):
            return post()
        return self._scatter_agg(live, key_cols, state_specs, spec, ranges)

    def _chunked_segsum_agg(self, live, key_cols, state_specs, spec, ranges,
                            k: int) -> ColumnarBatch:
        """The segsum route per CHUNK_ROWS slice, then one scatter-bucket
        merge of the k dense partials."""
        ch = S.CHUNK_ROWS
        nkeys = len(key_cols)
        parts: List[ColumnarBatch] = []
        for i in range(k):
            off = i * ch
            parts.append(self._segsum_or_fallback(
                live[off:off + ch], [_rows_slice(c, off, ch) for c in key_cols],
                [(op, _rows_slice(src, off, ch), sdt)
                 for op, src, sdt in state_specs], spec, ranges))
        cat_cols: List[ColumnVector] = []
        for ci in range(nkeys + len(state_specs)):
            cvs = [p.columns[ci] for p in parts]
            c0 = cvs[0]
            if c0.is_dict:
                data = {"codes": torch.cat([c.data["codes"] for c in cvs]),
                        "dict_offsets": c0.data["dict_offsets"],
                        "dict_bytes": c0.data["dict_bytes"]}
            else:
                data = torch.cat([c.data for c in cvs])
            val = None
            if any(c.validity is not None for c in cvs):
                val = torch.cat([c.validity_or_default(c.capacity)
                                 for c in cvs])
            cat_cols.append(ColumnVector(c0.dtype, data, val,
                                         dict_unique=c0.dict_unique))
        cat_live = torch.cat([p.live_mask() for p in parts])
        merge_specs = [("sum", cat_cols[nkeys + j], sdt)
                       for j, (_, _, sdt) in enumerate(state_specs)]
        return self._bucket_scatter_agg(cat_live, cat_cols[:nkeys],
                                        merge_specs, spec, ranges)

    def _segsum_agg(self, live, key_cols, state_specs, spec, ranges):
        """Sort by packed key, number the groups densely, build the digit
        lanes and run the segsum kernel. Returns (post thunk building the
        output batch, max group rows, any NaN/Inf) with the last two still
        on the device. The output lives in dense group-id space at the
        bucket space's capacity, like the scatter route's."""
        device = live.device
        nb = 1 << spec.total_bits
        big = nb + 1
        code = torch.where(live, R.pack_keys(spec, key_cols, ranges, live),
                           big).to(torch.int32)
        sk, perm = torch.sort(code, stable=True)
        boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                              sk[1:] != sk[:-1]])
        gid = (torch.cumsum(boundary.to(torch.int32), 0) - 1).to(torch.int32)
        live_sorted = sk < big
        has_specials = torch.zeros((), dtype=torch.bool, device=device)
        lanes = [live_sorted.to(torch.bfloat16)]  # lane 0: live count
        kd, kshifts = S.int_digits(torch.where(live_sorted, sk, 0),
                                   spec.total_bits)
        lanes.extend(kd)
        plan = []
        for op, src, sdt in state_specs:
            if op == "count_all":
                plan.append(("count_all", None))
            elif op == "count":
                if src is None or src.validity is None:
                    plan.append(("count_live", None))
                else:
                    lanes.append((src.validity[perm] & live_sorted).to(
                        torch.bfloat16))
                    plan.append(("count_lane", len(lanes) - 1))
            else:
                # NaN/Inf rows are stripped before the scale (an Inf max
                # would zero every digit) and force the scatter fallback
                vals = src.data.to(torch.float64)[perm]
                valid_s = live_sorted if src.validity is None \
                    else (src.validity[perm] & live_sorted)
                finite = torch.isfinite(vals)
                clean = torch.where(valid_s & finite, vals, 0.0)
                has_specials = has_specials | (valid_s & ~finite).any()
                scale = R._exponent_scale(clean.abs().max()) \
                    * float(2.0 ** 11)
                start = len(lanes)
                lanes.extend(S.float_digits(clean, scale))
                some_lane = None
                if src.validity is not None:
                    lanes.append(valid_s.to(torch.bfloat16))
                    some_lane = len(lanes) - 1
                plan.append(("sum", (start, scale, some_lane)))
        # lane-major payload: stacking whole planes is one contiguous copy;
        # the kernel takes any lane count, so no zero lanes are added
        acc = S.segsum(gid, torch.stack(lanes), nb)

        def post():
            return self._segsum_post(acc, state_specs, spec, ranges,
                                     key_cols, plan, len(kd), kshifts, nb)
        return post, acc[:, 0].max(), has_specials

    def _segsum_post(self, acc, state_specs, spec, ranges, key_cols, plan,
                     nkd, kshifts, nb):
        device = acc.device
        counts_live = acc[:, 0]
        key_code = S.int_digits_to_val([acc[:, 1 + i] for i in range(nkd)],
                                       kshifts, counts_live)
        occupied = counts_live > 0.5
        ones = torch.ones(nb, dtype=torch.bool, device=device)
        out_cols: List[ColumnVector] = []
        for c in R.unpack_keys(spec, key_code.to(torch.int64), ranges,
                               key_cols):
            v = c.validity & occupied if c.validity is not None else occupied
            out_cols.append(ColumnVector(c.dtype, c.data, v,
                                         dict_unique=c.dict_unique))
        for (op, src, sdt), (kind, info) in zip(state_specs, plan):
            if kind in ("count_all", "count_live"):
                out_cols.append(ColumnVector(
                    sdt, counts_live.to(torch.int64).to(sdt.torch_dtype),
                    ones))
            elif kind == "count_lane":
                out_cols.append(ColumnVector(
                    sdt, acc[:, info].to(torch.int64).to(sdt.torch_dtype),
                    ones))
            else:
                start, scale, some_lane = info
                tot = S.digits_to_f64([acc[:, start + i]
                                       for i in range(len(S.SHIFTS))]) / scale
                some = acc[:, some_lane] > 0.5 if some_lane is not None \
                    else occupied
                out_cols.append(ColumnVector(sdt, tot.to(sdt.torch_dtype),
                                             some))
        return ColumnarBatch(out_cols,
                             LazyRowCount(occupied.sum(dtype=torch.int32)),
                             occupied)

    def _scatter_agg(self, live, key_cols, state_specs, spec, ranges):
        """The scatter-bucket route: every reduction scatters straight into
        the dense bucket space of the packed key."""
        lay = R.bucket_layout(spec, key_cols, ranges, live)
        out_cols: List[ColumnVector] = []
        for c in R.bucket_unpack_keys(spec, ranges, key_cols):
            v = c.validity & lay.occupied if c.validity is not None \
                else lay.occupied
            out_cols.append(ColumnVector(c.dtype, c.data, v,
                                         dict_unique=c.dict_unique))
        ones = torch.ones(lay.nb, dtype=torch.bool, device=live.device)
        cap = live.shape[0]
        for op, src, sdt in state_specs:
            if src is not None:
                if src.is_string and op not in ("count", "count_all"):
                    raise NotImplementedError(_STRING_STATE)
                valid = live if src.validity is None else (src.validity & live)
                vals = _zeros(cap, sdt, live.device) if src.is_string \
                    else src.data
            else:
                valid, vals = live, _zeros(cap, sdt, live.device)
            ov, oval = self._bucket_op(op, vals, valid, sdt, lay, ones)
            out_cols.append(ColumnVector(sdt, ov.to(sdt.torch_dtype), oval))
        return ColumnarBatch(out_cols, LazyRowCount(lay.n_groups),
                             lay.occupied)

    def _bucket_op(self, op, vals, valid, sdt, lay, ones):
        def nvalid():
            # a no-null column's validity is the live mask the layout
            # already counted
            return lay.counts.to(torch.int64) if valid is lay.live \
                else R.bucket_count(lay, valid)
        if op == "count":
            return nvalid(), ones
        if op == "count_all":
            return lay.counts.to(torch.int64), ones
        some = nvalid() > 0
        if op in ("sum", "sumsq"):
            # the square in the input's own type, as the JAX package does
            v = vals * vals if op == "sumsq" else vals
            if isinstance(sdt, (T.Float64Type, T.Float32Type)):
                return R.bucket_sum_f64(lay, v, valid), some
            return R.bucket_sum_int(lay, v, valid), some
        if op in ("first", "last"):
            v, has = R.bucket_first_last(op, lay, vals, valid)
            return v, has & some
        if op in ("min", "max"):
            if vals.dtype == torch.float64:
                return R.bucket_minmax_f64(op, lay, vals, valid), some
            if vals.dtype == torch.float32:
                return R.bucket_minmax_f32(op, lay, vals, valid), some
            if vals.dtype == torch.bool:
                return R.bucket_minmax_int(op, lay, vals.to(torch.int32),
                                           valid).to(torch.bool), some
            return R.bucket_minmax_int(op, lay, vals, valid), some
        raise ValueError(f"unknown bucket op {op}")


class HashAggregateExec(TorchExec):
    """The hash aggregate in one of the JAX package's three modes:

    - ``partial``: update each input batch into (keys, states) batches,
      merge them within the partition, and yield the states;
    - ``final``: merge the state batches of the partials below an
      exchange, then evaluate;
    - ``complete``: update, merge and evaluate in one operator.

    An upstream filter may be absorbed as ``pre_filter`` (partial and
    complete modes: it narrows the live mask of the update), and stage
    fusion (``exec/stage_fusion.py``) may absorb the narrow chain below
    as ``pre_chain``: its members' stage bodies run in front of the
    update inside one dispatch a batch and inside the retry attempt, so a
    split retry re-runs the chain on each half. With
    spark.rapids.sql.agg.skipAggPassReductionRatio below 1, a keyed
    partial whose first batch kept more than that share of its rows as
    groups yields each batch's states unmerged, for the final to merge.
    """

    def __init__(self, plan, children, conf, device, mode: str = "complete",
                 pre_filter=None):
        super().__init__(plan, children, conf, device)
        self.mode = mode
        self.kern = _AggKernels(plan.group_exprs, plan.aggs, pre_filter,
                                bool(conf.get(C.PALLAS_ENABLED)))
        #: the absorbed chain's stage bodies, child-most first (set by
        #: stage fusion; carry-free by its gate), and their operators
        self.pre_chain: Optional[List[fuse.StageBody]] = None
        self.pre_chain_members: List[TorchExec] = []
        self.fused_stage_id = 0
        self._chain_failed = False

    @property
    def schema(self):
        if self.mode == "partial":
            return T.Schema(tuple(self.state_fields()))
        return self.plan.schema

    def state_fields(self):
        """The schema of the state batches a partial yields: the keys,
        then each aggregate's states as ``<name>__<state>``."""
        fields = [T.StructField(n, e.data_type()) for n, e in
                  zip(self.plan.group_names, self.plan.group_exprs)]
        for a in self.plan.aggs:
            for sname, sdt in a.fn.state_schema():
                fields.append(T.StructField(f"{a.name}__{sname}", sdt))
        return fields

    # -- stage fusion: the absorbed narrow-operator chain -----------------

    def _sig(self, phase: str, ansi: bool = False):
        return ("hashagg", phase) + self.kern._fp() + (ansi,)

    def _chain_key(self, ansi: bool):
        return ("hashagg_chain_update",
                tuple(b.key for b in self.pre_chain),
                self._sig("update", ansi))

    def _build_chain_update(self, ansi: bool):
        """The chain's bodies, then the update's tiny-bucket, sort or
        global route, composed into one function a batch:
        ``fn(batch, pid, ctx_of) -> (states, [errors...], [rows...])``
        with each member's live output rows."""
        bodies = list(self.pre_chain)
        kern = self.kern

        def build():
            fns = [b.builder() for b in bodies]

            def fn(batch, pid, ctx_of):
                errs_all, rows = [], []
                for f in fns:
                    batch, errs, _ = f(batch, pid, 0)
                    errs_all.append(errs)
                    rows.append(live_rows(batch))
                out, uerrs = kern.general_update(batch, ctx_of)
                errs_all.append(uerrs)
                return out, errs_all, rows
            return fn
        return build

    def _unfused_pre_chain(self, source):
        from spark_rapids_tpu_torch.exec.stage_fusion import rebuild_chain
        return rebuild_chain(self.pre_chain_members, source)

    def tree_string(self, indent: int = 0) -> str:
        if not self.pre_chain_members:
            return super().tree_string(indent)
        pad = "  " * indent
        sid = self.fused_stage_id
        lines = [f"{pad}*({sid}) {self.name()} <- {self.plan.describe()}"]
        for m in reversed(self.pre_chain_members):
            lines.append(f"{pad}  *({sid}) {type(m).__name__} "
                         f"<- {m.plan.describe()} [fused]")
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def execute_partition(self, pidx):
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        agg_t = self.metrics.metric(M.AGG_TIME)
        in_batches = self.metrics.metric(M.NUM_INPUT_BATCHES)
        nkeys = len(self.plan.group_exprs)
        batches = self.children[0].execute_partition(pidx)
        skip_merge = False
        if self.mode == "final":
            partials = list(batches)
            in_batches.add(len(partials))
        else:
            ansi = bool(self.conf.get(C.ANSI_ENABLED))

            def plain_attempt(b):
                # the update (with an absorbed pre-filter) is idempotent
                # over its input batch: retried after a spill drain, or
                # split in half, on OOM (JAX tpu_nodes.py:2727-2815)
                with self.span(agg_t):
                    out, errs = self.kern.update(b, self._ctx, ansi)
                    raise_errors(errs)
                return out

            attempt = plain_attempt
            chain_live = False
            chain_in_rows = [None]  # the rows the update phase saw
            if self.pre_chain and self._chain_failed:
                # an earlier partition's build failed: the unfused member
                # chain runs in front of the plain update
                batches = self._unfused_pre_chain(
                    self.children[0]).execute_partition(pidx)
            elif self.pre_chain:
                chain_fn = None
                try:
                    chain_fn = fuse.fused(self._chain_key(ansi),
                                          self._build_chain_update(ansi))
                except Exception as ex:  # noqa: BLE001 - see below
                    from spark_rapids_tpu_torch.expr.core import (
                        SparkException,
                    )
                    from spark_rapids_tpu_torch.runtime.lifecycle import (
                        QueryCancelledError,
                    )
                    if isinstance(ex, (SparkException, QueryCancelledError)):
                        raise
                    # the per-stage fallback: only BUILDING the composed
                    # function may fall back; an error raised while a
                    # batch runs propagates (no trace to fail here)
                    _LOG.warning("absorbed-chain build failed for %s; "
                                 "falling back to the unfused chain",
                                 self.name(), exc_info=True)
                    self._chain_failed = True
                    batches = self._unfused_pre_chain(
                        self.children[0]).execute_partition(pidx)
                if chain_fn is not None:
                    disp = self.metrics.metric(M.STAGE_DISPATCHES)
                    member_rows = [m.metrics.metric(M.NUM_OUTPUT_ROWS)
                                   for m in self.pre_chain_members]
                    rng = fuse.stage_range(
                        f"AbsorbedStage#{self.fused_stage_id}")

                    def chain_attempt(b):
                        # chain + update: one dispatch, idempotent over its
                        # input (carry-free bodies), so retry and split
                        # retry treat it as a plain update
                        disp.add(1)
                        if TR.active() is not None:
                            TR.instant("stageDispatch", cat="dispatch",
                                       args={"stage_id": self.fused_stage_id,
                                             "absorbed": True,
                                             "members": len(
                                                 self.pre_chain_members)
                                             + 1})
                        with self.span(agg_t), rng():
                            out, errs_list, rows = chain_fn(b, pidx,
                                                            self._ctx)
                            for e in errs_list:
                                raise_errors(e)
                        for mr, r in zip(member_rows, rows):
                            mr.add(r)
                        if rows:
                            chain_in_rows[0] = rows[-1]
                        return out

                    attempt = chain_attempt
                    chain_live = True
            if self.kern.has_custom or (
                    nkeys and self.conf.get(C.AGG_FORCE_SINGLE_PASS)):
                # one update pass over the partition's rows, concatenated:
                # a segmented aggregate's result cannot merge (and the
                # testing knob asks for it)
                batches = list(batches)
                if len(batches) > 1:
                    batches = [K.concat_batches(batches)]
            ratio = float(self.conf.get(C.SKIP_AGG_PASS_RATIO))
            partials = []

            for bi, batch in enumerate(batches):
                self._acquire()
                in_batches.add(1)
                for si, out in enumerate(with_retry(attempt, batch)):
                    partials.append(ColumnarBatch(out.columns, 1)
                                    if nkeys == 0 else out)
                    if bi == 0 and si == 0 and ratio < 1.0 and nkeys \
                            and self.mode == "partial":
                        # sampled on the first batch only: each count is
                        # a sync. With an absorbed chain, against the
                        # chain's output rows.
                        src = chain_in_rows[0] if chain_live \
                            and chain_in_rows[0] is not None \
                            else batch.num_rows
                        skip_merge = int(out.num_rows) > ratio * max(
                            int(src), 1)
        if not partials:
            if nkeys:
                return
            partials = [self._empty_state_batch()]
        self._acquire()
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        if skip_merge and len(partials) > 1:
            for p in partials:
                p = K.compact_batch(p)
                out_rows.add(p.num_rows)
                out_batches.add(1)
                yield p
            return
        with self.span(agg_t):
            merged = self._merge(partials)
            if self.mode != "partial":
                merged = self._evaluate(merged)
        out_rows.add(merged.num_rows)
        out_batches.add(1)
        yield merged

    def _merge(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        """Fold the partition's state batches into one. A single batch
        already has unique keys, unless a coalesce concatenated it from
        several (``coalesced``): that one still merges."""
        if len(partials) == 1 and not partials[0].coalesced:
            return partials[0]
        batch = K.concat_batches(partials)
        nkeys = len(self.plan.group_exprs)
        if nkeys == 0 and int(batch.num_rows) <= 1:
            return batch
        out = self.kern.merge(batch)
        return ColumnarBatch(out.columns, 1) if nkeys == 0 else out

    def _evaluate(self, state: ColumnarBatch) -> ColumnarBatch:
        fn = fuse.fused(self._sig("evaluate"),
                        lambda: self.kern.evaluate_states)
        return fn(state)

    def _empty_state_batch(self) -> ColumnarBatch:
        """A zero-row update: count states are 0 and valid, others null."""
        cap = round_capacity(1)
        first = torch.arange(cap, device=self.device) < 1
        cols = []
        for f in self.state_fields():
            is_count = f.name.endswith("__count")
            cols.append(ColumnVector(
                f.dtype, _zeros(cap, f.dtype, self.device),
                first if is_count else torch.zeros(cap, dtype=torch.bool,
                                                   device=self.device)))
        return ColumnarBatch(cols, 1)


# ---------------------------------------------------------------------------
# Limit, TopN, sort
# ---------------------------------------------------------------------------

class LimitExec(TorchExec):
    """The first n rows of each partition, in order (masked batches are
    compacted first); no batch is pulled once n rows are out. In a fused
    stage its body masks the rows past a budget carried on the device
    instead."""

    def stage_body(self) -> fuse.StageBody:
        return limit_stage_body(self.plan.n, self.device)

    def execute_partition(self, pidx):
        remaining = self.plan.n
        if remaining <= 0:
            return
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            if batch.row_mask is not None:
                batch = K.compact_batch(batch)
            n = int(batch.num_rows)
            if n <= remaining:
                remaining -= n
                yield batch
            else:
                yield K.slice_batch(batch, 0, remaining)
                remaining = 0
            if remaining <= 0:
                # stop before pulling another batch, as the fused limit
                # does (the JAX package's LimitExec pulls one more)
                return


def _order_keys(kc: ColumnVector, o, num_rows, live=None, n_chunks=None):
    """(int64 key, nulls, ascending, nulls first) for one sort order: one
    entry for fixed-width types, one per 8-byte chunk for strings (exact
    byte order, ``string_chunk_keys``)."""
    if kc.is_string:
        if n_chunks is None:
            n_chunks = K.string_chunk_count(kc)
        return [(k, nulls, o.ascending, o.resolved_nulls_first())
                for k, nulls in K.string_chunk_keys(kc, num_rows, n_chunks,
                                                    live=live)]
    k, nulls = K.normalize_key(kc, num_rows, live=live)
    return [(k, nulls, o.ascending, o.resolved_nulls_first())]


def _sort_perm_for(orders, batch: ColumnarBatch, ctx: EvalCtx):
    live = batch.live_mask()
    keys = []
    for o in orders:
        keys.extend(_order_keys(o.expr.eval(ctx), o, batch.num_rows,
                                live=live))
    return K.lexsort_indices(keys, batch.num_rows, live=live)


_MIN32 = -(1 << 31)
_MAX32 = (1 << 31) - 1


def _topn_image(kc: ColumnVector, order, live) -> Optional[torch.Tensor]:
    """A monotone int32 image of a sort key in which rows that belong
    earlier in the output are larger (so ``torch.topk`` selects them).
    64-bit keys pass through float32, so ties may collapse: the image only
    sets a candidate threshold, and the final sort is exact. None for
    strings."""
    d = kc.dtype
    if kc.is_string:
        return None
    if isinstance(d, (T.Float32Type, T.Float64Type)):
        x = kc.data.to(torch.float32)
        x = torch.where(torch.isnan(x), float("nan"), x)
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        bits = x.view(torch.int32)
        img = torch.where(bits < 0, ~bits ^ _MIN32, bits)
    elif isinstance(d, (T.Int64Type, T.TimestampType, T.DecimalType)):
        bits = kc.data.to(torch.float32).view(torch.int32)
        img = torch.where(bits < 0, ~bits ^ _MIN32, bits)
    else:
        img = kc.data.to(torch.int32)
    if order.ascending:
        img = ~img  # a monotone reversal without INT_MIN overflow
    if kc.validity is not None:
        img = torch.where(kc.validity, img,
                          _MAX32 if order.resolved_nulls_first() else _MIN32)
    return torch.where(live, img, _MIN32)


class TopNExec(TorchExec):
    """ORDER BY + LIMIT n without sorting the whole input: ``torch.topk``
    over a monotone int32 image of the first sort key gives a threshold,
    and only the candidate rows at or above it get the exact sort. One
    host read (the candidate count); ties and collapsed images widen the
    candidate set, and one wider than max(4n, 4096) falls back to the
    exact full sort, as string keys do."""

    def __init__(self, plan, children, conf, device, orders, n: int):
        super().__init__(plan, children, conf, device)
        self.orders = orders
        self.n = n
        self._imageable = all(not isinstance(o.expr.data_type(),
                                             T.StringType) for o in orders)

    def execute_partition(self, pidx):
        sort_t = self.metrics.metric(M.SORT_TIME)
        batches = list(self.children[0].execute_partition(pidx))
        if not batches:
            return
        self._acquire()
        batch = K.concat_batches(batches) if len(batches) > 1 else batches[0]
        with self.span(sort_t):
            out = self._top(batch)
        yield out

    def _fp(self):
        return (tuple((o.expr.fingerprint(), o.ascending,
                       o.resolved_nulls_first()) for o in self.orders),
                self.n, str(self.device))

    def _top(self, batch: ColumnarBatch) -> ColumnarBatch:
        from spark_rapids_tpu_torch.runtime.pipeline import start_d2h
        n = self.n
        bound = max(4 * n, 4096)
        if self._imageable and batch.capacity > bound:
            orders, device = self.orders, self.device

            def build_select():
                def fn(b):
                    live = b.live_mask()
                    kc = orders[0].expr.eval(EvalCtx(
                        b.columns, b.num_rows, b.capacity, device,
                        live=live))
                    img = _topn_image(kc, orders[0], live)
                    thr = torch.topk(img, min(n, b.capacity)).values[-1]
                    cand = live & (img >= thr)
                    return cand, cand.sum(dtype=torch.int64)
                return fn

            sel_fn = fuse.fused(("topn_select", self._fp()), build_select)
            cand, cnt_d = sel_fn(batch)
            cnt = int(start_d2h(cnt_d).numpy())
            if cnt <= bound:
                def build_sort():
                    def fn(b, cand, cnt):
                        small = K.gather_batch(
                            b, K._compact_indices(cand,
                                                  round_capacity(bound)),
                            cnt)
                        perm = _sort_perm_for(orders, small, EvalCtx(
                            small.columns, small.num_rows, small.capacity,
                            device, live=small.live_mask()))
                        m = min(cnt, n)
                        idx = torch.arange(round_capacity(n), device=device)
                        sel = torch.where(idx < m, perm[:idx.shape[0]], -1)
                        return ColumnarBatch(
                            K.gather_batch(small, sel, cnt).columns, m)
                    return fn

                srt = fuse.fused(("topn_sort", self._fp()), build_sort)
                return srt(batch, cand, cnt)
        # the exact full sort: string keys, small inputs, or a wide tie set
        if batch.row_mask is not None:
            batch = K.compact_batch(batch)
        total = int(batch.num_rows)
        perm = _sort_perm_for(self.orders, batch, self._ctx(batch))
        out = K.gather_batch(batch, perm, batch.num_rows)
        return K.slice_batch(out, 0, min(n, total))


class SortExec(TorchExec):
    """Whole-partition sort: normalized keys, one stable lexsort, one
    gather. Inputs above spark.rapids.sql.sort.outOfCoreBytes sort out of
    core (``_out_of_core``)."""

    def execute_partition(self, pidx):
        sort_t = self.metrics.metric(M.SORT_TIME)
        batches = list(self.children[0].execute_partition(pidx))
        if not batches:
            return
        self._acquire()
        total = sum(b.device_memory_size() for b in batches)
        if total > self.conf.get(C.SORT_OOC_BYTES):
            it = self._out_of_core(batches)
            while True:
                with self.span(sort_t):
                    b = next(it, None)
                if b is None:
                    return
                yield b
        batch = K.concat_batches(batches) if len(batches) > 1 else batches[0]
        if batch.row_mask is not None:
            batch = K.compact_batch(batch)
        with self.span(sort_t):
            perm = _sort_perm_for(self.plan.orders, batch, self._ctx(batch))
            out = K.gather_batch(batch, perm, batch.num_rows)
        yield out

    def _out_of_core(self, batches):
        """Only the key planes stay on the device: each batch's keys are
        computed and its rows staged to the host (pyarrow); one lexsort of
        the concatenated keys gives the permutation, pyarrow assembles the
        sorted rows, and they come back in reader-sized slices."""
        import pyarrow as pa
        orders = self.plan.orders
        names = self.plan.schema.names
        compacted, key_cols = [], []
        for b in batches:
            if b.row_mask is not None:
                b = K.compact_batch(b)
            if int(b.num_rows) == 0:
                continue
            compacted.append(b)
            ctx = self._ctx(b)
            key_cols.append([o.expr.eval(ctx) for o in orders])
        if not compacted:
            return
        # a string key's chunk count is the widest over the batches, so
        # the key planes of every batch line up
        widths = [max(K.string_chunk_count(kc[i]) for kc in key_cols)
                  if isinstance(o.expr.data_type(), T.StringType) else 1
                  for i, o in enumerate(orders)]
        per_batch, tables = [], []
        for b, kcs in zip(compacted, key_cols):
            n = int(b.num_rows)
            planes = []
            for o, kc, w in zip(orders, kcs, widths):
                for k, nulls, _, _ in _order_keys(kc, o, n, n_chunks=w):
                    planes.append((k[:n], nulls[:n]))
            per_batch.append(planes)
            tables.append(to_arrow(b, names))  # stages the rows off the card
        keys, pi = [], 0
        for o, w in zip(orders, widths):
            for _ in range(w):
                keys.append((torch.cat([p[pi][0] for p in per_batch]),
                             torch.cat([p[pi][1] for p in per_batch]),
                             o.ascending, o.resolved_nulls_first()))
                pi += 1
        n = int(keys[0][0].shape[0])
        perm = K.lexsort_indices(keys, n)[:n].cpu().numpy()
        table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
        ordered = table.take(perm)
        step = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        for off in range(0, n, step):
            yield from_arrow(ordered.slice(off, min(step, n - off)),
                             self.device)



# ---------------------------------------------------------------------------
# Window
# ---------------------------------------------------------------------------

def _boundaries(sorted_plane: torch.Tensor) -> torch.Tensor:
    """True where a sorted plane starts a new run (row 0 always)."""
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_plane.device),
                      sorted_plane[1:] != sorted_plane[:-1]])


class _WindowLayout:
    """The sorted-space planes every window function reads: segment and
    peer bounds (ends clamped to the live rows), segment ids, the
    boundary flags, row positions and the live mask."""

    def __init__(self, segb, peerb, num_rows: int):
        cap = segb.shape[0]
        self.seg_start, seg_end, self.peer_start, peer_end = \
            W.segment_layout(segb, peerb)
        self.seg_end = seg_end.clamp(max=max(num_rows - 1, 0))
        self.peer_end = torch.minimum(peer_end, self.seg_end)
        self.seg_id = torch.cumsum(segb.to(torch.int32), 0)
        self.segb, self.peerb = segb, peerb
        self.idx = torch.arange(cap, dtype=torch.int64, device=segb.device)
        self.live = self.idx < num_rows


class WindowExec(TorchExec):
    """Window evaluation: one sort by the (partition, order) keys, then
    every window function of the node as segmented scans
    (``ops/window.py``). Two routes, as in the JAX package:

    - packed: when every key packs into one int64 plane
      (``_probe_pack_spec``) and every order key is an integer, date or
      bool, one stable sort of the order-faithful packed plane; window
      values are computed in sorted space and scattered back, so the
      output keeps the input's row order, and data columns are gathered
      only when a function reads them;
    - general: ``lexsort_indices`` over the normalized keys; the whole
      batch is gathered into sorted order, and the output stays in it.
    """

    def execute_partition(self, pidx):
        win_t = self.metrics.metric(M.OP_TIME)
        batches = list(self.children[0].execute_partition(pidx))
        if not batches:
            return
        self._acquire()
        batch = K.concat_batches(batches) if len(batches) > 1 else batches[0]
        with self.span(win_t):
            out = self._window(batch)
        yield out

    def _window(self, batch: ColumnarBatch) -> ColumnarBatch:
        """One batch through the route's dispatches, under the JAX
        package's key families: the keys' ``run_stage``, then
        ``window_sortlay`` and ``window_fns`` (packed, with a frame
        aggregate: two dispatches, as the JAX package splits them),
        ``window_packed`` or ``window``."""
        if batch.row_mask is not None:
            batch = K.compact_batch(batch)
        spec = self.plan.window_exprs[0].spec  # one spec per node
        nparts = len(spec.partition_exprs)
        key_exprs = list(spec.partition_exprs) + [o.expr
                                                  for o in spec.order_specs]
        if key_exprs:
            kcols = compiled.run_stage(key_exprs, batch, self.device,
                                       bool(self.conf.get(C.ANSI_ENABLED)))
            pk, ranges, _ = _probe_pack_spec(kcols, batch.live_mask(),
                                             key_exprs)
            # dictionary codes are not value-ordered: they pack only as
            # partition keys
            if pk is not None and all(k in (R.KIND_INT, R.KIND_BOOL)
                                      for k in pk.kinds[nparts:]):
                return self._packed(batch, kcols, pk, ranges)
        return self._general(batch)

    def _packed(self, batch, kcols, pk, ranges) -> ColumnarBatch:
        exprs = list(self.plan.window_exprs)
        spec = exprs[0].spec
        nparts = len(spec.partition_exprs)
        key_exprs = list(spec.partition_exprs) + [o.expr
                                                  for o in spec.order_specs]
        flags = [(True, True)] * nparts + [
            (o.ascending, o.resolved_nulls_first()) for o in spec.order_specs]
        efp = tuple(w.fingerprint() for w in exprs)
        pkey = (pk.kinds, pk.bits)
        dev = self.device
        if any(isinstance(w.fn, WE.WindowAgg) for w in exprs):
            fn_lay = fuse.fused(
                ("window_sortlay", tuple(e.fingerprint() for e in key_exprs),
                 tuple(flags[nparts:]), pkey),
                lambda: _window_sort_layout(pk, nparts, flags))
            fn_apply = fuse.fused(("window_fns", efp, pkey),
                                  lambda: _window_apply_fns(exprs, dev))
            perm, lay = fn_lay(batch, kcols, ranges)
            return fn_apply(batch, perm, lay)
        fn = fuse.fused(("window_packed", efp, pkey),
                        lambda: _window_packed(pk, nparts, flags, exprs, dev))
        return fn(batch, kcols, ranges)

    def _general(self, batch) -> ColumnarBatch:
        exprs = list(self.plan.window_exprs)
        dev = self.device
        ansi = bool(self.conf.get(C.ANSI_ENABLED))
        fn = fuse.fused(("window", tuple(w.fingerprint() for w in exprs)),
                        lambda: _window_general(exprs[0].spec, exprs, dev,
                                                ansi))
        return fn(batch)


# The window routes' stage functions: module-level, capturing expressions,
# static settings and the device only, never the operator (its child tree
# can pin cached batches in the process-wide keyed cache).

def _window_sort_layout(pk, nparts, flags):
    """Packed route, first half: one stable sort of the packed key plane
    and the sorted-space layout -> (perm, layout)."""
    obits = sum(pk.bits[nparts:])

    def fn(batch, kcols, ranges):
        nr = int(batch.num_rows)
        packed = R.pack_keys_sort(pk, kcols, ranges, batch.live_mask(),
                                  flags)
        sp, perm = torch.sort(packed, stable=True)
        return perm, _WindowLayout(_boundaries(sp >> obits),
                                   _boundaries(sp), nr)
    return fn


def _window_apply_fns(exprs, device):
    """Packed route, second half: every window function in sorted space,
    taken back to the input's row order by one inverse permutation."""

    def fn(batch, perm, lay):
        nr = int(batch.num_rows)
        live = batch.live_mask()
        sctx = EvalCtx([], nr, batch.capacity, device)
        sctx.columns = K.LazyGatheredCols(batch.columns, perm, nr)
        inv = torch.empty_like(perm)
        inv[perm] = lay.idx
        out_cols = list(batch.columns)
        for w in exprs:
            out = K.gather_column(_eval_window_fn(w, sctx, lay), inv, nr)
            out_cols.append(ColumnVector(out.dtype, out.data,
                                         out.validity & live,
                                         dict_unique=out.dict_unique))
        return ColumnarBatch(out_cols, nr)
    return fn


def _window_packed(pk, nparts, flags, exprs, device):
    """The packed route in one dispatch (no frame aggregate)."""
    layout = _window_sort_layout(pk, nparts, flags)
    apply = _window_apply_fns(exprs, device)

    def fn(batch, kcols, ranges):
        perm, lay = layout(batch, kcols, ranges)
        return apply(batch, perm, lay)
    return fn


def _window_general(spec, exprs, device, ansi):
    """The general route: ``lexsort_indices`` over the normalized keys,
    the whole batch gathered into sorted order (the output stays in
    it)."""

    def fn(batch):
        nr = int(batch.num_rows)
        ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity, device,
                      ansi, live=batch.live_mask())
        pnorm = [K.normalize_key(e.eval(ctx), nr)
                 for e in spec.partition_exprs]
        onorm = [K.normalize_key(o.expr.eval(ctx), nr)
                 for o in spec.order_specs]
        raise_errors(ctx.errors)
        sort_keys = [(k, nl, True, True) for k, nl in pnorm]
        sort_keys += [(k, nl, o.ascending, o.resolved_nulls_first())
                      for (k, nl), o in zip(onorm, spec.order_specs)]
        if sort_keys:
            perm = K.lexsort_indices(sort_keys, nr)
            sorted_cols = K.gather_batch(batch, perm, nr).columns
        else:
            sorted_cols = list(batch.columns)
        segb = torch.zeros(batch.capacity, dtype=torch.bool, device=device)
        segb[0] = True
        for k, nl in pnorm:
            segb = segb | _boundaries(k[perm]) | _boundaries(nl[perm])
        peerb = segb
        for k, nl in onorm:
            peerb = peerb | _boundaries(k[perm]) | _boundaries(nl[perm])
        lay = _WindowLayout(segb, peerb, nr)
        sctx = EvalCtx(sorted_cols, nr, batch.capacity, device)
        out_cols = list(sorted_cols)
        for w in exprs:
            out_cols.append(_eval_window_fn(w, sctx, lay))
        return ColumnarBatch(out_cols, nr)
    return fn


def _dense_probe_masked(how, left_keys, condition, key_map, device, ansi):
    """The masked dense probe's stage function: captures expressions,
    static settings and the device, never the join operator."""

    def fn(probe, build, slot_idx, bmin):
        plive = probe.live_mask()
        ctx = EvalCtx(probe.columns, probe.num_rows, probe.capacity, device,
                      ansi, live=plive)
        probe_keys = [e.eval(ctx) for e in left_keys]
        raise_errors(ctx.errors)
        pk0 = probe_keys[0]
        p_in = plive if pk0.validity is None else (plive & pk0.validity)
        bidx = J.dense_lookup_planes(slot_idx, bmin,
                                     pk0.data.to(torch.int64), p_in)
        matched = bidx >= 0
        blive = build.live_mask() if build.row_mask is not None else None
        bcols = []
        for ci, c in enumerate(build.columns):
            ki = key_map.get(ci)
            if ki is not None:
                pk = probe_keys[ki]
                v = (pk.validity & matched) if pk.validity is not None \
                    else matched
                bcols.append(ColumnVector(c.dtype, pk.data, v))
            else:
                bcols.append(K.gather_column(c, bidx, build.num_rows,
                                             src_live=blive))
        if condition is not None:
            cctx = EvalCtx(list(probe.columns) + bcols, probe.num_rows,
                           probe.capacity, device, ansi, live=plive)
            pred = condition.eval(cctx)
            raise_errors(cctx.errors)
            ok = pred.data.to(torch.bool)
            if pred.validity is not None:
                ok = ok & pred.validity
            matched = matched & ok
        if how == "left_semi":
            return K.mask_filter_batch(probe, matched)
        if how == "left_anti":
            return K.mask_filter_batch(probe, ~matched)
        if how == "inner":
            live = plive & matched
            return ColumnarBatch(list(probe.columns) + bcols,
                                 LazyRowCount(live.sum(dtype=torch.int32)),
                                 live)
        ob = [ColumnVector(c.dtype, c.data,
                           (c.validity & matched) if c.validity is not None
                           else matched, dict_unique=c.dict_unique)
              for c in bcols]
        return ColumnarBatch(list(probe.columns) + ob, probe.num_rows,
                             probe.row_mask)
    return fn


def _frame_end(frame, lay: _WindowLayout) -> torch.Tensor:
    """The last row of each row's frame when the frame starts at the
    partition's start."""
    if frame.lower is None and frame.upper is None:
        return lay.seg_end
    if frame.upper != 0:
        return lay.seg_end
    return lay.peer_end if frame.kind == "range" else lay.idx


def _eval_window_fn(w, sctx: EvalCtx, lay: _WindowLayout) -> ColumnVector:
    """One window function over sorted rows."""
    fn = w.fn
    rt = fn.result_type()
    live = lay.live
    if isinstance(fn, WE.RowNumber):
        return ColumnVector(rt, W.row_number(lay.seg_start), live)
    if isinstance(fn, WE.Rank):
        return ColumnVector(rt, W.rank(lay.seg_start, lay.peer_start), live)
    if isinstance(fn, WE.DenseRank):
        return ColumnVector(rt, W.dense_rank(lay.segb, lay.peerb,
                                             lay.seg_start), live)
    if isinstance(fn, WE.NTile):
        return ColumnVector(rt, W.ntile(fn.n, lay.seg_start, lay.seg_end),
                            live)
    if isinstance(fn, WE.LeadLag):
        src = fn.children[0].eval(sctx)
        off = fn.offset if fn.is_lead else -fn.offset
        svalid = src.validity if src.validity is not None else live
        vals, valid = W.lead_lag(src.data, svalid, lay.seg_id, off)
        if fn.default is not None:
            in_seg = (lay.idx + off >= lay.seg_start) \
                & (lay.idx + off <= lay.seg_end)
            vals = torch.where(in_seg, vals, torch.full_like(vals,
                                                             fn.default))
            valid = valid | ~in_seg
        return ColumnVector(src.dtype, vals, valid & live)
    if isinstance(fn, WE.PercentRank):
        n_seg = (lay.seg_end - lay.seg_start + 1).to(torch.float64)
        rk = W.rank(lay.seg_start, lay.peer_start).to(torch.float64)
        v = torch.where(n_seg > 1, (rk - 1.0) / torch.clamp(n_seg - 1.0,
                                                            min=1.0), 0.0)
        return ColumnVector(rt, v, live)
    if isinstance(fn, WE.CumeDist):
        n_seg = (lay.seg_end - lay.seg_start + 1).to(torch.float64)
        v = (lay.peer_end - lay.seg_start + 1).to(torch.float64) / n_seg
        return ColumnVector(rt, v, live)
    if isinstance(fn, (WE.NthValue, WE.FirstValue, WE.LastValue)):
        src = fn.children[0].eval(sctx)
        svalid = src.validity if src.validity is not None else live
        frame_end = _frame_end(w.spec.resolved_frame(), lay)
        if isinstance(fn, WE.LastValue):
            pos, ok = frame_end, live
        elif isinstance(fn, WE.FirstValue):
            pos, ok = lay.seg_start, live
        else:
            pos = lay.seg_start + (fn.n - 1)
            ok = live & (pos <= frame_end)
        cap = lay.idx.shape[0]
        return K.gather_column(src, torch.where(ok, pos.clamp(0, cap - 1), -1),
                               cap, src_live=svalid)
    if isinstance(fn, WE.WindowAgg):
        return _eval_window_agg(fn, w.spec.resolved_frame(), sctx, lay)
    raise NotImplementedError(type(fn).__name__)


def _eval_window_agg(fn, frame, sctx: EvalCtx,
                     lay: _WindowLayout) -> ColumnVector:
    """sum, count, count(*), avg, min or max over the frame: running
    (from the partition's start) or unbounded frames by one segmented
    cumsum or scan, other ROWS frames by prefix differences."""
    agg = fn.fn
    rt = agg.result_type()
    live = lay.live
    if agg.children:
        src = agg.children[0].eval(sctx)
        vals = src.data
        svalid = (src.validity if src.validity is not None else live) & live
    else:  # count(*)
        vals = torch.ones_like(lay.idx)
        svalid = live
    unbounded = frame.lower is None and frame.upper is None
    bounded_rows = frame.kind == "rows" and not unbounded and not (
        frame.lower is None and frame.upper == 0)
    fe = _frame_end(frame, lay)

    def sum_count(v, valid):
        if bounded_rows:
            return W.bounded_sum_count(v, valid, lay.seg_start, lay.seg_end,
                                       frame.lower, frame.upper)
        return W.running_sum_count(v, valid, lay.seg_start, fe)

    if isinstance(agg, (A.Min, A.Max)):
        v, c = W.running_minmax("min" if isinstance(agg, A.Min) else "max",
                                vals, svalid, lay.seg_start, fe)
        return ColumnVector(rt, v.to(rt.torch_dtype), (c > 0) & live)
    if isinstance(agg, A.CountAll):
        cnt, _ = sum_count(torch.ones_like(lay.idx), live)
        return ColumnVector(T.INT64, cnt, live)
    if isinstance(agg, A.Average):
        s, c = sum_count(vals.to(torch.float64), svalid)
        return ColumnVector(rt, s / torch.clamp(c, min=1), (c > 0) & live)
    if not vals.is_floating_point():
        vals = vals.to(torch.int64)
    s, c = sum_count(vals, svalid)
    if isinstance(agg, A.Count):
        return ColumnVector(T.INT64, c, live)
    if isinstance(agg, A.Sum):
        return ColumnVector(rt, s.to(rt.torch_dtype), (c > 0) & live)
    raise NotImplementedError(type(agg).__name__)

# ---------------------------------------------------------------------------
# Hash joins
# ---------------------------------------------------------------------------

def _null_column(dtype: T.DataType, cap: int, device) -> ColumnVector:
    """An all-null column of ``dtype`` at capacity ``cap``."""
    no = torch.zeros(cap, dtype=torch.bool, device=device)
    if isinstance(dtype, T.StringType):
        return ColumnVector(dtype, {
            "offsets": torch.zeros(cap + 1, dtype=torch.int32, device=device),
            "bytes": torch.zeros(8, dtype=torch.uint8, device=device)}, no)
    return ColumnVector(dtype, _zeros(cap, dtype, device), no)


def _empty_batch(schema: T.Schema, device, cap: int = 0) -> ColumnarBatch:
    cap = cap or round_capacity(0)
    return ColumnarBatch([_null_column(f.dtype, cap, device)
                          for f in schema.fields], 0)


def _pair_batch(left: ColumnarBatch, right: ColumnarBatch, li, ri, n
                ) -> ColumnarBatch:
    """Both sides gathered at the pairs (index -1 gathers null). Masked
    sides join uncompacted, so a gather reads validity through the live
    mask, never ``arange < num_rows``."""
    llive = left.live_mask() if left.row_mask is not None else None
    rlive = right.live_mask() if right.row_mask is not None else None
    cols = [K.gather_column(c, li, left.num_rows, src_live=llive)
            for c in left.columns]
    cols += [K.gather_column(c, ri, right.num_rows, src_live=rlive)
             for c in right.columns]
    return ColumnarBatch(cols, n)


def _concat_idx(a, na: int, b, nb: int, cap: int) -> torch.Tensor:
    """a[:na] then b[:nb], -1 padded to cap."""
    r = torch.arange(cap, dtype=torch.int64, device=a.device)
    av = a[r.clamp(0, a.shape[0] - 1)]
    bv = b[(r - na).clamp(0, b.shape[0] - 1)]
    return torch.where(r < na, av, torch.where(r < na + nb, bv, -1))


class _HashJoinBase(TorchExec):
    """The probe loop of the hash joins; the build side is the right
    child. Inner, left, semi and anti joins with a unique dense build key
    emit the probe planes untouched under a new live mask (no pairs);
    otherwise pairs come from ``ops/join.join_pairs``. A build side above
    spark.rapids.sql.join.subPartitionRows splits with the probe by key
    hash (seed 107) into buckets joined pairwise."""

    def __init__(self, plan, children, conf, device, part_keys=None):
        super().__init__(plan, children, conf, device)
        #: common-type (left keys, right keys) for hashing; the planner
        #: sets them on the shuffled path, they are derived elsewhere
        self.part_keys = part_keys
        self._split_lock = threading.Lock()
        self._split_cache = None
        #: caching the split pays only when partitions share one build
        self._cache_build_split = False

    def _sub_parts(self, build_rows: int) -> int:
        thr = self.conf.get(C.JOIN_SUBPARTITION_ROWS)
        if build_rows <= thr:
            return 1
        return min(-(-build_rows // thr), 64)

    def _dense_table_for(self, build, build_keys):
        """The direct-address table of a build batch, prepared once (one
        four-scalar read) and kept on the plan node and, for a reused
        broadcast, in its entry in the cached relation's store."""
        cached = getattr(self.plan, "_dense_table_cache", None)
        if cached is not None and cached[0] is build:
            return cached[1]
        entry = getattr(self.plan, "_bcast_entry", None)
        if entry is None or entry["build"] is not build:
            entry = {"dense": {}}
        tkey = tuple(type(e.data_type()).__name__
                     for e in self.plan.left_keys)
        if tkey not in entry["dense"]:
            entry["dense"][tkey] = J.prepare_dense_build(
                build_keys, build.num_rows,
                [e.data_type() for e in self.plan.left_keys]) \
                if int(build.num_rows) > 0 else None
        self.plan._dense_table_cache = (build, entry["dense"][tkey])
        return entry["dense"][tkey]

    def _hash_keys(self, side: int):
        if self.part_keys is None:
            # murmur3 is width-sensitive: both sides hash the common type
            lks, rks = [], []
            for lk, rk in zip(self.plan.left_keys, self.plan.right_keys):
                ct = T.common_type(lk.data_type(), rk.data_type())
                lks.append(lk if lk.data_type() == ct else Cast(lk, ct))
                rks.append(rk if rk.data_type() == ct else Cast(rk, ct))
            self.part_keys = (lks, rks)
        return self.part_keys[side]

    def _eval(self, exprs, batch):
        ctx = self._ctx(batch)
        cols = [e.eval(ctx) for e in exprs]
        raise_errors(ctx.errors)
        return cols

    def _split_build(self, build, k):
        """The build side in k key-hash buckets, each compacted, with its
        key columns; cached when partitions share one build."""
        def compute():
            return [(bpc, self._eval(self.plan.right_keys, bpc))
                    for bpc in map(K.compact_batch, self._bucket_split(
                        build, self._hash_keys(1), k))]
        if not self._cache_build_split:
            return compute()
        with self._split_lock:
            if self._split_cache is None or self._split_cache[0] is not build:
                self._split_cache = (build, compute())
            return self._split_cache[1]

    def _bucket_split(self, batch, keys, k, seed=107):
        """k masked views of a batch, one per hash bucket of its keys
        (shared planes, different live masks)."""
        live = batch.live_mask()
        key_cols = self._eval(keys, batch)
        h = K.partition_hash_batch(key_cols, batch.num_rows, seed=seed,
                                   live=live)
        b = torch.remainder(h, k)
        out = []
        for i in range(k):
            m = live & (b == i)
            out.append(ColumnarBatch(batch.columns,
                                     LazyRowCount(m.sum(dtype=torch.int32)),
                                     m))
        return out

    def _probe_stream(self, probe_iter, build, build_keys,
                      track_build_matches: bool):
        """The joined batches of a probe stream; for right and full joins,
        then the build rows no probe row matched."""
        join_t = self.metrics.metric(M.JOIN_TIME)
        how = self.plan.how
        matched_build = torch.zeros(build.capacity, dtype=torch.bool,
                                    device=self.device) \
            if track_build_matches else None
        if how in ("inner", "left", "left_semi", "left_anti"):
            with self.span(join_t):
                table = self._dense_table_for(build, build_keys)
            if table is not None and table.max_dup <= 1:
                for probe in probe_iter:
                    self._acquire()
                    with self.span(join_t):
                        out = self._probe_masked(probe, build, table)
                    yield out
                return
        # right and full joins track a build-wide matched mask, which
        # bucket-local indices would break: they stay single-pass
        k = self._sub_parts(int(build.num_rows)) \
            if how in ("inner", "left", "left_semi", "left_anti") else 1
        with self.span(join_t):
            build_parts = self._split_build(build, k) if k > 1 else None
        for probe in probe_iter:
            self._acquire()
            if build_parts is not None:
                with self.span(join_t):
                    probe_parts = self._bucket_split(
                        probe, self._hash_keys(0), k)
                for pp, (bpc, bkeys) in zip(probe_parts, build_parts):
                    with self.span(join_t):
                        _, out = self._probe_one(K.compact_batch(pp), bpc,
                                                 bkeys, None)
                    yield out
                continue
            with self.span(join_t):
                matched_build, out = self._probe_one(probe, build,
                                                     build_keys,
                                                     matched_build)
            yield out
        if track_build_matches:
            with self.span(join_t):
                un_idx, n_un = J.unmatched_indices(matched_build,
                                                   build.live_mask())
                out = None
                if n_un:
                    dummy = _empty_batch(self.plan.children[0].schema,
                                         self.device, 8)
                    out = _pair_batch(dummy, build,
                                      torch.full_like(un_idx, -1), un_idx,
                                      n_un)
            if out is not None:
                yield out

    def _probe_masked(self, probe, build, table) -> ColumnarBatch:
        """The unique-key join without pairs, one dispatch a probe batch
        (the JAX package's ``dense_probe_masked`` family): a batch sharing
        the probe's planes, the build columns gathered at the probe rows,
        and a live mask (inner, semi, anti) or null-extended build columns
        (left). A join condition narrows the match, which is exact since
        each probe row has at most one candidate."""
        plan = self.plan
        # build key columns equal to the probe's keys are not gathered
        key_map = {}
        for ki, rk in enumerate(plan.right_keys):
            if isinstance(rk, BoundRef) and rk.index < len(build.columns):
                c = build.columns[rk.index]
                if plan.left_keys[ki].data_type() == c.dtype \
                        and not c.is_string:
                    key_map[rk.index] = ki
        cond = plan.condition
        key = ("dense_probe_masked", plan.how,
               tuple(e.fingerprint() for e in plan.left_keys),
               tuple(e.fingerprint() for e in plan.right_keys),
               cond.fingerprint() if cond is not None else None,
               tuple(sorted(key_map.items())))
        fn = fuse.fused(key, lambda: _dense_probe_masked(
            plan.how, list(plan.left_keys), cond, key_map, self.device,
            bool(self.conf.get(C.ANSI_ENABLED))))
        return fn(probe, build, table.slot_idx, table.bmin)

    def _probe_one(self, probe, build, build_keys, matched_build):
        how = self.plan.how
        probe_keys = self._eval(self.plan.left_keys, probe)
        live = probe.live_mask() if probe.row_mask is not None else None
        pi, bi, nmatch = J.join_pairs(build_keys, build.num_rows, probe_keys,
                                      probe.num_rows, probe_live=live)
        pi, bi, nmatch = self._apply_condition(probe, build, pi, bi, nmatch)
        if how in ("left_semi", "left_anti"):
            mask = J.probe_matched_mask(pi, probe.capacity)
            return matched_build, K.mask_filter_batch(
                probe, ~mask if how == "left_anti" else mask)
        if how in ("left", "full"):
            mask = J.probe_matched_mask(pi, probe.capacity)
            un_idx, n_un = J.unmatched_indices(mask, probe.live_mask())
            if n_un:
                tot = nmatch + n_un
                cap = round_capacity(max(tot, 1))
                pi = _concat_idx(pi, nmatch, un_idx, n_un, cap)
                bi = _concat_idx(bi, nmatch, torch.full_like(un_idx, -1),
                                 n_un, cap)
                nmatch = tot
        if matched_build is not None:
            matched_build = matched_build | J.probe_matched_mask(
                bi, build.capacity)
        return matched_build, _pair_batch(probe, build, pi, bi, nmatch)

    def _apply_condition(self, probe, build, pi, bi, nmatch):
        if self.plan.condition is None or nmatch == 0:
            return pi, bi, nmatch
        pairs = _pair_batch(probe, build, pi, bi, nmatch)
        [pred] = self._eval([self.plan.condition], pairs)
        keep = pred.data.to(torch.bool) & pred.validity_or_default(nmatch)
        keep = keep & (torch.arange(pi.shape[0], device=self.device) < nmatch)
        idx, cnt = K.filter_indices(keep, pi.shape[0])
        sel = idx.clamp(0, pi.shape[0] - 1)
        return (torch.where(idx >= 0, pi[sel], -1),
                torch.where(idx >= 0, bi[sel], -1), cnt)


class BroadcastHashJoinExec(_HashJoinBase):
    """The build side (the right child) materialized once and shared by
    every probe partition. Right and full joins are planned over a
    collected probe side, so they see one probe partition. A build side
    that reads one cached relation through filters, projections and
    limits is kept on that relation (``_bcast_reuse``) and in the
    digest-keyed cross-query cache (``exec/adaptive.py``), and reused by
    later queries while the relation's materialization stays the same;
    each reuse by another plan records a ``build_reuse`` decision."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        self._build_lock = threading.Lock()
        self._build: Optional[ColumnarBatch] = None
        self._build_keys = None
        self._cache_build_split = True

    def _reuse_anchor(self):
        """(cached relation, structural key) of a build side that reads
        exactly one cached relation through filters, projections and
        limits only, else (None, None)."""
        rels = []

        def walk(n):
            if isinstance(n, P.CachedRelation):
                rels.append(n)
                return "cached"
            parts = tuple(walk(c) for c in n.children)
            if isinstance(n, P.Filter):
                return ("filter", n.condition.fingerprint(), parts)
            if isinstance(n, P.Project):
                return ("project", tuple(e.fingerprint() for e in n.exprs),
                        parts)
            if isinstance(n, P.Limit):
                return ("limit", n.n, parts)
            rels.append(None)  # any other node: no reuse
            return ("other",)

        fp = walk(self.plan.children[1])
        if len(rels) != 1 or rels[0] is None:
            return None, None
        return rels[0], (fp, tuple(e.fingerprint()
                                   for e in self.plan.right_keys))

    def _reuse_build(self, entry) -> ColumnarBatch:
        self.plan._bcast_entry = entry
        self._build, self._build_keys = entry["build"], entry["keys"]
        return self._build

    def _build_side(self) -> ColumnarBatch:
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        with _materializing(self._build_lock):
            if self._build is not None:
                return self._build
            anchor, skey = self._reuse_anchor()
            entry = getattr(self.plan, "_bcast_entry", None)
            if anchor is not None and entry is not None \
                    and entry["mat"] is not None \
                    and entry["mat"] is anchor.materialized:
                # this plan ran before: its own build, no decision
                return self._reuse_build(entry)
            entry = None
            if anchor is not None:
                store = getattr(anchor, "_bcast_reuse", None) or {}
                entry = store.get(skey)
                if entry is not None \
                        and entry["mat"] is not anchor.materialized:
                    del store[skey]  # a re-cache: stop pinning old batches
                    entry = None
                source = "anchor"
                if entry is None:
                    # the second chance: the digest-keyed cross-query
                    # cache, for another plan tree reading the same cached
                    # relation through the same build shape; a hit
                    # re-warms the relation's store
                    entry = AQ.build_cache_get(
                        self.conf, self.plan.children[1], skey, anchor)
                    source = "digest"
                    if entry is not None:
                        if len(store) >= 8:
                            store.pop(next(iter(store)))
                        store[skey] = entry
                        anchor._bcast_reuse = store
                if entry is not None:
                    if AQ.enabled(self.conf):
                        AQ.record(AQ.BUILD_REUSE, source=source,
                                  dispatches_saved=int(
                                      entry.get("build_batches", 0)) or 1)
                    return self._reuse_build(entry)
            batches = [b for part in _partitions(self.children[1])
                       for b in part]
            build = K.compact_batch(K.concat_batches(batches)) \
                if batches else _empty_batch(self.plan.children[1].schema,
                                             self.device)
            entry = {"build": build,
                     "keys": self._eval(self.plan.right_keys, build),
                     "dense": {}, "mat": None, "build_batches": len(batches)}
            if anchor is not None and anchor.materialized is not None:
                entry["mat"] = anchor.materialized
                store = getattr(anchor, "_bcast_reuse", None)
                if store is None:
                    store = anchor._bcast_reuse = {}
                if len(store) >= 8:
                    store.pop(next(iter(store)))
                store[skey] = entry
                AQ.build_cache_put(self.conf, self.plan.children[1], skey,
                                   anchor, entry)
            return self._reuse_build(entry)

    def execute_partition(self, pidx):
        with self.span(self.metrics.metric(M.BUILD_TIME)):
            build = self._build_side()
        yield from self._probe_stream(
            self.children[0].execute_partition(pidx), build,
            self._build_keys, self.plan.how in ("right", "full"))


class ShuffledHashJoinExec(_HashJoinBase):
    """Both sides hash-exchanged on the join keys; each partition builds
    from its slice of the right side and probes with its slice of the
    left. Right and full joins work per partition: equal keys co-locate."""

    def execute_partition(self, pidx):
        with self.span(self.metrics.metric(M.BUILD_TIME)):
            batches = list(self.children[1].execute_partition(pidx))
            build = K.compact_batch(K.concat_batches(batches)) if batches \
                else _empty_batch(self.plan.children[1].schema, self.device)
            build_keys = self._eval(self.plan.right_keys, build)
        yield from self._probe_stream(
            self.children[0].execute_partition(pidx), build, build_keys,
            self.plan.how in ("right", "full"))


class AdaptiveJoinExec(TorchExec):
    """The join strategy picked at run time where the planner cannot
    estimate the build side: the build side streams until its rows pass
    spark.rapids.sql.join.broadcastRowThreshold. Under it the streamed
    batches feed a broadcast hash join; over it they are dropped and both
    sides hash-exchange, the build side running again through its
    exchange (holding the whole of a side too big to broadcast would cost
    more device memory than running it twice)."""

    def __init__(self, plan, children, conf, device, part_keys):
        super().__init__(plan, children, conf, device)
        self.part_keys = part_keys
        self._lock = threading.Lock()
        self._chosen: Optional[TorchExec] = None

    def _choose(self) -> TorchExec:
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        with _materializing(self._lock):
            if self._chosen is not None:
                return self._chosen
            left, right = self.children
            threshold = self.conf.get(C.BROADCAST_JOIN_ROW_THRESHOLD)
            batches, rows, overflow = [], 0, False
            for p in range(right.num_partitions):
                with TaskContext(partition_id=p):
                    for b in right.execute_partition(p):
                        batches.append(b)
                        rows += int(b.num_rows)
                        if rows > threshold:
                            overflow = True
                            break
                if overflow:
                    break
            if not overflow:
                src = _MaterializedExec(self.plan.children[1], batches,
                                        self.conf, self.device)
                self._chosen = BroadcastHashJoinExec(
                    self.plan, [left, src], self.conf, self.device)
                AQ.record(AQ.BROADCAST_CONVERSION, source="row_probe",
                          build_rows=rows, threshold_rows=threshold,
                          # both sides' exchanges never run
                          dispatches_saved=2 * max(len(batches), 1))
            else:
                del batches
                lkeys, rkeys = self.part_keys
                n_out = left.num_partitions
                lex = ShuffleExchangeExec(self.plan, [left], self.conf,
                                          self.device, lkeys, n_out)
                rex = ShuffleExchangeExec(self.plan, [right], self.conf,
                                          self.device, rkeys, n_out)
                self._chosen = ShuffledHashJoinExec(
                    self.plan, [lex, rex], self.conf, self.device,
                    part_keys=self.part_keys)
            return self._chosen

    def execute_partition(self, pidx):
        yield from self._choose().execute_partition(pidx)


class _MaterializedExec(TorchExec):
    """Batches already on the device, as one partition (the adaptive
    joins' materialized build side)."""

    def __init__(self, plan, batches, conf, device):
        super().__init__(plan, [], conf, device)
        self._batches = list(batches)

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, pidx):
        yield from self._batches


# ---------------------------------------------------------------------------
# Nested-loop and cartesian joins
# ---------------------------------------------------------------------------

class _WholeBuildJoin(TorchExec):
    """A join whose build side (the right child) is every partition of it
    concatenated and compacted, once, under a lock, and shared by every
    probe partition."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        self._build_lock = threading.Lock()
        self._build: Optional[ColumnarBatch] = None

    def _build_side(self) -> ColumnarBatch:
        with _materializing(self._build_lock):
            if self._build is None:
                batches = [b for part in _partitions(self.children[1])
                           for b in part]
                self._build = K.compact_batch(K.concat_batches(batches)) \
                    if batches else _empty_batch(self.plan.children[1].schema,
                                                 self.device)
        return self._build


def _masked(cols, live) -> ColumnarBatch:
    return ColumnarBatch(cols, LazyRowCount(live.sum(dtype=torch.int32)), live)


class BroadcastNestedLoopJoinExec(_WholeBuildJoin):
    """Non-equi joins: each left batch meets the build side one tile of
    build rows at a time, ``tile_rows = max(1, min(build capacity,
    MAX_PAIRS // left capacity))``. The condition runs over the tile's
    pair batch, which inner and outer joins emit as a masked batch; the
    matched flags of both sides accumulate, and then left and full joins
    emit the unmatched left rows with null right columns, semi and anti
    joins the left rows by their flag, and right and full joins, after
    the last left batch, the unmatched build rows (the planner gives them
    a single left partition). With one build row per tile the left
    columns are the pair batch's as they are, without a gather."""

    MAX_PAIRS = 1 << 20

    def execute_partition(self, pidx):
        join_t = self.metrics.metric(M.JOIN_TIME)
        how = self.plan.how
        with self.span(self.metrics.metric(M.BUILD_TIME)):
            build = self._build_side()
        n_build = int(build.num_rows)
        bcap = max(build.capacity, 1)
        bmatched = torch.zeros(bcap, dtype=torch.bool, device=self.device)
        for left in self.children[0].execute_partition(pidx):
            self._acquire()
            lcap = max(left.capacity, 1)
            tile = max(1, min(bcap, self.MAX_PAIRS // lcap))
            llive = left.live_mask()
            lmatched = torch.zeros(lcap, dtype=torch.bool, device=self.device)
            for t0 in range(0, n_build, tile):
                with self.span(join_t):
                    cols, match = self._tile(left, llive, build, n_build,
                                             t0, tile)
                    # pair p is (left row p // tile, build row
                    # t0 + p % tile)
                    grid = match.view(lcap, tile)
                    lmatched |= grid.any(1)
                    end = min(t0 + tile, bcap)
                    bmatched[t0:end] |= grid.any(0)[:end - t0]
                if how in ("inner", "left", "right", "full"):
                    yield _masked(cols, match)
            if how in ("left", "full"):
                nulls = [_null_column(f.dtype, lcap, self.device)
                         for f in self.plan.children[1].schema.fields]
                yield _masked(list(left.columns) + nulls, llive & ~lmatched)
            elif how == "left_semi":
                yield _masked(list(left.columns), llive & lmatched)
            elif how == "left_anti":
                yield _masked(list(left.columns), llive & ~lmatched)
        if how in ("right", "full") and n_build > 0:
            nulls = [_null_column(f.dtype, bcap, self.device)
                     for f in self.plan.children[0].schema.fields]
            yield _masked(nulls + list(build.columns),
                          build.live_mask() & ~bmatched)

    def _tile(self, left, llive, build, n_build: int, t0: int, tile: int):
        """The pair batch of a left batch and build rows [t0, t0 + tile),
        and the pairs the condition keeps."""
        lcap = left.capacity
        if tile == 1:
            lcols = list(left.columns)
            live_pair = llive
            bidx = torch.full((lcap,), t0, dtype=torch.int64,
                              device=self.device)
        else:
            p = torch.arange(lcap * tile, dtype=torch.int64,
                             device=self.device)
            lidx = p // tile
            lcols = [K.gather_column(c, lidx, left.num_rows, src_live=llive)
                     for c in left.columns]
            bidx = t0 + p % tile
            live_pair = llive[lidx] & (bidx < n_build)
        bsafe = bidx.clamp(max=build.capacity - 1)
        cols = lcols + [K.gather_column(c, bsafe, build.num_rows)
                        for c in build.columns]
        cond = self.plan.condition
        if cond is None:
            return cols, live_pair
        ctx = EvalCtx(cols, LazyRowCount(live_pair.sum(dtype=torch.int32)),
                      live_pair.shape[0], self.device,
                      self.conf.get(C.ANSI_ENABLED), live=live_pair)
        pred = cond.eval(ctx)
        raise_errors(ctx.errors)
        match = live_pair & pred.data.to(torch.bool)
        if pred.validity is not None:
            match = match & pred.validity
        return cols, match


class CartesianProductExec(_WholeBuildJoin):
    """Cross joins: per left batch (compacted), the pairs r // nb and
    r % nb over round_capacity(n) rows (``_pair_batch``), with the
    optional condition as a filter on the selection mask."""

    def execute_partition(self, pidx):
        join_t = self.metrics.metric(M.JOIN_TIME)
        with self.span(self.metrics.metric(M.BUILD_TIME)):
            build = self._build_side()
        nb = int(build.num_rows)
        for probe in self.children[0].execute_partition(pidx):
            self._acquire()
            with self.span(join_t):
                out = self._cross(probe, build, nb)
            if out is not None:
                yield out

    def _cross(self, probe, build, nb: int):
        if probe.row_mask is not None:
            probe = K.compact_batch(probe)
        n = int(probe.num_rows) * nb
        if n == 0:
            return None
        r = torch.arange(round_capacity(n), dtype=torch.int64,
                         device=self.device)
        out = _pair_batch(probe, build, torch.where(r < n, r // nb, -1),
                          torch.where(r < n, r % nb, -1), n)
        if self.plan.condition is not None:
            ctx = self._ctx(out)
            pred = self.plan.condition.eval(ctx)
            raise_errors(ctx.errors)
            out = K.mask_filter_batch(
                out, pred.data.to(torch.bool)
                & pred.validity_or_default(n))
        return out


# ---------------------------------------------------------------------------
# CPU fallback
# ---------------------------------------------------------------------------

def host_table(batch: ColumnarBatch, names) -> "pa.Table":
    """A device batch's live rows as a host table; a large sparse batch
    is compacted on the device first (a bucket-route output can be a
    few-percent occupied 2^18-slot batch)."""
    if batch.row_mask is not None and batch.capacity > 16384:
        batch = K.compact_batch(batch)
    return to_arrow(batch, names)


def empty_table(schema: T.Schema) -> "pa.Table":
    import pyarrow as pa
    fields = [pa.field(f.name, T.to_arrow(f.dtype)) for f in schema.fields]
    return pa.Table.from_arrays([pa.array([], f.type) for f in fields],
                                schema=pa.schema(fields))


class CpuFallbackExec(TorchExec):
    """One plan node that planning tagged off the device, run by the CPU
    backend (the JAX package's ``CpuFallbackExec``). Three steps, each
    timed: ``download_ms`` brings the children's partitions to host
    tables (an adjacent fallback hands over its host result without a
    round trip through the card), ``cpu_ms`` converts them, runs
    ``cpu_backend.apply_node`` and converts the result back, and
    ``upload_ms`` puts the result as one partition on the session's
    device. The device operators below and above stay on the device; a
    filter below stays a device filter. ``transfers`` holds the three
    times, counts the rows in and out and names the device the output
    landed on. Its ``metrics`` stay empty, as the JAX package's do."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        self.transfers = {"download_ms": 0.0, "cpu_ms": 0.0,
                          "upload_ms": 0.0, "rows_in": 0, "rows_out": 0,
                          "output_device": None}

    @property
    def num_partitions(self):
        return 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _download(self, child: TorchExec):
        """The child's rows as one host table."""
        import pyarrow as pa
        names = child.plan.schema.names
        tables = []
        for p in range(child.num_partitions):
            with TaskContext(partition_id=p):
                for batch in child.execute_partition(p):
                    self._sync()  # the child's device work is no download
                    t0 = time.perf_counter()
                    tables.append(host_table(batch, names))
                    self.transfers["download_ms"] += \
                        (time.perf_counter() - t0) * 1e3
        table = pa.concat_tables(tables) if tables \
            else empty_table(child.plan.schema)
        self.transfers["rows_in"] += table.num_rows
        return table

    def cpu_result(self):
        child_cols = []
        for c in self.children:
            if isinstance(c, CpuFallbackExec):
                child_cols.append(c.cpu_result())
                continue
            table = self._download(c)
            t0 = time.perf_counter()
            child_cols.append(CPU.table_to_cols(table))
            self.transfers["cpu_ms"] += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = CPU.apply_node(self.plan, child_cols,
                             self.conf.get(C.ANSI_ENABLED))
        self.transfers["cpu_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def execute_partition(self, pidx):
        cols = self.cpu_result()
        t0 = time.perf_counter()
        table = CPU.cols_to_table(cols, self.plan.schema.names)
        self.transfers["cpu_ms"] += (time.perf_counter() - t0) * 1e3
        self._acquire()
        t0 = time.perf_counter()
        batch = from_arrow(table, self.device)
        self._sync()
        self.transfers["upload_ms"] += (time.perf_counter() - t0) * 1e3
        self.transfers["rows_out"] += table.num_rows
        self.transfers["output_device"] = str(
            batch.columns[0].device if batch.columns else self.device)
        yield batch
