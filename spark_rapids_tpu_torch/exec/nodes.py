"""Physical operators: per-partition iterators of device batches.

Counterpart of ``spark_rapids_tpu/exec/tpu_nodes.py`` for this engine's
operators: ``InMemoryScanExec``, the Parquet scans (``ParquetScanExec``,
which decodes on the host, and the device-decode pair
``EncodedParquetSourceExec`` + ``DeviceDecodeScanExec``),
``CachedScanExec``, ``ProjectExec``,
``FilterExec``, ``CoalesceBatchesExec``, ``CollectExchangeExec``,
``ShuffleExchangeExec`` (compact in-process mode) and ``HashAggregateExec``
with ``_AggKernels``.

PyTorch runs eagerly, so each operator is plain tensor code per batch; the
JAX package's stage fusion and compile caches have no counterpart here.

The hash aggregate picks a route per batch, in the JAX package's order:

1. tiny-bucket: dict-string keys whose vocabulary holds each string
   once, and bool keys, with at most 4096 key combinations
   (``ops/groupby.bucket_agg``);
2. packed radix: integer, date, bool and such dict keys packed into one
   int64 plane (``ops/radix``). With 11-24 packed bits and 1-2 float sums
   plus counts it takes the segsum kernel (``ops/segsum``), per
   CHUNK_ROWS slice for large batches; otherwise, or when a group
   outgrows the kernel's exact range or a NaN/Inf appears, the
   scatter-bucket reductions. Packed keys wider than 23 bits (the JAX
   package's packed sort route) are not ported yet and raise;
3. the sort route for every other key (flat strings, dictionaries that
   may repeat a string, floats): stable sorts on 64-bit keys, then
   segmented reductions (``ops/groupby.group_segments``). Partial states
   merge by the packed route when their keys pack, else by this one.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, LazyRowCount, column_from_arrow, from_arrow,
    round_capacity,
)
from spark_rapids_tpu_torch.expr.core import (
    Alias, BoundRef, EvalCtx, Expression, raise_errors,
)
from spark_rapids_tpu_torch.io import encoded as ENC
from spark_rapids_tpu_torch.io.parquet_pruning import prune_row_groups
from spark_rapids_tpu_torch.ops import decode as D
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import radix as R
from spark_rapids_tpu_torch.ops import repartition as RP
from spark_rapids_tpu_torch.ops import segsum as S


class TorchExec:
    def __init__(self, plan, children: List["TorchExec"], conf, device):
        self.plan = plan
        self.children = children
        self.conf = conf
        self.device = torch.device(device)

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def execute_partition(self, pidx: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def walk(self) -> Iterator["TorchExec"]:
        """This operator and every operator below it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def _ctx(self, batch: ColumnarBatch, live=None) -> EvalCtx:
        return EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                       self.device, self.conf.get(C.ANSI_ENABLED),
                       live=batch.live_mask() if live is None else live)


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
        off = 0
        while off < n or (n == 0 and off == 0):
            take = min(max_rows, n - off)
            yield from_arrow(table.slice(start + off, take), self.device)
            off += max(take, 1)


# ---------------------------------------------------------------------------
# Parquet scans
# ---------------------------------------------------------------------------

def _prefetched(items, load_fn, n_threads: int):
    """load_fn(item) for each item, in order, with at most n_threads
    loads running ahead of the consumer, so host decode overlaps the
    upload and the device work without buffering a whole file."""
    if n_threads <= 1 or len(items) <= 1:
        for it in items:
            yield load_fn(it)
        return
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        pending = [pool.submit(load_fn, it) for it in items[:n_threads]]
        nxt = len(pending)
        while pending:
            fut = pending.pop(0)
            if nxt < len(items):
                pending.append(pool.submit(load_fn, items[nxt]))
                nxt += 1
            yield fut.result()


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
    """One partition per file; row groups are pruned by the pushed
    filters against the footer statistics. ``metrics`` holds plain
    counters (the JAX package's metric names) for tests and the smoke."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        # a snapshot: a later pushdown over a plan sharing this scan must
        # not change the filters under a converted exec
        self._pushed = list(plan.pushed_filters)
        self._metrics_lock = threading.Lock()  # prefetch workers add too
        self.metrics: Dict[str, float] = {
            "numRowGroups": 0, "numRowGroupsPruned": 0, "readBytes": 0,
            "decodeTime": 0.0, "numOutputRows": 0, "numOutputBatches": 0}

    @property
    def num_partitions(self):
        return max(1, len(self.plan.paths))

    def _groups(self, metadata):
        groups, total = prune_row_groups(metadata, self._pushed)
        self.metrics["numRowGroups"] += total
        self.metrics["numRowGroupsPruned"] += total - len(groups)
        for g in groups:
            self.metrics["readBytes"] += metadata.row_group(g).total_byte_size
        return groups, total

    def _emitted(self, rows: int) -> None:
        self.metrics["numOutputRows"] += rows
        self.metrics["numOutputBatches"] += 1


class ParquetScanExec(_ParquetExec):
    """The host-decode scan: pyarrow reads and decodes each kept row
    group, then one upload per batch. Reader strategies
    (spark.rapids.sql.format.parquet.reader.type): PERFILE loads row
    groups one by one; MULTITHREADED prefetches them on a bounded pool;
    COALESCING and AUTO also concatenate them on the host up to the
    reader batch size."""

    def execute_partition(self, pidx):
        import pyarrow.parquet as pq
        path = self.plan.paths[pidx]
        names = self.plan.schema.names
        mode = str(self.conf.get(C.MULTIFILE_READER_TYPE)).upper()
        threads = 1 if mode == "PERFILE" \
            else int(self.conf.get(C.MULTIFILE_READER_THREADS))
        groups, total = self._groups(pq.ParquetFile(path).metadata)
        if not groups:
            if total:
                return  # every row group refuted
            groups = [-1]  # a file without row groups: read it whole

        def load(g):
            # one ParquetFile per load: parquet-cpp readers are not
            # thread-safe, and loads run on the prefetch workers
            t0 = time.perf_counter()
            f = pq.ParquetFile(path)
            tbl = f.read(columns=names) if g < 0 \
                else f.read_row_group(g, columns=names)
            with self._metrics_lock:
                self.metrics["decodeTime"] += time.perf_counter() - t0
            return tbl

        batch_rows = self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS)
        tables = _prefetched(groups, load, threads)
        if mode in ("COALESCING", "AUTO"):
            tables = _host_coalesced(tables, batch_rows)
        for tbl in tables:
            off = 0
            while off < tbl.num_rows or (tbl.num_rows == 0 and off == 0):
                chunk = tbl.slice(off, batch_rows)
                self._emitted(chunk.num_rows)
                yield from_arrow(chunk, self.device)
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
        self.metrics.update({"encodedBytes": 0, "decodedBytes": 0,
                             "numDecodeFallbackColumns": 0,
                             "copyToDeviceTime": 0.0})
        self.fallback_columns: Dict[str, str] = ENC.probe_support(
            plan.paths[0], plan.schema.fields)

    def execute_partition(self, pidx):
        import pyarrow as pa
        import pyarrow.parquet as pq
        path = self.plan.paths[pidx]
        fields = list(self.plan.schema.fields)
        pf = pq.ParquetFile(path)
        groups, total = self._groups(pf.metadata)
        if not groups:
            if total:
                return  # every row group refuted: nothing read or uploaded
            # a file without row groups: host read, every column decoded
            b = from_arrow(pf.read(columns=[f.name for f in fields]),
                           self.device)
            self._emitted(int(b.num_rows))
            yield ENC.EncodedBatch(
                [ENC.EncodedColumn("decoded", c.dtype, {}, cv=c,
                                   bounds=c.bounds) for c in b.columns],
                int(b.num_rows), b.capacity)
            return
        m = self.metrics
        hbs = ENC.read_encoded_batches(
            path, pf.metadata, groups, fields,
            self.conf.get(C.MAX_READER_BATCH_SIZE_ROWS),
            min(32, int(self.conf.get(C.DEVICE_DECODE_MAX_BITS))),
            bool(self.conf.get(C.DEVICE_DECODE_DELTA)))
        while True:
            t0 = time.perf_counter()
            hb = next(hbs, None)
            m["decodeTime"] += time.perf_counter() - t0
            if hb is None:
                return
            self.fallback_columns.update(hb.fallback)
            fb_idx = [i for i, c in enumerate(hb.columns) if c is None]
            tbl = None
            if fb_idx:
                m["numDecodeFallbackColumns"] += len(fb_idx)
                t0 = time.perf_counter()
                parts = [pf.read_row_group(g, columns=[fields[i].name
                                                       for i in fb_idx])
                         for g in hb.groups]
                tbl = (pa.concat_tables(parts) if len(parts) > 1
                       else parts[0]).combine_chunks()
                m["decodeTime"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            decoded = {}
            for j, i in enumerate(fb_idx):
                arr = tbl.column(j)
                arr = arr.chunk(0) if arr.num_chunks else arr.combine_chunks()
                decoded[i] = column_from_arrow(arr, fields[i].dtype, hb.cap,
                                               self.device)
            eb = ENC.upload(hb, decoded, self.device)
            m["copyToDeviceTime"] += time.perf_counter() - t0
            m["encodedBytes"] += hb.encoded_bytes
            m["decodedBytes"] += eb.decoded_size()
            self._emitted(hb.num_rows)
            yield eb


class DeviceDecodeScanExec(TorchExec):
    """Expands the child's EncodedBatches into ColumnarBatches on the
    device (ops/decode.py, with the bitslice kernel), one batch at a
    time. The row count stays the host int the source knew, so no
    device read is needed for it."""

    def __init__(self, plan, children, conf, device):
        super().__init__(plan, children, conf, device)
        self.metrics: Dict[str, float] = {"opTime": 0.0,
                                          "numOutputBatches": 0}

    def execute_partition(self, pidx):
        for eb in self.children[0].execute_partition(pidx):
            t0 = time.perf_counter()
            out = D.decode_batch(eb)
            self.metrics["opTime"] += time.perf_counter() - t0
            self.metrics["numOutputBatches"] += 1
            yield out


class CachedScanExec(TorchExec):
    """Materializes the child once into device-resident batches (one per
    partition) stored on the CachedRelation node; later scans stream
    straight from device memory."""

    _lock = threading.Lock()

    @property
    def num_partitions(self):
        if self.plan.materialized is not None:
            return len(self.plan.materialized)
        return self.children[0].num_partitions

    def _materialize(self):
        with CachedScanExec._lock:
            if self.plan.materialized is None:
                child = self.children[0]
                out = []
                for p in range(child.num_partitions):
                    batches = list(child.execute_partition(p))
                    if batches:
                        merged = K.compact_batch(K.concat_batches(batches))
                        _attach_column_stats(merged)
                        batches = [merged]
                    out.append(batches)
                self.plan.materialized = out
        return self.plan.materialized

    def execute_partition(self, pidx):
        yield from self._materialize()[pidx]


_STAT_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type, T.DateType)


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

    def execute_partition(self, pidx):
        trivial = self._trivial_indices()
        for batch in self.children[0].execute_partition(pidx):
            if trivial is not None:
                yield ColumnarBatch([batch.columns[i] for i in trivial],
                                    batch.num_rows, batch.row_mask)
                continue
            ctx = self._ctx(batch)
            cols = [e.eval(ctx) for e in self.plan.exprs]
            raise_errors(ctx.errors)
            for e, o in zip(self.plan.exprs, cols):
                inner = e.children[0] if isinstance(e, Alias) else e
                if isinstance(inner, BoundRef):
                    o.bounds = batch.columns[inner.index].bounds
            yield ColumnarBatch(cols, batch.num_rows, batch.row_mask)


class FilterExec(TorchExec):
    """Marks failing rows dead in the selection mask; no gather, no sync."""

    def execute_partition(self, pidx):
        for batch in self.children[0].execute_partition(pidx):
            ctx = self._ctx(batch)
            pred = self.plan.condition.eval(ctx)
            raise_errors(ctx.errors)
            valid = pred.validity if pred.validity is not None \
                else ctx.row_mask
            yield K.mask_filter_batch(batch, pred.data.to(torch.bool) & valid)


class CoalesceBatchesExec(TorchExec):
    """Concatenates batches up to spark.rapids.sql.batchSizeBytes."""

    def execute_partition(self, pidx):
        target = self.conf.get(C.TARGET_BATCH_SIZE)
        pending: List[ColumnarBatch] = []
        pending_bytes = 0
        for batch in self.children[0].execute_partition(pidx):
            pending.append(batch)
            pending_bytes += batch.device_memory_size()
            if pending_bytes >= target:
                yield K.concat_batches(pending)
                pending, pending_bytes = [], 0
        if pending:
            yield K.concat_batches(pending)


class CollectExchangeExec(TorchExec):
    """N -> 1 exchange: every child partition's batches, in order."""

    @property
    def num_partitions(self):
        return 1

    def execute_partition(self, pidx):
        child = self.children[0]
        for p in range(child.num_partitions):
            yield from child.execute_partition(p)


class ShuffleExchangeExec(TorchExec):
    """Hash exchange in the compact in-process mode: per input batch,
    murmur3 of the keys (the murmur3 kernel), pmod n_out, one stable
    counting sort, one fetch of the offsets vector, then contiguous
    right-sized sub-batches per target partition."""

    def __init__(self, plan, children, conf, device,
                 keys: List[Expression], n_out: int):
        super().__init__(plan, children, conf, device)
        self.keys = keys
        self.n_out = n_out
        self._lock = threading.Lock()
        self._out: Optional[List[List[ColumnarBatch]]] = None

    @property
    def num_partitions(self):
        return self.n_out

    def _partition(self, batch: ColumnarBatch, out) -> None:
        live = batch.live_mask()
        ctx = self._ctx(batch, live)
        key_cols = [e.eval(ctx) for e in self.keys]
        h = K.partition_hash_batch(key_cols, batch.num_rows, live=live)
        pid = torch.remainder(h, self.n_out)
        sorted_b, off = RP.counting_sort_by_pid(batch, pid, self.n_out)
        offsets = off.cpu().numpy()  # the one sync per input batch
        for p, sub in enumerate(RP.compact_slices(sorted_b, offsets,
                                                  self.n_out)):
            if sub is None:
                continue
            for ic, oc in zip(batch.columns, sub.columns):
                oc.bounds = ic.bounds
            out[p].append(sub)

    def _materialize(self):
        with self._lock:
            if self._out is None:
                mode = str(self.conf.get(C.SHUFFLE_PARTITIONING)).lower()
                if mode != "compact":
                    raise NotImplementedError(
                        f"spark.rapids.shuffle.partitioning={mode!r}")
                child = self.children[0]
                out: List[List[ColumnarBatch]] = [[] for _ in
                                                  range(self.n_out)]
                for p in range(child.num_partitions):
                    for batch in child.execute_partition(p):
                        if self.n_out == 1:
                            out[0].append(batch)
                        else:
                            self._partition(batch, out)
                self._out = out
        return self._out

    def execute_partition(self, pidx):
        yield from self._materialize()[pidx]


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
            ranges = R.probe_ranges(key_cols, live)
            ranges_host = ranges.cpu().numpy()
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
    _SIMPLE_OPS = frozenset({"sum", "count", "count_all", "min", "max"})
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
                    T.DateType, T.BooleanType, T.StringType)):
                return False
        for a in self.aggs:
            for (_, sdt), (op, _) in zip(a.fn.state_schema(),
                                         a.fn.update_ops()):
                if op not in self._SIMPLE_OPS or isinstance(sdt,
                                                            T.StringType):
                    return False
        return True

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

    def _inputs(self, batch, live, ctx_of):
        """Evaluate the keys and every aggregate's inputs."""
        ctx = ctx_of(batch, live)
        key_cols = [e.eval(ctx) for e in self.group_exprs]
        input_cols = [[e.eval(ctx) for e in a.fn.children] for a in self.aggs]
        return key_cols, input_cols, ctx.errors

    def update(self, batch: ColumnarBatch, ctx_of):
        """The update phase: tiny-bucket, packed radix, or global.
        Returns (state batch, ANSI error planes)."""
        if self._packed_ok:
            key_cols = [e.eval(ctx_of(batch, batch.live_mask()))
                        for e in self.group_exprs]
            if self._bucket_sizes(key_cols) is None:
                spec, ranges, rh = _probe_pack_spec(
                    key_cols, batch.live_mask(), self.group_exprs)
                if spec is not None:
                    batch, live, errs = self._filtered(batch, ctx_of)
                    key_cols, input_cols, ierrs = self._inputs(batch, live,
                                                               ctx_of)
                    out = self._packed_agg(live, key_cols,
                                           self._update_specs(input_cols),
                                           spec, ranges)
                    _attach_key_bounds(out, spec, rh)
                    return out, errs + ierrs
        batch, live, errs = self._filtered(batch, ctx_of)
        key_cols, input_cols, ierrs = self._inputs(batch, live, ctx_of)
        if not key_cols:
            return self._global_update(batch, live, input_cols), errs + ierrs
        sizes = self._bucket_sizes(key_cols)
        if sizes is None:
            return self._sort_agg(live, key_cols,
                                  self._update_specs(input_cols),
                                  batch.num_rows), errs + ierrs
        return self._bucket_update(batch, live, key_cols, input_cols,
                                   sizes), errs + ierrs

    def _update_specs(self, input_cols):
        """(reduction, input column or None, state type) per state."""
        specs = []
        for ai, a in enumerate(self.aggs):
            for (_, sdt), (op, idx) in zip(a.fn.state_schema(),
                                           a.fn.update_ops()):
                specs.append((op, input_cols[ai][idx] if idx >= 0 else None,
                              sdt))
        return specs

    def merge(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Fold partial states that share keys."""
        nkeys = len(self.group_exprs)
        live = batch.live_mask()
        states = []
        ci = nkeys
        for a in self.aggs:
            for (_, sdt), op in zip(a.fn.state_schema(), a.fn.merge_ops()):
                states.append((op, batch.columns[ci], sdt))
                ci += 1
        if nkeys == 0:
            cols = []
            for op, src, sdt in states:
                valid = live if src.validity is None else (src.validity & live)
                ov, oval = G.global_agg(op, src.data, valid)
                cols.append(_resize_plane(ov, oval, sdt, round_capacity(1)))
            return ColumnarBatch(cols, 1)
        key_cols = list(batch.columns[:nkeys])
        spec = None
        if self._packed_ok:
            spec, ranges, rh = _probe_pack_spec(key_cols, live)
        if spec is None:
            return self._sort_agg(live, key_cols, states, batch.num_rows)
        out = self._packed_agg(live, key_cols, states, spec, ranges)
        _attach_key_bounds(out, spec, rh)
        return out

    # -- global (no keys) --------------------------------------------------

    def _global_update(self, batch, live, input_cols) -> ColumnarBatch:
        cap = batch.capacity
        out_cols = []
        for ai, a in enumerate(self.aggs):
            for (_, sdt), (op, idx) in zip(a.fn.state_schema(),
                                           a.fn.update_ops()):
                if idx >= 0:
                    src = input_cols[ai][idx]
                    if src.is_string:
                        if op not in ("count", "count_all"):
                            raise NotImplementedError(
                                "string aggregate state on the device")
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
            if src is None:
                vals, valid = _zeros(cap, sdt, live.device), live
            else:
                if src.is_string and op not in ("count", "count_all"):
                    raise NotImplementedError(
                        "string aggregate state on the device")
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

    def _bucket_update(self, batch, live, key_cols, input_cols, sizes):
        device = live.device
        B = int(np.prod(sizes))
        bucket = torch.zeros(batch.capacity, dtype=torch.int32, device=device)
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
        for ai, a in enumerate(self.aggs):
            for (_, sdt), (op, idx) in zip(a.fn.state_schema(),
                                           a.fn.update_ops()):
                if idx >= 0:
                    src = input_cols[ai][idx]
                    if src.is_string and op not in ("count", "count_all"):
                        raise NotImplementedError(
                            "string aggregate state on the device")
                    vals = _zeros(batch.capacity, sdt, device) \
                        if src.is_string else src.data.to(sdt.torch_dtype)
                    valid = live if src.validity is None \
                        else (src.validity & live)
                else:
                    vals, valid = _zeros(batch.capacity, sdt, device), live
                ov, oval = G.bucket_agg(op, vals, valid, bucket, B, matmul_ok)
                out_cols.append(ColumnVector(sdt, ov, oval))
        return ColumnarBatch(out_cols,
                             LazyRowCount(occupancy.sum(dtype=torch.int32)),
                             occupancy)

    # -- packed radix route ------------------------------------------------

    def _packed_agg(self, live, key_cols, state_specs, spec, ranges):
        if spec.total_bits > R.BUCKET_BITS:
            raise NotImplementedError(
                "the packed sort route (ops/radix.group_layout) for keys "
                f"wider than {R.BUCKET_BITS} bits is not ported yet")
        return self._bucket_scatter_agg(live, key_cols, state_specs, spec,
                                        ranges)

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
                    raise NotImplementedError(
                        "string aggregate state on the device")
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
        if op == "sum":
            if isinstance(sdt, (T.Float64Type, T.Float32Type)):
                return R.bucket_sum_f64(lay, vals, valid), some
            return R.bucket_sum_int(lay, vals, valid), some
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
    """Complete-mode hash aggregate: update each input batch, merge the
    partial states, evaluate. An upstream filter may be absorbed as
    ``pre_filter`` so it only narrows the live mask."""

    def __init__(self, plan, children, conf, device, pre_filter=None):
        super().__init__(plan, children, conf, device)
        self.kern = _AggKernels(plan.group_exprs, plan.aggs, pre_filter,
                                bool(conf.get(C.PALLAS_ENABLED)))

    def _state_fields(self):
        fields = [T.StructField(n, e.data_type()) for n, e in
                  zip(self.plan.group_names, self.plan.group_exprs)]
        for a in self.plan.aggs:
            for sname, sdt in a.fn.state_schema():
                fields.append(T.StructField(f"{a.name}__{sname}", sdt))
        return fields

    def execute_partition(self, pidx):
        nkeys = len(self.plan.group_exprs)
        partials = []
        for batch in self.children[0].execute_partition(pidx):
            out, errs = self.kern.update(batch, self._ctx)
            raise_errors(errs)
            partials.append(ColumnarBatch(out.columns, 1) if nkeys == 0
                            else out)
        if not partials:
            if nkeys:
                return
            partials = [self._empty_state_batch()]
        merged = partials[0]
        if len(partials) > 1:
            batch = K.concat_batches(partials)
            if nkeys or int(batch.num_rows) > 1:
                merged = self.kern.merge(batch)
            else:
                merged = batch
            if nkeys == 0:
                merged = ColumnarBatch(merged.columns, 1)
        yield self._evaluate(merged)

    def _evaluate(self, state: ColumnarBatch) -> ColumnarBatch:
        nkeys = len(self.plan.group_exprs)
        out_cols = list(state.columns[:nkeys])
        ci = nkeys
        for a in self.plan.aggs:
            n_state = len(a.fn.state_schema())
            res = a.fn.evaluate(state.columns[ci: ci + n_state])
            ci += n_state
            rt = a.fn.result_type()
            if res.data.dtype != rt.torch_dtype:
                res = ColumnVector(rt, res.data.to(rt.torch_dtype),
                                   res.validity)
            out_cols.append(res)
        return ColumnarBatch(out_cols, state.num_rows if nkeys else 1,
                             state.row_mask)

    def _empty_state_batch(self) -> ColumnarBatch:
        """A zero-row update: count states are 0 and valid, others null."""
        cap = round_capacity(1)
        first = torch.arange(cap, device=self.device) < 1
        cols = []
        for f in self._state_fields():
            is_count = f.name.endswith("__count")
            cols.append(ColumnVector(
                f.dtype, _zeros(cap, f.dtype, self.device),
                first if is_count else torch.zeros(cap, dtype=torch.bool,
                                                   device=self.device)))
        return ColumnarBatch(cols, 1)
