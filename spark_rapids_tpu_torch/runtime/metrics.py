"""Metrics framework (counterpart of ``spark_rapids_tpu/runtime/metrics.py``;
reference GpuExec.scala:33-284 GpuMetric and GpuTaskMetrics.scala).

Per-exec named metrics with levels (ESSENTIAL/MODERATE/DEBUG) in a
``MetricsRegistry`` each operator owns, plus the per-task accumulators
(semaphore wait, retry counts, spill bytes) that ``runtime/task.
TaskContext`` keeps. ``TorchSession.last_metrics()`` snapshots every
operator of the last action through ``walk_exec_tree``; the query trace
(``runtime/trace.py``) writes that snapshot beside its spans.

The names are the JAX package's but one: the scans' decode timer is
``gpuDecodeTime``, the reference's own GpuMetric name, where the JAX
package says ``tpuDecodeTime``.

Timers run on the host clock (``time.perf_counter_ns``). Around work
that launches CUDA kernels a timer measures what the host spent issuing
it (the enqueue, and any sync the work itself makes), not the card's
execution: no timer synchronizes the device.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

ESSENTIAL = 0
MODERATE = 1
DEBUG = 2

# Standard metric names (reference GpuExec companion object)
NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
NUM_INPUT_BATCHES = "numInputBatches"
NUM_ROW_GROUPS = "numRowGroups"
NUM_ROW_GROUPS_PRUNED = "numRowGroupsPruned"
READ_BYTES = "readBytes"
#: files of a Parquet scan, and those its hive partition values refuted
#: (the port's scans also count these)
NUM_FILES = "numFiles"
NUM_FILES_PRUNED = "numFilesPruned"
#: raw ENCODED Parquet bytes a device-decode scan uploaded — the bytes
#: that actually crossed the host->device link (compare decodedBytes:
#: the ratio is the link traffic the device decoder saved)
ENCODED_BYTES = "encodedBytes"
#: decoded plane bytes a device-decode scan produced on device — what
#: the host path would have uploaded instead
DECODED_BYTES = "decodedBytes"
#: columns a device-decode scan host-decoded instead (unsupported
#: type/encoding/codec; per-column reasons in ``fallback_columns``)
NUM_DECODE_FALLBACK_COLUMNS = "numDecodeFallbackColumns"
OP_TIME = "opTime"
SORT_TIME = "sortTime"
AGG_TIME = "aggTime"
JOIN_TIME = "joinTime"
CONCAT_TIME = "concatTime"
#: the JAX package's tpuDecodeTime, under the reference's GpuMetric name
DECODE_TIME = "gpuDecodeTime"
COPY_TO_DEVICE_TIME = "copyToDeviceTime"
COPY_FROM_DEVICE_TIME = "copyFromDeviceTime"
FILTER_TIME = "filterTime"
BUILD_TIME = "buildTime"
SEMAPHORE_WAIT_TIME = "semaphoreWaitTime"
SEMAPHORE_HOLD_TIME = "semaphoreHoldTime"
SPILL_TO_HOST_BYTES = "spillToHostBytes"
SPILL_TO_HOST_TIME = "spillToHostTime"
SPILL_TO_DISK_BYTES = "spillToDiskBytes"
SPILL_TO_DISK_TIME = "spillToDiskTime"
RETRY_COUNT = "retryCount"
SPLIT_RETRY_COUNT = "splitAndRetryCount"
#: ns of failed attempts that a retry replayed
RETRY_WASTED_TIME = "retryWastedTime"
#: ns spent draining the spill stores and backing off before a re-attempt
RETRY_BLOCK_TIME = "retryBlockTime"
#: high-water mark of registered device bytes while the task ran
MAX_DEVICE_BYTES_HELD = "maxDeviceBytesHeld"
#: serialized blobs re-fetched from the shuffle store after a failed check
SHUFFLE_CORRUPTION_RETRIES = "shuffleCorruptionRetries"
PARTITION_TIME = "partitionTime"
#: partitioning-kernel dispatches and host round trips per input batch of
#: an exchange, fused-stage entries (a fused stage's or an absorbing
#: aggregate's calls), SPMD waves and the in-program ICI exchange (no
#: mesh in the port yet); the JAX package's names, so both packages read
#: one roster
PARTITION_DISPATCHES = "partitionDispatches"
PARTITION_HOST_FETCHES = "partitionHostFetches"
STAGE_DISPATCHES = "stageDispatches"
SHARD_WAVES = "shardWaves"
ICI_EXCHANGE_TIME = "iciExchangeTime"
#: post-shuffle sub-batches merged by tiny-partition coalescing
#: (spark.rapids.shuffle.coalesceTinyRows): adjacent device sub-batches
#: under the threshold concat into one batch before downstream dispatch
SHUFFLE_COALESCED_BATCHES = "shuffleCoalescedBatches"
#: serialized-shuffle bytes an exchange wrote into its host store
#: (post-compression wire bytes; reference shuffle write metrics)
SHUFFLE_BYTES_WRITTEN = "shuffleBytesWritten"
#: serialized-shuffle bytes the host store overflowed to disk files
SHUFFLE_BYTES_SPILLED = "shuffleBytesSpilled"
#: a pipeline boundary's lookahead, the ns its consumer blocked waiting
#: for the producer, and the producer's own decode/upload time
#: (runtime/pipeline.PipelineExec)
PIPELINE_DEPTH = "pipelineDepth"
PIPELINE_STALL_TIME = "pipelineStallTime"
PIPELINE_PRODUCER_TIME = "pipelineProducerTime"

#: *Time metrics that record WAITING or overlapped work, not exclusive
#: operator work: folding them into an operator-time rollup would make
#: hot-path comparisons lie (wait is scheduling; producer time is the
#: upstream's own decode/upload time, already on the upstream's metrics)
WAIT_TIME_METRICS = frozenset((
    SEMAPHORE_WAIT_TIME, PIPELINE_STALL_TIME, PIPELINE_PRODUCER_TIME))

#: *Time metrics NESTED inside another *Time metric on the same exec
#: (iciExchangeTime runs inside partitionTime's span)
NESTED_TIME_METRICS = frozenset((ICI_EXCHANGE_TIME,))


class GpuMetric:
    __slots__ = ("name", "level", "_value", "_lock", "_deferred")

    def __init__(self, name: str, level: int = MODERATE):
        self.name = name
        self.level = level
        self._value = 0
        self._lock = threading.Lock()
        self._deferred = []

    def add(self, v) -> None:
        """Accepts ints or a LazyRowCount; a lazy count that has not been
        read yet is kept and resolved when the metric is read (metrics
        must never add device round trips to the hot path)."""
        from spark_rapids_tpu_torch.columnar.batch import LazyRowCount
        if isinstance(v, LazyRowCount) and v._val is None:
            with self._lock:
                self._deferred.append(v)
            return
        with self._lock:
            self._value += int(v)

    def set(self, v: int) -> None:
        with self._lock:
            self._value = int(v)
            self._deferred = []

    def set_max(self, v: int) -> None:
        """High-water-mark semantics (maxDeviceBytesHeld)."""
        with self._lock:
            if int(v) > self._value:
                self._value = int(v)

    @property
    def value(self) -> int:
        with self._lock:
            if self._deferred:
                pending = [v for v in self._deferred if v._val is None]
                if pending:  # ONE transfer, not one sync per count
                    import torch
                    vals = torch.stack([p._dev.reshape(()).to(torch.int64)
                                        for p in pending]).cpu().tolist()
                    for lz, val in zip(pending, vals):
                        lz._val = int(val)
                self._value += sum(int(v) for v in self._deferred)
                self._deferred = []
            return self._value

    def peek(self) -> int:
        """The value WITHOUT resolving deferred lazy device counts (no
        device sync, unlike .value): what a scrape of a running query
        reads."""
        with self._lock:
            v = self._value
            for d in self._deferred:
                if d._val is not None:
                    v += d._val
            return v

    def ns(self):
        """Context manager timing a block in nanoseconds."""
        return _Timer(self)


class _Timer:
    __slots__ = ("metric", "t0")

    def __init__(self, metric: GpuMetric):
        self.metric = metric

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter_ns() - self.t0)
        return False


class MetricsRegistry:
    """Per-exec metric set filtered by the configured level."""

    def __init__(self, level: int = MODERATE):
        self.level = level
        self.metrics: Dict[str, GpuMetric] = {}
        self._lock = threading.Lock()  # partitions run on several threads

    def metric(self, name: str, level: int = MODERATE) -> GpuMetric:
        m = self.metrics.get(name)
        if m is None:
            with self._lock:
                m = self.metrics.get(name)
                if m is None:
                    m = self.metrics[name] = GpuMetric(name, level)
        return m

    def __getitem__(self, name: str) -> int:
        """The value of one registered metric (KeyError when the exec
        never registered it)."""
        return self.metrics[name].value

    def snapshot(self) -> Dict[str, int]:
        return {k: m.value for k, m in list(self.metrics.items())
                if m.level <= self.level}

    def peek_snapshot(self) -> Dict[str, int]:
        """snapshot() without resolving lazy device counts (GpuMetric.
        peek)."""
        return {k: m.peek() for k, m in list(self.metrics.items())
                if m.level <= self.level}


def walk_exec_tree(root):
    """THE canonical exec-tree metric walk: each node, then its
    vertically fused members, then its absorbed pre-chain members, then
    its children — yielding ``(key, node, depth, role, stage_id)`` with
    keys ``ClsName#i`` in visit order. ``TorchSession.last_metrics()``
    derives from this one generator, and so do the dispatch budgets and
    ``stage_fusion.fusion_groups``. An adaptive node is followed into the
    operator it chose at run time (``_chosen``), as ``TorchExec.walk``
    does, and a node reached twice is yielded once. Duck-typed: no exec
    imports."""
    counter = [0]
    seen = set()

    def key_of(n):
        k = f"{type(n).__name__}#{counter[0]}"
        counter[0] += 1
        return k

    def walk(n, depth):
        if id(n) in seen:
            return
        seen.add(id(n))
        members = getattr(n, "members", None) or []
        pre = getattr(n, "pre_chain_members", None) or []
        sid = (getattr(n, "stage_id", None) if members
               else getattr(n, "fused_stage_id", None) if pre else None)
        yield key_of(n), n, depth, None, sid
        for m in members:
            yield key_of(m), m, depth, "member", sid
        for m in pre:
            yield key_of(m), m, depth, "absorbed", sid
        chosen = getattr(n, "_chosen", None)
        for c in ([chosen] if chosen is not None else []) + list(n.children):
            yield from walk(c, depth + 1)

    yield from walk(root, 0)


def exec_rollup(snapshot: Dict[str, int]) -> Dict[str, int]:
    """Fold one exec's metric snapshot into the standard rollup: output
    rows, batches, device dispatches, and total operator time.

    time_ns sums every *Time metric EXCEPT the WAIT_TIME_METRICS (wait
    is scheduling and producer time is overlapped upstream work, not this
    operator's own) and the NESTED_TIME_METRICS, whose intervals already
    sit inside another metric's span."""
    rows = int(snapshot.get(NUM_OUTPUT_ROWS, 0))
    # presence-based fallback, NOT falsy-or: an exec that RECORDED zero
    # output batches (every input row filtered away) must report 0, not
    # its input batch count
    batches = int(snapshot[NUM_OUTPUT_BATCHES]
                  if NUM_OUTPUT_BATCHES in snapshot
                  else snapshot.get(NUM_INPUT_BATCHES, 0))
    dispatches = int(snapshot[STAGE_DISPATCHES]
                     if STAGE_DISPATCHES in snapshot
                     else snapshot.get(PARTITION_DISPATCHES, 0))
    time_ns = sum(int(v) for k, v in snapshot.items()
                  if k.endswith("Time") and k not in WAIT_TIME_METRICS
                  and k not in NESTED_TIME_METRICS)
    return {"rows": rows, "batches": batches, "dispatches": dispatches,
            "time_ns": time_ns}


def metrics_level_from_conf(conf) -> int:
    from spark_rapids_tpu_torch import config as C
    s = str(conf.get(C.METRICS_LEVEL)).upper()
    return {"ESSENTIAL": ESSENTIAL, "MODERATE": MODERATE,
            "DEBUG": DEBUG}.get(s, MODERATE)
