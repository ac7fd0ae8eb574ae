"""Pipelined batch execution: overlap host decode, serde and upload with
device compute across exec boundaries (counterpart of
``spark_rapids_tpu/runtime/pipeline.py``).

Reference parity: the reference gets much of its throughput from
OVERLAP: MultiFileReaderThreadPool prefetches and decodes the next chunk
while the device computes, and the async write path keeps serialization
off the compute critical path. Without this module every batch's pyarrow
decode and upload sits serially between the device work of its
neighbours. ``insert_pipelines`` wraps every non-root scan in a
``PipelineExec``: a bounded-lookahead producer/consumer boundary.

Design (the four interactions to keep straight):

* Producers run on the shared bounded host pool (runtime/host_pool.py) as
  PULL-TRIGGERED REFILL tasks, not partition-lifetime threads: a refill
  produces until the bounded queue is full, stashes at most one overflow
  item, and returns its worker to the pool. The consumer re-arms the
  refill after every take, so a producer never blocks a pool worker on a
  full queue.
* TaskContext is thread-local: each refill binds the consumer task's
  context and query id for its duration (restoring the worker's own
  bindings after), so the semaphore's re-entrancy, retry accounting,
  cancellation and trace tracks all see the owning task from producer
  threads.
* The device semaphore is acquired by the CONSUMER before the first
  refill is armed: the task already holds its permit when producer-side
  uploads run, so a producer never parks a pool worker in the
  semaphore's wait queue.
* Early exit (a LIMIT closing its upstream) cancels the pipeline:
  ``close()`` stops re-arming, waits for the in-flight refill to return
  its worker, and closes the source generator from a thread that is
  provably not executing it. Producer exceptions (a ``KernelError``, a
  CUDA error, an out-of-memory error, an injected fault) travel through
  the queue and re-raise at the consumer.

The CUDA handoff (no JAX counterpart: there the upload is asynchronous
and XLA orders it). A batch produced on a pool worker must not reach the
consumer's kernels before its copies land, and its memory must not be
handed back to the producer while those kernels still read it:

* the producer runs each ``next(source)`` (the uploads of ``from_arrow``
  and ``ENC.upload``, pinned and non-blocking, and any padding) on a side
  stream of its own and records an event after the batch's last device
  operation; the event rides through the queue with the batch;
* the consumer makes its current stream wait on that event before the
  batch's first use, and calls ``record_stream`` on every tensor of the
  batch (values, validity, offsets, string bytes, the encoded planes and
  partition columns), so the caching allocator, whose pools are per
  stream, keeps each block until the consumer's work on it is done;
* ``close()`` synchronizes the side stream before the unconsumed batches
  are dropped. A CPU batch skips all of this.

One side stream per boundary (per partition's iterator): the event of a
batch then orders exactly that boundary's uploads. Uploads on the
default stream would queue behind the consumer's kernels and overlap
nothing; a stream shared by two boundaries would make one boundary's
batches wait on the other's copies. ``torch.cuda.Stream()`` takes its
stream from PyTorch's per-device pool of non-blocking streams (32, handed
out round robin), so a second pipeline running at the same time on the
same device gets a stream of its own too; past 32 live boundaries two
share one, which orders their uploads one after the other and stays
correct, because each batch carries its own event.

Per-stage fallback: ``PipelineExec`` runs the child synchronously when
depth <= 0, when the submission would land at host-pool depth 2 (inline:
no overlap is possible, and a bounded queue with no concurrent consumer
would deadlock), or when setting the pipeline up raises. The synchronous
path is the same device path; nothing falls back to the CPU.

``start_d2h`` is the deferred-scalar-fetch half of the design: the
compact exchange starts the copy of a batch's offsets to pinned host
memory right after dispatching its counting sort, and reads them only
after the NEXT batch has been dispatched, so the transfer rides under
device compute instead of serializing against it.
"""
from __future__ import annotations

import logging
import queue
import time
from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.exec.nodes import TorchExec
from spark_rapids_tpu_torch.runtime import metrics as M

log = logging.getLogger("spark_rapids_tpu_torch")

#: queue sentinel: the producer exhausted its source
_DONE = object()
#: hand sentinel: no stashed overflow item
_EMPTY = object()

#: consumers currently blocked waiting on a producer refill (the pipeline
#: stall gauge). Moves only on the slow path, never per batch.
_STALLED = 0
_STALL_LOCK = _san.lock("pipeline.stall")


def stalled_consumers() -> int:
    """Pipeline consumers blocked on a producer right now (a racy read by
    design: it feeds a gauge)."""
    return _STALLED


def _stall_enter() -> None:
    global _STALLED
    with _STALL_LOCK:
        _STALLED += 1


def _stall_exit() -> None:
    global _STALLED
    with _STALL_LOCK:
        _STALLED = max(0, _STALLED - 1)


class _PendingHost:
    """A device tensor's copy to the host, in flight: a non-blocking copy
    into pinned memory and an event on the stream that issued it. A CPU
    tensor is its own copy."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def numpy(self):
        """The host values, once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def start_d2h(t: torch.Tensor) -> _PendingHost:
    """Begin the copy of ``t`` to the host without waiting for it; the
    result's ``numpy()`` waits for it."""
    return _PendingHost(t)


def batch_tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor of a ColumnarBatch or EncodedBatch: each column's
    data, validity, string offsets and bytes, codes and vocabulary, the
    child columns, the row mask and a row count on the device, and an
    encoded column's planes and ready column."""
    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnarBatch, ColumnVector, LazyRowCount,
    )
    from spark_rapids_tpu_torch.io import encoded as ENC
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from batch_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from batch_tensors(v)
    elif isinstance(obj, ColumnarBatch):
        yield from batch_tensors(obj.columns)
        yield from batch_tensors(obj.row_mask)
        yield from batch_tensors(obj.num_rows)
    elif isinstance(obj, ColumnVector):
        yield from batch_tensors(obj.data)
        yield from batch_tensors(obj.validity)
    elif isinstance(obj, LazyRowCount):
        yield from batch_tensors(obj._dev)
    elif isinstance(obj, ENC.EncodedBatch):
        yield from batch_tensors(obj.columns)
    elif isinstance(obj, ENC.EncodedColumn):
        yield from batch_tensors(obj.planes)
        yield from batch_tensors(obj.cv)


class _Staged:
    """Queue envelope of a batch produced on the side stream: the batch
    and the event recorded after its last device operation."""

    __slots__ = ("item", "event")

    def __init__(self, item, event):
        self.item = item
        self.event = event


class _CudaHandoff:
    """The producer's side stream of one boundary and the consumer's half
    of the handoff (see the module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def produce(self, source) -> _Staged:
        """next(source) with its device work on the side stream."""
        with torch.cuda.stream(self.stream):
            item = next(source)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return _Staged(item, ev)

    def receive(self, staged: _Staged):
        """The batch, ordered after its uploads on the consumer's stream
        and kept from reuse until the consumer's work on it is done."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(staged.event)
        for t in batch_tensors(staged.item):
            if t.device.type == "cuda":
                t.record_stream(consumer)
        return staged.item

    def close(self) -> None:
        self.stream.synchronize()


class _ProducerError:
    """Queue envelope for an exception raised on the producer side."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PipelinedIterator:
    """Bounded-lookahead bridge: items of ``source`` are produced on the
    host pool up to ``depth`` ahead of the consumer.

    Iterate it exactly once (it is its own iterator) and close() it when
    done; PipelineExec does both. Thread model: ONE consumer thread
    iterates; refill tasks never run concurrently with each other
    (single-flight, guarded by _lock). With a CUDA ``device`` the
    producer's device work runs on a side stream (``_CudaHandoff``)."""

    def __init__(self, source: Iterator, depth: int, ctx=None,
                 conf=None, label: str = "pipeline",
                 stall_metric=None, producer_metric=None,
                 device: Optional[torch.device] = None):
        from spark_rapids_tpu_torch.runtime.host_pool import get_host_pool
        from spark_rapids_tpu_torch.runtime.obs import live as _live
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._ctx = ctx
        self._label = label
        self._stall = stall_metric
        self._prod = producer_metric
        self._pool = get_host_pool(conf)
        self._handoff = _CudaHandoff(device) \
            if device is not None and device.type == "cuda" else None
        # the consumer's bound query id: refills re-bind it (with the
        # TaskContext), so a cancel reaches the producer and its spans
        # attribute to the owning query
        self._query_id = _live.current_query_id()
        # the consumer's serving request context rides the same seam:
        # producer-side spans land in the request's reqtrace ring even
        # when a consumer-armed refill runs on a fresh pool worker
        self._req = _live.current_request()
        self._lock = _san.lock("pipeline.iterator")
        self._cancel = False
        self._refill_running = False
        self._finished = False      # terminal item produced (DONE/error)
        self._hand = _EMPTY         # overflow item a full queue bounced
        self._future = None         # in-flight refill, for close()
        self._closed = False
        self._ensure_refill()

    # -- producer side -----------------------------------------------------

    def _ensure_refill(self) -> None:
        with self._lock:
            if (self._refill_running or self._cancel
                    or (self._finished and self._hand is _EMPTY)):
                return
            self._refill_running = True
            self._future = self._pool.submit(self._refill)

    def _refill(self) -> None:
        """Produce until the bounded queue is full (stashing at most one
        bounced item), then return the pool worker, under the consumer
        task's TaskContext, query id and serving request.

        Invariant: _refill_running flips False under the SAME lock hold
        that decides to exit: a consumer that takes the lock afterwards
        either sees an armed refill or may safely arm one."""
        from spark_rapids_tpu_torch.runtime.obs import live as _live
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        prev = TaskContext.peek()
        prev_qid = _live.bind(self._query_id)
        prev_req = _live.bind_request(self._req)
        if self._ctx is not None:
            TaskContext.set_current(self._ctx)
        try:
            try:
                self._refill_loop()
            except BaseException as e:  # noqa: BLE001 - _refill_loop only
                # raises on instrumentation bugs; the consumer must still
                # be unblocked with a terminal item
                with self._lock:
                    self._refill_running = False
                    if not self._finished:
                        self._finished = True
                        try:
                            self._q.put_nowait(_ProducerError(e))
                        except queue.Full:
                            self._hand = _ProducerError(e)
        finally:
            _live.bind_request(prev_req)
            _live.bind(prev_qid)
            if self._ctx is not None:
                if prev is not None:
                    TaskContext.set_current(prev)
                else:
                    TaskContext.clear()

    def _refill_loop(self) -> None:
        from spark_rapids_tpu_torch.runtime import faults as _faults
        from spark_rapids_tpu_torch.runtime import lifecycle as _lc
        from spark_rapids_tpu_torch.runtime import trace
        while True:
            with self._lock:
                if self._cancel:
                    self._refill_running = False
                    return
                if self._hand is not _EMPTY:
                    try:
                        self._q.put_nowait(self._hand)
                        self._hand = _EMPTY
                    except queue.Full:
                        # the consumer re-arms after its next take
                        self._refill_running = False
                        return
                if self._finished:
                    self._refill_running = False
                    return
            t0 = time.perf_counter_ns()
            try:
                # cooperative checkpoint: a cancelled query's refill
                # raises here and the error travels the producer-error
                # envelope to the consumer, which unwinds normally
                _lc.check_current()
                # producer-death injection: a fault here travels the same
                # envelope as a real upstream decode failure
                _faults.site("pipeline.producer")
                item = next(self._source) if self._handoff is None \
                    else self._handoff.produce(self._source)
            except StopIteration:
                item = _DONE
            except BaseException as e:  # noqa: BLE001 - travels to the
                item = _ProducerError(e)  # consumer and re-raises there
            dt = time.perf_counter_ns() - t0
            if self._prod is not None and not isinstance(
                    item, _ProducerError) and item is not _DONE:
                self._prod.add(dt)
            if trace.active() is not None:
                trace.emit_span("pipelineProduce", t0, dt, cat="pipeline",
                                args={"label": self._label},
                                level=trace.DEBUG)
            with self._lock:
                if item is _DONE or isinstance(item, _ProducerError):
                    self._finished = True
                if self._cancel:
                    self._refill_running = False
                    return
                try:
                    self._q.put_nowait(item)
                except queue.Full:
                    self._hand = item
                    self._refill_running = False
                    return

    # -- consumer side -----------------------------------------------------

    def __iter__(self):
        from spark_rapids_tpu_torch.runtime import trace
        while True:
            self._ensure_refill()
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                t0 = time.perf_counter_ns()
                _stall_enter()
                try:
                    item = self._q.get()
                finally:
                    _stall_exit()
                dt = time.perf_counter_ns() - t0
                if self._stall is not None:
                    self._stall.add(dt)
                if trace.active() is not None:
                    trace.instant("pipelineStall", cat="pipeline", args={
                        "label": self._label, "stall_us": dt / 1000.0},
                        level=trace.DEBUG)
            if item is _DONE:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            if isinstance(item, _Staged):
                item = self._handoff.receive(item)
            yield item

    def close(self) -> None:
        """Cancel the pipeline: stop re-arming, wait out the in-flight
        refill, then close the source generator (safe: nothing executes
        it once the refill returned), synchronize the side stream and
        drop the buffered batches. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cancel = True
            fut = self._future
        if fut is not None:
            try:
                fut.result(timeout=300)
            except Exception:  # noqa: BLE001 - refill never raises; a
                # timeout means a wedged upstream decode, log and move on
                log.warning("pipeline %s: refill did not finish on close",
                            self._label, exc_info=True)
        try:
            self._source.close()
        except BaseException:  # noqa: BLE001 - upstream cleanup only
            pass
        if self._handoff is not None:
            self._handoff.close()
        # drop buffered batches promptly (device memory)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._hand = _EMPTY


# ---------------------------------------------------------------------------
# The exec node + planner pass
# ---------------------------------------------------------------------------

class PipelineExec(TorchExec):
    """Pipeline boundary: runs its child's generator on the host pool with
    bounded lookahead, its uploads on a side CUDA stream, so the child's
    host work (decode, padding, upload) overlaps the parent's device
    compute. Transparent to the data: yields the child's batches
    unchanged. ``metrics``: pipelineDepth (0 when the partition ran
    synchronously), pipelineStallTime (the consumer blocked on the
    producer), pipelineProducerTime (the producer's own time) and
    numOutputBatches."""

    def __init__(self, plan, children, conf, device, depth: int):
        super().__init__(plan, children, conf, device)
        self.depth = int(depth)

    @property
    def schema(self):
        return self.children[0].schema

    def name(self) -> str:
        return f"PipelineExec(depth={self.depth})"

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        return "\n".join([f"{pad}{self.name()}",
                          self.children[0].tree_string(indent + 1)])

    def execute_partition(self, pidx):
        from spark_rapids_tpu_torch.runtime.host_pool import HostTaskPool
        from spark_rapids_tpu_torch.runtime.lifecycle import (
            QueryCancelledError,
        )
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        depth_m = self.metrics.metric(M.PIPELINE_DEPTH)
        out_batches = self.metrics.metric(M.NUM_OUTPUT_BATCHES)
        # depth-2 pool submissions run inline: an "async" producer on the
        # consumer's own thread gives no overlap and a bounded queue
        # nobody drains; run synchronously instead
        if self.depth <= 0 or HostTaskPool._depth() >= 2:
            depth_m.set(0)
            for b in self.children[0].execute_partition(pidx):
                out_batches.add(1)
                yield b
            return
        src = self.children[0].execute_partition(pidx)
        try:
            # consumer-side acquire BEFORE the producer is armed: the task
            # holds its permit when producer uploads run, so a producer
            # never parks a pool worker on the semaphore
            self._acquire()
            pit = PipelinedIterator(
                src, self.depth, ctx=TaskContext.peek(), conf=self.conf,
                label=f"{type(self.children[0]).__name__}@p{pidx}",
                stall_metric=self.metrics.metric(M.PIPELINE_STALL_TIME),
                producer_metric=self.metrics.metric(
                    M.PIPELINE_PRODUCER_TIME),
                device=self.device)
        except QueryCancelledError:
            # a cancelled query's unwind is not a setup failure: running
            # the stage synchronously would resurrect the killed work
            raise
        except Exception:  # noqa: BLE001 - per-stage fallback: a
            # pipeline setup failure takes the synchronous device path
            log.warning("pipeline setup failed for %s; running "
                        "synchronously", self.name(), exc_info=True)
            depth_m.set(0)
            for b in src:
                out_batches.add(1)
                yield b
            return
        depth_m.set(self.depth)
        try:
            for b in pit:
                out_batches.add(1)
                yield b
        finally:
            pit.close()


def pipeline_conf(conf) -> int:
    """Effective lookahead depth from the conf pair (0 = disabled)."""
    if not conf.get(C.PIPELINE_ENABLED):
        return 0
    return max(0, int(conf.get(C.PIPELINE_DEPTH)))


def insert_pipelines(exec_root, conf):
    """Planner pass (applied by plan/overrides.convert_plan): wrap every
    non-root host-producing scan in a PipelineExec so the scan->compute
    edge becomes a pipeline boundary. Scans feeding an exchange get the
    same treatment: the exchange's partitioning is the consumer there.
    A cached relation's scan is not wrapped: its batches are on the
    device already."""
    depth = pipeline_conf(conf)
    if depth <= 0:
        return exec_root
    from spark_rapids_tpu_torch.exec import nodes as X
    scan_types = (X.ParquetScanExec, X.EncodedParquetSourceExec,
                  X.TextScanExec, X.InMemoryScanExec,
                  X.ShuffleFileScanExec)

    def rewrite(node, parent):
        node.children = [rewrite(c, node) for c in node.children]
        if parent is not None and isinstance(node, scan_types):
            return PipelineExec(node.plan, [node], conf, node.device, depth)
        return node

    return rewrite(exec_root, None)
