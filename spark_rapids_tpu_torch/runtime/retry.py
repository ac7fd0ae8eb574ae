"""Retry on OOM (counterpart of ``spark_rapids_tpu/runtime/retry.py``;
reference RmmRapidsRetryIterator.scala withRetry / withRetryNoSplit, the
GpuRetryOOM / GpuSplitAndRetryOOM exceptions and the injection grammar of
spark.rapids.sql.test.injectRetryOOM, RapidsConf.scala:1627).

OOM arises two ways:

1. cooperatively, when ``SpillFramework.reserve()`` cannot fit a
   reservation (TpuRetryOOM raised synchronously), and
2. physically, when PyTorch's caching allocator cannot allocate on the
   card: it raises ``torch.OutOfMemoryError`` synchronously, in the
   thread that allocates, and a hand kernel whose launch reports
   cudaErrorMemoryAllocation raises the same (``ops/_build.check``). The
   retry drains the spill stores and tries again.

Work wrapped in ``with_retry`` must be idempotent and its inputs
spillable (the reference's contract). On TpuSplitAndRetryOOM the input
batch is split in half and each half retried; the split cascades down to
a single row.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterator, List

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.ops import kernels as K


class TpuOOM(RuntimeError):
    pass


class TpuRetryOOM(TpuOOM):
    """Retry the same work after memory has been freed."""


class TpuSplitAndRetryOOM(TpuOOM):
    """The work itself is too large: split the input and retry halves."""


class TpuQueryQuotaOOM(TpuRetryOOM):
    """A query exceeded its own spark.rapids.query.deviceBudgetBytes
    quota with nothing of its own left to spill. Retried like any
    TpuRetryOOM, but the pre-retry drain frees only the offending
    query's handles (SpillFramework.drain_query): neighbor queries'
    batches stay resident."""

    def __init__(self, msg: str, query_id=None):
        super().__init__(msg)
        self.query_id = query_id


def is_device_oom(exc: BaseException) -> bool:
    """Is this exception an allocation failure on the card? A type test:
    the caching allocator raises ``torch.OutOfMemoryError`` in the thread
    that allocates, so the translation is exact (the JAX package matches
    jaxlib messages). A user exception whose message says "out of
    memory" is not retried."""
    return isinstance(exc, torch.OutOfMemoryError)


#: bounded exponential backoff between OOM retry attempts (process-wide
#: like the OomInjector: retries run on task threads). Synced from
#: spark.rapids.retry.backoff* by TorchSession.prepare_execution.
_BACKOFF_BASE_MS = 10.0
_BACKOFF_MAX_MS = 500.0


def set_backoff(base_ms: float, max_ms: float) -> None:
    global _BACKOFF_BASE_MS, _BACKOFF_MAX_MS
    _BACKOFF_BASE_MS = max(0.0, float(base_ms))
    _BACKOFF_MAX_MS = max(0.0, float(max_ms))


def backoff_from_conf(conf) -> None:
    from spark_rapids_tpu_torch import config as C
    set_backoff(conf.get(C.RETRY_BACKOFF_BASE_MS),
                conf.get(C.RETRY_BACKOFF_MAX_MS))


def _backoff_seconds(attempt: int) -> float:
    """Jittered bounded exponential backoff for retry attempt n (1-based):
    base*2^(n-1) ms capped at the max, scaled by a uniform 50-100% jitter
    so concurrent tasks that OOMed together fan back in spread out."""
    if _BACKOFF_BASE_MS <= 0:
        return 0.0
    raw_ms = min(_BACKOFF_BASE_MS * (2.0 ** (attempt - 1)),
                 _BACKOFF_MAX_MS)
    return (raw_ms / 1000.0) * (0.5 + random.random() * 0.5)


class OomInjector:
    """Test fault injection: force the next N with_retry attempts to OOM
    (reference RmmSpark.forceRetryOOM / the injectRetryOOM conf). The
    state is process-global: partitions run on task threads.

    The facade of the `retry.oom` site of runtime/faults.py:
    ``_attempt_with_drain`` checks both, so either
    ``spark.rapids.sql.test.injectRetryOOM`` or a
    ``retry.oom:oom:count[,skip]`` schedule in
    ``spark.rapids.debug.faults`` fires here."""

    _lock = threading.Lock()
    _num = 0
    _skip = 0
    _split = False

    @classmethod
    def configure(cls, num_ooms: int = 0, skip: int = 0,
                  split: bool = False) -> None:
        with cls._lock:
            cls._num = num_ooms
            cls._skip = skip
            cls._split = split

    @classmethod
    def from_conf(cls, conf) -> None:
        from spark_rapids_tpu_torch import config as C
        spec = conf.get(C.RETRY_OOM_INJECT)
        if not spec:
            cls.configure(0)  # a session without injection clears leftovers
            return
        try:
            parts = [p.strip() for p in str(spec).split(",")]
            num = int(parts[0]) if parts[0] else 0
            skip = int(parts[1]) if len(parts) > 1 and parts[1] else 0
            split = len(parts) > 2 and parts[2].lower() == "split"
        except ValueError as e:
            raise ValueError(
                f"invalid {C.RETRY_OOM_INJECT.key} spec {spec!r}: expected "
                f"'count[,skip[,split]]'") from e
        cls.configure(num, skip, split)

    @classmethod
    def maybe_throw(cls) -> None:
        with cls._lock:
            if cls._num <= 0:
                return
            if cls._skip > 0:
                cls._skip -= 1
                return
            cls._num -= 1
            split = cls._split
        if split:
            raise TpuSplitAndRetryOOM("injected split-retry OOM")
        raise TpuRetryOOM("injected retry OOM")


def split_in_half(batch: ColumnarBatch) -> List[ColumnarBatch]:
    """Default split policy (reference splitSpillableInHalfByRows): the
    live rows compacted, then the first and second halves."""
    n = int(batch.num_rows)
    if n <= 1:
        raise TpuSplitAndRetryOOM("cannot split a single-row batch further")
    if batch.row_mask is not None:
        batch = K.compact_batch(batch)
        n = int(batch.num_rows)
    half = n // 2
    return [K.slice_batch(batch, 0, half),
            K.slice_batch(batch, half, n - half)]


class _Split(Exception):
    pass


def _attempt_with_drain(attempt: Callable[[], object], max_retries: int,
                        splittable: bool) -> object:
    """Shared retry loop: injection check, OOM translation, spill drain.
    Raises _Split when the caller should split the input instead. Each
    failed attempt's time goes to the task's retryWastedTime and to a
    retryAttempt span; the drain and the backoff before the next one to
    retryBlockTime."""
    from spark_rapids_tpu_torch.runtime import faults, trace
    from spark_rapids_tpu_torch.runtime import lifecycle as _lc
    from spark_rapids_tpu_torch.runtime.obs import live as _live
    from spark_rapids_tpu_torch.runtime.memory import get_spill_framework
    from spark_rapids_tpu_torch.runtime.task import TaskContext

    retries = 0
    while True:
        t0a = time.perf_counter_ns()
        try:
            OomInjector.maybe_throw()
            faults.site("retry.oom")
            result = attempt()
            if retries and trace.active() is not None:
                # the attempt that finally landed, tagged with how many
                # tries the work took in total
                trace.instant("retrySucceeded", cat="retry", args={
                    "attempts": retries + 1})
            return result
        except TpuSplitAndRetryOOM as e:
            if splittable:
                # the halves re-run work this attempt already did
                wasted_ns = time.perf_counter_ns() - t0a
                ctx = TaskContext.peek()
                if ctx is not None:
                    ctx.metric("retryWastedTime").add(wasted_ns)
                trace.emit_span("retryAttempt", t0a, wasted_ns,
                                cat="retry",
                                args={"attempt": retries + 1,
                                      "retried": True, "split": True,
                                      "error": type(e).__name__})
                raise _Split()
            raise
        except Exception as e:  # noqa: BLE001 - translate device OOM too
            if not isinstance(e, TpuRetryOOM) and not is_device_oom(e):
                raise
            wasted_ns = time.perf_counter_ns() - t0a
            retries += 1
            ctx = TaskContext.peek()
            if ctx is not None:
                ctx.metric("retryCount").add(1)
                ctx.metric("retryWastedTime").add(wasted_ns)
            trace.emit_span("retryAttempt", t0a, wasted_ns, cat="retry",
                            args={"attempt": retries, "retried": True,
                                  "error": type(e).__name__})
            trace.instant("retryOOM", cat="retry", args={
                "attempt": retries, "error": type(e).__name__})
            if retries > max_retries:
                raise
            t0 = time.perf_counter_ns()
            fw = get_spill_framework()
            if isinstance(e, TpuQueryQuotaOOM):
                # per-query quota breach: free only the offending query's
                # handles, never a neighbor query's batches
                fw.drain_query(e.query_id if e.query_id is not None
                               else _live.current_query_id())
            else:
                fw.drain_all()
            # bounded exponential backoff + jitter before the re-attempt,
            # cancellation-aware: a cancelled query wakes out of it
            # immediately (QueryCancelledError)
            delay_s = _backoff_seconds(retries)
            if delay_s > 0:
                trace.instant("retryBackoff", cat="retry", args={
                    "attempt": retries,
                    "ms": round(delay_s * 1000.0, 3)})
                _lc.sleep(delay_s)
            if ctx is not None:
                ctx.metric("retryBlockTime").add(
                    time.perf_counter_ns() - t0)


def with_retry(attempt: Callable[[ColumnarBatch], object],
               batch: ColumnarBatch,
               split_policy: Callable[[ColumnarBatch], List[ColumnarBatch]]
               = split_in_half,
               max_retries: int = 8) -> Iterator[object]:
    """Run `attempt(batch)`, retrying on OOM. Yields one result per
    (sub-)batch: a split produces several results, which the caller
    treats exactly like extra input batches."""
    from spark_rapids_tpu_torch.runtime import trace
    from spark_rapids_tpu_torch.runtime.task import TaskContext

    stack = [batch]
    while stack:
        b = stack.pop(0)
        try:
            yield _attempt_with_drain(lambda: attempt(b), max_retries,
                                      splittable=True)
        except _Split:
            ctx = TaskContext.peek()
            if ctx is not None:
                ctx.metric("splitAndRetryCount").add(1)
            if trace.active() is not None:
                # args gated: int(num_rows) can sync a lazy device count
                trace.instant("splitAndRetryOOM", cat="retry",
                              args={"rows": int(b.num_rows)})
            stack = split_policy(b) + stack


def with_retry_no_split(attempt: Callable[[], object],
                        max_retries: int = 8) -> object:
    """Retry-only wrapper for non-splittable work (reference
    withRetryNoSplit)."""
    return _attempt_with_drain(attempt, max_retries, splittable=False)
