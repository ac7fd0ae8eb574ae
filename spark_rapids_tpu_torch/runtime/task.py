"""Task context (counterpart of ``spark_rapids_tpu/runtime/task.py``; the
Spark TaskContext the operators see).

One ``TaskContext`` per partition task: its id, the partition, whether
it holds device data (the semaphore's priority), the task accumulators
(``runtime/metrics.py``) and completion callbacks, which run on success,
failure and cancel alike, so permits and handles always release.

The JAX package passes the context to ``execute_partition(ctx, pidx)``.
Here ``execute_partition(pidx)`` keeps its signature and operators read
the thread's context with ``TaskContext.peek()``. A context entered while
another is current on the thread (a cache, an exchange or a broadcast
build materialized inside a task) records it as ``parent`` and restores
it on exit; the semaphore treats a nested task as covered by a permit
its parent holds (``runtime/semaphore.py``).

At completion the accumulators roll into the query trace's event log
(``runtime/trace.on_task_complete``, when a trace is on), fold into the
live registry (``runtime/obs.on_task_complete``: completed, failed and
cancelled tasks, and the counters of ``_TASK_COUNTERS``) and are summed
into the owning query's totals, which the session reads back as
``last_task_metrics()``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from spark_rapids_tpu_torch.runtime.metrics import GpuMetric

_LOG = logging.getLogger("spark_rapids_tpu_torch")

#: query id -> {accumulator: summed value} of the query's completed tasks
_TOTALS: Dict[int, Dict[str, int]] = {}
_TOTALS_LOCK = threading.Lock()


class TaskContext:
    _counter = 0
    _counter_lock = threading.Lock()
    _local = threading.local()

    def __init__(self, partition_id: int = 0, stage_id: int = 0):
        from spark_rapids_tpu_torch.runtime.obs import live
        with TaskContext._counter_lock:
            TaskContext._counter += 1
            self.task_id = TaskContext._counter
        self.partition_id = partition_id
        self.stage_id = stage_id
        self.start_ns = time.perf_counter_ns()
        self._failed = False
        self._cancelled = False
        #: set (under _completion_lock) when complete() starts
        self._done = False
        self._completion_lock = threading.Lock()
        #: the query this task works for: the constructing thread's bound
        #: query id (task waves bind it before constructing contexts)
        self.query_id = live.current_query_id()
        self.holds_device_data = False
        #: the context that was current on this thread when this one was
        #: entered (None for a top-level task)
        self.parent: Optional[TaskContext] = None
        self._metrics: Dict[str, GpuMetric] = {}
        self._completion: List[Callable[[], None]] = []

    def metric(self, name: str) -> GpuMetric:
        if name not in self._metrics:
            self._metrics[name] = GpuMetric(name)
        return self._metrics[name]

    def metrics_snapshot(self) -> Dict[str, int]:
        return {k: m.value for k, m in self._metrics.items()}

    @property
    def completed(self) -> bool:
        return self._done

    def on_completion(self, fn: Callable[[], None]) -> None:
        """Run fn when the task completes; at once on a task that has
        already completed (a pipeline producer still inside its source
        when the consumer's task unwound), as Spark runs a listener
        added to a completed task."""
        with self._completion_lock:
            if not self._done:
                self._completion.append(fn)
                return
        fn()

    def complete(self, failed: bool = False,
                 cancelled: bool = False) -> None:
        """Run the completion callbacks (in reverse order of
        registration), then sum the accumulators into the query's
        totals. ``cancelled`` marks a task unwound by its query's cancel
        token: it did not fail, but it must not count as a clean
        completion either: obs folds it into
        rapids_tasks_cancelled_total."""
        with self._completion_lock:
            self._done = True
            callbacks, self._completion = self._completion, []
        for fn in reversed(callbacks):
            try:
                fn()
            except Exception:  # noqa: BLE001 - the remaining callbacks
                # (the semaphore release) must still run
                _LOG.warning("task %d completion callback failed",
                             self.task_id, exc_info=True)
        self._failed = failed
        self._cancelled = cancelled
        # the trace's event log, the live registry and the query's
        # attribution aggregate after the callbacks, so the semaphore
        # release's final wait and hold times are in all three: ONE
        # write batch per task
        from spark_rapids_tpu_torch.runtime import obs, trace
        from spark_rapids_tpu_torch.runtime.obs import attribution
        trace.on_task_complete(self)
        obs.on_task_complete(self)
        attribution.fold_task(self._metrics)
        if self.query_id is not None and self._metrics:
            snap = self.metrics_snapshot()
            with _TOTALS_LOCK:
                tot = _TOTALS.setdefault(self.query_id, {})
                for k, v in snap.items():
                    if k == "maxDeviceBytesHeld":
                        tot[k] = max(tot.get(k, 0), v)
                    else:
                        tot[k] = tot.get(k, 0) + v

    # -- thread association ------------------------------------------------
    @staticmethod
    def peek() -> "Optional[TaskContext]":
        """The thread's current context, without creating one."""
        return getattr(TaskContext._local, "ctx", None)

    @staticmethod
    def get() -> "TaskContext":
        ctx = getattr(TaskContext._local, "ctx", None)
        if ctx is None:
            ctx = TaskContext()
            TaskContext._local.ctx = ctx
        return ctx

    @staticmethod
    def set_current(ctx: "Optional[TaskContext]") -> None:
        TaskContext._local.ctx = ctx

    @staticmethod
    def clear() -> None:
        if hasattr(TaskContext._local, "ctx"):
            del TaskContext._local.ctx

    def __enter__(self):
        self.parent = TaskContext.peek()
        TaskContext.set_current(self)
        return self

    def __exit__(self, et, ev, tb):
        cancelled = False
        if et is not None:
            from spark_rapids_tpu_torch.runtime.lifecycle import (
                QueryCancelledError,
            )
            cancelled = issubclass(et, QueryCancelledError)
        try:
            self.complete(failed=et is not None and not cancelled,
                          cancelled=cancelled)
        finally:
            TaskContext.set_current(self.parent)
        return False


def take_query_totals(query_id) -> Dict[str, int]:
    """The summed task accumulators of one query, removed from the
    table (the session reads them once the query has finished)."""
    with _TOTALS_LOCK:
        return _TOTALS.pop(query_id, {})


def reset_for_tests() -> None:
    with _TOTALS_LOCK:
        _TOTALS.clear()
    TaskContext.clear()
