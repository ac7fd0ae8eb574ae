"""Task accumulators (counterpart of the ``GpuMetric`` part of
``spark_rapids_tpu/runtime/metrics.py``; reference GpuTaskMetrics).

``GpuMetric`` is one thread-safe counter with ``add``, ``set_max`` (a
high-water mark) and ``value``. A lazy
device row count added to it is resolved when the metric is read, so
counting never adds a device sync to the hot path. The names below are
the per-task accumulators that the retry framework, the spill framework
and the semaphore keep on ``runtime/task.TaskContext``. The per-operator
metric registry and its rollups are not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import threading

RETRY_COUNT = "retryCount"
SPLIT_RETRY_COUNT = "splitAndRetryCount"
#: ns of failed attempts that a retry replayed
RETRY_WASTED_TIME = "retryWastedTime"
#: ns spent draining the spill stores and backing off before a re-attempt
RETRY_BLOCK_TIME = "retryBlockTime"
SPILL_TO_HOST_BYTES = "spillToHostBytes"
SPILL_TO_HOST_TIME = "spillToHostTime"
SPILL_TO_DISK_BYTES = "spillToDiskBytes"
SPILL_TO_DISK_TIME = "spillToDiskTime"
#: high-water mark of registered device bytes while the task ran
MAX_DEVICE_BYTES_HELD = "maxDeviceBytesHeld"
SEMAPHORE_WAIT_TIME = "semaphoreWaitTime"
SEMAPHORE_HOLD_TIME = "semaphoreHoldTime"
#: serialized blobs re-fetched from the shuffle store after a failed check
SHUFFLE_CORRUPTION_RETRIES = "shuffleCorruptionRetries"
#: the serialized exchange's store totals (ShuffleExchangeExec.metrics)
SHUFFLE_BYTES_WRITTEN = "shuffleBytesWritten"
SHUFFLE_BYTES_SPILLED = "shuffleBytesSpilled"


class GpuMetric:
    __slots__ = ("name", "_value", "_lock", "_deferred")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        self._deferred = []

    def add(self, v) -> None:
        """Accepts ints or a LazyRowCount; a lazy count that has not been
        read yet is kept and resolved when the metric is read."""
        from spark_rapids_tpu_torch.columnar.batch import LazyRowCount
        if isinstance(v, LazyRowCount) and v._val is None:
            with self._lock:
                self._deferred.append(v)
            return
        with self._lock:
            self._value += int(v)

    def set_max(self, v: int) -> None:
        """High-water-mark semantics (maxDeviceBytesHeld)."""
        with self._lock:
            if int(v) > self._value:
                self._value = int(v)

    @property
    def value(self) -> int:
        with self._lock:
            if self._deferred:
                self._value += sum(int(v) for v in self._deferred)
                self._deferred = []
            return self._value
