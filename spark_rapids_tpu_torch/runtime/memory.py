"""Device budget, the three-tier spill cascade and spillable batches
(counterpart of ``spark_rapids_tpu/runtime/memory.py``; reference
SpillFramework.scala, SpillableColumnarBatch.scala, GpuDeviceManager's
pool sizing and DeviceMemoryEventHandler's drain on an allocation
failure).

The budget is cooperative: operators register the batches they hold
between steps; ``reserve()`` is called before materializing a large
batch and drains the spill stores (device -> host -> disk, largest batch
first) until the reservation fits. A real ``torch.OutOfMemoryError`` in
a retried attempt also drains them (``runtime/retry.py``). The budget in
force is min(spark.rapids.memory.tpu.budgetBytes, allocFraction x the
card's memory), where the JAX package reads XLA's bytes_limit; on a CPU
session it is budgetBytes.

Spilling a batch to the host copies every plane to the CPU
(``columnar/batch.batch_to``, a blocking copy) and drops the device
batch; host objects (dictionary vocabularies are planes too, column
bounds are not) ride along untouched. The disk tier writes each plane
with ``np.save``. ``get`` moves the planes back to the batch's device.
Freed device blocks return to PyTorch's caching allocator: room for this
process's next allocation, not for another process.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_to, map_planes,
)

DEVICE, HOST, DISK = "device", "host", "disk"


def _record_spill(kind: str, nbytes: int, dur_ns: int,
                  handle_id: str) -> None:
    """The spilling task's accumulators (the spill runs on the thread
    whose reservation forced it) plus a trace instant event."""
    from spark_rapids_tpu_torch.runtime import trace
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    ctx = TaskContext.peek()
    if ctx is not None:
        ctx.metric(kind + "Bytes").add(nbytes)
        ctx.metric(kind + "Time").add(dur_ns)
    trace.instant(kind, cat="memory", args={
        "bytes": nbytes, "dur_ns": dur_ns, "handle": handle_id[:8]})


class SpillableHandle:
    """One registered batch. State machine: device -> host -> disk,
    rematerialized back to the device on demand (``get``). Larger
    batches spill first (reference SpillFramework)."""

    def __init__(self, framework: "SpillFramework", batch: ColumnarBatch):
        from spark_rapids_tpu_torch.runtime.obs import live
        self.fw = framework
        self.handle_id = uuid.uuid4().hex
        self.size = batch.device_memory_size()
        self.device = batch.device if batch.columns else None
        # per-query ledger key (spark.rapids.query.deviceBudgetBytes):
        # the registering thread's bound query id, so quota enforcement
        # can pick victims from, and charge, the owning query only
        self.query_id = live.current_query_id()
        self._lock = threading.Lock()
        self._tier = DEVICE
        self._device: Optional[ColumnarBatch] = batch
        self._host: Optional[ColumnarBatch] = None
        #: the host batch with each plane replaced by its file's path
        self._disk: Optional[ColumnarBatch] = None
        self._closed = False
        self._pinned = False  # mid-rematerialization: not a spill victim

    @property
    def tier(self) -> str:
        return self._tier

    def spillable(self) -> bool:
        return self._tier == DEVICE and not self._closed and not self._pinned

    # -- transitions -------------------------------------------------------

    def spill_to_host(self) -> int:
        """device -> host. Returns bytes freed from the device tier."""
        t0 = time.perf_counter_ns()
        with self._lock:
            if self._tier != DEVICE or self._closed or self._pinned:
                return 0
            self._host = batch_to(self._device, "cpu")
            self._device = None
            self._tier = HOST
        _record_spill("spillToHost", self.size, time.perf_counter_ns() - t0,
                      self.handle_id)
        return self.size

    def spill_to_disk(self) -> int:
        """host -> disk. Returns bytes freed from the host tier."""
        from spark_rapids_tpu_torch.runtime import faults as _faults
        # fault site outside the handle lock: an injected disk error (or
        # wedge) must behave like np.save failing
        _faults.site("spill.disk")
        t0 = time.perf_counter_ns()
        with self._lock:
            if self._tier != HOST or self._closed or self._pinned:
                return 0
            spill_dir = self.fw.ensure_spill_dir()
            seq = iter(range(1 << 30))

            def save(t):
                path = os.path.join(spill_dir,
                                    f"{self.handle_id}_{next(seq)}.npy")
                np.save(path, t.numpy(), allow_pickle=False)
                return path

            self._disk = map_planes(self._host, save)
            self._host = None
            self._tier = DISK
        _record_spill("spillToDisk", self.size, time.perf_counter_ns() - t0,
                      self.handle_id)
        return self.size

    def _disk_paths(self):
        paths = []
        if self._disk is not None:
            map_planes(self._disk, lambda p: paths.append(p) or p)
        return paths

    def get(self) -> ColumnarBatch:
        """Rematerialize on the device. Never calls into the framework
        while holding the handle lock (reserve may pick other handles,
        possibly themselves rematerializing, as victims: holding the
        lock across that is an ABBA deadlock). The handle is pinned for
        the duration so concurrent spills skip it."""
        with self._lock:
            if self._closed:
                raise ValueError("handle closed")
            if self._tier == DEVICE:
                return self._device
            self._pinned = True
            if self._tier == DISK:
                paths = self._disk_paths()
                self._host = map_planes(
                    self._disk, lambda p: torch.from_numpy(np.load(p)))
                for p in paths:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                self._disk = None
                self._tier = HOST
        try:
            # best effort: an over-budget handle was admitted once and
            # must stay rematerializable (drain everything else, then load)
            self.fw.reserve(self.size, exclude=self, best_effort=True)
            with self._lock:
                if self._tier == HOST:
                    self._device = batch_to(self._host, self.device) \
                        if self.device is not None else self._host
                    self._host = None
                    self._tier = DEVICE
                return self._device
        finally:
            with self._lock:
                self._pinned = False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            paths = self._disk_paths()
            self._disk = None
            self._device = None
            self._host = None
        # disk cleanup outside the handle lock: once _closed is set no
        # transition can race
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.fw.unregister(self)


class SpillFramework:
    """Cooperative device budget + the spill cascade."""

    def __init__(self, device_budget_bytes: int, host_budget_bytes: int,
                 spill_dir: Optional[str] = None):
        self.device_budget = device_budget_bytes
        self.host_budget = host_budget_bytes
        #: None: a fresh temporary directory, made at the first disk spill
        self.spill_dir = spill_dir
        self._lock = threading.Lock()
        self._handles: Dict[str, SpillableHandle] = {}
        self.metrics = {"spill_to_host_bytes": 0, "spill_to_disk_bytes": 0,
                        "spill_count": 0, "oom_drains": 0}
        #: leak audit (reference RapidsBufferCatalog leak tracking): when
        #: enabled, registrations record their creation stack so
        #: unreleased handles are attributable, and leak_report() names
        #: them
        self.leak_audit = False
        self._origins: Dict[str, str] = {}

    def ensure_spill_dir(self) -> str:
        with self._lock:
            if self.spill_dir is None:
                self.spill_dir = tempfile.mkdtemp(prefix="srt_spill_")
            d = self.spill_dir
        os.makedirs(d, exist_ok=True)
        return d

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.metrics[key] += n

    def metrics_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.metrics)

    # -- registration ------------------------------------------------------

    def register(self, batch: ColumnarBatch) -> SpillableHandle:
        """Register a device-resident batch. Enforces the budget by
        spilling OTHER handles; a single batch larger than the whole
        budget is admitted anyway (it already exists on the device; the
        cooperative budget cannot un-allocate it) after draining."""
        h = SpillableHandle(self, batch)
        from spark_rapids_tpu_torch.runtime.retry import TpuRetryOOM
        # per-query quota first, and its breach propagates (unlike the
        # global budget below): the over-quota query self-spills, and
        # when nothing of its own is left to spill the typed quota OOM
        # feeds its retry/split cascade instead of evicting neighbors
        self._enforce_query_budget(h.size)
        try:
            self.reserve(h.size)
        except TpuRetryOOM:
            self.drain_all()
        with self._lock:
            self._handles[h.handle_id] = h
            if self.leak_audit:
                import traceback
                self._origins[h.handle_id] = "".join(
                    traceback.format_stack(limit=8)[:-1])
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        ctx = TaskContext.peek()
        if ctx is not None:
            # high-water mark of device bytes registered while this task
            # ran (GpuTaskMetrics maxDeviceMemoryBytes)
            ctx.metric("maxDeviceBytesHeld").set_max(
                self.device_bytes_held())
        return h

    def unregister(self, h: SpillableHandle) -> None:
        with self._lock:
            self._handles.pop(h.handle_id, None)
            self._origins.pop(h.handle_id, None)

    # -- leak detection ----------------------------------------------------

    def leak_report(self, expected_live: int = 0) -> list:
        """Unreleased handles beyond `expected_live` (cached relations
        legitimately stay registered for their lifetime). Returns
        [(handle_id, bytes, origin_stack_or_None)]."""
        with self._lock:
            if len(self._handles) <= expected_live:
                return []
            # dict order = registration order: the oldest registrations
            # are the legitimately persistent ones
            items = list(self._handles.items())[expected_live:]
            return [(hid, h.size, self._origins.get(hid))
                    for hid, h in items]

    def assert_no_leaks(self, expected_live: int = 0) -> None:
        leaks = self.leak_report(expected_live)
        if leaks:
            lines = [f"  {hid}: {size}B" + (f"\n{org}" if org else "")
                     for hid, size, org in leaks]
            raise AssertionError(
                f"{len(leaks)} spillable handle(s) not released:\n"
                + "\n".join(lines))

    # -- accounting --------------------------------------------------------

    def device_bytes_held(self, query_id=None) -> int:
        """Registered device-tier bytes: process-wide, or one query's
        ledger slice when `query_id` is passed (the per-query quota
        read)."""
        with self._lock:
            return sum(h.size for h in self._handles.values()
                       if h.tier == DEVICE
                       and (query_id is None or h.query_id == query_id))

    def host_bytes_held(self) -> int:
        with self._lock:
            return sum(h.size for h in self._handles.values()
                       if h.tier == HOST)

    def _spilled(self, freed: int) -> None:
        if freed:
            with self._lock:
                self.metrics["spill_to_host_bytes"] += freed
                self.metrics["spill_count"] += 1
            self._enforce_host_budget()

    def _enforce_query_budget(self, nbytes: int,
                              exclude: Optional[SpillableHandle] = None
                              ) -> None:
        """Per-query device quota (spark.rapids.query.deviceBudgetBytes,
        carried on the query's cancel token): when the current query's
        ledger plus this reservation exceeds its own budget, spill the
        query's own device handles (largest first). When nothing of its
        own remains spillable, raise the typed TpuQueryQuotaOOM: the
        retry framework then drains only this query's handles, leaving
        neighbor queries' batches resident."""
        from spark_rapids_tpu_torch.runtime import lifecycle as _lc
        tok = _lc.current_token()
        if tok is None or tok.device_budget <= 0:
            return
        budget, qid = tok.device_budget, tok.query_id
        from spark_rapids_tpu_torch.runtime.retry import TpuQueryQuotaOOM
        while self.device_bytes_held(query_id=qid) + nbytes > budget:
            victim = self._pick_victim(exclude, query_id=qid)
            if victim is None:
                raise TpuQueryQuotaOOM(
                    f"query {qid} holds "
                    f"{self.device_bytes_held(query_id=qid)}B of device "
                    f"batches and needs {nbytes}B more, over its "
                    f"deviceBudgetBytes={budget} quota with nothing of "
                    f"its own left to spill", query_id=qid)
            self._spilled(victim.spill_to_host())

    def drain_query(self, query_id) -> int:
        """Spill every device handle the given query holds (the quota
        twin of drain_all: the retry framework calls this on a
        TpuQueryQuotaOOM so an over-quota query frees only its own
        memory before re-attempting)."""
        freed = 0
        while True:
            victim = self._pick_victim(None, query_id=query_id)
            if victim is None:
                return freed
            got = victim.spill_to_host()
            freed += got
            self._spilled(got)

    def reserve(self, nbytes: int, exclude: Optional[SpillableHandle] = None,
                best_effort: bool = False) -> None:
        """Make room for an nbytes device materialization, spilling
        registered device handles (largest first) as needed. Raises
        TpuRetryOOM when even a full drain cannot fit the reservation;
        best_effort=True drains what it can and returns instead (used to
        rematerialize handles that were admitted over budget). The
        per-query quota is enforced by register(), not here."""
        from spark_rapids_tpu_torch.runtime.retry import TpuRetryOOM
        if nbytes > self.device_budget:
            if best_effort:
                self.drain_all()
                return
            raise TpuRetryOOM(
                f"reservation {nbytes}B exceeds device budget "
                f"{self.device_budget}B")
        while self.device_bytes_held() + nbytes > self.device_budget:
            victim = self._pick_victim(exclude)
            if victim is None:
                if best_effort:
                    return
                raise TpuRetryOOM(
                    f"cannot reserve {nbytes}B: "
                    f"{self.device_bytes_held()}B held, nothing spillable")
            freed = victim.spill_to_host()
            self._spilled(freed)
            if not freed and best_effort:
                return

    def _pick_victim(self, exclude,
                     query_id=None) -> Optional[SpillableHandle]:
        with self._lock:
            cands = [h for h in self._handles.values()
                     if h.spillable() and h is not exclude
                     and (query_id is None or h.query_id == query_id)]
        if not cands:
            return None
        return max(cands, key=lambda h: h.size)

    def _enforce_host_budget(self) -> None:
        while self.host_bytes_held() > self.host_budget:
            with self._lock:
                cands = [h for h in self._handles.values() if h.tier == HOST]
            if not cands:
                return
            victim = max(cands, key=lambda h: h.size)
            freed = victim.spill_to_disk()
            if not freed:
                return
            self._count("spill_to_disk_bytes", freed)

    def drain_all(self) -> int:
        """Emergency drain (the DeviceMemoryEventHandler analog, called
        when an allocation on the card failed)."""
        self._count("oom_drains")
        freed = 0
        while True:
            victim = self._pick_victim(None)
            if victim is None:
                return freed
            got = victim.spill_to_host()
            freed += got
            if got:
                self._enforce_host_budget()


class SpillableColumnarBatch:
    """Operator currency: hold this between pipeline steps instead of a
    raw batch so other tasks' reservations can evict it (reference
    SpillableColumnarBatch.scala)."""

    def __init__(self, batch: ColumnarBatch,
                 fw: Optional["SpillFramework"] = None):
        self.fw = fw or get_spill_framework()
        self.handle = self.fw.register(batch)

    def get_batch(self) -> ColumnarBatch:
        return self.handle.get()

    @property
    def size(self) -> int:
        return self.handle.size

    @property
    def tier(self) -> str:
        return self.handle.tier

    def close(self) -> None:
        self.handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_GLOBAL: Optional[SpillFramework] = None
_GLOBAL_LOCK = threading.Lock()


def get_spill_framework(conf=None, device=None) -> SpillFramework:
    """The process-wide framework. When a conf is passed (each session's
    collect does, with its device), the budgets are re-synced so a later
    session's settings are not silently ignored."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        existing = _GLOBAL
    if conf is None and existing is not None:
        return existing
    if conf is None:
        conf = C.session_conf()
    budget = device_budget_from(conf, device)
    sd = conf.get(C.SPILL_DIR) or None
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = SpillFramework(budget, conf.get(C.HOST_SPILL_LIMIT),
                                     spill_dir=sd)
            return _GLOBAL
        fw = _GLOBAL
        fw.device_budget = budget
        fw.host_budget = conf.get(C.HOST_SPILL_LIMIT)
        if sd:
            fw.spill_dir = sd
    # a lowered budget takes effect now, not at the next registration:
    # the largest handles spill until the registered bytes fit it (the
    # JAX package applies it at the next register or reserve)
    if fw.device_bytes_held() > fw.device_budget:
        fw.reserve(0, best_effort=True)
    return fw


def device_budget_from(conf, device=None) -> int:
    """min(budgetBytes, allocFraction x the card's memory) for a session
    on a card; budgetBytes on the CPU."""
    budget = int(conf.get(C.DEVICE_MEMORY_BUDGET))
    if device is not None and torch.device(device).type == "cuda":
        total = torch.cuda.mem_get_info(torch.device(device))[1]
        budget = min(budget, int(total * float(
            conf.get(C.DEVICE_MEMORY_FRACTION))))
    return budget


def peek_spill_framework() -> Optional[SpillFramework]:
    """The process framework without creating (or re-syncing) one."""
    return _GLOBAL


def reset_spill_framework() -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
