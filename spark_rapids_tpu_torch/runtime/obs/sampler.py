"""Resource time-series sampler: bounded rings of live engine gauges
(counterpart of ``spark_rapids_tpu/runtime/obs/sampler.py``).

The /metrics gauges answer "what is the pressure NOW?"; a post-mortem
needs "what was the pressure over the last two minutes LEADING UP to the
trigger?". This module runs ONE service thread (``spawn_service_thread``)
that every ``spark.rapids.obs.sampler.intervalMs`` samples the ``SERIES``
roster below into per-series bounded rings (the flight-recorder ring
discipline: preallocated slots + a wrap index, single writer, racy but
atomic tuple reads by dumpers and scrapers, no locks shared with query
hot paths).

Consumers:

- ``/metrics``: each series exports as a ``rapids_sampler_<name>``
  gauge reading the ring's newest sample;
- ``/console``: SVG sparklines;
- flight dumps: ``chrome_events()`` renders every ring as a Chrome
  trace counter track ("ph":"C"), embedded by ``flight.dump``;
- each tick also records the ids of the queries running at sample time
  (``runtime/obs/live.py``).

A tick reads ~10 in-process values and never the card: the device-bytes
series is the spill framework's registered-bytes ledger
(``runtime/memory.py``), not a CUDA runtime query, so the sampler adds
no device synchronization. The three serving series read 0 while the
serving layer (``runtime/serving``) is not installed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

#: The sampler-series roster: the collector table below must cover it
#: exactly (asserted at import).
SERIES: Dict[str, str] = {
    "device_bytes_held": "registered (spillable) device bytes held "
                         "(runtime/memory.py ledger)",
    "host_spill_bytes_held": "spilled bytes resident in the host store",
    "semaphore_available": "device-semaphore permits currently free",
    "semaphore_waiting": "tasks parked on the device semaphore",
    "host_pool_queue_tier0": "host-pool tier-0 tasks queued, not yet "
                             "running",
    "host_pool_queue_tier1": "host-pool tier-1 tasks queued, not yet "
                             "running",
    "pipeline_stalled_consumers": "pipeline consumers currently blocked "
                                  "waiting on a producer refill "
                                  "(runtime/pipeline.py)",
    "breaker_state": "device circuit-breaker state (0 closed, 1 "
                     "half-open, 2 open)",
    "process_rss_bytes": "process resident set size (/proc/self/statm)",
    "running_queries": "top-level queries currently in flight "
                       "(runtime/obs/live.py registry)",
    "serving_active_requests": "POST /sql requests inside the serving "
                               "layer (runtime/serving/; 0 when off)",
    "serving_queue_depth": "queries parked in the admission queue "
                           "behind spark.rapids.query.maxConcurrent",
    "serving_cache_hit_ratio": "serving result-cache hits / lookups "
                               "(0 until the first lookup)",
}


class _SeriesRing:
    """One series' bounded sample ring: preallocated slots + a
    monotonic write index. Single-writer (the sampler thread); readers
    copy racily — each slot holds an immutable tuple
    ``(t_ns, value, query_ids)``, so a concurrent overwrite yields the
    old or the new sample, never garbage."""

    __slots__ = ("buf", "idx", "cap")

    def __init__(self, cap: int):
        self.cap = max(8, int(cap))
        self.buf: List[Optional[tuple]] = [None] * self.cap
        self.idx = 0

    def append(self, sample: tuple) -> None:
        self.buf[self.idx % self.cap] = sample
        self.idx += 1

    def snapshot(self) -> List[tuple]:
        """Samples oldest-first (a racy copy; at most one sample torn
        ACROSS the list — individual slots never are)."""
        out = [s for s in list(self.buf) if s is not None]
        out.sort(key=lambda s: s[0])
        return out

    def latest(self) -> Optional[tuple]:
        if self.idx == 0:
            return None
        return self.buf[(self.idx - 1) % self.cap]


# -- collectors (one per SERIES entry; all in-process reads) ---------------

def _collect_device_bytes() -> float:
    from spark_rapids_tpu_torch.runtime import memory as MEM
    fw = MEM.peek_spill_framework()
    return float(fw.device_bytes_held()) if fw is not None else 0.0


def _collect_host_spill_bytes() -> float:
    from spark_rapids_tpu_torch.runtime import memory as MEM
    fw = MEM.peek_spill_framework()
    return float(fw.host_bytes_held()) if fw is not None else 0.0


def _collect_sem_available() -> float:
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    sem = SEM.peek_semaphore()
    return float(sem.available) if sem is not None else 0.0


def _collect_sem_waiting() -> float:
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    sem = SEM.peek_semaphore()
    return float(sem.waiting) if sem is not None else 0.0


def _collect_pool_depth(tier: str) -> Callable[[], float]:
    def read() -> float:
        from spark_rapids_tpu_torch.runtime import host_pool as HP
        pool = HP.current_pool()
        return float(pool.queue_depths().get(tier, 0)) if pool else 0.0
    return read


def _collect_pipeline_stalls() -> float:
    from spark_rapids_tpu_torch.runtime import pipeline as PL
    return float(PL.stalled_consumers())


def _collect_breaker_state() -> float:
    from spark_rapids_tpu_torch.runtime import watchdog as WD
    brk = WD.peek_breaker()
    if brk is None or brk.state == "closed":
        return 0.0
    return 2.0 if brk.state == "open" else 1.0


def _collect_rss() -> float:
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 - non-linux: RSS reads as 0
        return 0.0


def _collect_running_queries() -> float:
    from spark_rapids_tpu_torch.runtime.obs import live
    return float(live.running_count())


def _collect_serving_active() -> float:
    from spark_rapids_tpu_torch.runtime import serving as SRV
    srv = SRV.server()
    return float(srv._active) if srv is not None else 0.0


def _collect_serving_queue() -> float:
    from spark_rapids_tpu_torch.runtime import serving as SRV
    if SRV.server() is None:
        return 0.0
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    return float(LC.doc().get("queued", 0))


def _collect_serving_hit_ratio() -> float:
    from spark_rapids_tpu_torch.runtime import serving as SRV
    srv = SRV.server()
    if srv is None or srv.cache is None:
        return 0.0
    return float(srv.cache.stats()["hit_ratio"])


_COLLECTORS: Dict[str, Callable[[], float]] = {
    "device_bytes_held": _collect_device_bytes,
    "host_spill_bytes_held": _collect_host_spill_bytes,
    "semaphore_available": _collect_sem_available,
    "semaphore_waiting": _collect_sem_waiting,
    "host_pool_queue_tier0": _collect_pool_depth("tier0"),
    "host_pool_queue_tier1": _collect_pool_depth("tier1"),
    "pipeline_stalled_consumers": _collect_pipeline_stalls,
    "breaker_state": _collect_breaker_state,
    "process_rss_bytes": _collect_rss,
    "running_queries": _collect_running_queries,
    "serving_active_requests": _collect_serving_active,
    "serving_queue_depth": _collect_serving_queue,
    "serving_cache_hit_ratio": _collect_serving_hit_ratio,
}

# every roster series has exactly one collector (and nothing samples
# off-roster)
assert set(_COLLECTORS) == set(SERIES)


class ResourceSampler:
    """The process-wide sampler: one ring per series + the service
    thread driving them."""

    def __init__(self, interval_ms: int = 200, ring_size: int = 512):
        self.interval_s = max(0.01, int(interval_ms) / 1000.0)
        self.rings: Dict[str, _SeriesRing] = {
            name: _SeriesRing(ring_size) for name in SERIES}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        #: measured cost of the last sample_once
        self.last_tick_ns = 0

    # -- sampling ----------------------------------------------------------

    def sample_once(self) -> None:
        """Take one sample of every series (the loop body; tests and
        the smoke call it directly for deterministic ticks)."""
        t0 = time.perf_counter_ns()
        from spark_rapids_tpu_torch.runtime.obs import live
        qids = tuple(live.running_ids())
        for name, collect in _COLLECTORS.items():
            try:
                v = collect()
            except Exception:  # noqa: BLE001 - one dead collector must
                v = 0.0  # not stop the others or the loop
            self.rings[name].append((t0, v, qids))
        self.ticks += 1
        self.last_tick_ns = time.perf_counter_ns() - t0

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sampler must outlive
                pass  # any transient runtime state it reads

    def start(self) -> None:
        if self._thread is not None:
            return
        from spark_rapids_tpu_torch.runtime.host_pool import spawn_service_thread
        self._thread = spawn_service_thread(self._loop,
                                            name="rapids-obs-sampler")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # -- export ------------------------------------------------------------

    def latest(self) -> Dict[str, float]:
        out = {}
        for name, ring in self.rings.items():
            s = ring.latest()
            out[name] = s[1] if s is not None else 0.0
        return out

    def snapshot(self) -> Dict[str, List[tuple]]:
        """{series: [(t_ns, value, query_ids), ...]} oldest-first."""
        return {name: ring.snapshot() for name, ring in self.rings.items()}

    def chrome_events(self, t0_ns: int, pid: int) -> List[dict]:
        """Every ring as Chrome-trace counter events ("ph":"C") on a
        shared counter track, timestamped relative to t0_ns (the flight
        recorder's epoch, so the counters align with its spans)."""
        events: List[dict] = []
        for name, ring in self.rings.items():
            for t_ns, v, _qids in ring.snapshot():
                events.append({
                    "ph": "C", "name": f"sampler/{name}", "pid": pid,
                    "tid": 0, "ts": (t_ns - t0_ns) / 1000.0,
                    "args": {"value": v}})
        return events

    def doc(self) -> dict:
        """The /healthz sampler document."""
        return {"enabled": True,
                "interval_ms": round(self.interval_s * 1000.0, 1),
                "ring_size": next(iter(self.rings.values())).cap,
                "ticks": self.ticks,
                "last_tick_us": round(self.last_tick_ns / 1000.0, 1),
                "latest": self.latest()}


# ---------------------------------------------------------------------------
# module lifecycle (driven by obs.install / obs.shutdown_for_tests)
# ---------------------------------------------------------------------------

_SAMPLER: Optional[ResourceSampler] = None
_STATE_LOCK = _san.lock("obs.sampler.state")


def sampler() -> Optional[ResourceSampler]:
    return _SAMPLER


def maybe_install(conf) -> Optional[ResourceSampler]:
    """Install + start the process-wide sampler from a session conf
    (idempotent; first installer wins, like the flight recorder)."""
    global _SAMPLER
    from spark_rapids_tpu_torch import config as Cf
    if not conf.get(Cf.OBS_SAMPLER_ENABLED):
        return _SAMPLER
    with _STATE_LOCK:
        if _SAMPLER is None:
            _SAMPLER = ResourceSampler(
                interval_ms=int(conf.get(Cf.OBS_SAMPLER_INTERVAL_MS)),
                ring_size=int(conf.get(Cf.OBS_SAMPLER_RING)))
        s = _SAMPLER
    s.start()
    return s


def install(interval_ms: int = 200, ring_size: int = 512,
            start: bool = True) -> ResourceSampler:
    """Explicit install (tests, smokes): replaces any existing sampler
    (stopping its thread first)."""
    global _SAMPLER
    s = ResourceSampler(interval_ms=interval_ms, ring_size=ring_size)
    with _STATE_LOCK:
        old, _SAMPLER = _SAMPLER, s
    if old is not None:
        old.stop()
    if start:
        s.start()
    return s


def uninstall_for_tests() -> None:
    global _SAMPLER
    with _STATE_LOCK:
        s, _SAMPLER = _SAMPLER, None
    if s is not None:
        s.stop()


def chrome_events(t0_ns: int, pid: int) -> List[dict]:
    """Counter events of the installed sampler ([] when off) — what
    flight.dump embeds."""
    s = _SAMPLER
    if s is None:
        return []
    try:
        return s.chrome_events(t0_ns, pid)
    except Exception:  # noqa: BLE001 - a dump must never fail on its
        return []  # resource-context garnish


def doc() -> Optional[dict]:
    s = _SAMPLER
    return s.doc() if s is not None else None
