"""Always-on flight recorder: bounded per-thread rings, dump-on-trigger
(counterpart of ``spark_rapids_tpu/runtime/obs/flight.py``).

The retroactive half of tracing: the interesting queries are the ones
nobody thought to trace. Structured tracing (runtime/trace.py) is opt-in
and off by default, so a production failure produces counters but no
timeline. This module keeps a small, bounded, process-wide ring of the
most recent span/instant events, fed from the SAME instrumentation
points trace.py owns (``TorchExec.span``, the module instants), and dumps
it as a Chrome-trace file when something goes wrong: a query fails,
degrades or is cancelled, the dispatch watchdog reports a wedge, the
circuit breaker opens, or a query breaches its SLO
(runtime/obs/slo.py).

Overhead discipline:

- recorder off (``spark.rapids.obs.flight.enabled=false``): every hook
  in trace.py is one module-global read (``_REC is None``) past the
  tracer check;
- recorder on (the default): NO locks on the hot path. Each thread owns
  a private fixed-size ring (a preallocated list + wrap index) reached
  through a thread-local; the only lock is taken once per thread at ring
  creation and around dump bookkeeping. A recorded event is one tuple
  store + one integer increment, on the host: nothing reads the card.
  DEBUG-level spans/instants are filtered out so they cannot flush the
  interesting MODERATE events from a small ring.

Dumps are rate-limited (``minIntervalSeconds``) and retained bounded
(``maxDumps``), so a failure storm cannot fill the disk. A dump is a
snapshot: writer threads keep appending while it is taken (slot stores
are atomic tuple swaps under the GIL), so an event is either fully
present or fully absent. ``dump`` never raises.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch import config as _Cf
from spark_rapids_tpu_torch.analysis import sanitizer as _san
# cross-thread query correlation: every ring entry captures the
# submitting thread's bound query id (one thread-local read)
from spark_rapids_tpu_torch.runtime.obs import live as _live
# per-request tail sampling rides the same entry point: an event landing
# in the flight ring also lands in the bound request's ring
# (reqtrace._REC is None when reqtrace is off: one module-global read)
from spark_rapids_tpu_torch.runtime.obs import reqtrace as _reqtrace

log = logging.getLogger("spark_rapids_tpu_torch")

#: THE enabled flag: None = recorder off, every trace.py hook returns
#: after one module-global read.
_REC: "Optional[FlightRecorder]" = None
_STATE_LOCK = _san.lock("obs.flight.state")


class _Ring:
    """One thread's event ring: preallocated slots + a monotonic write
    index. Single-writer (the owning thread); the dumper reads racily —
    each slot holds an immutable tuple, so a concurrent overwrite yields
    the old or the new event, never garbage."""

    __slots__ = ("buf", "idx", "cap", "tid", "label")

    def __init__(self, cap: int, tid: int, label: str):
        self.buf: List[Optional[tuple]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.tid = tid
        self.label = label


class _FlightSpan:
    """The hot-path span when tracing is off but the recorder is on:
    times the block ONCE, feeds the paired GpuMetric (the same
    NvtxWithMetrics contract trace._Span honors) and stores one ring
    entry."""

    __slots__ = ("rec", "name", "cat", "metric", "t0")

    def __init__(self, rec: "FlightRecorder", name: str, metric, cat: str):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.metric = metric

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        m = self.metric
        if m is not None:
            m.add(dur)
        self.rec.record(self.name, self.cat, self.t0, dur)
        return False


class FlightRecorder:
    """Process-wide recorder: per-thread rings + the dump machinery."""

    def __init__(self, capacity: int = 2048,
                 out_dir: str = _Cf.OBS_FLIGHT_PATH.default,
                 min_interval_s: float = 5.0,
                 max_dumps: int = 50):
        self.capacity = max(16, int(capacity))
        self.out_dir = out_dir
        self.min_interval_s = float(min_interval_s)
        self.max_dumps = max(1, int(max_dumps))
        self.pid = os.getpid()
        self._t0 = time.perf_counter_ns()
        self._wall0 = time.time()
        self._lock = _san.lock("obs.flight.rings")
        self._tls = threading.local()
        self._rings: List[_Ring] = []
        self._seq = 0
        self._last_dump_mono = 0.0
        self.dumps = 0
        #: {"path","reason","unix","query_id"} of the most recent dump
        self.last_dump: Optional[dict] = None

    # -- hot path ----------------------------------------------------------

    def _new_ring(self) -> _Ring:
        t = threading.current_thread()
        r = _Ring(self.capacity, (t.ident or 0) & 0x7FFFFFFF, t.name)
        with self._lock:
            self._rings.append(r)
        self._tls.ring = r
        return r

    def span(self, name: str, metric, cat: str) -> _FlightSpan:
        return _FlightSpan(self, name, metric, cat)

    def record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
               args: Optional[dict] = None) -> None:
        """Store one complete event (dur_ns >= 0) or instant (dur_ns < 0)
        in this thread's ring, tagged with the thread's bound query id.
        Lock-free."""
        try:
            r = self._tls.ring
        except AttributeError:
            r = self._new_ring()
        qid = _live.current_query_id()
        r.buf[r.idx % r.cap] = (name, cat, t0_ns, dur_ns, args, qid)
        r.idx += 1
        rr = _reqtrace._REC
        if rr is not None:
            rr.feed(name, cat, t0_ns, dur_ns, args, qid)

    def instant(self, name: str, cat: str,
                args: Optional[dict] = None) -> None:
        self.record(name, cat, time.perf_counter_ns(), -1, args)

    # -- dump --------------------------------------------------------------

    def _ts_us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1000.0

    def dump(self, reason: str, query_id: Optional[int] = None,
             error: Optional[str] = None) -> Optional[str]:
        """Snapshot every ring into a Chrome-trace file
        ``flight_<seq>_<reason>.json`` under out_dir. Returns the path,
        or None when rate-limited. File I/O happens outside the lock;
        bookkeeping re-locks after the write."""
        now = time.monotonic()
        with self._lock:
            if self.min_interval_s > 0 and self._last_dump_mono and \
                    now - self._last_dump_mono < self.min_interval_s:
                return None
            prev_mono = self._last_dump_mono
            self._last_dump_mono = now
            self._seq += 1
            seq = self._seq
            rings = list(self._rings)
        events: List[dict] = []
        dropped = 0
        for r in rings:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": self.pid, "tid": r.tid,
                           "args": {"name": r.label}})
            dropped += max(r.idx - r.cap, 0)
            for ev in list(r.buf):
                if ev is None:
                    continue
                name, cat, t0_ns, dur_ns, args, qid = ev
                if dur_ns < 0:
                    doc = {"ph": "i", "name": name, "cat": cat,
                           "pid": self.pid, "tid": r.tid,
                           "ts": self._ts_us(t0_ns), "s": "t"}
                else:
                    doc = {"ph": "X", "name": name, "cat": cat,
                           "pid": self.pid, "tid": r.tid,
                           "ts": self._ts_us(t0_ns),
                           "dur": dur_ns / 1000.0}
                if args or qid is not None:
                    a = dict(args) if args else {}
                    if qid is not None:
                        a["query_id"] = qid
                    doc["args"] = a
                events.append(doc)
        # the resource time-series leading up to the trigger: every
        # sampler ring as a counter track, aligned to this recorder's
        # clock (runtime/obs/sampler.py) — a post-mortem then shows
        # memory/semaphore/queue pressure UNDER the event timeline
        try:
            from spark_rapids_tpu_torch.runtime.obs import sampler as _sampler
            events.extend(_sampler.chrome_events(self._t0, self.pid))
        except Exception:  # noqa: BLE001 - the dump must not need the
            pass  # sampler
        events.sort(key=lambda e: e.get("ts", -1.0))
        trigger = {"reason": reason}
        if query_id is not None:
            trigger["query_id"] = query_id
        if error:
            trigger["error"] = error
        events.append({"ph": "i", "name": "flightTrigger", "cat": "flight",
                       "pid": self.pid, "tid": 0,
                       "ts": self._ts_us(time.perf_counter_ns()),
                       "s": "g", "args": trigger})
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "reason": reason,
                "query_id": query_id,
                "error": error,
                "dumped_unix": time.time(),
                "recorder_start_unix": self._wall0,
                "dropped_events": dropped,
                "ring_capacity": self.capacity,
                "producer": "spark_rapids_tpu_torch.runtime.obs.flight",
            },
        }
        path = os.path.join(self.out_dir,
                            f"flight_{seq:04d}_{reason}.json")
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
        except BaseException:
            # nothing was written: disarm the rate limiter so the NEXT
            # trigger (after the operator frees disk, say) may dump —
            # a failed write must not eat the interval
            with self._lock:
                self._last_dump_mono = prev_mono
            raise
        self._prune_dumps()
        info = {"path": path, "reason": reason, "unix": time.time(),
                "query_id": query_id}
        with self._lock:
            self.dumps += 1
            self.last_dump = info
        _count_dump(reason)
        return path

    def _prune_dumps(self) -> None:
        """Bounded retention: keep the newest max_dumps flight files (a
        failure storm must not fill the disk)."""
        def seq_of(name: str) -> int:
            # numeric, NOT lexicographic: past seq 9999 the :04d pad
            # overflows and "flight_10000_..." would sort before
            # "flight_9999_...", deleting the newest dump
            try:
                return int(name.split("_")[1])
            except (IndexError, ValueError):
                return -1

        try:
            names = sorted((n for n in os.listdir(self.out_dir)
                            if n.startswith("flight_")
                            and n.endswith(".json")), key=seq_of)
        except OSError:
            return
        for name in names[:-self.max_dumps]:
            try:
                os.unlink(os.path.join(self.out_dir, name))
            except OSError:
                continue  # a concurrent prune already removed it

    def doc(self) -> dict:
        """The /healthz flight document."""
        with self._lock:
            return {"enabled": True, "ring_capacity": self.capacity,
                    "threads": len(self._rings), "dumps": self.dumps,
                    "last_dump": dict(self.last_dump)
                    if self.last_dump else None}


def _count_dump(reason: str) -> None:
    """Obs counter for one written dump. Never raises; never under the
    recorder lock."""
    try:
        from spark_rapids_tpu_torch.runtime import obs
        st = obs.state()
        if st is not None:
            st.registry.counter(
                "rapids_flight_dumps_total",
                "Flight-recorder dumps written, by trigger",
                labels={"reason": reason}).inc()
    except Exception:  # noqa: BLE001 - the recorder must not need obs
        pass


# ---------------------------------------------------------------------------
# module API (what trace.py / session.py / watchdog.py call)
# ---------------------------------------------------------------------------

def recorder() -> Optional[FlightRecorder]:
    return _REC


def maybe_install(conf) -> Optional[FlightRecorder]:
    """Install the process-wide recorder from a session conf (idempotent;
    first installer wins, like the obs registry and the tracer)."""
    global _REC
    if not conf.get(_Cf.OBS_FLIGHT_ENABLED):
        return _REC
    with _STATE_LOCK:
        if _REC is None:
            _REC = FlightRecorder(
                capacity=int(conf.get(_Cf.OBS_FLIGHT_EVENTS)),
                out_dir=conf.get(_Cf.OBS_FLIGHT_PATH)
                or _Cf.OBS_FLIGHT_PATH.default,
                min_interval_s=float(
                    conf.get(_Cf.OBS_FLIGHT_MIN_INTERVAL_S)),
                max_dumps=int(conf.get(_Cf.OBS_FLIGHT_MAX_DUMPS)))
        return _REC


def install(capacity: int = 2048,
            out_dir: str = _Cf.OBS_FLIGHT_PATH.default,
            min_interval_s: float = 0.0,
            max_dumps: int = 50) -> FlightRecorder:
    """Explicit install (tests, smokes): replaces any existing recorder."""
    global _REC
    rec = FlightRecorder(capacity=capacity, out_dir=out_dir,
                         min_interval_s=min_interval_s,
                         max_dumps=max_dumps)
    with _STATE_LOCK:
        _REC = rec
    return rec


def uninstall_for_tests() -> None:
    """Drop the recorder (tests: rings and rate-limit state must not
    leak across tests)."""
    global _REC
    with _STATE_LOCK:
        _REC = None


def instant(name: str, cat: str = "flight",
            args: Optional[dict] = None) -> None:
    rec = _REC
    if rec is not None:
        rec.instant(name, cat, args)


def dump(reason: str, query_id: Optional[int] = None,
         error: Optional[str] = None) -> Optional[str]:
    """Dump the rings if a recorder is installed. Never raises — a
    failing dump must not mask the failure that triggered it."""
    rec = _REC
    if rec is None:
        return None
    try:
        return rec.dump(reason, query_id=query_id, error=error)
    except Exception:  # noqa: BLE001 - observability never fails a query
        log.warning("flight-recorder dump failed (reason=%s)", reason,
                    exc_info=True)
        return None


def doc() -> Optional[dict]:
    """The /healthz flight document (None when the recorder is off)."""
    rec = _REC
    return rec.doc() if rec is not None else None
