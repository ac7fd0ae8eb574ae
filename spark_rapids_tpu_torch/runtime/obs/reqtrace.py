"""Per-request tail-sampled tracing: W3C context, request rings, verdicts
(counterpart of ``spark_rapids_tpu/runtime/obs/reqtrace.py``).

The flight recorder (runtime/obs/flight.py) answers "what was this
PROCESS doing when something broke"; this module answers the serving
question: "why was THIS request slow, on WHICH replica, and in WHICH
phase". Every POST /sql request carries (or mints) a W3C
``traceparent``; a :class:`RequestContext` binds it thread-locally and
rides the conf/query-id propagation seams (task waves, pool submits,
pipeline refills: runtime/host_pool.py), so every span the engine emits
for the request's query lands in the request's OWN bounded ring next to
the serving layer's span tree (intake, admission wait, warm-boot gate,
cache lookup, single-flight wait, execute, Arrow serialize: the
``REQUEST_SPANS`` roster).

**Tail-based sampling.** The ring buffers unconditionally (flight-ring
discipline: preallocated slots, one tuple store per event, no locks on
the hot path, one module-global read when disabled); the keep/drop
decision happens at request END, when the outcome is known (the
``VERDICTS`` roster): errors, cancellations, deadlines, SLO breaches and
runs slower than the digest baseline are ALWAYS kept; ordinary requests
(hot cache hits included) keep at ``spark.rapids.obs.reqtrace.
sampleRatio``. A kept request exports a self-contained per-request
timeline (a Chrome-trace file and an OTLP-JSON-shaped sibling) under
``reqtrace.path``, rate-limited (sampled keeps only; the always-keep
verdicts bypass the interval) and retention-pruned like flight dumps.
Exemplars on the latency histograms (runtime/obs/registry.py) link each
bucket to the trace_id and export path of a request that landed in it.

Every span here times the host: an engine span covers what its thread
spent issuing the batch's work to the card, not the kernels' device
time. Nothing in this module reads the card.

Overhead: disabled is one module-global read at each feed site; armed
is one thread-local read, one tuple store and one integer increment per
event.
"""
from __future__ import annotations

import json
import logging
import os
import random
import tempfile
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime.obs import live as _live

log = logging.getLogger("spark_rapids_tpu_torch")

_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "rapids_tpu_reqtrace")

#: The serving span-name roster: every ``request_span("...")`` literal
#: in the serving layer names one of these.
REQUEST_SPANS: Dict[str, str] = {
    "intake": "the whole request inside the server: bounded-intake "
              "admission through response-doc construction",
    "admission_wait": "parked in the lifecycle admission gate "
                      "(spark.rapids.query.maxConcurrent) before the "
                      "query may execute",
    "warm_boot_wait": "first-request wait for the replica's AOT warmup "
                      "replay (serving.warmBoot.timeoutSeconds)",
    "cache_lookup": "result-cache key computation + consultation "
                    "(plan digest x table epoch x conf fingerprint)",
    "single_flight_wait": "parked behind another request's in-flight "
                          "execution of the same cache key",
    "execute": "the query's own top-level action (sess.collect) — "
               "engine exec spans nest under this phase",
    "serialize": "Arrow IPC stream serialization of the result table",
}

#: The sampling-verdict roster: every verdict literal the recorder can
#: land. All but ``dropped`` export a timeline.
VERDICTS: Dict[str, str] = {
    "error": "the request failed (HTTP 500 class) — always kept",
    "cancelled": "the query's cancel token fired (user/HTTP/fault) — "
                 "always kept",
    "deadline": "the deadline sweeper cancelled the query "
                "(timeoutSeconds) — always kept",
    "slo_breach": "the query breached its SLO (runtime/obs/slo.py) — "
                  "always kept",
    "slow_vs_baseline": "wall time exceeded the digest's history "
                        "baseline mean x TAIL_FACTOR without breaching "
                        "the SLO — always kept",
    "sampled": "an ordinary request (bad-request/rejected/ok, hot "
               "cache hits included) kept by the sampleRatio draw",
    "dropped": "an ordinary request not selected by the draw — the "
               "ring is discarded, nothing is written",
}

#: Multiplier over the per-digest baseline mean for the
#: ``slow_vs_baseline`` always-keep verdict (below the SLO's
#: baselineFactor, so the tail between "slower than usual" and "breach"
#: still exports).
TAIL_FACTOR = 2.0

#: THE enabled flag: None = reqtrace off, every feed site returns after
#: one module-global read.
_REC: "Optional[ReqTraceRecorder]" = None
_STATE_LOCK = _san.lock("obs.reqtrace.state")

#: id minting (trace_id / span_id); process-seeded — ids only need
#: uniqueness, not reproducibility
_RNG = random.Random()
_RNG_LOCK = _san.lock("obs.reqtrace.ids")


def _hex(bits: int) -> str:
    with _RNG_LOCK:
        return f"{_RNG.getrandbits(bits):0{bits // 4}x}"


def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """Parse a W3C traceparent header. Returns (trace_id, parent_span_id,
    flags) or None when absent/malformed (the caller then mints)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if ver == "ff" or tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid, flags


class RequestContext:
    """One serving request's distributed-tracing state: W3C identity +
    the bounded event ring. Bound thread-locally (live.bind_request) and
    propagated across task waves / pool submits / pipeline refills by
    the host pool's capture-rebind seams; writer threads store racily
    into the shared ring (immutable tuples — an overwrite yields the old
    or the new event, never garbage; concurrent index bumps may drop an
    event, which the export reports in its dropped count)."""

    __slots__ = ("trace_id", "parent_span_id", "span_id", "flags",
                 "honored", "replica_id", "buf", "idx", "cap",
                 "t0_ns", "wall0", "query_id", "slo_breach")

    def __init__(self, cap: int, replica_id: str,
                 traceparent: Optional[str] = None):
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            self.trace_id, self.parent_span_id, self.flags = parsed
            self.honored = True
        else:
            self.trace_id = _hex(128)
            self.parent_span_id = None
            self.flags = "01"
            self.honored = False
        #: this request's root (serving) span id — the parent every
        #: serving phase span and the outgoing traceparent carry
        self.span_id = _hex(64)
        self.replica_id = replica_id
        self.buf: List[Optional[tuple]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.t0_ns = time.perf_counter_ns()
        self.wall0 = time.time()
        #: the live query id of this request's top-level action (stamped
        #: by the obs epilogue once known — the serving<->exec join key)
        self.query_id: Optional[int] = None
        #: did this request's query breach its SLO (stamped by the obs
        #: epilogue, which owns the breach check)
        self.slo_breach = False

    def traceparent(self) -> str:
        """The outgoing W3C header (this request's root span as parent)."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
               args: Optional[dict], qid, tid: int) -> None:
        self.buf[self.idx % self.cap] = (name, cat, t0_ns, dur_ns, args,
                                         qid, tid)
        self.idx += 1


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _ReqSpan:
    """A serving-phase span: times the block once and stores one ring
    entry in the bound request's ring (cat ``serving``)."""

    __slots__ = ("ctx", "name", "t0")

    def __init__(self, ctx: RequestContext, name: str):
        self.ctx = ctx
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ctx.record(self.name, "serving", self.t0,
                        time.perf_counter_ns() - self.t0, None,
                        self.ctx.query_id,
                        threading.get_ident() & 0x7FFFFFFF)
        return False


class _HookSpan:
    """The engine-span fallback when the flight recorder is off but
    reqtrace is armed (trace.py's metric_span/exec_span/span hand out
    this instead of the bare metric timer): times the block once, feeds
    the paired GpuMetric, and feeds the request ring."""

    __slots__ = ("rec", "name", "cat", "metric", "t0")

    def __init__(self, rec: "ReqTraceRecorder", name: str, metric,
                 cat: str):
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
        self.rec.feed(self.name, self.cat, self.t0, dur, None,
                      _live.current_query_id())
        return False


class ReqTraceRecorder:
    """Process-wide per-request recorder: context minting, the feed hot
    path, the end-of-request verdict, and the export machinery."""

    def __init__(self, capacity: int = 4096,
                 out_dir: str = _DEFAULT_DIR,
                 sample_ratio: float = 0.01,
                 min_interval_s: float = 1.0,
                 max_dumps: int = 100,
                 replica_id: str = "",
                 sample_seed: Optional[int] = None):
        self.capacity = max(64, int(capacity))
        self.out_dir = out_dir
        self.sample_ratio = max(0.0, min(1.0, float(sample_ratio)))
        self.min_interval_s = float(min_interval_s)
        self.max_dumps = max(1, int(max_dumps))
        self.replica_id = replica_id or f"pid-{os.getpid()}"
        self.pid = os.getpid()
        self._t0 = time.perf_counter_ns()
        self._wall0 = time.time()
        self._lock = _san.lock("obs.reqtrace.recorder")
        self._rng = random.Random(sample_seed)
        self._seq = 0
        self._last_export_mono = 0.0
        self.exports = 0
        self.dropped = 0
        self.rate_limited = 0
        #: {"path","verdict","trace_id","unix"} of the most recent export
        self.last_export: Optional[dict] = None

    # -- hot path ----------------------------------------------------------

    def begin(self, traceparent: Optional[str] = None) -> RequestContext:
        """Mint (or adopt) this request's context. The caller binds it
        (live.bind_request) for the request's whole handler scope."""
        return RequestContext(self.capacity, self.replica_id,
                              traceparent=traceparent)

    def feed(self, name: str, cat: str, t0_ns: int, dur_ns: int,
             args: Optional[dict], qid) -> None:
        """Store one event in the bound request's ring (no request bound:
        return after one thread-local read). Lock-free."""
        ctx = _live.current_request()
        if ctx is None:
            return
        ctx.record(name, cat, t0_ns, dur_ns, args, qid,
                   threading.get_ident() & 0x7FFFFFFF)

    def span(self, name: str, metric, cat: str) -> _HookSpan:
        return _HookSpan(self, name, metric, cat)

    def request_span(self, ctx: RequestContext, name: str) -> _ReqSpan:
        return _ReqSpan(ctx, name)

    # -- verdict -----------------------------------------------------------

    def decide(self, *, status: str,
               cancel_reason: Optional[str] = None,
               slo_breach: bool = False,
               slow_vs_baseline: bool = False,
               draw: Optional[float] = None) -> str:
        """The tail-sampling verdict for one finished request. Always-
        keep classes first; everything else rides the sampleRatio draw
        (injectable for tests)."""
        if status == "failed":
            return _v("error")
        if status == "cancelled":
            if cancel_reason == "deadline":
                return _v("deadline")
            return _v("cancelled")
        if slo_breach:
            return _v("slo_breach")
        if slow_vs_baseline:
            return _v("slow_vs_baseline")
        if draw is None:
            draw = self._rng.random()
        if self.sample_ratio > 0 and draw < self.sample_ratio:
            return _v("sampled")
        return _v("dropped")

    def end(self, ctx: RequestContext, *, status: str,
            cancel_reason: Optional[str] = None,
            slo_breach: bool = False,
            slow_vs_baseline: bool = False,
            error: Optional[str] = None,
            cache_outcome: Optional[str] = None,
            wall_ms: Optional[float] = None,
            draw: Optional[float] = None) -> dict:
        """Land the verdict for one finished request: drop the ring or
        export the timeline pair. Returns {"verdict","kept","path",
        "otlp_path","trace_id"} (paths None when dropped or
        rate-limited). Never raises."""
        verdict = self.decide(status=status, cancel_reason=cancel_reason,
                              slo_breach=slo_breach,
                              slow_vs_baseline=slow_vs_baseline,
                              draw=draw)
        out = {"verdict": verdict, "kept": verdict != "dropped",
               "trace_id": ctx.trace_id, "path": None, "otlp_path": None}
        if verdict == "dropped":
            with self._lock:
                self.dropped += 1
            _count_verdict(verdict)
            return out
        try:
            paths = self._export(ctx, verdict, status=status,
                                 error=error,
                                 cache_outcome=cache_outcome,
                                 wall_ms=wall_ms)
        except Exception:  # noqa: BLE001 - observability never fails a
            log.warning("reqtrace export failed (verdict=%s)", verdict,
                        exc_info=True)  # request
            paths = None
        if paths is not None:
            out["path"], out["otlp_path"] = paths
        _count_verdict(verdict)
        return out

    # -- export ------------------------------------------------------------

    def _ts_us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1000.0

    def _unix_ns(self, t_ns: int) -> int:
        return int(self._wall0 * 1e9) + (t_ns - self._t0)

    def _export(self, ctx: RequestContext, verdict: str, *,
                status: str, error: Optional[str],
                cache_outcome: Optional[str],
                wall_ms: Optional[float]) -> Optional[tuple]:
        """Write the Chrome-trace + OTLP-JSON pair. Sampled keeps are
        rate-limited (min_interval_s); always-keep verdicts bypass the
        limit — retention pruning bounds disk either way. File I/O
        happens outside the lock."""
        now = time.monotonic()
        with self._lock:
            if verdict == "sampled" and self.min_interval_s > 0 \
                    and self._last_export_mono \
                    and now - self._last_export_mono < self.min_interval_s:
                self.rate_limited += 1
                return None
            prev_mono = self._last_export_mono
            self._last_export_mono = now
            self._seq += 1
            seq = self._seq
        dur_ns = time.perf_counter_ns() - ctx.t0_ns
        events = list(ctx.buf)
        dropped = max(ctx.idx - ctx.cap, 0)
        meta = {
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_span_id": ctx.parent_span_id,
            "traceparent": ctx.traceparent(),
            "traceparent_honored": ctx.honored,
            "replica_id": ctx.replica_id,
            "query_id": ctx.query_id,
            "verdict": verdict,
            "status": status,
            "error": error,
            "cache": cache_outcome,
            "wall_ms": wall_ms,
            "request_start_unix": ctx.wall0,
            "dropped_events": dropped,
            "ring_capacity": ctx.cap,
            "producer": "spark_rapids_tpu_torch.runtime.obs.reqtrace",
        }
        base = os.path.join(
            self.out_dir,
            f"req_{seq:05d}_{verdict}_{ctx.trace_id[:8]}")
        chrome = base + ".json"
        otlp = base + ".otlp.json"
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(chrome, "w") as f:
                json.dump(self._chrome_doc(ctx, events, dur_ns, meta), f)
            with open(otlp, "w") as f:
                json.dump(self._otlp_doc(ctx, events, dur_ns), f)
        except BaseException:
            # nothing durable was written: disarm the rate limiter so
            # the NEXT request may export (a failed write must not eat
            # the interval)
            with self._lock:
                self._last_export_mono = prev_mono
            raise
        self._prune()
        info = {"path": chrome, "verdict": verdict,
                "trace_id": ctx.trace_id, "unix": time.time()}
        with self._lock:
            self.exports += 1
            self.last_export = info
        return chrome, otlp

    def _chrome_doc(self, ctx: RequestContext, events: List[tuple],
                    dur_ns: int, meta: dict) -> dict:
        out: List[dict] = []
        named = set()
        for ev in events:
            if ev is None:
                continue
            name, cat, t0_ns, ev_dur, args, qid, tid = ev
            if tid not in named:
                named.add(tid)
                out.append({"ph": "M", "name": "thread_name",
                            "pid": self.pid, "tid": tid,
                            "args": {"name": f"thread {tid}"}})
            if ev_dur < 0:
                doc = {"ph": "i", "name": name, "cat": cat,
                       "pid": self.pid, "tid": tid,
                       "ts": self._ts_us(t0_ns), "s": "t"}
            else:
                doc = {"ph": "X", "name": name, "cat": cat,
                       "pid": self.pid, "tid": tid,
                       "ts": self._ts_us(t0_ns), "dur": ev_dur / 1000.0}
            if args or qid is not None:
                a = dict(args) if args else {}
                if qid is not None:
                    a["query_id"] = qid
                doc["args"] = a
            out.append(doc)
        out.sort(key=lambda e: e.get("ts", -1.0))
        # the root request span spans the whole timeline, carrying the
        # W3C identity so the Chrome view alone identifies the request
        out.append({"ph": "X", "name": "request", "cat": "serving",
                    "pid": self.pid, "tid": 0,
                    "ts": self._ts_us(ctx.t0_ns),
                    "dur": dur_ns / 1000.0, "args": dict(meta)})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": meta}

    def _otlp_doc(self, ctx: RequestContext, events: List[tuple],
                  dur_ns: int) -> dict:
        """The OTLP-JSON-shaped sibling: resourceSpans carrying the
        replica identity, one scope, the request root span, and every
        ring event as a child span (serving phases parent on the root;
        engine events parent on the ``execute`` phase when one exists)."""

        def attr(key, value):
            if isinstance(value, bool):
                return {"key": key, "value": {"boolValue": value}}
            if isinstance(value, int):
                return {"key": key, "value": {"intValue": str(value)}}
            return {"key": key, "value": {"stringValue": str(value)}}

        spans: List[dict] = []
        exec_span_id = None
        prepared = []
        for ev in events:
            if ev is None:
                continue
            name, cat, t0_ns, ev_dur, args, qid, tid = ev
            sid = _hex(64)
            if cat == "serving" and name == "execute" and ev_dur >= 0:
                exec_span_id = sid
            prepared.append((sid, name, cat, t0_ns, ev_dur, args, qid))
        for sid, name, cat, t0_ns, ev_dur, args, qid in prepared:
            parent = ctx.span_id if cat == "serving" \
                else (exec_span_id or ctx.span_id)
            end_ns = t0_ns + max(ev_dur, 0)
            sp = {
                "traceId": ctx.trace_id,
                "spanId": sid,
                "parentSpanId": parent,
                "name": name,
                "kind": 1,
                "startTimeUnixNano": str(self._unix_ns(t0_ns)),
                "endTimeUnixNano": str(self._unix_ns(end_ns)),
                "attributes": [attr("category", cat)],
            }
            if qid is not None:
                sp["attributes"].append(attr("query_id", qid))
            for k, v in (args or {}).items():
                sp["attributes"].append(attr(k, v))
            spans.append(sp)
        root = {
            "traceId": ctx.trace_id,
            "spanId": ctx.span_id,
            "name": "POST /sql",
            "kind": 2,
            "startTimeUnixNano": str(self._unix_ns(ctx.t0_ns)),
            "endTimeUnixNano": str(self._unix_ns(ctx.t0_ns + dur_ns)),
            "attributes": [attr("replica_id", ctx.replica_id)],
        }
        if ctx.parent_span_id:
            root["parentSpanId"] = ctx.parent_span_id
        if ctx.query_id is not None:
            root["attributes"].append(attr("query_id", ctx.query_id))
        return {"resourceSpans": [{
            "resource": {"attributes": [
                attr("service.name", "spark-rapids-tpu-torch"),
                attr("service.instance.id", ctx.replica_id),
            ]},
            "scopeSpans": [{
                "scope": {"name":
                          "spark_rapids_tpu_torch.runtime.obs.reqtrace"},
                "spans": [root] + spans,
            }],
        }]}

    def _prune(self) -> None:
        """Bounded retention: keep the newest max_dumps export pairs
        (numeric seq sort — the flight discipline)."""
        def seq_of(name: str) -> int:
            try:
                return int(name.split("_")[1])
            except (IndexError, ValueError):
                return -1

        try:
            names = [n for n in os.listdir(self.out_dir)
                     if n.startswith("req_") and n.endswith(".json")]
        except OSError:
            return
        seqs = sorted({seq_of(n) for n in names})
        for s in seqs[:-self.max_dumps]:
            for n in names:
                if seq_of(n) == s:
                    try:
                        os.unlink(os.path.join(self.out_dir, n))
                    except OSError:
                        continue

    def doc(self) -> dict:
        """The /healthz reqtrace document."""
        with self._lock:
            return {"enabled": True, "replica_id": self.replica_id,
                    "sample_ratio": self.sample_ratio,
                    "exports": self.exports, "dropped": self.dropped,
                    "rate_limited": self.rate_limited,
                    "last_export": dict(self.last_export)
                    if self.last_export else None}


def _v(verdict: str) -> str:
    """Roster checkpoint for verdict literals: returns its argument,
    which must be a VERDICTS key."""
    return verdict


def _count_verdict(verdict: str) -> None:
    """Obs counter for one landed verdict. Never raises; never under the
    recorder lock."""
    try:
        from spark_rapids_tpu_torch.runtime import obs
        st = obs.state()
        if st is not None:
            st.registry.counter(
                "rapids_reqtrace_verdicts_total",
                "Per-request tail-sampling verdicts landed, by verdict",
                labels={"verdict": verdict}).inc()
    except Exception:  # noqa: BLE001 - the recorder must not need obs
        pass


# ---------------------------------------------------------------------------
# module API (what serving/server.py, trace.py and flight.py call)
# ---------------------------------------------------------------------------

def recorder() -> Optional[ReqTraceRecorder]:
    return _REC


def maybe_install(conf,
                  replica_id: str = "") -> Optional[ReqTraceRecorder]:
    """Install the process-wide recorder from a session conf (idempotent;
    first installer wins, like the flight recorder)."""
    global _REC
    from spark_rapids_tpu_torch import config as Cf
    if not conf.get(Cf.OBS_REQTRACE_ENABLED):
        return _REC
    with _STATE_LOCK:
        if _REC is None:
            _REC = ReqTraceRecorder(
                capacity=int(conf.get(Cf.OBS_REQTRACE_EVENTS)),
                out_dir=conf.get(Cf.OBS_REQTRACE_PATH)
                or _DEFAULT_DIR,
                sample_ratio=float(
                    conf.get(Cf.OBS_REQTRACE_SAMPLE_RATIO)),
                min_interval_s=float(
                    conf.get(Cf.OBS_REQTRACE_MIN_INTERVAL_S)),
                max_dumps=int(conf.get(Cf.OBS_REQTRACE_MAX_DUMPS)),
                replica_id=replica_id
                or conf.get(Cf.OBS_REPLICA_ID) or "")
        return _REC


def install(capacity: int = 4096,
            out_dir: str = _DEFAULT_DIR,
            sample_ratio: float = 1.0,
            min_interval_s: float = 0.0,
            max_dumps: int = 100,
            replica_id: str = "",
            sample_seed: Optional[int] = None) -> ReqTraceRecorder:
    """Explicit install (tests, smokes): replaces any existing recorder."""
    global _REC
    rec = ReqTraceRecorder(capacity=capacity, out_dir=out_dir,
                           sample_ratio=sample_ratio,
                           min_interval_s=min_interval_s,
                           max_dumps=max_dumps, replica_id=replica_id,
                           sample_seed=sample_seed)
    with _STATE_LOCK:
        _REC = rec
    return rec


def uninstall_for_tests() -> None:
    """Drop the recorder (tests: contexts and rate-limit state must not
    leak across tests)."""
    global _REC
    with _STATE_LOCK:
        _REC = None


def begin_request(
        traceparent: Optional[str] = None) -> Optional[RequestContext]:
    """Mint this request's context (None when reqtrace is off — the
    serving layer then skips binding entirely)."""
    rec = _REC
    if rec is None:
        return None
    return rec.begin(traceparent)


def end_request(ctx: Optional[RequestContext], **kw) -> Optional[dict]:
    """Land the verdict for one finished request (no-op when reqtrace is
    off or the request never got a context)."""
    rec = _REC
    if rec is None or ctx is None:
        return None
    return rec.end(ctx, **kw)


def request_span(name: str):
    """A serving-phase span over the bound request (one module-global
    read + one thread-local read when disabled/unbound). ``name`` must
    be a REQUEST_SPANS roster key."""
    rec = _REC
    if rec is None:
        return _NULL
    ctx = _live.current_request()
    if ctx is None:
        return _NULL
    return _ReqSpan(ctx, name)


def doc() -> Optional[dict]:
    """The /healthz reqtrace document (None when the recorder is off)."""
    rec = _REC
    return rec.doc() if rec is not None else None
