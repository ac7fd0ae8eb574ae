"""Structured tracing: spans, instant events, per-task event log
(counterpart of ``spark_rapids_tpu/runtime/trace.py``).

Reference parity: NvtxWithMetrics.scala (NVTX ranges tied to GpuMetrics —
entering a range optionally starts the paired metric timer, so the trace
and the SQL-UI metrics are ONE instrumentation point), profiler.scala /
Plugin.scala:442 (ProfilerOnExecutor: a built-in executor profiler writing
per-query artifacts under a configured directory), and GpuTaskMetrics
(per-task accumulators — retry/spill/semaphore times — consumed by the
offline spark-rapids-tools profiling report; tools/profiler_report.py is
that report's analog here).

Output format: Chrome trace-event JSON (Perfetto / chrome://tracing
loadable). One track per task thread (tid = task id while a TaskContext
is bound, thread ident otherwise, named by a thread_name metadata event),
complete events ("ph":"X") for spans, instant events ("ph":"i") for
semaphore acquire/release, spill (device→host→disk, bytes), retry and
split-retry, faults, cancels and the watchdog. While tracing is on, spans
also open a ``torch.profiler.record_function`` range (the JAX package's
``jax.profiler.TraceAnnotation``), so a ``torch.profiler`` capture around
a traced query shows the same operator names on its timeline.

The operator spans time the host: an exec's span covers what its thread
spent on the batch, CUDA launches enqueued rather than finished (see
``runtime/metrics.py``).

Overhead discipline: tracing is OFF by default and the off path is one
module-global read + branch per span — ``metric_span`` then returns the
GpuMetric's own timer (exactly the untraced hot path) and ``instant``
returns immediately. Levels reuse the metric levels (ESSENTIAL <
MODERATE < DEBUG): a span/instant above the configured level costs the
same as tracing off.

Config surface (spark.rapids.sql.trace.*): enabled, path, level,
taskMetrics — see config.py. The tracer's two locks are the sanitizer's
(``analysis/sanitizer.py``), and an exec span carries the operator's LORE
id (``runtime/lore.py``) when it has one.

The always-on flight recorder (``runtime/obs/flight.py``) shares these
instrumentation points: a span or instant the tracer is not consuming
(tracing off, or above the configured level) still lands in the bounded
per-thread ring unless it is DEBUG, so a failure can dump a retroactive
timeline; with the recorder off each hook costs one more module-global
read. The per-request tracer (``runtime/obs/reqtrace.py``) takes the
same events into a serving request's ring: through the flight recorder
when it is on, through these hooks when it is off. Traced events carry
the emitting thread's bound query id (``runtime/obs/live.py``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime.metrics import DEBUG, ESSENTIAL, MODERATE
# the flight recorder: _flight._REC is None when it is off
from spark_rapids_tpu_torch.runtime.obs import flight as _flight
from spark_rapids_tpu_torch.runtime.obs import live as _live
# per-request tail sampling (runtime/obs/reqtrace.py): with the flight
# recorder on, its record() feeds the bound request's ring, so the
# branches below cover only flight off + reqtrace on; off, one more
# module-global read per hook
from spark_rapids_tpu_torch.runtime.obs import reqtrace as _reqtrace

__all__ = ["DEBUG", "ESSENTIAL", "MODERATE", "Tracer", "active",
           "metric_span", "exec_span", "span", "instant", "emit_span",
           "on_task_complete", "start_query", "end_query"]

#: Names of the per-task accumulators rolled up into the event log
#: (the GpuTaskMetrics analog). semaphoreWaitTime is fed by the
#: semaphore itself; the rest by runtime/retry.py and runtime/memory.py.
TASK_METRIC_NAMES = (
    "semaphoreWaitTime", "semaphoreHoldTime",
    "retryCount", "splitAndRetryCount", "retryBlockTime",
    "retryWastedTime",
    "spillToHostBytes", "spillToDiskBytes",
    "spillToHostTime", "spillToDiskTime",
    "maxDeviceBytesHeld",
    "shuffleCorruptionRetries",
)

_TRACER: "Optional[Tracer]" = None
_STATE_LOCK = _san.lock("trace.state")
_QUERY_SEQ = 0


class _NullSpan:
    """Context manager for the disabled path when no metric is paired."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Tracer:
    """One query's trace: an in-memory event buffer (tasks append under a
    lock; writing files mid-query would serialize the hot path) finalized
    to <dir>/query_<id>_{trace.json,events.jsonl,metrics.json}."""

    def __init__(self, out_dir: str, level: int = MODERATE,
                 task_metrics: bool = True, query_id: int = 0):
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        self.out_dir = out_dir
        self.level = level
        self.task_metrics = task_metrics
        self.query_id = query_id
        self.pid = os.getpid()
        self._t0 = time.perf_counter_ns()
        self._wall0 = time.time()
        self._lock = _san.lock("trace.buffer")
        self._events: List[dict] = []
        self._task_records: List[dict] = []
        self._named_tids: set = set()
        self._current_query_id = _live.current_query_id
        self._task_peek = TaskContext.peek
        # record_function forwarding (torch.profiler interplay)
        try:
            from torch.profiler import record_function
            self._annotation = record_function
        except Exception:  # noqa: BLE001 - profiler optional
            self._annotation = None

    # -- clocks ------------------------------------------------------------

    def _ts_us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1000.0

    # -- track identity ----------------------------------------------------

    def _track(self) -> int:
        """One track per task thread: the bound task's id when a
        TaskContext is live on this thread, the raw thread ident
        otherwise (pool workers, the session's thread)."""
        ctx = self._task_peek()
        if ctx is not None:
            tid = ctx.task_id
            name = f"task {ctx.task_id} (partition {ctx.partition_id})"
        else:
            tid = threading.get_ident() & 0x7FFFFFFF
            name = threading.current_thread().name
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            with self._lock:
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": tid, "args": {"name": name}})
        return tid

    # -- event emission ----------------------------------------------------

    def _with_qid(self, args: Optional[dict]) -> Optional[dict]:
        """args + the emitting thread's bound query id (one thread-local
        read; None binding leaves args untouched)."""
        qid = self._current_query_id()
        if qid is None:
            return args
        out = dict(args) if args else {}
        out.setdefault("query_id", qid)
        return out

    def complete(self, name: str, t0_ns: int, dur_ns: int, cat: str,
                 args: Optional[dict] = None) -> None:
        args = self._with_qid(args)
        ev = {"ph": "X", "name": name, "cat": cat, "pid": self.pid,
              "tid": self._track(), "ts": self._ts_us(t0_ns),
              "dur": dur_ns / 1000.0}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str,
                args: Optional[dict] = None) -> None:
        args = self._with_qid(args)
        ev = {"ph": "i", "name": name, "cat": cat, "pid": self.pid,
              "tid": self._track(), "ts": self._ts_us(time.perf_counter_ns()),
              "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def task_rollup(self, record: dict) -> None:
        with self._lock:
            self._task_records.append(record)

    # -- lifecycle ---------------------------------------------------------

    def paths(self) -> Dict[str, str]:
        base = os.path.join(self.out_dir, f"query_{self.query_id}")
        return {"trace": base + "_trace.json",
                "events": base + "_events.jsonl",
                "metrics": base + "_metrics.json"}

    def finalize(self, last_metrics: Optional[dict] = None,
                 status: str = "ok",
                 error: Optional[BaseException] = None,
                 plan_digest: Optional[str] = None) -> Dict[str, str]:
        """Write the three artifacts; returns their paths. A failed query
        finalizes with status="failed" + the exception class so the
        buffered events flush instead of dying with the query (and the
        offline report can say WHY the trace ends early)."""
        os.makedirs(self.out_dir, exist_ok=True)
        p = self.paths()
        with self._lock:
            events = list(self._events)
            tasks = list(self._task_records)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "query_id": self.query_id,
                "trace_level": self.level,
                "wall_start_unix": self._wall0,
                "status": status,
                "plan_digest": plan_digest,
                "producer": "spark_rapids_tpu_torch.runtime.trace",
            },
        }
        with open(p["trace"], "w") as f:
            json.dump(doc, f)
        with open(p["events"], "w") as f:
            qrec = {
                "type": "query", "query_id": self.query_id,
                "wall_start_unix": self._wall0,
                "duration_ns": time.perf_counter_ns() - self._t0,
                "n_tasks": len(tasks),
                "status": status,
                "plan_digest": plan_digest}
            if error is not None:
                qrec["error_class"] = type(error).__name__
            f.write(json.dumps(qrec) + "\n")
            for rec in tasks:
                f.write(json.dumps(rec) + "\n")
        if last_metrics is not None:
            with open(p["metrics"], "w") as f:
                json.dump(last_metrics, f, indent=1)
        return p


class _Span:
    """A live span: times the block ONCE, feeds the paired GpuMetric (the
    NvtxWithMetrics contract) and emits a complete event; opens a
    torch.profiler range of the same name."""

    __slots__ = ("tracer", "name", "metric", "cat", "args", "t0", "_ann",
                 "level")

    def __init__(self, tracer: Tracer, name: str, metric, cat: str,
                 args: Optional[dict], level: int = MODERATE):
        self.tracer = tracer
        self.name = name
        self.metric = metric
        self.cat = cat
        self.args = dict(args) if args else {}
        self._ann = None
        self.level = level

    def __enter__(self):
        ann_cls = self.tracer._annotation
        if ann_cls is not None:
            try:
                self._ann = ann_cls(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 - never fail the query
                self._ann = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:  # noqa: BLE001
                pass
        if self.metric is not None:
            self.metric.add(dur)
        self.tracer.complete(self.name, self.t0, dur, self.cat,
                             self.args or None)
        # traced spans also feed the flight ring, so a dump taken while
        # tracing is on still covers the current query (DEBUG filtered,
        # as at every flight entry point)
        fr = _flight._REC
        if fr is not None and self.level < DEBUG:
            fr.record(self.name, self.cat, self.t0, dur, self.args or None)
        elif self.level < DEBUG:
            rr = _reqtrace._REC
            if rr is not None:
                rr.feed(self.name, self.cat, self.t0, dur,
                        self.args or None, _live.current_query_id())
        return False


# ---------------------------------------------------------------------------
# Module-level fast-path API (what the instrumentation points call)
# ---------------------------------------------------------------------------

def active() -> Optional[Tracer]:
    return _TRACER


def metric_span(name: str, metric, cat: str = "exec",
                args: Optional[dict] = None, level: Optional[int] = None):
    """THE instrumentation point: one timed block feeding both the
    GpuMetric and the trace. Tracing off (or the event filtered by
    level) returns the metric's own nanosecond timer — the exact
    untraced hot path."""
    tr = _TRACER
    lvl = level if level is not None else getattr(metric, "level",
                                                  MODERATE)
    if tr is None or lvl > tr.level:
        fr = _flight._REC
        if fr is not None and lvl < DEBUG:
            return fr.span(name, metric, cat)
        rr = _reqtrace._REC
        if fr is None and rr is not None and lvl < DEBUG \
                and _live.current_request() is not None:
            return rr.span(name, metric, cat)
        return metric.ns() if metric is not None else _NULL
    return _Span(tr, name, metric, cat, args, level=lvl)


def exec_span(node, metric, name: Optional[str] = None):
    """Span for one exec's per-batch work, named
    ``ExecName.metricName`` with the exec's class name (the key
    ``last_metrics()`` files the metric under, so the offline report can
    reconcile the two)."""
    tr = _TRACER
    if tr is None or metric.level > tr.level:
        fr = _flight._REC
        if fr is not None and metric.level < DEBUG:
            return fr.span(name or f"{type(node).__name__}.{metric.name}",
                           metric, "exec")
        rr = _reqtrace._REC
        if fr is None and rr is not None and metric.level < DEBUG \
                and _live.current_request() is not None:
            return rr.span(name or f"{type(node).__name__}.{metric.name}",
                           metric, "exec")
        return metric.ns()
    lid = getattr(node, "lore_id", None)
    return _Span(tr, name or f"{type(node).__name__}.{metric.name}",
                 metric, "exec", None if lid is None else {"lore_id": lid},
                 level=metric.level)


def span(name: str, cat: str = "runtime", args: Optional[dict] = None,
         level: int = MODERATE):
    """Metric-less span (async writes, report-only ranges)."""
    tr = _TRACER
    if tr is None or level > tr.level:
        fr = _flight._REC
        if fr is not None and level < DEBUG:
            return fr.span(name, None, cat)
        rr = _reqtrace._REC
        if fr is None and rr is not None and level < DEBUG \
                and _live.current_request() is not None:
            return rr.span(name, None, cat)
        return _NULL
    return _Span(tr, name, None, cat, args, level=level)


def instant(name: str, cat: str = "runtime", args: Optional[dict] = None,
            level: int = MODERATE) -> None:
    tr = _TRACER
    if tr is not None and level <= tr.level:
        tr.instant(name, cat, args)
    fr = _flight._REC
    if fr is not None and level < DEBUG:
        fr.instant(name, cat, args)
    elif level < DEBUG:
        rr = _reqtrace._REC
        if rr is not None:
            rr.feed(name, cat, time.perf_counter_ns(), -1, args,
                    _live.current_query_id())


def emit_span(name: str, t0_ns: int, dur_ns: int, cat: str = "exec",
              args: Optional[dict] = None, level: int = MODERATE) -> None:
    """Record an already-measured interval as a complete event (for call
    sites that must own the timing, e.g. a retry's wasted attempt)."""
    tr = _TRACER
    if tr is not None and level <= tr.level:
        tr.complete(name, t0_ns, dur_ns, cat, args)
    fr = _flight._REC
    if fr is not None and level < DEBUG:
        fr.record(name, cat, t0_ns, dur_ns, args)
    elif level < DEBUG:
        rr = _reqtrace._REC
        if rr is not None:
            rr.feed(name, cat, t0_ns, dur_ns, args,
                    _live.current_query_id())


def on_task_complete(ctx) -> None:
    """TaskContext completion hook: roll the task's accumulators into the
    per-query event log (the GpuTaskMetrics → profiling-tool handoff)."""
    tr = _TRACER
    if tr is None or not tr.task_metrics:
        return
    metrics = {}
    # roster keys first (stable event-log schema order), ad-hoc
    # accumulators after
    ordered = list(TASK_METRIC_NAMES) + [
        k for k in ctx._metrics if k not in TASK_METRIC_NAMES]
    for name in ordered:
        m = ctx._metrics.get(name)
        if m is None:
            continue
        try:
            v = int(m.value)
        except Exception:  # noqa: BLE001 - a lazy count that cannot resolve
            continue
        if v:
            metrics[name] = v
    tr.task_rollup({
        "type": "task",
        "query_id": tr.query_id,
        # the lifecycle's query id (the tracer's own query_id is its
        # per-tracer sequence)
        "live_query_id": ctx.query_id,
        "task_id": ctx.task_id,
        "partition_id": ctx.partition_id,
        "stage_id": ctx.stage_id,
        "failed": ctx._failed,
        "duration_ns": time.perf_counter_ns() - ctx.start_ns,
        "metrics": metrics,
    })


# ---------------------------------------------------------------------------
# Query lifecycle (driven by TorchSession.collect)
# ---------------------------------------------------------------------------

def start_query(conf) -> Optional[Tracer]:
    """Install a process-wide tracer for one query when
    spark.rapids.sql.trace.enabled is set. Returns None when tracing is
    off OR a query trace is already active (a nested collect — broadcast
    materialization, subqueries — joins the enclosing query's trace).

    The tracer is a process-wide singleton (the reference runs ONE
    ProfilerOnExecutor per executor for the same reason: instrumentation
    points are global). Known limit: two top-level queries collected
    CONCURRENTLY from different sessions share the first query's trace —
    the second query's events land in (and end with) the first's
    artifacts, and its session's last_trace_paths stays None."""
    global _TRACER, _QUERY_SEQ
    from spark_rapids_tpu_torch import config as Cf
    if not conf.get(Cf.TRACE_ENABLED):
        return None
    with _STATE_LOCK:
        if _TRACER is not None:
            return None
        out_dir = conf.get(Cf.TRACE_PATH) or Cf.TRACE_PATH.default
        level_s = str(conf.get(Cf.TRACE_LEVEL)).strip().upper()
        levels = {"ESSENTIAL": ESSENTIAL, "MODERATE": MODERATE,
                  "DEBUG": DEBUG}
        if level_s not in levels:
            # fail fast: a silent MODERATE fallback would make the user
            # debug missing DEBUG events instead of a typo
            raise ValueError(
                f"invalid {Cf.TRACE_LEVEL.key} {level_s!r}: expected "
                f"ESSENTIAL, MODERATE, or DEBUG")
        lvl = levels[level_s]
        _QUERY_SEQ += 1
        tr = Tracer(out_dir, level=lvl,
                    task_metrics=conf.get(Cf.TRACE_TASK_METRICS),
                    query_id=_QUERY_SEQ)
        _TRACER = tr
        return tr


def end_query(tracer: Tracer,
              last_metrics: Optional[dict] = None,
              status: str = "ok",
              error: Optional[BaseException] = None,
              plan_digest: Optional[str] = None) -> Dict[str, str]:
    """Uninstall + finalize; returns the artifact paths. The tracer is
    uninstalled FIRST so a finalize failure can never leave a dead
    tracer swallowing the next query's events."""
    global _TRACER
    with _STATE_LOCK:
        if _TRACER is tracer:
            _TRACER = None
    return tracer.finalize(last_metrics=last_metrics, status=status,
                           error=error, plan_digest=plan_digest)
