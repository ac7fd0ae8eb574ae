"""Per-query wall-time attribution into named phase buckets (counterpart
of ``spark_rapids_tpu/runtime/obs/attribution.py``).

Where did the wall clock of one query go? At query end the operators'
``*Time`` timers plus the per-query direct-record aggregate (task
accumulators, kernel builds) decompose into the ``BUCKETS`` roster,
normalized so the buckets always sum to the measured wall time.

Consumers: ``df.explain("analyze")`` prints the breakdown, history
records carry it (a bar in ``tools/history_server.py``), ``/metrics``
exports ``rapids_query_seconds_bucket{phase=...}`` and the SLO detector's
``/healthz`` summary quotes the top buckets.

What the buckets mean on the card: every timer reads the host clock
(``runtime/metrics.py``). Around CUDA work a timer holds the enqueue
plus any sync the work makes, so queued card work lands in whichever
timer syncs first, often ``copyFromDeviceTime`` (``host_decode``) or an
exchange's offsets fetch (``shuffle``). The fold reads only these host
integers and the task accumulators: it never reads the card. ``compile``
is building a kernel library (nvcc, or g++ for a host library) and
loading it the first time it is used (``ops/_build.load``).

Concurrency semantics: per-task times are summed across concurrent
tasks, so the measured total can exceed wall time. Then every bucket is
scaled by wall/measured (critical-path shares), the raw sum kept in
``measured_seconds`` and the ratio in ``concurrency_factor``. When the
total is under wall, the remainder lands in ``other`` (planning, result
assembly, untimed glue).

Process-wide current-query aggregate (the tracer-singleton pattern, same
known limit: two top-level queries collected concurrently share the
aggregate, so their direct-recorded buckets can interleave).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

#: The attribution-bucket roster: every ``attribution.record("...")``
#: literal in the port names one of these.
BUCKETS: Dict[str, str] = {
    "compile": "kernel builds: compiling a hand kernel's library (nvcc, "
               "or g++ for a host library) and loading it the first "
               "time a query uses it",
    "device_compute": "device operator work: every exec *Time metric not "
                      "classified into another bucket",
    "host_decode": "host-side scan decode and H2D/D2H transfer time "
                   "(gpuDecodeTime, copyToDeviceTime, copyFromDeviceTime)",
    "shuffle": "exchange work: partitioning kernels plus every *Time "
               "metric on an Exchange/Shuffle exec (serde, store writes)",
    "semaphore_wait": "tasks blocked acquiring the device semaphore "
                      "(semaphoreWaitTime task accumulator)",
    "pipeline_stall": "pipeline consumers blocked on a producer refill "
                      "(pipelineStallTime)",
    "retry_backoff": "retry-OOM store drain + exponential backoff between "
                     "attempts (retryBlockTime task accumulator)",
    "spill": "spill time device->host and host->disk (spillToHostTime, "
             "spillToDiskTime task accumulators)",
    "other": "unattributed wall-time remainder: planning, host glue, "
             "result assembly (zero when concurrency-scaled)",
}

#: *Time metrics that are overlapped upstream work or nested inside
#: another metric's span, never critical path on their own (producer time
#: is the upstream's own decode and upload; iciExchangeTime would run
#: inside partitionTime's span)
_EXCLUDED_METRICS = frozenset(("pipelineProducerTime", "iciExchangeTime"))

#: metric-name -> bucket for the per-exec snapshot half; a *Time metric
#: absent here buckets as device_compute (or shuffle on an exchange exec).
#: The scans' decode timer is the port's gpuDecodeTime.
METRIC_BUCKETS: Dict[str, str] = {
    "gpuDecodeTime": "host_decode",
    "copyToDeviceTime": "host_decode",
    "copyFromDeviceTime": "host_decode",
    "partitionTime": "shuffle",
    "pipelineStallTime": "pipeline_stall",
    "semaphoreWaitTime": "semaphore_wait",
    "retryBlockTime": "retry_backoff",
    "spillToHostTime": "spill",
    "spillToDiskTime": "spill",
}

#: per-task accumulators folded into the aggregate at task completion
#: (these never appear in exec snapshots: no double counting)
TASK_BUCKETS: Dict[str, str] = {
    "semaphoreWaitTime": "semaphore_wait",
    "retryBlockTime": "retry_backoff",
    "spillToHostTime": "spill",
    "spillToDiskTime": "spill",
}

#: exec-class substrings whose unclassified *Time metrics bucket as
#: shuffle instead of device_compute
_SHUFFLE_CLASSES = ("Exchange", "Shuffle")

assert set(METRIC_BUCKETS.values()) <= set(BUCKETS)
assert set(TASK_BUCKETS.values()) <= set(BUCKETS)

_LOCK = _san.lock("obs.attribution")
#: the active query's direct-record aggregate (bucket -> ns); None when
#: no top-level action runs, and record() is then one global read
_AGG: Optional[Dict[str, int]] = None

#: per-thread suppression: work that must not land in a concurrent user
#: query's aggregate runs under suppress_scope
_SUPPRESS = threading.local()


def thread_suppressed() -> bool:
    return bool(getattr(_SUPPRESS, "on", False))


def set_thread_suppressed(on: bool) -> None:
    _SUPPRESS.on = bool(on)


@contextlib.contextmanager
def suppress_scope():
    """Suppress record() and fold_task() on the current thread."""
    prev = thread_suppressed()
    _SUPPRESS.on = True
    try:
        yield
    finally:
        _SUPPRESS.on = prev


# ---------------------------------------------------------------------------
# per-query aggregate lifecycle (driven by TorchSession.collect)
# ---------------------------------------------------------------------------

def on_query_start() -> None:
    """Open a fresh aggregate for a top-level action."""
    global _AGG
    with _LOCK:
        _AGG = {}


def finish() -> Dict[str, int]:
    """Close and return the aggregate (bucket -> ns)."""
    global _AGG
    with _LOCK:
        agg, _AGG = (_AGG if _AGG is not None else {}), None
        return agg


def reset_for_tests() -> None:
    global _AGG
    with _LOCK:
        _AGG = None


def record(bucket: str, ns: int) -> None:
    """Direct-record ns into the active query's bucket (a kernel build).
    No active query: one module-global read."""
    if _AGG is None or thread_suppressed():
        return
    with _LOCK:
        agg = _AGG
        if agg is not None:
            agg[bucket] = agg.get(bucket, 0) + int(ns)


def fold_task(metrics: Dict[str, object]) -> None:
    """Fold one finished task's accumulators into the active aggregate
    (TaskContext.complete: one fold per task, never per batch). The
    accumulators are host integers."""
    if _AGG is None or thread_suppressed():
        return
    for name, bucket in TASK_BUCKETS.items():
        m = metrics.get(name)
        if m is None:
            continue
        try:
            v = int(m.value)
        except Exception:  # noqa: BLE001 - an unresolvable value
            continue
        if v:
            record(bucket, v)


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

def classify_exec_times(snaps: Optional[Dict[str, dict]]
                        ) -> Dict[str, Dict[str, int]]:
    """Per-exec-class bucket decomposition of a last_metrics()-shaped
    snapshot: {exec_class: {bucket: ns}} under the rules attribute()
    folds into its query totals."""
    per_cls: Dict[str, Dict[str, int]] = {}
    for exec_key, snap in (snaps or {}).items():
        cls = exec_key.split("#", 1)[0]
        shuffle_cls = any(s in cls for s in _SHUFFLE_CLASSES)
        dst = per_cls.setdefault(cls, {})
        for mname, v in snap.items():
            if not mname.endswith("Time") or mname in _EXCLUDED_METRICS:
                continue
            try:
                v = int(v)
            except Exception:  # noqa: BLE001 - non-numeric entry
                continue
            if v <= 0:
                continue
            b = METRIC_BUCKETS.get(mname)
            if b is None:
                b = "shuffle" if shuffle_cls else "device_compute"
            dst[b] = dst.get(b, 0) + v
    return per_cls


#: the compile-correction cascade: a build ran inside the first launch's
#: exec span, so its wall sits in one of these buckets too
_COMPILE_CASCADE = ("device_compute", "shuffle", "host_decode")


def subtract_compile(totals: Dict[str, int], compile_ns: int) -> None:
    """Subtract a query's direct-recorded compile ns from the buckets its
    first launches double-counted into, in cascade order, mutating
    ``totals`` in place. Buckets absent from ``totals`` are skipped."""
    rem = int(compile_ns)
    if rem <= 0:
        return
    for b in _COMPILE_CASCADE:
        if b not in totals:
            continue
        shift = min(rem, totals[b])
        totals[b] -= shift
        rem -= shift
        if not rem:
            break


def attribute(snaps: Optional[Dict[str, dict]], duration_ns: int,
              extra: Optional[Dict[str, int]] = None) -> Optional[dict]:
    """Decompose one query's wall time into the bucket roster.

    ``snaps`` is a last_metrics()-shaped {exec_key: {metric: value}}
    snapshot (only its ``*Time`` entries are read); ``extra`` the
    direct-record aggregate from finish(). Returns the attribution
    document (buckets in seconds, fractions of wall, measured total and
    concurrency factor) or None for a zero-duration query."""
    wall_ns = int(duration_ns)
    if wall_ns <= 0:
        return None
    totals = {b: 0 for b in BUCKETS}
    for per_bucket in classify_exec_times(snaps).values():
        for b, v in per_bucket.items():
            totals[b] += v
    # the in-program exchange's view (nested inside partitionTime):
    # reported beside the buckets, never added to them
    ici_ns = 0
    for snap in (snaps or {}).values():
        try:
            ici_ns += int(snap.get("iciExchangeTime", 0))
        except Exception:  # noqa: BLE001 - non-numeric entry
            pass
    views = {"ici_exchange": round(ici_ns / 1e9, 9)} if ici_ns > 0 else {}
    for b, v in (extra or {}).items():
        if b in totals:
            totals[b] += int(v)
    subtract_compile(totals, totals["compile"])
    measured = sum(totals.values())
    if measured > wall_ns:
        factor = measured / wall_ns
        scaled = {b: int(v * wall_ns / measured)
                  for b, v in totals.items()}
        scaled["other"] += wall_ns - sum(scaled.values())  # rounding
        totals = scaled
    else:
        factor = 1.0
        totals["other"] += wall_ns - measured
    doc = {
        # 9 decimals = full ns resolution, so the buckets sum exactly
        "wall_seconds": round(wall_ns / 1e9, 9),
        "buckets": {b: round(totals[b] / 1e9, 9) for b in BUCKETS},
        "fractions": {b: round(totals[b] / wall_ns, 4) for b in BUCKETS},
        "measured_seconds": round(measured / 1e9, 9),
        "concurrency_factor": round(factor, 3),
    }
    if views:
        doc["views"] = views
    return doc


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render_text(doc: Optional[dict], width: int = 24) -> List[str]:
    """Text breakdown for explain("analyze"): one line per nonzero
    bucket, largest first, with a proportional bar."""
    if not doc:
        return []
    head = (f"-- time attribution (wall {doc['wall_seconds']:.3f}s"
            + (f", concurrency {doc['concurrency_factor']:.1f}x"
               if doc.get("concurrency_factor", 1.0) > 1.0 else "")
            + ") --")
    lines = [head]
    buckets = doc.get("buckets", {})
    fracs = doc.get("fractions", {})
    for b in sorted(buckets, key=lambda k: -buckets[k]):
        s = buckets[b]
        if s <= 0:
            continue
        frac = fracs.get(b, 0.0)
        bar = "#" * max(1, int(frac * width))
        lines.append(f"  {b:<15} {s:>9.3f}s {frac * 100:>5.1f}%  {bar}")
    for name, s in sorted(doc.get("views", {}).items()):
        lines.append(f"  view:{name:<10} {s:>9.3f}s  (measured, nested "
                     f"in shuffle)")
    return lines


def summary(doc: Optional[dict], top: int = 3) -> Optional[dict]:
    """Compact /healthz form: wall + the top-N nonzero buckets."""
    if not doc:
        return None
    buckets = doc.get("buckets", {})
    ranked = sorted(((b, s) for b, s in buckets.items() if s > 0),
                    key=lambda kv: -kv[1])[:top]
    return {"wall_seconds": doc.get("wall_seconds"),
            "top_buckets": {b: s for b, s in ranked}}
