"""Process-wide live metrics registry: counters, gauges, bounded histograms
(counterpart of ``spark_rapids_tpu/runtime/obs/registry.py``).

The Prometheus-facing half of the observability layer. Distinct from the
PER-EXEC ``runtime.metrics.MetricsRegistry`` (a query-scoped GpuMetric
set): this one is process-wide, survives queries, and is what
``/metrics`` renders.

Publishing discipline: hot paths never touch this registry. The
GpuMetric / TaskContext accumulators collect per-batch values as before;
``runtime.obs`` folds them in ONCE per task completion and once per query
end, so the per-batch cost of live metrics is zero and the disabled path
is one module-global read (the budget of trace.py).

Histograms are bounded-memory log-bucketed sketches (8 sub-buckets per
octave => <= ~4.4% relative quantile error): an unbounded reservoir
would grow with query count on a long-lived serving process. p50/p95/p99
render as a Prometheus summary; exact count/sum/min/max ride along.
Registering one name as two instrument types raises ``TypeError``.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: sub-buckets per power of two; 8 keeps relative bucket width at
#: 2**(1/8)-1 ~ 9% (quantile midpoint error ~4.4%) with a few hundred
#: buckets covering 1ns..1000s
_OCTAVE_SUBDIV = 8
_NAME_OK = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _sanitize(name: str) -> str:
    out = "".join(ch if ch in _NAME_OK else "_" for ch in name)
    return out if out and not out[0].isdigit() else "_" + out


def _label_str(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{_sanitize(k)}="{v}"')
    return "{" + ",".join(parts) + "}"


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, v: int = 1) -> None:
        with self._lock:
            self._value += int(v)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class FloatCounter(Counter):
    """Monotonic float counter (Prometheus counters are floats natively;
    the int base class keeps existing series rendering as integers).
    Used for accumulated-seconds totals like
    rapids_query_seconds_bucket{phase=...}."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += float(v)


class Gauge:
    """Point-in-time value. Either set explicitly or backed by a callback
    evaluated at render/snapshot time (queue depths, semaphore state —
    live reads with zero publish-path cost)."""

    __slots__ = ("name", "help", "labels", "_lock", "_value", "_fn")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        with self._lock:
            if float(v) > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 - a dead callback must not
                return float("nan")  # kill the scrape
        with self._lock:
            return self._value


class Histogram:
    """Bounded-memory log-bucketed histogram with quantile estimation.

    observe(v) hashes v into bucket floor(log2(v) * 8); counts live in a
    dict so memory is O(distinct octave sub-buckets), independent of
    observation count. quantile(q) walks the cumulative counts and
    returns the hit bucket's geometric midpoint, clamped to the exact
    observed [min, max] — relative error is bounded by the half bucket
    width (~4.4%), verified against numpy.percentile by property test.
    """

    __slots__ = ("name", "help", "labels", "_lock", "_buckets", "_zero",
                 "count", "sum", "min", "max", "_exemplars")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # observations <= 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        #: bucket idx -> (value, unix_ts, labels) — the latest exemplar
        #: per bucket (OpenMetrics: a p99 spike on /metrics resolves to
        #: a concrete trace_id + per-request timeline path)
        self._exemplars: Dict[int, tuple] = {}

    @staticmethod
    def _bucket_idx(v: float) -> int:
        return math.floor(math.log2(v) * _OCTAVE_SUBDIV)

    def observe(self, v: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= 0.0:
                self._zero += 1
                return
            idx = self._bucket_idx(v)
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            if exemplar:
                self._exemplars[idx] = (v, time.time(), dict(exemplar))

    def attach_exemplar(self, v: float,
                        exemplar: Dict[str, str]) -> None:
        """Attach an exemplar to the bucket an already-observed value v
        landed in (for call sites that learn the trace identity AFTER
        the observation — e.g. the reqtrace export path)."""
        v = float(v)
        if v <= 0.0 or not exemplar:
            return
        with self._lock:
            self._exemplars[self._bucket_idx(v)] = (v, time.time(),
                                                    dict(exemplar))

    def exemplars(self) -> Dict[int, tuple]:
        with self._lock:
            return {i: (val, ts, dict(lbl))
                    for i, (val, ts, lbl) in self._exemplars.items()}

    def openmetrics_buckets(self) -> List[tuple]:
        """[(le, cumulative_count, exemplar_or_None)] ending with the
        +Inf bucket — the explicit-bucket series /metrics renders when
        at least one exemplar exists (the summary alone has nowhere to
        hang an exemplar per the OpenMetrics grammar)."""
        with self._lock:
            cum = self._zero
            out: List[tuple] = []
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                out.append((2.0 ** ((idx + 1) / _OCTAVE_SUBDIV), cum,
                            self._exemplars.get(idx)))
            out.append((math.inf, self.count, None))
            return out

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(q * self.count))
            cum = self._zero
            if cum >= target:
                return max(min(0.0, self.max), self.min)
            rep = self.max
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= target:
                    rep = 2.0 ** ((idx + 0.5) / _OCTAVE_SUBDIV)
                    break
            return min(max(rep, self.min), self.max)

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": total,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def bucket_count(self) -> int:
        with self._lock:
            return len(self._buckets)


class MetricsRegistry:
    """The process-wide registry `/metrics` renders. get-or-create by
    (name, labels); creation is rare (bounded by metric-name x exec-name
    cardinality), reads/increments take only the instrument's own lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Optional[Tuple]], object] = {}

    def _key(self, name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted(labels.items())) if labels else None)

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[Dict[str, str]], **kw):
        name = _sanitize(name)
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def float_counter(self, name: str, help: str = "",
                      labels: Optional[Dict[str, str]] = None
                      ) -> FloatCounter:
        return self._get_or_create(FloatCounter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "",
                 labels: Optional[Dict[str, str]] = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help, labels, fn=fn)
        g._fn = fn  # re-registration re-points the callback
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    # -- export ------------------------------------------------------------

    def _grouped(self) -> Dict[str, List[object]]:
        with self._lock:
            items = list(self._metrics.values())
        by_name: Dict[str, List[object]] = {}
        for m in items:
            by_name.setdefault(m.name, []).append(m)
        return by_name

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4. Histograms render as
        summaries (quantile series + _sum/_count)."""
        lines: List[str] = []
        grouped = self._grouped()
        for name in sorted(grouped):
            group = grouped[name]
            first = group[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            if isinstance(first, Counter):
                lines.append(f"# TYPE {name} counter")
                for m in group:
                    lines.append(f"{name}{_label_str(m.labels)} {m.value}")
            elif isinstance(first, Gauge):
                lines.append(f"# TYPE {name} gauge")
                for m in group:
                    v = m.value
                    lines.append(f"{name}{_label_str(m.labels)} "
                                 f"{'NaN' if v != v else repr(v)}")
            elif isinstance(first, Histogram):
                lines.append(f"# TYPE {name} summary")
                for m in group:
                    base = dict(m.labels) if m.labels else {}
                    for q in (0.5, 0.95, 0.99):
                        lbl = dict(base)
                        lbl["quantile"] = repr(q)
                        lines.append(f"{name}{_label_str(lbl)} "
                                     f"{repr(m.quantile(q))}")
                    snap = m.snapshot()
                    lines.append(f"{name}_sum{_label_str(base or None)} "
                                 f"{repr(snap['sum'])}")
                    lines.append(f"{name}_count{_label_str(base or None)} "
                                 f"{snap['count']}")
                    # exemplar-carrying histograms additionally render
                    # explicit cumulative buckets with OpenMetrics
                    # exemplar syntax: `name_bucket{le="..."} N
                    # # {trace_id="..."} value timestamp`
                    if m._exemplars:
                        for le, cum, ex in m.openmetrics_buckets():
                            lbl = dict(base)
                            lbl["le"] = ("+Inf" if le == math.inf
                                         else repr(le))
                            line = f"{name}_bucket{_label_str(lbl)} {cum}"
                            if ex is not None:
                                v, ts, exl = ex
                                line += (f" # {_label_str(exl)} "
                                         f"{repr(v)} {repr(ts)}")
                            lines.append(line)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """Machine-readable dump (tests, /healthz internals)."""
        out: Dict[str, object] = {}
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            key = m.name + _label_str(m.labels)
            out[key] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out
