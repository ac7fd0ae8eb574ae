"""SLO anomaly detection: per-plan-digest latency baselines + breaches
(counterpart of ``spark_rapids_tpu/runtime/obs/slo.py``).

Each plan digest (``runtime/obs/history.plan_digest``: same query, same
digest) accumulates a bounded window of recent successful wall times; a
new run exceeding its baseline mean by
``spark.rapids.obs.slo.baselineFactor`` (once ``minRuns`` samples
exist), or exceeding the absolute bound
``spark.rapids.obs.slo.latencySeconds`` regardless of history, is a
breach: the query epilogue then emits a ``slowQuery`` instant, bumps
``rapids_slo_breaches_total``, records the breach (with its attribution
summary) on ``/healthz``, and triggers a flight-recorder dump, so the
timeline of the slow query exists retroactively even with tracing off.

Breaching runs do NOT fold into the baseline (a regression must keep
reading as a regression); with ``spark.rapids.obs.historyDir`` set the
baselines seed from the query history store at install time, so they
survive process restarts.

Plain in-memory state behind one lock; touched once per query end,
never on an execution path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

#: digests tracked before the oldest-inserted is evicted (a serving
#: process sees a bounded query vocabulary; this bounds memory anyway)
_MAX_DIGESTS = 2048


class SloDetector:
    """Per-digest latency baselines with breach classification."""

    def __init__(self, enabled: bool = True, factor: float = 3.0,
                 min_runs: int = 5, abs_seconds: float = 0.0,
                 window: int = 32):
        self._lock = _san.lock("obs.slo")
        self.enabled = bool(enabled)
        self.factor = float(factor)
        self.min_runs = max(1, int(min_runs))
        self.abs_seconds = float(abs_seconds)
        self.window = max(2, int(window))
        self._hist: "OrderedDict[str, List[float]]" = OrderedDict()
        self.breaches = 0
        self.last_breach: Optional[dict] = None
        self._seeded = False

    def configure(self, enabled: bool, factor: float, min_runs: int,
                  abs_seconds: float, window: int) -> None:
        with self._lock:
            self.enabled = bool(enabled)
            self.factor = float(factor)
            self.min_runs = max(1, int(min_runs))
            self.abs_seconds = float(abs_seconds)
            self.window = max(2, int(window))

    # -- baseline maintenance ----------------------------------------------

    def _observe_locked(self, digest: str, seconds: float) -> None:
        runs = self._hist.get(digest)
        if runs is None:
            while len(self._hist) >= _MAX_DIGESTS:
                self._hist.popitem(last=False)
            runs = self._hist[digest] = []
        runs.append(float(seconds))
        if len(runs) > self.window:
            del runs[:len(runs) - self.window]

    def observe(self, digest: str, seconds: float) -> None:
        """Fold a duration into the baseline WITHOUT breach-checking."""
        with self._lock:
            self._observe_locked(digest, seconds)

    def seed_from_history(self, store, limit: int = 2000) -> int:
        """Load baselines from a query history store's ok records (once
        per detector; later calls are no-ops). Returns records folded."""
        with self._lock:
            if self._seeded:
                return 0
            self._seeded = True
        n = 0
        try:
            records = store.read_all()[-limit:]
        except Exception:  # noqa: BLE001 - an unreadable store seeds
            return 0  # nothing; live baselines still accumulate
        for rec in records:
            if rec.get("type") != "query" or rec.get("status") != "ok":
                continue
            if rec.get("slo_breach"):
                # the live check refused to fold this run: seeding must
                # refuse it too, or a sustained regression normalizes
                # itself away across restarts
                continue
            digest = rec.get("plan_digest")
            dur = rec.get("duration_ns")
            if not digest or not dur:
                continue
            self.observe(digest, int(dur) / 1e9)
            n += 1
        return n

    def baseline(self, digest: str) -> Optional[dict]:
        with self._lock:
            runs = self._hist.get(digest)
            if not runs:
                return None
            return {"mean_seconds": sum(runs) / len(runs),
                    "runs": len(runs)}

    # -- the per-query check -----------------------------------------------

    def record(self, digest: str, seconds: float) -> Optional[dict]:
        """Check one successful query against its SLO, then (when clean)
        fold it into the baseline. Returns the breach document or None."""
        with self._lock:
            if not self.enabled:
                return None
            breach: Optional[dict] = None
            if self.abs_seconds > 0 and seconds > self.abs_seconds:
                breach = {"kind": "absolute",
                          "threshold_seconds": self.abs_seconds}
            else:
                runs = self._hist.get(digest)
                if runs and len(runs) >= self.min_runs:
                    base = sum(runs) / len(runs)
                    if seconds > base * self.factor:
                        breach = {"kind": "baseline",
                                  "baseline_seconds": round(base, 6),
                                  "threshold_seconds": round(
                                      base * self.factor, 6),
                                  "runs": len(runs)}
            if breach is None:
                self._observe_locked(digest, seconds)
                return None
            breach.update({"plan_digest": digest,
                           "seconds": round(float(seconds), 6),
                           "factor": self.factor})
            self.breaches += 1
            self.last_breach = breach
            return breach

    def reset_for_tests(self) -> None:
        with self._lock:
            self._hist.clear()
            self.breaches = 0
            self.last_breach = None
            self._seeded = False

    def doc(self) -> dict:
        """The /healthz slo sub-document."""
        with self._lock:
            return {"enabled": self.enabled, "breaches": self.breaches,
                    "digests_tracked": len(self._hist),
                    "factor": self.factor,
                    "abs_seconds": self.abs_seconds,
                    "last_breach": dict(self.last_breach)
                    if self.last_breach else None}
