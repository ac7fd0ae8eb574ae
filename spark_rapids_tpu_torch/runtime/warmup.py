"""Warmup: replay the hot plans before the first user query needs them.

Counterpart of ``spark_rapids_tpu/runtime/warmup.py``. The query-history
store (spark.rapids.obs.historyDir) records every top-level action with
its plan digest and, for actions born from ``session.sql``, its SQL text.
At session construction (opt-in ``spark.rapids.compile.warmup.enabled``)
the manager reads the store, ranks recurring successful digests by run
count, and keeps the top ``maxPlans`` as the replay set. Replays need the
referenced tables, which at construction time are not registered yet, so
the manager launches lazily: every ``create_or_replace_temp_view``
notifies it, and any pending statement whose tables now resolve replays
on ONE background service thread (``host_pool.spawn_service_thread``,
never a bounded pool worker: a replay runs a whole query, which fans out
task waves of its own).

Replays run on a shadow session (same conf and device, tracing and the
profile capture off, the live view registry) inside
``obs.suppressed_actions()``, so they touch no user-visible session state,
append no history records, fold into no SLO baseline and count into no
query counters. A replay takes device permits like any query (its task
waves admit through the semaphore). A replay failure is logged and
counted, never raised.

Port difference in what a replay primes. On the TPU a replay pays XLA's
trace and compile ahead of the user. On the card nothing is compiled per
plan: a replay primes the keyed stage cache (``runtime/compile_cache``),
the hand kernels' library loads (``ops/_build``; a build if the library
is not on disk yet) and the caching allocator's pools.

Progress is surfaced in the /healthz ``warmup`` document and as
``warmupReplay`` trace instants.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

_LOCK = _san.lock("runtime.warmup")
_MGR: "Optional[WarmupManager]" = None


class WarmupManager:
    """Process-wide warmup state (the obs/tracer singleton pattern)."""

    def __init__(self, session, pending: List[Dict]):
        #: the session whose view registry replays resolve against
        self.session = session
        #: [{digest, sql, runs}] not yet replayed, most-recurrent first
        self.pending = pending
        self.total = len(pending)
        self.replayed = 0
        self.failed = 0
        self.replay_seconds = 0.0
        self._running = False
        #: bumped on every view registration: a drain that finishes its
        #: sweep re-sweeps if the generation moved while it ran (a view
        #: registered DURING a failing probe sweep must not be lost)
        self._notify_gen = 0
        self._done_ev = threading.Event()
        if not pending:
            self._done_ev.set()

    # -- the /healthz document --------------------------------------------

    def doc(self) -> Dict[str, object]:
        with _LOCK:
            return {
                "enabled": True,
                "plans": self.total,
                "pending": len(self.pending),
                "running": self._running,
                "replayed": self.replayed,
                "failed": self.failed,
                "replay_seconds": round(self.replay_seconds, 3),
            }

    # -- replay ------------------------------------------------------------

    def notify_view(self) -> None:
        """A table was registered: if any pending statement might now
        resolve, make sure the replay thread is running. The thread
        drains everything resolvable and parks again (re-spawned by the
        next registration) — registration happens a handful of times at
        startup, so a short-lived thread per burst beats a poller."""
        with _LOCK:
            self._notify_gen += 1
            if self._running or not self.pending:
                # a running drain observes the generation bump and
                # re-sweeps before parking — no lost wakeup
                return
            self._running = True
        from spark_rapids_tpu_torch.runtime.host_pool import spawn_service_thread
        spawn_service_thread(self._drain, name="rapids-warmup")

    def _drain(self) -> None:
        import logging
        log = logging.getLogger("spark_rapids_tpu_torch")
        try:
            shadow = self._shadow_session()
            while True:
                with _LOCK:
                    gen = self._notify_gen
                item = self._next_resolvable(shadow)
                if item is None:
                    with _LOCK:
                        if not self.pending or self._notify_gen == gen:
                            # clear _running INSIDE the exit decision:
                            # a notify landing after this lock releases
                            # sees _running False and spawns a fresh
                            # drain (no unobserved-bump window)
                            self._running = False
                            if not self.pending:
                                self._done_ev.set()
                            return
                    continue  # a view registered mid-sweep: re-sweep
                t0 = time.perf_counter()
                ok = self._replay(shadow, item, log)
                dt = time.perf_counter() - t0
                with _LOCK:
                    self.replay_seconds += dt
                    if ok:
                        self.replayed += 1
                    else:
                        self.failed += 1
                try:
                    from spark_rapids_tpu_torch.runtime import trace as TR
                    TR.instant("warmupReplay", cat="compile", args={
                        "digest": item.get("digest"),
                        "ok": ok, "seconds": round(dt, 3)},
                        level=TR.MODERATE)
                except Exception:  # noqa: BLE001 - tracing is advisory
                    pass
        finally:
            with _LOCK:
                self._running = False
                if not self.pending:
                    self._done_ev.set()

    def _shadow_session(self):
        """A throwaway session sharing the live view registry but not the
        user-visible last-action state; tracing and the profile capture
        off, so replays write no artifacts. Built from the arming
        session's conf values and device: a bare TorchSession() would
        re-run conf-derived process-global init from defaults on this
        background thread."""
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.sql.session import TorchSession
        shadow = TorchSession(dict(self.session.conf._values),
                              device=str(self.session.device))
        shadow.conf.set(C.TRACE_ENABLED, False)
        shadow.conf.set(C.PROFILE_DIR, "")
        shadow._views = self.session._views  # live: later views visible
        return shadow

    def _next_resolvable(self, shadow) -> Optional[Dict]:
        """Pop the hottest pending statement whose tables all resolve
        (probe = parse only; an unresolved table keeps it pending for
        the next registration burst)."""
        with _LOCK:
            candidates = list(self.pending)
        for item in candidates:
            try:
                shadow.sql(item["sql"])
            except Exception:  # noqa: BLE001 - not resolvable (yet)
                continue
            with _LOCK:
                if item in self.pending:
                    self.pending.remove(item)
                    return item
        return None

    def _replay(self, shadow, item: Dict, log) -> bool:
        from spark_rapids_tpu_torch.runtime import obs
        from spark_rapids_tpu_torch.runtime.obs import attribution as attr
        from spark_rapids_tpu_torch.sql import session as sess_mod
        try:
            # nested on ALL layers: obs suppression keeps history/SLO/
            # counters clean, the collect-depth bump keeps the replay
            # out of the top-level-only machinery (attribution open/
            # reset, breaker half-open probe, degradation policy), and
            # the attribution thread-suppression (inherited by the
            # replay's task waves) keeps its compile/task records out
            # of a CONCURRENT user query's aggregate
            with obs.suppressed_actions(), sess_mod.nested_action_scope(), \
                    attr.suppress_scope():
                shadow.sql(item["sql"]).collect()
            return True
        except Exception as e:  # noqa: BLE001 - warmup must never
            # surface a failure into the session it serves
            log.warning("warmup replay of plan %s failed: %s: %s",
                        item.get("digest"), type(e).__name__,
                        str(e)[:200])
            return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every pending plan replayed (tests and the
        smoke). True when the queue drained."""
        return self._done_ev.wait(timeout)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def maybe_arm(session) -> "Optional[WarmupManager]":
    """Arm warmup for this process from a session's conf (idempotent —
    the first arming session wins, exactly like the obs endpoint; the
    shadow session's own construction re-enters here and no-ops).
    Called from TorchSession.__init__."""
    global _MGR
    from spark_rapids_tpu_torch import config as C
    if _MGR is not None or not session.conf.get(C.COMPILE_WARMUP_ENABLED):
        return _MGR
    hist_dir = session.conf.get(C.OBS_HISTORY_DIR)
    if not hist_dir:
        return None
    pending = _hot_plans(hist_dir,
                         int(session.conf.get(C.COMPILE_WARMUP_MIN_RUNS)),
                         int(session.conf.get(C.COMPILE_WARMUP_MAX_PLANS)))
    with _LOCK:
        if _MGR is None:
            _MGR = WarmupManager(session, pending)
    return _MGR


def _hot_plans(hist_dir: str, min_runs: int, max_plans: int) -> List[Dict]:
    """Rank replayable history records: successful top-level queries
    carrying SQL text, grouped by plan digest, recurrence >= min_runs,
    most-recurrent (then most-recent) first."""
    from spark_rapids_tpu_torch.runtime.obs.history import QueryHistoryStore
    by_digest: Dict[str, Dict] = {}
    try:
        records = QueryHistoryStore(hist_dir).read_all()
    except Exception:  # noqa: BLE001 - an unreadable store arms nothing
        return []
    for i, rec in enumerate(records):
        if rec.get("type") != "query" or rec.get("status") != "ok":
            continue
        digest, sql = rec.get("plan_digest"), rec.get("sql")
        if not digest or not sql:
            continue
        slot = by_digest.setdefault(
            digest, {"digest": digest, "sql": sql, "runs": 0, "last": 0})
        slot["runs"] += 1
        slot["last"] = i
        slot["sql"] = sql  # newest text wins
    hot = [s for s in by_digest.values() if s["runs"] >= max(1, min_runs)]
    hot.sort(key=lambda s: (-s["runs"], -s["last"]))
    return hot[:max(0, max_plans)]


def notify_view_registered(session) -> None:
    """Hook from TorchSession.create_or_replace_temp_view: a new table may
    unblock pending replays. One module-global read when warmup is
    unarmed."""
    mgr = _MGR
    if mgr is not None:
        mgr.notify_view()


def manager() -> "Optional[WarmupManager]":
    return _MGR


def doc() -> Optional[Dict[str, object]]:
    """The /healthz warmup document (None = not armed)."""
    mgr = _MGR
    return mgr.doc() if mgr is not None else None


def reset_for_tests() -> None:
    global _MGR
    with _LOCK:
        _MGR = None
