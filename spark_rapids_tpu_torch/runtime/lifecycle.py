"""Query lifecycle control: cooperative cancellation, deadlines and
admission control (counterpart of ``spark_rapids_tpu/runtime/lifecycle.py``).

There is no thread to interrupt safely, so every query is cooperatively
killable:

1. **CancelToken.** Every top-level action registers a token keyed by
   its live query id (``runtime/obs/live.py``: ``bind`` and
   ``current_query_id``; task waves carry the binding to their threads). The engine's choke
   points (the start of a batch's device work in ``ProjectExec``,
   ``FilterExec`` and the aggregate's update, task-wave starts, retry
   backoff sleeps, the exchange's offsets fetch and the semaphore's
   acquire) call :func:`check_current`, which raises a typed
   :class:`QueryCancelledError` once the token fires. The error unwinds
   through the normal task-completion paths, so spill handles, semaphore
   permits and admission slots release as for any other failure.
   Blocking waits (semaphore park, admission queue, retry backoff)
   register their waiter event with the token so ``cancel()`` wakes them
   at once.

2. **Deadlines.** ``spark.rapids.query.timeoutSeconds`` (or the
   per-action ``collect(timeout_seconds=...)``) arms a deadline on the
   token; a sweeper thread over the token registry fires
   ``cancel("deadline")`` when it lapses.

3. **AdmissionGate.** ``spark.rapids.query.maxConcurrent`` bounds the
   top-level actions executing; excess queries park in a bounded FIFO
   queue. A full queue or an expired
   ``spark.rapids.query.queueTimeoutSeconds`` raises a typed
   :class:`QueryRejectedError`. A queued query is cancellable: its queue
   event is a token waiter.

With no query in flight :func:`check_current` is one module-global dict
read (two within ~60 s of a cancel, while the tombstones drain).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.runtime import faults as _faults
from spark_rapids_tpu_torch.runtime.obs import live as _live

#: the thread-bound query id lives in the live query registry; these are
#: its names, for the call sites that reach it through this module
current_query_id = _live.current_query_id
bind = _live.bind


class QueryCancelledError(RuntimeError):
    """A cooperatively cancelled query (user cancel, deadline, or an
    injected `cancel`-kind fault). NOT a SparkException and NOT
    degradable: a cancelled query must terminate, not re-execute on the
    CPU backend."""

    def __init__(self, query_id=None, reason: str = "user"):
        self.query_id = query_id
        self.reason = reason
        super().__init__(
            f"query {query_id if query_id is not None else '?'} "
            f"cancelled ({reason})")


class QueryRejectedError(RuntimeError):
    """Admission control refused the query: the concurrent-query queue
    is full, or the queue wait exceeded
    spark.rapids.query.queueTimeoutSeconds (the HTTP 503/429 analog for
    the future serving layer). The query never executed."""


class CancelToken:
    """One top-level action's cancellation state. `cancel()` is
    idempotent (first reason wins) and wakes every registered waiter
    event, so threads parked on the semaphore, the admission queue, or a
    retry backoff observe the cancel immediately."""

    __slots__ = ("query_id", "reason", "deadline_at", "device_budget",
                 "local", "cancel_monotonic", "_cancelled", "_event",
                 "_waiters", "_lock")

    def __init__(self, query_id: int, deadline_s: float = 0.0,
                 device_budget: int = 0, local: bool = False):
        self.query_id = query_id
        self.reason: Optional[str] = None
        #: monotonic deadline (0.0 = none) the sweeper fires against
        self.deadline_at = (time.monotonic() + deadline_s
                            if deadline_s and deadline_s > 0 else 0.0)
        #: per-query device-bytes quota (0 = off; runtime/memory.py reads
        #: this through current_token() at reservation time)
        self.device_budget = int(device_budget or 0)
        #: id minted by this module (not by the caller)
        self.local = local
        self.cancel_monotonic = 0.0
        self._cancelled = False
        self._event = threading.Event()
        self._waiters: List[threading.Event] = []
        self._lock = threading.Lock()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self, reason: str = "user") -> bool:
        """Fire the token. Returns True on the first (effective) call."""
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self.reason = reason
            self.cancel_monotonic = time.monotonic()
            waiters, self._waiters = self._waiters, []
        # wakeups outside the lock
        self._event.set()
        for ev in waiters:
            ev.set()
        try:
            from spark_rapids_tpu_torch.runtime import trace
            trace.instant("cancelRequested", cat="query", args={
                "query_id": self.query_id, "reason": reason},
                level=trace.ESSENTIAL)
        except Exception:  # noqa: BLE001 - cancellation must not need a
            pass  # tracer
        return True

    def check(self) -> None:
        if self._cancelled:
            raise QueryCancelledError(self.query_id, self.reason)

    def add_waiter(self, ev: threading.Event) -> None:
        """Register a parked thread's event: cancel() sets it. A token
        already cancelled sets it immediately (no lost-wakeup window)."""
        with self._lock:
            if not self._cancelled:
                self._waiters.append(ev)
                return
        ev.set()

    def remove_waiter(self, ev: threading.Event) -> None:
        with self._lock:
            try:
                self._waiters.remove(ev)
            except ValueError:
                pass

    def wait_cancelled(self, timeout_s: float) -> bool:
        """Sleep up to timeout_s, returning early (True) on cancel — the
        cancellation-aware replacement for time.sleep on backoff paths."""
        return self._event.wait(timeout_s)


# ---------------------------------------------------------------------------
# the token registry + hot-path checkpoint
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: THE live-token table: empty = no query in flight, check_current is one
#: global truthiness read. CPython dict get/set are atomic; mutation
#: happens under _LOCK, hot-path reads are lock-free.
_TOKENS: Dict[int, CancelToken] = {}
_LOCAL_SEQ = 0
_REJECTED = 0
_CANCELLED_TOTAL = 0
#: (query_id, reason, seconds from cancel() to terminal) of recent
#: cancels — the chaos latency gate reads this
_LAST_LATENCIES: List[tuple] = []
#: recently-cancelled query ids -> (reason, finishing thread id): the
#: orphaned-worker hole. finish_action pops the token BEFORE a cancelled
#: query's pool workers finish unwinding, so an orphan's next
#: check_current() used to silently return (token gone) and the task ran
#: on — worst case parking forever on a bounded handoff with no consumer
#: while holding its semaphore permit (the tier-1 test_cancel teardown
#: leak). Tombstoned qids still raise at the checkpoint — EXCEPT on the
#: finishing thread itself, whose observability epilogue (metric
#: snapshots, history writes) must never re-raise the cancel. Bounded
#: insertion-ordered ring: 64 entries outlive any unwind window without
#: growing with query count, and begin_action drops entries older than
#: the TTL so a long-running engine's checkpoint fast path returns to
#: the single-read disarmed cost once the unwind window has passed.
_TOMBSTONES: Dict[int, tuple] = {}
_TOMBSTONE_CAP = 64
_TOMBSTONE_TTL_S = 60.0

def token_ids() -> List[int]:
    return sorted(_TOKENS)


def current_token() -> Optional[CancelToken]:
    """The token of the query bound to THIS thread (None outside any
    query's work)."""
    qid = current_query_id()
    if qid is None:
        return None
    return _TOKENS.get(qid)


def check_current() -> None:
    """THE cooperative checkpoint. Raises QueryCancelledError when the
    thread's bound query has been cancelled; otherwise returns. Placed at
    the engine's per-batch choke points (the start of a batch's device
    work in a projection, a filter or an aggregate's update, wave task
    start, retry backoff, exchange offsets fetch, semaphore acquire). No query in flight: one module-global read (plus a second,
    the tombstone table, only within ~60s of a cancel)."""
    if not _TOKENS:
        # the registry being empty does NOT mean no orphan: the last
        # cancelled query's workers may still be unwinding after
        # finish_action popped their token — the teardown-leak scenario
        if _TOMBSTONES:
            _check_tombstone()
        return
    # the query.cancel crossing site: a `cancel`-kind schedule delivers a
    # cancel at a named checkpoint pass (chaos storms use count/skip to
    # land mid-scan/mid-shuffle/mid-retry); disarmed = one global read
    _faults.site("query.cancel")
    qid = current_query_id()
    if qid is None:
        return
    tok = _TOKENS.get(qid)
    if tok is None:
        _check_tombstone()
        return
    if tok._cancelled:
        raise QueryCancelledError(tok.query_id, tok.reason)


def _check_tombstone() -> None:
    """No live token for this thread's bound qid: either a stale binding
    (fine) or an orphaned worker of a just-cancelled query whose token
    finish_action already popped — the tombstone ring tells them apart,
    and the orphan unwinds here instead of running on. The thread that
    ran finish_action (and now runs the observability epilogue) is
    exempt."""
    qid = current_query_id()
    if qid is None:
        return
    ts = _TOMBSTONES.get(qid)
    if ts is not None and ts[1] != threading.get_ident():
        raise QueryCancelledError(qid, ts[0])


def cancel(query_id, reason: str = "user") -> bool:
    """Cancel a live query by id (the session.cancel / POST
    /queries/<id>/cancel entry point). Returns False when no such query
    is in flight (already finished, or never existed) — cancel-after-
    finish is a no-op by construction."""
    tok = _TOKENS.get(query_id)
    if tok is None:
        return False
    fired = tok.cancel(reason)
    if fired:
        _count_cancelled()
    return fired


def cancel_current(reason: str = "fault") -> bool:
    """Cancel the query bound to THIS thread (the `cancel`-kind fault
    action)."""
    qid = current_query_id()
    if qid is None:
        return False
    return cancel(qid, reason)


def sleep(seconds: float) -> None:
    """Cancellation-aware sleep: wakes (and raises) the moment the
    current query's token fires. Outside any query: plain time.sleep."""
    tok = current_token()
    if tok is None:
        time.sleep(seconds)
        return
    if tok.wait_cancelled(seconds):
        raise QueryCancelledError(tok.query_id, tok.reason)


def _count_cancelled() -> None:
    global _CANCELLED_TOTAL
    with _LOCK:
        _CANCELLED_TOTAL += 1


# ---------------------------------------------------------------------------
# per-action lifecycle (driven by TpuSession.collect)
# ---------------------------------------------------------------------------

def begin_action(query_id: Optional[int], conf,
                 timeout_seconds: Optional[float] = None) -> CancelToken:
    """Register a cancel token for one top-level action. `query_id` is
    the live registry's positive id when obs minted one; None (obs off)
    mints a local negative id and binds it to this thread, so the
    checkpoints work the same. Arms the deadline sweeper when a timeout
    applies."""
    global _LOCAL_SEQ
    from spark_rapids_tpu_torch import config as C
    deadline = timeout_seconds if timeout_seconds is not None \
        else float(conf.get(C.QUERY_TIMEOUT_S) or 0.0)
    budget = int(conf.get(C.QUERY_DEVICE_BUDGET) or 0)
    local = query_id is None
    with _LOCK:
        if _TOMBSTONES:
            # expire tombstones past the unwind window (insertion order
            # = age order, so stop at the first fresh entry)
            cutoff = time.monotonic() - _TOMBSTONE_TTL_S
            for k, ts in list(_TOMBSTONES.items()):
                if ts[2] >= cutoff:
                    break
                del _TOMBSTONES[k]
        if local:
            _LOCAL_SEQ -= 1
            query_id = _LOCAL_SEQ
        tok = CancelToken(query_id, deadline_s=deadline,
                          device_budget=budget, local=local)
        _TOKENS[query_id] = tok
    if local:
        bind(query_id)
    if tok.deadline_at:
        _ensure_sweeper()
    return tok


def admit(token: CancelToken, conf) -> None:
    """Pass the admission gate (spark.rapids.query.maxConcurrent). With
    gating off this is two conf reads; otherwise the caller may park in
    the bounded FIFO queue until a slot frees, the queue-wait timeout
    raises QueryRejectedError, or the token cancels. On success the slot
    is recorded on the gate and released by finish_action."""
    from spark_rapids_tpu_torch import config as C
    limit = int(conf.get(C.QUERY_MAX_CONCURRENT) or 0)
    if limit <= 0:
        return
    _GATE.configure(limit,
                    int(conf.get(C.QUERY_MAX_QUEUED) or 0),
                    float(conf.get(C.QUERY_QUEUE_TIMEOUT_S) or 0.0))
    # the serving span tree: a /sql request's time parked in the gate is
    # the "admission_wait" phase of its per-request timeline (no-op
    # unless a request context is bound: runtime/obs/reqtrace.py)
    from spark_rapids_tpu_torch.runtime.obs import reqtrace as _rt
    with _rt.request_span("admission_wait"):
        _GATE.acquire(token)


def finish_action(token: Optional[CancelToken], status: str) -> None:
    """Tear one action's lifecycle state down BEFORE the observability
    epilogue runs: the token leaves the registry (so epilogue work —
    metric snapshots, history writes — can never re-raise the cancel),
    its admission slot releases, and a fired token's cancel->terminal
    latency is recorded for the chaos gate."""
    if token is None:
        return
    with _LOCK:
        _TOKENS.pop(token.query_id, None)
        if token.cancelled:
            # tombstone the qid so orphaned pool workers still observe
            # the cancel at their next checkpoint (this thread — which
            # runs the epilogue — is exempt; see _TOMBSTONES)
            _TOMBSTONES[token.query_id] = (token.reason or "user",
                                           threading.get_ident(),
                                           time.monotonic())
            while len(_TOMBSTONES) > _TOMBSTONE_CAP:
                _TOMBSTONES.pop(next(iter(_TOMBSTONES)))
    _GATE.forget(token)
    if token.local:
        bind(None)
    if token.cancelled and token.cancel_monotonic:
        lat = time.monotonic() - token.cancel_monotonic
        with _LOCK:
            _LAST_LATENCIES.append((token.query_id, token.reason, lat))
            del _LAST_LATENCIES[:-64]


def count_rejected() -> None:
    global _REJECTED
    with _LOCK:
        _REJECTED += 1
    try:
        from spark_rapids_tpu_torch.runtime import obs
        st = obs.state()
        if st is not None:
            st.registry.counter(
                "rapids_queries_rejected_total",
                "Queries refused by admission control "
                "(spark.rapids.query.maxConcurrent)").inc()
    except Exception:  # noqa: BLE001 - rejection must not need obs
        pass


def cancel_latencies() -> List[tuple]:
    """Recent (query_id, reason, seconds) cancel->terminal latencies."""
    with _LOCK:
        return list(_LAST_LATENCIES)


def doc() -> dict:
    """The admission and cancel document."""
    with _LOCK:
        rejected, cancelled = _REJECTED, _CANCELLED_TOTAL
    return dict(_GATE.doc(), tokens=len(_TOKENS), rejected=rejected,
                cancelled=cancelled)


# ---------------------------------------------------------------------------
# the deadline sweeper
# ---------------------------------------------------------------------------

_SWEEP_INTERVAL_S = 0.05
_SWEEPER: Optional[threading.Thread] = None
_SWEEPER_STOP = threading.Event()


def _ensure_sweeper() -> None:
    global _SWEEPER, _SWEEPER_STOP
    with _LOCK:
        if (_SWEEPER is not None and _SWEEPER.is_alive()
                and not _SWEEPER_STOP.is_set()):
            # a live sweeper whose stop event fired is a CONDEMNED
            # generation draining out — spawn a fresh one past it
            return
        # each sweeper generation owns its OWN stop event. Clearing a
        # shared event here used to resurrect a previous sweeper that
        # reset_for_tests had stopped but that hadn't yet observed the
        # set (join(2) can time out under full-suite load) — the zombie
        # then swept a LATER test's tokens (the second half of the
        # tier-1 test_cancel teardown flake).
        stop = threading.Event()
        _SWEEPER_STOP = stop
        from spark_rapids_tpu_torch.runtime.host_pool import spawn_service_thread
        _SWEEPER = spawn_service_thread(lambda: _sweep_loop(stop),
                                        name="rapids-query-deadline")


def _sweep_loop(stop: threading.Event) -> None:
    global _SWEEPER
    while not stop.wait(_SWEEP_INTERVAL_S):
        now = time.monotonic()
        armed = False
        for tok in list(_TOKENS.values()):
            if not tok.deadline_at:
                continue
            armed = True
            if now >= tok.deadline_at and not tok._cancelled:
                if tok.cancel("deadline"):
                    _count_cancelled()
        if not armed:
            # idle exit: no deadline-armed query left — the decision and
            # the handle clear share the registry lock with begin_action
            # (which registers the token BEFORE _ensure_sweeper), so a
            # new deadline either keeps this loop alive or finds
            # _SWEEPER cleared and spawns a fresh one; the process never
            # carries 20 wakeups/sec for an idle engine
            with _LOCK:
                if any(t.deadline_at for t in _TOKENS.values()):
                    continue
                if _SWEEPER is threading.current_thread():
                    # a replaced generation must not clear the handle of
                    # the sweeper that superseded it
                    _SWEEPER = None
                return


# ---------------------------------------------------------------------------
# admission gate
# ---------------------------------------------------------------------------

class AdmissionGate:
    """Bounded-concurrency gate over top-level actions: up to `limit`
    execute, up to `max_queued` park FIFO behind them (live state
    `queued`), the rest reject. Waiter wakeups are direct handoff under
    the gate lock (the PrioritySemaphore discipline); a waiter's event is
    also a token waiter, so cancellation while queued wakes it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._limit = 0
        self._max_queued = 16
        self._timeout_s = 30.0
        self._active = 0
        self._queue: List[list] = []  # FIFO of [event, granted]
        self._holders: Dict[int, bool] = {}  # query_id -> True

    def configure(self, limit: int, max_queued: int,
                  timeout_s: float) -> None:
        with self._lock:
            self._limit = max(0, int(limit))
            self._max_queued = max(0, int(max_queued))
            self._timeout_s = max(0.0, float(timeout_s))
            # a RAISED limit frees slots right now: grant queue heads
            # immediately (the _grant_head_locked discipline) — queued
            # queries must not keep parking behind one long runner, or
            # time out, while admission capacity sits idle
            self._grant_heads_locked()

    def _grant_heads_locked(self) -> None:
        while self._queue and self._active < self._limit:
            head = self._queue.pop(0)
            head[1] = True
            self._active += 1
            head[0].set()

    def acquire(self, token: CancelToken) -> None:
        entry = None
        with self._lock:
            if self._active < self._limit and not self._queue:
                self._active += 1
                self._holders[token.query_id] = True
                return
            if len(self._queue) < self._max_queued:
                entry = [threading.Event(), False]
                self._queue.append(entry)
            queued, limit, timeout = \
                len(self._queue), self._limit, self._timeout_s
        if entry is None:
            count_rejected()
            raise QueryRejectedError(
                f"admission queue full ({queued} queued behind "
                f"{limit} running; spark.rapids.query.maxQueued)")
        token.add_waiter(entry[0])
        try:
            if timeout > 0:
                entry[0].wait(timeout)
            else:
                entry[0].wait()  # granted or cancelled, whichever first
        finally:
            token.remove_waiter(entry[0])
        with self._lock:
            granted = entry[1]
            if not granted:
                try:
                    self._queue.remove(entry)
                except ValueError:
                    pass
            else:
                self._holders[token.query_id] = True
        if token.cancelled:
            if granted:
                self.release(token)
            raise QueryCancelledError(token.query_id, token.reason)
        if not granted:
            count_rejected()
            raise QueryRejectedError(
                f"queue wait exceeded "
                f"spark.rapids.query.queueTimeoutSeconds={timeout}s")

    def release(self, token: CancelToken) -> None:
        with self._lock:
            if self._holders.pop(token.query_id, None) is None:
                return
            self._active -= 1
            self._grant_heads_locked()

    def forget(self, token: CancelToken) -> None:
        """finish_action hook: release the slot IF this token holds one
        (an ungated or rejected query holds none)."""
        self.release(token)

    def doc(self) -> dict:
        with self._lock:
            return {"limit": self._limit, "active": self._active,
                    "queued": len(self._queue)}


_GATE = AdmissionGate()


def gate() -> AdmissionGate:
    return _GATE


# ---------------------------------------------------------------------------
# test lifecycle
# ---------------------------------------------------------------------------

def reset_for_tests() -> None:
    """Drop tokens, admission state, counters and the deadline sweeper
    (conftest: a cancelled/queued query must not leak into the next
    test)."""
    global _SWEEPER, _REJECTED, _CANCELLED_TOTAL
    with _LOCK:
        _TOKENS.clear()
        _TOMBSTONES.clear()
        _LAST_LATENCIES.clear()
        _REJECTED = 0
        _CANCELLED_TOTAL = 0
        sweeper, _SWEEPER = _SWEEPER, None
    _SWEEPER_STOP.set()
    if sweeper is not None:
        sweeper.join(timeout=2)
    _GATE.__init__()
