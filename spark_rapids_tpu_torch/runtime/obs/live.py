"""Live query registry: in-flight query state, progress, and the
cross-thread query-id binding (counterpart of
``spark_rapids_tpu/runtime/obs/live.py``).

A running query is visible WHILE it runs: a process-wide registry of
``QueryContext`` objects surfaced by ``session.running_queries()``, the
``/queries`` JSON endpoint and the ``/console`` live page.

Three pieces:

1. **QueryContext + state machine.** Every top-level action registers a
   context (query id, plan digest, SQL text, start time) that walks the
   ``STATES`` roster: queued -> planning -> executing -> finishing ->
   {ok, failed, degraded, cancelled}. Transitions are validated against
   the roster; a terminal state is sticky.

2. **Pull-based progress.** The context holds the query's OWN exec root
   (attached by ``prepare_execution``, not ``session.last_exec``, which
   concurrent queries in one session clobber). A progress snapshot walks
   that tree with ``walk_exec_tree`` and *peeks* each exec's rows and
   batches: ``GpuMetric.peek`` never resolves a ``LazyRowCount``, so a
   scrape never reads a count off the card and adds no device sync to
   the running query (no ``.value``, ``.item()`` or ``.cpu()`` here).
   %-complete and ETA derive from the plan's scan estimates
   (``PlanNode.estimated_rows``) against the rows the leaf scans have
   produced.

3. **Cross-thread correlation.** ``bind(qid)`` puts the query id in a
   thread-local; task waves, host-pool submits and pipeline refills carry
   it, so ``current_query_id()`` answers from ANY thread doing work for
   the query. TaskContext captures it at construction, flight-ring
   entries and trace events carry it, the sampler annotates ticks with
   the running set, and ``QueryLogFilter`` stamps it onto log records.
   ``runtime/lifecycle.bind`` and ``.current_query_id`` are these same
   functions.

``current_query_id()`` is one thread-local read; registration happens
once per query, never per batch; progress is computed at scrape time on
the scraper's thread.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san

#: The query-state roster: every ``transition("...")`` literal in the
#: engine must name one of these.
STATES: Dict[str, str] = {
    "queued": "registered, not yet planning (parked in the admission "
              "queue of spark.rapids.query.maxConcurrent; an ungated "
              "query passes through immediately)",
    "planning": "plan conversion and session preamble running "
                "(convert_plan, tagging, spill-budget sync)",
    "executing": "exec tree attached and partitions running — progress "
                 "counters are live in this state",
    "finishing": "partitions done; epilogue running (trace finalize, "
                 "registry publish)",
    "ok": "terminal: completed successfully",
    "failed": "terminal: raised to the caller",
    "degraded": "terminal: device path failed, CPU fallback answered "
                "(spark.rapids.fallback.cpu.enabled)",
    "cancelled": "terminal: the query's cancel token fired (user cancel, "
                 "deadline, or injected fault) and the engine unwound at "
                 "a cooperative checkpoint (runtime/lifecycle.py)",
}

#: states a query can end in (the registry drops it on these)
TERMINAL_STATES = ("ok", "failed", "degraded", "cancelled")

#: legal transition edges (state machine enforced in transition())
_T = TERMINAL_STATES
_EDGES = {
    "queued": ("planning",) + _T,
    "planning": ("executing", "finishing") + _T,
    "executing": ("finishing",) + _T,
    "finishing": _T,
}

_LOCK = _san.lock("obs.live.registry")
_RUNNING: "Dict[int, QueryContext]" = {}
_LAST_COMPLETED: Optional[dict] = None

#: per-thread query-id binding (the correlation primitive)
_TLS = threading.local()


# ---------------------------------------------------------------------------
# thread binding (what host_pool / pipeline / task propagate)
# ---------------------------------------------------------------------------

def current_query_id() -> Optional[int]:
    """The query id bound to THIS thread (None outside any query's
    work). One thread-local read — safe on any hot path."""
    return getattr(_TLS, "qid", None)


def bind(qid: Optional[int]) -> Optional[int]:
    """Bind qid to this thread; returns the previous binding so pool
    workers (which outlive any one query) can restore it."""
    prev = getattr(_TLS, "qid", None)
    _TLS.qid = qid
    return prev


def run_bound(qid: Optional[int], fn, *args):
    """Run fn(*args) with qid bound to this thread, restoring the
    previous binding after (the host-pool submit wrapper)."""
    prev = bind(qid)
    try:
        return fn(*args)
    finally:
        bind(prev)


def current_request():
    """The RequestContext (runtime/obs/reqtrace.py) bound to THIS
    thread: None outside any serving request's work. One thread-local
    read, the same budget as current_query_id()."""
    return getattr(_TLS, "req", None)


def bind_request(rctx):
    """Bind a serving RequestContext to this thread; returns the
    previous binding so pool workers (which outlive any one request)
    can restore it. Rides the conf/query-id seams: task waves,
    HostTaskPool submits, pipeline refills."""
    prev = getattr(_TLS, "req", None)
    _TLS.req = rctx
    return prev


def run_request_bound(rctx, fn, *args):
    """Run fn(*args) with rctx bound to this thread, restoring the
    previous binding after (the host-pool submit wrapper)."""
    prev = bind_request(rctx)
    try:
        return fn(*args)
    finally:
        bind_request(prev)


class QueryLogFilter:
    """logging.Filter stamping the thread's bound query id onto every
    record as ``record.query_id`` ("-" when unbound), so any formatter
    with ``%(query_id)s`` attributes log lines from pool/pipeline/
    writer threads to the right in-flight query. Installed once on the
    ``spark_rapids_tpu_torch`` logger by obs.install()."""

    def filter(self, record) -> bool:
        qid = current_query_id()
        record.query_id = qid if qid is not None else "-"
        return True


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

class QueryContext:
    """One in-flight top-level action's live state. Mutated only by the
    owning query's threads (transition/attach); read racily by scrape
    threads — every read path copies under the registry lock or reads
    immutable/atomic fields."""

    __slots__ = ("query_id", "plan_digest", "sql", "started_unix",
                 "start_ns", "state", "state_history", "exec_root",
                 "thread_name", "est_rows")

    def __init__(self, query_id: int, plan_digest: Optional[str] = None,
                 sql: Optional[str] = None):
        self.query_id = query_id
        self.plan_digest = plan_digest
        self.sql = sql
        self.started_unix = time.time()
        self.start_ns = time.perf_counter_ns()
        self.state = "queued"
        #: [(state, perf_ns)] — the timeline /queries shows
        self.state_history: List[tuple] = [("queued", self.start_ns)]
        self.exec_root = None
        self.thread_name = threading.current_thread().name
        #: summed estimated_rows over the plan's leaf scans (None until
        #: an exec tree attaches; 0 = no estimate available)
        self.est_rows: Optional[int] = None

    # -- state machine -----------------------------------------------------

    def transition(self, state: str) -> None:
        """Advance the state machine. Illegal states raise (the roster
        is the contract — a typo'd state must fail loudly, not render
        as a phantom phase on the console); illegal EDGES are clamped
        to the nearest legal terminal instead, because the epilogue
        must always be able to land a terminal state."""
        if state not in STATES:
            raise ValueError(
                f"unknown query state {state!r}: expected one of "
                f"{sorted(STATES)}")
        cur = self.state
        if cur in TERMINAL_STATES:
            return  # terminal is sticky
        if state not in _EDGES.get(cur, ()):
            if state not in TERMINAL_STATES:
                return  # out-of-order non-terminal hop: ignore
        self.state = state
        self.state_history.append((state, time.perf_counter_ns()))

    def attach_exec(self, exec_root) -> None:
        """Attach the converted exec tree (prepare_execution) and move
        to executing. Only the FIRST attach wins: a nested collect
        (broadcast materialization) re-enters prepare_execution while
        this query is executing and must not clobber the outer tree."""
        if self.exec_root is not None or self.state != "planning":
            return
        self.exec_root = exec_root
        self.est_rows = _estimate_scan_rows(exec_root)
        self.transition("executing")

    # -- progress ----------------------------------------------------------

    def progress_doc(self, with_execs: bool = True) -> dict:
        """Snapshot this query's live progress (scrape-time pull; no
        device syncs — GpuMetric.peek only)."""
        now_ns = time.perf_counter_ns()
        elapsed_s = (now_ns - self.start_ns) / 1e9
        doc = {
            "query_id": self.query_id,
            "state": self.state,
            "plan_digest": self.plan_digest,
            "started_unix": self.started_unix,
            "elapsed_seconds": round(elapsed_s, 3),
            "thread": self.thread_name,
            "states": [
                {"state": s, "at_seconds":
                 round((t - self.start_ns) / 1e9, 6)}
                for s, t in list(self.state_history)],
        }
        if self.sql:
            doc["sql"] = self.sql[:500]
        root = self.exec_root
        if root is None:
            return doc
        from spark_rapids_tpu_torch.runtime.metrics import (
            NUM_OUTPUT_BATCHES, NUM_OUTPUT_ROWS, walk_exec_tree,
        )
        execs = []
        scan_rows = 0
        try:
            for key, node, _d, role, _sid in walk_exec_tree(root):
                ms = node.metrics.metrics
                rows_m = ms.get(NUM_OUTPUT_ROWS)
                batches_m = ms.get(NUM_OUTPUT_BATCHES)
                rows = rows_m.peek() if rows_m is not None else 0
                batches = batches_m.peek() if batches_m is not None else 0
                # leaf scans drive %-complete (only role-None true
                # leaves are sources)
                if role is None and not node.children:
                    scan_rows += rows
                if with_execs:
                    execs.append({"exec": key, "rows": rows,
                                  "batches": batches})
        except Exception:  # noqa: BLE001 - a tree mid-mutation must not
            pass  # fail the scrape; partial progress is still progress
        if with_execs:
            doc["execs"] = execs
        est = self.est_rows
        doc["scan_rows"] = scan_rows
        doc["scan_rows_estimated"] = est
        if est:
            pct = min(1.0, scan_rows / est)
            # a query whose work actually finished reports 100% even if
            # the scan estimate overshot — but a FAILED query died where
            # it died: forcing 100% would tell triage it ran to
            # completion
            if self.state in ("finishing", "ok", "degraded"):
                pct = 1.0
            doc["percent_complete"] = round(pct * 100.0, 2)
            if 0.0 < pct < 1.0:
                doc["eta_seconds"] = round(elapsed_s * (1.0 - pct) / pct, 3)
            elif pct >= 1.0:
                doc["eta_seconds"] = 0.0
        return doc


def _estimate_scan_rows(exec_root) -> int:
    """Summed plan-side row estimates over the tree's leaf scans (0 =
    nothing estimable; progress then reports rows without a %)."""
    total = 0

    def walk(n):
        nonlocal total
        if not n.children:
            try:
                est = n.plan.estimated_rows()
            except Exception:  # noqa: BLE001 - stats are advisory
                est = None
            if est:
                total += int(est)
        for c in n.children:
            walk(c)

    try:
        walk(exec_root)
    except Exception:  # noqa: BLE001 - stats are advisory
        return 0
    return total


# ---------------------------------------------------------------------------
# registry lifecycle (driven by obs.on_query_start / on_query_end)
# ---------------------------------------------------------------------------

def register(query_id: int, plan_digest: Optional[str] = None,
             sql: Optional[str] = None) -> QueryContext:
    qc = QueryContext(query_id, plan_digest=plan_digest, sql=sql)
    with _LOCK:
        _RUNNING[query_id] = qc
    return qc


def get(query_id) -> Optional[QueryContext]:
    with _LOCK:
        return _RUNNING.get(query_id)


def current_context() -> Optional[QueryContext]:
    """The context of the query bound to THIS thread (the
    prepare_execution attach hook)."""
    qid = current_query_id()
    if qid is None:
        return None
    with _LOCK:
        return _RUNNING.get(qid)


def finish(query_id, status: str, duration_ns: int = 0) -> Optional[dict]:
    """Land the terminal state and drop the query from the running set;
    the final progress doc becomes last_completed."""
    global _LAST_COMPLETED
    with _LOCK:
        qc = _RUNNING.pop(query_id, None)
    if qc is None:
        return None
    try:
        qc.transition(status if status in TERMINAL_STATES else "failed")
    except ValueError:
        qc.transition("failed")
    doc = qc.progress_doc(with_execs=True)
    if duration_ns:
        doc["wall_ms"] = round(duration_ns / 1e6, 3)
    # the exec tree must not outlive the query through the registry (a
    # completed batch's device tensors hang off those metrics' lazy
    # counts); last_completed keeps only the rendered doc
    qc.exec_root = None
    with _LOCK:
        _LAST_COMPLETED = doc
    return doc


def running_count() -> int:
    with _LOCK:
        return len(_RUNNING)


def running_ids() -> List[int]:
    with _LOCK:
        return sorted(_RUNNING)


def running_docs(with_execs: bool = True) -> List[dict]:
    """Progress snapshots of every in-flight query, oldest first. The
    contexts are copied out under the lock; the (possibly slow) tree
    walks run outside it."""
    with _LOCK:
        ctxs = sorted(_RUNNING.values(), key=lambda c: c.query_id)
    return [c.progress_doc(with_execs=with_execs) for c in ctxs]


def queries_doc() -> dict:
    """The /queries endpoint document."""
    with _LOCK:
        last = dict(_LAST_COMPLETED) if _LAST_COMPLETED else None
    return {
        "now_unix": time.time(),
        "running": running_docs(with_execs=True),
        "last_completed": last,
    }


def reset_for_tests() -> None:
    global _LAST_COMPLETED
    with _LOCK:
        _RUNNING.clear()
        _LAST_COMPLETED = None
    if hasattr(_TLS, "qid"):
        del _TLS.qid
    if hasattr(_TLS, "req"):
        del _TLS.req
