"""Runtime concurrency sanitizer: instrumented Lock/Condition wrappers
(counterpart of ``spark_rapids_tpu/analysis/sanitizer.py``).

The named lock sites of ``runtime/``, ``shuffle/`` and ``io/`` (the host
pool's registry, the async writer's condition, the shuffle store, the
trace's two locks, the pipeline's locks) construct their locks through
:func:`lock` / :func:`condition`, and when
``spark.rapids.debug.sanitizer.enabled`` is on each acquire / release /
wait feeds a process-wide analysis:

- **lock-order graph**: acquiring B while holding A records the edge
  A->B (first stacks kept, occurrences counted). A new edge that closes
  a cycle in the name graph is a potential-deadlock (lock inversion)
  finding, reported on the first run that merely exhibits both orders,
  deadlock or not.
- **held-lock blocking**: a lock held longer than
  ``spark.rapids.debug.sanitizer.holdWarnMs`` is reported with the
  acquire-site stack: the runtime signature of I/O (or a wedged
  callback) inside a critical section.
- **wait-under-lock**: ``Condition.wait`` releases only its own lock;
  waiting while holding any other sanitized lock blocks that lock for
  the full wait and is reported immediately.

When the sanitizer is off every proxy operation is one module-global
read and a delegated call. The internal state lock is held only for
dict bookkeeping, never across emission or user code.

Reporting: findings accumulate process-wide; :func:`report` returns
them ranked (inversions, then waits-under-lock, then longest holds) and
:func:`dump` also emits one ``sanitizerFinding`` instant per finding
through ``runtime/trace.py``, so a traced query's timeline shows them.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["lock", "condition", "install", "uninstall", "maybe_install",
           "enabled", "report", "dump", "reset"]

#: THE enabled flag: every proxy operation reads this once. None =
#: disabled (delegate straight to the wrapped primitive).
_STATE: "Optional[_SanState]" = None


def _stack(depth: int) -> Tuple[str, ...]:
    """Acquire-site stack, innermost last, sanitizer frames dropped."""
    frames = traceback.extract_stack()
    out = []
    for f in frames:
        if f.filename.endswith("analysis/sanitizer.py"):
            continue
        out.append(f"{f.filename}:{f.lineno} {f.name}")
    return tuple(out[-depth:])


class _SanState:
    """Process-wide sanitizer state. The internal lock guards only the
    graph/finding dicts — it is never held across lock waits, emission,
    or any user code, so it cannot itself participate in a cycle."""

    def __init__(self, hold_warn_ms: float = 50.0, stack_depth: int = 8):
        self.hold_warn_ms = hold_warn_ms
        self.stack_depth = stack_depth
        self._ilock = threading.Lock()
        #: per-thread stack of live holds: [(proxy_id, name, t0_ns, stack)]
        self._tl = threading.local()
        #: (held_name, acquired_name) -> {count, stack_held, stack_acq}
        self.edges: Dict[Tuple[str, str], dict] = {}
        #: out-adjacency over names, for cycle checks
        self._adj: Dict[str, set] = {}
        self.findings: List[dict] = []
        #: finding dedup keys (an inversion/hold site reports once)
        self._seen: set = set()

    # -- hold stack --------------------------------------------------------

    def holds(self) -> List[tuple]:
        h = getattr(self._tl, "holds", None)
        if h is None:
            h = self._tl.holds = []
        return h

    # -- graph -------------------------------------------------------------

    def _path_exists(self, src: str, dst: str) -> bool:
        """DFS over the name graph (tiny: tens of nodes)."""
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._adj.get(n, ()))
        return False

    def record_acquired(self, proxy, name: str, blocked_ns: int) -> None:
        holds = self.holds()
        t0 = time.perf_counter_ns()
        stack = _stack(self.stack_depth)
        new_findings = []
        with self._ilock:
            for _, held_name, _, held_stack in holds:
                if held_name == name:
                    # same-name edges (two instances of one class) need
                    # an address-ordering discipline to judge; tracked
                    # as an edge, excluded from cycle findings
                    pass
                edge = (held_name, name)
                info = self.edges.get(edge)
                if info is None:
                    # a NEW edge: does it close a cycle?
                    if held_name != name and self._path_exists(
                            name, held_name):
                        key = ("inversion",) + tuple(sorted((held_name,
                                                             name)))
                        if key not in self._seen:
                            self._seen.add(key)
                            new_findings.append({
                                "kind": "lock-inversion",
                                "severity": 0,
                                "locks": [held_name, name],
                                "detail": f"acquired {name!r} while "
                                          f"holding {held_name!r}, but the "
                                          f"opposite order is also on "
                                          f"record — potential deadlock",
                                "stack_held": list(held_stack),
                                "stack": list(stack),
                            })
                    self.edges[edge] = {"count": 1,
                                        "stack_held": list(held_stack),
                                        "stack_acq": list(stack)}
                    self._adj.setdefault(held_name, set()).add(name)
                else:
                    info["count"] += 1
            self.findings.extend(new_findings)
        holds.append((id(proxy), name, t0, stack))

    def record_released(self, proxy, name: str) -> None:
        holds = self.holds()
        # releases are LIFO in the with-statement world, but search back
        # to front so out-of-order manual release() stays correct
        for i in range(len(holds) - 1, -1, -1):
            if holds[i][0] == id(proxy):
                _, _, t0, stack = holds.pop(i)
                held_ms = (time.perf_counter_ns() - t0) / 1e6
                if held_ms >= self.hold_warn_ms:
                    self._add_hold_finding(name, held_ms, stack)
                return
        # acquire predates install() (or a foreign thread releasing):
        # nothing to attribute

    def _add_hold_finding(self, name: str, held_ms: float,
                          stack: Tuple[str, ...]) -> None:
        key = ("hold", name, stack)
        with self._ilock:
            if key in self._seen:
                for f in self.findings:
                    if f.get("_key") == key:
                        f["held_ms"] = max(f["held_ms"], round(held_ms, 3))
                        f["count"] = f.get("count", 1) + 1
                        break
                return
            self._seen.add(key)
            self.findings.append({
                "kind": "held-lock-blocking",
                "severity": 2,
                "locks": [name],
                "held_ms": round(held_ms, 3),
                "count": 1,
                "detail": f"{name!r} held {held_ms:.1f}ms (warn "
                          f"threshold {self.hold_warn_ms:.0f}ms) — "
                          f"blocking work inside the critical section",
                "stack": list(stack),
                "_key": key,
            })

    def record_wait_under_lock(self, cv_name: str) -> None:
        others = [h[1] for h in self.holds() if h[1] != cv_name]
        if not others:
            return
        stack = _stack(self.stack_depth)
        key = ("wait", cv_name, tuple(others), stack)
        with self._ilock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.findings.append({
                "kind": "wait-under-lock",
                "severity": 1,
                "locks": [cv_name] + others,
                "detail": f"Condition {cv_name!r} wait() while holding "
                          f"{others!r} — wait releases only its own "
                          f"lock; the others stay blocked for the full "
                          f"wait",
                "stack": list(stack),
            })


class _SanLock:
    """Lock proxy. Disabled: one global read + delegation. Enabled:
    order-graph + hold-time accounting around the real primitive."""

    __slots__ = ("_lk", "name")

    def __init__(self, name: str, lk=None):
        self._lk = lk if lk is not None else threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _STATE
        if st is None:
            return self._lk.acquire(blocking, timeout)
        t0 = time.perf_counter_ns()
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            st.record_acquired(self, self.name,
                               time.perf_counter_ns() - t0)
        return ok

    def release(self) -> None:
        st = _STATE
        # attribute the hold BEFORE the real release: after it, another
        # thread may already be inside the region we are timing
        if st is not None:
            st.record_released(self, self.name)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _SanCondition(_SanLock):
    """Condition proxy: a _SanLock whose wait() suspends its own hold
    record (wait releases the underlying lock) and reports waits made
    while other sanitized locks are held."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, threading.Condition())

    def wait(self, timeout: Optional[float] = None) -> bool:
        st = _STATE
        if st is None:
            return self._lk.wait(timeout)
        st.record_wait_under_lock(self.name)
        # the wait releases this cv's lock: close the hold record now
        # (a long WAIT is idle, not a held-lock block) and re-open it
        # when the wait returns re-acquired
        st.record_released(self, self.name)
        try:
            return self._lk.wait(timeout)
        finally:
            st2 = _STATE
            if st2 is not None:
                st2.record_acquired(self, self.name, 0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        st = _STATE
        if st is None:
            return self._lk.wait_for(predicate, timeout)
        st.record_wait_under_lock(self.name)
        st.record_released(self, self.name)
        try:
            return self._lk.wait_for(predicate, timeout)
        finally:
            st2 = _STATE
            if st2 is not None:
                st2.record_acquired(self, self.name, 0)

    def notify(self, n: int = 1) -> None:
        self._lk.notify(n)

    def notify_all(self) -> None:
        self._lk.notify_all()


# ---------------------------------------------------------------------------
# Factories (what the engine's lock sites call)
# ---------------------------------------------------------------------------

def lock(name: str) -> _SanLock:
    """A named engine lock. Always a proxy, so the sanitizer can be
    enabled after the lock was created (module-global locks are built at
    import time, long before any session conf exists)."""
    return _SanLock(name)


def condition(name: str) -> _SanCondition:
    return _SanCondition(name)


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------

def install(hold_warn_ms: float = 50.0, stack_depth: int = 8) -> None:
    global _STATE
    if _STATE is None:
        _STATE = _SanState(hold_warn_ms, stack_depth)


def uninstall() -> None:
    global _STATE
    _STATE = None


def reset() -> None:
    """Drop accumulated state but keep the sanitizer enabled (tests)."""
    global _STATE
    st = _STATE
    if st is not None:
        _STATE = _SanState(st.hold_warn_ms, st.stack_depth)


def enabled() -> bool:
    return _STATE is not None


def maybe_install(conf) -> None:
    """Session bootstrap hook: install when the debug conf says so. A
    later session turning the conf off does NOT uninstall — findings are
    process-scoped and other sessions may still rely on them; call
    :func:`uninstall` explicitly to stop."""
    from spark_rapids_tpu_torch import config as C
    if conf.get(C.SANITIZER_ENABLED):
        install(hold_warn_ms=conf.get(C.SANITIZER_HOLD_WARN_MS),
                stack_depth=conf.get(C.SANITIZER_STACK_DEPTH))


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def report() -> dict:
    """Ranked findings snapshot: inversions first, then waits-under-lock,
    then held-lock blocks by duration."""
    st = _STATE
    if st is None:
        return {"enabled": False, "findings": [], "edges": 0}
    with st._ilock:
        findings = [dict(f) for f in st.findings]
        n_edges = len(st.edges)
        edges = [{"from": a, "to": b, "count": i["count"]}
                 for (a, b), i in st.edges.items()]
    for f in findings:
        f.pop("_key", None)
    findings.sort(key=lambda f: (f["severity"],
                                 -float(f.get("held_ms", 0.0))))
    return {"enabled": True, "findings": findings, "edges": n_edges,
            "order_edges": edges}


def dump() -> dict:
    """report() + one ``sanitizerFinding`` trace instant per finding (a
    no-op when tracing is off), ranked: the trace is the transport, so
    findings land on the traced query's timeline."""
    rep = report()
    if rep["findings"]:
        from spark_rapids_tpu_torch.runtime import trace
        for f in rep["findings"]:
            trace.instant("sanitizerFinding", cat="sanitizer", args={
                "kind": f["kind"], "locks": f["locks"],
                "detail": f["detail"]})
    return rep
