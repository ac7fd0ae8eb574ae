"""Device dispatch watchdog and circuit breaker (counterpart of
``spark_rapids_tpu/runtime/watchdog.py``).

A wedged device call cannot be interrupted from Python. What the engine
can do is notice, fast, that a dispatch exceeded its deadline, and stop
sending new queries into the wedge:

- **DispatchWatchdog** (``spark.rapids.watchdog.enabled``): device work
  registers with :func:`guard` (the start of each batch's device work in
  ``ProjectExec``, ``FilterExec`` and the aggregate's update); a
  heartbeat service thread scans the in-flight table and, when a
  dispatch exceeds ``spark.rapids.watchdog.dispatchTimeoutSeconds``,
  reports it once (a log warning) and records a failure on the circuit
  breaker, so the next query degrades to the CPU instead of joining the
  wedge.

- **CircuitBreaker**: closed -> open -> half-open with exponential
  backoff. ``record_failure`` past the threshold (or any failure while
  half-open) opens the breaker and doubles its backoff up to the cap;
  once the backoff elapses, one caller's ``allow()`` half-opens it and
  probes the device with a real query; success closes it. The session
  consults ``allow()`` before device execution when CPU fallback is on.

Watchdog disabled: ``guard`` is one module-global read returning a shared
null context; the breaker is touched once per query, never per batch.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("spark_rapids_tpu_torch")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-backend breaker. Thread-safe; logging happens outside the
    lock."""

    def __init__(self, backend: str = "device", failure_threshold: int = 3,
                 base_backoff_s: float = 1.0, max_backoff_s: float = 60.0):
        self.backend = backend
        self.failure_threshold = max(1, int(failure_threshold))
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._backoff_s = self.base_backoff_s
        self._open_count = 0
        self._last_error: Optional[str] = None

    def configure(self, failure_threshold: int, base_backoff_s: float,
                  max_backoff_s: float) -> None:
        with self._lock:
            self.failure_threshold = max(1, int(failure_threshold))
            self.base_backoff_s = float(base_backoff_s)
            self.max_backoff_s = float(max_backoff_s)
            if self._state == CLOSED:
                self._backoff_s = self.base_backoff_s

    def record_failure(self, error_class: str = "") -> None:
        opened = False
        with self._lock:
            self._consecutive_failures += 1
            self._last_error = error_class or self._last_error
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive_failures
                    >= self.failure_threshold):
                if self._state == HALF_OPEN:
                    # the probe failed: back off harder before the next
                    self._backoff_s = min(self._backoff_s * 2,
                                          self.max_backoff_s)
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._open_count += 1
                opened = True
        if opened:
            self._emit_transition(OPEN, error_class)

    def record_success(self) -> None:
        closed = False
        with self._lock:
            self._consecutive_failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._backoff_s = self.base_backoff_s
                closed = True
        if closed:
            self._emit_transition(CLOSED, "")

    def allow(self) -> bool:
        """May a device attempt proceed? closed: yes. open: yes exactly
        once per elapsed backoff window (the caller becomes the
        half-open probe); half-open: no while the probe is in flight —
        but a probe whose outcome is never recorded (the probe query
        failed with a USER error before proving anything about the
        device, or was interrupted) must not wedge the breaker
        half-open forever, so after another backoff window a new probe
        is granted."""
        now = time.monotonic()
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and (
                    now - self._opened_at >= self._backoff_s):
                self._state = HALF_OPEN
                self._half_open_at = now
                probe = True
            elif self._state == HALF_OPEN and (
                    now - self._half_open_at >= self._backoff_s):
                # the previous probe's verdict never arrived: re-probe
                self._half_open_at = now
                probe = True
            else:
                probe = False
        if probe:
            self._emit_transition(HALF_OPEN, "")
        return probe

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_doc(self) -> dict:
        """The breaker's state document."""
        with self._lock:
            doc = {
                "backend": self.backend,
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "backoff_s": round(self._backoff_s, 3),
                "open_count": self._open_count,
                "last_error_class": self._last_error,
            }
            if self._state == OPEN:
                doc["open_for_s"] = round(
                    time.monotonic() - self._opened_at, 3)
        return doc

    def _emit_transition(self, to_state: str, error_class: str) -> None:
        try:
            from spark_rapids_tpu_torch.runtime import trace
            trace.instant("breakerTransition", cat="watchdog", args={
                "backend": self.backend, "to": to_state,
                "error": error_class}, level=trace.ESSENTIAL)
        except Exception:  # noqa: BLE001 - breaker must not need a tracer
            pass
        try:
            from spark_rapids_tpu_torch.runtime import obs
            st = obs.state()
            if st is not None:
                st.registry.counter(
                    "rapids_breaker_transitions_total",
                    "Circuit-breaker state transitions",
                    labels={"to": to_state}).inc()
        except Exception:  # noqa: BLE001 - breaker must not need obs
            pass
        if to_state == OPEN:
            # an opening breaker is a failure-domain event: capture the
            # timeline that led here (flight.dump never raises)
            from spark_rapids_tpu_torch.runtime.obs import flight
            flight.dump("breaker_open", error=error_class or None)
            log.warning("circuit breaker OPEN for backend %s (after %s); "
                        "queries degrade to CPU while open",
                        self.backend, error_class or "failures")
        else:
            log.info("circuit breaker %s for backend %s", to_state,
                     self.backend)


# ---------------------------------------------------------------------------
# dispatch watchdog
# ---------------------------------------------------------------------------

class _NullGuard:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_GUARD = _NullGuard()


class DispatchWatchdog:
    """Heartbeat scanner over in-flight guarded dispatches."""

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._seq = 0
        #: id -> [site, t0_monotonic, thread_name, reported]
        self._inflight: Dict[int, list] = {}
        self._stop = threading.Event()
        self._thread = None
        self.timeouts_reported = 0

    def start(self) -> None:
        from spark_rapids_tpu_torch.runtime.host_pool import spawn_service_thread
        interval = min(1.0, max(0.02, self.timeout_s / 4.0))

        def loop():
            while not self._stop.wait(interval):
                self._scan()

        self._thread = spawn_service_thread(loop, name="rapids-watchdog")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    class _Guard:
        __slots__ = ("wd", "gid")

        def __init__(self, wd: "DispatchWatchdog", site: str):
            self.wd = wd
            with wd._lock:
                wd._seq += 1
                self.gid = wd._seq
                wd._inflight[self.gid] = [
                    site, time.monotonic(),
                    threading.current_thread().name, False]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            with self.wd._lock:
                self.wd._inflight.pop(self.gid, None)
            return False

    def guard(self, site: str) -> "DispatchWatchdog._Guard":
        return DispatchWatchdog._Guard(self, site)

    def _scan(self) -> None:
        now = time.monotonic()
        overdue = []
        with self._lock:
            for entry in self._inflight.values():
                if not entry[3] and now - entry[1] >= self.timeout_s:
                    entry[3] = True  # report each wedge exactly once
                    overdue.append((entry[0], now - entry[1], entry[2]))
            self.timeouts_reported += len(overdue)
        for site, held_s, thread_name in overdue:
            self._report(site, held_s, thread_name)

    def _report(self, site: str, held_s: float, thread_name: str) -> None:
        log.warning(
            "watchdog: device dispatch at %s on thread %s exceeded "
            "%.3fs (in flight %.3fs) — recording breaker failure; the "
            "call itself cannot be interrupted", site, thread_name,
            self.timeout_s, held_s)
        try:
            from spark_rapids_tpu_torch.runtime import trace
            trace.instant("watchdogDispatchTimeout", cat="watchdog", args={
                "site": site, "held_s": round(held_s, 3),
                "thread": thread_name}, level=trace.ESSENTIAL)
        except Exception:  # noqa: BLE001 - watchdog must not need a tracer
            pass
        try:
            from spark_rapids_tpu_torch.runtime import obs
            st = obs.state()
            if st is not None:
                st.registry.counter(
                    "rapids_watchdog_dispatch_timeouts_total",
                    "Device dispatches that exceeded the watchdog "
                    "deadline").inc()
        except Exception:  # noqa: BLE001 - watchdog must not need obs
            pass
        # the wedge's retroactive timeline: dump the flight rings now,
        # while the events leading into the stuck dispatch are still in
        # the buffers (flight.dump never raises)
        from spark_rapids_tpu_torch.runtime.obs import flight
        flight.dump("watchdog_timeout", error="DispatchTimeout")
        breaker().record_failure("DispatchTimeout")


# ---------------------------------------------------------------------------
# process-wide state
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
#: THE enabled flag: None = watchdog off (guard() is one global read)
_WATCHDOG: Optional[DispatchWatchdog] = None
_BREAKER: Optional[CircuitBreaker] = None


def breaker() -> CircuitBreaker:
    """The process device breaker, created on first use (default params;
    maybe_install syncs them from a session conf)."""
    global _BREAKER
    with _STATE_LOCK:
        if _BREAKER is None:
            _BREAKER = CircuitBreaker()
        return _BREAKER


def peek_breaker() -> Optional[CircuitBreaker]:
    """The breaker if one exists, without creating it."""
    return _BREAKER


def active() -> bool:
    return _WATCHDOG is not None


def guard(site: str):
    """Watchdog registration for one device call. Disabled path: one
    module-global read returning a shared null context."""
    wd = _WATCHDOG
    if wd is None:
        return _NULL_GUARD
    return wd.guard(site)


def maybe_install(conf) -> None:
    """Sync breaker params and start/stop the watchdog from a session
    conf (called from TorchSession.prepare_execution; idempotent)."""
    global _WATCHDOG
    from spark_rapids_tpu_torch import config as C
    breaker().configure(
        conf.get(C.WATCHDOG_BREAKER_THRESHOLD),
        conf.get(C.WATCHDOG_BREAKER_BACKOFF_S),
        conf.get(C.WATCHDOG_BREAKER_MAX_BACKOFF_S))
    enabled = conf.get(C.WATCHDOG_ENABLED)
    timeout_s = float(conf.get(C.WATCHDOG_DISPATCH_TIMEOUT_S))
    with _STATE_LOCK:
        wd = _WATCHDOG
        if enabled and wd is None:
            wd = DispatchWatchdog(timeout_s)
            wd.start()
            _WATCHDOG = wd
            return
        if enabled and wd is not None and wd.timeout_s != timeout_s:
            wd.timeout_s = timeout_s
            return
        if not enabled and wd is not None:
            _WATCHDOG = None
        else:
            return
    wd.stop()


def uninstall_for_tests() -> None:
    """Tear down watchdog + breaker (tests: a tripped breaker must not
    leak into the next test's queries)."""
    global _WATCHDOG, _BREAKER
    with _STATE_LOCK:
        wd, _WATCHDOG = _WATCHDOG, None
        _BREAKER = None
    if wd is not None:
        wd.stop()
