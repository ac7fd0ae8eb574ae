"""Fault injection: named engine sites and scheduled fault kinds
(counterpart of ``spark_rapids_tpu/runtime/faults.py``).

One injector with a named site wherever the engine crosses a failure
domain. Call sites pass a literal site name to :func:`site` (an action
site: the fault raises, sleeps or wedges at the call) or
:func:`site_bytes` (a data site: the fault may also corrupt the bytes
flowing through). An unregistered name in the conf spec fails
``from_conf`` fast. The OomInjector of ``runtime/retry.py`` stays the
facade of the ``retry.oom`` site.

Conf grammar (``spark.rapids.debug.faults``)::

    site:kind[:count[,skip]][;site:kind[:count[,skip]]...]

with kinds ``ioerror`` (raise InjectedFaultError, an OSError), ``corrupt``
(flip bytes; data sites only: the serialized shuffle's write and read),
``delay`` (sleep debug.faults.delayMs),
``wedge`` (sleep debug.faults.wedgeSeconds, long enough for the dispatch
watchdog to notice), ``oom`` (raise TpuRetryOOM, feeding the retry
framework), and ``cancel`` (fire the current query's cancel token, so the
checkpoint that follows raises QueryCancelledError). ``count`` defaults
to 1; ``skip`` delays the first firing by that many site passes.

With no schedule armed every hook is one module-global read. Every fired
fault counts into the process-wide per-site tally.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger("spark_rapids_tpu_torch")

#: The fault-site roster, the JAX package's: every `faults.site("...")`
#: literal in the engine names one of these, and every site in a
#: `spark.rapids.debug.faults` spec must exist here.
SITES: Dict[str, str] = {
    "scan.decode": "host-side scan decode/upload of one source batch "
                   "(parquet/text/in-memory scans)",
    "shuffle.read": "serialized shuffle blob fetched from the store for "
                    "deserialization (data site: corruptible)",
    "shuffle.write": "serialized shuffle blob about to enter the host "
                     "store (data site: corruptible)",
    "spill.disk": "a spill-file write: shuffle-store budget overflow or "
                  "the memory framework's host->disk tier transition",
    "device.dispatch": "the start of one batch's device work in "
                       "ProjectExec, FilterExec or the aggregate's update "
                       "(where the JAX package's fused dispatch sits)",
    "pipeline.producer": "a pipelined stage's producer refill pulling the "
                         "next upstream batch (runtime/pipeline.py)",
    "exchange.fetch": "the compact exchange's per-batch offsets fetch "
                      "(the host sync sizing partition slices)",
    "retry.oom": "the retry framework's attempt entry (the legacy "
                 "injectRetryOOM site, shared with OomInjector)",
    "query.cancel": "the cooperative cancellation checkpoint "
                    "(lifecycle.check_current — fused dispatch, pipeline "
                    "refill, wave start, backoff, exchange fetch); a "
                    "`cancel`-kind schedule delivers a cancel at a "
                    "named checkpoint pass",
    "semaphore.wait": "a queued PrioritySemaphore acquire about to park "
                      "on its waiter event (delay/wedge a contended "
                      "acquire; ioerror exercises the abandoned-waiter "
                      "cleanup path)",
}

#: data sites: the only sites a `corrupt` schedule may target
BYTE_SITES = frozenset(("shuffle.read", "shuffle.write"))

KINDS = ("ioerror", "corrupt", "delay", "wedge", "oom", "cancel")


class InjectedFaultError(OSError):
    """An ioerror-kind injected fault (an OSError so existing disk-error
    handling treats it exactly like the real thing)."""


class _Sched:
    __slots__ = ("kind", "remaining", "skip")

    def __init__(self, kind: str, count: int, skip: int):
        self.kind = kind
        self.remaining = count
        self.skip = skip


_LOCK = threading.Lock()
#: THE armed flag: None = disabled, every hook returns after one global
#: read. Otherwise: site -> ordered schedule list.
_STATE: "Optional[Dict[str, List[_Sched]]]" = None
#: process-lifetime per-site fired tally (site -> count); survives
#: re-configuration so /healthz and chaos accounting see totals
_FIRED: Dict[str, int] = {}
_DELAY_MS = 50.0
_WEDGE_S = 0.25


def parse_spec(spec: str) -> Dict[str, List[_Sched]]:
    """Parse the conf grammar; raises ValueError on unknown sites/kinds
    (fail fast at configure time, not mid-query)."""
    out: Dict[str, List[_Sched]] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"invalid fault spec {part!r}: expected "
                f"'site:kind[:count[,skip]]'")
        sname, kind = bits[0].strip(), bits[1].strip().lower()
        if sname not in SITES:
            raise ValueError(
                f"unknown fault site {sname!r}; registered sites: "
                f"{', '.join(sorted(SITES))}")
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; kinds: {', '.join(KINDS)}")
        if kind == "corrupt" and sname not in BYTE_SITES:
            raise ValueError(
                f"fault kind 'corrupt' needs a data site "
                f"({', '.join(sorted(BYTE_SITES))}); {sname!r} is an "
                f"action site")
        count, skip = 1, 0
        if len(bits) > 2 and bits[2].strip():
            cs = bits[2].split(",")
            try:
                count = int(cs[0])
                skip = int(cs[1]) if len(cs) > 1 and cs[1].strip() else 0
            except ValueError as e:
                raise ValueError(
                    f"invalid fault count/skip in {part!r}: expected "
                    f"'count[,skip]'") from e
        out.setdefault(sname, []).append(_Sched(kind, count, skip))
    return out


def configure(spec: str = "", delay_ms: float = 50.0,
              wedge_s: float = 0.25) -> None:
    """Install (or, with an empty spec, clear) the process-wide fault
    schedule. An empty spec clears leftovers exactly like
    OomInjector.from_conf — a session without injection must not inherit
    a previous session's chaos."""
    global _STATE, _DELAY_MS, _WEDGE_S
    parsed = parse_spec(spec) if spec else None
    with _LOCK:
        _STATE = parsed if parsed else None
        _DELAY_MS = float(delay_ms)
        _WEDGE_S = float(wedge_s)


def from_conf(conf) -> None:
    from spark_rapids_tpu_torch import config as C
    configure(conf.get(C.FAULTS_SPEC) or "",
              delay_ms=conf.get(C.FAULTS_DELAY_MS),
              wedge_s=conf.get(C.FAULTS_WEDGE_S))


def armed(site_name: str) -> bool:
    """Does an uncommitted schedule exist for this site?"""
    st = _STATE
    return st is not None and site_name in st


def fault_counts() -> Dict[str, int]:
    """Process-lifetime fired tally per site."""
    with _LOCK:
        return dict(_FIRED)


def total_fired() -> int:
    with _LOCK:
        return sum(_FIRED.values())


def _next_kind(site_name: str):
    """Pop the next due fault for a site, or None. Lock held only for
    the bookkeeping; the action (sleep/raise/emit) runs outside."""
    global _STATE
    with _LOCK:
        st = _STATE
        if st is None:
            return None
        scheds = st.get(site_name)
        if not scheds:
            return None
        s = scheds[0]
        if s.skip > 0:
            s.skip -= 1
            return None
        s.remaining -= 1
        if s.remaining <= 0:
            scheds.pop(0)
            if not scheds:
                st.pop(site_name, None)
                if not st:
                    _STATE = None
        _FIRED[site_name] = _FIRED.get(site_name, 0) + 1
        delay_ms, wedge_s = _DELAY_MS, _WEDGE_S
    return s.kind, delay_ms, wedge_s


def _emit(site_name: str, kind: str) -> None:
    """Observability for one fired fault: trace instant + obs counter +
    debug log. Never raises; never called under the faults lock."""
    try:
        from spark_rapids_tpu_torch.runtime import trace
        trace.instant("faultInjected", cat="faults",
                      args={"site": site_name, "kind": kind})
    except Exception:  # noqa: BLE001 - injection must not need a tracer
        pass
    try:
        from spark_rapids_tpu_torch.runtime import obs
        st = obs.state()
        if st is not None:
            st.registry.counter(
                "rapids_faults_injected_total",
                "Injected faults fired (spark.rapids.debug.faults)",
                labels={"site": site_name}).inc()
    except Exception:  # noqa: BLE001 - injection must not need obs
        pass
    log.debug("fault injected: site=%s kind=%s", site_name, kind)


def _act(site_name: str, kind: str, delay_ms: float, wedge_s: float) -> None:
    """Perform an action-kind fault (everything but corrupt)."""
    _emit(site_name, kind)
    if kind == "ioerror":
        raise InjectedFaultError(
            f"injected ioerror at fault site {site_name!r}")
    if kind == "oom":
        from spark_rapids_tpu_torch.runtime.retry import TpuRetryOOM
        raise TpuRetryOOM(f"injected OOM at fault site {site_name!r}")
    if kind == "cancel":
        # fire the CURRENT query's cancel token: the next checkpoint
        # (usually the very site pass that fired this) observes it and
        # raises QueryCancelledError — the chaos storm's way of
        # delivering a cancel at a named engine crossing
        from spark_rapids_tpu_torch.runtime import lifecycle
        lifecycle.cancel_current(reason="fault")
        return
    if kind == "delay":
        time.sleep(delay_ms / 1000.0)
    elif kind == "wedge":
        time.sleep(wedge_s)


def site(site_name: str) -> None:
    """Action injection point. Disabled path: one module-global read."""
    if _STATE is None:
        return
    due = _next_kind(site_name)
    if due is None:
        return
    kind, delay_ms, wedge_s = due
    if kind == "corrupt":
        # a corrupt schedule reaching an action site (configure rejects
        # this for conf specs; programmatic schedules could still) acts
        # as an ioerror rather than silently not firing
        _emit(site_name, kind)
        raise InjectedFaultError(
            f"injected corrupt-as-ioerror at action site {site_name!r}")
    _act(site_name, kind, delay_ms, wedge_s)


def site_bytes(site_name: str, data: bytes) -> bytes:
    """Data injection point: like :func:`site`, but a `corrupt` fault
    returns a bit-flipped copy of `data` instead of raising. Disabled
    path: one module-global read."""
    if _STATE is None:
        return data
    due = _next_kind(site_name)
    if due is None:
        return data
    kind, delay_ms, wedge_s = due
    if kind == "corrupt":
        _emit(site_name, kind)
        return corrupt_bytes(data)
    _act(site_name, kind, delay_ms, wedge_s)
    return data


def corrupt_bytes(data: bytes) -> bytes:
    """Deterministic corruption: flip a byte in the middle and one near
    the end (past any header), so checksums must catch it."""
    if not data:
        return b"\xff"
    buf = bytearray(data)
    buf[len(buf) // 2] ^= 0xFF
    buf[-1] ^= 0x55
    return bytes(buf)
