"""Live observability: the process-wide registry, the live query
registry, the flight recorder, the SLO detector, the sampler and the
HTTP endpoint (counterpart of ``spark_rapids_tpu/runtime/obs/__init__.py``).

This package is the LIVE half of the observability story; the offline
half (structured traces and event logs) is runtime/trace.py. Data flow:

    GpuMetric / TaskContext accumulators   (per batch, unchanged hot path)
        -> on_task_complete(ctx)           (ONE registry fold per task)
    attribution, rollups, SLO, history     (once per query, at the end)
        -> on_query_end(...)
    registry  ->  /metrics (Prometheus text), tools/history_server.py
    healthz() ->  /healthz (device probe, semaphore, spill, last query)

Overhead discipline (the budget of trace.py): with
``spark.rapids.obs.enabled=false`` every hook is one module-global read
+ branch; enabled, the hooks run per task or query completion, never per
batch, and none reads the card by default: the attribution buckets read
host-clock timers, and the endpoint's per-exec rollups take each metric's
resolved part (``GpuMetric.peek``), so the epilogue adds no device
synchronization. The HTTP endpoint starts only when
``spark.rapids.obs.port`` is set; the history store only when
``spark.rapids.obs.historyDir`` is set, and its record resolves the lazy
device row counts (``session.last_metrics()``, one snapshot a query).

Process-wide singleton (like the tracer and the semaphore): the first
session that installs wins the endpoint port, the probe's device and the
history dir; later sessions publish into the same registry. Nested
collects (a broadcast materialization, a scalar subquery) join the
enclosing query: only top-level actions produce history records.

The kernel cost audit's roofline gauges and ``last_roofline``, the
kernel-build counters (``runtime/compile_cache.py``) and ``/healthz``'s
``compile`` and ``warmup`` documents are wired here, and so are the
serving layer's routes (``runtime/serving``: ``POST /sql``, ``/serving``,
``/healthz``'s ``serving``), its counters and the request-latency
histogram whose buckets carry per-request trace exemplars
(``runtime/obs/reqtrace.py``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime.obs import (
    attribution, flight, live, reqtrace, sampler,
)
from spark_rapids_tpu_torch.runtime.obs.history import (
    QueryHistoryStore, build_query_record, plan_digest,
)
from spark_rapids_tpu_torch.runtime.obs.registry import MetricsRegistry
from spark_rapids_tpu_torch.runtime.obs.slo import SloDetector

_STATE: "Optional[ObsState]" = None
_STATE_LOCK = _san.lock("obs.state")

#: TaskContext accumulator -> process counter (folded once per task).
#: Every one is a host integer in the port (nothing adds a device count
#: to a task accumulator), so the fold reads no device value.
_TASK_COUNTERS = {
    "semaphoreWaitTime": ("rapids_semaphore_wait_ns_total",
                          "Total ns tasks waited on the device semaphore"),
    "semaphoreHoldTime": ("rapids_semaphore_hold_ns_total",
                          "Total ns tasks held a device semaphore permit"),
    "retryCount": ("rapids_retries_total",
                   "Retry-OOM attempts replayed"),
    "splitAndRetryCount": ("rapids_split_retries_total",
                           "Split-and-retry OOM splits"),
    "retryBlockTime": ("rapids_retry_block_ns_total",
                       "Total ns spent draining spill stores before "
                       "re-attempts"),
    "retryWastedTime": ("rapids_retry_wasted_ns_total",
                        "Total ns spent in attempts that later OOMed and "
                        "were replayed"),
    "spillToHostBytes": ("rapids_spill_to_host_bytes_total",
                         "Bytes spilled device->host"),
    "spillToDiskBytes": ("rapids_spill_to_disk_bytes_total",
                         "Bytes spilled host->disk"),
    "spillToHostTime": ("rapids_spill_to_host_ns_total",
                        "Total ns spent spilling device->host"),
    "spillToDiskTime": ("rapids_spill_to_disk_ns_total",
                        "Total ns spent spilling host->disk"),
    "shuffleCorruptionRetries": (
        "rapids_shuffle_corruption_retries_total",
        "Shuffle blobs that failed integrity verification and were "
        "transparently re-fetched from the store"),
}


class ObsState:
    """Everything the live layer owns. One per process."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.history: Optional[QueryHistoryStore] = None
        self.server = None  # ObsHttpServer
        self.probe = None   # DeviceProbe
        #: the device the liveness probe dispatches to: the first
        #: installing session's
        self.device = None
        self.slo: Optional[SloDetector] = None
        #: live query registry gate (spark.rapids.obs.progress.enabled)
        self.progress_enabled = True
        self._lock = threading.Lock()
        self._query_seq = 0
        self._active = 0  # top-level queries currently running
        self.last_query: Optional[dict] = None
        #: the most recent SLO breach: digest, breach doc, attribution
        #: summary, flight-dump path (the /healthz slow-query surface)
        self.last_slow: Optional[dict] = None
        #: this process's fleet identity (spark.rapids.obs.replicaId, or
        #: pid-derived), stamped on every history record
        self.replica_id: str = ""
        #: the most recent audited query's roofline doc (analysis/
        #: kernel_audit.py): the /console roofline table reads this
        self.last_roofline: Optional[dict] = None


#: per-thread collect depth: a re-entrant collect on the SAME thread is
#: a nested action (broadcast materialization, subqueries) and joins the
#: enclosing query; a collect on ANOTHER thread is a concurrent
#: top-level query and gets its own token
_TLS = threading.local()

#: sentinel token for a nested collect (must still flow to on_query_end
#: so the thread's depth unwinds; publishes nothing)
NESTED = "nested"


def _preregister(reg: MetricsRegistry) -> None:
    """Create the roster instruments up front so a scrape before the
    first task or query still renders them (at zero): the JAX package's
    roster."""
    for _, (name, help_) in _TASK_COUNTERS.items():
        reg.counter(name, help_)
    reg.counter("rapids_tasks_completed_total", "Tasks completed")
    reg.counter("rapids_tasks_failed_total", "Tasks failed")
    reg.counter("rapids_tasks_cancelled_total",
                "Tasks unwound by a query cancel token or an early "
                "sibling close (neither completed nor failed)")
    for status in ("ok", "failed", "degraded", "cancelled"):
        reg.counter("rapids_queries_total", "Queries completed",
                    labels={"status": status})
    reg.counter("rapids_queries_rejected_total",
                "Queries refused by admission control "
                "(spark.rapids.query.maxConcurrent)")
    reg.counter("rapids_faults_injected_total",
                "Injected faults fired (spark.rapids.debug.faults)")
    reg.counter("rapids_watchdog_dispatch_timeouts_total",
                "Device dispatches that exceeded the watchdog deadline")
    reg.counter("rapids_breaker_transitions_total",
                "Circuit-breaker state transitions",
                labels={"to": "open"})

    def _breaker_open():
        from spark_rapids_tpu_torch.runtime import watchdog as WD
        brk = WD.peek_breaker()
        return 0 if brk is None or brk.state == "closed" else (
            2 if brk.state == "open" else 1)

    reg.gauge_fn("rapids_breaker_state", _breaker_open,
                 "Device circuit-breaker state "
                 "(0 closed, 1 half-open, 2 open)")
    reg.counter("rapids_shuffle_bytes_written_total",
                "Serialized shuffle bytes written to the host store")
    reg.counter("rapids_shuffle_bytes_spilled_total",
                "Serialized shuffle bytes spilled to disk")
    reg.counter("rapids_slo_breaches_total",
                "Queries that exceeded their latency SLO "
                "(spark.rapids.obs.slo.*)")
    reg.counter("rapids_flight_dumps_total",
                "Flight-recorder dumps written, by trigger",
                labels={"reason": "query_failed"})
    # the serving layer (runtime/serving/): request intake and the
    # plan-digest-keyed result cache
    reg.counter("rapids_serving_requests_total",
                "POST /sql requests accepted into the serving "
                "layer (past the maxInflight bound).")
    reg.counter("rapids_serving_rejected_total",
                "POST /sql requests refused with HTTP 429 "
                "(maxInflight, maxSessions, or admission-gate "
                "rejection).")
    reg.counter("rapids_result_cache_hits_total",
                "Serving result-cache hits (byte-identical replay of "
                "a prior execution with the same plan digest, table "
                "epoch, and compile fingerprint).")
    reg.counter("rapids_result_cache_misses_total",
                "Serving result-cache misses (the request executed and "
                "its serialized result was inserted).")
    reg.counter("rapids_result_cache_evictions_total",
                "Serving result-cache LRU evictions (byte or entry "
                "bound exceeded).")
    reg.counter("rapids_result_cache_bypasses_total",
                "Serving requests that bypassed the result cache "
                "(non-deterministic plan or cache=false).")
    for phase in attribution.BUCKETS:
        reg.float_counter(
            "rapids_query_seconds_bucket",
            "Per-query wall time attributed to each phase bucket "
            "(seconds; runtime/obs/attribution.py)",
            labels={"phase": phase})
    # the roofline of the most recent AUDITED query (analysis/
    # kernel_audit.py; spark.rapids.obs.audit.enabled): set once per
    # query end, zero until an audited query completes
    for group in ("device_compute", "shuffle", "total"):
        reg.gauge("rapids_roofline_achieved_gbps",
                  "Achieved device bandwidth of the most recent audited "
                  "query (audited bytes / attributed seconds)",
                  labels={"group": group})
        reg.gauge("rapids_roofline_pct",
                  "Share of the configured bandwidth roofline "
                  "(spark.rapids.obs.audit.peakGbps) the most recent "
                  "audited query achieved", labels={"group": group})
    for group in ("device_compute", "shuffle"):
        reg.gauge("rapids_roofline_achieved_gflops",
                  "Achieved operation rate of the most recent audited "
                  "query", labels={"group": group})
        reg.gauge("rapids_roofline_padding_waste_ratio",
                  "Worst-case shape-bucket padding share of the most "
                  "recent audited query's input plane bytes "
                  "(runtime/shapes.py ladder exposure)",
                  labels={"group": group})
    reg.histogram("rapids_query_wall_time_ms",
                  "Per-query wall time (ms)")
    reg.histogram("rapids_serving_request_ms",
                  "Per-request serving wall time (ms), intake to "
                  "response doc; buckets carry reqtrace exemplars")
    reg.histogram("rapids_task_duration_ms", "Per-task duration (ms)")
    reg.gauge("rapids_max_device_bytes_held",
              "High-water mark of registered device bytes (any task)")
    # live gauges (evaluated at scrape time)
    from spark_rapids_tpu_torch.runtime import host_pool as HP
    from spark_rapids_tpu_torch.runtime import memory as MEM
    from spark_rapids_tpu_torch.runtime import semaphore as SEM

    def _sem(attr):
        def read():
            sem = SEM.peek_semaphore()
            return getattr(sem, attr) if sem is not None else 0
        return read

    reg.gauge_fn("rapids_semaphore_available", _sem("available"),
                 "Device semaphore permits currently free")
    reg.gauge_fn("rapids_semaphore_waiting", _sem("waiting"),
                 "Tasks parked on the device semaphore")

    def _cc_stat(name):
        def read():
            from spark_rapids_tpu_torch.runtime import compile_cache as CC
            return CC.stats()[name]
        return read

    # the kernel builds (runtime/compile_cache.py, fed by ops/_build):
    # the JAX package's series names, counting the card's compiles
    reg.counter("rapids_xla_compiles_total",
                "Kernel libraries compiled (nvcc, or the host compiler for "
                "host libraries) by ops/_build; the JAX package counts XLA "
                "backend compiles under this name")
    reg.float_counter("rapids_xla_compile_seconds_total",
                      "Seconds spent building kernel libraries")
    reg.counter("rapids_persistent_cache_hits_total",
                "Kernel libraries found built on disk (spark.rapids.compile."
                "cacheDir or build/torch_kernels) and only loaded")
    reg.counter("rapids_persistent_cache_misses_total",
                "Kernel libraries that had to be built")
    # process totals: builds made before the registry existed (a first
    # session's kernel builds, chip_smoke.py's build phase) count too
    from spark_rapids_tpu_torch.runtime import compile_cache as _CC
    built = _CC.stats()
    reg.counter("rapids_xla_compiles_total").inc(built["xla_compiles"])
    reg.float_counter("rapids_xla_compile_seconds_total").inc(
        built["xla_compile_ns"] / 1e9)
    reg.counter("rapids_persistent_cache_hits_total").inc(
        built["persistent_hits"])
    reg.counter("rapids_persistent_cache_misses_total").inc(
        built["persistent_misses"])
    # the keyed stage cache (runtime/compile_cache.py), read live
    reg.gauge_fn("rapids_compile_cache_hits", _cc_stat("hits"),
                 "Keyed stage-cache hits (entries resolved without "
                 "building)")
    reg.gauge_fn("rapids_compile_cache_misses", _cc_stat("misses"),
                 "Keyed stage-cache misses (fresh entries built)")
    reg.gauge_fn("rapids_compile_cache_entries", _cc_stat("entries"),
                 "Live keyed stage-cache entries")

    def _pool_depth(tier):
        def read():
            pool = HP.current_pool()
            return pool.queue_depths().get(tier, 0) if pool else 0
        return read

    for tier in ("tier0", "tier1"):
        reg.gauge_fn("rapids_host_pool_queue_depth", _pool_depth(tier),
                     "Host task-pool queued (not yet running) tasks",
                     labels={"tier": tier})

    def _spill(attr):
        def read():
            fw = MEM.peek_spill_framework()
            return getattr(fw, attr)() if fw is not None else 0
        return read

    reg.gauge_fn("rapids_device_bytes_held", _spill("device_bytes_held"),
                 "Registered (spillable) device bytes currently held")
    reg.gauge_fn("rapids_host_spill_bytes_held", _spill("host_bytes_held"),
                 "Spilled bytes currently resident in the host store")
    # the live query registry + resource sampler: one gauge per rostered
    # series reading the ring's newest sample, so Prometheus and the
    # console agree on "current"; running-query count reads the registry
    reg.gauge_fn("rapids_queries_running", live.running_count,
                 "Top-level queries currently in flight (live registry)")

    def _smp(series):
        def read():
            s = sampler.sampler()
            if s is None:
                return 0.0
            smp = s.rings[series].latest()
            return smp[1] if smp is not None else 0.0
        return read

    for series, shelp in sampler.SERIES.items():
        reg.gauge_fn(f"rapids_sampler_{series}", _smp(series),
                     f"Sampled {shelp} (newest ring sample; "
                     f"spark.rapids.obs.sampler.*)")


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def install(conf, device=None) -> "Optional[ObsState]":
    """Install (or extend) the process-wide observability state from a
    session's conf; ``device`` is the session's, which the liveness probe
    dispatches to. Idempotent; called from TorchSession.__init__."""
    global _STATE
    from spark_rapids_tpu_torch import config as Cf
    # the flight recorder and the sampler are their own confs' concern:
    # always-on unless switched off, even with the live layer off
    flight.maybe_install(conf)
    sampler.maybe_install(conf)
    # per-request tail-sampled tracing (opt-in:
    # spark.rapids.obs.reqtrace.enabled): its own conf's concern too
    reqtrace.maybe_install(conf)
    if not conf.get(Cf.OBS_ENABLED):
        return _STATE
    with _STATE_LOCK:
        st = _STATE
        if st is None:
            st = ObsState(MetricsRegistry())
            _preregister(st.registry)
            # log lines from any thread attribute to the bound query:
            # %(query_id)s becomes available to every formatter on the
            # engine logger (one filter instance)
            import logging
            lg = logging.getLogger("spark_rapids_tpu_torch")
            if not any(isinstance(f, live.QueryLogFilter)
                       for f in lg.filters):
                lg.addFilter(live.QueryLogFilter())
            _STATE = st
        if st.device is None and device is not None:
            st.device = device
        st.progress_enabled = bool(conf.get(Cf.OBS_PROGRESS_ENABLED))
        if not st.replica_id:
            import os as _os
            st.replica_id = (conf.get(Cf.OBS_REPLICA_ID)
                             or f"pid-{_os.getpid()}")
        hist_dir = conf.get(Cf.OBS_HISTORY_DIR)
        if hist_dir and st.history is None:
            st.history = QueryHistoryStore(hist_dir)
        if st.slo is None:
            st.slo = SloDetector()
        st.slo.configure(conf.get(Cf.OBS_SLO_ENABLED),
                         conf.get(Cf.OBS_SLO_FACTOR),
                         conf.get(Cf.OBS_SLO_MIN_RUNS),
                         conf.get(Cf.OBS_SLO_ABS_SECONDS),
                         conf.get(Cf.OBS_SLO_WINDOW))
        port = int(conf.get(Cf.OBS_PORT))
        if port > 0 and st.server is None:
            from spark_rapids_tpu_torch.runtime.obs.endpoint import \
                ObsHttpServer
            if st.probe is None:
                st.probe = _new_probe(
                    st, conf.get(Cf.OBS_PROBE_TIMEOUT_MS) / 1000.0)
            try:
                from spark_rapids_tpu_torch.runtime.obs.console import \
                    render_live
                server = ObsHttpServer(port, st.registry.render_prometheus,
                                       healthz,
                                       queries=live.queries_doc,
                                       console=render_live,
                                       cors_origin=conf.get(
                                           Cf.OBS_CORS_ORIGIN),
                                       cancel=_cancel_query,
                                       sql=_serving_sql,
                                       serving=_serving_doc)
                server.start()
                st.server = server
            except Exception:  # noqa: BLE001 - a bind failure (port in
                # use by another engine process) must not kill session
                # construction for an observability feature
                import logging
                logging.getLogger("spark_rapids_tpu_torch").warning(
                    "failed to start obs endpoint on port %d", port,
                    exc_info=True)
    if st.history is not None:
        # baselines survive restarts: seed once from the store (outside
        # the state lock: seeding reads the history file)
        st.slo.seed_from_history(st.history)
    return st


def _new_probe(st: "ObsState", timeout_s: float = 2.0):
    """A DeviceProbe of the state's device (the card where none was
    given and one is present)."""
    from spark_rapids_tpu_torch.runtime.obs.endpoint import (
        DeviceProbe, default_device_probe, device_probe,
    )
    fn = device_probe(st.device) if st.device is not None \
        else default_device_probe
    return DeviceProbe(fn, timeout_s=timeout_s)


def state() -> "Optional[ObsState]":
    return _STATE


def enabled() -> bool:
    return _STATE is not None


def shutdown_for_tests() -> None:
    """Tear the singleton down (tests only: frees the port, drops the
    registry so the next install starts clean). Also stops the resource
    sampler's service thread and clears the live query registry."""
    global _STATE
    with _STATE_LOCK:
        st, _STATE = _STATE, None
    if st is not None and st.server is not None:
        try:
            st.server.stop()
        except Exception:  # noqa: BLE001
            pass
    sampler.uninstall_for_tests()
    live.reset_for_tests()
    _TLS.depth = 0


def set_device_probe(fn: Callable[[], bool]) -> None:
    """Swap the /healthz device probe (tests: a blocking fn proves the
    degraded flip without wedging a real device)."""
    st = _STATE
    if st is not None:
        from spark_rapids_tpu_torch.runtime.obs.endpoint import DeviceProbe
        timeout = st.probe.timeout_s if st.probe is not None else 2.0
        st.probe = DeviceProbe(fn, timeout_s=timeout)


# ---------------------------------------------------------------------------
# publish hooks (the only calls on engine paths)
# ---------------------------------------------------------------------------

def on_task_complete(ctx) -> None:
    """Fold one finished task's accumulators into the process registry:
    ONE write batch per task, nothing per batch. Called by
    TaskContext.complete after the trace rollup."""
    st = _STATE
    if st is None:
        return
    reg = st.registry
    try:
        if getattr(ctx, "_cancelled", False):
            reg.counter("rapids_tasks_cancelled_total").inc()
        else:
            reg.counter("rapids_tasks_failed_total" if ctx._failed
                        else "rapids_tasks_completed_total").inc()
        dur_ns = time.perf_counter_ns() - ctx.start_ns
        reg.histogram("rapids_task_duration_ms").observe(dur_ns / 1e6)
        for acc_name, (cname, chelp) in _TASK_COUNTERS.items():
            m = ctx._metrics.get(acc_name)
            if m is None:
                continue
            v = int(m.value)
            if v:
                reg.counter(cname, chelp).inc(v)
        mdb = ctx._metrics.get("maxDeviceBytesHeld")
        if mdb is not None:
            reg.gauge("rapids_max_device_bytes_held").set_max(int(mdb.value))
    except Exception:  # noqa: BLE001 - observability never fails a task
        pass


def on_query_start(plan_digest: Optional[str] = None,
                   sql: Optional[str] = None):
    """Returns a query token: None when obs is off, the NESTED sentinel
    for a re-entrant collect on this thread (it joins the enclosing
    query but must still reach on_query_end to unwind the depth), or a
    fresh positive query id. Concurrent top-level queries from other
    threads or sessions each get their own token and their OWN live
    QueryContext. The token also binds to the calling thread as the
    correlation id (task waves, the host pool and the pipelines carry it
    to every thread working for this query)."""
    st = _STATE
    if st is None:
        return None
    depth = getattr(_TLS, "depth", 0)
    _TLS.depth = depth + 1
    if depth:
        return NESTED
    with st._lock:
        st._query_seq += 1
        st._active += 1
        token = st._query_seq
    live.bind(token)
    if st.progress_enabled:
        try:
            # registered in the `queued` state: the session transitions
            # it to `planning` once admission control grants the slot
            live.register(token, plan_digest=plan_digest, sql=sql)
        except Exception:  # noqa: BLE001 - the registry must never
            pass  # fail a query
    return token


def wants_rollups() -> bool:
    """Does a consumer (the endpoint or the history store) exist for
    per-exec rollups?"""
    st = _STATE
    return st is not None and (st.server is not None
                               or st.history is not None)


def on_query_end(token, *, session, plan, status: str,
                 error: Optional[BaseException], duration_ns: int,
                 wall_start_unix: float,
                 trace_paths: Optional[dict] = None,
                 last_metrics: Optional[Dict[str, dict]] = None,
                 degraded_reason: Optional[str] = None,
                 attribution_doc: Optional[dict] = None,
                 roofline_doc: Optional[dict] = None,
                 aqe_doc: Optional[dict] = None,
                 flight_dump: Optional[str] = None) -> Optional[dict]:
    """Publish one finished top-level action: the registry rollups, the
    SLO check, the attribution export and the history record. Returns the
    record (None when history is off). MUST be called for every non-None
    token (including NESTED): it unwinds the thread's collect depth.
    ``last_metrics`` is the caller's resolved snapshot when it took one;
    the endpoint's rollups otherwise peek, and the history record takes
    one."""
    _TLS.depth = max(0, getattr(_TLS, "depth", 1) - 1)
    st = _STATE
    if st is None or token is NESTED:
        return None
    # land the terminal live-registry state and release this thread's
    # correlation binding (a NESTED return above keeps the outer
    # query's binding intact)
    try:
        live.finish(token, status, duration_ns=duration_ns)
    except Exception:  # noqa: BLE001 - the registry must never fail a
        pass  # query epilogue
    live.bind(None)
    # request tracing: the epilogue runs on the request's handler thread,
    # so the bound serving request (if any) learns its query's live id
    # here, the join key between its serving span tree and the engine
    # spans sharing its ring
    rctx = live.current_request()
    if rctx is not None and isinstance(token, int):
        rctx.query_id = token
    reg = st.registry
    try:
        reg.counter("rapids_queries_total",
                    labels={"status": status}).inc()
        reg.histogram("rapids_query_wall_time_ms").observe(
            duration_ns / 1e6,
            exemplar=({"trace_id": rctx.trace_id}
                      if rctx is not None else None))
        if attribution_doc:
            for phase, secs in attribution_doc.get("buckets", {}).items():
                if secs:
                    reg.float_counter("rapids_query_seconds_bucket",
                                      labels={"phase": phase}).inc(secs)
        if roofline_doc:
            st.last_roofline = roofline_doc
            # the last audited query's gauges; the whole group roster is
            # zeroed first, so a group this doc lacks (no exchange ran)
            # does not keep a previous query's number
            for group in ("device_compute", "shuffle", "total"):
                lbl = {"group": group}
                reg.gauge("rapids_roofline_achieved_gbps",
                          labels=lbl).set(0.0)
                reg.gauge("rapids_roofline_pct", labels=lbl).set(0.0)
                if group != "total":
                    reg.gauge("rapids_roofline_achieved_gflops",
                              labels=lbl).set(0.0)
                    reg.gauge("rapids_roofline_padding_waste_ratio",
                              labels=lbl).set(0.0)
            for group, g in roofline_doc.get("groups", {}).items():
                lbl = {"group": group}
                reg.gauge("rapids_roofline_achieved_gbps", labels=lbl
                          ).set(g.get("achieved_gbps") or 0.0)
                reg.gauge("rapids_roofline_pct", labels=lbl
                          ).set(g.get("roofline_pct_bw") or 0.0)
                reg.gauge("rapids_roofline_achieved_gflops", labels=lbl
                          ).set(g.get("achieved_gflops") or 0.0)
                reg.gauge("rapids_roofline_padding_waste_ratio",
                          labels=lbl
                          ).set(g.get("padding_waste_ratio") or 0.0)
            tot = roofline_doc.get("total") or {}
            reg.gauge("rapids_roofline_achieved_gbps",
                      labels={"group": "total"}
                      ).set(tot.get("achieved_gbps") or 0.0)
            reg.gauge("rapids_roofline_pct", labels={"group": "total"}
                      ).set(tot.get("roofline_pct_bw") or 0.0)
        digest = None
        try:
            digest = plan_digest(plan)
        except Exception:  # noqa: BLE001 - an undigestable plan still
            pass  # publishes; it just cannot baseline
        breach = None
        if st.slo is not None and status == "ok" and digest:
            breach = st.slo.record(digest, duration_ns / 1e9)
        if rctx is not None and breach is not None:
            # the request's tail-sampling verdict must see the breach
            rctx.slo_breach = True
        if breach is not None:
            if attribution_doc is None:
                try:
                    attribution_doc = session.last_attribution()
                except Exception:  # noqa: BLE001 - advisory
                    pass
            reg.counter("rapids_slo_breaches_total").inc()
            try:
                from spark_rapids_tpu_torch.runtime import trace as _tr
                _tr.instant("slowQuery", cat="query", args=dict(breach),
                            level=_tr.ESSENTIAL)
            except Exception:  # noqa: BLE001 - slo must not need a tracer
                pass
            if flight_dump is None:
                flight_dump = flight.dump(
                    "slo_breach",
                    query_id=token if isinstance(token, int) else None)
            st.last_slow = {
                "query_id": token,
                "plan_digest": digest,
                "wall_ms": round(duration_ns / 1e6, 3),
                "breach": breach,
                "attribution": attribution.summary(attribution_doc),
                "flight_dump": flight_dump,
                "finished_unix": time.time(),
            }
        snaps = last_metrics
        if st.history is not None and snaps is None:
            # the record's rollups resolve the lazy device row counts:
            # one snapshot serves the record and the registry
            snaps = {}
            try:
                snaps = session.last_metrics()
            except Exception:  # noqa: BLE001 - a poisoned lazy count
                pass  # must not drop the whole publish
        if st.server is not None or st.history is not None:
            # per-exec rollups; with the endpoint alone, from each
            # metric's resolved part: a row count still on the card is
            # not read (no device sync in the epilogue)
            if snaps is None:
                snaps = peek_metrics(session)
            _publish_exec_rollups(reg, snaps)
        rec = None
        if st.history is not None:
            rec = build_query_record(
                query_id=token, wall_start_unix=wall_start_unix,
                duration_ns=duration_ns, status=status, error=error,
                plan=plan, session=session, trace_paths=trace_paths,
                snaps=snaps, degraded_reason=degraded_reason,
                attribution=attribution_doc, roofline=roofline_doc,
                aqe=aqe_doc,
                slo_breach=breach, flight_dump=flight_dump,
                digest=digest, replica_id=st.replica_id or None,
                trace_id=rctx.trace_id if rctx is not None else None,
                mesh=_mesh_doc(session))
            st.history.append(rec)
        st.last_query = {
            "query_id": token, "status": status,
            "wall_ms": round(duration_ns / 1e6, 3),
            "error_class": type(error).__name__ if error else None,
            "finished_unix": time.time(),
        }
        if degraded_reason is not None:
            st.last_query["degraded_reason"] = degraded_reason
        if breach is not None:
            st.last_query["slo_breach"] = True
        return rec
    except Exception:  # noqa: BLE001 - observability never fails a query
        return None
    finally:
        with st._lock:
            st._active -= 1


def peek_metrics(session) -> Dict[str, dict]:
    """``session.last_metrics()`` without resolving lazy device counts
    (``MetricsRegistry.peek_snapshot``): no device sync. Every ``*Time``
    timer is a host integer, so the attribution fold reads the same
    timers from it."""
    from spark_rapids_tpu_torch.runtime.metrics import walk_exec_tree
    out: Dict[str, dict] = {}
    root = getattr(session, "last_exec", None)
    if root is None:
        return out
    try:
        for key, node, _d, _role, _sid in walk_exec_tree(root):
            snap = node.metrics.peek_snapshot()
            if snap:
                out[key] = snap
    except Exception:  # noqa: BLE001 - a partial rollup still publishes
        pass
    return out


def _mesh_doc(session) -> Optional[dict]:
    """The history record's ``mesh`` under spark.rapids.sql.multichip.
    enabled, else None (best effort: history never fails a query)."""
    try:
        conf = getattr(session, "conf", None)
        from spark_rapids_tpu_torch import config as C
        if conf is None or not conf.get(C.MULTICHIP_ENABLED):
            return None
        from spark_rapids_tpu_torch.parallel import mesh as _mesh
        return {"n_devices": _mesh.multichip_devices(conf),
                "axes": [_mesh.PART_AXIS]}
    except Exception:  # noqa: BLE001 - history never fails a query
        return None


def _publish_exec_rollups(reg: MetricsRegistry, snaps: Dict[str, dict]
                          ) -> None:
    """Per-exec-CLASS rollups (bounded cardinality: one series per
    operator type, not per instance)."""
    from spark_rapids_tpu_torch.runtime.metrics import exec_rollup
    per_cls: Dict[str, dict] = {}
    shuffle_written = shuffle_spilled = 0
    for exec_key, snap in snaps.items():
        cls = exec_key.split("#", 1)[0]
        r = exec_rollup(snap)
        dst = per_cls.setdefault(cls, {"rows": 0, "batches": 0,
                                       "dispatches": 0, "time_ns": 0})
        for k in dst:
            v = r.get(k)
            if v:
                dst[k] += int(v)
        shuffle_written += int(snap.get("shuffleBytesWritten", 0))
        shuffle_spilled += int(snap.get("shuffleBytesSpilled", 0))
    for cls, r in per_cls.items():
        lbl = {"exec": cls}
        if r["time_ns"]:
            reg.counter("rapids_exec_time_ns_total",
                        "Per-operator-class device/op time (ns)",
                        labels=lbl).inc(r["time_ns"])
        if r["rows"]:
            reg.counter("rapids_exec_rows_total",
                        "Per-operator-class output rows", labels=lbl
                        ).inc(r["rows"])
        if r["dispatches"]:
            reg.counter("rapids_exec_dispatches_total",
                        "Per-operator-class device dispatches", labels=lbl
                        ).inc(r["dispatches"])
    if shuffle_written:
        reg.counter("rapids_shuffle_bytes_written_total"
                    ).inc(shuffle_written)
    if shuffle_spilled:
        reg.counter("rapids_shuffle_bytes_spilled_total"
                    ).inc(shuffle_spilled)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

def _compile_doc():
    try:
        from spark_rapids_tpu_torch.runtime import compile_cache as CC
        return CC.doc()
    except Exception:  # noqa: BLE001 - health must always render
        return None


def _warmup_doc():
    try:
        from spark_rapids_tpu_torch.runtime import warmup as WU
        return WU.doc()
    except Exception:  # noqa: BLE001 - health must always render
        return None


def _lifecycle_doc():
    try:
        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        return LC.doc()
    except Exception:  # noqa: BLE001 - health must always render
        return None


def _cancel_query(query_id) -> bool:
    """The POST /queries/<id>/cancel handler target."""
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    return LC.cancel(query_id, reason="http")


def _serving_sql(payload: dict):
    """The POST /sql handler target (lazy: the serving layer may install
    after the endpoint starts, or never)."""
    from spark_rapids_tpu_torch.runtime import serving as SRV
    return SRV.handle_sql(payload)


def _serving_doc():
    """The GET /serving + healthz['serving'] document (None when the
    serving layer is not installed)."""
    try:
        from spark_rapids_tpu_torch.runtime import serving as SRV
        return SRV.server_doc()
    except Exception:  # noqa: BLE001 - health must always render
        return None


def suppressed_actions():
    """Context manager making every collect on the CURRENT thread look
    nested to the live layer (on_query_start returns NESTED: no SLO
    fold, no query counters)."""
    import contextlib

    @contextlib.contextmanager
    def _cm():
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        try:
            yield
        finally:
            _TLS.depth = max(0, getattr(_TLS, "depth", 1) - 1)

    return _cm()


def healthz() -> dict:
    """The /healthz document. Degraded when the device probe is blocked
    or failing OR the device circuit breaker is open (the engine is
    serving, but on the CPU fallback path); breaker state and per-site
    injected-fault counts ride along."""
    st = _STATE
    if st is None:
        return {"status": "degraded", "reason": "obs not installed"}
    from spark_rapids_tpu_torch.runtime import faults as FLT
    from spark_rapids_tpu_torch.runtime import memory as MEM
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    from spark_rapids_tpu_torch.runtime import watchdog as WD
    if st.probe is None:
        st.probe = _new_probe(st)
    sem = SEM.peek_semaphore()
    sem_doc = {"permits": sem.permits, "available": sem.available,
               "waiting": sem.waiting,
               "saturated": sem.available == 0} if sem is not None else None
    # a busy device is not a degraded device: while a running query
    # holds EVERY semaphore permit, defer the probe and report the
    # reason instead. `_active` (not the live registry, which
    # progress.enabled=false leaves empty) counts in-flight top-level
    # queries unconditionally.
    with st._lock:
        active = st._active
    if sem is not None and sem.available == 0 and active > 0:
        device = {"alive": None, "deferred": True,
                  "reason": "all semaphore permits held by a running "
                            "query; probe skipped"}
        device_ok = True
    else:
        device = st.probe.check()
        device_ok = bool(device.get("alive"))
    fw = MEM.peek_spill_framework()
    if fw is not None:
        host_held = fw.host_bytes_held()
        spill_doc = {
            "device_bytes_held": fw.device_bytes_held(),
            "device_budget": fw.device_budget,
            "host_bytes_held": host_held,
            "host_budget": fw.host_budget,
            "disk_spill_bytes": fw.metrics.get("spill_to_disk_bytes", 0),
            "pressure": round(host_held / fw.host_budget, 4)
            if fw.host_budget else 0.0,
        }
    else:
        spill_doc = None
    # direct counter reads: a full registry snapshot would walk every
    # histogram's quantiles per poll
    reg = st.registry
    brk = WD.peek_breaker()
    breaker_doc = brk.state_doc() if brk is not None else {
        "backend": "device", "state": "closed"}
    return {
        "status": "ok" if (device_ok
                           and breaker_doc["state"] != "open")
        else "degraded",
        "device": device,
        "breaker": breaker_doc,
        "faults": FLT.fault_counts(),
        "semaphore": sem_doc,
        "spill": spill_doc,
        "flight": flight.doc(),
        # the kernel builds and the keyed cache, and warmup's progress
        # (runtime/compile_cache.py, runtime/warmup.py)
        "compile": _compile_doc(),
        "warmup": _warmup_doc(),
        "slo": dict(st.slo.doc(), last_slow=st.last_slow)
        if st.slo is not None else None,
        "sampler": sampler.doc(),
        "queries": {
            "active": active,
            "running": live.running_docs(with_execs=False),
            "completed_ok": reg.counter(
                "rapids_queries_total", labels={"status": "ok"}).value,
            "failed": reg.counter(
                "rapids_queries_total",
                labels={"status": "failed"}).value,
            "degraded": reg.counter(
                "rapids_queries_total",
                labels={"status": "degraded"}).value,
            "cancelled": reg.counter(
                "rapids_queries_total",
                labels={"status": "cancelled"}).value,
            "rejected": reg.counter(
                "rapids_queries_rejected_total").value,
            "last_completed": st.last_query,
        },
        "lifecycle": _lifecycle_doc(),
        "serving": _serving_doc(),
    }
