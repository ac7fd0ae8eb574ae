"""The port's per-operator metrics (``runtime/metrics.py``) and query trace
(``runtime/trace.py``) against the JAX package's, on the CPU.

- The programs of ``tests/test_trace.py`` that do not depend on fusion:
  tracing is off by default and writes nothing; the artifacts are Chrome
  trace JSON with task tracks, ``ExecName.metricName`` spans and
  semaphore instants; the tracer is uninstalled after a collect; the
  level filters events; ``metric_span`` is the single instrumentation
  point (one interval feeds the metric and the event); an invalid level
  fails fast; the off path is the metric's own timer; the semaphore's
  waits are event-driven and measure real contention.
- ``tools/profiler_report.py``'s ``analyze`` reconciles every span total
  with its ``last_metrics()`` timer within 1%, with no history directory.
- ``last_metrics()`` against the JAX package's, with its stage fusion off
  (and one device, so both plan the same aggregates): every exec class of
  both trees records the same ``numOutputRows``, and the Parquet scans
  the same ``numRowGroups``, ``numRowGroupsPruned`` and ``readBytes``.
  The decode timer is ``gpuDecodeTime`` where the JAX package says
  ``tpuDecodeTime``.
- The runtime's instants (retry, fault, spill), the task event
  log, spans forwarded to ``torch.profiler``, and a failing query that
  fails the same with tracing on and flushes its trace.

Tolerances: counts are exact; the reconciliation is the JAX package's
rule, span totals within 1% of the metric timers.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.expr.core import SparkException, col, lit
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import trace
from spark_rapids_tpu_torch.sql import functions as F

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import profiler_report as PR  # noqa: E402


@pytest.fixture(autouse=True)
def _runtime():
    H.reset_torch_runtime()
    yield
    H.reset_torch_runtime()


def _table(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 40, n),
                     "v": rng.integers(0, 1000, n),
                     "d": rng.uniform(0, 1, n)})


def _traced_session(tmp_path, level="DEBUG", **extra):
    conf = {"spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.path": str(tmp_path),
            "spark.rapids.sql.trace.level": level,
            "spark.rapids.sql.reader.batchSizeRows": "1024"}
    conf.update(extra)
    return TorchSession(conf, device="cpu")


def _grouped(s, parts=2):
    return (s.create_dataframe(_table(), num_partitions=parts)
            .filter(col("v") > lit(10))
            .select(col("k"), (col("v") * lit(2)).alias("v2"))
            .filter(col("v2") < lit(1900))
            .group_by("k").agg(F.sum(col("v2"))))


# ---------------------------------------------------------------------------
# core artifacts
# ---------------------------------------------------------------------------

def test_trace_off_by_default_writes_nothing():
    s = TorchSession(device="cpu")
    assert not s.conf.get(C.TRACE_ENABLED)
    s.create_dataframe(_table()).filter(col("v") > lit(1)).collect()
    assert s.last_trace_paths is None
    assert trace.active() is None


def test_trace_artifacts_chrome_valid(tmp_path):
    s = _traced_session(tmp_path)
    out = _grouped(s).collect()
    assert out.num_rows > 0
    p = s.last_trace_paths
    for k in ("trace", "events", "metrics"):
        assert os.path.exists(p[k]), k
    events = PR.validate_chrome_trace(p["trace"])  # raises on malformation
    assert {"X", "M", "i"} <= {e["ph"] for e in events}
    # one named track per task thread
    names = [e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"]
    assert any(n.startswith("task ") for n in names)
    # exec spans named ExecName.metricName
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert "InMemoryScanExec.copyToDeviceTime" in spans
    assert "HashAggregateExec.aggTime" in spans
    instants = {e["name"] for e in events if e["ph"] == "i"}
    assert {"semaphoreAcquire", "semaphoreRelease", "queryStart"} \
        <= instants
    with open(p["metrics"]) as f:
        assert json.load(f) == s.last_metrics()
    doc = json.load(open(p["trace"]))
    assert doc["otherData"]["status"] == "ok"
    assert doc["otherData"]["producer"] == \
        "spark_rapids_tpu_torch.runtime.trace"


def test_tracer_uninstalled_after_collect(tmp_path):
    s = _traced_session(tmp_path)
    s.create_dataframe(_table()).filter(col("v") > lit(5)).collect()
    assert trace.active() is None
    q1 = s.last_trace_paths["trace"]
    # a second action gets its own query id
    s.create_dataframe(_table()).filter(col("v") > lit(7)).collect()
    q2 = s.last_trace_paths["trace"]
    assert q1 != q2
    art = PR.load_artifacts(q2)
    assert art["query"]["n_tasks"] >= 1
    assert art["tasks"] and all(t["type"] == "task" for t in art["tasks"])


def test_trace_level_filters_events(tmp_path):
    ess = _traced_session(tmp_path / "e", level="ESSENTIAL")
    dbg = _traced_session(tmp_path / "d", level="DEBUG")
    _grouped(ess).collect()
    _grouped(dbg).collect()
    ev_ess = PR.validate_chrome_trace(ess.last_trace_paths["trace"])
    ev_dbg = PR.validate_chrome_trace(dbg.last_trace_paths["trace"])
    assert len(ev_ess) < len(ev_dbg)
    # MODERATE instants (semaphore) and MODERATE metric spans are
    # filtered at ESSENTIAL; the ESSENTIAL queryStart marker stays
    names = {e["name"] for e in ev_ess if e["ph"] in ("i", "X")}
    assert "semaphoreAcquire" not in names
    assert not any(n.endswith("Time") for n in names)
    assert "queryStart" in names


def test_metric_span_is_single_instrumentation_point(tmp_path):
    # tracing OFF: the metric still ticks through the same call site
    m = M.GpuMetric("opTime")
    with trace.metric_span("x.opTime", m):
        time.sleep(0.001)
    assert m.value > 0
    # tracing ON: one timed block feeds BOTH metric and event
    conf = C.RapidsConf({"spark.rapids.sql.trace.enabled": "true",
                         "spark.rapids.sql.trace.path": str(tmp_path)})
    tr = trace.start_query(conf)
    try:
        m2 = M.GpuMetric("opTime")
        with trace.metric_span("x.opTime", m2):
            time.sleep(0.001)
    finally:
        paths = trace.end_query(tr)
    ev = [e for e in PR.validate_chrome_trace(paths["trace"])
          if e["ph"] == "X" and e["name"] == "x.opTime"]
    assert len(ev) == 1
    # the event duration IS the metric value (same measured interval)
    assert abs(ev[0]["dur"] - m2.value / 1000.0) < 1e-6


def test_invalid_trace_level_fails_fast(tmp_path):
    with pytest.raises(ValueError, match="trace.level"):
        trace.start_query(C.RapidsConf({
            "spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.path": str(tmp_path),
            "spark.rapids.sql.trace.level": "VERBOSE"}))
    assert trace.active() is None  # nothing half-installed
    s = _traced_session(tmp_path, level="VERBOSE")
    with pytest.raises(ValueError, match="trace.level"):
        s.create_dataframe(_table()).collect()


def test_disabled_path_returns_plain_metric_timer():
    assert trace.active() is None
    m = M.GpuMetric("opTime")
    assert isinstance(trace.metric_span("x", m), M._Timer), \
        "disabled path must be the raw timer"
    node = object()
    assert isinstance(trace.exec_span(node, m), M._Timer)
    assert isinstance(trace.span("y"), trace._NullSpan)
    trace.instant("z")  # must be a no-op, not an error


# ---------------------------------------------------------------------------
# report + reconciliation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return H.make_tables(20_000)


def test_profiler_report_reconciles_the_port(tmp_path, tables):
    li, od = tables
    api = torch_api()
    s = _traced_session(tmp_path, **{
        "spark.rapids.sql.join.broadcastRowThreshold": "0",
        "spark.rapids.sql.adaptive.broadcastThresholdBytes": "0"})
    # q3join over two partitions: exchanges, a shuffled join, a sort
    out = H.q3join(api, s.create_dataframe(li, num_partitions=2),
                   s.create_dataframe(od, num_partitions=2)).collect()
    assert out.num_rows > 0
    art = PR.load_artifacts(s.last_trace_paths["trace"])
    analysis = PR.analyze(art)  # no history directory is read
    rows = analysis["reconciliation"]
    names = {r["name"].split(".")[0] for r in rows}
    assert {"ShuffleExchangeExec", "ShuffledHashJoinExec",
            "HashAggregateExec"} <= names, names
    for r in rows:
        assert r["delta_pct"] < 1.0, r
    # every timer in the snapshot has its spans, but the waiting and
    # overlapped ones (a pipeline boundary's stall and producer times),
    # which no span feeds
    timers = {f"{k.split('#')[0]}.{m}" for k, snap in
              s.last_metrics().items() for m, v in snap.items()
              if m.endswith("Time") and v and m not in M.WAIT_TIME_METRICS}
    assert timers == {r["name"] for r in rows}
    report = PR.generate_report(art)
    for section in ("Top operators by exclusive time",
                    "Spill / retry hot spots", "Semaphore contention",
                    "reconciliation"):
        assert section in report, section


# ---------------------------------------------------------------------------
# last_metrics() against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def one_device(monkeypatch):
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])


def _rows_by_class(metrics):
    out = {}
    for key, snap in metrics.items():
        if M.NUM_OUTPUT_ROWS in snap:
            cls = key.split("#")[0]
            out[cls] = out.get(cls, 0) + snap[M.NUM_OUTPUT_ROWS]
    return out


def _classes(metrics):
    return {k.split("#")[0] for k in metrics}


QUERIES = {
    "q1": lambda api, li, od: H.q1(api, li),
    "q6": lambda api, li, od: H.q6(api, li),
    "filter_rows": lambda api, li, od: li.filter(
        api.col("l_quantity") < api.lit(10.0)).select(
        api.col("l_orderkey"), api.col("l_discount")),
    "repart_agg": lambda api, li, od: H.repart_agg(api, li),
    "q3join": lambda api, li, od: H.q3join(api, li, od),
    "sort_rows": lambda api, li, od: H.sort_rows(api, li),
}

NO_FUSION = {"spark.rapids.sql.stageFusion.enabled": "false"}


@pytest.mark.parametrize("query", list(QUERIES))
def test_last_metrics_rows_match_jax(query, tables, one_device):
    li, od = tables
    snaps, results = [], []
    for api, conf in ((torch_api(), None), (jax_api(), NO_FUSION)):
        s = api.session(conf)
        df = QUERIES[query](api, s.create_dataframe(li, num_partitions=2),
                            s.create_dataframe(od))
        results.append(df.collect())
        snaps.append(s.last_metrics())
    got, want = snaps
    assert results[0].num_rows == results[1].num_rows
    shared = _classes(got) & _classes(want)
    assert "InMemoryScanExec" in shared
    rows_got, rows_want = _rows_by_class(got), _rows_by_class(want)
    for cls in shared:
        assert rows_got.get(cls) == rows_want.get(cls), (cls, got, want)


@pytest.mark.parametrize("decode", ["device", "host"])
def test_parquet_scan_metrics_match_jax(decode, tmp_path, tables,
                                        one_device):
    li, _ = tables
    path = str(tmp_path / "li.parquet")
    # ordered by ship date, so q6's pushed date range prunes row groups
    pq.write_table(li.sort_by("l_shipdate"), path, row_group_size=2048)
    conf = {"spark.rapids.sql.decode.device.enabled":
            "true" if decode == "device" else "false"}
    snaps = []
    for api, extra in ((torch_api(), {}), (jax_api(), NO_FUSION)):
        s = api.session({**conf, **extra})
        H.q6(api, s.read_parquet(path)).collect()
        snaps.append(s.last_metrics())
    scan_keys = (M.NUM_ROW_GROUPS, M.NUM_ROW_GROUPS_PRUNED, M.READ_BYTES)

    def scan(snap):
        [(key, v)] = [(k, v) for k, v in snap.items()
                      if M.NUM_ROW_GROUPS in v]
        return key.split("#")[0], {k: v[k] for k in scan_keys}, v

    (pcls, pvals, pall), (jcls, jvals, jall) = map(scan, snaps)
    assert pcls == jcls
    assert pvals == jvals
    assert pvals[M.NUM_ROW_GROUPS_PRUNED] > 0  # the pushed filter pruned
    # the decode timer's name: the reference's where the JAX package has
    # its own
    assert M.DECODE_TIME == "gpuDecodeTime"
    assert "gpuDecodeTime" in pall and "tpuDecodeTime" in jall
    assert set(jall) - {"tpuDecodeTime"} <= set(pall)


def test_registry_levels_and_rollup():
    reg = M.MetricsRegistry(M.ESSENTIAL)
    reg.metric(M.NUM_OUTPUT_ROWS, M.ESSENTIAL).add(5)
    reg.metric(M.OP_TIME).add(100)  # MODERATE: filtered at ESSENTIAL
    assert reg.snapshot() == {M.NUM_OUTPUT_ROWS: 5}
    assert reg[M.OP_TIME] == 100
    roll = M.exec_rollup({M.NUM_OUTPUT_ROWS: 3, M.OP_TIME: 10,
                          M.SEMAPHORE_WAIT_TIME: 99, M.AGG_TIME: 5,
                          M.NUM_INPUT_BATCHES: 2})
    assert roll == {"rows": 3, "batches": 2, "dispatches": 0,
                    "time_ns": 15}
    conf = C.RapidsConf({"spark.rapids.sql.metrics.level": "debug"})
    assert M.metrics_level_from_conf(conf) == M.DEBUG
    assert M.metrics_level_from_conf(C.RapidsConf()) == M.MODERATE


def test_registry_counts_every_add_under_threads():
    """Partitions run on several threads: a metric registered and added to
    from more threads than cores, with a short switch interval, loses no
    update."""
    reg = M.MetricsRegistry()
    threads, per = 4 * (os.cpu_count() or 1), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(per):
                reg.metric(f"m{j % 3}").add(1)
                reg.metric(M.NUM_OUTPUT_ROWS).add(i)
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = reg.snapshot()
    assert sum(snap[f"m{k}"] for k in range(3)) == threads * per
    assert snap[M.NUM_OUTPUT_ROWS] == per * sum(range(threads))


# ---------------------------------------------------------------------------
# runtime instants, the event log, failures, torch.profiler
# ---------------------------------------------------------------------------

def test_retry_and_fault_instants_and_task_log(tmp_path):
    s = _traced_session(tmp_path, **{
        "spark.rapids.sql.test.injectRetryOOM": "1",
        "spark.rapids.debug.faults": "exchange.fetch:delay:1"})
    got = (s.create_dataframe(_table(), num_partitions=2)
           .repartition(3, col("k")).group_by("k")
           .agg(F.count(col("v"))).collect())
    assert got.num_rows == 40
    art = PR.load_artifacts(s.last_trace_paths["trace"])
    names = [e["name"] for e in art["events"]]
    for want in ("retryOOM", "retryAttempt", "retrySucceeded",
                 "faultInjected"):
        assert want in names, want
    retried = [t for t in art["tasks"] if t["metrics"].get("retryCount")]
    assert retried and all(t["live_query_id"] is not None for t in retried)


def test_spill_instants(tmp_path):
    s = _traced_session(tmp_path, **{
        "spark.rapids.memory.tpu.budgetBytes": str(1 << 16)})
    df = s.create_dataframe(_table(20_000), num_partitions=4).cache()
    df.count()
    df.agg(F.sum(col("v"))).collect()
    ev = PR.validate_chrome_trace(s.last_trace_paths["trace"])
    assert any(e["ph"] == "i" and e["name"] == "spillToHost" for e in ev)


def test_failing_query_fails_the_same_and_flushes(tmp_path):
    s = _traced_session(tmp_path, **{"spark.sql.ansi.enabled": "true"})
    df = s.create_dataframe(pa.table({"a": [1, 2], "b": [1, 0]})).select(
        (col("a") / col("b")).alias("q"))
    with pytest.raises(SparkException):
        df.collect()
    assert trace.active() is None
    doc = json.load(open(s.last_trace_paths["trace"]))
    assert doc["otherData"]["status"] == "failed"
    assert any(e["name"] == "queryError" for e in doc["traceEvents"])


def test_spans_forward_to_torch_profiler(tmp_path):
    """Exec spans open torch.profiler ranges of their names. The
    profiler's CPU activity records the thread that started it: behind a
    pipeline boundary the scan's spans run on a host-pool worker, so the
    scan's range is read with pipelining off, the consumer's with it
    on."""
    from torch.profiler import ProfilerActivity, profile
    for conf, want in (({}, "HashAggregateExec.aggTime"),
                       ({"spark.rapids.sql.pipeline.enabled": "false"},
                        "InMemoryScanExec.copyToDeviceTime")):
        s = _traced_session(tmp_path, **conf)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _grouped(s).collect()
        keys = {e.key for e in prof.key_averages()}
        assert "HashAggregateExec.aggTime" in keys
        assert want in keys
    # untraced: no range
    plain = TorchSession(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _grouped(plain).collect()
    assert "HashAggregateExec.aggTime" not in {
        e.key for e in prof.key_averages()}


def test_nested_collect_joins_the_outer_trace(tmp_path):
    s = _traced_session(tmp_path)
    s.create_or_replace_temp_view("t", s.create_dataframe(_table()))
    s.sql("SELECT k FROM t WHERE v > (SELECT avg(v) FROM t)").collect()
    assert trace.active() is None
    art = PR.load_artifacts(s.last_trace_paths["trace"])
    assert art["query"]["status"] == "ok"


# ---------------------------------------------------------------------------
# semaphore: direct handoff, event-driven waits
# ---------------------------------------------------------------------------

class _RecordingEvent(threading.Event):
    calls = []

    def wait(self, timeout=None):
        _RecordingEvent.calls.append(timeout)
        return super().wait(timeout)


class _ThreadingShim:
    """threading proxy whose Event records wait() timeouts."""

    def __init__(self):
        self.Event = _RecordingEvent

    def __getattr__(self, name):
        return getattr(threading, name)


def test_semaphore_waits_are_event_driven(monkeypatch):
    from spark_rapids_tpu_torch.runtime import semaphore as sem_mod
    _RecordingEvent.calls = []
    monkeypatch.setattr(sem_mod, "threading", _ThreadingShim())
    sem = sem_mod.PrioritySemaphore(1)
    sem.acquire(1)
    got = []

    def waiter():
        sem.acquire(1)
        got.append(time.perf_counter_ns())
        sem.release(1)

    t = threading.Thread(target=waiter)
    t.start()
    while not _RecordingEvent.calls:  # waiter parked
        time.sleep(0.001)
    t0 = time.perf_counter_ns()
    sem.release(1)
    t.join(timeout=5)
    assert not t.is_alive()
    assert got and (got[0] - t0) < 45_000_000, \
        "wakeup took a poll quantum — release must signal the waiter"
    assert _RecordingEvent.calls and all(
        c is None for c in _RecordingEvent.calls), _RecordingEvent.calls


def test_semaphore_wait_time_measures_real_contention():
    from spark_rapids_tpu_torch.runtime.semaphore import PrioritySemaphore
    sem = PrioritySemaphore(1)
    sem.acquire(1)
    m = M.GpuMetric("semaphoreWaitTime")
    done = []

    def waiter():
        sem.acquire(1, wait_metric=m)
        done.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)  # hold ~20ms of real contention
    sem.release(1)
    t.join(timeout=5)
    assert done
    assert 10_000_000 < m.value < 500_000_000, m.value
