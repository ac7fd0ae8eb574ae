"""The port's live observability (``spark_rapids_tpu_torch/runtime/obs``)
against the JAX package's, on the CPU.

The programs of tests/test_obs.py (the registry primitives, the publish
path, the endpoint), tests/test_live_obs.py (the state machine, progress,
cross-thread correlation, the sampler, /queries and /healthz) and
tests/test_flight.py (the rings, the dumps and their triggers, the SLO
detector) that are not bound to the history store, attribution, EXPLAIN
ANALYZE, fusion, compilation or serving, run against the port (those are
tests/test_torch_history.py's, tests/test_torch_kernel_audit.py's and
tests/test_torch_serving.py's). Parity cases run one program through
both packages with obs on: the same ``rapids_queries_total`` by status
and ``rapids_tasks_*`` counts, the same instrument roster, the same
live-state sequence and the same flight-dump triggers. Then the
port's own: the liveness probe (on the CPU, its op runs on the CPU; the
side-stream form is tests/test_torch_obs_card.py's), positive ids with
obs on and negative ones with it off, and the same rows with the live
layer off, where no obs thread runs.

Tolerances: rows exact (tests/asserts.py ``assert_tables_equal``);
histogram quantiles within 12% of numpy's percentiles (the sketch's
bound is ~4.4%).
"""
import glob
import importlib.util
import json
import logging
import os
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.runtime import obs, trace, watchdog
from spark_rapids_tpu_torch.runtime.metrics import GpuMetric
from spark_rapids_tpu_torch.runtime.obs import flight, live, sampler
from spark_rapids_tpu_torch.runtime.obs.history import plan_digest
from spark_rapids_tpu_torch.runtime.obs.registry import (
    Counter, Histogram, MetricsRegistry,
)
from spark_rapids_tpu_torch.runtime.obs.slo import SloDetector

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_spec = importlib.util.spec_from_file_location(
    "profiler_report", os.path.join(REPO, "tools", "profiler_report.py"))
PR = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PR)

#: Prometheus exposition lines (tools/obs_smoke.py's check)
_METRIC_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
    r"[-+]?(\d+\.?\d*([eE][-+]?\d+)?|NaN|nan|[Ii]nf)$")
#: the acceptance roster of tools/obs_smoke.py
ROSTER = ("rapids_semaphore_wait_ns_total",
          "rapids_spill_to_host_bytes_total", "rapids_retries_total",
          "rapids_query_wall_time_ms", "rapids_tasks_completed_total")

#: the serving layer's instruments (ROADMAP.md A11f, the last item to
#: bring preregistered instruments)
SERVING_INSTRUMENTS = {
    "rapids_serving_requests_total", "rapids_serving_rejected_total",
    "rapids_result_cache_hits_total", "rapids_result_cache_misses_total",
    "rapids_result_cache_evictions_total",
    "rapids_result_cache_bypasses_total",
    "rapids_serving_request_ms",
}

#: the live layer switched off: the plain version of this slice
OFF = {"spark.rapids.obs.enabled": "false",
       "spark.rapids.obs.flight.enabled": "false",
       "spark.rapids.obs.sampler.enabled": "false"}


def _reset_jax_obs():
    from spark_rapids_tpu.runtime import obs as jobs
    from spark_rapids_tpu.runtime.obs import flight as jflight
    jobs.shutdown_for_tests()
    jflight.uninstall_for_tests()


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Each test gets its own obs singletons (ports, registries, live
    query registry, sampler, flight recorder), in both packages."""
    reset_torch_runtime()
    _reset_jax_obs()
    yield
    reset_torch_runtime()
    _reset_jax_obs()


@pytest.fixture
def wedged_probe():
    """A probe that blocks until the test ends (then its thread exits, so
    no probe thread outlives the test)."""
    release = threading.Event()
    yield lambda: release.wait(30) or True
    release.set()


def _session(conf=None):
    return TorchSession(conf, device="cpu")


def _table(n=20_000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 40, n),
                     "v": rng.integers(1, 1000, n)})


def _df(api, s, t, threshold=10, parts=2):
    col, lit = api.col, api.lit
    return (s.create_dataframe(t, num_partitions=parts)
            .filter(col("v") > lit(threshold))
            .select(col("k"), (col("v") * lit(2)).alias("v2"))
            .group_by("k").agg(api.F.sum(col("v2")).alias("sv")))


def _query(s, t=None):
    return _df(torch_api(), s, t if t is not None else _table(4000)
               ).collect()


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _check_prometheus(text: str) -> int:
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _METRIC_LINE.match(line), f"unparseable line: {line!r}"
        n += 1
    return n


def _obs_threads():
    """Live obs threads (a wedged probe of an earlier test may linger)."""
    return {t for t in threading.enumerate()
            if t.name.startswith("rapids-obs")}


# ---------------------------------------------------------------------------
# registry primitives (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_counter_concurrent_publish_no_lost_updates():
    c = Counter("c")
    n_threads, per = 16, 5000

    def worker():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per


def test_registry_concurrent_publish_from_host_pool():
    from spark_rapids_tpu_torch.runtime.host_pool import (
        get_host_pool, reset_host_pool,
    )
    reg = MetricsRegistry()

    def publish(i):
        reg.counter("rapids_test_total").inc(2)
        reg.histogram("rapids_test_ms").observe(float(i % 50 + 1))
        return i

    reset_host_pool()
    try:
        out = list(get_host_pool().map_ordered(publish, range(400)))
        assert out == list(range(400))
        assert reg.counter("rapids_test_total").value == 800
        assert reg.histogram("rapids_test_ms").count == 400
    finally:
        reset_host_pool()


@pytest.mark.parametrize("dist,seed", [
    ("lognormal", 11), ("lognormal", 12), ("uniform", 13),
    ("exponential", 14), ("bimodal", 15)])
def test_histogram_quantiles_vs_numpy(dist, seed):
    rng = np.random.default_rng(seed)
    n = 5000
    xs = {
        "lognormal": rng.lognormal(3.0, 1.5, n),
        "uniform": rng.uniform(1.0, 1e6, n),
        "exponential": rng.exponential(1e4, n) + 1e-3,
        "bimodal": np.concatenate([rng.normal(100, 5, 2 * n // 5),
                                   rng.normal(1e5, 1e3, 3 * n // 5)]),
    }[dist]
    xs = np.abs(xs) + 1e-9
    h = Histogram("h")
    for x in xs:
        h.observe(float(x))
    for q in (0.50, 0.95, 0.99):
        est, exact = h.quantile(q), float(np.percentile(xs, q * 100))
        assert abs(est - exact) / exact < 0.12, (dist, q, est, exact)
    snap = h.snapshot()
    assert snap["count"] == len(xs)
    assert snap["min"] == pytest.approx(float(xs.min()))
    assert snap["max"] == pytest.approx(float(xs.max()))


def test_histogram_memory_bound_and_edges():
    h = Histogram("h")
    for x in 10.0 ** np.random.default_rng(0).uniform(-3, 10, 100_000):
        h.observe(float(x))
    assert h.bucket_count() < 400 and h.count == 100_000
    e = Histogram("e")
    assert e.quantile(0.5) == 0.0  # empty
    for v in (0.0, -5.0, 42.0):
        e.observe(v)
    assert e.quantile(0.99) <= 42.0 and e.snapshot()["min"] == -5.0


def test_prometheus_render_parseable_and_typed():
    reg = MetricsRegistry()
    reg.counter("rapids_a_total", "a counter").inc(3)
    reg.gauge("rapids_g", "a gauge").set(1.5)
    reg.gauge_fn("rapids_live", lambda: 7, "live gauge",
                 labels={"tier": "t0"})
    h = reg.histogram("rapids_h_ms", "a histogram")
    for v in (1.0, 10.0, 100.0):
        h.observe(v)
    text = reg.render_prometheus()
    assert _check_prometheus(text) >= 7
    assert "# TYPE rapids_a_total counter" in text
    assert "# TYPE rapids_g gauge" in text
    assert "# TYPE rapids_h_ms summary" in text
    assert 'rapids_live{tier="t0"} 7.0' in text
    assert "rapids_h_ms_count 3" in text
    reg.counter("rapids_x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("rapids_x")


# ---------------------------------------------------------------------------
# publish path (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_task_and_query_publish_with_and_without_a_consumer():
    """The endpoint consumes per-exec rollups; with no endpoint and no
    history store the per-exec publish is skipped."""
    s = _session()
    _query(s)
    snap = obs.state().registry.snapshot()
    assert snap['rapids_queries_total{status="ok"}'] == 1
    assert snap["rapids_tasks_completed_total"] >= 1
    assert snap["rapids_query_wall_time_ms"]["count"] == 1
    assert not any(k.startswith("rapids_exec_") for k in snap)
    reset_torch_runtime()
    s = _session({"spark.rapids.obs.port": str(_free_port())})
    _query(s)
    snap = obs.state().registry.snapshot()
    assert any(k.startswith("rapids_exec_rows_total") for k in snap)


def test_nested_query_joins_outer_and_unwinds():
    s = _session()
    _query(s)
    okc = 'rapids_queries_total{status="ok"}'
    before = obs.state().registry.snapshot()[okc]
    tok = obs.on_query_start()
    assert isinstance(tok, int)
    nested = obs.on_query_start()
    assert nested is obs.NESTED

    def end(t):
        obs.on_query_end(t, session=s, plan=None, status="ok",
                         error=None, duration_ns=1,
                         wall_start_unix=time.time(), trace_paths=None)

    end(nested)
    assert obs.state().registry.snapshot()[okc] == before
    end(tok)
    assert obs.state().registry.snapshot()[okc] == before + 1
    tok2 = obs.on_query_start()
    assert isinstance(tok2, int) and tok2 > tok
    end(tok2)


def test_concurrent_top_level_queries_all_count():
    sessions = [_session() for _ in range(3)]
    errors = []

    def run(s):
        try:
            _query(s)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    snap = obs.state().registry.snapshot()
    assert snap['rapids_queries_total{status="ok"}'] == 3
    assert snap["rapids_query_wall_time_ms"]["count"] == 3


def test_endpoint_scrape_and_healthz_flip(wedged_probe):
    port = _free_port()
    s = _session({"spark.rapids.obs.port": str(port),
                  "spark.rapids.obs.probeTimeoutMs": "400"})
    errors = []

    def run_queries():
        try:
            for _ in range(2):
                _query(s, _table(100_000))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=run_queries)
    th.start()
    mid = 0
    while th.is_alive():
        code, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200
        _check_prometheus(body)
        mid += 1
        time.sleep(0.02)
    th.join()
    assert not errors and mid >= 1
    code, body = _get(f"http://127.0.0.1:{port}/metrics")
    for name in ROSTER:
        assert name in body, name
    code, hz = _get(f"http://127.0.0.1:{port}/healthz")
    doc = json.loads(hz)
    assert code == 200 and doc["status"] == "ok"
    assert doc["device"]["alive"] and doc["semaphore"]["permits"] >= 1
    assert doc["queries"]["completed_ok"] >= 2
    obs.set_device_probe(wedged_probe)
    code, hz = _get(f"http://127.0.0.1:{port}/healthz")
    doc = json.loads(hz)
    assert code == 503 and doc["status"] == "degraded"
    assert doc["device"]["blocked"]
    assert _get(f"http://127.0.0.1:{port}/")[0] == 200
    assert _get(f"http://127.0.0.1:{port}/nope")[0] == 404
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics")
    with urllib.request.urlopen(req, timeout=5) as r:
        assert "text/plain" in r.headers["Content-Type"]


def test_serving_routes_answer_as_when_serving_is_off():
    """``/serving`` and ``POST /sql`` give the JAX package's answers
    while the serving layer is not installed; a cancel of an id not in
    flight is a 404."""
    port = _free_port()
    _session({"spark.rapids.obs.port": str(port)})
    assert _get(f"http://127.0.0.1:{port}/serving")[0] == 404
    base = f"http://127.0.0.1:{port}"
    for path, body in (("/sql", b'{"sql": "select 1"}'),
                       ("/queries/987/cancel", b"")):
        req = urllib.request.Request(base + path, data=body,
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=5)
            code = 200
        except urllib.error.HTTPError as e:
            code, doc = e.code, e.read().decode()
        assert code == 404
    assert "serving layer not installed" not in doc  # the cancel's doc
    assert json.loads(doc) == {"query_id": 987, "cancelled": False}


# ---------------------------------------------------------------------------
# live registry (tests/test_live_obs.py)
# ---------------------------------------------------------------------------

def test_state_machine():
    qc = live.QueryContext(1, plan_digest="d1")
    assert qc.state == "queued"
    for st in ("planning", "executing", "finishing", "ok"):
        qc.transition(st)
        assert qc.state == st
    assert [s for s, _ in qc.state_history] == [
        "queued", "planning", "executing", "finishing", "ok"]
    with pytest.raises(ValueError, match="unknown query state"):
        qc.transition("warp_speed")
    qc = live.QueryContext(1)
    qc.transition("planning")
    qc.transition("failed")
    qc.transition("executing")  # terminal sticky: ignored
    assert qc.state == "failed"
    qc2 = live.QueryContext(2)
    qc2.transition("finishing")  # out-of-order non-terminal hop ignored
    assert qc2.state == "queued"
    assert set(live.TERMINAL_STATES) <= set(live.STATES)
    for cur, nxts in live._EDGES.items():
        assert cur in live.STATES and set(nxts) <= set(live.STATES)


def test_query_lifecycle_registers_progresses_and_lands_terminal():
    s = _session()
    t = _table()
    df = _df(torch_api(), s, t)
    assert s.running_queries() == []
    df.collect()
    assert s.running_queries() == []
    last = live.queries_doc()["last_completed"]
    assert last is not None and last["state"] == "ok"
    assert last["plan_digest"] == plan_digest(df.plan)
    assert last["scan_rows"] == t.num_rows
    assert last["scan_rows_estimated"] == t.num_rows
    assert last["percent_complete"] == 100.0
    assert last["eta_seconds"] == 0.0
    assert [d["state"] for d in last["states"]] == [
        "queued", "planning", "executing", "finishing", "ok"]
    assert any(e["rows"] for e in last["execs"])


def test_failed_query_lands_failed_state():
    from spark_rapids_tpu_torch.expr.core import SparkException
    api = torch_api()
    s = _session({"spark.sql.ansi.enabled": "true"})
    t = pa.table({"v": [1, 2, 3, 4], "z": [1, 1, 0, 1]})
    df = s.create_dataframe(t).select(
        (api.col("v") / api.col("z")).alias("x"))
    with pytest.raises(SparkException):
        df.collect()
    last = live.queries_doc()["last_completed"]
    assert last is not None and last["state"] == "failed"
    assert live.running_count() == 0


def test_progress_disabled_conf_keeps_registry_empty():
    s = _session({"spark.rapids.obs.progress.enabled": "false"})
    _query(s)
    assert live.queries_doc()["last_completed"] is None
    assert s.running_queries() == []


def _poll_executing(stop, seen):
    while not stop.is_set():
        for d in live.running_docs(with_execs=False):
            if d["state"] == "executing":
                seen.append((d["query_id"], d["plan_digest"],
                             d["scan_rows"], d.get("percent_complete")))
        time.sleep(0.002)


def test_mid_flight_progress_is_live_and_monotone():
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1024"})
    t = _table(n=120_000)
    df = _df(torch_api(), s, t)
    seen: list = []
    stop = threading.Event()
    th = threading.Thread(target=_poll_executing, args=(stop, seen))
    th.start()
    try:
        df.collect()
    finally:
        stop.set()
        th.join()
    assert len(seen) >= 2, f"query too fast to observe: {seen}"
    rows = [r for _, _, r, _ in seen]
    assert rows == sorted(rows) and all(r <= t.num_rows for r in rows)
    pcts = [p for *_, p in seen if p is not None]
    assert pcts and all(0.0 <= p <= 100.0 for p in pcts)


def test_nested_collect_joins_outer_query():
    s = _session()
    small = pa.table({"k": np.arange(40), "name": np.arange(40) * 2})
    s.create_or_replace_temp_view("big", s.create_dataframe(
        _table(n=4000), 2))
    s.create_or_replace_temp_view("small", s.create_dataframe(small))
    s.sql("select b.k, sum(s.name) from big b join small s on "
          "b.k = s.k group by b.k").collect()
    last = live.queries_doc()["last_completed"]
    assert last is not None and last["state"] == "ok"
    assert last["query_id"] is not None
    assert live.running_count() == 0
    assert obs.state().registry.snapshot()[
        'rapids_queries_total{status="ok"}'] == 1


def test_concurrent_queries_see_only_their_own_progress():
    api = torch_api()
    n_threads = 4
    tables = {i: _table(n=60_000 + 10_000 * i, seed=i)
              for i in range(n_threads)}
    dfs = {i: _df(api, _session(
        {"spark.rapids.sql.reader.batchSizeRows": "1024"}), tables[i],
        threshold=10 + i) for i in range(n_threads)}
    digests = {plan_digest(dfs[i].plan): i for i in range(n_threads)}
    assert len(digests) == n_threads
    seen: list = []
    errors: list = []
    stop = threading.Event()

    def run(i):
        try:
            dfs[i].collect()
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    poller = threading.Thread(target=_poll_executing, args=(stop, seen))
    poller.start()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stop.set()
    poller.join()
    assert not errors, errors
    assert live.running_count() == 0
    by_q: dict = {}
    for qid, dg, rows, _ in seen:
        by_q.setdefault(qid, []).append((dg, rows))
    assert len(by_q) == n_threads, by_q.keys()
    for qid, snaps in by_q.items():
        ds = {d for d, _ in snaps}
        assert len(ds) == 1, f"query {qid} showed digests {ds}"
        i = digests[next(iter(ds))]
        rows = [r for _, r in snaps]
        assert rows == sorted(rows)
        assert all(r <= tables[i].num_rows for r in rows)


def test_binding_propagates_to_pool_waves_and_pipelines():
    from spark_rapids_tpu_torch.runtime import lifecycle
    from spark_rapids_tpu_torch.runtime.host_pool import (
        get_host_pool, run_task_wave,
    )
    from spark_rapids_tpu_torch.runtime.pipeline import PipelinedIterator
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    # the lifecycle's names are the live registry's functions
    assert lifecycle.bind is live.bind
    assert lifecycle.current_query_id is live.current_query_id
    assert live.current_query_id() is None
    assert live.bind(7) is None and live.current_query_id() == 7
    assert live.run_bound(9, live.current_query_id) == 9
    assert live.current_query_id() == 7
    live.bind(None)
    pool = get_host_pool()
    live.bind(42)
    try:
        assert pool.submit(live.current_query_id).result() == 42
    finally:
        live.bind(None)
    assert pool.submit(live.current_query_id).result() is None

    def work(i):
        return live.current_query_id(), TaskContext().query_id

    live.bind(11)
    try:
        assert run_task_wave(work, range(4)) == [(11, 11)] * 4
    finally:
        live.bind(None)

    def source():
        for _ in range(6):
            yield live.current_query_id()

    live.bind(5)
    try:
        pit = PipelinedIterator(source(), depth=2, label="t")
    finally:
        live.bind(None)
    got = list(pit)
    pit.close()
    assert got == [5] * 6


def test_flight_ring_entries_tagged_with_query_id(tmp_path):
    rec = flight.install(capacity=64, out_dir=str(tmp_path),
                         min_interval_s=0.0)
    live.bind(33)
    try:
        rec.record("tagged", "t", 0, 1)
        rec.instant("mark", "t")
    finally:
        live.bind(None)
    rec.record("untagged", "t", 2, 1)
    by_name = {e[0]: e for e in rec._rings[0].buf if e is not None}
    assert by_name["tagged"][5] == 33 and by_name["mark"][5] == 33
    assert by_name["untagged"][5] is None
    events = {e["name"]: e for e in
              json.load(open(rec.dump("test")))["traceEvents"]}
    assert events["tagged"]["args"]["query_id"] == 33
    assert "query_id" not in (events["untagged"].get("args") or {})


def test_query_log_filter_stamps_and_installs_once():
    f = live.QueryLogFilter()
    rec = logging.LogRecord("spark_rapids_tpu_torch", logging.INFO, "x",
                            1, "msg", (), None)
    f.filter(rec)
    assert rec.query_id == "-"
    live.bind(8)
    try:
        f.filter(rec)
        assert rec.query_id == 8
    finally:
        live.bind(None)
    lg = logging.getLogger("spark_rapids_tpu_torch")
    for _ in range(2):  # a second install adds no second filter
        _session()
        assert len([x for x in lg.filters
                    if isinstance(x, live.QueryLogFilter)]) == 1


def test_query_start_marker_in_flight_dump(tmp_path):
    flight.install(capacity=2048, out_dir=str(tmp_path),
                   min_interval_s=0.0)
    s = _session()
    df = _df(torch_api(), s, _table(n=4000))
    df.collect()
    events = [e for e in json.load(open(flight.dump("test")))[
        "traceEvents"] if e["name"] == "queryStart"]
    assert events, "no queryStart instant reached the flight ring"
    args = events[-1].get("args") or {}
    assert isinstance(args.get("query_id"), int) and args["query_id"] > 0
    assert args.get("plan_digest") == plan_digest(df.plan)


# -- the sampler ------------------------------------------------------------

def test_sampler_rings_bounded_and_ticks_annotated():
    smp = sampler.install(interval_ms=50, ring_size=16, start=False)
    try:
        for _ in range(40):
            smp.sample_once()
        assert smp.ticks == 40 and set(smp.rings) == set(sampler.SERIES)
        for name, ring in smp.rings.items():
            snap = ring.snapshot()
            assert len(snap) <= 16, f"{name} ring unbounded"
            assert ring.idx == 40
            assert all(isinstance(x[1], float) for x in snap)
        latest = smp.latest()
        assert set(latest) == set(sampler.SERIES)
        assert latest["process_rss_bytes"] > 0.0
        live.register(77)
        smp.sample_once()
        assert smp.rings["running_queries"].latest()[1:] == (1.0, (77,))
        live.finish(77, "ok")
        smp.sample_once()
        assert smp.rings["running_queries"].latest()[1:] == (0.0, ())
    finally:
        sampler.uninstall_for_tests()


def test_sampler_chrome_events_and_flight_embed(tmp_path):
    rec = flight.install(capacity=64, out_dir=str(tmp_path),
                         min_interval_s=0.0)
    smp = sampler.install(interval_ms=50, ring_size=8, start=False)
    try:
        smp.sample_once()
        evs = smp.chrome_events(0, 1)
        names = {f"sampler/{x}" for x in sampler.SERIES}
        assert evs and all(e["ph"] == "C" for e in evs)
        assert {e["name"] for e in evs} == names
        rec.record("e", "t", 0, 1)
        counters = {e["name"] for e in
                    json.load(open(rec.dump("test")))["traceEvents"]
                    if e.get("ph") == "C"}
        assert names <= counters
    finally:
        sampler.uninstall_for_tests()


def test_sampler_pipeline_stall_gauge_and_service_thread():
    from spark_rapids_tpu_torch.runtime import pipeline as PL
    assert PL.stalled_consumers() == 0
    PL._stall_enter()
    try:
        smp = sampler.install(interval_ms=50, ring_size=8, start=False)
        smp.sample_once()
        assert smp.rings["pipeline_stalled_consumers"].latest()[1] == 1.0
    finally:
        PL._stall_exit()
        sampler.uninstall_for_tests()
    smp = sampler.install(interval_ms=10, ring_size=32, start=True)
    try:
        deadline = time.time() + 5.0
        while smp.ticks < 3 and time.time() < deadline:
            time.sleep(0.02)
        assert smp.ticks >= 3, "sampler service thread never ticked"
    finally:
        sampler.uninstall_for_tests()


def test_sampler_gauges_on_metrics_and_console_renders():
    s = _session()
    _query(s)
    text = obs.state().registry.render_prometheus()
    for series in sampler.SERIES:
        assert f"rapids_sampler_{series}" in text
    from spark_rapids_tpu_torch.runtime.obs.console import render_live
    html = render_live()
    assert "Last completed" in html and "svg" in html


# -- /queries and /healthz ------------------------------------------------------

def test_queries_endpoint_scrape_while_running_race_clean():
    port = _free_port()
    s = _session({"spark.rapids.obs.port": str(port),
                  "spark.rapids.sql.reader.batchSizeRows": "1024"})
    t = _table(n=80_000)
    errors: list = []

    def run_queries():
        try:
            for _ in range(2):
                _df(torch_api(), s, t).collect()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=run_queries)
    th.start()
    scrapes, executing = 0, 0
    while th.is_alive():
        code, body = _get(f"http://127.0.0.1:{port}/queries")
        assert code == 200, body
        doc = json.loads(body)
        scrapes += 1
        for d in doc.get("running") or []:
            assert d["state"] in live.STATES
            executing += d["state"] == "executing"
        time.sleep(0.005)
    th.join()
    assert not errors, errors
    assert scrapes >= 3
    assert executing >= 1, "no scrape caught the query executing"
    code, body = _get(f"http://127.0.0.1:{port}/console")
    assert code == 200 and "Running queries" in body
    code, body = _get(f"http://127.0.0.1:{port}/queries")
    assert json.loads(body)["last_completed"]["state"] == "ok"


def test_healthz_queries_doc_shape():
    s = _session()
    _query(s)
    doc = obs.healthz()
    q = doc["queries"]
    assert q["running"] == [] and q["completed_ok"] >= 1
    assert q["last_completed"]["status"] == "ok"
    assert doc["sampler"] is not None and doc["sampler"]["enabled"]


class _FullSem:
    permits = 2
    available = 0
    waiting = 1


@pytest.mark.parametrize("progress", ["true", "false"])
def test_healthz_defers_probe_while_query_holds_all_permits(
        monkeypatch, progress, wedged_probe):
    """Deferral keys off the unconditional active-query counter, so it
    protects a busy engine with the live registry off too."""
    _session({"spark.rapids.obs.progress.enabled": progress})
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    monkeypatch.setattr(SEM, "peek_semaphore", lambda: _FullSem())
    obs.set_device_probe(wedged_probe)
    if progress == "true":
        live.register(123).transition("planning")
    st = obs.state()
    with st._lock:
        st._active += 1
    try:
        t0 = time.time()
        doc = obs.healthz()
        assert time.time() - t0 < 1.0, "deferred probe still ran"
        assert doc["device"]["deferred"] is True
        assert doc["device"]["alive"] is None and doc["status"] == "ok"
        assert [d["query_id"] for d in doc["queries"]["running"]] == (
            [123] if progress == "true" else [])
    finally:
        live.finish(123, "ok")
        with st._lock:
            st._active -= 1
    if progress == "true":
        # permits saturated but no running query: the probe runs (and
        # this one blocks -> degraded)
        doc = obs.healthz()
        assert doc["device"]["blocked"] and doc["status"] == "degraded"


def test_failed_query_progress_not_forced_complete():
    from spark_rapids_tpu_torch.runtime.metrics import NUM_OUTPUT_ROWS

    class _Leaf:
        children = ()
        members = None

        class plan:
            @staticmethod
            def estimated_rows():
                return 1000

        class metrics:
            metrics: dict = {}

    leaf = _Leaf()
    m = GpuMetric(NUM_OUTPUT_ROWS)
    m.add(100)
    leaf.metrics.metrics = {NUM_OUTPUT_ROWS: m}
    for qid, end, pct in ((9, "failed", 10.0), (10, "degraded", 100.0)):
        qc = live.QueryContext(qid)
        qc.transition("planning")
        qc.attach_exec(leaf)
        qc.transition(end)
        assert qc.progress_doc()["percent_complete"] == pct


def test_progress_never_resolves_a_lazy_row_count():
    """A scrape peeks: a row count still on the device is not read (no
    device sync), and counts as 0 until the query resolves it."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import LazyRowCount
    m = GpuMetric("numOutputRows")
    m.add(5)
    lazy = LazyRowCount(torch.tensor(7))
    m.add(lazy)
    assert m.peek() == 5 and lazy._val is None
    assert m.value == 12 and m.peek() == 12


# ---------------------------------------------------------------------------
# the flight recorder and the SLO detector (tests/test_flight.py)
# ---------------------------------------------------------------------------

def _fsess(tmp_path, **over):
    conf = {"spark.rapids.obs.flight.path": str(tmp_path / "flight"),
            "spark.rapids.obs.flight.minIntervalSeconds": "0",
            "spark.rapids.sql.reader.batchSizeRows": "4096"}
    conf.update(over)
    return _session(conf)


def _fdf(api, s):
    rng = np.random.default_rng(7)
    t = pa.table({"k": rng.integers(0, 20, 20_000),
                  "v": rng.integers(0, 100, 20_000)})
    return (s.create_dataframe(t, num_partitions=2)
            .filter(api.col("v") > api.lit(10))
            .group_by("k").agg(api.F.sum(api.col("v")).alias("sv")))


def _dumps(tmp_path):
    return sorted(glob.glob(str(tmp_path / "flight" / "flight_*.json")))


def test_ring_is_bounded_and_keeps_newest(tmp_path):
    rec = flight.FlightRecorder(capacity=16, out_dir=str(tmp_path),
                                min_interval_s=0.0)
    for i in range(100):
        rec.record(f"e{i}", "t", i, 1)
    doc = json.load(open(rec.dump("test")))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {f"e{i}" for i in range(84, 100)}
    assert doc["otherData"]["dropped_events"] == 84


def test_flight_span_feeds_metric_and_ring_and_rate_limit(tmp_path):
    rec = flight.FlightRecorder(capacity=64, out_dir=str(tmp_path),
                                min_interval_s=60.0)
    m = GpuMetric("opTime")
    with rec.span("Exec.opTime", m, "exec"):
        time.sleep(0.002)
    assert m.value >= 2_000_000
    rec.instant("somethingHappened", "t", {"x": 1})
    p1 = rec.dump("first")
    assert rec.dump("second") is None  # rate-limited
    events = PR.validate_chrome_trace(p1)
    spans = [e for e in events if e["name"] == "Exec.opTime"]
    assert len(spans) == 1 and spans[0]["dur"] >= 2000
    inst = [e for e in events if e["name"] == "somethingHappened"]
    assert inst[0]["ph"] == "i" and inst[0]["args"] == {"x": 1}


@pytest.mark.parametrize("start_seq,want", [
    (0, {"flight_0003_test.json", "flight_0004_test.json",
         "flight_0005_test.json"}),
    (9998, {"flight_10001_test.json", "flight_10002_test.json",
            "flight_10003_test.json"})])
def test_dump_retention_bounded(tmp_path, start_seq, want):
    """Pruning parses the seq: lexicographic order would put
    flight_10001 before flight_9999 and delete the newest dumps."""
    rec = flight.FlightRecorder(capacity=16, out_dir=str(tmp_path),
                                min_interval_s=0.0, max_dumps=3)
    rec.record("e", "t", 0, 1)
    rec._seq = start_seq
    for _ in range(5):
        rec.dump("test")
    kept = {os.path.basename(p)
            for p in glob.glob(str(tmp_path / "flight_*.json"))}
    assert kept == want


def test_failed_write_does_not_eat_the_rate_interval(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("in the way")
    rec = flight.install(capacity=16, out_dir=str(blocked),
                         min_interval_s=3600.0)
    rec.record("e", "t", 0, 1)
    assert flight.dump("first") is None  # write failed, swallowed
    rec.out_dir = str(tmp_path / "ok")
    assert flight.dump("second") is not None
    rec = flight.install(capacity=16, out_dir="/nonexistent\0bad")
    rec.record("e", "t", 0, 1)
    assert flight.dump("broken") is None  # never raises


def test_trace_fastpaths_feed_flight_when_tracing_off(tmp_path):
    assert trace.active() is None
    rec = flight.install(capacity=64, out_dir=str(tmp_path))
    m = GpuMetric("opTime")

    class FakeExec:
        lore_id = None

    with trace.exec_span(FakeExec(), m):
        pass
    with trace.metric_span("manual.span", m):
        pass
    with trace.span("plain.span"):
        pass
    trace.instant("anInstant")
    trace.emit_span("emitted.span", time.perf_counter_ns(), 5)
    with trace.span("debug.span", level=trace.DEBUG):
        pass
    trace.instant("debugInstant", level=trace.DEBUG)
    names = {e["name"]
             for e in PR.validate_chrome_trace(rec.dump("test"))}
    assert {"FakeExec.opTime", "manual.span", "plain.span",
            "anInstant", "emitted.span"} <= names
    assert "debug.span" not in names and "debugInstant" not in names


def test_traced_debug_spans_filtered_from_ring(tmp_path):
    from spark_rapids_tpu_torch import config as C
    rec = flight.install(capacity=64, out_dir=str(tmp_path))
    qt = trace.start_query(C.RapidsConf({
        "spark.rapids.sql.trace.enabled": "true",
        "spark.rapids.sql.trace.path": str(tmp_path / "tr"),
        "spark.rapids.sql.trace.level": "DEBUG"}))
    try:
        with trace.span("moderate.span"):
            pass
        with trace.span("debug.span", level=trace.DEBUG):
            pass
    finally:
        trace.end_query(qt)
    names = {e["name"]
             for e in PR.validate_chrome_trace(rec.dump("test"))}
    assert "moderate.span" in names and "debug.span" not in names


def test_disabled_path_returns_pretrace_objects():
    flight.uninstall_for_tests()
    m = GpuMetric("opTime")
    assert type(trace.metric_span("x", m)).__name__ == "_Timer"
    assert trace.span("x") is trace._NULL
    assert flight.dump("nothing") is None and flight.doc() is None


def test_failed_query_dumps_readable_trace(tmp_path):
    """The fault fires at the third batch's decode, so the dump holds the
    operator spans of the batches before it."""
    s = _fsess(tmp_path,
               **{"spark.rapids.debug.faults": "scan.decode:ioerror:1,2"})
    with pytest.raises(Exception):
        _fdf(torch_api(), s).collect()
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "query_failed" in dumps[0]
    events = PR.validate_chrome_trace(dumps[0])
    names = {e["name"] for e in events}
    assert sum(1 for e in events if e["ph"] == "X") > 0
    assert {"faultInjected", "queryError", "flightTrigger",
            "queryStart"} <= names
    other = json.load(open(dumps[0]))["otherData"]
    assert other["reason"] == "query_failed"
    assert other["error"] == "InjectedFaultError"
    qid = other["query_id"]
    assert isinstance(qid, int) and qid > 0
    start = [e for e in events if e["name"] == "queryStart"]
    assert start[-1]["args"]["query_id"] == qid
    reg = obs.state().registry
    assert reg.counter("rapids_faults_injected_total",
                       labels={"site": "scan.decode"}).value >= 1
    assert reg.counter("rapids_flight_dumps_total",
                       labels={"reason": "query_failed"}).value == 1


def test_watchdog_timeout_dumps(tmp_path):
    _session()
    flight.install(capacity=64, out_dir=str(tmp_path / "flight"))
    wd = watchdog.DispatchWatchdog(timeout_s=0.03)
    wd.start()
    try:
        with wd.guard("device.dispatch"):
            time.sleep(0.3)
        deadline = time.time() + 5
        while wd.timeouts_reported == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert wd.timeouts_reported >= 1
    finally:
        wd.stop()
        watchdog.uninstall_for_tests()
    dumps = _dumps(tmp_path)
    assert dumps and "watchdog_timeout" in dumps[0]
    events = PR.validate_chrome_trace(dumps[0])
    assert any(e["name"] == "watchdogDispatchTimeout" for e in events)
    assert obs.state().registry.counter(
        "rapids_watchdog_dispatch_timeouts_total").value >= 1


def test_breaker_open_dumps(tmp_path):
    _session()
    flight.install(capacity=64, out_dir=str(tmp_path / "flight"))
    brk = watchdog.CircuitBreaker(failure_threshold=1)
    brk.record_failure("SomeDeviceError")
    assert brk.state == "open"
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "breaker_open" in dumps[0]
    assert json.load(open(dumps[0]))["otherData"]["error"] == \
        "SomeDeviceError"
    assert obs.state().registry.counter(
        "rapids_breaker_transitions_total", labels={"to": "open"}
    ).value == 1


def test_slo_detector_unit():
    det = SloDetector(factor=2.0, min_runs=3, abs_seconds=0.0)
    for v in (1.0, 1.1, 0.9, 1.9):
        assert det.record("d1", v) is None
    b = det.record("d1", 5.0)
    assert b is not None and b["kind"] == "baseline"
    assert 0.9 < b["baseline_seconds"] < 1.5 and b["runs"] >= 3
    b2 = det.record("d1", 5.0)  # the breaching run did not fold in
    assert abs(b2["baseline_seconds"] - b["baseline_seconds"]) < 1e-9
    assert det.breaches == 2
    det = SloDetector(factor=100.0, min_runs=2, abs_seconds=0.5, window=4)
    assert det.record("d", 0.4) is None
    b = det.record("d", 0.6)
    assert b["kind"] == "absolute" and b["threshold_seconds"] == 0.5
    for i in range(10):
        det.observe("d", float(i))
    assert det.baseline("d")["runs"] == 4
    det = SloDetector(enabled=False, abs_seconds=0.001)
    assert det.record("d", 10.0) is None and det.breaches == 0


def test_slo_breach_end_to_end(tmp_path):
    s = _fsess(tmp_path, **{"spark.rapids.obs.slo.latencySeconds":
                            "0.000001"})
    _fdf(torch_api(), s).collect()
    st = obs.state()
    assert st.slo.breaches == 1
    assert st.registry.counter("rapids_slo_breaches_total").value == 1
    hz = obs.healthz()
    last_slow = hz["slo"]["last_slow"]
    assert last_slow["plan_digest"]
    assert last_slow["breach"]["kind"] == "absolute"
    assert last_slow["flight_dump"] and os.path.exists(
        last_slow["flight_dump"])
    assert hz["flight"]["last_dump"]["reason"] == "slo_breach"
    events = PR.validate_chrome_trace(last_slow["flight_dump"])
    assert any(e["name"] == "slowQuery" for e in events)
    assert hz["queries"]["last_completed"]["slo_breach"] is True


def test_always_on_span_cost_is_bounded(tmp_path):
    rec = flight.install(capacity=2048, out_dir=str(tmp_path))
    m = GpuMetric("opTime")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.metric_span("x", m):
            pass
    per_call_us = (time.perf_counter() - t0) / n * 1e6
    assert per_call_us < 50, f"flight span costs {per_call_us:.1f}us"
    assert rec.doc()["enabled"]


# ---------------------------------------------------------------------------
# parity with the JAX package: one program, obs on in both
# ---------------------------------------------------------------------------

def _run_both(program, conf=None, tmp_path=None):
    """program(api, session) in both packages with the live layer at its
    defaults; returns {name: (rows or the error, registry snapshot,
    last completed live doc, flight dumps)}."""
    out = {}
    for name, api in (("port", torch_api()), ("jax", jax_api())):
        c = dict(conf or {})
        if tmp_path is not None:
            c["spark.rapids.obs.flight.path"] = str(tmp_path / name)
            c["spark.rapids.obs.flight.minIntervalSeconds"] = "0"
        s = api.session(c)
        try:
            res = program(api, s).collect()
        except Exception as e:  # noqa: BLE001 - the error is the answer
            res = e
        if name == "port":
            st, lv = obs.state(), live
        else:
            from spark_rapids_tpu.runtime import obs as jobs
            from spark_rapids_tpu.runtime.obs import live as jlive
            st, lv = jobs.state(), jlive
        dumps = sorted(os.path.basename(p).split("_", 2)[2]
                       for p in glob.glob(str(tmp_path / name / "*.json"))
                       ) if tmp_path is not None else []
        out[name] = (res, st.registry.snapshot(),
                     lv.queries_doc()["last_completed"], dumps)
    return out


def _counts(snap):
    return {k: v for k, v in snap.items()
            if k.startswith(("rapids_queries_total", "rapids_tasks_"))}


def _one_part(api, s):
    return s.create_dataframe(_table(3000)).filter(
        api.col("v") > api.lit(500)).select(
        api.col("k"), (api.col("v") + api.lit(1)).alias("w"))


def _ansi_fail(api, s):
    t = pa.table({"v": [1, 2, 3, 4], "z": [1, 1, 0, 1]})
    return s.create_dataframe(t).select(
        (api.col("v") / api.col("z")).alias("x"))


def _fault_fail(api, s):
    return _one_part(api, s)


@pytest.mark.parametrize("case", ["ok", "ansi_failed", "fault_failed",
                                  "fault_degraded"])
def test_counters_states_and_dumps_equal_jax(case, tmp_path):
    """The same program through both packages: the same rows (or both
    raise), the same rapids_queries_total by status and rapids_tasks_*
    counts, the same live-state sequence, and the same flight dumps."""
    program, conf = {
        "ok": (_one_part, None),
        "ansi_failed": (_ansi_fail, {"spark.sql.ansi.enabled": "true"}),
        "fault_failed": (_fault_fail, {
            "spark.rapids.debug.faults": "scan.decode:ioerror"}),
        "fault_degraded": (_fault_fail, {
            "spark.rapids.debug.faults": "scan.decode:ioerror",
            "spark.rapids.fallback.cpu.enabled": "true"}),
    }[case]
    got = _run_both(program, conf, tmp_path)
    (pr, ps, pl, pd), (jr, js, jl, jd) = got["port"], got["jax"]
    if isinstance(jr, Exception):
        assert isinstance(pr, Exception), pr
    else:
        assert_tables_equal(pr, jr, ignore_order=True)
    assert _counts(ps) == _counts(js)
    assert [d["state"] for d in pl["states"]] == \
        [d["state"] for d in jl["states"]]
    assert pd == jd
    status = {"ok": "ok", "ansi_failed": "failed",
              "fault_failed": "failed",
              "fault_degraded": "degraded"}[case]
    assert ps[f'rapids_queries_total{{status="{status}"}}'] == 1
    assert pd == ([] if status == "ok" else [f"query_{status}.json"])


def test_roster_equals_jax_less_later_items():
    from spark_rapids_tpu.runtime.obs import _preregister as jax_pre
    from spark_rapids_tpu.runtime.obs.registry import \
        MetricsRegistry as JaxRegistry

    def names(reg):
        return {m.name for m in reg._metrics.values()}

    jreg, preg = JaxRegistry(), MetricsRegistry()
    jax_pre(jreg)
    obs._preregister(preg)
    assert SERVING_INSTRUMENTS <= names(preg)
    assert names(preg) == names(jreg)
    assert set(preg._metrics) == set(jreg._metrics)


def test_config_keys_and_defaults_equal_jax():
    from spark_rapids_tpu import config as JC

    from spark_rapids_tpu_torch import config as PC
    want = {k: JC._REGISTRY[k].default for k in JC._REGISTRY
            if k.startswith("spark.rapids.obs.")}
    got = {k: PC._REGISTRY[k].default for k in PC.keys()
           if k.startswith("spark.rapids.obs.")}
    assert len(got) == 30 and set(got) == set(want)
    import tempfile
    want["spark.rapids.obs.flight.path"] = os.path.join(
        tempfile.gettempdir(), "rapids_tpu_flight")
    want["spark.rapids.obs.reqtrace.path"] = os.path.join(
        tempfile.gettempdir(), "rapids_tpu_reqtrace")
    # the stated exceptions: the roofline peaks are the H100 SXM's (data
    # sheet, 700 W), not the TPU's 819 GB/s and 197 TFLOP/s
    assert (want.pop("spark.rapids.obs.audit.peakGbps"),
            want.pop("spark.rapids.obs.audit.peakGflops")) == \
        (819.0, 197000.0)
    assert (got.pop("spark.rapids.obs.audit.peakGbps"),
            got.pop("spark.rapids.obs.audit.peakGflops")) == \
        (3350.0, 66900.0)
    assert got == want
    assert PC._REGISTRY["spark.sql.caseSensitive"].default is False


# ---------------------------------------------------------------------------
# the port's own: the probe, ids, and the layer switched off
# ---------------------------------------------------------------------------

def test_cpu_probe_runs_its_op_on_the_cpu():
    from spark_rapids_tpu_torch.runtime.obs.endpoint import (
        DeviceProbe, device_probe,
    )
    assert device_probe("cpu")() is True
    doc = DeviceProbe(device_probe("cpu"), timeout_s=5.0).check()
    assert doc["alive"] is True and doc["blocked"] is False
    assert doc["probe_ms"] is not None
    _session({"spark.rapids.obs.port": str(_free_port())})
    st = obs.state()
    assert st.device.type == "cpu" and obs.healthz()["device"]["alive"]


def test_query_ids_positive_with_obs_and_negative_without():
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    seen = []
    orig = LC.begin_action

    def spy(query_id, conf, timeout_seconds=None):
        tok = orig(query_id, conf, timeout_seconds=timeout_seconds)
        seen.append(tok.query_id)
        return tok

    LC.begin_action = spy
    try:
        _query(_session())
        # the live layer is process-wide: off means no session installed it
        reset_torch_runtime()
        _query(_session(OFF))
    finally:
        LC.begin_action = orig
    assert seen[0] > 0 and seen[1] < 0


@pytest.mark.parametrize("program", ["agg", "join_sql", "failed"])
def test_layer_off_gives_the_same_rows_and_runs_no_thread(program):
    """The plain version of this slice: the same session with the live
    layer off answers the same rows (or raises the same error), installs
    nothing and starts no obs thread."""
    api = torch_api()

    def run(conf):
        s = _session(dict(conf or {}, **{"spark.sql.ansi.enabled":
                                         str(program == "failed")}))
        if program == "agg":
            return _df(api, s, _table(8000)).collect()
        if program == "failed":
            try:
                _ansi_fail(api, s).collect()
            except Exception as e:  # noqa: BLE001
                return type(e).__name__
        s.create_or_replace_temp_view("big", s.create_dataframe(
            _table(n=4000), 2))
        s.create_or_replace_temp_view("small", s.create_dataframe(
            pa.table({"k": np.arange(40), "name": np.arange(40) * 2})))
        return s.sql("select b.k, sum(s.name) from big b join small s "
                     "on b.k = s.k group by b.k").collect()

    on = run(None)
    assert obs.state() is not None and sampler.sampler() is not None
    reset_torch_runtime()
    before = _obs_threads()
    off = run(OFF)
    assert obs.state() is None and flight.recorder() is None
    assert sampler.sampler() is None and _obs_threads() <= before
    if isinstance(on, str):
        assert on == off == "SparkException"
    else:
        assert_tables_equal(on, off, ignore_order=True)
