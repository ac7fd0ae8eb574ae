"""The port's query history, wall-time attribution, measured cost pass and
EXPLAIN ANALYZE (``spark_rapids_tpu_torch/runtime/obs/{history,
attribution}.py``, ``plan/cost.py``'s measured pass, the session's
reports and ``DataFrame.to_device_batches``) against the JAX package's,
on the CPU.

The programs of tests/test_obs.py (the history round trip, the failed
query's record, EXPLAIN ANALYZE, ``tools/history_server.py`` and
``tools/profiler_report.py`` over the port's store), tests/test_flight.py
(the attribution cases; the compile bucket on a fresh cache becomes a
first ``ops/_build.load`` with its build step stubbed, since the CPU
tests run without nvcc) and tests/test_adaptive.py (the measured-cost cases
with hand-seeded roofline docs, the adaptive section of EXPLAIN ANALYZE,
the ``rapids_aqe_*`` counters) run against the port.
``test_nds_scorecard_history_round_trip`` is left out: tools/nds_probe.py
drives the JAX package's session only.

Parity cases run one program through both packages with history on: the
same record keys and the same type, status, plan digest, SQL, fallback
reasons, decision kinds, conf delta on the shared keys and
``fusion_groups``; the
same bucket roster with buckets summing to the wall time; the same
measured collapse of pctl_shuffled's exchange. The JAX package plans for
one device here, as the port does. Then the port's own: the metric names
each land in their bucket, the default epilogue resolves no lazy device
count, the handoff's batches are the collect's.

Tolerances: rows exact (tests/asserts.py ``assert_tables_equal``) but
pctl_shuffled's interpolated percentile against the JAX package, which
XLA's CPU backend contracts into an FMA (1e-12 relative); buckets sum to
the wall within 1% (exact by construction).
"""
import glob
import importlib.util
import json
import os
import re
import time

import jax
import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu_torch import config as PC
from spark_rapids_tpu_torch.columnar.batch import to_arrow
from spark_rapids_tpu_torch.exec import adaptive as AQ
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.ops import _build
from spark_rapids_tpu_torch.plan import cost as COST
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import obs
from spark_rapids_tpu_torch.runtime.obs import attribution
from spark_rapids_tpu_torch.runtime.obs.history import (
    QueryHistoryStore, conf_delta, plan_digest,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "spark_rapids_tpu_torch")
JAX, TORCH = jax_api(), torch_api()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PR = _tool("profiler_report")
HS = _tool("history_server")


def _reset_jax():
    from spark_rapids_tpu.exec import adaptive as JAQ
    from spark_rapids_tpu.plan import cost as JCOST
    from spark_rapids_tpu.runtime import obs as jobs
    from spark_rapids_tpu.runtime.obs import attribution as jattr
    from spark_rapids_tpu.runtime.obs import flight as jflight
    jobs.shutdown_for_tests()
    jflight.uninstall_for_tests()
    jattr.reset_for_tests()
    JCOST.reset_for_tests()
    JAQ.reset_for_tests()


def _reset_torch():
    reset_torch_runtime()
    attribution.reset_for_tests()
    COST.reset_for_tests()
    AQ.reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' process-wide state (the obs singletons with their
    history stores, the attribution aggregate, the measured-hint memo,
    the adaptive recorder) starts empty, and the JAX package plans for
    one device, as the port does."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    _reset_torch()
    _reset_jax()
    yield
    _reset_torch()
    _reset_jax()


@pytest.fixture(scope="module")
def lineitem():
    return H.make_lineitem(4000)


def _table(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 40, n),
                     "v": rng.integers(1, 1000, n),
                     "d": rng.uniform(0, 1, n)})


def _grouped(api, s, t=None, threshold=10):
    """tests/test_obs.py's _query."""
    col, lit, F = api.col, api.lit, api.F
    return (s.create_dataframe(t if t is not None else _table(),
                               num_partitions=2)
            .filter(col("v") > lit(threshold))
            .select(col("k"), (col("v") * lit(2)).alias("v2"))
            .group_by("k").agg(F.sum(col("v2")).alias("sv")))


def _session(conf=None):
    return TORCH.session(dict(conf or {}))


def _hist(tmp_path, name="hist", **extra):
    return {"spark.rapids.obs.historyDir": str(tmp_path / name), **extra}


def _records(path):
    return QueryHistoryStore(str(path)).read_all()


def _execs(session, name):
    return [e for e in session.last_exec.walk() if type(e).__name__ == name]


def _decisions(session, kind=None):
    ds = (session.last_aqe() or {}).get("decisions", [])
    return [d for d in ds if kind is None or d["kind"] == kind]


def _reconciles(doc):
    total = sum(doc["buckets"].values())
    return abs(total - doc["wall_seconds"]) <= 0.01 * doc["wall_seconds"]


# ---------------------------------------------------------------------------
# the history store (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_history_round_trip_and_digest_stability(tmp_path):
    s = _session(_hist(tmp_path))
    _grouped(TORCH, s).collect()
    _grouped(TORCH, s).collect()
    # a different query gets a different digest
    _grouped(TORCH, s, threshold=999).collect()
    recs = _records(tmp_path / "hist")
    assert len(recs) == 3
    assert {r["status"] for r in recs} == {"ok"}
    d1, d2, d3 = (r["plan_digest"] for r in recs)
    assert d1 == d2 and d1 != d3
    assert QueryHistoryStore(str(tmp_path / "hist")).by_digest(d1) \
        == recs[:2]
    r = recs[0]
    assert r["physical_plan"] and r["execs"] and r["annotated_plan"]
    assert any(v["_rollup"]["rows"] > 0 for v in r["execs"].values())
    assert PC.OBS_HISTORY_DIR.key in r["conf_delta"]
    assert r["duration_ns"] > 0 and r["query_id"] == 1
    assert r["fusion_groups"] == [] and "roofline" not in r
    assert _reconciles(r["attribution"])


def test_failed_query_recorded_and_trace_finalized(tmp_path):
    s = _session({**_hist(tmp_path),
                  "spark.rapids.sql.trace.enabled": "true",
                  "spark.rapids.sql.trace.path": str(tmp_path / "tr"),
                  "spark.sql.ansi.enabled": "true"})
    col = TORCH.col
    t = pa.table({"v": [1, 2, 3, 4], "z": [1, 1, 0, 1]})
    df = s.create_dataframe(t).select((col("v") / col("z")).alias("x"))
    with pytest.raises(SparkException):
        df.collect()
    paths = s.last_trace_paths
    assert paths is not None and os.path.exists(paths["trace"])
    events = PR.validate_chrome_trace(paths["trace"])
    err = [e for e in events if e["ph"] == "i" and e["name"] == "queryError"]
    assert err and err[0]["args"]["error"] == "SparkException"
    with open(paths["events"]) as f:
        qrec = json.loads(f.readline())
    assert qrec["status"] == "failed" and qrec["plan_digest"]
    recs = _records(tmp_path / "hist")
    assert len(recs) == 1
    assert recs[0]["status"] == "failed"
    assert recs[0]["error_class"] == "SparkException"
    assert recs[0]["plan_digest"] == qrec["plan_digest"]
    assert recs[0]["flight_dump"].endswith(".json")
    _grouped(TORCH, s).collect()
    assert _records(tmp_path / "hist")[-1]["status"] == "ok"


def test_slo_baselines_seed_from_the_store(tmp_path):
    s = _session(_hist(tmp_path))
    for _ in range(3):
        _grouped(TORCH, s).collect()
    digest = _records(tmp_path / "hist")[0]["plan_digest"]
    # a restart: the new layer's detector reads the three runs back
    obs.shutdown_for_tests()
    _session(_hist(tmp_path))
    base = obs.state().slo.baseline(digest)
    assert base is not None and base["runs"] == 3


def test_record_takes_one_snapshot_and_default_takes_none(tmp_path,
                                                          monkeypatch):
    """The default epilogue resolves no lazy device count (attribution
    reads the timers through a peek); with history on, the record's
    rollups and its annotated plan share one snapshot a query."""
    calls = []
    real = M.MetricsRegistry.snapshot

    def counting(self):
        calls.append(id(self))
        return real(self)

    monkeypatch.setattr(M.MetricsRegistry, "snapshot", counting)
    s = _session()
    _grouped(TORCH, s).collect()
    assert calls == [] and s.last_attribution() is not None
    assert obs.state().history is None
    obs.shutdown_for_tests()
    s = _session(_hist(tmp_path))
    _grouped(TORCH, s).collect()
    assert calls and len(calls) == len(set(calls))
    assert len(_records(tmp_path / "hist")) == 1


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_explain_analyze_matches_last_metrics(capsys):
    col, lit, F = TORCH.col, TORCH.lit, TORCH.F
    s = _session({"spark.rapids.sql.reader.batchSizeRows": "1024"})
    df = (s.create_dataframe(_table(8000), num_partitions=1)
          .filter(col("v") > lit(5))
          .select(col("k"), (col("v") + lit(1)).alias("v1"), col("d"))
          .filter(col("d") < lit(0.95))
          .select(col("k"), (col("v1") * lit(3)).alias("v3"))
          .group_by("k").agg(F.sum(col("v3")).alias("s3")))
    text = df.explain(mode="analyze")
    assert capsys.readouterr().out.strip() == text.strip()
    snaps = s.last_metrics()
    assert snaps, "analyze must execute the query"
    lines = text.splitlines()
    keys = [k for k, *_ in M.walk_exec_tree(s.last_exec)]
    assert len(lines) >= len(keys)
    for i, key in enumerate(keys):
        r = M.exec_rollup(snaps.get(key, {}))
        line = lines[i]
        assert key.split("#", 1)[0] in line, (key, line)
        assert f"rows={r['rows']}" in line, (key, line)
        assert f"batches={r['batches']}" in line, (key, line)
        assert f"time={r['time_ns'] / 1e6:.3f}ms" in line, (key, line)
    scan = [ln for ln in lines if "InMemoryScanExec" in ln]
    assert scan and "rows=8000" in scan[0]
    assert "-- time attribution (wall " in text


def test_explain_analyze_without_action():
    assert "no executed plan" in _session().explain_analyze()
    assert _session().last_plan_explain() == ""


def test_explain_modes_and_reports(lineitem):
    s = _session()
    df = H.q1(TORCH, s.create_dataframe(lineitem))
    # 'stages' (stage fusion, ROADMAP A11e): the JAX package's tree; the
    # port's aggregate line names its mode
    jdf = H.q1(JAX, JAX.session().create_dataframe(lineitem))
    assert df.explain("stages").replace("(complete)", "") == \
        jdf.explain("stages")
    df.collect()
    assert s.last_plan_explain().splitlines()[0].startswith("* Aggregate")
    assert s.last_audit() is None and s.last_roofline() is None
    assert "roofline" not in s.explain_analyze()


# ---------------------------------------------------------------------------
# the history server and the profiler report over the port's store
# ---------------------------------------------------------------------------

def test_history_server_renders_diffable_pair(tmp_path):
    s = _session(_hist(tmp_path))
    _grouped(TORCH, s).collect()
    _grouped(TORCH, s).collect()  # same digest: a diffable pair
    _grouped(TORCH, s, threshold=0).collect()
    written = HS.render_site(str(tmp_path / "hist"), str(tmp_path / "html"))
    assert "index.html" in written
    diffs = [n for n in written if n.startswith("diff_")]
    assert len(diffs) == 1, "two runs of one digest -> one diff page"
    idx = open(written["index.html"]).read()
    assert idx.count("query_") >= 3
    qpages = [n for n in written if n.startswith("query_")]
    assert len(qpages) == 3
    body = open(written[qpages[0]]).read()
    for frag in ("Annotated plan", "rows=", "time="):
        assert frag in body, frag
    diff_body = open(written[diffs[0]]).read()
    assert "→" in diff_body and "Δ time" in diff_body


def test_history_server_marks_failures(tmp_path):
    s = _session({**_hist(tmp_path), "spark.sql.ansi.enabled": "true"})
    col = TORCH.col
    t = pa.table({"v": [1, 2], "z": [1, 0]})
    with pytest.raises(SparkException):
        s.create_dataframe(t).select((col("v") / col("z")).alias("x")) \
            .collect()
    written = HS.render_site(str(tmp_path / "hist"), str(tmp_path / "html"))
    assert "failed" in open(written["index.html"]).read()
    qpage = [p for n, p in written.items() if n.startswith("query_")][0]
    assert "SparkException" in open(qpage).read()


def test_profiler_report_history_cross_link(tmp_path):
    s = _session({**_hist(tmp_path),
                  "spark.rapids.sql.trace.enabled": "true",
                  "spark.rapids.sql.trace.path": str(tmp_path / "tr")})
    _grouped(TORCH, s).collect()
    art = PR.load_artifacts(s.last_trace_paths["trace"])
    rec = PR.cross_link_history(art, str(tmp_path / "hist"))
    assert rec is not None
    assert rec["plan_digest"] == art["query"]["plan_digest"]
    assert os.path.abspath(rec["trace_paths"]["trace"]) == \
        os.path.abspath(s.last_trace_paths["trace"])
    assert "History cross-link" in PR.generate_report(art, history_rec=rec)


# ---------------------------------------------------------------------------
# attribution (tests/test_flight.py)
# ---------------------------------------------------------------------------

def _flight_sess(tmp_path, **over):
    conf = {"spark.rapids.obs.flight.path": str(tmp_path / "flight"),
            "spark.rapids.obs.flight.minIntervalSeconds": "0",
            "spark.rapids.sql.reader.batchSizeRows": "4096"}
    conf.update(over)
    return _session(conf)


def _flight_query(s, parts=2):
    rng = np.random.default_rng(7)
    t = pa.table({"k": rng.integers(0, 20, 20_000),
                  "v": rng.integers(0, 100, 20_000)})
    col, lit, F = TORCH.col, TORCH.lit, TORCH.F
    return (s.create_dataframe(t, num_partitions=parts)
            .filter(col("v") > lit(10))
            .group_by("k").agg(F.sum(col("v")).alias("sv")))


def test_attribution_reconciles_with_wall_time(tmp_path):
    s = _flight_sess(tmp_path)
    t0 = time.perf_counter()
    _flight_query(s).collect()
    wall_outer = time.perf_counter() - t0
    attr = s.last_attribution()
    assert attr is not None
    assert set(attr["buckets"]) == set(attribution.BUCKETS)
    assert _reconciles(attr)
    assert attr["wall_seconds"] <= wall_outer * 1.05
    assert all(v >= 0 for v in attr["buckets"].values())
    assert attr["buckets"]["device_compute"] > 0
    # exported by default, with no endpoint and no history store
    snap = obs.state().registry.snapshot()
    exported = {k: v for k, v in snap.items()
                if k.startswith("rapids_query_seconds_bucket")}
    assert len(exported) == len(attribution.BUCKETS)
    assert sum(exported.values()) == pytest.approx(attr["wall_seconds"],
                                                   rel=1e-6)


def test_attribution_compile_bucket_on_first_load(tmp_path, monkeypatch):
    """A hand kernel's first load inside a query (its build stubbed: no
    nvcc here) lands in ``compile`` and leaves the operator's timer."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all",
                        lambda names: time.sleep(0.02) or {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    loads = []

    def body(x):
        loads.append(_build.load("murmur3"))
        return x[0] * 2.0, x[1]

    f = TORCH.col_udf(body, return_type=TORCH.T.FLOAT64)
    s = _flight_sess(tmp_path)
    df = s.create_dataframe(pa.table({"x": [1.0, 2.0, 3.0]}))
    df.select(f(TORCH.col("x")).alias("y")).collect()
    attr = s.last_attribution()
    assert len(loads) == 1
    assert attr["buckets"]["compile"] >= 0.02
    assert attr["concurrency_factor"] == 1.0 and _reconciles(attr)
    # a warm load records nothing
    df.select(f(TORCH.col("x")).alias("y")).collect()
    assert s.last_attribution()["buckets"]["compile"] == 0.0


def test_attribution_in_explain_analyze(tmp_path, capsys):
    text = _flight_query(_flight_sess(tmp_path)).explain(mode="analyze")
    capsys.readouterr()
    assert "-- time attribution (wall " in text
    assert "device_compute" in text and "%" in text


def test_attribution_concurrency_scaling():
    snaps = {"FakeExec#0": {"opTime": 4_000_000_000}}
    doc = attribution.attribute(snaps, 1_000_000_000)
    assert doc["concurrency_factor"] == pytest.approx(4.0)
    assert doc["buckets"]["device_compute"] == pytest.approx(1.0)
    assert sum(doc["buckets"].values()) == pytest.approx(
        doc["wall_seconds"])
    doc2 = attribution.attribute(snaps, 8_000_000_000)
    assert doc2["concurrency_factor"] == 1.0
    assert doc2["buckets"]["other"] == pytest.approx(4.0)
    from spark_rapids_tpu.runtime.obs import attribution as jattr
    assert doc == jattr.attribute(snaps, 1_000_000_000)
    assert doc2 == jattr.attribute(snaps, 8_000_000_000)


def test_attribution_classification_and_compile_correction():
    snaps = {
        "InMemoryScanExec#0": {"gpuDecodeTime": 10, "copyToDeviceTime": 10,
                               "numOutputRows": 99},
        "ShuffleExchangeExec#1": {"partitionTime": 30, "opTime": 10},
        "PipelineExec#2": {"pipelineStallTime": 25,
                           "pipelineProducerTime": 1000},  # excluded
        "FilterExec#3": {"filterTime": 40},
    }
    extra = {"compile": 15, "semaphore_wait": 5}
    doc = attribution.attribute(snaps, 1_000_000_000, extra=extra)
    ns = {b: round(s * 1e9) for b, s in doc["buckets"].items()}
    assert ns["host_decode"] == 20  # the port's decode timer
    assert ns["shuffle"] == 40
    assert ns["pipeline_stall"] == 25
    assert ns["semaphore_wait"] == 5
    assert ns["compile"] == 15 and ns["device_compute"] == 25
    assert sum(ns.values()) == 1_000_000_000
    # the JAX package folds its own decode timer's name the same way
    from spark_rapids_tpu.runtime.obs import attribution as jattr
    jsnaps = dict(snaps)
    jsnaps["InMemoryScanExec#0"] = {"tpuDecodeTime": 10,
                                    "copyToDeviceTime": 10}
    assert jattr.attribute(jsnaps, 1_000_000_000, extra=extra) == doc


def test_attribution_compile_correction_cascades_past_device():
    snaps = {"ShuffleExchangeExec#0": {"partitionTime": 100},
             "FilterExec#1": {"filterTime": 30}}
    doc = attribution.attribute(snaps, 1_000_000_000,
                                extra={"compile": 90})
    ns = {b: round(s * 1e9) for b, s in doc["buckets"].items()}
    assert ns["compile"] == 90
    assert ns["device_compute"] == 0
    assert ns["shuffle"] == 40
    assert doc["concurrency_factor"] == 1.0
    assert sum(ns.values()) == 1_000_000_000


def test_attribution_history_and_render(tmp_path):
    s = _flight_sess(tmp_path, **_hist(tmp_path))
    _flight_query(s).collect()
    rec = [r for r in obs.state().history.read_all()
           if r.get("type") == "query"][-1]
    attr = rec["attribution"]
    assert set(attr["buckets"]) == set(attribution.BUCKETS)
    lines = attribution.render_text(attr)
    assert lines and lines[0].startswith("-- time attribution")
    assert len(lines) - 1 == sum(
        1 for v in attr["buckets"].values() if v > 0)


def test_attribution_aggregate_cleared_between_queries(tmp_path):
    s = _flight_sess(tmp_path)
    _flight_query(s).collect()
    first = s.last_attribution()
    # outside a query the aggregate is closed: record is a no-op
    attribution.record("compile", 10**12)
    with attribution.suppress_scope():
        assert attribution.thread_suppressed()
    assert not attribution.thread_suppressed()
    _flight_query(s).collect()
    second = s.last_attribution()
    assert second["buckets"]["compile"] <= first["buckets"]["compile"] + 1


def test_slow_query_carries_the_attribution_summary(tmp_path):
    s = _flight_sess(tmp_path, **{
        "spark.rapids.obs.slo.latencySeconds": "1e-9"})
    _flight_query(s).collect()
    slow = obs.state().last_slow
    assert slow["breach"]["kind"] == "absolute"
    assert slow["attribution"]["wall_seconds"] == \
        s.last_attribution()["wall_seconds"]
    assert slow["attribution"]["top_buckets"]


# ---------------------------------------------------------------------------
# the measured cost pass (tests/test_adaptive.py)
# ---------------------------------------------------------------------------

def _seed_verdict(store, digest, groups):
    rec = dict(next(r for r in reversed(store.by_digest(digest))
                    if r.get("status") == "ok"))
    rec["roofline"] = {"groups": groups}
    store.append(rec)


DISPATCH_SHUFFLE = {"shuffle": {"bound": "dispatch_overhead"}}


def test_measured_cost_collapses_dispatch_bound_exchange(tmp_path,
                                                         lineitem):
    s = _session(_hist(tmp_path))

    def q():
        return H.pctl_shuffled(TORCH, s.create_dataframe(
            lineitem, num_partitions=4))

    cold = q().collect()
    assert not _decisions(s, AQ.MEASURED_COST)
    assert _execs(s, "ShuffleExchangeExec"), \
        "precondition: the cold plan must carry a hash exchange"
    digest = plan_digest(q().plan)
    st = obs.state()
    _seed_verdict(st.history, digest, DISPATCH_SHUFFLE)
    warm = q().collect()
    (d,) = _decisions(s, AQ.MEASURED_COST)
    assert d["digest"] == digest and d["exchange_parts"] == 1
    assert d["coalesce_tiny_rows"] == 4 * 1024
    assert not _execs(s, "ShuffleExchangeExec")
    assert _execs(s, "CollectExchangeExec")
    assert_tables_equal(warm, cold, ignore_order=True)
    assert st.history.by_digest(digest)[-1]["aqe"]["counts"] == \
        {"measured_cost": 1}
    assert "measured_cost: digest=" + digest in s.explain_analyze()


def test_measured_cost_off_without_history_or_by_conf(tmp_path, lineitem):
    s = _session()
    H.pctl_shuffled(TORCH, s.create_dataframe(
        lineitem, num_partitions=3)).collect()
    assert not _decisions(s, AQ.MEASURED_COST)
    s = _session(_hist(tmp_path, **{
        "spark.rapids.sql.adaptive.measuredCost.enabled": "false"}))
    df = H.pctl_shuffled(TORCH, s.create_dataframe(lineitem,
                                                   num_partitions=3))
    df.collect()
    _seed_verdict(obs.state().history, plan_digest(df.plan),
                  DISPATCH_SHUFFLE)
    df.collect()
    assert not _decisions(s, AQ.MEASURED_COST)
    assert _execs(s, "ShuffleExchangeExec")


def test_measured_hints_ignore_non_dispatch_verdicts(tmp_path, lineitem):
    s = _session(_hist(tmp_path))
    df = H.pctl_shuffled(TORCH, s.create_dataframe(lineitem,
                                                   num_partitions=3))
    df.collect()
    digest = plan_digest(df.plan)
    _seed_verdict(obs.state().history, digest,
                  {"shuffle": {"bound": "memory"},
                   "device_compute": {"bound": "compute"}})
    COST.reset_for_tests()
    assert COST.measured_hints(df.plan, s.conf) is None
    # a dispatch-bound compute group: harder coalescing and the fusion
    # hint, which shows in the decision's detail only
    _seed_verdict(obs.state().history, digest,
                  {"device_compute": {"bound": "dispatch_overhead"}})
    h = COST.measured_hints(df.plan, s.conf)
    assert h.detail() == {"digest": digest,
                          "basis": "shuffle=n/a,device_compute="
                                   "dispatch_overhead",
                          "coalesce_tiny_rows": 4096,
                          "fusion_min_members": 2}


def test_measured_coalescing_snapshots_at_conversion(tmp_path, lineitem):
    """A repartition keeps its exchange (only an aggregate's collapses),
    with coalesceTinyRows taken from the hints at conversion."""
    s = _session(_hist(tmp_path))
    df = H.repart_agg(TORCH, s.create_dataframe(lineitem), n=4)
    cold = df.collect()
    assert [e._tiny_override for e in _execs(s, "ShuffleExchangeExec")] \
        == [None]
    _seed_verdict(obs.state().history, plan_digest(df.plan),
                  DISPATCH_SHUFFLE)
    warm = df.collect()
    assert [e._tiny_override for e in _execs(s, "ShuffleExchangeExec")] \
        == [4096]
    assert COST.current_hints() is None
    assert_tables_equal(warm, cold, ignore_order=True)


def _aqe_join(s):
    rng = np.random.default_rng(5)
    left = pa.table({"k": pa.array(rng.integers(0, 12, 60)),
                     "lv": pa.array(rng.integers(0, 100, 60))})
    right = pa.table({"k": pa.array(rng.integers(0, 15, 30)),
                      "rv": pa.array(rng.uniform(0, 1, 30))})
    return s.create_dataframe(left, num_partitions=3).join(
        s.create_dataframe(right, num_partitions=2), on="k", how="inner")


AQE_ON = {"spark.rapids.sql.join.broadcastRowThreshold": 1}


def test_explain_analyze_has_adaptive_section():
    s = _session(AQE_ON)
    _aqe_join(s).collect()
    text = s.explain_analyze()
    assert "-- adaptive (" in text
    assert "broadcast_conversion" in text


def test_aqe_counters_and_instants(tmp_path):
    s = _session({**AQE_ON, "spark.rapids.sql.trace.enabled": "true",
                  "spark.rapids.sql.trace.path": str(tmp_path)})
    _aqe_join(s).collect()
    snap = obs.state().registry.snapshot()
    assert snap['rapids_aqe_decisions_total{kind="broadcast_conversion"}'] \
        == 1
    assert snap["rapids_aqe_dispatches_saved_total"] == \
        s.last_aqe()["dispatches_saved"] > 0
    events = PR.validate_chrome_trace(s.last_trace_paths["trace"])
    inst = [e for e in events if e["name"] == "aqeDecision"]
    assert [e["args"]["kind"] for e in inst] == ["broadcast_conversion"]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

SQL_Q = ("SELECT l_returnflag, SUM(l_quantity) AS sq, COUNT(*) AS n "
         "FROM lineitem WHERE l_shipdate <= 10471 GROUP BY l_returnflag")

PROGRAMS = {
    "q1": lambda api, s, df: H.q1(api, df),
    "q72shfl": lambda api, s, df: H.q72shfl(api, df),
    "repart_agg": lambda api, s, df: H.repart_agg(api, df, n=4),
    "pctl_shuffled": lambda api, s, df: H.pctl_shuffled(api, df),
    "sql": lambda api, s, df: (s.create_or_replace_temp_view(
        "lineitem", df), s.sql(SQL_Q))[1],
}


def _run_recorded(api, hist, name, table, parts=3):
    s = api.session({"spark.rapids.obs.historyDir": str(hist)})
    df = PROGRAMS[name](api, s, s.create_dataframe(table,
                                                   num_partitions=parts))
    out = df.collect()
    return s, df, out


def _kinds(rec):
    return [d["kind"] for d in (rec.get("aqe") or {}).get("decisions", [])]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_records_match_jax(tmp_path, lineitem, name):
    from spark_rapids_tpu import config as JC
    from spark_rapids_tpu.runtime.obs.history import \
        QueryHistoryStore as JStore
    # one store for both packages: the port's record, then the JAX
    # package's, each readable by the other's reader
    _run_recorded(TORCH, tmp_path, name, lineitem)
    _run_recorded(JAX, tmp_path, name, lineitem)
    prec, jrec = _records(tmp_path)
    assert JStore(str(tmp_path)).read_all() == [prec, jrec]
    assert set(prec) == set(jrec)
    for k in ("type", "status", "plan_digest", "sql", "fallback_reasons"):
        assert prec.get(k) == jrec.get(k), k
    assert (prec.get("sql") is not None) == (name == "sql")
    assert _kinds(prec) == _kinds(jrec)
    shared = set(PC.keys()) & set(JC.registry())
    assert {k: v for k, v in prec["conf_delta"].items() if k in shared} \
        == {k: v for k, v in jrec["conf_delta"].items() if k in shared}
    assert set(prec["attribution"]["buckets"]) == \
        set(jrec["attribution"]["buckets"])
    assert prec["fusion_groups"] == jrec["fusion_groups"]


@pytest.mark.parametrize("name", ["q1", "pctl_shuffled"])
def test_attribution_matches_jax_roster_and_reconciles(lineitem, name):
    from spark_rapids_tpu.runtime.obs import attribution as jattr
    assert list(attribution.BUCKETS) == list(jattr.BUCKETS)
    assert set(attribution.TASK_BUCKETS) == set(jattr.TASK_BUCKETS)
    for api in (TORCH, JAX):
        s = api.session()
        PROGRAMS[name](api, s, s.create_dataframe(
            lineitem, num_partitions=3)).collect()
        doc = s.last_attribution()
        assert list(doc["buckets"]) == list(attribution.BUCKETS)
        assert _reconciles(doc) and doc["wall_seconds"] > 0


def test_measured_collapse_matches_jax(tmp_path, lineitem):
    from spark_rapids_tpu.runtime import obs as jobs
    answers = {}
    for api, o, tag in ((TORCH, obs, "p"), (JAX, jobs, "j")):
        s, df, cold = _run_recorded(api, tmp_path / tag, "pctl_shuffled",
                                    lineitem, parts=4)
        st = o.state()
        digest = st.history.read_all()[-1]["plan_digest"]
        _seed_verdict(st.history, digest, DISPATCH_SHUFFLE)
        warm = df.collect()
        root = s.last_exec if api is TORCH else s._last_exec
        names = [type(e).__name__ for e in (
            root.walk() if api is TORCH else H.chosen_execs(root))]
        assert "ShuffleExchangeExec" not in names, tag
        assert "CollectExchangeExec" in names, tag
        assert [d["kind"] for d in s.last_aqe()["decisions"]] == \
            ["measured_cost"]
        assert_tables_equal(warm, cold, ignore_order=True)
        answers[tag] = (digest, warm.sort_by("l_shipdate"))
    assert answers["p"][0] == answers["j"][0]
    assert_tables_equal(answers["p"][1], answers["j"][1],
                        approx_float=1e-12)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

#: the port's *Time metrics that fold into device_compute (every operator
#: timer; the two task accumulators never appear in an exec's snapshot)
DEVICE_COMPUTE_TIMES = {"opTime", "sortTime", "aggTime", "joinTime",
                        "concatTime", "filterTime", "buildTime",
                        "semaphoreHoldTime", "retryWastedTime"}


def test_every_port_time_metric_has_its_bucket():
    names = {v for k, v in vars(M).items()
             if k.isupper() and isinstance(v, str) and v.endswith("Time")}
    classified = set(attribution.METRIC_BUCKETS) \
        | attribution._EXCLUDED_METRICS
    assert names == classified | DEVICE_COMPUTE_TIMES
    assert not classified & DEVICE_COMPUTE_TIMES
    assert set(attribution.METRIC_BUCKETS) <= names
    assert attribution.METRIC_BUCKETS[M.DECODE_TIME] == "host_decode"
    assert set(attribution.TASK_BUCKETS) <= names


def test_every_record_literal_names_a_bucket():
    lit = re.compile(r"\b(?:attribution|ATTR)\.record\(\s*\"(\w+)\"")
    found = []
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(path) as f:
            found += [(os.path.relpath(path, PKG), b)
                      for b in lit.findall(f.read())]
    assert ("ops/_build.py", "compile") in found
    assert all(b in attribution.BUCKETS for _, b in found), found


def test_config_keys_registered_at_jax_defaults():
    from spark_rapids_tpu import config as JC
    for key in ("spark.rapids.obs.historyDir",
                "spark.rapids.sql.adaptive.measuredCost.enabled"):
        assert PC.registry()[key].default == JC.registry()[key].default
    # 99 keys, the stage fusion and shape-ladder keys, the audit,
    # compile and profile keys, then the reqtrace and serving keys: all
    # of the JAX package's 129 but spark.rapids.sql.multichip.*
    assert len(PC.keys()) == 127
    for key in ("spark.rapids.sql.stageFusion.enabled",
                "spark.rapids.compile.shapes.growthFactor",
                "spark.rapids.compile.shapes.dtypeAlign",
                "spark.rapids.tpu.batchCapacityMinRows",
                "spark.rapids.obs.audit.enabled",
                "spark.rapids.obs.audit.overheadBoundFactor",
                "spark.rapids.compile.cacheDir",
                "spark.rapids.compile.warmup.enabled",
                "spark.rapids.compile.warmup.maxPlans",
                "spark.rapids.compile.warmup.minRuns",
                "spark.rapids.profile.dir"):
        assert PC.registry()[key].default == JC.registry()[key].default
    # the stated exceptions: the roofline peaks are the H100 SXM's
    # (3350 GB/s HBM3, 66900 GFLOP/s FP32; data sheet, 700 W)
    assert (PC.registry()["spark.rapids.obs.audit.peakGbps"].default,
            PC.registry()["spark.rapids.obs.audit.peakGflops"].default) \
        == (3350.0, 66900.0)
    assert set(PC.keys()) <= set(JC.registry())
    assert {k for k, e in PC.registry().items() if e.internal} == \
        {k for k, e in JC.registry().items()
         if e.internal and k in PC.registry()}
    conf = PC.RapidsConf({"spark.rapids.sql.test.enabled": "true",
                          "spark.rapids.obs.historyDir": "/x"})
    assert conf_delta(conf) == {"spark.rapids.obs.historyDir": "/x"}


def _filtered(api, s, df):
    col, lit = api.col, api.lit
    return df.filter(col("l_discount") > lit(0.05)).select(
        "l_orderkey", "l_quantity")


@pytest.mark.parametrize("name,build,parts", [
    ("q1", lambda api, s, df: H.q1(api, df), 1),
    ("filtered", _filtered, 3),
    ("pctl_shuffled", lambda api, s, df: H.pctl_shuffled(api, df), 3)])
def test_to_device_batches_are_the_collects(lineitem, name, build, parts):
    s = _session()
    df = build(TORCH, s, s.create_dataframe(lineitem,
                                            num_partitions=parts))
    want = df.collect()
    batches = df.to_device_batches()
    assert batches and all(b.row_mask is None for b in batches)
    assert all(c.device == s.device for b in batches for c in b.columns)
    got = pa.concat_tables([to_arrow(b, want.schema.names)
                            for b in batches])
    assert got.equals(want)


def _pctl_joined(api, li, od):
    """A segmented aggregate over a join: pruning rewrites the plan (a
    projection under each join side) on its first conversion."""
    col, F = api.col, api.F
    j = li.join(od, on=[(col("l_orderkey"), col("o_orderkey"))],
                how="inner")
    return (j.select(col("o_orderdate"), col("l_extendedprice"))
            .group_by(col("o_orderdate"))
            .agg(F.percentile(col("l_extendedprice"), 0.5).alias("p50")))


def test_measured_pass_finds_a_rebuilt_pruned_query_c26(tmp_path):
    """ROADMAP C26: both packages prune a plan in place at its first
    conversion, so a DataFrame's digest before its first collect differs
    from its record's. The JAX package's measured pass digests the
    unpruned plan and misses the verdict of a query built anew; the
    port's prunes first and finds it."""
    from spark_rapids_tpu.runtime import obs as jobs
    from spark_rapids_tpu.runtime.obs.history import plan_digest as jdigest
    li, od = H.make_tables(4000)
    for api, o, digest, tag in ((TORCH, obs, plan_digest, "p"),
                                (JAX, jobs, jdigest, "j")):
        s = api.session({"spark.rapids.obs.historyDir": str(tmp_path / tag)})

        def build():
            return _pctl_joined(api, s.create_dataframe(
                li, num_partitions=3), s.create_dataframe(od))

        df = build()
        fresh = digest(df.plan)
        cold = df.collect()
        store = o.state().history
        recorded = store.read_all()[-1]["plan_digest"]
        assert recorded != fresh and recorded == digest(df.plan)
        _seed_verdict(store, recorded, DISPATCH_SHUFFLE)
        warm = build().collect()
        kinds = [d["kind"] for d in (s.last_aqe() or {}).get(
            "decisions", [])]
        assert_tables_equal(warm, cold, ignore_order=True)
        if api is TORCH:
            assert kinds == ["measured_cost"]
            assert not _execs(s, "ShuffleExchangeExec")
        else:
            assert "measured_cost" not in kinds  # the reference misses it
