"""The port's per-request tracing (``spark_rapids_tpu_torch/runtime/obs/
reqtrace.py``) and its fleet report (``tools/torch_fleet_report.py``)
against the JAX package's, on the CPU.

The programs of tests/test_reqtrace.py run against the port: the W3C
``traceparent`` round trip (parsing, minting, the HTTP header), the
serving <-> engine span join in an exported timeline and its OTLP
sibling, the cache hit's timeline and the history records' trace ids,
the tail-sampling verdict matrix, the export rate limit, exemplars on
/metrics, and the multi-replica fleet view over a shared historyDir.
Parity cases hold the verdict matrix and the parser to the JAX
package's answers. Then the port's own: with the flight recorder off the
engine spans still reach the request's ring (``runtime/trace.py``'s
branches), spans from task-wave threads join it, and the fleet report
reads two port replicas' real records.
"""
import http.client
import importlib.util
import json
import os
import sys

import numpy as np
import pyarrow as pa
import pytest

from torch_port_helpers import reset_torch_runtime

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.runtime import obs, serving
from spark_rapids_tpu_torch.runtime.obs import reqtrace
from spark_rapids_tpu_torch.runtime.obs.history import QueryHistoryStore
from spark_rapids_tpu_torch.runtime.obs.registry import MetricsRegistry

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_spec = importlib.util.spec_from_file_location(
    "torch_fleet_report", os.path.join(REPO, "tools",
                                       "torch_fleet_report.py"))
fleet_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fleet_report)


@pytest.fixture(autouse=True)
def _fresh():
    """Reqtrace rides the serving and obs singletons: fresh ones for each
    test (the port's; the JAX package's recorder for the parity cases)."""
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    reset_torch_runtime()
    jrt.uninstall_for_tests()
    yield
    reset_torch_runtime()
    jrt.uninstall_for_tests()


def _table(n=500, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 8, n),
                     "v": rng.integers(1, 1000, n)})


def _serving_session(**extra):
    conf = {"spark.rapids.serving.enabled": "true"}
    conf.update(extra)
    s = TorchSession(conf, device="cpu")
    s.create_or_replace_temp_view("t", s.create_dataframe(_table()))
    return s


_SQL = "SELECT k, SUM(v) AS sv FROM t GROUP BY k ORDER BY k"
_TID = "ab" * 16
_TP = f"00-{_TID}-{'cd' * 8}-01"

_MALFORMED = [
    None, "", "garbage", "00-abc-def-01",
    f"00-{'0' * 32}-{'cd' * 8}-01",      # all-zero trace id
    f"00-{_TID}-{'0' * 16}-01",          # all-zero parent span
    f"ff-{_TID}-{'cd' * 8}-01",          # forbidden version
    f"00-{'xy' * 16}-{'cd' * 8}-01",     # non-hex
    f"00-{_TID}-{'cd' * 8}",             # missing field
]


# ---------------------------------------------------------------------------
# W3C traceparent round-trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("header", _MALFORMED)
def test_malformed_traceparent_mints(header):
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    assert reqtrace.parse_traceparent(header) is None
    assert jrt.parse_traceparent(header) is None
    ctx = reqtrace.RequestContext(64, "r1", traceparent=header)
    assert not ctx.honored and ctx.parent_span_id is None
    assert len(ctx.trace_id) == 32 and int(ctx.trace_id, 16) >= 0
    assert ctx.trace_id != _TID


def test_valid_traceparent_honored_and_propagated():
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    assert reqtrace.parse_traceparent(_TP) == (_TID, "cd" * 8, "01") \
        == jrt.parse_traceparent(_TP)
    ctx = reqtrace.RequestContext(64, "r1", traceparent=_TP)
    assert ctx.honored and ctx.trace_id == _TID
    assert ctx.parent_span_id == "cd" * 8
    out = ctx.traceparent()
    assert out.startswith(f"00-{_TID}-") and out.endswith("-01")
    assert out.split("-")[2] == ctx.span_id != "cd" * 8


def test_http_traceparent_roundtrip(tmp_path):
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    reqtrace.install(out_dir=str(tmp_path), sample_ratio=0.0)
    _serving_session(**{"spark.rapids.obs.port": str(port)})
    port = obs.state().server.port

    def post(headers):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/sql", body=json.dumps({"sql": _SQL}),
                     headers=dict({"Content-Type": "application/json"},
                                  **headers))
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        hdr = resp.getheader("traceparent")
        conn.close()
        return doc, hdr

    doc, hdr = post({"traceparent": _TP})
    assert doc["trace_id"] == _TID
    assert hdr == doc["traceparent"]
    assert hdr.startswith(f"00-{_TID}-") and hdr.endswith("-01")
    doc2, hdr2 = post({})
    assert len(doc2["trace_id"]) == 32 and doc2["trace_id"] != _TID
    assert hdr2.startswith(f"00-{doc2['trace_id']}-")


# ---------------------------------------------------------------------------
# the serving <-> exec span join in an exported timeline
# ---------------------------------------------------------------------------

def _engine_spans(timeline):
    meta = timeline["otherData"]
    return [e for e in timeline["traceEvents"]
            if e.get("cat") not in ("serving", None)
            and (e.get("args") or {}).get("query_id") == meta["query_id"]]


@pytest.mark.parametrize("flight_on", [True, False])
def test_export_joins_serving_and_exec_spans(tmp_path, flight_on):
    """With the flight recorder on its record() feeds the request's
    ring; off, runtime/trace.py's hooks do."""
    rec = reqtrace.install(out_dir=str(tmp_path), sample_ratio=1.0,
                           min_interval_s=0.0, replica_id="repl-a")
    _serving_session(**{"spark.rapids.obs.flight.enabled":
                        str(flight_on).lower()})
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 200 and doc["status"] == "ok"
    assert doc["replica_id"] == "repl-a"
    rt = doc["reqtrace"]
    assert rt["verdict"] == "sampled" and os.path.exists(rt["path"])
    timeline = json.load(open(rt["path"]))
    meta = timeline["otherData"]
    assert meta["trace_id"] == doc["trace_id"]
    assert meta["replica_id"] == "repl-a"
    events = timeline["traceEvents"]
    serving_spans = {e["name"]: e for e in events
                     if e.get("cat") == "serving"}
    assert {"intake", "cache_lookup", "execute",
            "serialize"} <= set(serving_spans)
    assert isinstance(meta["query_id"], int)
    engine = _engine_spans(timeline)
    assert engine, "no engine exec spans joined to the request's query"
    # the engine's spans lie inside the execute phase
    ex = serving_spans["execute"]
    assert all(ex["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0)
               <= ex["ts"] + ex["dur"] + 1e-3 for e in engine)
    otlp = json.load(open(rt["path"][:-5] + ".otlp.json"))
    spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    root = next(s for s in spans if s["name"] == "POST /sql")
    assert root["traceId"] == doc["trace_id"]
    intake = next(s for s in spans if s["name"] == "intake")
    assert intake["parentSpanId"] == root["spanId"]
    execute = next(s for s in spans if s["name"] == "execute")
    assert any(s["parentSpanId"] == execute["spanId"] for s in spans
               if s["name"] not in reqtrace.REQUEST_SPANS
               and s["name"] != "POST /sql")
    assert rec.exports == 1


def test_wave_thread_spans_join_the_request(tmp_path):
    """A multi-partition query's tasks run on task-wave threads: their
    spans reach the request's ring through the wave's binding."""
    reqtrace.install(out_dir=str(tmp_path), sample_ratio=1.0,
                     min_interval_s=0.0)
    s = _serving_session()
    s.create_or_replace_temp_view(
        "p", s.create_dataframe(_table(n=2000), num_partitions=4))
    code, doc = serving.handle_sql(
        {"sql": "SELECT k, COUNT(*) AS n FROM p GROUP BY k"})
    assert code == 200
    timeline = json.load(open(doc["reqtrace"]["path"]))
    tids = {e["tid"] for e in _engine_spans(timeline)}
    assert len(tids) >= 2, "every engine span came from one thread"


def test_cache_hit_timeline_and_history_trace_id(tmp_path):
    hist = tmp_path / "hist"
    reqtrace.install(out_dir=str(tmp_path / "rt"), sample_ratio=1.0,
                     min_interval_s=0.0)
    _serving_session(**{"spark.rapids.obs.historyDir": str(hist)})
    _, d1 = serving.handle_sql({"sql": _SQL})
    code, d2 = serving.handle_sql({"sql": _SQL})
    assert code == 200 and d2["cache"] == "hit"
    assert d2["reqtrace"]["verdict"] == "sampled"
    timeline = json.load(open(d2["reqtrace"]["path"]))
    names = {e["name"] for e in timeline["traceEvents"]
             if e.get("cat") == "serving"}
    assert "cache_lookup" in names and "execute" not in names
    recs = QueryHistoryStore(str(hist)).read_all()
    by_type = {}
    for r in recs:
        by_type.setdefault(r["type"], []).append(r)
    assert by_type["query"][-1]["trace_id"] == d1["trace_id"]
    assert by_type["result_cache_hit"][-1]["trace_id"] == d2["trace_id"]
    assert by_type["result_cache_hit"][-1]["plan_digest"] == \
        by_type["query"][-1]["plan_digest"]


# ---------------------------------------------------------------------------
# the tail-sampling verdict matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,verdict", [
    (dict(status="failed"), "error"),
    (dict(status="failed", slo_breach=True), "error"),
    (dict(status="cancelled", cancel_reason="user"), "cancelled"),
    (dict(status="cancelled", cancel_reason="deadline"), "deadline"),
    (dict(status="ok", slo_breach=True), "slo_breach"),
    (dict(status="ok", slow_vs_baseline=True), "slow_vs_baseline"),
    (dict(status="ok", slo_breach=True, slow_vs_baseline=True),
     "slo_breach"),
    (dict(status="ok", draw=0.001), "sampled"),
    (dict(status="ok", draw=0.999), "dropped"),
    (dict(status="bad_request", draw=0.001), "sampled"),
])
def test_verdict_matrix(tmp_path, kw, verdict):
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    rec = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path),
                                    sample_ratio=0.01)
    jrec = jrt.ReqTraceRecorder(out_dir=str(tmp_path), sample_ratio=0.01)
    assert rec.decide(**kw) == verdict == jrec.decide(**kw)
    assert verdict in reqtrace.VERDICTS


def test_rosters_are_the_jax_packages():
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    assert list(reqtrace.REQUEST_SPANS) == list(jrt.REQUEST_SPANS)
    assert list(reqtrace.VERDICTS) == list(jrt.VERDICTS)
    assert reqtrace.TAIL_FACTOR == jrt.TAIL_FACTOR


def test_verdict_ratio_edges_and_export_bookkeeping(tmp_path):
    rec = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path),
                                    sample_ratio=0.0)
    assert rec.decide(status="ok", draw=0.0) == "dropped"
    rec = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path),
                                    sample_ratio=1.0, min_interval_s=0.0)
    assert rec.decide(status="ok", draw=0.999999) == "sampled"
    ctx = rec.begin()
    out = rec.end(ctx, status="failed", error="Boom")
    assert out["kept"] and out["verdict"] == "error"
    assert os.path.exists(out["path"])
    assert os.path.exists(out["otlp_path"])
    assert json.load(open(out["path"]))["otherData"]["error"] == "Boom"
    rec2 = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path / "none"),
                                     sample_ratio=0.0)
    ctx2 = rec2.begin()
    out2 = rec2.end(ctx2, status="ok")
    assert not out2["kept"] and out2["path"] is None
    assert not os.path.exists(str(tmp_path / "none"))
    assert rec2.dropped == 1


def test_sampled_exports_rate_limited_but_errors_never(tmp_path):
    rec = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path),
                                    sample_ratio=1.0,
                                    min_interval_s=3600.0)
    assert rec.end(rec.begin(), status="ok", draw=0.0)["path"]
    out = rec.end(rec.begin(), status="ok", draw=0.0)
    assert out["kept"] and out["path"] is None
    assert rec.rate_limited == 1
    assert rec.end(rec.begin(), status="failed")["path"]


def test_retention_keeps_the_newest_pairs(tmp_path):
    rec = reqtrace.ReqTraceRecorder(out_dir=str(tmp_path),
                                    sample_ratio=1.0, min_interval_s=0.0,
                                    max_dumps=2)
    paths = [rec.end(rec.begin(), status="failed")["path"]
             for _ in range(4)]
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 4  # two Chrome + OTLP pairs
    assert all(os.path.basename(p) in left for p in paths[2:])


# ---------------------------------------------------------------------------
# exemplars on /metrics
# ---------------------------------------------------------------------------

def test_exemplar_renders_openmetrics_bucket_lines():
    reg = MetricsRegistry()
    h = reg.histogram("rapids_serving_request_ms", "request wall")
    h.observe(3.0)
    h.observe(12.5, exemplar={"trace_id": "deadbeef" * 4})
    out = reg.render_prometheus()
    bucket_lines = [ln for ln in out.splitlines()
                    if ln.startswith("rapids_serving_request_ms_bucket")]
    assert bucket_lines and bucket_lines[-1].count('le="+Inf"') == 1
    ex_lines = [ln for ln in bucket_lines if " # {" in ln]
    assert len(ex_lines) == 1
    assert 'trace_id="' + "deadbeef" * 4 + '"' in ex_lines[0]
    counts = [int(ln.split(" # ")[0].rsplit(" ", 1)[1])
              for ln in bucket_lines]
    assert counts == sorted(counts) and counts[-1] == 2


def test_serving_request_records_resolvable_exemplar(tmp_path):
    reqtrace.install(out_dir=str(tmp_path), sample_ratio=1.0,
                     min_interval_s=0.0)
    _serving_session()
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 200
    out = obs.state().registry.render_prometheus()
    ex_lines = [ln for ln in out.splitlines()
                if ln.startswith("rapids_serving_request_ms_bucket")
                and " # {" in ln]
    assert ex_lines, "serving latency histogram carries no exemplar"
    assert f'trace_id="{doc["trace_id"]}"' in ex_lines[0]
    path = ex_lines[0].split('path="')[1].split('"')[0]
    assert path == doc["reqtrace"]["path"] and os.path.exists(path)
    # the query's own wall-time histogram carries the request's id too
    assert any(ln.startswith("rapids_query_wall_time_ms_bucket")
               and f'trace_id="{doc["trace_id"]}"' in ln
               for ln in out.splitlines())


# ---------------------------------------------------------------------------
# the fleet view over a shared historyDir
# ---------------------------------------------------------------------------

def _fleet_record(replica, digest, wall_ms, trace_id, status="ok",
                  compile_s=0.0, slo=None):
    rec = {"type": "query", "replica_id": replica, "plan_digest": digest,
           "duration_ns": int(wall_ms * 1e6), "status": status,
           "trace_id": trace_id,
           "attribution": {"buckets": {"compile": compile_s}}}
    if slo is not None:
        rec["slo_breach"] = slo
    return rec


def test_two_replica_fleet_report_merge(tmp_path):
    hist = str(tmp_path / "hist")
    a = QueryHistoryStore(hist)
    b = QueryHistoryStore(hist)
    tid_a = "aa" * 16
    tid_b = "bb" * 16
    for w in (10.0, 11.0, 12.0):
        a.append(_fleet_record("repl-a", "digX", w, tid_a,
                               compile_s=0.5))
    for w in (40.0, 44.0, 48.0):
        b.append(_fleet_record("repl-b", "digX", w, tid_b, slo={"x": 1}))
    b.append(_fleet_record("repl-b", "digY", 5.0, "cc" * 16,
                           status="failed"))
    b.append({"type": "result_cache_hit", "replica_id": "repl-b",
              "plan_digest": "digX", "wall_ms": 1.0, "trace_id": tid_b})
    rt = tmp_path / "rt"
    rt.mkdir()
    (rt / f"req_00001_slo_breach_{tid_b[:8]}.json").write_text("{}")
    (rt / "req_00002_error_99999999.json").write_text("{}")

    doc = fleet_report.fleet_summary(
        QueryHistoryStore(hist).read_all(),
        reqtrace_dirs=[str(rt)], skew_factor=1.5)
    assert doc["replicas"] == ["repl-a", "repl-b"]
    assert doc["totals"]["repl-a"]["queries"] == 3
    assert doc["totals"]["repl-b"]["slo_breaches"] == 3
    assert doc["totals"]["repl-b"]["failed"] == 1
    assert doc["totals"]["repl-b"]["cache_hits"] == 1
    cell = doc["digests"]["digX"]
    assert cell["repl-a"]["runs"] == 3 and cell["repl-b"]["runs"] == 3
    assert cell["repl-a"]["compile_s"] == 1.5
    assert cell["repl-a"]["p99_ms"] == 12.0
    assert cell["repl-b"]["p99_ms"] == 48.0
    assert tid_a in cell["repl-a"]["trace_ids"]
    assert [s["plan_digest"] for s in doc["skewed"]] == ["digX"]
    assert doc["skewed"][0]["slow"] == "repl-b"
    assert doc["skewed"][0]["ratio"] == 4.0
    arts = {a["file"].rsplit("/", 1)[-1]: a for a in doc["reqtrace"]}
    assert arts[f"req_00001_slo_breach_{tid_b[:8]}.json"][
        "trace_id"] == tid_b
    assert arts["req_00002_error_99999999.json"]["trace_id"] is None
    text = fleet_report.render_text(doc)
    assert "repl-a" in text and "skew" in text and "slo_breach" in text


def test_fleet_report_cli_json(tmp_path, capsys):
    hist = str(tmp_path / "hist")
    QueryHistoryStore(hist).append(
        _fleet_record("r1", "d", 3.0, "ee" * 16))
    sys_argv = sys.argv
    sys.argv = ["torch_fleet_report.py", hist, "--json"]
    try:
        assert fleet_report.main() == 0
    finally:
        sys.argv = sys_argv
    doc = json.loads(capsys.readouterr().out)
    assert doc["replicas"] == ["r1"]


def test_fleet_report_over_two_port_replicas(tmp_path):
    """Two port replicas (their replicaId confs) serve into one
    historyDir; the report splits the shared digest per replica and
    joins each replica's exported timelines back to its records."""
    hist = str(tmp_path / "hist")
    docs = {}
    for replica in ("repl-a", "repl-b"):
        reset_torch_runtime()
        rt_dir = str(tmp_path / f"rt-{replica}")
        reqtrace.install(out_dir=rt_dir, sample_ratio=1.0,
                         min_interval_s=0.0, replica_id=replica)
        _serving_session(**{"spark.rapids.obs.historyDir": hist,
                            "spark.rapids.obs.replicaId": replica})
        docs[replica] = [serving.handle_sql({"sql": _SQL})[1]
                         for _ in range(2)]
    doc = fleet_report.fleet_summary(
        QueryHistoryStore(hist).read_all(),
        reqtrace_dirs=[str(tmp_path / f"rt-{r}") for r in docs])
    assert doc["replicas"] == ["repl-a", "repl-b"]
    digest = docs["repl-a"][0]["plan_digest"]
    assert digest == docs["repl-b"][0]["plan_digest"]
    cell = doc["digests"][digest]
    for r, (miss, hit) in docs.items():
        assert (miss["cache"], hit["cache"]) == ("miss", "hit")
        assert cell[r]["runs"] == 1
        assert doc["totals"][r]["cache_hits"] == 1
        assert miss["trace_id"] in cell[r]["trace_ids"]
    joined = {a["trace_id"] for a in doc["reqtrace"]}
    assert {d["trace_id"] for ds in docs.values() for d in ds} <= joined


def test_conf_installs_the_recorder(tmp_path):
    """spark.rapids.obs.reqtrace.* arm the recorder from a session conf
    (first installer wins), with the conf's ring, ratio and path."""
    _serving_session(**{
        "spark.rapids.obs.reqtrace.enabled": "true",
        "spark.rapids.obs.reqtrace.sampleRatio": "1.0",
        "spark.rapids.obs.reqtrace.minIntervalSeconds": "0",
        "spark.rapids.obs.reqtrace.events": "128",
        "spark.rapids.obs.reqtrace.path": str(tmp_path),
        "spark.rapids.obs.replicaId": "conf-replica"})
    rec = reqtrace.recorder()
    assert rec is not None and rec.capacity == 128
    assert rec.sample_ratio == 1.0 and rec.replica_id == "conf-replica"
    TorchSession({"spark.rapids.obs.reqtrace.enabled": "true",
                  "spark.rapids.obs.reqtrace.events": "4096"},
                 device="cpu")
    assert reqtrace.recorder() is rec
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 200 and doc["reqtrace"]["verdict"] == "sampled"
    assert os.path.dirname(doc["reqtrace"]["path"]) == str(tmp_path)
    assert obs.healthz()["serving"]["reqtrace"]["exports"] == 1
