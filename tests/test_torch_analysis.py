"""The port's lock sanitizer (``analysis/sanitizer.py``), plan verifier
(``analysis/plan_verify.py``) and LORE dump and replay
(``runtime/lore.py``), on the CPU.

- tests/test_analysis.py's sanitizer cases: seeded inversions (one
  thread and across threads), held-lock blocking, a wait under a foreign
  lock, a wait on the condition alone, ranking, pass-through when off,
  dump without a trace, installation through the session's conf, and a
  clean engine that stays silent (here a pipelined, serialized-shuffle
  query instead of the NDS probes).
- Its plan-verify cases without the fusion ones (PV-FUSE, PV-ABSORB and
  the dispatch budgets wait for stage fusion): a schema-changing wrapper,
  a malformed schema, a pipeline at the root or over a non-scan or at
  depth 0, a cycle, the raised error, and the conf that runs the verifier
  inside convert_plan; plus the port's real trees, which verify clean.
- tests/test_aux_subsystems.py's LORE dump and replay, whose replay
  equals the JAX package's answer, and the LORE id on exec spans.
"""
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.analysis import sanitizer
from spark_rapids_tpu_torch.analysis.plan_verify import (
    PlanVerifyError, check_plan, verify_plan,
)
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


# ---------------------------------------------------------------------------
# Runtime concurrency sanitizer: seeded bugs must be caught
# ---------------------------------------------------------------------------

@pytest.fixture
def san():
    # 250 ms: nested-acquire stack capture under an outer lock must not
    # fake a held-lock finding on a loaded box; tests about hold
    # detection re-install with their own tight threshold
    sanitizer.uninstall()
    sanitizer.install(hold_warn_ms=250.0)
    yield sanitizer
    sanitizer.uninstall()


def _kinds(rep):
    return [f["kind"] for f in rep["findings"]]


def test_sanitizer_seeded_lock_inversion(san):
    a, b = san.lock("seed.A"), san.lock("seed.B")
    with a:
        with b:
            pass
    assert _kinds(san.report()) == []  # one order alone is legal
    with b:
        with a:
            pass
    inv = [f for f in san.report()["findings"]
           if f["kind"] == "lock-inversion"]
    assert len(inv) == 1
    assert sorted(inv[0]["locks"]) == ["seed.A", "seed.B"]
    assert inv[0]["stack"] and inv[0]["stack_held"]
    # dedup: exhibiting the inversion again does not re-report
    with b:
        with a:
            pass
    assert len([f for f in san.report()["findings"]
                if f["kind"] == "lock-inversion"]) == 1


def test_sanitizer_seeded_cross_thread_inversion(san):
    """The ABBA across two threads, sequenced so it cannot deadlock: the
    sanitizer reports it from order evidence alone."""
    a, b = san.lock("xt.A"), san.lock("xt.B")
    done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        done.set()

    th = threading.Thread(target=t1)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert done.wait(5)
    with b:
        with a:
            pass
    inv = [f for f in san.report()["findings"]
           if f["kind"] == "lock-inversion"]
    assert len(inv) == 1 and sorted(inv[0]["locks"]) == ["xt.A", "xt.B"]


def test_sanitizer_seeded_held_lock_blocking(san):
    san.uninstall()
    san.install(hold_warn_ms=5.0)
    lk = san.lock("seed.hold")
    with lk:
        time.sleep(0.02)  # the runtime signature of I/O under a lock
    holds = [f for f in san.report()["findings"]
             if f["kind"] == "held-lock-blocking"]
    assert len(holds) == 1
    assert holds[0]["locks"] == ["seed.hold"]
    assert holds[0]["held_ms"] >= 5.0 and holds[0]["stack"]


@pytest.mark.parametrize("foreign", [True, False])
def test_sanitizer_wait_under_lock(san, foreign):
    """A wait while holding another sanitized lock is reported; a wait
    on the condition alone is clean."""
    other = san.lock("seed.other")
    cv = san.condition("seed.cv")
    if foreign:
        with other:
            with cv:
                cv.wait(timeout=0.01)
    else:
        with cv:
            cv.wait(timeout=0.01)
    waits = [f for f in san.report()["findings"]
             if f["kind"] == "wait-under-lock"]
    if foreign:
        assert len(waits) == 1
        assert waits[0]["locks"][0] == "seed.cv"
        assert "seed.other" in waits[0]["locks"]
    else:
        assert waits == []


def test_sanitizer_report_ranking(san):
    san.uninstall()
    san.install(hold_warn_ms=5.0)
    a, b = san.lock("rank.A"), san.lock("rank.B")
    with a:
        time.sleep(0.02)  # hold finding (severity 2)
    with a:
        with b:
            pass
    with b:
        with a:
            pass  # inversion finding (severity 0)
    kinds = _kinds(san.report())
    assert kinds[0] == "lock-inversion"
    assert kinds[-1] == "held-lock-blocking"


def test_sanitizer_disabled_is_passthrough():
    sanitizer.uninstall()
    lk = sanitizer.lock("off.lock")
    with lk:
        assert lk.locked()
    cv = sanitizer.condition("off.cv")
    with cv:
        cv.wait(timeout=0.01)
    assert sanitizer.report() == {"enabled": False, "findings": [],
                                  "edges": 0}


def test_sanitizer_dump_without_and_with_a_trace(san, tmp_path):
    """dump() reports whether or not a trace is live; under a trace each
    finding becomes a sanitizerFinding instant on the query's
    timeline."""
    from spark_rapids_tpu_torch.runtime import trace
    san.uninstall()
    san.install(hold_warn_ms=5.0)
    lk = san.lock("dump.hold")
    with lk:
        time.sleep(0.02)
    assert _kinds(san.dump()) == ["held-lock-blocking"]
    s = TorchSession({"spark.rapids.sql.trace.enabled": "true",
                      "spark.rapids.sql.trace.path": str(tmp_path)},
                     device="cpu")
    qt = trace.start_query(s.conf)
    try:
        san.dump()
    finally:
        paths = trace.end_query(qt, status="ok")
    with open(paths["trace"]) as f:
        events = json.load(f)["traceEvents"]
    found = [e for e in events if e.get("name") == "sanitizerFinding"]
    assert len(found) == 1
    assert found[0]["args"]["kind"] == "held-lock-blocking"


def test_sanitizer_conf_installs_via_session():
    sanitizer.uninstall()
    try:
        s = TorchSession({"spark.rapids.debug.sanitizer.enabled": True,
                          "spark.rapids.debug.sanitizer.holdWarnMs": 250.0},
                         device="cpu")
        s.create_dataframe(pa.table({"a": [1, 2, 3]})).collect()
        assert sanitizer.enabled()
    finally:
        sanitizer.uninstall()


def test_sanitizer_silent_on_clean_engine():
    """A pipelined query through a serialized hash exchange (the host
    pool, the pipeline's locks, the shuffle store, the async writer's
    condition) records lock-order edges and produces no finding. The
    hold threshold is far above any critical section, so a loaded
    scheduler cannot fake a held-lock finding."""
    rng = np.random.default_rng(5)
    t = pa.table({"k": rng.integers(0, 50, 20_000),
                  "v": rng.integers(0, 100, 20_000)})
    sanitizer.uninstall()
    sanitizer.install(hold_warn_ms=2000.0)
    try:
        s = TorchSession({"spark.rapids.sql.reader.batchSizeRows": "1024",
                          "spark.rapids.shuffle.mode": "SERIALIZED"},
                         device="cpu")
        out = (s.create_dataframe(t, num_partitions=4).repartition(4, "k")
               .group_by("k").agg(F.sum(col("v")).alias("s"))).collect()
        assert out.num_rows == 50
        rep = sanitizer.report()
        assert rep["enabled"]
        assert rep["findings"] == [], json.dumps(rep["findings"], indent=1)
        assert rep["edges"] > 0 or rep["order_edges"] == []
    finally:
        sanitizer.uninstall()


# ---------------------------------------------------------------------------
# Plan-invariant verifier: seeded illegal trees + the real engine
# ---------------------------------------------------------------------------

class _Field:
    def __init__(self, name, dtype):
        self.name, self.dtype = name, dtype


class _Schema:
    def __init__(self, *fields):
        self.fields = list(fields)


def _node(clsname, schema, children=(), **attrs):
    n = type(clsname, (), {})()
    n.schema = schema
    n.children = list(children)
    for k, v in attrs.items():
        setattr(n, k, v)
    return n


_AB = _Schema(_Field("a", "int64"), _Field("b", "float64"))


def test_verify_schema_preserving_wrapper_violation():
    scan = _node("ParquetScanExec", _AB)
    filt = _node("FilterExec", _Schema(_Field("c", "int64")), [scan])
    viols = check_plan(filt)
    assert len(viols) == 1 and viols[0].startswith("PV-SCHEMA")
    assert "must preserve its child's schema" in viols[0]


def test_verify_malformed_schema():
    viols = check_plan(_node("ProjectExec", None))
    assert viols and "well-formed" in viols[0]


def test_verify_pipeline_at_root_and_bad_wrap():
    scan = _node("ParquetScanExec", _AB)
    pipe = _node("PipelineExec", _AB, [scan], depth=2)
    viols = check_plan(pipe)  # pipe IS the root here
    assert any("PV-PIPE" in v and "root" in v for v in viols)

    sort = _node("SortExec", _AB, [_node("ParquetScanExec", _AB)])
    pipe2 = _node("PipelineExec", _AB, [sort], depth=0)
    root = _node("ProjectExec", _AB, [pipe2])
    viols = check_plan(root)
    assert any("only host-producing scans" in v for v in viols)
    assert any("depth must be >= 1" in v for v in viols)


def test_verify_tree_cycle():
    n = _node("ProjectExec", _AB)
    n.children = [n]
    viols = check_plan(n)
    assert any("PV-TREE" in v and "cycle" in v for v in viols)


def test_verify_plan_raises_with_violation_list():
    filt = _node("FilterExec", _Schema(_Field("c", "int64")),
                 [_node("ParquetScanExec", _AB)])
    with pytest.raises(PlanVerifyError) as ei:
        verify_plan(filt)
    assert len(ei.value.violations) == 1
    assert "PV-SCHEMA" in str(ei.value)


def test_plan_verify_conf_runs_in_convert(monkeypatch):
    """spark.rapids.debug.planVerify.enabled verifies every converted tree
    inside convert_plan; a violation raises before anything runs."""
    from spark_rapids_tpu_torch.runtime import pipeline as PL
    s = TorchSession({"spark.rapids.debug.planVerify.enabled": True},
                     device="cpu")
    df = s.create_dataframe(pa.table({"a": [1, 2, 3, 4]}))
    assert df.collect().num_rows == 4
    real = PL.insert_pipelines

    def at_root(root, conf):
        return PL.PipelineExec(root.plan, [real(root, conf)], conf,
                               root.device, 2)

    monkeypatch.setattr(PL, "insert_pipelines", at_root)
    agg = df.group_by("a").agg(F.count().alias("n"))
    with pytest.raises(PlanVerifyError, match="PipelineExec at the root"):
        agg.collect()


def _tables(n=6_000, seed=3):
    rng = np.random.default_rng(seed)
    t = pa.table({"k": rng.integers(0, 30, n), "v": rng.normal(0, 5, n),
                  "s": np.array(["x", "y", "z"])[rng.integers(0, 3, n)]})
    return t, t.slice(0, 200).rename_columns(["k2", "v2", "s2"])


#: real trees of the port: every operator class reaches the verifier
VERIFY_PROGRAMS = {
    "agg_2parts": lambda s, t, d, p: s.create_dataframe(
        t, num_partitions=2).group_by("k").agg(F.sum(col("v")).alias("x")),
    "repart_agg": lambda s, t, d, p: s.create_dataframe(
        t, num_partitions=3).repartition(4, "k").group_by("s").agg(
        F.count().alias("n")),
    "join_sort_limit": lambda s, t, d, p: s.create_dataframe(t).join(
        s.create_dataframe(d), col("k") == col("k2")).sort(
        col("v").desc()).limit(10),
    "parquet_device": lambda s, t, d, p: s.read_parquet(p).filter(
        col("v") > 0.0).group_by("s").agg(F.count().alias("n")),
    "cached_union": lambda s, t, d, p: s.create_dataframe(t).cache().union(
        s.create_dataframe(t)).group_by("k").agg(F.count().alias("n")),
}


@pytest.mark.parametrize("name", list(VERIFY_PROGRAMS))
def test_real_plans_verify_clean(name, tmp_path):
    from spark_rapids_tpu_torch.plan.overrides import convert_plan
    t, d = _tables()
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=2000)
    s = TorchSession({"spark.rapids.debug.planVerify.enabled": True,
                      "spark.rapids.sql.reader.batchSizeRows": "1024"},
                     device="cpu")
    df = VERIFY_PROGRAMS[name](s, t, d, path)
    root, _ = convert_plan(df.plan, s.conf, s.device)
    assert check_plan(root) == []
    assert df.collect().num_rows > 0


# ---------------------------------------------------------------------------
# LORE dump and replay
# ---------------------------------------------------------------------------

def _t(n=40):
    rng = np.random.default_rng(0)
    return pa.table({
        "k": pa.array(np.array(["a", "b"], object)[rng.integers(0, 2, n)]),
        "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})


@pytest.mark.parametrize("lore_id", [0, 1])
def test_lore_dump_and_replay(tmp_path, lore_id):
    """Every operator's inputs are dumped with its plan; replaying the
    root (id 0: the aggregate over its dumped input) or the pipeline
    boundary (id 1: over the scan's dumped batches) gives the query's
    answer, which equals the JAX package's."""
    from spark_rapids_tpu_torch.runtime import lore
    d = str(tmp_path / "lore")
    t = _t(30)
    s = TorchSession({"spark.rapids.sql.lore.dumpPath": d}, device="cpu")
    df = s.create_dataframe(t).group_by("k").agg(F.sum(col("v")))
    expect = {r["k"]: r["sum(v)"] for r in df.collect().to_pylist()}
    ids = sorted(os.listdir(d))
    assert any(x.startswith("loreId=") for x in ids)
    with open(os.path.join(d, f"loreId={lore_id}", "plan.txt")) as f:
        head = f.readline()
    assert head.startswith(f"loreId={lore_id} exec=")
    out = lore.replay(d, lore_id, df.plan, TorchSession(device="cpu").conf,
                      device="cpu")
    if lore_id == 0:
        got = {r["k"]: r["sum(v)"] for r in out.to_pylist()}
        assert got == expect
        japi = jax_api()
        jdf = japi.session().create_dataframe(t).group_by("k").agg(
            japi.F.sum(japi.col("v")))
        assert got == {r["k"]: r["sum(v)"] for r in
                       jdf.collect().to_pylist()}
    else:
        assert "PipelineExec" in head
        assert sorted(out.to_pylist(), key=repr) == \
            sorted(t.to_pylist(), key=repr)


def test_lore_id_on_exec_spans(tmp_path):
    api = torch_api()
    s = TorchSession({"spark.rapids.sql.lore.dumpPath": str(tmp_path / "l"),
                      "spark.rapids.sql.trace.enabled": "true",
                      "spark.rapids.sql.trace.path": str(tmp_path / "t")},
                     device="cpu")
    s.create_dataframe(_t(50)).group_by("k").agg(
        api.F.sum(api.col("v"))).collect()
    with open(s.last_trace_paths["trace"]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "exec"]
    assert spans
    lids = {e["name"].split(".")[0]: e["args"]["lore_id"] for e in spans}
    ids = {type(n).__name__: n.lore_id for n in s.last_exec.walk()}
    for name, lid in lids.items():
        assert ids[name] == lid
