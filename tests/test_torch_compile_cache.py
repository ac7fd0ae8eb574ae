"""The compile layer of the port: warmup, the kernel-build counters and the
build directory, the /healthz compile and warmup documents, and the
per-action profile capture (spark_rapids_tpu_torch/runtime/
compile_cache.py, runtime/warmup.py, ops/_build.py, sql/session.py).

The warmup programs of tests/test_compile_cache.py run through the port:
replays prime the keyed cache (the user's first run of a warmed plan
builds nothing), the ranking prefers recurrence, a replay failure never
raises, and nothing arms without history; a replay also takes device
permits like a query and gives them all back. The build counters are
held with a fake compiler (the CPU tests need no nvcc): a miss, then a hit,
in the directory spark.rapids.compile.cacheDir names.
"""
import json
import os
import stat

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_port_helpers import reset_torch_runtime, torch_api

from spark_rapids_tpu.runtime import warmup as JWU

from spark_rapids_tpu_torch.ops import _build
from spark_rapids_tpu_torch.runtime import compile_cache as CC
from spark_rapids_tpu_torch.runtime import warmup

TA = torch_api()
QUERY = "SELECT a, SUM(b) AS sb FROM t WHERE a > 10 GROUP BY a"


@pytest.fixture(autouse=True)
def _fresh():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _seed_history(tmp_path, runs=2):
    hist = str(tmp_path / "hist")
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": list(range(200)),
                             "b": [float(i) for i in range(200)]}), path)
    s1 = TA.session({"spark.rapids.obs.historyDir": hist})
    s1.create_or_replace_temp_view("t", s1.read_parquet(path))
    for _ in range(runs):
        s1.sql(QUERY).collect()
    from spark_rapids_tpu_torch.runtime import obs
    obs.shutdown_for_tests()  # the next session opens its own store
    return hist, path


def _warm_session(hist):
    return TA.session({"spark.rapids.obs.historyDir": hist,
                       "spark.rapids.compile.warmup.enabled": "true"})


# ---------------------------------------------------------------------------
# warmup (runtime/warmup.py)
# ---------------------------------------------------------------------------

def test_history_records_carry_sql(tmp_path):
    hist, _ = _seed_history(tmp_path)
    recs = [json.loads(ln) for ln in
            open(os.path.join(hist, "query_history.jsonl"))]
    assert all(r.get("sql", "").startswith("SELECT") for r in recs)
    assert len({r["plan_digest"] for r in recs}) == 1


def test_warmup_replays_prime_the_cache(tmp_path):
    from spark_rapids_tpu_torch.runtime.semaphore import peek_semaphore
    hist, path = _seed_history(tmp_path)
    CC.clear()
    n_hist = len(open(os.path.join(hist, "query_history.jsonl"))
                 .readlines())
    s2 = _warm_session(hist)
    mgr = warmup.manager()
    assert mgr is not None and mgr.doc()["pending"] == 1
    s2.create_or_replace_temp_view("t", s2.read_parquet(path))
    assert mgr.wait(60), "warmup never drained"
    doc = mgr.doc()
    assert doc["replayed"] == 1 and doc["failed"] == 0
    assert warmup.doc() == doc
    # replays prime caches; they are not user queries
    assert len(open(os.path.join(hist, "query_history.jsonl"))
               .readlines()) == n_hist
    # the replay took device permits like a query and gave them back
    sem = peek_semaphore()
    assert sem is not None and sem.available == sem.permits
    before = CC.stats()
    s2.sql(QUERY).collect()
    after = CC.stats()
    assert after["misses"] == before["misses"]
    assert after["xla_compiles"] == before["xla_compiles"]


def test_warmup_ranking_prefers_recurrence(tmp_path):
    recs = (
        [{"type": "query", "status": "ok", "plan_digest": "aa",
          "sql": "SELECT 1"}] * 3
        + [{"type": "query", "status": "ok", "plan_digest": "bb",
            "sql": "SELECT 2"}] * 5
        + [{"type": "query", "status": "failed", "plan_digest": "cc",
            "sql": "SELECT 3"}] * 9
        + [{"type": "query", "status": "ok", "plan_digest": "dd",
            "sql": "SELECT 4"}]
        + [{"type": "nds_scorecard", "plan_digest": "ee"}] * 9)
    with open(tmp_path / "query_history.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    for min_runs, max_plans in ((2, 8), (1, 3), (4, 8), (2, 1)):
        hot = warmup._hot_plans(str(tmp_path), min_runs, max_plans)
        assert hot == JWU._hot_plans(str(tmp_path), min_runs, max_plans)
    assert [h["digest"] for h in warmup._hot_plans(str(tmp_path), 2, 8)] \
        == ["bb", "aa"]


def test_warmup_replay_failure_never_raises(tmp_path):
    hist, path = _seed_history(tmp_path)
    s2 = _warm_session(hist)
    mgr = warmup.manager()
    # the shadow session inherits s2's conf: an injected scan ioerror
    # fails the replay, which is counted and never raised
    s2.conf.set("spark.rapids.debug.faults", "scan.decode:ioerror:1")
    s2.create_or_replace_temp_view("t", s2.read_parquet(path))
    assert mgr.wait(60)
    doc = mgr.doc()
    assert doc["failed"] == 1 and doc["replayed"] == 0
    s2.conf.set("spark.rapids.debug.faults", "")
    assert s2.sql("SELECT a FROM t").collect().num_rows == 200


def test_warmup_not_armed_without_history():
    TA.session({"spark.rapids.compile.warmup.enabled": "true"})
    assert warmup.manager() is None and warmup.doc() is None


# ---------------------------------------------------------------------------
# /healthz
# ---------------------------------------------------------------------------

def test_healthz_compile_and_warmup_documents(tmp_path):
    from spark_rapids_tpu_torch.runtime import obs
    TA.session()
    doc = obs.healthz()
    cd = doc.get("compile")
    assert cd is not None
    for k in ("warm_entries", "hits", "misses", "compile_seconds",
              "xla_compiles", "xla_compile_seconds", "persistent_dir",
              "persistent_hits", "persistent_misses"):
        assert k in cd
    assert doc["warmup"] is None
    hist, _ = _seed_history(tmp_path)
    _warm_session(hist)
    assert obs.healthz()["warmup"]["plans"] == 1


# ---------------------------------------------------------------------------
# the kernel-build counters and spark.rapids.compile.cacheDir
# ---------------------------------------------------------------------------

def test_cache_dir_default_keeps_build_torch_kernels():
    TA.session()
    assert CC.build_root() is None
    assert _build.build_root() == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.endswith(os.path.join("build", "torch_kernels"))


def test_cache_dir_counts_a_build_then_a_load(tmp_path, monkeypatch):
    """A fake nvcc writes a real (empty) shared library: the first load
    builds it under cacheDir (a compile and a miss), a second process's
    load (the library dropped from this one) finds it there (a hit)."""
    from spark_rapids_tpu_torch.runtime import obs
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
                    "done\n"
                    "exec cc -shared -fPIC -o \"$out\" -x c /dev/null\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    cache = tmp_path / "kernels"
    TA.session({"spark.rapids.compile.cacheDir": str(cache)})
    assert CC.build_root() == str(cache)
    reg = obs.state().registry
    names = ("rapids_xla_compiles_total",
             "rapids_persistent_cache_misses_total",
             "rapids_persistent_cache_hits_total")
    reg0 = [reg.counter(n).value for n in names]
    before = CC.stats()
    _build.load("case_map")
    mid = CC.stats()
    assert mid["xla_compiles"] == before["xla_compiles"] + 1
    assert mid["persistent_misses"] == before["persistent_misses"] + 1
    assert mid["persistent_hits"] == before["persistent_hits"]
    assert mid["xla_compile_ns"] > before["xla_compile_ns"]
    assert [p.name.split("-")[0] for p in cache.iterdir()] == ["case_map"]
    _build._libs.clear()
    _build.load("case_map")
    after = CC.stats()
    assert after["xla_compiles"] == mid["xla_compiles"]
    assert after["persistent_hits"] == mid["persistent_hits"] + 1
    assert [reg.counter(n).value - v for n, v in zip(names, reg0)] == \
        [1, 1, 1]
    assert obs.healthz()["compile"]["persistent_dir"] == str(cache)


# ---------------------------------------------------------------------------
# spark.rapids.profile.dir
# ---------------------------------------------------------------------------

def test_profile_dir_writes_a_trace_per_action(tmp_path):
    col, lit = TA.col, TA.lit
    prof = tmp_path / "prof"
    s = TA.session({"spark.rapids.profile.dir": str(prof),
                    "spark.rapids.sql.trace.enabled": "true",
                    "spark.rapids.sql.trace.path": str(tmp_path / "tr")})
    df = s.create_dataframe(pa.table({"a": list(range(100))}))
    df.filter(col("a") > lit(10)).collect()
    first = s.last_profile_path
    df.collect()
    assert first and s.last_profile_path != first
    assert sorted(os.listdir(prof)) == sorted(
        os.path.basename(p) for p in (first, s.last_profile_path))
    with open(first) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the structured trace's spans ride in as record_function ranges
    assert any(n and n.startswith("FusedStageExec") for n in names) or \
        any(n and "Exec" in n for n in names), sorted(names)[:40]


def test_profile_dir_nested_capture_raises(tmp_path):
    s = TA.session({"spark.rapids.profile.dir": str(tmp_path)})
    df = s.create_dataframe(pa.table({"a": [1, 2, 3]}))
    with torch.profiler.profile():
        with pytest.raises(RuntimeError, match="cannot nest"):
            df.collect()
    assert df.collect().num_rows == 3
