"""The port's serving layer (``spark_rapids_tpu_torch/runtime/serving``)
against the JAX package's, on the CPU.

The programs of tests/test_serving.py run against the port: the
digest-keyed result cache (byte parity, epoch invalidation, bounded
churn, single-flight, the rand bypass, the ANSI fingerprint), named
conf-overlay sessions, the POST /sql HTTP surface with its typed 400/429
docs and the /serving doc, and the QoS tier riding task waves. Parity
cases serve the same SQL through a JAX ``TpuSession`` and through the
port and compare the deserialized tables. Then the port's own: the
overlay session lands on the root's device, a CPU server makes no CUDA
call, a hit runs nothing, a deadline answers 499 and leaves the device
semaphore idle, the packed aggregate's key dispatch reaches the cancel
checkpoint, and the plan digest a served request carries is its
record's (ROADMAP C28; the JAX package's answer is asserted beside it).

Tolerances: rows exact (tests/asserts.py ``assert_tables_equal``); the
cached payload byte for byte.
"""
import base64
import http.client
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import reset_torch_runtime

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.runtime import obs, serving
from spark_rapids_tpu_torch.runtime.serving.result_cache import ResultCache
from spark_rapids_tpu_torch.runtime.serving.server import deserialize_table


def _reset_jax():
    from spark_rapids_tpu.runtime import obs as jobs
    from spark_rapids_tpu.runtime import serving as jserving
    from spark_rapids_tpu.runtime.obs import flight as jflight
    from spark_rapids_tpu.runtime.obs import reqtrace as jrt
    jobs.shutdown_for_tests()
    jflight.uninstall_for_tests()
    jrt.uninstall_for_tests()
    jserving.reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh():
    """Serving rides the obs endpoint: each test gets fresh obs, serving
    and reqtrace singletons, in both packages."""
    reset_torch_runtime()
    _reset_jax()
    yield
    reset_torch_runtime()
    _reset_jax()


def _table(n=600, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 9, n),
                     "v": rng.integers(1, 1000, n)})


def _serving_session(**extra):
    conf = {"spark.rapids.serving.enabled": "true"}
    conf.update(extra)
    s = TorchSession(conf, device="cpu")
    s.create_or_replace_temp_view("t", s.create_dataframe(_table()))
    return s


_SQL = "SELECT k, SUM(v) AS sv FROM t GROUP BY k ORDER BY k"


def _rows(doc):
    return deserialize_table(base64.b64decode(doc["result"]))


# ---------------------------------------------------------------------------
# the result cache through the server
# ---------------------------------------------------------------------------

def test_hit_is_byte_identical_and_counted():
    _serving_session()
    code1, d1 = serving.handle_sql({"sql": _SQL})
    code2, d2 = serving.handle_sql({"sql": _SQL})
    assert (code1, d1["cache"]) == (200, "miss")
    assert (code2, d2["cache"]) == (200, "hit")
    assert d1["result"] == d2["result"]
    tbl = _rows(d2)
    assert tbl.num_rows == 9 and tbl.column_names == ["k", "sv"]
    assert d2["attribution"] is None and d2["xla_compiles"] == 0
    st = serving.server().cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    assert 0 < st["bytes"] and st["entries"] == 1
    assert st["hit_ratio"] == 0.5


def test_view_replace_bumps_epoch_and_invalidates():
    s = _serving_session()
    _, d1 = serving.handle_sql({"sql": _SQL})
    s.create_or_replace_temp_view(
        "t", s.create_dataframe(_table(seed=99)))
    code, d2 = serving.handle_sql({"sql": _SQL})
    assert code == 200 and d2["cache"] == "miss"
    assert d2["plan_digest"] == d1["plan_digest"]
    assert _rows(d1).to_pylist() != _rows(d2).to_pylist(), \
        "epoch invalidation served stale data"


def test_explicit_cache_false_and_rand_plan_bypass():
    s = _serving_session()
    code, doc = serving.handle_sql({"sql": _SQL, "cache": False})
    assert code == 200 and doc["cache"] == "bypass"
    assert doc["plan_digest"] is None
    s.create_or_replace_temp_view("samp", s.table("t").sample(0.5, seed=3))
    code, doc = serving.handle_sql({"sql": "SELECT k FROM samp"})
    assert code == 200 and doc["cache"] == "bypass"
    assert serving.server().cache.stats()["bypasses"] == 2


def test_ansi_fingerprint_splits_keys():
    s = _serving_session()
    cache = serving.server().cache
    plan = s.sql(_SQL).plan
    k_plain = cache.key_for(plan, s.conf)
    k_ansi = cache.key_for(
        plan, C.RapidsConf({"spark.sql.ansi.enabled": "true"}))
    assert k_plain is not None and k_ansi is not None
    assert k_plain[0] == k_ansi[0] and k_plain != k_ansi


def test_named_session_overlay_and_session_limit():
    _serving_session()
    code, doc = serving.handle_sql({
        "sql": _SQL, "session": "alice",
        "conf": {"spark.sql.ansi.enabled": "true"}})
    assert code == 200 and doc["session"] == "alice"
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 200 and doc["cache"] == "miss"
    code, doc = serving.handle_sql({"sql": _SQL, "conf": {"a": "b"}})
    assert code == 400 and doc["error_type"] == "ValueError"
    serving.server().max_sessions = 1
    code, doc = serving.handle_sql({"sql": _SQL, "session": "bob"})
    assert code == 429 and doc["error_type"] == "QueryRejectedError"
    assert "maxSessions" in doc["message"]


# ---------------------------------------------------------------------------
# ResultCache unit behavior (no engine underneath)
# ---------------------------------------------------------------------------

def test_bounded_churn_evicts_lru_and_accounts_bytes():
    rc = ResultCache(max_bytes=1 << 20, max_entries=3)
    for i in range(7):
        rc.get_or_execute(("k", i), lambda i=i: bytes(100 + i))
    st = rc.stats()
    assert st["entries"] == 3 and st["evictions"] == 4
    assert st["bytes"] == sum(100 + i for i in (4, 5, 6))
    assert rc.lookup(("k", 0)) is None
    assert rc.lookup(("k", 6)) is not None
    rc2 = ResultCache(max_bytes=64, max_entries=8)
    rc2.get_or_execute(("big",), lambda: bytes(1000))
    assert rc2.stats()["entries"] == 0 and rc2.stats()["bytes"] == 0


def test_single_flight_one_execution_many_waiters():
    rc = ResultCache(max_bytes=1 << 20, max_entries=8)
    executions = []
    barrier = threading.Barrier(5)
    results = []

    def execute():
        executions.append(threading.get_ident())
        time.sleep(0.15)
        return b"payload"

    def worker():
        barrier.wait()
        results.append(rc.get_or_execute(("hot",), execute))

    threads = [threading.Thread(target=worker) for _ in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert len(executions) == 1, "single-flight executed more than once"
    assert len(results) == 5
    assert all(p == b"payload" for p, _ in results)
    assert sorted(o for _, o in results) == \
        ["hit", "hit", "hit", "hit", "miss"]


def test_single_flight_leader_failure_promotes_follower():
    rc = ResultCache(max_bytes=1 << 20, max_entries=8)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.1)
            raise RuntimeError("leader dies")
        return b"ok"

    errs, box = [], {}

    def leader():
        try:
            rc.get_or_execute(("f",), flaky)
        except RuntimeError as e:
            errs.append(e)

    def follower():
        box["out"] = rc.get_or_execute(("f",), flaky)

    tl = threading.Thread(target=leader)
    tf = threading.Thread(target=follower)
    tl.start()
    while not calls:
        time.sleep(0.005)
    tf.start()
    tl.join(10)
    tf.join(10)
    assert len(errs) == 1
    assert box["out"] == (b"ok", "miss") and len(calls) == 2


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------

def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    body = json.dumps(payload).encode()
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_post_sql_roundtrip_429_and_serving_doc():
    port = _free_port()
    _serving_session(**{"spark.rapids.obs.port": str(port)})
    port = obs.state().server.port
    code, doc = _post(port, "/sql", {"sql": _SQL})
    assert code == 200 and doc["status"] == "ok"
    assert _rows(doc).num_rows == 9
    code, doc = _post(port, "/sql", {"sql": "SELEC nope"})
    assert code == 400 and doc["status"] == "bad_request"
    code, doc = _post(port, "/sql", {})
    assert code == 400 and doc["error_type"] == "ValueError"
    serving.server().max_inflight = 0
    code, doc = _post(port, "/sql", {"sql": _SQL})
    assert code == 429 and doc["error_type"] == "QueryRejectedError"
    serving.server().max_inflight = 32
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", "/serving")
    sv = json.loads(conn.getresponse().read())
    assert sv["enabled"] and sv["requests"] >= 4 and sv["rejected"] >= 1
    assert sv["result_cache"]["entries"] >= 1
    conn.request("GET", "/healthz")
    hz = json.loads(conn.getresponse().read())
    assert hz["serving"]["enabled"] is True
    conn.request("GET", "/console")
    page = conn.getresponse().read().decode()
    assert "<h2>Serving</h2>" in page
    conn.close()


def test_serving_off_is_404_and_absent_doc():
    port = _free_port()
    TorchSession({"spark.rapids.obs.port": str(port)}, device="cpu")
    port = obs.state().server.port
    assert not serving.installed() and serving.server_doc() is None
    code, doc = _post(port, "/sql", {"sql": _SQL})
    assert code == 404 and "serving" in doc["message"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", "/serving")
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()
    conn.close()


def test_qos_tier_rides_wave_threads_and_restores():
    """spark.rapids.serving.requestNice: the background tier is
    thread-local, rides run_task_wave's fan-out like the conf does,
    raises the worker's OS niceness for the task and restores both."""
    from spark_rapids_tpu_torch.runtime import host_pool as HP

    assert HP.qos_nice() == 0
    tid = threading.get_native_id()
    base_prio = os.getpriority(os.PRIO_PROCESS, tid)
    seen = []

    def work(i):
        wtid = threading.get_native_id()
        seen.append((HP.qos_nice(),
                     os.getpriority(os.PRIO_PROCESS, wtid)))
        return i * 10

    out = HP.run_at_nice(
        7, lambda: HP.run_task_wave(work, [1, 2, 3]))
    assert out == [10, 20, 30]
    assert [n for n, _ in seen] == [7, 7, 7]
    if HP._nice_restorable():
        assert all(p >= 7 for _, p in seen), \
            "worker ran a background-tier task at high priority"
    assert HP.qos_nice() == 0
    assert os.getpriority(os.PRIO_PROCESS, tid) == base_prio


def test_qos_tier_rides_pool_submits():
    """The shared host pool's workers run a background request's task at
    its tier and go back to the latency tier after it."""
    from spark_rapids_tpu_torch.runtime import host_pool as HP
    pool = HP.get_host_pool()
    got = HP.run_at_nice(5, lambda: pool.submit(HP.qos_nice).result(10))
    assert got == 5
    assert pool.submit(HP.qos_nice).result(10) == 0


# ---------------------------------------------------------------------------
# parity: the same SQL served by both packages
# ---------------------------------------------------------------------------

_PARITY = {
    "group_order": _SQL,
    "filter_project": "SELECT k, v * 2 AS w FROM t WHERE v > 500",
    "global_agg": "SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS lo, "
                  "MAX(v) AS hi FROM t",
    "self_join": "SELECT a.k, COUNT(*) AS n FROM t a JOIN u b "
                 "ON a.k = b.k GROUP BY a.k",
    "computed_key": "SELECT COUNT(g) AS n, SUM(s) AS ts FROM (SELECT g, "
                    "SUM(v) AS s FROM (SELECT k % 4 AS g, v FROM t) p "
                    "GROUP BY g) q",
}


@pytest.mark.parametrize("name", sorted(_PARITY))
def test_served_answers_equal_the_jax_packages(name):
    from spark_rapids_tpu.runtime import serving as jserving
    from spark_rapids_tpu.sql.session import TpuSession
    small = _table(n=300, seed=5)
    docs = []
    for make, srv in ((lambda c: TorchSession(c, device="cpu"), serving),
                      (TpuSession, jserving)):
        s = make({"spark.rapids.serving.enabled": "true"})
        s.create_or_replace_temp_view("t", s.create_dataframe(_table()))
        s.create_or_replace_temp_view("u", s.create_dataframe(small))
        code, miss = srv.handle_sql({"sql": _PARITY[name]})
        code2, hit = srv.handle_sql({"sql": _PARITY[name]})
        assert (code, code2) == (200, 200)
        assert (miss["cache"], hit["cache"]) == ("miss", "hit")
        assert hit["result"] == miss["result"]
        docs.append(miss)
    port, jax_ = (_rows(d) for d in docs)
    assert_tables_equal(port, jax_,
                        ignore_order="ORDER BY" not in _PARITY[name])


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_overlay_session_lands_on_the_roots_device():
    s = _serving_session()
    code, doc = serving.handle_sql({
        "sql": _SQL, "session": "bg",
        "conf": {"spark.rapids.serving.requestNice": "3"}})
    assert code == 200
    overlay = serving.server()._sessions["bg"]
    assert overlay is not s and overlay.device == s.device
    assert overlay.device.type == "cpu"
    assert overlay._views is s._views
    assert overlay.conf.get(C.SERVING_REQUEST_NICE) == 3
    assert_tables_equal(_rows(doc), s.sql(_SQL).collect())


def test_cpu_server_makes_no_cuda_call(monkeypatch, tmp_path):
    """A CPU root serves misses, hits, overlays and traced requests
    without initializing CUDA."""
    import torch
    calls = []

    def no_cuda(*a, **k):
        calls.append(1)
        raise AssertionError("the CPU server initialized CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    from spark_rapids_tpu_torch.runtime.obs import reqtrace
    reqtrace.install(out_dir=str(tmp_path), sample_ratio=1.0)
    _serving_session()
    for payload in ({"sql": _SQL}, {"sql": _SQL},
                    {"sql": _SQL, "session": "x",
                     "conf": {"spark.sql.ansi.enabled": "true"}}):
        code, _ = serving.handle_sql(payload)
        assert code == 200
    assert not calls


def test_kernel_error_while_parsing_is_a_failure(monkeypatch):
    """A kernel that fails under a scalar subquery's collect while the
    SQL is parsed fails the request (500): it is not the client's bad
    request."""
    from spark_rapids_tpu_torch.ops._build import KernelError
    _serving_session()

    def broken(self, text):
        raise KernelError("segsum: launch failed")
    monkeypatch.setattr(TorchSession, "sql", broken)
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 500 and doc["error_type"] == "KernelError"
    assert serving.server().doc()["failed"] == 1


def test_hit_runs_nothing(monkeypatch):
    """A hit is host bytes: no collect, no conversion, no kernel."""
    s = _serving_session()
    serving.handle_sql({"sql": _SQL})
    ran = []
    monkeypatch.setattr(TorchSession, "collect",
                        lambda self, *a, **k: ran.append(1))
    code, doc = serving.handle_sql({"sql": _SQL})
    assert code == 200 and doc["cache"] == "hit" and not ran
    assert s.last_exec is not None


def test_deadline_answers_499_and_leaves_the_semaphore_idle(tmp_path):
    from spark_rapids_tpu_torch.runtime import semaphore as SEM
    from spark_rapids_tpu_torch.runtime.obs import reqtrace
    reqtrace.install(out_dir=str(tmp_path), sample_ratio=0.0)
    s = _serving_session(**{
        "spark.rapids.sql.reader.batchSizeRows": "64",
        "spark.rapids.debug.faults": "scan.decode:delay:40",
        "spark.rapids.debug.faults.delayMs": "40"})
    s.create_or_replace_temp_view(
        "big", s.create_dataframe(_table(n=4000), num_partitions=2))
    code, doc = serving.handle_sql({
        "sql": "SELECT k, SUM(v) AS s FROM big GROUP BY k",
        "timeout_seconds": 0.2})
    assert code == 499 and doc["status"] == "cancelled"
    assert doc["reqtrace"]["verdict"] == "deadline"
    assert os.path.exists(doc["reqtrace"]["path"])
    assert s.last_action_status == ("cancelled", "deadline")
    sem = SEM.peek_semaphore()
    assert sem is None or (sem.available == sem.permits
                           and sem.waiting == 0)
    assert serving.server().doc()["cancelled"] == 1


def test_packed_key_dispatch_is_audited_and_checkpointed(monkeypatch):
    """The packed aggregate's keys run through the keyed stage cache's
    run_stage family (the JAX package's dispatch): the auditor charges
    it, and a cancel checkpoint runs before it, so a served deadline on a
    packed group-by fires one dispatch sooner."""
    from spark_rapids_tpu_torch.analysis import kernel_audit
    from spark_rapids_tpu_torch.exec import nodes as X
    from spark_rapids_tpu_torch.runtime import lifecycle as LC
    from spark_rapids_tpu_torch.sql import functions as F
    s = TorchSession({"spark.rapids.obs.audit.enabled": "true"},
                     device="cpu")
    kernel_audit.clear_for_cold_audit()
    df = s.create_dataframe(_table()).group_by("k").agg(
        F.sum("v").alias("s"))
    order = []
    real_check, real_stage = LC.check_current, X._key_stage
    monkeypatch.setattr(LC, "check_current",
                        lambda: order.append("check") or real_check())

    def key_stage(exprs):
        inner = real_stage(exprs)

        def stage(*a):
            order.append("keys")
            return inner(*a)
        return stage
    monkeypatch.setattr(X, "_key_stage", key_stage)
    df.collect()
    assert "keys" in order and order[order.index("keys") - 1] == "check"
    assert s.last_audit()["classes"]["run_stage"]["dispatches"] == 1


def test_served_digest_is_the_records_c28(tmp_path):
    """ROADMAP C28: ``convert_plan`` prunes a plan in place, so an
    aggregate over an absorbable projection changes digest at its first
    collect. The JAX package's key digests the plan as built: its
    response, its hit records and ``_slow_vs_baseline`` carry a digest
    no query record has, so the baseline is never found. The port's key
    prunes first and carries the record's digest."""
    from spark_rapids_tpu.runtime import obs as jobs
    from spark_rapids_tpu.runtime import serving as jserving
    from spark_rapids_tpu.sql.session import TpuSession
    sql = _PARITY["computed_key"]
    answers = {}
    for tag, make, srv, o in (
            ("port", lambda c: TorchSession(c, device="cpu"), serving,
             obs),
            ("jax", TpuSession, jserving, jobs)):
        s = make({"spark.rapids.serving.enabled": "true",
                  "spark.rapids.obs.historyDir": str(tmp_path / tag),
                  "spark.rapids.obs.slo.minRuns": "2"})
        s.create_or_replace_temp_view("t", s.create_dataframe(_table()))
        code, miss = srv.handle_sql({"sql": sql})
        code2, hit = srv.handle_sql({"sql": sql})
        assert (code, code2, hit["cache"]) == (200, 200, "hit")
        s.sql(sql).collect()  # a second ok run arms the baseline
        recs = o.state().history.read_all()
        q = [r["plan_digest"] for r in recs if r["type"] == "query"]
        h = [r["plan_digest"] for r in recs
             if r["type"] == "result_cache_hit"]
        assert len(set(q)) == 1 and h == [miss["plan_digest"]]
        found = srv.server()._slow_vs_baseline("ok", miss["plan_digest"],
                                               1e9)
        answers[tag] = (miss["plan_digest"] == q[0], found)
    assert answers == {"port": (True, True), "jax": (False, False)}


def test_conf_keys_are_the_jax_packages():
    from spark_rapids_tpu import config as JC
    port = {k for k in C.keys()
            if k.startswith(("spark.rapids.serving.",
                             "spark.rapids.obs.reqtrace."))}
    assert len(port) == 15
    for k in port:
        if k != "spark.rapids.obs.reqtrace.path":
            assert C.registry()[k].default == JC.registry()[k].default, k
    assert set(JC.registry()) - set(C.keys()) == {
        "spark.rapids.sql.multichip.enabled",
        "spark.rapids.sql.multichip.devices"}
