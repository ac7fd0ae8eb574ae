"""The kernel cost auditor of the port (spark_rapids_tpu_torch/analysis/
kernel_audit.py), held against the JAX package where the programs are not
bound to XLA.

The programs of tests/test_kernel_audit.py: padding-waste math at bucket
boundaries, off the ladder and under the growth factor (the same inputs
through both packages' functions), determinism across two cold runs with
4 task-wave threads, the steady state adding no audit work, the off path,
the warm unaudited entry as a finding, the roofline reconciling with the
attribution and reaching every surface, compare_signature's answers
against the JAX function's, and the CPU golden cold prefix
(tests/torch_cost_signatures.json, written by
tools/torch_gen_cost_signatures.py). Then the port's own: a hand kernel's
plain version is charged its formula, views are charged nothing, a
value-dependent size is charged at its capacity, the KERNEL_PRIMITIVES
roster, and a real audited record driving the measured cost pass.
"""
import ast
import importlib.util
import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import reset_torch_runtime, torch_api

from spark_rapids_tpu.analysis import kernel_audit as JKA
from spark_rapids_tpu.runtime import shapes as JSH

from spark_rapids_tpu_torch.analysis import kernel_audit as KA
from spark_rapids_tpu_torch.runtime import compile_cache as CC
from spark_rapids_tpu_torch.runtime import shapes as SH

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "spark_rapids_tpu_torch")
GOLDEN = os.path.join(os.path.dirname(__file__), "torch_cost_signatures.json")
TA = torch_api()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _tool("torch_gen_cost_signatures")


@pytest.fixture(autouse=True)
def _fresh():
    from spark_rapids_tpu_torch.plan import cost as COST
    from spark_rapids_tpu_torch.runtime.obs import attribution
    reset_torch_runtime()
    attribution.reset_for_tests()
    COST.reset_for_tests()
    KA.reset_for_tests(drop_records=True)
    yield
    KA.reset_for_tests(drop_records=True)
    SH.configure(2.0, True)
    JSH.configure(2.0, True)
    reset_torch_runtime()
    COST.reset_for_tests()


def _table(rows=30000, seed=13):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 7, rows), "v": rng.random(rows)})


def _query(s, t, num_partitions=1):
    col, lit, F = TA.col, TA.lit, TA.F
    df = s.create_dataframe(t, num_partitions=num_partitions)
    return (df.filter(col("v") > lit(0.3)).group_by("k")
            .agg(F.sum(col("v")).alias("s"), F.count(col("v")).alias("c")))


def _narrow(s, t, num_partitions=4):
    """A fused Filter -> Project over 4 partitions: its root runs as a task
    wave of 4 threads, which race on the same (entry, signature)."""
    col, lit = TA.col, TA.lit
    return (s.create_dataframe(t, num_partitions=num_partitions)
            .filter(col("v") > lit(0.25))
            .select(col("k"), (col("v") * lit(3.0)).alias("v3")))


def _audited(**conf):
    base = {"spark.rapids.obs.audit.enabled": "true"}
    base.update(conf)
    return TA.session(base)


# ---------------------------------------------------------------------------
# padding-waste math, against the JAX package's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1024, 2048, 8192, 1 << 16, 1 << 20])
def test_padding_waste_math_at_bucket_boundaries(cap):
    assert SH.is_bucketed(cap, 1)
    floor = KA.bucket_floor_live(cap)
    assert floor == JKA.bucket_floor_live(cap)
    assert SH.bucket_rows(floor, 1) == cap
    assert floor == 1 or SH.bucket_rows(floor - 1, 1) < cap
    assert KA.padding_waste(cap, cap) == JKA.padding_waste(cap, cap) == 0.0
    assert KA.max_padding_waste(cap) == JKA.max_padding_waste(cap) == \
        pytest.approx((cap - floor) / cap)
    for live in (floor, cap // 2 + cap // 4, cap - 1):
        assert KA.padding_waste(live, cap) == JKA.padding_waste(live, cap)


def test_padding_waste_off_ladder_capacity():
    for cap in (1000, 0, 3000):
        assert KA.bucket_floor_live(cap) == JKA.bucket_floor_live(cap)
        assert KA.max_padding_waste(cap) == JKA.max_padding_waste(cap)
    assert KA.bucket_floor_live(1000) is None
    assert KA.max_padding_waste(1000) == 0.0


@pytest.mark.parametrize("growth", [1.25, 1.5])
def test_padding_waste_tracks_growth_factor(growth):
    w2 = KA.max_padding_waste(1 << 16)
    SH.configure(growth, True)
    JSH.configure(growth, True)
    cap = SH.bucket_rows(50000, 1)
    assert cap == JSH.bucket_rows(50000, 1)
    assert KA.bucket_floor_live(cap) == JKA.bucket_floor_live(cap)
    assert KA.max_padding_waste(cap) == JKA.max_padding_waste(cap) < w2


# ---------------------------------------------------------------------------
# determinism, the steady state, the off path, findings
# ---------------------------------------------------------------------------

def test_signature_deterministic_across_cold_runs_and_threads():
    t = _table()
    sigs = []
    for _ in range(2):
        s = _audited()
        queries = [_query(s, t, num_partitions=4), _narrow(s, t)]
        KA.clear_for_cold_audit()
        KA.reset_for_tests(drop_records=True)
        KA.set_enabled(True)
        run = []
        for q in queries:
            q.collect()
            sig = KA.query_signature(s.last_audit())
            assert sig, "no signature from an audited cold run"
            run.append(sig)
        sigs.append(json.dumps(run, sort_keys=True))
    assert sigs[0] == sigs[1]
    assert not KA.findings()
    # the narrow query's fused stage ran once a partition
    assert json.loads(sigs[0])[1]["fused_stage"]["dispatches"] == 4


def test_steady_state_adds_no_audit_work():
    s = _audited()
    q = _query(s, _table(rows=20000, seed=5))
    KA.clear_for_cold_audit()
    q.collect()
    cold = KA.query_signature(s.last_audit())
    shapes_after_cold = KA.stats()["shapes"]
    q.collect()
    assert KA.stats()["shapes"] == shapes_after_cold
    assert KA.stats()["pending"] == 0
    assert KA.query_signature(s.last_audit()) == cold
    assert not KA.findings()


def test_disabled_path_zero_per_dispatch_work():
    s = TA.session()
    before = KA.stats()["shapes"]
    _query(s, _table(rows=8000, seed=3)).collect()
    assert CC._AUDITOR is None
    assert KA.stats()["shapes"] == before
    assert KA.stats()["pending"] == 0
    assert s.last_audit() is None and s.last_roofline() is None


def test_warm_unaudited_entry_is_a_finding():
    t = _table(rows=9000, seed=9)
    _query(TA.session(), t).collect()  # built with the audit off
    warm = _audited()
    _query(warm, t).collect()  # the same keys: warm entries, no records
    assert any("unaudited entry" in f for f in KA.findings())
    assert warm.last_audit()["query_findings"]


# ---------------------------------------------------------------------------
# the roofline and its surfaces
# ---------------------------------------------------------------------------

def test_roofline_reconciles_and_reaches_every_surface(tmp_path):
    from spark_rapids_tpu_torch.runtime import obs
    from spark_rapids_tpu_torch.runtime.obs import console
    s = _audited(**{"spark.rapids.obs.historyDir": str(tmp_path)})
    q = _query(s, _table(rows=40000, seed=21))
    KA.clear_for_cold_audit()
    q.collect()
    roof, attr = s.last_roofline(), s.last_attribution()
    assert roof and attr
    dev = roof["groups"]["device_compute"]["seconds"]
    a_dev = (attr["buckets"]["device_compute"]
             * attr.get("concurrency_factor", 1.0))
    assert abs(dev - a_dev) <= 0.01 * max(dev, a_dev, 1e-9)
    assert roof["groups"]["device_compute"]["bound"] in (
        "memory", "compute", "dispatch_overhead")
    assert roof["peak_gbps"] == 3350.0 and roof["peak_gflops"] == 66900.0
    text = s.explain_analyze()
    assert "-- roofline (audit" in text and "device_compute" in text
    recs = obs.state().history.read_all()
    assert recs and recs[-1]["roofline"]["groups"]["device_compute"][
        "achieved_gbps"] == roof["groups"]["device_compute"]["achieved_gbps"]
    st = obs.state()
    prom = st.registry.render_prometheus()
    assert "rapids_roofline_achieved_gbps" in prom
    assert 'rapids_roofline_pct{group="total"}' in prom
    assert st.last_roofline is roof
    page = console.render_live()
    assert "Roofline — last audited query" in page
    report = _tool("torch_roofline_report")
    rows = report.summarize(report.load_records(str(tmp_path)))
    assert len(rows) == 1 and rows[0]["top_kernel"]


def test_audited_record_drives_the_measured_collapse(tmp_path):
    """No hand-written verdict: the cold run's audited record says the
    exchange is dispatch-bound (on the CPU every group is), and the next
    conversion of the same plan collapses the aggregate exchange."""
    from spark_rapids_tpu_torch.exec import adaptive as AQ

    def names(sess):
        return [type(n).__name__ for n in H.chosen_execs(sess.last_exec)]

    s = _audited(**{"spark.rapids.obs.historyDir": str(tmp_path)})
    li = s.create_dataframe(H.make_lineitem(3000), num_partitions=3)
    df = H.pctl_shuffled(TA, li)
    cold = df.collect()
    assert "ShuffleExchangeExec" in names(s)
    assert s.last_roofline()["groups"]["shuffle"]["bound"] == \
        "dispatch_overhead"
    warm = df.collect()
    (d,) = [d for d in (s.last_aqe() or {}).get("decisions", [])
            if d["kind"] == AQ.MEASURED_COST]
    assert d["exchange_parts"] == 1
    assert "ShuffleExchangeExec" not in names(s)
    assert "CollectExchangeExec" in names(s)
    assert sorted(cold.to_pylist(), key=repr) == \
        sorted(warm.to_pylist(), key=repr)


# ---------------------------------------------------------------------------
# compare_signature against the JAX function
# ---------------------------------------------------------------------------

_GOLD = {"fused_stage": {"dispatches": 4, "entries": 1, "shapes": 2,
                         "flops": 1000, "bytes_accessed": 5000,
                         "in_bytes": 100, "out_bytes": 50},
         "gone": {"dispatches": 1, "entries": 1, "shapes": 1, "flops": 1,
                  "bytes_accessed": 1, "in_bytes": 1, "out_bytes": 1}}
_GOT = {"fused_stage": dict(_GOLD["fused_stage"], bytes_accessed=10000,
                            dispatches=6),
        "novel": {"dispatches": 1, "entries": 1, "shapes": 1, "flops": 1,
                  "bytes_accessed": 1, "in_bytes": 1, "out_bytes": 1}}


@pytest.mark.parametrize("golden,got,tol", [
    (_GOLD, _GOT, 0.0), (_GOLD, _GOT, 2.0), (_GOLD, _GOLD, 0.0),
    (None, _GOT, 0.0), (_GOLD, None, 0.0)])
def test_compare_signature_names_the_dimension(golden, got, tol):
    diffs = KA.compare_signature("q7", golden, got, rel_tol=tol)
    assert diffs == JKA.compare_signature("q7", golden, got, rel_tol=tol)
    if golden is _GOLD and got is _GOT and not tol:
        assert "q7: fused_stage bytes_accessed regressed 5000 -> 10000" \
            in diffs
        assert "q7: fused_stage dispatches regressed 4 -> 6" in diffs
        assert any("vanished" in d and "gone" in d for d in diffs)
        assert any("new kernel class" in d and "novel" in d for d in diffs)
    if tol:
        assert not any("bytes_accessed regressed" in d for d in diffs)


# ---------------------------------------------------------------------------
# the CPU golden cold prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", [1, 2])
def test_golden_cost_signature_cold_prefix(prefix):
    with open(GOLDEN) as f:
        doc = json.load(f)
    assert doc["_sf"] == GEN.SF and doc["_seed"] == GEN.SEED
    assert doc["kernel_primitives"] == sorted(KA.KERNEL_PRIMITIVES)
    sigs = GEN.build_cost_signatures(prefix)
    problems = []
    for qn, sig in sigs.items():
        problems += KA.compare_signature(
            f"q{qn}", doc["cost_signatures"][qn], sig)
    assert len(sigs) == prefix and not problems, "\n".join(problems)


# ---------------------------------------------------------------------------
# the mode's charges
# ---------------------------------------------------------------------------

def _charge_of(fn, *args, key="probe"):
    """The record of one audited call of fn(*args) as a keyed entry."""
    KA.set_enabled(True)
    full_key = (key, (), ())
    KA.mark_built(full_key)
    out = KA.wrap(full_key, fn)(*args)
    recs = [r for r in KA.records_doc() if r["family"] == key]
    assert len(recs) == 1
    return recs[0], out


def _kernel_cases():
    from spark_rapids_tpu_torch.ops import bitslice as BS
    from spark_rapids_tpu_torch.ops import case_map as CM
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    g = torch.Generator().manual_seed(3)
    vals = torch.randint(-1000, 1000, (4096,), dtype=torch.int32,
                         generator=g)
    gid = torch.sort(torch.randint(0, 50, (4096,), dtype=torch.int32,
                                   generator=g)).values
    pay = torch.randint(-3, 4, (5, 4096), generator=g).to(torch.bfloat16)
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (300,),
                          dtype=torch.int32, generator=g)
    off = torch.randint(0, 298 * 32, (2000,), dtype=torch.int64,
                        generator=g)
    mask = torch.full((2000,), (1 << 7) - 1, dtype=torch.int32)
    raw = torch.randint(0, 256, (7000,), dtype=torch.uint8, generator=g)
    return {
        "murmur3_int32": (MK.murmur3_int32, (vals, 42),
                          MK.murmur3_int32_plain),
        "murmur3_int32_rows": (MK.murmur3_int32, (vals, vals),
                               MK.murmur3_int32_plain),
        "segsum": (S.segsum, (gid, pay, 64), S.segsum_plain),
        "bitslice": (BS.bitslice, (words, off, mask), BS.bitslice_plain),
        "case_map": (CM.case_map, (raw, True), CM.case_map_plain),
    }


@pytest.mark.parametrize("name", ["murmur3_int32", "murmur3_int32_rows",
                                  "segsum", "bitslice", "case_map"])
def test_plain_version_is_charged_its_formula(name):
    wrapper, args, plain = _kernel_cases()[name]
    kname = name.replace("_rows", "")
    rec, out = _charge_of(wrapper, *args, key="kernel_" + name)
    nbytes, flops = KA.KERNEL_COSTS[kname](*args)
    assert rec["bytes_accessed"] == nbytes and rec["flops"] == flops
    assert rec["kernels"] == {kname: (1, nbytes, flops)}
    assert torch.equal(out, plain(*args))


def test_views_are_charged_nothing():
    x = torch.arange(4096, dtype=torch.int64)

    def views(a):
        m = a.view(64, 64).t()[1:, ::2]
        return m.narrow(0, 2, 10), a.unsqueeze(0).expand(3, -1), m.select(
            1, 4), a.as_strided((10,), (3,))

    rec, _ = _charge_of(views, x, key="views")
    assert rec["bytes_accessed"] == 0 and rec["flops"] == 0

    def add(a):
        return a + 1

    rec, _ = _charge_of(add, x, key="add")
    # one read and one write of the plane (the scalar rides as a 0-d)
    assert 2 * 4096 * 8 <= rec["bytes_accessed"] <= 2 * 4096 * 8 + 8
    assert rec["flops"] == 4096
    assert rec["in_bytes"] == rec["out_bytes"] == 4096 * 8
    assert rec["row_capacity"] == 4096


def test_value_dependent_sizes_are_charged_at_capacity():
    def select(a):
        kept = a[a > 0]
        return kept * 2

    few = torch.full((4096,), -1.0)
    few[:3] = 1.0
    many = torch.ones(4096)
    r1, o1 = _charge_of(select, few, key="sel")
    KA.reset_for_tests(drop_records=True)
    r2, o2 = _charge_of(select, many, key="sel")
    assert o1.numel() == 3 and o2.numel() == 4096
    assert r1["bytes_accessed"] == r2["bytes_accessed"] > 0
    assert r1["flops"] == r2["flops"]


def test_kernel_primitives_roster():
    """Every port module that loads a csrc/*.cu library through
    ops/_build.load is on KERNEL_PRIMITIVES, and every entry does."""
    cu = {os.path.splitext(f)[0]
          for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith(".cu")}
    loaders = set()
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "load" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and node.args[0].value in cu:
                    loaders.add(os.path.relpath(path, PKG))
    assert loaders == set(KA.KERNEL_PRIMITIVES)
    assert set(KA.KERNEL_COSTS) == {"murmur3_int32", "segsum", "bitslice",
                                    "case_map"}
