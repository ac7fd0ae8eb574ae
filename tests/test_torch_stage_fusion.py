"""Stage fusion, the shape-bucket ladder and the keyed stage cache in the
port (spark_rapids_tpu_torch), held against the JAX package.

The programs of tests/test_stage_fusion.py and the shape and keyed-cache
programs of tests/test_compile_cache.py run through both packages: plan
shape (collapse, the switch, a lone operator, explain("stages")), one
dispatch a batch under each package's dispatch hook, fused against
unfused parity (ANSI, masked, empty, the row-base carry, LIMIT and its
early stop, Expand absorbed and masked), last_metrics, the build-failure
fallbacks, and the differential group-by. Then the dispatch budget of
every NDS probe plan (tools/nds_probe.py, rebuilt here for the port) and
of the five bench shapes against the JAX package's, the expected fusion
groups chip_smoke.py checks, and the rule that an error raised while a
fused stage runs a batch propagates and is never replayed unfused.

The JAX package plans for one device here (jax.devices patched to one),
as the port does.
"""
import importlib.util
import math
import os
import re

import jax
import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from data_gen import (
    DoubleGen, IntegerGen, LongGen, RepeatSeqGen, StringGen, gen_table,
)
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import fuse as JF
from spark_rapids_tpu.exec import stage_fusion as JSF
from spark_rapids_tpu.exec import tpu_nodes as JX
from spark_rapids_tpu.plan import nodes as JP
from spark_rapids_tpu.plan.overrides import convert_plan as jconvert
from spark_rapids_tpu.runtime import shapes as JSH
from spark_rapids_tpu.runtime.task import TaskContext as JTaskContext

from spark_rapids_tpu_torch import config as TC
from spark_rapids_tpu_torch.analysis import plan_verify as PV
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.columnar.batch import to_arrow
from spark_rapids_tpu_torch.exec import fuse as PF
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.exec import stage_fusion as SF
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.ops._build import KernelError
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.plan.overrides import convert_plan
from spark_rapids_tpu_torch.runtime import compile_cache as CC
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import shapes
from spark_rapids_tpu_torch.runtime.task import TaskContext

from spark_rapids_tpu.analysis import plan_verify as JPV

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TA, JA = torch_api(), jax_api()
OFF = {"spark.rapids.sql.stageFusion.enabled": "false"}

_SPEC = [("k", RepeatSeqGen(IntegerGen(min_val=0, max_val=40), length=30)),
         ("v", LongGen(min_val=-(1 << 40), max_val=1 << 40)),
         ("d", DoubleGen()),
         ("s", StringGen())]


def _restore_shape_policy():
    """The port's and the JAX package's published shape policy back at
    their defaults (both are module globals a session publishes)."""
    shapes.configure(2.0, True)
    PB.MIN_CAPACITY = 1024
    CC.publish_conf(TC.RapidsConf())
    JSH.configure(2.0, True)
    JB.MIN_CAPACITY = 1024


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    H.reset_torch_runtime()
    yield
    PF.set_dispatch_hook(None)
    JF.set_dispatch_hook(None)
    H.reset_torch_runtime()
    _restore_shape_policy()


def _sess(api, conf=None):
    return api.session(conf)


def _df(api, s, spec=_SPEC, length=1800, seed=11, parts=3):
    return s.create_dataframe(gen_table(spec, length, seed),
                              num_partitions=parts)


def _chain(api, df, masked=False):
    col, lit = api.col, api.lit
    if masked:
        df = df.filter(col("s").is_not_null())
    return (df.filter(col("v").is_not_null() & (col("v") > lit(0)))
            .select(col("k"), (col("v") % lit(1000)).alias("m"),
                    (col("d") * lit(2.0)).alias("dd")))


def _eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_eq(a[k], b[k]) for k in a)
    return a == b


def _sorted(rows, keys):
    def k(r):
        out = []
        for c in keys:
            v = r[c]
            bad = v is None or (isinstance(v, float) and math.isnan(v))
            out.append((bad, 0 if bad else v))
        return out
    return sorted(rows, key=k)


def _port_convert(df):
    return convert_plan(df.plan, df.session.conf, df.session.device)[0]


def _jax_convert(df):
    return jconvert(df.plan, df.session.conf)[0]


def _drain(ex, names):
    rows = []
    for p in range(ex.num_partitions):
        with TaskContext(partition_id=p):
            for b in ex.execute_partition(p):
                rows.extend(to_arrow(b, names).to_pylist())
    return rows


def _jdrain(ex, names):
    from spark_rapids_tpu.columnar.batch import to_arrow as jto_arrow
    rows = []
    for p in range(ex.num_partitions):
        with JTaskContext(partition_id=p) as ctx:
            for b in ex.execute_partition(ctx, p):
                rows.extend(jto_arrow(b, names).to_pylist())
    return rows


class _Dispatches:
    """Counts dispatches through a package's fuse layer."""

    def __init__(self, mod):
        self.mod, self.keys = mod, []

    def __enter__(self):
        self.mod.set_dispatch_hook(self.keys.append)
        return self

    def __exit__(self, *exc):
        self.mod.set_dispatch_hook(None)
        return False


# ---------------------------------------------------------------------------
# Plan shape
# ---------------------------------------------------------------------------

def test_chain_collapses_to_fused_stage():
    roots = []
    for api, conv in ((TA, _port_convert), (JA, _jax_convert)):
        roots.append(conv(_chain(api, _df(api, _sess(api)))))
    port, jroot = roots
    assert isinstance(port, SF.FusedStageExec)
    assert isinstance(jroot, JSF.fused_stage_cls())
    assert [type(m).__name__ for m in port.members] == \
        [type(m).__name__ for m in jroot.members] == \
        ["FilterExec", "ProjectExec"]
    assert PV.check_plan(port) == []


def test_fusion_disabled_keeps_chain():
    port = _port_convert(_chain(TA, _df(TA, _sess(TA, OFF))))
    jroot = _jax_convert(_chain(JA, _df(JA, _sess(JA, OFF))))
    for root, proj, filt in ((port, X.ProjectExec, X.FilterExec),
                             (jroot, JX.ProjectExec, JX.FilterExec)):
        assert isinstance(root, proj)
        assert isinstance(root.children[0], filt)
    assert PV.dispatch_budget(port)["fusion_groups"] == \
        JPV.dispatch_budget(jroot)["fusion_groups"] == []


def test_single_dispatching_op_not_fused():
    for api, conv, filt in ((TA, _port_convert, X.FilterExec),
                            (JA, _jax_convert, JX.FilterExec)):
        df = _df(api, _sess(api), length=300, seed=3, parts=1)
        assert isinstance(conv(df.filter(api.col("v") > api.lit(0))), filt)


def _stage_lines(text):
    """The explain("stages") lines that name a stage or a member: the
    ``*(n)`` marker and the operator class."""
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*(\*\(\d+\)) (\w+)", line)
        if m:
            out.append((m.group(1), m.group(2),
                        line.rstrip().endswith("[fused]")))
    return out


def test_explain_stages_prints_fusion_groups(capsys):
    got = {}
    for name, api in (("port", TA), ("jax", JA)):
        got[name] = _chain(api, _df(api, _sess(api))).explain(mode="stages")
    capsys.readouterr()
    s = got["port"]
    assert "*(1)" in s and "FusedStageExec" in s and "[fused]" in s
    assert _stage_lines(s) == _stage_lines(got["jax"])
    assert _stage_lines(s)[0] == ("*(1)", "FusedStageExec", False)


# ---------------------------------------------------------------------------
# Dispatch budget: one dispatch a batch
# ---------------------------------------------------------------------------

def _agg_table(n_rows=3000):
    rng = np.random.default_rng(5)
    return pa.table({"g": rng.uniform(0, 6, n_rows).round(0),
                     "v": rng.integers(-1000, 1000, n_rows),
                     "d": rng.uniform(-10, 10, n_rows)})


def _partial_agg_chain(api, s, t, parts=3):
    """Filter -> Project -> partial HashAggregate over a float key, built
    as the multi-device planner shapes it."""
    col, lit, F = api.col, api.lit, api.F
    df = (s.create_dataframe(t, num_partitions=parts)
          .filter(col("v") > lit(-500))
          .select(col("g"), (col("v") * lit(3)).alias("v3"), col("d"))
          .group_by(col("g")).agg(F.sum("v3").alias("sv"),
                                  F.count().alias("n"),
                                  F.min("d").alias("md")))
    node = df.plan
    plan_cls = P.Aggregate if api is TA else JP.Aggregate
    while not isinstance(node, plan_cls):
        node = node.children[0]
    if api is TA:
        child, _ = convert_plan(node.children[0], s.conf, s.device)
        agg = X.HashAggregateExec(node, [child], s.conf, s.device,
                                  mode="partial")
        return SF.fuse_stages(agg, s.conf)
    child, _ = jconvert(node.children[0], s.conf)
    agg = JX.HashAggregateExec(node, [child], s.conf, mode="partial")
    return JSF.fuse_stages(agg, s.conf)


def test_partial_agg_chain_absorbed_one_dispatch_per_batch():
    t = _agg_table()
    root = _partial_agg_chain(TA, _sess(TA), t)
    jroot = _partial_agg_chain(JA, _sess(JA), t)
    assert [type(m).__name__ for m in root.pre_chain_members] == \
        [type(m).__name__ for m in jroot.pre_chain_members] == \
        ["FilterExec", "ProjectExec"]
    names = [f.name for f in root.state_fields()]
    with _Dispatches(PF) as dc:
        rows = _drain(root, names)
    with _Dispatches(JF) as jdc:
        jrows = _jdrain(jroot, names)
    assert rows
    assert len(dc.keys) == len(jdc.keys) == root.num_partitions
    assert all(k[0] == "hashagg_chain_update" for k in dc.keys)
    assert root.metrics.metric(M.STAGE_DISPATCHES).value == \
        root.num_partitions
    assert _eq(_sorted(rows, ["g"]), _sorted(jrows, ["g"]))


def test_fused_stage_one_dispatch_per_batch():
    root = _port_convert(_chain(TA, _df(TA, _sess(TA))))
    jroot = _jax_convert(_chain(JA, _df(JA, _sess(JA))))
    with _Dispatches(PF) as dc:
        rows = _drain(root, ["k", "m", "dd"])
    with _Dispatches(JF) as jdc:
        jrows = _jdrain(jroot, ["k", "m", "dd"])
    assert rows and _eq(rows, jrows)
    assert len(dc.keys) == len(jdc.keys) == root.num_partitions
    assert all(k[0] == "fused_stage" for k in dc.keys)
    assert root.metrics.metric(M.STAGE_DISPATCHES).value == \
        root.num_partitions
    fil, prj = root.members
    assert prj.metrics.metric(M.NUM_OUTPUT_ROWS).value == len(rows)
    assert fil.metrics.metric(M.NUM_OUTPUT_ROWS).value == len(rows)


def test_unfused_chain_pays_one_dispatch_per_op():
    root = _port_convert(_chain(TA, _df(TA, _sess(TA, OFF))))
    jroot = _jax_convert(_chain(JA, _df(JA, _sess(JA, OFF))))
    with _Dispatches(PF) as dc:
        _drain(root, ["k", "m", "dd"])
    with _Dispatches(JF) as jdc:
        _jdrain(jroot, ["k", "m", "dd"])
    assert len(dc.keys) == len(jdc.keys) == 2 * root.num_partitions
    assert sorted(k[0] for k in dc.keys) == sorted(k[0] for k in jdc.keys)


# ---------------------------------------------------------------------------
# Parity: fused against unfused, and against the JAX package
# ---------------------------------------------------------------------------

def _three_ways(build, conf=None, keys=None):
    """The query's rows from the port fused, the port unfused and the
    JAX package (fused, its default)."""
    conf = dict(conf or {})
    out = []
    for api, extra in ((TA, {}), (TA, OFF), (JA, {})):
        rows = build(api, _sess(api, dict(conf, **extra))).collect() \
            .to_pylist()
        out.append(_sorted(rows, keys) if keys else rows)
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ansi", ["false", "true"])
def test_chain_parity_fused_vs_unfused(ansi, masked):
    fused, unfused, want = _three_ways(
        lambda api, s: _chain(api, _df(api, s), masked=masked),
        {"spark.sql.ansi.enabled": ansi})
    assert _eq(fused, unfused) and _eq(fused, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ansi", ["false", "true"])
def test_agg_chain_parity_fused_vs_unfused(ansi, masked):
    def build(api, s):
        col, lit, F = api.col, api.lit, api.F
        df = _df(api, s, length=2200, seed=23)
        if masked:
            df = df.filter(col("s").is_not_null())
        return (df.filter(col("v").is_not_null())
                .select((col("d") * lit(1.5)).alias("g"),
                        (col("v") % lit(97)).alias("m"))
                .group_by(col("g")).agg(F.sum("m").alias("sm"),
                                        F.count().alias("n")))
    fused, unfused, want = _three_ways(
        build, {"spark.sql.ansi.enabled": ansi}, keys=["g"])
    assert _eq(fused, unfused) and _eq(fused, want)


def test_empty_batches_parity():
    col, lit = TA.col, TA.lit
    fused, unfused, want = _three_ways(
        lambda api, s: _chain(api, _df(api, s)).filter(
            api.col("m") > api.lit(10 ** 9)))
    assert fused == unfused == want == []
    del col, lit


def test_empty_source_parity():
    t = pa.table({"k": pa.array([], pa.int64()),
                  "v": pa.array([], pa.int64())})
    fused, unfused, want = _three_ways(
        lambda api, s: s.create_dataframe(t)
        .filter(api.col("v") > api.lit(0))
        .select((api.col("k") + api.lit(1)).alias("k1"),
                (api.col("v") * api.lit(2)).alias("v2")))
    assert fused == unfused == want == []


def test_ansi_error_still_raises_through_fused_stage():
    def build(api, s):
        col, lit = api.col, api.lit
        return (s.create_dataframe({"a": [1, 2, 3], "b": [1, 0, 2]})
                .filter(col("a") > lit(0))
                .select((col("a") / col("b")).alias("q"),
                        (col("a") + lit(1)).alias("a1"))
                .filter(col("a1") > lit(0)))
    conf = {"spark.sql.ansi.enabled": "true"}
    df = build(TA, _sess(TA, conf))
    assert isinstance(_port_convert(df), SF.FusedStageExec)
    with pytest.raises(SparkException):
        df.collect()
    with pytest.raises(JA.E.SparkException):
        build(JA, _sess(JA, conf)).collect()


def test_row_base_carry_threads_through_fused_stage():
    def build(api, s):
        col, lit = api.col, api.lit
        return (s.create_dataframe({"v": list(range(2000))},
                                   num_partitions=2)
                .filter(col("v") % lit(3) > lit(0))
                .select(col("v"),
                        api.F.monotonically_increasing_id().alias("id"))
                .filter(col("v") > lit(10)))
    conf = {"spark.rapids.sql.reader.batchSizeRows": "256"}
    s = _sess(TA, conf)
    assert isinstance(_port_convert(build(TA, s)), SF.FusedStageExec)
    fused, unfused, want = _three_ways(build, conf, keys=["v"])
    assert fused == unfused == want


def _limit_chain(api, s, n_rows=100, limit=20):
    col, lit = api.col, api.lit
    return (s.create_dataframe({"v": list(range(n_rows))})
            .filter(col("v") > lit(4))
            .limit(limit)
            .select((col("v") * lit(2)).alias("w"))
            .filter(col("w") < lit(40)))


def test_limit_in_fused_chain_parity():
    fused, unfused, want = _three_ways(_limit_chain)
    assert [r["w"] for r in fused] == [v * 2 for v in range(5, 20)]
    assert fused == unfused == want


def test_limit_fused_stage_stops_consuming_input():
    """A small LIMIT in a fused chain stops pulling batches once the
    device budget carry reaches zero."""
    conf = {"spark.rapids.sql.reader.batchSizeRows": "128"}

    def build(api, s):
        col, lit = api.col, api.lit
        return (s.create_dataframe({"v": list(range(4000))})
                .filter(col("v") >= lit(0))
                .limit(50)
                .select((col("v") + lit(1)).alias("w"))
                .filter(col("w") > lit(0)))
    root = _port_convert(build(TA, _sess(TA, conf)))
    assert isinstance(root, SF.FusedStageExec)
    with _Dispatches(PF) as dc:
        rows = _drain(root, ["w"])
    assert [r["w"] for r in rows] == list(range(1, 51))
    # 4000 rows / 128 a batch = 32 batches: the stage stops after the
    # limit-filling one
    assert len(dc.keys) <= 2
    assert root.metrics.metric(M.NUM_INPUT_BATCHES).value <= 2
    jroot = _jax_convert(build(JA, _sess(JA, conf)))
    with _Dispatches(JF) as jdc:
        jrows = _jdrain(jroot, ["w"])
    assert rows == jrows and len(dc.keys) == len(jdc.keys)


def _rollup(api, s):
    col, F = api.col, api.F
    spec = [("a", RepeatSeqGen(IntegerGen(min_val=0, max_val=4), length=7)),
            ("b", RepeatSeqGen(IntegerGen(min_val=0, max_val=3), length=5)),
            ("v", LongGen(min_val=0, max_val=1000))]
    return (_df(api, s, spec, length=600, seed=41, parts=2)
            .rollup(col("a"), col("b"))
            .agg(F.sum("v").alias("sv"), F.count().alias("n")))


def test_expand_grouping_sets_parity():
    fused, unfused, want = _three_ways(_rollup, keys=["a", "b"])
    assert _eq(fused, unfused) and _eq(fused, want)


def test_expand_absorbed_into_agg_one_dispatch_per_batch():
    """ROLLUP over a float key: the Expand's body runs in the (general
    route) aggregate's update, one dispatch an input batch."""
    rng = np.random.default_rng(13)
    n = 2000
    t = pa.table({"g": rng.uniform(0, 5, n).round(0),
                  "v": rng.integers(0, 100, n)})
    roots = []
    for api in (TA, JA):
        s = _sess(api)
        df = (s.create_dataframe(t, num_partitions=2)
              .rollup(api.col("g")).agg(api.F.sum("v").alias("sv"),
                                        api.F.count().alias("n")))
        node = df.plan
        plan_cls = P.Aggregate if api is TA else JP.Aggregate
        while not isinstance(node, plan_cls):
            node = node.children[0]
        if api is TA:
            child, _ = convert_plan(node.children[0], s.conf, s.device)
            assert isinstance(child, X.ExpandExec)
            agg = X.HashAggregateExec(node, [child], s.conf, s.device,
                                      mode="partial")
            roots.append(SF.fuse_stages(agg, s.conf))
        else:
            child, _ = jconvert(node.children[0], s.conf)
            agg = JX.HashAggregateExec(node, [child], s.conf,
                                       mode="partial")
            roots.append(JSF.fuse_stages(agg, s.conf))
    root, jroot = roots
    assert [type(m).__name__ for m in root.pre_chain_members] == \
        [type(m).__name__ for m in jroot.pre_chain_members]
    assert "ExpandExec" in [type(m).__name__ for m in root.pre_chain_members]
    assert root.pre_chain_members[-1].stacked
    names = [f.name for f in root.state_fields()]
    with _Dispatches(PF) as dc:
        rows = _drain(root, names)
    assert len(dc.keys) == root.num_partitions and len(rows) >= 2
    jrows = _jdrain(jroot, names)
    assert _eq(_sorted(rows, names), _sorted(jrows, names))


def test_expand_over_masked_input_parity():
    """Filter -> Expand absorbed into the aggregate: the live rows of the
    masked filter output sit past the live count, and the Expand body
    must not null them."""
    rng = np.random.default_rng(29)
    n = 1500
    t = pa.table({"g": rng.uniform(0, 5, n).round(0),
                  "b": rng.integers(0, 3, n),
                  "v": rng.integers(0, 100, n)})

    def build(api, s):
        col, lit, F = api.col, api.lit, api.F
        return (s.create_dataframe(t, num_partitions=2)
                .filter(col("v") % lit(7) > lit(1))
                .rollup(col("g"), col("b"))
                .agg(F.sum("v").alias("sv"), F.count().alias("n")))
    fused, unfused, want = _three_ways(build, keys=["g", "b"])
    assert _eq(fused, unfused) and _eq(fused, want)


def test_last_metrics_no_duplicate_subtrees():
    s = _sess(TA)
    df = _chain(TA, _df(TA, s))
    df.collect()
    keys = list(s.last_metrics().keys())
    assert len([k for k in keys if k.startswith("InMemoryScanExec")]) <= 1
    assert len([k for k in keys if k.startswith("FusedStageExec")]) == 1
    assert s.last_metrics()[next(k for k in keys if k.startswith(
        "FusedStageExec"))][M.STAGE_DISPATCHES] == 3


def test_absorbed_chain_build_failure_falls_back(monkeypatch):
    t = _agg_table()
    root = _partial_agg_chain(TA, _sess(TA), t)
    assert root.pre_chain is not None
    root._chain_key = lambda ansi: ("hashagg_chain_broken_test", ansi)

    def broken(ansi):
        def build():
            raise RuntimeError("synthetic build failure")
        return build

    monkeypatch.setattr(root, "_build_chain_update", broken)
    names = [f.name for f in root.state_fields()]
    rows = _drain(root, names)
    assert root._chain_failed and rows
    ref = _partial_agg_chain(TA, _sess(TA, OFF), t)
    assert ref.pre_chain is None
    assert _eq(_sorted(rows, ["g"]), _sorted(_drain(ref, names), ["g"]))


def test_fused_stage_build_failure_falls_back(monkeypatch):
    root = _port_convert(_chain(TA, _df(TA, _sess(TA))))
    assert isinstance(root, SF.FusedStageExec)
    root._key = ("fused_stage_broken_test", root._key)

    def broken_build():
        raise RuntimeError("synthetic build failure")

    monkeypatch.setattr(root, "_build", lambda: broken_build)
    got = _drain(root, ["k", "m", "dd"])
    assert root._failed
    want = _chain(TA, _df(TA, _sess(TA, OFF))).collect().to_pylist()
    assert _eq(got, want)


def test_kernel_error_in_fused_stage_propagates_unreplayed(monkeypatch):
    """An error raised while a fused stage runs a batch (here a hand
    kernel's KernelError) propagates unchanged: the stage is not marked
    failed and the unfused chain never runs."""
    root = _port_convert(_chain(TA, _df(TA, _sess(TA))))
    assert isinstance(root, SF.FusedStageExec)
    built = root._build()

    def failing_build():
        fn = built()

        def run(batch, pid, carries):
            raise KernelError("synthetic launch failure")
        return run if fn else None

    root._key = ("fused_stage_kernel_error_test", root._key)
    monkeypatch.setattr(root, "_build", lambda: failing_build)
    replays = []
    monkeypatch.setattr(root, "_unfused_chain",
                        lambda src: replays.append(src))
    with pytest.raises(KernelError, match="synthetic launch failure"):
        _drain(root, ["k", "m", "dd"])
    assert not root._failed and replays == []


def test_kernel_error_in_absorbed_chain_propagates(monkeypatch):
    root = _partial_agg_chain(TA, _sess(TA), _agg_table())
    root._chain_key = lambda ansi: ("hashagg_chain_kernel_error_test", ansi)

    def failing(ansi):
        def build():
            def fn(batch, pid, ctx_of):
                raise KernelError("synthetic launch failure")
            return fn
        return build

    monkeypatch.setattr(root, "_build_chain_update", failing)
    with pytest.raises(KernelError):
        _drain(root, [f.name for f in root.state_fields()])
    assert not root._chain_failed


def test_differential_group_by_under_fusion():
    def build(api, s):
        col, lit, F = api.col, api.lit, api.F
        return (_df(api, s, length=1500, seed=67)
                .filter(col("v").is_not_null())
                .select(col("k"), (col("v") % lit(50)).alias("m"))
                .group_by(col("k")).agg(F.sum("m").alias("sm"),
                                        F.count().alias("n")))
    for conf in ({}, OFF):
        df = build(TA, _sess(TA, conf))
        got = _sorted(df.collect().to_pylist(), ["k"])
        cpu = _sorted(df.collect_cpu().to_pylist(), ["k"])
        assert got == cpu


# ---------------------------------------------------------------------------
# The shape ladder and the keyed stage cache (test_compile_cache.py)
# ---------------------------------------------------------------------------

def test_default_policy_is_next_power_of_two():
    for n in (1, 2, 7, 8, 9, 100, 1023, 1024, 1025, 1 << 20, (1 << 20) + 1):
        expect = 1 << (max(n, 8) - 1).bit_length() if n > 1 else 8
        assert PB.round_capacity(n, minimum=8) == expect \
            == JB.round_capacity(n, minimum=8)


@pytest.mark.parametrize("growth", [1.25, 1.5, 3.0])
@pytest.mark.parametrize("itemsize", [None, 1, 4])
def test_bucket_ladder_fixpoint_and_monotone(growth, itemsize):
    shapes.configure(growth, True)
    JSH.configure(growth, True)
    ns = range(1, 200000, 37)
    caps = sorted({shapes.bucket_rows(n, 8, itemsize) for n in ns})
    for c in caps:
        assert shapes.bucket_rows(c, 8, itemsize) == c
    for n in range(1, 60000, 499):
        assert shapes.bucket_rows(n, 8, itemsize) >= n
    assert len(caps) < 64
    assert [shapes.bucket_rows(n, 8, itemsize) for n in ns] == \
        [JSH.bucket_rows(n, 8, itemsize) for n in ns]
    assert [shapes.bucket_pool_bytes(n) for n in range(0, 70000, 97)] == \
        [JSH.bucket_pool_bytes(n) for n in range(0, 70000, 97)]


def test_dtype_alignment_rounds_to_whole_tiles():
    shapes.configure(1.5, True)
    for n in (5000, 50000, 300000):
        assert shapes.bucket_rows(n, 8, 1) % (32 * 128) == 0
    shapes.configure(1.5, False)
    assert any(shapes.bucket_rows(n, 8, 1) % (32 * 128)
               for n in (5000, 50000, 300000))


def test_growth_factor_clamped():
    shapes.configure(0.5, True)
    assert shapes.GROWTH_FACTOR > 1.0
    shapes.configure(100.0, True)
    assert shapes.GROWTH_FACTOR <= 4.0


def test_conf_publishes_policy():
    s = _sess(TA, {"spark.rapids.compile.shapes.growthFactor": "1.5",
                   "spark.rapids.tpu.batchCapacityMinRows": "64"})
    TC.set_session_conf(s.conf)
    assert shapes.GROWTH_FACTOR == 1.5 and PB.MIN_CAPACITY == 64
    assert PB.round_capacity(1100) != 2048  # tighter than pow2
    js = _sess(JA, {"spark.rapids.compile.shapes.growthFactor": "1.5",
                    "spark.rapids.tpu.batchCapacityMinRows": "64"})
    from spark_rapids_tpu import config as JC
    JC.set_session_conf(js.conf)
    assert PB.round_capacity(1100) == JB.round_capacity(1100)


def test_ensure_bucketed_pads_foreign_batch():
    import torch
    from spark_rapids_tpu_torch import types as T
    data = torch.arange(12, dtype=torch.int64)
    valid = torch.tensor([True] * 10 + [False] * 2)
    b = PB.ColumnarBatch([PB.ColumnVector(T.INT64, data, valid)], 10)
    out = shapes.ensure_bucketed(b)
    assert out.capacity == 16 and out.num_rows == 10
    assert out.columns[0].data[:10].tolist() == list(range(10))
    assert bool(out.columns[0].validity[-1]) is False
    b2 = PB.from_arrow(pa.table({"a": list(range(20))}), "cpu")
    assert shapes.ensure_bucketed(b2) is b2


def _probe_df(api, s, rows=2000):
    rng = np.random.default_rng(7)
    t = pa.table({"k": rng.integers(0, 50, rows), "v": rng.random(rows)})
    col, lit, F = api.col, api.lit, api.F
    return (s.create_dataframe(t)
            .filter(col("v") > lit(0.25))
            .select(col("k"), (col("v") * lit(2.0)).alias("w"))
            .group_by(col("k")).agg(F.sum(col("w")).alias("s")))


def test_same_plan_twice_zero_new_builds():
    s = _sess(TA)
    df = _probe_df(TA, s)
    first = df.collect()
    warm = CC.stats()
    second = df.collect()
    after = CC.stats()
    assert after["misses"] == warm["misses"], "second run built new entries"
    assert after["hits"] > warm["hits"]
    assert first.to_pydict() == second.to_pydict()


def test_clear_cache_forces_rebuild():
    s = _sess(TA)
    df = _probe_df(TA, s)
    df.collect()
    PF.clear_cache()
    before = CC.stats()
    assert before["entries"] == 0
    df.collect()
    after = CC.stats()
    assert after["misses"] > before["misses"]
    assert after["compile_ns"] >= before["compile_ns"]
    assert all(isinstance(k, tuple) and len(k) == 3
               for k in CC.cache_keys())


def test_ansi_changes_conf_fingerprint():
    t = pa.table({"a": [1, 2, 3], "b": [4, 5, 6]})

    def run(conf):
        s = _sess(TA, conf)
        df = s.create_dataframe(t).select(
            (TA.col("a") + TA.col("b")).alias("c"))
        df.collect()
        return df

    df = run({})
    warm = CC.stats()
    df.collect()
    assert CC.stats()["misses"] == warm["misses"]
    run({"spark.sql.ansi.enabled": "true"})
    assert CC.stats()["misses"] > warm["misses"], \
        "an ANSI flip must not share stage functions"


def test_compile_cache_gauges_in_registry():
    from spark_rapids_tpu_torch.runtime import obs
    s = _sess(TA)
    _probe_df(TA, s).collect()
    text = obs.state().registry.render_prometheus()
    for name in ("rapids_compile_cache_hits", "rapids_compile_cache_misses",
                 "rapids_compile_cache_entries"):
        assert name in text


def _parity_table(rows):
    rng = np.random.default_rng(rows + 1)
    return pa.table({
        "k": rng.integers(0, 7, rows).astype(np.int64),
        "v": rng.integers(-1000, 1000, rows).astype(np.int64),
        "d": rng.random(rows),
    })


def _parity_query(api, df):
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("v") > lit(0))
            .select(col("k"), (col("v") * lit(3)).alias("w"), col("d"))
            .group_by(col("k")).agg(F.sum(col("w")).alias("sw"),
                                    F.count(col("d")).alias("c")))


@pytest.mark.parametrize("rows", [8, 9, 64, 1000])
@pytest.mark.parametrize("ansi", [False, True])
def test_fused_unfused_parity_at_bucket_boundaries(rows, ansi):
    base = {"spark.rapids.tpu.batchCapacityMinRows": "8",
            "spark.sql.ansi.enabled": ansi}
    t = _parity_table(rows)
    fused, unfused, want = _three_ways(
        lambda api, s: _parity_query(api, s.create_dataframe(t)), base,
        keys=["k"])
    assert fused == unfused == want


def test_fused_unfused_parity_empty_result():
    t = _parity_table(64)
    fused, unfused, want = _three_ways(
        lambda api, s: _parity_query(api, s.create_dataframe(t)).filter(
            api.col("sw") < api.lit(-1)),
        {"spark.rapids.tpu.batchCapacityMinRows": "8"})
    assert fused == unfused == want == []


# ---------------------------------------------------------------------------
# Dispatch budgets: every NDS probe plan and the five bench shapes
# ---------------------------------------------------------------------------

def _nds_module(port: bool):
    """tools/nds_probe.py loaded as a module; for the port, with its
    imports retargeted at spark_rapids_tpu_torch (its query builders read
    T, F, E, col, lit and Window from their module)."""
    path = os.path.join(REPO, "tools", "nds_probe.py")
    name = "nds_probe_port" if port else "nds_probe_jax"
    if not port:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    src = open(path).read()
    src = src.replace("from spark_rapids_tpu.sql.session import TpuSession",
                      "from spark_rapids_tpu_torch import TorchSession "
                      "as TpuSession")
    src = re.sub(r"\bspark_rapids_tpu\b", "spark_rapids_tpu_torch", src)
    mod = type(importlib)(name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


_BUDGET_KEYS = ("narrow_dispatches_per_batch", "fused_stages",
                "absorbed_stages", "fusion_groups", "pipeline_boundaries")

#: census differences between the port's plans and the JAX package's
#: (ROADMAP's stated port differences): none at the probe's size
_CENSUS_DIFFERENCES = {}


def _budgets(port_root, jax_root):
    a, b = PV.dispatch_budget(port_root), JPV.dispatch_budget(jax_root)
    return {k: a[k] for k in _BUDGET_KEYS}, {k: b[k] for k in _BUDGET_KEYS}, \
        a["exec_census"], b["exec_census"]


def test_nds_probe_dispatch_budgets_match_jax():
    pn, jn = _nds_module(True), _nds_module(False)
    ps, js = _sess(TA), _sess(JA)
    tables = jn.gen_tables(0.002, seed=7)
    pd = {n: ps.create_dataframe(t).cache() for n, t in tables.items()}
    jd = {n: js.create_dataframe(t).cache() for n, t in tables.items()}
    problems, compared = [], 0
    for qn in sorted(jn.QUERIES):
        proot = ps.prepare_execution(pn.QUERIES[qn](ps, pd).plan)[0]
        jroot = js.prepare_execution(jn.QUERIES[qn](js, jd).plan)[0]
        got, want, pc, jc = _budgets(proot, jroot)
        problems += [f"q{qn}: {d}" for d in PV.compare_budget(got, want)]
        problems += [f"q{qn}: {v}" for v in PV.check_plan(proot)]
        if pc != jc and _CENSUS_DIFFERENCES.get(qn) != (pc, jc):
            problems.append(f"q{qn}: census {pc} != {jc}")
        compared += 1
    assert compared == len(jn.QUERIES) >= 90
    assert not problems, "\n".join(problems)


def test_nds_probe_fusion_off_plans_no_stages():
    pn = _nds_module(True)
    ps = _sess(TA, OFF)
    tables = pn.gen_tables(0.002, seed=7)
    pd = {n: ps.create_dataframe(t).cache() for n, t in tables.items()}
    for qn in (5, 13, 31, 39):
        root = ps.prepare_execution(pn.QUERIES[qn](ps, pd).plan)[0]
        budget = PV.dispatch_budget(root)
        assert budget["fusion_groups"] == [] and \
            budget["fused_stages"] == budget["absorbed_stages"] == 0


def _bench_shapes(api, s, li, od):
    return {"q6": H.q6(api, li), "q1": H.q1(api, li),
            "q3join": H.q3join(api, li, od), "q67win": H.q67win(api, li),
            "q72shfl": H.q72shfl(api, li)}


def test_bench_shapes_dispatch_budgets_match_jax():
    li, od = H.make_tables(4000)
    roots = {}
    for api in (TA, JA):
        s = _sess(api)
        lic = s.create_dataframe(li).cache()
        odc = s.create_dataframe(od).cache()
        roots[api is TA] = {n: s.prepare_execution(df.plan)[0]
                            for n, df in _bench_shapes(api, s, lic,
                                                       odc).items()}
    for name in roots[True]:
        got, want, pc, jc = _budgets(roots[True][name], roots[False][name])
        assert got == want, (name, PV.compare_budget(got, want))
        assert pc == jc, (name, pc, jc)


# ---------------------------------------------------------------------------
# The fusion groups chip_smoke.py's fusion phase checks
# ---------------------------------------------------------------------------

def test_smoke_fusion_groups_match_jax(tmp_path):
    """torch_port_helpers.FUSION_EXPECT holds the fusion groups of the
    smoke's fusion-phase queries as the JAX package plans them; the port
    must plan the same, at the small size here and on the card."""
    import pyarrow.parquet as pq
    li = H.make_lineitem(20_000)
    path = str(tmp_path / "li.parquet")
    pq.write_table(li, path, row_group_size=4096)
    got, want = {}, {}
    for api, out in ((TA, got), (JA, want)):
        s = _sess(api)
        cached = s.create_dataframe(li).cache()
        for name, build in H.fusion_queries(api).items():
            df = build(s, cached, path)
            root = s.prepare_execution(df.plan)[0]
            mod = PV if api is TA else JPV
            out[name] = mod.dispatch_budget(root)["fusion_groups"]
    assert got == want
    assert {n: [g for g in v] for n, v in want.items()} == H.FUSION_EXPECT


# ---------------------------------------------------------------------------
# Windows and the masked dense probe through the dispatch choke point
# ---------------------------------------------------------------------------

#: the JAX package's key families of the window operator's and the masked
#: dense join probe's per-batch dispatches (exec/tpu_nodes.py)
_WINDOW_JOIN_FAMILIES = ("window_sortlay", "window_fns", "window_packed",
                         "window", "dense_probe_masked")


def _families(keys):
    from collections import Counter
    return Counter(k[0] for k in keys
                   if isinstance(k, tuple) and k
                   and k[0] in _WINDOW_JOIN_FAMILIES)


def _running_by_flags(api, df):
    """A frame aggregate over integer order keys: the packed route's two
    dispatches (window_sortlay, then window_fns)."""
    col, F = api.col, api.F
    w = api.Window.partition_by(col("l_returnflag"), col("l_linestatus")) \
        .order_by(col("l_shipdate"))
    return (df.select(col("l_returnflag"), col("l_linestatus"),
                      F.sum(col("l_quantity")).over(w).alias("rs"))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(F.max("rs").alias("mx")))


def _shape_dfs(api, s, li, od, parts):
    lic = s.create_dataframe(li, num_partitions=parts)
    odc = s.create_dataframe(od)
    return {"q67win": H.q67win(api, lic),
            "running_by_flags": _running_by_flags(api, lic),
            "win_running": H.win_running(api, lic),
            "q3join": H.q3join(api, lic, odc)}


@pytest.mark.parametrize("parts", [1, 3])
def test_window_and_join_dispatches_match_jax(parts):
    """Each window route's and the masked probe's dispatches pass fuse.fused
    under the JAX package's key families, as many as the JAX package's."""
    li, od = H.make_tables(2000)
    got = {}
    for api, mod in ((TA, PF), (JA, JF)):
        s = _sess(api)
        out = got.setdefault(api is TA, {})
        for name, df in _shape_dfs(api, s, li, od, parts).items():
            with _Dispatches(mod) as dc:
                df.collect()
            out[name] = _families(dc.keys)
    assert got[True] == got[False]
    seen = set().union(*[set(c) for c in got[True].values()])
    assert {"window_sortlay", "window_fns", "window_packed",
            "dense_probe_masked"} <= seen, got[True]


@pytest.mark.parametrize("qn", [12])
def test_nds_window_join_dispatches_match_jax(qn):
    """NDS probe plans with a window and joins: the same window and
    masked-probe dispatches, and the same static budget, in both
    packages."""
    pn, jn = _nds_module(True), _nds_module(False)
    tables = jn.gen_tables(0.002, seed=7)
    got = {}
    for api, mod, nds in ((TA, PF, pn), (JA, JF, jn)):
        s = _sess(api)
        d = {n: s.create_dataframe(t).cache() for n, t in tables.items()}
        df = nds.QUERIES[qn](s, d)
        with _Dispatches(mod) as dc:
            df.collect()
        got[api is TA] = (_families(dc.keys),
                          s.prepare_execution(df.plan)[0])
    (pc, proot), (jc, jroot) = got[True], got[False]
    assert pc == jc and pc["dense_probe_masked"] > 0 and \
        set(pc) & {"window", "window_packed", "window_sortlay"}, pc
    a, b, _, _ = _budgets(proot, jroot)
    assert a == b, PV.compare_budget(a, b)
