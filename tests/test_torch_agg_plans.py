"""The partial -> collect -> final aggregate of the port against the JAX
package: the single-device plan rule, every aggregate with a partial
state over 1 and 4 partitions of 1-3 batches, the skip-merge ratio, a
global aggregate over empty partitions, an absorbed filter, the merge of a
coalesced batch, the placement report and a CPU-tagged aggregate, and the
fixed-point merge case of ROADMAP C ("known").

The JAX package sees the tests' eight virtual devices and plans its
multi-device branch (partial -> hash exchange -> final); the plan tests
give it one device, which takes its single-device rule, the rule the port
ports.

Tolerances: keys, counts, integer sums, min, max, first and last are
exact; float sums and averages within a relative 1e-12 (the partial
states add in another order than one complete pass); variance and
standard deviation within a relative 1e-9, since ``sumsq - sum^2 / n``
magnifies the low bits of those sums.
"""
import math

import jax
import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import nodes as JP
from spark_rapids_tpu.plan import overrides as JO

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.plan import nodes as TP
from spark_rapids_tpu_torch.plan import overrides as O

N = 4000
AGGS = ("sum", "count", "count_all", "avg", "min", "max", "first", "last",
        "var_samp", "var_pop", "stddev_samp", "stddev_pop")
#: relative tolerance per aggregate (absent: exact)
TOL = {"sum_v": 1e-12, "avg_v": 1e-12, "avg_i": 1e-12,
       "var_samp_v": 1e-9, "var_pop_v": 1e-9, "stddev_samp_v": 1e-9,
       "stddev_pop_v": 1e-9, "var_samp_i": 1e-9, "var_pop_i": 1e-9,
       "stddev_samp_i": 1e-9, "stddev_pop_i": 1e-9}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(31)
    return pa.table({
        "k": rng.integers(0, 60, N).astype(np.int32),
        "s": np.array([f"g{j}" for j in range(12)])[rng.integers(0, 12, N)],
        "v": pa.array(rng.normal(50, 20, N), mask=rng.random(N) < 0.1),
        "i": pa.array(rng.integers(-1000, 1000, N).astype(np.int64),
                      mask=rng.random(N) < 0.1),
    })


@pytest.fixture
def one_device(monkeypatch):
    """The JAX package's single-device planning (its tests see eight)."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])


def _aggs(api):
    F, col = api.F, api.col
    out = []
    for name in AGGS:
        if name == "count_all":
            out.append(F.count().alias("count_all"))
            continue
        fn = {"avg": F.avg, "var_samp": F.var_samp, "var_pop": F.var_pop,
              "stddev_samp": F.stddev_samp,
              "stddev_pop": F.stddev_pop}.get(name) or getattr(F, name)
        out += [fn(col("v")).alias(f"{name}_v"), fn(col("i")).alias(f"{name}_i")]
    return out


def _rows(t: pa.Table, keys):
    d = t.to_pydict()
    return {tuple(d[k][i] for k in keys):
            {c: d[c][i] for c in t.column_names if c not in keys}
            for i in range(t.num_rows)}


def _close(g, w, tol) -> bool:
    if g is None or w is None:
        return g is None and w is None
    if isinstance(g, float) and math.isnan(g):
        return isinstance(w, float) and math.isnan(w)
    if tol is None:
        return g == w
    return abs(g - w) <= tol * max(abs(g), abs(w)) or abs(g - w) < 1e-300


def _assert_same(got, want, keys):
    g, w = _rows(got, keys), _rows(want, keys)
    assert set(g) == set(w)
    for k in w:
        for c, wv in w[k].items():
            assert _close(g[k][c], wv, TOL.get(c)), (k, c, g[k][c], wv)


def _aggregate_modes(session):
    return [e.mode for e in session.last_exec.walk()
            if isinstance(e, X.HashAggregateExec)]


def _jax_shape(session):
    """The JAX package's operators above its scan, as the port names
    them (its fused pipelines and scan have no counterpart)."""
    names = []
    for line in session._last_exec.tree_string().splitlines():
        name = line.strip().split(" ")[0]
        if name.endswith("Exec") and "Pipeline" not in name \
                and "Scan" not in name:
            names.append(name)
    return names


def _port_shape(session):
    """The port's operators above its scan, its pipeline boundaries left
    out as the JAX package's are."""
    return [type(e).__name__ for e in session.last_exec.walk()
            if "Scan" not in type(e).__name__
            and type(e).__name__ != "PipelineExec"]


# ---------------------------------------------------------------------------
# the plan rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit,want", [
    (N, ["complete"]), (N - 1, ["final", "partial"]),
    (0, ["final", "partial"])])
def test_plan_rule_follows_the_estimate(table, monkeypatch, limit, want):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", limit)
    P = torch_api()
    s = P.session()
    df = s.create_dataframe(table, num_partitions=4)
    df.group_by("k").agg(P.F.sum(P.col("v"))).collect()
    assert _aggregate_modes(s) == want
    shape = _port_shape(s)
    if want == ["complete"]:
        assert shape == ["HashAggregateExec", "CoalesceBatchesExec",
                         "CollectExchangeExec"]
    else:
        assert shape == ["HashAggregateExec", "CollectExchangeExec",
                         "HashAggregateExec"]
    assert s.last_exec.tree_string().splitlines()[0].startswith(
        f"HashAggregateExec({want[0]}) <- Aggregate[keys=[k]")


def test_unknown_estimate_plans_partial_and_final(table):
    # a grouped aggregate's cardinality is unknown to both packages
    P = torch_api()
    s = P.session()
    inner = s.create_dataframe(table, num_partitions=4).group_by("k").agg(
        P.F.sum(P.col("v")).alias("x")).repartition(3)
    inner.group_by("k").agg(P.F.sum(P.col("x"))).collect()
    assert _aggregate_modes(s) == ["final", "partial", "complete"]


@pytest.mark.parametrize("case", ["small", "large", "unknown", "one_part"])
def test_plan_matches_the_jax_single_device_rule(table, one_device,
                                                 monkeypatch, case):
    # "large": both packages' in-memory estimate is lifted past 64M rows
    if case == "large":
        for mod in (JP, TP):
            orig = mod.PlanNode.estimated_rows

            def lifted(self, _orig=orig, _mod=mod):
                est = _orig(self)
                return 100_000_000 if isinstance(
                    self, _mod.InMemorySource) else est
            monkeypatch.setattr(mod.PlanNode, "estimated_rows", lifted)
    results, shapes = [], []
    for api in (torch_api(), jax_api()):
        s = api.session()
        df = s.create_dataframe(table, num_partitions=1 if case == "one_part"
                                else 4)
        if case == "unknown":
            df = df.group_by("k", "s").agg(
                api.F.sum(api.col("v")).alias("v")).repartition(3)
        results.append(df.group_by("k").agg(
            api.F.sum(api.col("v")).alias("sum_v"),
            api.F.count().alias("n")).collect())
        shapes.append(_port_shape(s) if api.F.__name__.startswith(
            "spark_rapids_tpu_torch") else _jax_shape(s))
    port, jax_shape = shapes
    assert port == jax_shape
    _assert_same(*results, ["k"])


# ---------------------------------------------------------------------------
# every aggregate with a partial state, through partial -> collect -> final
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s"], []])
@pytest.mark.parametrize("parts,batches", [(1, 1), (4, 1), (4, 3), (1, 3)])
def test_partial_states_merge_like_jax(table, monkeypatch, keys, parts,
                                      batches):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    conf = {"spark.rapids.sql.reader.batchSizeRows":
            -(-N // (parts * batches))}
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        df = s.create_dataframe(table, num_partitions=parts)
        g = df.group_by(*keys) if keys else df
        out.append(g.agg(*_aggs(api)).collect())
        if api.F.__name__.startswith("spark_rapids_tpu_torch"):
            assert _aggregate_modes(s) == (["final", "partial"] if parts > 1
                                           else ["complete"])
    _assert_same(*out, keys)


def test_integer_and_float_sums_are_exact_and_close(table, monkeypatch):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    P = torch_api()
    got = P.session().create_dataframe(table, num_partitions=4).group_by(
        "k").agg(P.F.sum(P.col("i")).alias("si"),
                 P.F.sum(P.col("v")).alias("sv")).collect()
    k = table["k"].to_numpy()
    i = table["i"].to_numpy(zero_copy_only=False)
    v = table["v"].to_numpy(zero_copy_only=False)
    for row in got.to_pylist():
        m = k == row["k"]
        assert row["si"] == int(np.nansum(i[m]))
        assert _close(row["sv"], float(np.nansum(v[m])), 1e-12)


# ---------------------------------------------------------------------------
# skip-merge ratio, empty partitions, the absorbed filter, coalesced merge
# ---------------------------------------------------------------------------

def _partial_of(session):
    [p] = [e for e in session.last_exec.walk()
           if isinstance(e, X.HashAggregateExec) and e.mode == "partial"]
    return p


@pytest.mark.parametrize("ratio,unmerged", [(1.0, False), (0.5, True)])
def test_skip_merge_ratio(monkeypatch, ratio, unmerged):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    rng = np.random.default_rng(2)
    # nearly every row its own group: the first batch barely reduces
    t = pa.table({"k": rng.permutation(3000).astype(np.int64) % 2900,
                  "v": rng.normal(size=3000)})
    conf = {"spark.rapids.sql.reader.batchSizeRows": 250,
            "spark.rapids.sql.agg.skipAggPassReductionRatio": ratio}
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        df = s.create_dataframe(t, num_partitions=2)
        out.append(df.group_by("k").agg(api.F.sum(api.col("v")).alias("sum_v"),
                                        api.F.count().alias("n")).collect())
        if api.F.__name__.startswith("spark_rapids_tpu_torch"):
            n_out = len(list(_partial_of(s).execute_partition(0)))
            assert n_out == (6 if unmerged else 1)
    _assert_same(*out, ["k"])


def test_force_single_pass_updates_once_a_partition(table, monkeypatch):
    # the testing knob concatenates a partition's batches: one update each
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    calls = []
    orig = X._AggKernels.update

    def spy(kern, batch, ctx_of):
        calls.append(int(batch.num_rows))
        return orig(kern, batch, ctx_of)
    monkeypatch.setattr(X._AggKernels, "update", spy)
    conf = {"spark.rapids.sql.reader.batchSizeRows": 250,
            "spark.rapids.sql.agg.forceSinglePassPartialSort": "true"}
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table, num_partitions=4)
        out.append(df.group_by("k").agg(*_aggs(api)).collect())
    assert calls == [N // 4] * 4
    _assert_same(*out, ["k"])


@pytest.mark.parametrize("parts", [1, 4])
def test_global_aggregate_over_empty_partitions(table, monkeypatch, parts):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(table, num_partitions=parts)
        empty = df.filter(api.col("k") > api.lit(1000))
        out.append(empty.agg(*_aggs(api)).collect())
    got, want = out
    assert got.num_rows == 1
    assert got.to_pylist() == want.to_pylist()
    assert got["count_v"].to_pylist() == [0]
    assert got["sum_v"].to_pylist() == [None]


def test_absorbed_filter_narrows_the_partial(table, monkeypatch):
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        df = s.create_dataframe(table, num_partitions=4)
        out.append(df.filter(api.col("i") > api.lit(0)).group_by("s").agg(
            *_aggs(api)).collect())
        if api.F.__name__.startswith("spark_rapids_tpu_torch"):
            assert _partial_of(s).kern.pre_filter is not None
            assert "FilterExec" not in _port_shape(s)
    _assert_same(*out, ["s"])


@pytest.mark.parametrize("flag", [True, False])
def test_a_coalesced_batch_still_merges(table, monkeypatch, flag):
    # a final over a coalesce of the partials sees ONE batch with each key
    # once per partition: the coalesced flag makes it merge
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    if not flag:
        monkeypatch.setattr(X, "_coalesced",
                            lambda bs: X.K.concat_batches(bs))
    P = torch_api()
    s = P.session()
    df = s.create_dataframe(table, num_partitions=4).group_by("k").agg(
        P.F.count().alias("n"))
    df.collect()
    final = s.last_exec
    collect = final.children[0]
    final.children = [X.CoalesceBatchesExec(final.plan, [collect], final.conf,
                                            final.device)]
    [batch] = list(final.execute_partition(0))
    n = int(batch.num_rows)
    if flag:
        assert n == 60
    else:
        assert n > 60  # each key once per partition: left unmerged


# ---------------------------------------------------------------------------
# ROADMAP C, "known": the fixed-point merge of partial float sums
# ---------------------------------------------------------------------------

def test_merge_of_partial_sums_with_an_outlier_is_exact(monkeypatch):
    """5000 values in +-1000, one of them 1e16, string keys, 4 partitions.
    The JAX package's partial -> exchange -> final merges the partial
    sums on the packed scatter route, whose f64 sum is fixed point scaled
    to the batch's largest |value|: every group's sum comes out a multiple
    of 2^6, up to ~53 off (its update, on the tiny-bucket route, adds
    plain floats, as a complete pass does). The port's merge takes the
    update's route order, so its partial -> collect -> final is held to
    pyarrow's sums; the wrong JAX answers are asserted, not copied.

    The JAX package merges partial states between the batches of ONE
    partition too, and there it can lose a whole sum: two batches of 2
    rows, group b holding 1.5 and 2.25, then 3.0 beside a = 1e20. The
    port answers 6.75, the JAX package 0.0."""
    small = pa.table({"k": ["b", "b", "b", "a"],
                      "v": [1.5, 2.25, 3.0, 1e20]})
    two_rows = {"spark.rapids.sql.reader.batchSizeRows": 2}
    got = {}
    for name, api in (("port", torch_api()), ("jax", jax_api())):
        s = api.session(two_rows)
        r = s.create_dataframe(small).group_by("k").agg(
            api.F.sum(api.col("v")).alias("x")).collect()
        got[name] = dict(zip(r["k"].to_pylist(), r["x"].to_pylist()))
        if name == "port":
            assert dict(s.last_metrics())["InMemoryScanExec#2"][
                "numOutputBatches"] == 2
    assert got == {"port": {"b": 6.75, "a": 1e20},
                   "jax": {"b": 0.0, "a": 1e20}}
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)
    rng = np.random.default_rng(5)
    v = rng.uniform(-1000, 1000, 5000)
    v[17] = 1e16
    keys = np.array([f"k{j}" for j in range(40)])[rng.integers(0, 40, 5000)]
    t = pa.table({"s": keys, "v": v})
    ref = t.group_by("s").aggregate([("v", "sum")])
    want = dict(zip(ref["s"].to_pylist(), ref["v_sum"].to_pylist()))
    got = {}
    for name, api in (("port", torch_api()), ("jax", jax_api())):
        s = api.session()
        r = s.create_dataframe(t, num_partitions=4).group_by("s").agg(
            api.F.sum(api.col("v")).alias("x")).collect()
        got[name] = dict(zip(r["s"].to_pylist(), r["x"].to_pylist()))
        if name == "port":
            assert _aggregate_modes(s) == ["final", "partial"]
    for k, w in want.items():
        assert _close(got["port"][k], w, 1e-12), (k, got["port"][k], w)
    jax_err = max(abs(got["jax"][k] - w) for k, w in want.items()
                  if abs(w) < 1e6)
    assert jax_err > 1.0


# ---------------------------------------------------------------------------
# tagging: the placement report, and a CPU-tagged aggregate
# ---------------------------------------------------------------------------

def _report(api, overrides, table, agg, conf=None):
    s = api.session(conf)
    df = s.create_dataframe(table, num_partitions=4).group_by("k").agg(
        agg(api).alias("r"))
    report = overrides.wrap_and_tag(df.plan, s.conf).explain(all_ops=True)
    return s, df, report.replace("TPU", "GPU")


@pytest.mark.parametrize("agg", ["sum", "min_string"])
def test_placement_report_of_partial_and_final(table, monkeypatch, agg):
    # both halves of the aggregate are one Aggregate node of the report,
    # on the card or, tagged, on the CPU as one node
    monkeypatch.setattr(O, "COLLECT_COMPLETE_MAX_ROWS", 0)

    def fn(api):
        return api.F.sum(api.col("v")) if agg == "sum" \
            else api.F.min(api.col("s"))
    s, df, port = _report(torch_api(), O, table, fn)
    _, jdf, jax = _report(jax_api(), JO, table, fn)
    assert port == jax
    got, want = df.collect(), jdf.collect()
    _assert_same(got, want, ["k"])
    execs = [type(e).__name__ for e in s.last_exec.walk()]
    if agg == "sum":
        assert _aggregate_modes(s) == ["final", "partial"]
        assert port.count("Aggregate[") == 1 and "!" not in port
    else:
        assert execs[0] == "CpuFallbackExec"
        assert "HashAggregateExec" not in execs
        assert [ln.strip()[0] for ln in port.splitlines()
                if "Aggregate[" in ln] == ["!"]

