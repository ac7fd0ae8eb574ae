"""The port's adaptive execution against the JAX package, on the CPU.

Both packages run at their defaults, so the JAX package runs adaptive too
(its single-device planning: the tests' eight virtual devices would give
its aggregates a hash exchange the port does not plan). The shapes are
those of tests/test_adaptive.py without the measured cost, the counters
and the serialized shuffle: the shuffled-hash -> broadcast conversion,
the row probe of a build side of unknown size, the skew split, tiny
coalescing, cross-query build reuse, the masked partitioning mode and the
decision list around a scalar subquery. Each case holds three things to
the JAX package: the Arrow result (exact; f64 sums to a relative 1e-12),
the chosen join operators, and each decision's kind and host-int fields.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import aqe_decisions, chosen_execs, jax_api, torch_api

import jax
from spark_rapids_tpu.exec import adaptive as JAQ
from spark_rapids_tpu.runtime import metrics as JM

from spark_rapids_tpu_torch.exec import adaptive as AQ
from spark_rapids_tpu_torch.exec import nodes as X

AQE_ON = {"spark.rapids.sql.join.broadcastRowThreshold": 1}
AQE_OFF = {"spark.rapids.sql.join.broadcastRowThreshold": 1,
           "spark.rapids.sql.adaptive.enabled": "false"}
#: conversion off (threshold 0): only the skew split is live
SKEW_CONF = {"spark.rapids.sql.join.broadcastRowThreshold": 1,
             "spark.rapids.sql.adaptive.broadcastThresholdBytes": 0,
             "spark.rapids.sql.adaptive.skewFactor": 1.5}
#: the operators a join plan chooses
JOIN_OPS = {"AdaptiveShuffledHashJoinExec", "AdaptiveJoinExec",
            "BroadcastHashJoinExec", "ShuffledHashJoinExec",
            "ShuffleExchangeExec", "CollectExchangeExec", "_MaterializedExec",
            "RoundRobinExchangeExec", "RangeExchangeExec"}
JAX, TORCH = jax_api(), torch_api()


@pytest.fixture(autouse=True)
def _fresh_adaptive_state(monkeypatch):
    """Both packages' process-global adaptive state (decision list, build
    cache, table epoch) starts empty, and the JAX package plans for one
    device, as the port does."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    AQ.reset_for_tests()
    JAQ.reset_for_tests()
    yield
    AQ.reset_for_tests()
    JAQ.reset_for_tests()


def _sides(n=60, seed=5, skew=None):
    rng = np.random.default_rng(seed)
    if skew is None:
        lk = [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, 12, n)]
    else:
        lk = [0 if rng.random() < skew else int(x)
              for x in rng.integers(0, 12, n)]
    left = pa.table({
        "k": pa.array(lk, pa.int64()),
        "lv": pa.array(rng.integers(0, 100, n).astype(np.int64)),
    })
    right = pa.table({
        "k": pa.array([None if rng.random() < 0.1 else int(x)
                       for x in rng.integers(0, 15, n // 2)], pa.int64()),
        "rv": pa.array(rng.uniform(0, 1, n // 2)),
    })
    return left, right


def _join(s, left_t, right_t, how="inner", parts=(3, 2)):
    return s.create_dataframe(left_t, num_partitions=parts[0]).join(
        s.create_dataframe(right_t, num_partitions=parts[1]),
        on="k", how=how)


def _ops(execs):
    return {type(e).__name__ for e in execs} & JOIN_OPS


def _run_both(fn, conf=None):
    """(port session, port table, JAX session, JAX table) of fn(api, s)."""
    ps = TORCH.session(dict(conf or {}))
    js = JAX.session(dict(conf or {}))
    pt = fn(TORCH, ps).collect()
    jt = fn(JAX, js).collect()
    return ps, pt, js, jt


def _same_as_jax(ps, pt, js, jt, ignore_order=False):
    """Result, chosen operators and decisions equal the JAX package's."""
    assert_tables_equal(pt, jt, ignore_order=ignore_order,
                        approx_float=1e-12)
    assert _ops(ps.last_exec.walk()) == _ops(chosen_execs(js._last_exec))
    assert aqe_decisions(ps.last_aqe()) == aqe_decisions(js.last_aqe())


def _chosen(session, cls):
    return [e for e in session.last_exec.walk()
            if type(e).__name__ == cls]


# ---------------------------------------------------------------------------
# shuffle-hash -> broadcast conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_broadcast_conversion_matches_jax_and_the_shuffled_plan(how):
    left_t, right_t = _sides()
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t, how), AQE_ON)
    _same_as_jax(ps, pt, js, jt)
    assert [d["kind"] for d in ps.last_aqe()["decisions"]] == [
        "broadcast_conversion"]
    off = TORCH.session(AQE_OFF)
    assert_tables_equal(pt, _join(off, left_t, right_t, how).collect(),
                        ignore_order=True)
    assert off.last_aqe() is None


@pytest.mark.parametrize("scenario", ["ansi", "masked", "empty", "skewed"])
def test_broadcast_conversion_parity_scenarios(scenario):
    conf = dict(AQE_ON)
    skew = None
    if scenario == "ansi":
        conf["spark.sql.ansi.enabled"] = "true"
    elif scenario == "masked":
        conf["spark.rapids.shuffle.partitioning"] = "masked"
    elif scenario == "skewed":
        skew = 0.7
    left_t, right_t = _sides(80, seed=11, skew=skew)
    if scenario == "empty":
        right_t = right_t.slice(0, 0)
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t), conf)
    _same_as_jax(ps, pt, js, jt)
    # the masked build side cannot be measured without a sync: it stays
    # shuffled in both packages
    want = "ShuffledHashJoinExec" if scenario == "masked" \
        else "BroadcastHashJoinExec"
    assert _chosen(ps, want)


def test_conversion_chooses_broadcast_and_saves_dispatches():
    left_t, right_t = _sides()
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t), AQE_ON)
    _same_as_jax(ps, pt, js, jt)
    (node,) = _chosen(ps, "AdaptiveShuffledHashJoinExec")
    assert type(node._chosen).__name__ == "BroadcastHashJoinExec"
    (d,) = ps.last_aqe()["decisions"]
    (jd,) = js.last_aqe()["decisions"]
    print("build bytes: port", d["build_bytes"], "JAX", jd["build_bytes"])
    assert d["build_bytes"] <= d["threshold_bytes"] == 64 << 20
    # 2 input batches x (one counting sort + one offsets fetch)
    assert d["dispatches_saved"] == 4 == ps.last_aqe()["dispatches_saved"]
    assert "broadcast_conversion" in "\n".join(ps.explain_aqe())


def test_over_threshold_stays_shuffled_and_builds_once(monkeypatch):
    left_t, right_t = _sides()
    conf = dict(AQE_ON)
    conf["spark.rapids.sql.adaptive.broadcastThresholdBytes"] = 8
    calls = []
    orig = X.InMemoryScanExec.execute_partition

    def spy(self, pidx):
        calls.append((self.plan.table.num_rows, pidx))
        return orig(self, pidx)

    monkeypatch.setattr(X.InMemoryScanExec, "execute_partition", spy)
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t), conf)
    _same_as_jax(ps, pt, js, jt)
    (node,) = _chosen(ps, "AdaptiveShuffledHashJoinExec")
    assert type(node._chosen).__name__ == "ShuffledHashJoinExec"
    assert ps.last_aqe() is None
    # the build side (30 rows, 2 partitions) ran once, through its exchange
    assert sorted(c for c in calls if c[0] == 30) == [(30, 0), (30, 1)]
    off = TORCH.session(AQE_OFF)
    assert_tables_equal(pt, _join(off, left_t, right_t).collect(),
                        ignore_order=True)


@pytest.mark.parametrize("how", ["right", "full"])
def test_right_and_full_never_convert(how):
    left_t, right_t = _sides()
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t, how), AQE_ON)
    _same_as_jax(ps, pt, js, jt, ignore_order=True)
    assert ps.last_aqe() is None
    assert _chosen(ps, "ShuffledHashJoinExec")


def test_conversion_decisions_deterministic():
    left_t, right_t = _sides()
    docs = []
    for _ in range(2):
        s = TORCH.session(AQE_ON)
        _join(s, left_t, right_t).collect()
        docs.append(s.last_aqe())
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# the row probe (a build side of unknown size)
# ---------------------------------------------------------------------------

def _probe_query(rows, how):
    def q(api, s):
        F, col = api.F, api.col
        left = s.create_dataframe(
            {"k": [i % 40 for i in range(300)], "v": list(range(300))},
            num_partitions=3)
        right = s.create_dataframe({"k": [i % rows for i in range(2 * rows)],
                                    "w": list(range(2 * rows))})
        build = right.group_by(col("k")).agg(F.sum("w").alias("sw"))
        return left.join(build, on="k", how=how)
    return q


@pytest.mark.parametrize("threshold,rows,how,chosen", [
    (None, 4, "inner", "BroadcastHashJoinExec"),
    (None, 40, "left_anti", "BroadcastHashJoinExec"),
    (8, 40, "left", "ShuffledHashJoinExec"),
    (8, 40, "inner", "ShuffledHashJoinExec"),
])
def test_row_probe_under_and_over_threshold(threshold, rows, how, chosen):
    conf = {} if threshold is None else {
        "spark.rapids.sql.join.broadcastRowThreshold": threshold}
    ps, pt, js, jt = _run_both(_probe_query(rows, how), conf)
    _same_as_jax(ps, pt, js, jt, ignore_order=True)
    (node,) = _chosen(ps, "AdaptiveJoinExec")
    assert type(node._chosen).__name__ == chosen
    if chosen == "BroadcastHashJoinExec":
        (d,) = ps.last_aqe()["decisions"]
        assert d["source"] == "row_probe" and d["build_rows"] == rows


# ---------------------------------------------------------------------------
# skew split and tiny coalescing
# ---------------------------------------------------------------------------

def test_skew_split_rejoins_in_order():
    left_t, right_t = _sides(600, seed=3, skew=0.8)
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t, parts=(3, 3)), SKEW_CONF)
    _same_as_jax(ps, pt, js, jt)
    splits = [d for d in ps.last_aqe()["decisions"]
              if d["kind"] == "skew_split"]
    assert splits and all(d["splits"] >= 2 and d["rows"] >
                          d["threshold_rows"] for d in splits)
    off = TORCH.session(AQE_OFF)
    # no reordering: the slices rejoin in the unsplit partition's order
    assert_tables_equal(pt, _join(off, left_t, right_t,
                                  parts=(3, 3)).collect())


def test_skew_factor_zero_disables_split():
    left_t, right_t = _sides(600, seed=3, skew=0.8)
    conf = dict(SKEW_CONF)
    conf["spark.rapids.sql.adaptive.skewFactor"] = 0
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t, parts=(3, 3)), conf)
    _same_as_jax(ps, pt, js, jt)
    assert ps.last_aqe() is None


def test_skew_threshold_policy():
    conf = TORCH.session(SKEW_CONF).conf
    jconf = JAX.session(SKEW_CONF).conf
    for totals in ([10, 10, 100], [5, None, 50, 6], [3], [4, 4, 4],
                   [None, None], [0, 0, 9], [7, 8, 30, 31]):
        assert AQ.skew_threshold(conf, totals) \
            == JAQ.skew_threshold(jconf, totals)


def _repart_agg(n_out, rows=4000, hot=0.6):
    def q(api, s):
        F, col, lit = api.F, api.col, api.lit
        rng = np.random.default_rng(17)
        k = np.where(rng.random(rows) < hot, 0, rng.integers(0, 500, rows))
        df = s.create_dataframe(pa.table({
            "k": k.astype(np.int64),
            "v": rng.uniform(0, 10, rows)}), num_partitions=4)
        return df.repartition(n_out, col("k")).group_by(col("k")).agg(
            F.sum(col("v")).alias("sv"), F.count().alias("n"))
    return q


def _exchanges(execs, cls="ShuffleExchangeExec"):
    return [e for e in execs if type(e).__name__ == cls]


@pytest.mark.parametrize("tiny", [1024, 64, 0])
def test_tiny_coalescing_merges_like_jax(tiny):
    conf = {"spark.rapids.shuffle.coalesceTinyRows": tiny,
            "spark.rapids.sql.adaptive.skewFactor": 0}
    ps, pt, js, jt = _run_both(_repart_agg(16, hot=0.0), conf)
    _same_as_jax(ps, pt, js, jt, ignore_order=True)
    (pex,) = _exchanges(ps.last_exec.walk())
    (jex,) = _exchanges(chosen_execs(js._last_exec))
    merged = jex.metrics.metric(JM.SHUFFLE_COALESCED_BATCHES).value
    assert pex.coalesced_batches == merged
    if tiny == 1024:
        # 4 input batches x 16 partitions of ~60 rows: every partition's
        # four sub-batches merge into one
        assert merged == 64
    if tiny == 0:
        assert merged == 0


def test_skew_split_of_a_repartition_then_aggregate():
    ps, pt, js, jt = _run_both(_repart_agg(8), {})
    _same_as_jax(ps, pt, js, jt, ignore_order=True)
    (d,) = ps.last_aqe()["decisions"]
    assert d["kind"] == "skew_split" and d["splits"] >= 2


# ---------------------------------------------------------------------------
# broadcast-build reuse across queries
# ---------------------------------------------------------------------------

def _reuse_query(api, s, right_cached, left_t):
    return s.create_dataframe(left_t, num_partitions=3).join(
        right_cached, on="k", how="inner")


def test_build_reuse_across_queries_and_invalidation():
    left_t, right_t = _sides()
    docs = {}
    for api, pkg in ((TORCH, AQ), (JAX, JAQ)):
        s = api.session()
        right_cached = s.create_dataframe(right_t, num_partitions=2).cache()
        t1 = _reuse_query(api, s, right_cached, left_t).collect()
        first = aqe_decisions(s.last_aqe())
        t2 = _reuse_query(api, s, right_cached, left_t).collect()
        second = aqe_decisions(s.last_aqe())
        assert_tables_equal(t1, t2, ignore_order=True)
        # the same plan again: its own build, no decision
        df = _reuse_query(api, s, right_cached, left_t)
        df.collect()
        df.collect()
        third = aqe_decisions(s.last_aqe())
        epoch = pkg.table_epoch()
        s.create_or_replace_temp_view("r", s.create_dataframe(right_t))
        assert pkg.table_epoch() == epoch + 1
        docs[pkg] = (first, second, third, t2)
    assert docs[AQ][:3] == docs[JAQ][:3]
    first, second, third, t2 = docs[AQ]
    assert not first and second == [{"kind": "build_reuse",
                                      "source": "anchor"}]
    assert not third
    assert_tables_equal(t2, docs[JAQ][3], ignore_order=True)


def test_digest_hit_reuses_a_build_another_plan_made():
    """A second cached relation over the same data: a different anchor,
    so its first join misses the anchor store and finds no digest hit
    (the entry's anchor is not the live one), then a re-cache of the
    first relation drops its entries."""
    left_t, right_t = _sides()
    out = {}
    for api, pkg in ((TORCH, AQ), (JAX, JAQ)):
        s = api.session()
        r1 = s.create_dataframe(right_t, num_partitions=2).cache()
        _reuse_query(api, s, r1, left_t).collect()
        # the anchor store forgets; the digest cache still holds the build
        r1.plan._bcast_reuse = {}
        _reuse_query(api, s, r1, left_t).collect()
        hit = aqe_decisions(s.last_aqe())
        r2 = s.create_dataframe(right_t, num_partitions=2).cache()
        _reuse_query(api, s, r2, left_t).collect()
        other = aqe_decisions(s.last_aqe())
        out[pkg] = (hit, other)
    assert out[AQ] == out[JAQ]
    assert out[AQ][0] == [{"kind": "build_reuse", "source": "digest"}]
    assert not out[AQ][1]


def test_digest_cache_hit_requires_live_anchor():
    """The cache contract: a hit counts only while the anchor and its
    materialization are identity-identical; a table registration drops
    every entry."""
    from spark_rapids_tpu_torch.plan import nodes as P
    s = TORCH.session()
    conf = s.conf
    anchor = P.CachedRelation(P.InMemorySource(
        pa.table({"k": pa.array([1, 2], pa.int64())}), 1))
    anchor.materialized = ["mat"]
    entry = {"build": "b", "keys": "k", "mat": anchor.materialized,
             "build_batches": 3}
    AQ.build_cache_put(conf, anchor, ("skey",), anchor, entry)
    got = AQ.build_cache_get(conf, anchor, ("skey",), anchor)
    assert got is not None and got["build"] == "b"
    anchor.materialized = ["remat"]
    assert AQ.build_cache_get(conf, anchor, ("skey",), anchor) is None
    assert not AQ._BUILD_CACHE  # the stale entry was evicted
    anchor.materialized = ["mat2"]
    AQ.build_cache_put(conf, anchor, ("skey",), anchor,
                       dict(entry, mat=anchor.materialized))
    other = P.CachedRelation(P.InMemorySource(
        pa.table({"k": pa.array([1, 2], pa.int64())}), 1))
    other.materialized = anchor.materialized
    assert AQ.build_cache_get(conf, anchor, ("skey",), other) is None
    AQ.build_cache_put(conf, anchor, ("skey",), anchor,
                       dict(entry, mat=anchor.materialized))
    AQ.bump_table_version()
    assert AQ.build_cache_get(conf, anchor, ("skey",), anchor) is None
    for i in range(10):
        AQ.build_cache_put(conf, P.Limit(i + 1, anchor), ("skey",), anchor,
                           entry)
    assert len(AQ._BUILD_CACHE) == 8


@pytest.mark.parametrize("conf", [
    {"spark.rapids.sql.adaptive.buildReuse.enabled": "false"},
    {"spark.rapids.sql.adaptive.enabled": "false"}])
def test_build_reuse_disabled_by_conf(conf):
    left_t, right_t = _sides()
    out = {}
    for api, pkg in ((TORCH, AQ), (JAX, JAQ)):
        s = api.session(dict(conf))
        right_cached = s.create_dataframe(right_t, num_partitions=2).cache()
        _reuse_query(api, s, right_cached, left_t).collect()
        t = _reuse_query(api, s, right_cached, left_t).collect()
        assert not pkg._BUILD_CACHE
        out[pkg] = (aqe_decisions(s.last_aqe()), t)
    assert out[AQ][0] == out[JAQ][0]
    assert_tables_equal(out[AQ][1], out[JAQ][1], ignore_order=True)


# ---------------------------------------------------------------------------
# the masked partitioning mode
# ---------------------------------------------------------------------------

MASKED = {"spark.rapids.shuffle.partitioning": "masked"}


def _masked_shapes():
    rng = np.random.default_rng(23)
    n = 900
    t = pa.table({"k": pa.array(rng.integers(0, 30, n).astype(np.int32),
                                mask=rng.random(n) < 0.05),
                  "s": np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)],
                  "v": rng.normal(0, 5, n)})

    def hash_agg(api, s):
        F, col = api.F, api.col
        return s.create_dataframe(t, num_partitions=3).repartition(
            5, col("k")).group_by(col("k")).agg(F.sum(col("v")).alias("sv"),
                                                F.count().alias("n"))

    def round_robin(api, s):
        return s.create_dataframe(t, num_partitions=3).repartition(4)

    def range_sort(api, s):
        col = api.col
        return s.create_dataframe(t, num_partitions=3).sort(
            col("v").desc(), col("k"))

    def shuffled_join(api, s):
        col = api.col
        other = s.create_dataframe(t, num_partitions=2).filter(
            col("v") > api.lit(4.0)).select(col("k"), col("s").alias("s2"))
        return s.create_dataframe(t, num_partitions=3).join(
            other, on="k", how="left")

    return {"hash_agg": (hash_agg, "ShuffleExchangeExec", True),
            "round_robin": (round_robin, "RoundRobinExchangeExec", False),
            "range_sort": (range_sort, "RangeExchangeExec", False),
            "shuffled_join": (shuffled_join, "ShuffleExchangeExec", True)}


@pytest.mark.parametrize("shape", list(_masked_shapes()))
def test_masked_mode_equals_compact_and_jax(shape):
    fn, exch, any_order = _masked_shapes()[shape]
    conf = dict(MASKED, **{"spark.rapids.sql.join.broadcastRowThreshold": 1})
    ps, pt, js, jt = _run_both(fn, conf)
    _same_as_jax(ps, pt, js, jt, ignore_order=any_order)
    ex = _exchanges(ps.last_exec.walk(), exch)
    assert ex and all(e._masked for e in ex)
    assert ex[0].partition_dispatches == ex[0].partition_fetches \
        == 3 * ex[0].n_out
    compact = TORCH.session(
        {"spark.rapids.sql.join.broadcastRowThreshold": 1})
    assert_tables_equal(pt, fn(TORCH, compact).collect(),
                        ignore_order=any_order, approx_float=1e-12)


def test_unknown_partitioning_raises_like_jax():
    conf = {"spark.rapids.shuffle.partitioning": "bucketed"}
    fn = _masked_shapes()["round_robin"][0]
    with pytest.raises(ValueError, match="must be 'compact' or 'masked'"):
        fn(TORCH, TORCH.session(conf)).collect()
    with pytest.raises(ValueError, match="must be 'compact' or 'masked'"):
        fn(JAX, JAX.session(conf)).collect()


# ---------------------------------------------------------------------------
# the decision list and SQL
# ---------------------------------------------------------------------------

SQL_SCALAR_JOIN = ("SELECT l.k, l.lv, r.rv FROM l JOIN r ON l.k = r.k "
                   "WHERE l.lv > (SELECT MIN(lv) FROM l)")


def test_scalar_subquery_keeps_the_outer_decision_list():
    left_t, right_t = _sides()
    got = {}
    for api in (TORCH, JAX):
        s = api.session(AQE_ON)
        s.create_or_replace_temp_view(
            "l", s.create_dataframe(left_t, num_partitions=3))
        s.create_or_replace_temp_view(
            "r", s.create_dataframe(right_t, num_partitions=2))
        t = s.sql(SQL_SCALAR_JOIN).collect()
        got[api is TORCH] = (s, t)
    (ps, pt), (js, jt) = got[True], got[False]
    _same_as_jax(ps, pt, js, jt, ignore_order=True)
    assert [d["kind"] for d in ps.last_aqe()["decisions"]] == [
        "broadcast_conversion"]


def test_nested_collect_does_not_close_the_outer_list(monkeypatch):
    """A collect that runs while another action is running (a scalar
    subquery parsed mid-query) neither opens nor closes the decision
    list: the outer query keeps the decisions made after it."""
    left_t, right_t = _sides()
    s = TORCH.session(AQE_ON)
    s.create_or_replace_temp_view("l", s.create_dataframe(left_t))
    orig = AQ.AdaptiveShuffledHashJoinExec._choose

    def choose(self):
        s.sql("SELECT k FROM l WHERE lv >= (SELECT MAX(lv) FROM l)") \
            .collect()
        return orig(self)

    monkeypatch.setattr(AQ.AdaptiveShuffledHashJoinExec, "_choose", choose)
    _join(s, left_t, right_t).collect()
    assert [d["kind"] for d in s.last_aqe()["decisions"]] == [
        "broadcast_conversion"]


def test_render_text_matches_jax():
    left_t, right_t = _sides(600, seed=3, skew=0.8)
    ps, pt, js, jt = _run_both(
        lambda api, s: _join(s, left_t, right_t, parts=(3, 3)), SKEW_CONF)
    assert ps.explain_aqe() == JAQ.render_text(js.last_aqe())
    assert ps.explain_aqe()[0].startswith("-- adaptive (")
