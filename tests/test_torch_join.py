"""The port's joins against the JAX package, on the CPU.

Three levels, each on the same seeded inputs through both packages:
- ``ops/join``: the combined 64-bit key hash bit for bit, the merge-rank
  candidate ranges, and the pairs of ``join_pairs`` (as sets) with their
  counts, over the dense-unique, dense-duplicate and general paths;
- every join type through the DataFrame front door on the broadcast, the
  shuffled (threshold 0, 4 partitions) and the sub-partitioned
  strategies, with a join condition, the ``on="k"`` key dedupe, and the
  unique-key mask-through probe; cross joins with and without a
  condition, and non-equi joins of every type over one, several and
  single-row build tiles;
- bench.py's q3join whole, and the operators both packages plan, with
  adaptive execution off and at its default (on): broadcast, converted
  from shuffled to broadcast at run time, and kept shuffled, with the
  adaptive decisions held to the JAX package's.

Everything compares exactly: join results hold no float arithmetic, and
q3join's revenue sums take the exact packed-radix routes in both.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import (
    aqe_decisions, chosen_execs, from_jax_batch, jax_api, make_tables, q3join,
    torch_api,
)

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import join as JJ
from spark_rapids_tpu.plan.overrides import convert_plan as jax_convert
from spark_rapids_tpu.runtime.metrics import walk_exec_tree

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import join as J

ADAPTIVE_OFF = {"spark.rapids.sql.adaptive.enabled": "false"}
SHUFFLED = {"spark.rapids.sql.join.broadcastRowThreshold": 0}
SUBPART = {"spark.rapids.sql.join.subPartitionRows": 64}
#: the operators whose choice the port shares with the JAX package
PLANNED = {"BroadcastHashJoinExec", "ShuffledHashJoinExec", "TopNExec",
           "SortExec", "LimitExec", "RangeExchangeExec",
           "RoundRobinExchangeExec"}


def _spy(monkeypatch, owner, name):
    hits = []
    orig = getattr(owner, name)

    def spy(*a, **k):
        hits.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(owner, name, spy)
    return hits


def _u64_as_i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64).view(np.int64)


# ---------------------------------------------------------------------------
# ops/join
# ---------------------------------------------------------------------------

def _key_table(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array([f"key-{i:05d}" for i in range(40)] + ["", "é"], object)
    return pa.table({
        "i64": pa.array(rng.integers(-50, 50, n).astype(np.int64),
                        mask=rng.random(n) < 0.05),
        "i32": pa.array(rng.integers(0, 30, n).astype(np.int32)),
        "wide": pa.array(rng.integers(0, 40, n).astype(np.int64) << 40),
        "f64": pa.array(rng.choice([0.0, -0.0, 1.5, np.nan, -np.inf, 2.0],
                                   n), mask=rng.random(n) < 0.05),
        "f32": pa.array(rng.choice([0.0, -0.0, 1.5, np.nan, 7.25],
                                   n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.05),
        "d": pa.array(rng.integers(9000, 9040, n).astype(np.int32),
                      pa.date32()),
        "dict": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                         mask=rng.random(n) < 0.05),
        "flat": pa.array([f"row-{i % 97}-{'x' * (i % 11)}" for i in
                          range(n)], pa.string()),
    })


def _batches(n, seed):
    jb = jax_from_arrow(_key_table(n, seed))
    return jb, from_jax_batch(jb)


KEY_SETS = {"int64": ["i64"], "int32": ["i32"], "float64": ["f64"],
            "float32": ["f32"], "bool": ["b"], "date": ["d"],
            "dict": ["dict"], "flat": ["flat"], "int_and_string": ["i32",
                                                                    "dict"]}


def _cols(batch, names, table_names):
    return [batch.columns[table_names.index(n)] for n in names]


@pytest.mark.parametrize("keys", list(KEY_SETS.values()),
                         ids=list(KEY_SETS))
def test_combine_keys_bit_equal(keys):
    names = _key_table(4, 0).schema.names
    jb, pb = _batches(1500, 1)
    jh, jplanes, jnull = JJ._combine_keys(_cols(jb, keys, names), 1500)
    ph, pplanes, pnull = J._combine_keys(_cols(pb, keys, names), 1500)
    np.testing.assert_array_equal(pnull.numpy(), np.asarray(jnull))
    np.testing.assert_array_equal(ph.numpy(), _u64_as_i64(jh))
    for p, j in zip(pplanes, jplanes):
        np.testing.assert_array_equal(p.numpy(), _u64_as_i64(j))


def test_merge_rank_ranges_equal():
    rng = np.random.default_rng(3)
    bcap, bcount, pcap = 2048, 1500, 4096
    pool = rng.integers(0, 2 ** 63, 300, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 300).astype(np.uint64)
    bh = np.sort(rng.choice(pool, bcount))
    sorted_h = np.concatenate([bh, np.full(bcap - bcount,
                                           np.iinfo(np.uint64).max,
                                           np.uint64)])
    ph = rng.choice(np.concatenate([pool, rng.integers(
        0, 2 ** 63, 200, dtype=np.uint64)]), pcap)
    p_in = rng.random(pcap) < 0.9
    import jax.numpy as jnp
    jlo, jhi = JJ._merge_rank_ranges(jnp.asarray(sorted_h), bcount,
                                     jnp.asarray(ph), jnp.asarray(p_in))
    plo, phi = J._merge_rank_ranges(
        torch.from_numpy(sorted_h.view(np.int64)) ^ J._MIN64, bcount,
        torch.from_numpy(ph.view(np.int64)) ^ J._MIN64,
        torch.from_numpy(p_in))
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jhi))
    assert int((phi - plo).sum()) > 0


#: (build key, probe key, build rows, expected path)
PAIR_CASES = {
    "dense_unique": ("i32", "i32", 30, "_dense_int_pairs"),
    "dense_dup": ("i64", "i64", 800, "_dense_int_pairs"),
    "general_wide_int": ("wide", "wide", 800, "_merge_rank_ranges"),
    "dict": ("dict", "dict", 800, "_merge_rank_ranges"),
    "flat_vs_dict": ("flat", "flat", 800, "_merge_rank_ranges"),
    "float": ("f64", "f64", 800, "_merge_rank_ranges"),
    "two_columns": (["i32", "dict"], ["i32", "dict"], 800,
                    "_merge_rank_ranges"),
}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("case", list(PAIR_CASES.values()),
                         ids=list(PAIR_CASES))
def test_join_pairs_match_jax(case, masked, monkeypatch):
    bkey, pkey, brows, path = case
    bkey = bkey if isinstance(bkey, list) else [bkey]
    pkey = pkey if isinstance(pkey, list) else [pkey]
    names = _key_table(4, 0).schema.names
    if bkey == ["i32"]:  # unique build keys 0..29
        t = _key_table(brows, 5).set_column(
            names.index("i32"), "i32", pa.array(np.arange(brows,
                                                          dtype=np.int32)))
        jbb = jax_from_arrow(t)
        pbb = from_jax_batch(jbb)
    else:
        jbb, pbb = _batches(brows, 5)
    jpb, ppb = _batches(3000, 6)
    live = np.random.default_rng(7).random(ppb.capacity) < 0.7 \
        if masked else None
    hits = _spy(monkeypatch, J, path)
    import jax.numpy as jnp
    jp, jbi, jn = JJ.join_pairs(_cols(jbb, bkey, names), brows,
                                _cols(jpb, pkey, names), 3000,
                                probe_live=None if live is None
                                else jnp.asarray(live))
    pp, pbi, pn = J.join_pairs(_cols(pbb, bkey, names), brows,
                               _cols(ppb, pkey, names), 3000,
                               probe_live=None if live is None
                               else torch.from_numpy(live))
    assert pn == int(jn) and pn > 0 and hits
    want = sorted(zip(np.asarray(jp)[:int(jn)].tolist(),
                      np.asarray(jbi)[:int(jn)].tolist()))
    got = list(zip(pp[:pn].tolist(), pbi[:pn].tolist()))
    assert sorted(got) == want
    # probe-major, as the JAX package emits them
    assert [p for p, _ in got] == sorted(p for p, _ in got)
    if live is not None:
        assert all(live[p] for p, _ in got)


def test_dense_build_reads_the_host_once(monkeypatch):
    reads = []
    orig = torch.Tensor.tolist

    def spy(t):
        reads.append(t.numel())
        return orig(t)
    monkeypatch.setattr(torch.Tensor, "tolist", spy)
    _, pb = _batches(800, 5)
    table = J.prepare_dense_build([pb.columns[0]], 800,
                                  [pb.columns[0].dtype])
    assert reads == [4]
    assert table.max_dup > 1 and table.span == 100


# ---------------------------------------------------------------------------
# join types through the front door
# ---------------------------------------------------------------------------

def _sides(seed=11, n_left=700, n_right=300, unique_right=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 120, n_left).astype(np.int64)
    left = pa.table({
        "k": pa.array(k, mask=rng.random(n_left) < 0.05),
        "s": pa.array([f"s{i % 13}" for i in range(n_left)]),
        "lv": pa.array(rng.integers(0, 100, n_left).astype(np.int64)),
    })
    rk = rng.permutation(400)[:n_right].astype(np.int64) if unique_right \
        else rng.integers(40, 200, n_right).astype(np.int64)
    right = pa.table({
        "k": pa.array(rk, mask=rng.random(n_right) < 0.05),
        "t": pa.array([f"t{i % 7}" for i in range(n_right)]),
        "rv": pa.array(rng.integers(0, 100, n_right).astype(np.int64)),
    })
    return left, right


STRATEGIES = {"broadcast": ({}, 1), "shuffled": (SHUFFLED, 4),
              "subpartition": (SUBPART, 1)}
HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]


def _join(api, conf, parts, left, right, how, on="pairs", cond=False):
    s = api.session(dict(ADAPTIVE_OFF, **conf))
    dl = s.create_dataframe(left, num_partitions=parts)
    dr = s.create_dataframe(right, num_partitions=parts)
    if on == "name":
        return s, dl.join(dr, on="k", how=how)
    col = api.col
    dr = dr.select(col("k").alias("rk"), col("t"), col("rv"))
    if cond:
        return s, _conditioned(api, dl, dr, how)
    return s, dl.join(dr, on=[(col("k"), col("rk"))], how=how)


def _conditioned(api, dl, dr, how):
    """An equi-join with an extra condition over both sides' columns."""
    from spark_rapids_tpu_torch.plan import nodes as TP
    col = api.col
    cond = col("lv") > col("rv")
    if isinstance(dl.plan, TP.PlanNode):
        plan = TP.Join(dl.plan, dr.plan, [col("k")], [col("rk")], how, cond)
        return type(dl)(plan, dl.session)
    from spark_rapids_tpu.plan import nodes as JP
    plan = JP.Join(dl.plan, dr.plan, [col("k")], [col("rk")], how, cond)
    return type(dl)(plan, dl.session)


_JAX_RESULTS: dict = {}


def _jax_result(key, build):
    """The JAX package's result, once per distinct query: its results do
    not depend on the strategy, and each query compiles anew."""
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = build().collect()
    return _JAX_RESULTS[key]


def _jax_planned(session, df) -> set:
    root, _ = jax_convert(df.plan, session.conf)
    return {type(n).__name__ for _, n, *_ in walk_exec_tree(root)} & PLANNED


def _port_planned(session) -> set:
    return {type(n).__name__ for n in session.last_exec.walk()} & PLANNED


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_join_types_match_jax(strategy, how, monkeypatch):
    conf, parts = STRATEGIES[strategy]
    left, right = _sides()
    split = _spy(monkeypatch, X._HashJoinBase, "_split_build")
    ps, pdf = _join(torch_api(), conf, parts, left, right, how)
    got = pdf.collect()
    js, jdf = _join(jax_api(), conf, parts, left, right, how)
    want = _jax_result(("types", how),
                       lambda: _join(jax_api(), {}, 1, left, right, how)[1])
    assert_tables_equal(got, want, ignore_order=True)
    assert _port_planned(ps) == _jax_planned(js, jdf)
    sub = strategy == "subpartition" and how not in ("right", "full")
    assert bool(split) == sub


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti",
                                 "right", "full"])
def test_join_condition_matches_jax(how):
    left, right = _sides()
    got = _join(torch_api(), {}, 1, left, right, how, cond=True)[1].collect()
    want = _join(jax_api(), {}, 1, left, right, how, cond=True)[1].collect()
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("how", ["right", "full"])
@pytest.mark.parametrize("strategy", ["broadcast", "shuffled"])
def test_join_on_name_dedupes_the_key(strategy, how):
    conf, parts = STRATEGIES[strategy]
    left, right = _sides()
    got = _join(torch_api(), conf, parts, left, right, how,
                on="name")[1].collect()
    want = _jax_result(("name", how), lambda: _join(
        jax_api(), {}, 1, left, right, how, on="name")[1])
    assert got.schema.names == ["k", "s", "lv", "t", "rv"]
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti"])
def test_unique_build_keys_probe_through_the_mask(how, monkeypatch):
    masked = _spy(monkeypatch, X._HashJoinBase, "_probe_masked")
    pairs = _spy(monkeypatch, J, "join_pairs")
    left, right = _sides(unique_right=True)

    def build(api):
        col, lit = api.col, api.lit
        s = api.session(ADAPTIVE_OFF)
        dl = s.create_dataframe(left).filter(col("lv") < lit(80))
        dr = s.create_dataframe(right).select(
            col("k").alias("rk"), col("t"), col("rv"))
        return _conditioned(api, dl, dr, how)
    got = build(torch_api()).collect()
    assert masked and not pairs
    assert_tables_equal(got, build(jax_api()).collect(), ignore_order=True)


@pytest.mark.parametrize("kind", ["cross", "non_equi"])
def test_unported_joins_raise_naming_the_jax_exec(kind):
    """The joins without equi keys now plan the JAX package's operator of
    the same name, and agree with it."""
    out = []
    for api in (torch_api(), jax_api()):
        left, right = _sides()
        s = api.session(ADAPTIVE_OFF)
        dl = s.create_dataframe(left)
        dr = s.create_dataframe(right).select(api.col("k").alias("rk"))
        if kind == "cross":
            df, name = dl.join(dr, how="cross"), "CartesianProductExec"
        else:
            df, name = dl.join(dr, on=api.col("k") < api.col("rk")), \
                "BroadcastNestedLoopJoinExec"
        out.append((df.collect(), s))
    (got, ps), (want, _) = out
    assert name in {type(n).__name__ for n in ps.last_exec.walk()}
    assert_tables_equal(got, want, ignore_order=True)


def _without_keys(api, how, parts, cond=True):
    """A join of ``_sides()`` with no equi key: a condition over both
    sides' columns (nulls in k included), or none."""
    left, right = _sides()
    col = api.col
    s = api.session(ADAPTIVE_OFF)
    dl = s.create_dataframe(left, num_partitions=parts)
    dr = s.create_dataframe(right).select(col("k").alias("rk"), col("t"),
                                          col("rv"))
    on = (col("k") < col("rk")) & (col("lv") > col("rv") + api.lit(40))
    if how == "cross" and not cond:
        return s, dl.join(dr, how="cross")
    if how == "cross":  # the DataFrame API has no cross join condition
        from spark_rapids_tpu.plan import nodes as JP
        from spark_rapids_tpu_torch.plan import nodes as TP
        nodes = TP if isinstance(dl.plan, TP.PlanNode) else JP
        return s, type(dl)(nodes.Join(dl.plan, dr.plan, [], [], "cross",
                                      on), s)
    return s, dl.join(dr, on=on, how=how)


#: BroadcastNestedLoopJoinExec.MAX_PAIRS -> build rows per tile against
#: the 1024-row left capacity: the default (the whole build), 100 rows,
#: and one row, where the left columns join without a gather
TILES = {"whole_build": None, "tile_100": 1024 * 100, "tile_1": 1024}


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("how", HOWS)
def test_non_equi_joins_match_jax(how, tile, monkeypatch):
    if TILES[tile] is not None:
        monkeypatch.setattr(X.BroadcastNestedLoopJoinExec, "MAX_PAIRS",
                            TILES[tile])
    # right and full joins collect a multi-partition left side first
    parts = 4 if how in ("right", "full") else 1
    ps, pdf = _without_keys(torch_api(), how, parts)
    got = pdf.collect()
    want = _jax_result(("non_equi", how),
                       lambda: _without_keys(jax_api(), how, parts)[1])
    assert_tables_equal(got, want, ignore_order=True)
    names = {type(n).__name__ for n in ps.last_exec.walk()}
    assert "BroadcastNestedLoopJoinExec" in names
    assert ("CollectExchangeExec" in names) == (parts > 1)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "condition"])
def test_cross_joins_match_jax(cond):
    ps, pdf = _without_keys(torch_api(), "cross", 4, cond)
    got = pdf.collect()
    want = _without_keys(jax_api(), "cross", 4, cond)[1].collect()
    assert_tables_equal(got, want, ignore_order=True)
    assert got.num_rows == (700 * 300 if not cond else want.num_rows) > 0
    assert "CartesianProductExec" in {type(n).__name__
                                      for n in ps.last_exec.walk()}


# ---------------------------------------------------------------------------
# q3join whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4], ids=["broadcast", "shuffled"])
def test_q3join_matches_jax(parts, monkeypatch):
    li, od = make_tables(20_000)
    conf = dict(ADAPTIVE_OFF, **(SHUFFLED if parts > 1 else {}))
    masked = _spy(monkeypatch, X._HashJoinBase, "_probe_masked")
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        dl = s.create_dataframe(li, num_partitions=parts).cache()
        do = s.create_dataframe(od, num_partitions=parts).cache()
        df = q3join(api, dl, do)
        out.append((df.collect(), s, df))
    (got, ps, _), (want, js, jdf) = out
    assert_tables_equal(got, want)
    assert got.num_rows == 10 and masked
    planned = _port_planned(ps)
    assert planned == _jax_planned(js, jdf)
    assert "TopNExec" in planned
    assert ("ShuffledHashJoinExec" if parts > 1
            else "BroadcastHashJoinExec") in planned


#: q3join with adaptive execution at its default (on): (partitions, conf,
#: the join the adaptive plan runs)
ADAPTIVE_Q3 = {
    "broadcast": (1, {}, "BroadcastHashJoinExec"),
    "converted": (4, SHUFFLED, "BroadcastHashJoinExec"),
    "shuffled": (4, dict(SHUFFLED, **{
        "spark.rapids.sql.adaptive.broadcastThresholdBytes": 0}),
        "ShuffledHashJoinExec"),
}
ADAPTIVE_PLANNED = PLANNED | {"AdaptiveShuffledHashJoinExec",
                              "AdaptiveJoinExec", "_MaterializedExec",
                              "ShuffleExchangeExec"}


def _chosen_names(root) -> set:
    return {type(n).__name__ for n in chosen_execs(root)}


@pytest.mark.parametrize("case", list(ADAPTIVE_Q3))
def test_q3join_adaptive_matches_jax(case, monkeypatch):
    import jax
    from spark_rapids_tpu.exec import adaptive as JAQ
    from spark_rapids_tpu_torch.exec import adaptive as AQ
    real = jax.devices  # the JAX package's one-device aggregate plan
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    AQ.reset_for_tests()
    JAQ.reset_for_tests()
    parts, conf, join = ADAPTIVE_Q3[case]
    li, od = make_tables(20_000)
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        dl = s.create_dataframe(li, num_partitions=parts).cache()
        do = s.create_dataframe(od, num_partitions=parts).cache()
        out.append((q3join(api, dl, do).collect(), s))
    (got, ps), (want, js) = out
    assert_tables_equal(got, want)
    assert got.num_rows == 10
    planned = _chosen_names(ps.last_exec) & ADAPTIVE_PLANNED
    assert planned == _chosen_names(js._last_exec) & ADAPTIVE_PLANNED
    assert join in planned and "TopNExec" in planned
    assert aqe_decisions(ps.last_aqe()) == aqe_decisions(js.last_aqe())
    if case == "converted":
        assert [d["kind"] for d in ps.last_aqe()["decisions"]] == [
            "broadcast_conversion"]
    AQ.reset_for_tests()
    JAQ.reset_for_tests()
