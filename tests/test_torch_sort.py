"""The port's sort, TopN, limit and the round-robin and range exchanges
against the JAX package, on the CPU.

Each query runs through both packages on the same seeded table and the
results are compared row by row, in order, exactly: sorts and TopN define
the order (ties keep the input order in both), a limit keeps its
partitions' order, and a repartition's collect concatenates its
partitions, so equal order means equal partitioning. String sort keys
compare by exact byte order (8-byte chunks) in both packages. Most cases
run with adaptive execution off in both packages; the exchanges also run
at its default (on), where tiny post-shuffle sub-batches coalesce.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import from_jax_batch, jax_api, torch_api

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import kernels as JK
from spark_rapids_tpu.plan.overrides import convert_plan as jax_convert
from spark_rapids_tpu.runtime.metrics import walk_exec_tree

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import kernels as K

ADAPTIVE_OFF = {"spark.rapids.sql.adaptive.enabled": "false"}
PLANNED = {"TopNExec", "SortExec", "LimitExec", "RangeExchangeExec",
           "RoundRobinExchangeExec", "CollectExchangeExec"}
ROWS = 6000


def _spy(monkeypatch, owner, name):
    hits = []
    orig = getattr(owner, name)

    def spy(*a, **k):
        hits.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(owner, name, spy)
    return hits


def _table(n=ROWS, seed=21):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 100, n).round(1)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    big = rng.integers(-1000, 1000, n).astype(np.int64)
    top = rng.random(n) < 0.02
    big[top] = (1 << 40) + rng.integers(0, 64, int(top.sum()))
    prefix = "shared-prefix-of-twenty"
    flat = [f"{prefix}{i % 9}{'z' * (i % 5)}-{i}" if i % 3 else
            f"{prefix}{i % 9}" for i in range(n)]
    words = np.array([prefix + w for w in ("", "a", "ab", "abc", "b", "é",
                                           "ba", "aaaaaaaaaaaaaa")], object)
    return pa.table({
        "i": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "f": pa.array(f, mask=rng.random(n) < 0.05),
        "big": pa.array(big),
        "s": pa.array(flat, pa.string(), mask=rng.random(n) < 0.05),
        "w": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                      mask=rng.random(n) < 0.05),
    })


def _both(build, table=None, conf=None, parts=1, adaptive=False):
    """(port result, port session, JAX session, JAX DataFrame); adaptive
    execution off unless ``adaptive``."""
    table = _table() if table is None else table
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(dict({} if adaptive else ADAPTIVE_OFF,
                             **(conf or {})))
        df = build(api, s.create_dataframe(table, num_partitions=parts))
        out.append((df.collect(), s, df))
    (got, ps, _), (want, js, jdf) = out
    assert_tables_equal(got, want)
    return got, ps, js, jdf


def _planned(ps, js, jdf):
    port = {type(n).__name__ for n in ps.last_exec.walk()} & PLANNED
    root, _ = jax_convert(jdf.plan, js.conf)
    jax = {type(n).__name__ for _, n, *_ in walk_exec_tree(root)} & PLANNED
    assert port == jax
    return port


def _order(api, name, how):
    return getattr(api.col(name), how)()


# ---------------------------------------------------------------------------
# TopN
# ---------------------------------------------------------------------------

#: (order, n, filtered first, takes the topk image)
TOPN_CASES = {
    "f_desc": ([("f", "desc"), ("i", "asc")], 10, False, True),
    "f_asc": ([("f", "asc")], 25, False, True),
    "f_desc_nulls_first": ([("f", "desc_nulls_first")], 10, False, True),
    "f_asc_nulls_last": ([("f", "asc_nulls_last"), ("i", "desc")], 10,
                         False, True),
    "k_ties": ([("k", "desc")], 40, False, True),
    "int64_collapsing_image": ([("big", "desc")], 10, False, True),
    "string_key": ([("s", "asc"), ("i", "asc")], 10, False, False),
    "n_over_rows_masked": ([("f", "desc"), ("i", "asc")], 10_000, True,
                           False),
}


@pytest.mark.parametrize("case", list(TOPN_CASES.values()),
                         ids=list(TOPN_CASES))
def test_topn_matches_jax(case, monkeypatch):
    orders, n, masked, imaged = case
    topk = _spy(monkeypatch, torch, "topk")

    def build(api, df):
        if masked:
            df = df.filter(api.col("k") < api.lit(25))
        return df.order_by(*[_order(api, c, h) for c, h in orders]).limit(n)
    got, ps, js, jdf = _both(build)
    assert got.num_rows == (min(n, ROWS) if not masked else got.num_rows)
    assert bool(topk) == imaged
    assert "TopNExec" in _planned(ps, js, jdf)


def test_topn_over_partitions_matches_jax():
    def build(api, df):
        return df.order_by(api.col("big").desc(), api.col("i").asc()) \
            .limit(15)
    got, ps, js, jdf = _both(build, parts=4)
    assert got.num_rows == 15
    assert _planned(ps, js, jdf) == {"TopNExec", "CollectExchangeExec"}


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------

SORT_CASES = {
    "flat_string_then_int": [("s", "asc"), ("i", "desc")],
    "dict_string_desc_then_float": [("w", "desc_nulls_last"), ("f", "asc"),
                                    ("i", "asc")],
    "float_then_string": [("f", "desc"), ("s", "asc_nulls_last"),
                          ("i", "asc")],
    "int_nulls_last_then_dict": [("k", "asc_nulls_last"), ("w", "asc"),
                                 ("i", "desc")],
}


@pytest.mark.parametrize("orders", list(SORT_CASES.values()),
                         ids=list(SORT_CASES))
def test_sort_matches_jax(orders):
    def build(api, df):
        return df.order_by(*[_order(api, c, h) for c, h in orders])
    got, ps, js, jdf = _both(build)
    assert got.num_rows == ROWS
    assert _planned(ps, js, jdf) == {"SortExec"}


@pytest.mark.parametrize("orders", [SORT_CASES["flat_string_then_int"],
                                    SORT_CASES["float_then_string"]],
                         ids=["flat_string_then_int", "float_then_string"])
def test_out_of_core_sort_equals_in_core(orders, monkeypatch):
    ooc = _spy(monkeypatch, X.SortExec, "_out_of_core")
    conf = {"spark.rapids.sql.sort.outOfCoreBytes": 1 << 12,
            "spark.rapids.sql.reader.batchSizeRows": 1500}
    table = _table()

    def build(api, df):
        return df.order_by(*[_order(api, c, h) for c, h in orders])
    P = torch_api()
    got = build(P, P.session(conf).create_dataframe(table)).collect()
    assert ooc
    in_core = build(P, P.session().create_dataframe(table)).collect()
    assert_tables_equal(got, in_core)


def test_global_sort_over_partitions_matches_jax(monkeypatch):
    rng_ex = _spy(monkeypatch, X.RangeExchangeExec, "_repartition")

    def build(api, df):
        return df.select(api.col("f"), api.col("i"), api.col("big")) \
            .order_by(api.col("f").desc(), api.col("i").asc())
    conf = {"spark.rapids.sql.rangePartitioning.sampleSizePerPartition": 64}
    got, ps, js, jdf = _both(build, conf=conf, parts=4)
    assert got.num_rows == ROWS and rng_ex
    assert _planned(ps, js, jdf) == {"SortExec", "RangeExchangeExec"}


def test_string_sort_over_partitions_collects():
    def build(api, df):
        return df.order_by(api.col("s").asc(), api.col("i").asc())
    _, ps, js, jdf = _both(build, parts=3)
    assert _planned(ps, js, jdf) == {"SortExec", "CollectExchangeExec"}


# ---------------------------------------------------------------------------
# Limit and the round-robin exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4])
def test_limit_matches_jax(parts):
    def build(api, df):
        return df.filter(api.col("k") > api.lit(10)).limit(777)
    got, ps, js, jdf = _both(build, parts=parts)
    assert got.num_rows == 777
    assert _planned(ps, js, jdf) == ({"LimitExec", "CollectExchangeExec"}
                                     if parts > 1 else {"LimitExec"})


@pytest.mark.parametrize("parts", [1, 3])
def test_round_robin_repartition_matches_jax(parts):
    def build(api, df):
        return df.filter(api.col("k") > api.lit(5)).repartition(4)
    got, ps, js, jdf = _both(build, parts=parts)
    assert _planned(ps, js, jdf) == {"RoundRobinExchangeExec"}
    # the k-th live row of each input batch goes to partition k mod 4
    root = ps.last_exec
    sizes = [sum(int(b.num_rows) for b in root.execute_partition(p))
             for p in range(4)]
    assert sum(sizes) == got.num_rows and max(sizes) - min(sizes) <= parts


#: the exchanges at adaptive execution's default (on): tiny coalescing
#: merges their small post-shuffle sub-batches in both packages
ADAPTIVE_EXCHANGES = {
    "range_sort": (lambda api, df: df.select(
        api.col("f"), api.col("i"), api.col("k")).order_by(
        api.col("k").desc(), api.col("i").asc()), 4,
        {"SortExec", "RangeExchangeExec"}),
    "round_robin": (lambda api, df: df.filter(
        api.col("k") > api.lit(5)).repartition(6), 3,
        {"RoundRobinExchangeExec"}),
    "topn": (lambda api, df: df.order_by(api.col("f").desc(),
                                         api.col("i").asc()).limit(50), 4,
             {"TopNExec"}),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_EXCHANGES))
def test_exchanges_at_adaptive_defaults_match_jax(case):
    build, parts, planned = ADAPTIVE_EXCHANGES[case]
    conf = {"spark.rapids.sql.rangePartitioning.sampleSizePerPartition": 64}
    _, ps, js, jdf = _both(build, conf=conf, parts=parts, adaptive=True)
    assert planned <= _planned(ps, js, jdf)


# ---------------------------------------------------------------------------
# String chunk keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("column", ["s", "w"], ids=["flat", "dict"])
def test_string_chunk_keys_match_jax(column):
    t = _table(1500).select([column])
    jb = jax_from_arrow(t)
    pb = from_jax_batch(jb)
    jc, pc = jb.columns[0], pb.columns[0]
    n = JK.string_chunk_count(jc)
    assert K.string_chunk_count(pc) == n >= 4
    for (jk, jn), (pk, pn) in zip(JK.string_chunk_keys(jc, 1500, n),
                                  K.string_chunk_keys(pc, 1500, n)):
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        want = (np.asarray(jk).astype(np.uint64)
                ^ np.uint64(1 << 63)).view(np.int64)
        np.testing.assert_array_equal(pk.numpy(), want)
