"""The port's sort routes of the aggregate and the string slice as a
whole, against the JAX package, on the CPU.

Keys that do not pack (flat strings, dictionaries whose vocabulary may
repeat a string, floats) group by sorting 64-bit keys; the results must
equal the JAX package's group by group. Float sums there are held to a
relative 1e-12 (summation order), everything else exactly. Packed keys
wider than 23 bits take the packed sort route, whose limb sums are exact:
its results must equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import (
    from_jax_batch, jax_api, make_lineitem_text, str_case_agg,
    str_group_flat, str_prefix_rows, torch_api,
)

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import kernels as JK

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import case_map as CM
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import kernels as K


def _spy(monkeypatch, cls, name):
    hits = []
    orig = getattr(cls, name)

    def spy(self, *a, **k):
        hits.append(1)
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, name, spy)
    return hits


def _both(build, table, approx=1e-12, conf=None):
    """The port's result, checked against the JAX package's (floats to a
    relative ``approx``; None = exactly)."""
    out = []
    for api in (torch_api(), jax_api()):
        out.append(build(api, api.session(conf).create_dataframe(table))
                   .collect())
    assert_tables_equal(out[0], out[1], ignore_order=True,
                        approx_float=approx)
    return out[0]


# ---------------------------------------------------------------------------
# the fault: equal strings form one group
# ---------------------------------------------------------------------------

def _dup_table():
    vals = [f"s{i}" for i in range(1500)] + ["dup"] * 500
    return pa.table({"s": vals, "x": np.ones(2000)})


@pytest.mark.parametrize("repartition", [False, True],
                         ids=["direct", "repartition"])
def test_equal_strings_form_one_group(repartition, monkeypatch):
    sort = _spy(monkeypatch, X._AggKernels, "_sort_agg")

    def build(api, df):
        if repartition:
            df = df.repartition(4, api.col("s"))
        return df.group_by("s").agg(api.F.sum(api.col("x")).alias("sx"))
    got = _both(build, _dup_table())
    assert got.num_rows == 1501
    rows = {r["s"]: r["sx"] for r in got.to_pylist()}
    assert rows["dup"] == 500.0
    assert sort


def test_group_by_upper_of_dictionary_collapses_case(monkeypatch):
    bucket = _spy(monkeypatch, X._AggKernels, "_bucket_update")
    t = pa.table({"s": ["a", "A", "b", "a", "B", None],
                  "x": [1, 2, 3, 4, 5, 6]})

    def build(api, df):
        return (df.select(api.F.upper(api.col("s")).alias("u"), api.col("x"))
                .group_by("u").agg(api.F.sum(api.col("x")).alias("sx")))
    got = _both(build, t)
    assert {r["u"]: r["sx"] for r in got.to_pylist()} == \
        {"A": 7, "B": 8, None: 6}
    assert not bucket  # codes of a transformed vocabulary are not groups


# ---------------------------------------------------------------------------
# the sort route on its own
# ---------------------------------------------------------------------------

def _keys_table(n=3000, seed=4):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20000)] + ["", "é", "ß"],
                     object)
    fl = rng.choice([0.0, -0.0, 1.5, -2.25, np.nan, np.inf, -np.inf, 3.0], n)
    return pa.table({
        "s": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                      mask=rng.random(n) < 0.05),
        "f": pa.array(fl, mask=rng.random(n) < 0.05),
        "g": pa.array(fl.astype(np.float32), mask=rng.random(n) < 0.05),
        "k": pa.array(rng.integers(-3, 3, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "x": pa.array(rng.integers(-100, 100, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "v": pa.array(rng.normal(0, 10, n), mask=rng.random(n) < 0.1),
    })


def _aggs(api):
    col, F = api.col, api.F
    return [F.count().alias("n"), F.count(col("x")).alias("cx"),
            F.sum(col("x")).alias("sx"), F.sum(col("v")).alias("sv"),
            F.min(col("v")).alias("mnv"), F.max(col("x")).alias("mxx"),
            F.avg(col("v")).alias("av")]


@pytest.mark.parametrize("keys", [["s"], ["f"], ["g"], ["s", "k", "f"],
                                  ["k", "s"]],
                         ids=["string", "float64", "float32",
                              "string_int_float", "int_string"])
def test_sort_route_matches_jax(keys, monkeypatch):
    sort = _spy(monkeypatch, X._AggKernels, "_sort_agg")
    got = _both(lambda api, df: df.group_by(*keys).agg(*_aggs(api)),
                _keys_table())
    assert sort
    if keys == ["f"]:
        # NaNs form one group, and so do -0.0 and 0.0
        fs = got["f"].to_pylist()
        assert sum(1 for v in fs if v is not None and v != v) == 1
        assert sum(1 for v in fs if v == 0.0) == 1


def test_sort_route_over_masked_batches_matches_jax(monkeypatch):
    sort = _spy(monkeypatch, X._AggKernels, "_sort_agg")

    def build(api, df):
        col, lit = api.col, api.lit
        # the select between filter and aggregate keeps the filter apart:
        # the aggregate sees a batch with a selection mask
        return (df.filter(col("k") > lit(-1))
                .select(col("s"), col("f"), col("x"), col("v"))
                .group_by("s", "f").agg(*_aggs(api)[:4]))
    _both(build, _keys_table())
    assert sort


def test_sort_route_merges_partial_states(monkeypatch):
    merge = _spy(monkeypatch, X._AggKernels, "merge")
    conf = {"spark.rapids.sql.reader.batchSizeRows": 700}

    def build(api, df):
        return df.group_by("s", "f").agg(*_aggs(api))
    _both(build, _keys_table(), conf=conf)
    assert merge


def test_group_segments_match_jax():
    t = _keys_table(2000)
    jb = jax_from_arrow(t)
    pb = from_jax_batch(jb)
    n = t.num_rows
    for idx in ([0], [1], [2], [0, 3, 1]):
        jp, js, jbd = JG.group_segments([jb.columns[i] for i in idx], n)
        pp, ps, pbd = G.group_segments([pb.columns[i] for i in idx], n)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pbd.numpy(), np.asarray(jbd))
        assert G.num_groups(pbd) == JG.num_groups(jbd)


def test_normalize_key_strings_match_jax_hash():
    t = _keys_table(500)
    jb = jax_from_arrow(t)
    pb = from_jax_batch(jb)
    jkey, jnull = JK.normalize_key(jb.columns[0], 500)
    pkey, pnull = K.normalize_key(pb.columns[0], 500)
    # the port keeps the u64 key with its sign bit flipped, as int64
    want = (np.asarray(jkey).astype(np.uint64)
            ^ np.uint64(1 << 63)).view(np.int64)
    valid = ~np.asarray(jnull)
    np.testing.assert_array_equal(pnull.numpy(), np.asarray(jnull))
    np.testing.assert_array_equal(pkey.numpy()[valid], want[valid])


def test_packed_keys_wider_than_23_bits_still_raise(monkeypatch):
    # they raised until the packed sort route was ported; now they take it
    packed = _spy(monkeypatch, X._AggKernels, "_packed_sort_agg")

    def build(api, df):
        return df.select((api.col("x") * api.lit(1_000_000)).alias("w"),
                         api.col("v")) \
            .group_by("w").agg(api.F.sum(api.col("v")).alias("sv"))
    _both(build, _keys_table(), approx=None)
    assert packed


# ---------------------------------------------------------------------------
# the packed sort route: packed keys wider than 23 bits
# ---------------------------------------------------------------------------

def _wide_table(n=4000, seed=8):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1e3, n)
    v[rng.random(n) < 0.01] = np.nan
    v[rng.random(n) < 0.005] = np.inf
    return pa.table({
        "ok": pa.array(rng.integers(0, 3_000_000, n).astype(np.int64)),
        "od": pa.array(rng.integers(8400, 10600, n).astype(np.int32),
                       mask=rng.random(n) < 0.05),
        "g": pa.array(rng.integers(0, 40, n).astype(np.int64)),
        "x": pa.array(rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=rng.random(n) < 0.05),
        "f": pa.array(rng.normal(0, 1, n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5),
    })


def _packed_aggs(api):
    col, F = api.col, api.F
    return [F.count().alias("n"), F.count(col("v")).alias("cv"),
            F.sum(col("x")).alias("sx"), F.sum(col("v")).alias("sv"),
            F.min(col("x")).alias("mnx"), F.max(col("v")).alias("mxv"),
            F.min(col("f")).alias("mnf"), F.max(col("od")).alias("mxd"),
            F.avg(col("v")).alias("av")]


#: group keys whose packed width passes 23 bits (22 + 12, 22 + 6, 22 +
#: 12 + 2)
WIDE_KEYS = {"orderkey_date": ["ok", "od"], "orderkey_small": ["ok", "g"],
             "three_keys": ["ok", "od", "b"]}


@pytest.mark.parametrize("batch_rows", [None, 1500],
                         ids=["one_batch", "merged_partials"])
@pytest.mark.parametrize("keys", list(WIDE_KEYS.values()),
                         ids=list(WIDE_KEYS))
def test_packed_sort_route_matches_jax(keys, batch_rows, monkeypatch):
    packed = _spy(monkeypatch, X._AggKernels, "_packed_sort_agg")
    conf = None if batch_rows is None else \
        {"spark.rapids.sql.reader.batchSizeRows": batch_rows}
    # limb sums are exact: every column equal, floats included
    _both(lambda api, df: df.group_by(*keys).agg(*_packed_aggs(api)),
          _wide_table(), approx=None, conf=conf)
    assert packed


def test_group_layout_and_seg_sums_match_jax():
    import jax.numpy as jnp
    from spark_rapids_tpu.ops import radix as JR
    from spark_rapids_tpu_torch.ops import radix as R
    rng = np.random.default_rng(12)
    cap, n = 4096, 3500
    packed = rng.integers(0, 1 << 30, cap).astype(np.int64) % 997
    live = np.arange(cap) < n
    packed[~live] = 1 << 62
    vals = rng.normal(0, 1e6, cap)
    vals[::97] = np.nan
    valid = rng.random(cap) < 0.9
    jl = JR.group_layout(jnp.asarray(packed), jnp.asarray(live))
    pl = R.group_layout(torch.from_numpy(packed), torch.from_numpy(live))
    for f in ("perm", "sorted_packed", "boundary", "gid", "starts", "ends"):
        np.testing.assert_array_equal(getattr(pl, f).numpy(),
                                      np.asarray(getattr(jl, f)))
    assert int(pl.n_groups) == int(jl.n_groups)
    perm = np.asarray(jl.perm)
    js = JR.seg_sum_f64(jnp.asarray(vals[perm]),
                        jnp.asarray(valid[perm] & live[perm]), jl)
    ps = R.seg_sum_f64(torch.from_numpy(vals[perm]),
                       torch.from_numpy(valid[perm] & live[perm]), pl)
    g = int(pl.n_groups)
    np.testing.assert_array_equal(ps.numpy()[:g].view(np.int64),
                                  np.asarray(js)[:g].view(np.int64))


# ---------------------------------------------------------------------------
# the slice as a whole: the three string query shapes
# ---------------------------------------------------------------------------

ROWS = 4096


@pytest.fixture(scope="module")
def text_tables():
    t = make_lineitem_text(ROWS)
    comments = t["l_comment"].combine_chunks()
    # a dictionary variant: the same text drawn from 40 comments
    rng = np.random.default_rng(9)
    few = comments.take(pa.array(rng.integers(0, 40, ROWS)))
    mixed = pc.if_else(pa.array(rng.random(ROWS) < 0.5),
                       pc.utf8_upper(few), few)
    d = t.set_column(t.schema.get_field_index("l_comment"), "l_comment",
                     mixed.cast(pa.string()))
    return {"flat": t, "dict": d}


def test_l_comment_is_flat_and_dict_variant_is_not(text_tables):
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    flat = from_arrow(text_tables["flat"], "cpu").columns[-1]
    dct = from_arrow(text_tables["dict"], "cpu").columns[-1]
    assert "offsets" in flat.data and dct.is_dict
    lens = pc.utf8_length(text_tables["flat"]["l_comment"])
    assert pc.min(lens).as_py() >= 10 and pc.max(lens).as_py() <= 43


@pytest.mark.parametrize("kind", ["flat", "dict"])
@pytest.mark.parametrize("word", ["FURIOUS", "SLY"])
def test_str_case_agg_matches_jax(kind, word, text_tables, monkeypatch):
    bucket = _spy(monkeypatch, X._AggKernels, "_bucket_update")
    got = _both(lambda api, df: str_case_agg(api, df, word),
                text_tables[kind])
    assert got.num_rows and bucket


@pytest.mark.parametrize("kind", ["flat", "dict"])
def test_str_group_flat_matches_jax(kind, text_tables, monkeypatch):
    sort = _spy(monkeypatch, X._AggKernels, "_sort_agg")
    got = _both(str_group_flat, text_tables[kind])
    assert sort and got.num_rows > (1000 if kind == "flat" else 10)


@pytest.mark.parametrize("kind", ["flat", "dict"])
@pytest.mark.parametrize("word", ["a", "s"])
def test_str_prefix_rows_matches_jax(kind, word, text_tables):
    got = _both(lambda api, df: str_prefix_rows(api, df, word),
                text_tables[kind])
    assert got.num_rows


def test_slice_launches_nothing_on_the_cpu(text_tables):
    before = CM.launches
    P = torch_api()
    str_case_agg(P, P.session().create_dataframe(text_tables["flat"])) \
        .collect()
    assert CM.launches == before
