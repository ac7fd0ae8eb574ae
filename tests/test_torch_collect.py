"""Array columns and collect_list/collect_set in the port against the JAX
package: ints, floats with NaN and signed zeros, decimals, flat and
dictionary strings and nulls, over 1 and 3 partitions, with and without
keys; groups left empty once nulls are dropped; an array column through
filter, sort, limit, union and the collect to the host; the array gather
and concatenation; and the incompatibleOps tag of collect_set over
strings.

Tolerance: none. Every list equals the JAX package's element for element,
in the same order (collect_list: the stable input order after the
exchange; collect_set: the normalized key's order on the device, the
value order on the CPU), with one stated exception: collect_set of a
flat string column behind a hash exchange is compared as a set. The JAX
package's exchange re-encodes a flat string column as a dictionary whose
vocabulary it unions on the host, so its device collect_set then orders
by code; the port's exchange keeps the column flat (no host loop over a
vocabulary that may hold every row's string) and orders by the 64-bit
string hash, as both packages do without an exchange. Spark leaves the
order open (ROADMAP C).
"""
import decimal
import math

import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.ops import kernels as K

D = decimal.Decimal
N = 2400
INPUTS = ("i", "f", "d", "flat", "dict")


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(21)
    f = rng.integers(-3, 4, N).astype(np.float64)
    f[rng.random(N) < 0.05] = np.nan
    f[rng.random(N) < 0.05] = -0.0
    return pa.table({
        "k": rng.integers(0, 50, N).astype(np.int32),
        "g": np.array(["x", "y", "z"])[rng.integers(0, 3, N)],
        "i": pa.array(rng.integers(0, 9, N).astype(np.int64),
                      mask=rng.random(N) < 0.2),
        "f": pa.array(f, mask=rng.random(N) < 0.1),
        "d": H.decimal_array(rng.integers(-30, 30, N) * 5, 7, 2,
                             mask=rng.random(N) < 0.1),
        # nearly all distinct: a flat string column
        "flat": pa.array([f"w{j % 2000}" for j in rng.permutation(N)],
                         mask=rng.random(N) < 0.1),
        # a small vocabulary: a dictionary column
        "dict": pa.array(np.array(["aa", "b", "ccc", "dd"])[
            rng.integers(0, 4, N)], mask=rng.random(N) < 0.1),
    })


def _run(build, table, parts=1, conf=None):
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table, num_partitions=parts)
        out.append(build(api, df).collect())
    return out


def _same(a, b) -> bool:
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, float):
        # -0.0 and 0.0 are one set member: the same bits besides
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    return a == b


def _assert_same(got, want, keys, as_sets=()):
    assert got.schema == want.schema
    g = sorted(got.to_pylist(), key=lambda r: [str(r[k]) for k in keys])
    w = sorted(want.to_pylist(), key=lambda r: [str(r[k]) for k in keys])
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for c in rw:
            if c in as_sets:
                assert sorted(rg[c]) == sorted(rw[c]), (c, rg, rw)
                assert len(set(rg[c])) == len(rg[c])
            else:
                assert _same(rg[c], rw[c]), (c, rg, rw)


def _collects(api):
    F, col = api.F, api.col
    out = []
    for c in INPUTS:
        out += [F.collect_list(col(c)).alias(f"l_{c}"),
                F.collect_set(col(c)).alias(f"s_{c}")]
    return out


@pytest.mark.parametrize("keys", [("k",), ("g",), ("k", "g"), ()])
@pytest.mark.parametrize("parts", [1, 3])
def test_collect_matches_jax(table, keys, parts):
    def build(api, df):
        return (df.group_by(*keys) if keys else df).agg(*_collects(api))
    got, want = _run(build, table, parts)
    assert got.schema.field("l_d").type == pa.list_(pa.decimal128(7, 2))
    _assert_same(got, want, keys, as_sets=("s_flat",) if parts > 1 else ())


def test_collect_list_keeps_the_input_order(table):
    P = torch_api()
    got = P.session().create_dataframe(table, num_partitions=3).group_by(
        "k").agg(P.F.collect_list(P.col("i")).alias("l")).collect()
    k = table["k"].to_numpy()
    i = table["i"].to_pylist()
    for row in got.to_pylist():
        assert row["l"] == [v for kk, v in zip(k, i)
                            if kk == row["k"] and v is not None]


def test_collect_set_drops_duplicates_and_keeps_one_nan(table):
    P = torch_api()
    got = P.session().create_dataframe(table).agg(
        P.F.collect_set(P.col("f")).alias("s")).collect()
    [s] = got["s"].to_pylist()
    assert sum(1 for v in s if v != v) == 1
    assert len(s) == 8  # -3 .. 3 (-0.0 and 0.0 are one) and NaN


@pytest.mark.parametrize("parts", [1, 3])
def test_groups_empty_after_nulls(parts):
    t = pa.table({"k": np.array([1, 1, 2, 3, 3, 3], np.int32),
                  "v": pa.array([None, None, 5, None, 7, 7], pa.int64()),
                  "s": pa.array([None, "a", None, "b", None, "b"])})
    got, want = _run(lambda api, df: df.group_by("k").agg(
        api.F.collect_list(api.col("v")).alias("lv"),
        api.F.collect_set(api.col("v")).alias("sv"),
        api.F.collect_set(api.col("s")).alias("ss")), t, parts)
    _assert_same(got, want, ["k"])
    rows = {r["k"]: r for r in got.to_pylist()}
    assert rows[1]["lv"] == [] and rows[1]["ss"] == ["a"]
    assert rows[2]["ss"] == [] and rows[3]["sv"] == [7]


def test_collect_of_no_rows_is_an_empty_list(table):
    got, want = _run(lambda api, df: df.filter(
        api.col("k") > api.lit(100)).agg(
        api.F.collect_list(api.col("i")).alias("l"),
        api.F.collect_set(api.col("dict")).alias("s")), table, 3)
    assert got.to_pylist() == want.to_pylist() == [{"l": [], "s": []}]


# ---------------------------------------------------------------------------
# an array column downstream of the aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
def test_array_column_through_filter_sort_limit_union(table, parts):
    def build(api, df):
        col, lit = api.col, api.lit
        g = df.group_by("k").agg(
            api.F.collect_list(col("flat")).alias("words"),
            api.F.collect_set(col("d")).alias("decs"),
            api.F.count().alias("n"))
        kept = g.filter(col("k") % lit(3) == lit(0)).select(
            "k", "words", "decs")
        both = kept.union(kept.filter(col("k") < lit(20)))
        return both.sort(col("k").desc()).limit(13)
    got, want = _run(build, table, parts)
    assert got.num_rows == 13
    _assert_same(got, want, ["k"])
    assert [r["k"] for r in got.to_pylist()] == \
        [r["k"] for r in want.to_pylist()]


def test_array_gather_and_concat():
    t = pa.table({"a": pa.array([[1, 2], None, [], [3, None, 4], [5]],
                                pa.list_(pa.int32())),
                  "s": pa.array([["x"], ["yy", "z"], None, [], ["w"]],
                                pa.list_(pa.string()))})
    b = B.from_arrow(t, "cpu")
    import torch
    idx = torch.tensor([4, 3, -1, 0, 1, 3], dtype=torch.int64)
    g = K.gather_batch(b, idx, 6)
    want = t.take(pa.array([4, 3, 0, 0, 1, 3])).to_pylist()
    want[2] = {"a": None, "s": None}
    assert B.to_arrow(g, ["a", "s"]).to_pylist() == want
    cat = K.concat_batches([b, g])
    assert B.to_arrow(cat, ["a", "s"]).to_pylist() == t.to_pylist() + want
    masked = K.mask_filter_batch(b, torch.tensor(
        [True, False, True, True, False] + [False] * (b.capacity - 5)))
    assert B.to_arrow(K.compact_batch(masked), ["a", "s"]).to_pylist() == \
        t.take(pa.array([0, 2, 3])).to_pylist()
    assert B.to_arrow(K.concat_batches([masked, b]), ["a", "s"]).to_pylist() \
        == t.take(pa.array([0, 2, 3])).to_pylist() + t.to_pylist()


def test_arrays_round_trip_through_arrow():
    t = pa.table({
        "d": pa.array([[D("1.5"), None], None, [], [D("-2.25")]],
                      pa.list_(pa.decimal128(5, 2))),
        "f": pa.array([[float("nan")], [1.0, -0.0], None, []],
                      pa.list_(pa.float64())),
        "dt": pa.array([[18000, None], [], None, [1]], pa.list_(pa.date32())),
    })
    got = B.to_arrow(B.from_arrow(t, "cpu"), t.column_names)
    assert got.schema == t.schema
    for g, w in zip(got.to_pylist(), t.to_pylist()):
        for c in w:
            assert _same(g[c], w[c])
    # struct and map columns round-trip since the nested slice (A9c)
    st = pa.table({"m": pa.array([{"a": 1}, None]),
                   "mp": pa.array([[("a", 1)], None],
                                  pa.map_(pa.string(), pa.int64()))})
    assert B.to_arrow(B.from_arrow(st, "cpu"), st.column_names) \
        .to_pylist() == st.to_pylist()


# ---------------------------------------------------------------------------
# tagging
# ---------------------------------------------------------------------------

INCOMPAT_OFF = {"spark.rapids.sql.incompatibleOps.enabled": "false"}


@pytest.mark.parametrize("column", ["flat", "dict", "i"])
def test_incompatible_ops_tag_sends_string_sets_to_the_cpu(table, column):
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session(INCOMPAT_OFF)
        df = s.create_dataframe(table, num_partitions=3).group_by("k").agg(
            api.F.collect_set(api.col(column)).alias("s"),
            api.F.collect_list(api.col(column)).alias("l"))
        out.append(df.collect())
    _assert_same(*out, ["k"])
    P = torch_api()
    s = P.session(INCOMPAT_OFF)
    df = s.create_dataframe(table, num_partitions=3).group_by("k").agg(
        P.F.collect_set(P.col(column)).alias("s"))
    df.collect()
    report = s.last_meta.explain()
    on_cpu = "collect_set over strings dedups by 64-bit double-hash" in report
    assert on_cpu == (column != "i")
