"""The port's unions, grouping sets (Expand), ranges and the rest of the
DataFrame surface against the JAX package.

Each test builds the same program from a numpy seed, runs it through the
JAX package's session (on the CPU) and through ``TorchSession(device=
"cpu")``, and compares the live rows.

Tolerances:
- keys, integers, strings, counts, grouping ids and grouping() bits are
  exact, and so are rand values and the rows sample/random_split keep;
- float sums and means are held to a relative 1e-12 (they add in
  different orders where the JAX package plans partial -> exchange ->
  final over several partitions and the port collects, and on the routes
  that add in ``torch.sum``/``index_add_`` order); describe's stddev and
  mean cells, corr and cov (E[xy] - E[x]E[y] magnifies low bits) to a
  relative 1e-9;
- except the grouping-set sums of unrounded doubles in
  ``test_grouping_sets_match_jax``: where a string key sends the port to
  the sort route, it adds in ``index_add_`` order while the JAX package
  sums fixed-point limbs scaled per batch, and a four-row group of values
  near 10 came out 5.3e-11 from the exact sum in the JAX package (2.6e-14
  in the port). Those sums are held to an absolute 1e-12 x sum(|v|), the
  window tests' convention for sums added in different orders.
"""
import contextlib
import io

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.exec import fuse as JF
from spark_rapids_tpu.exec import tpu_nodes as JX
from spark_rapids_tpu.ops import pallas_segsum as JPS

from spark_rapids_tpu_torch.exec import fuse as PF
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
from spark_rapids_tpu_torch.ops import segsum as S

N = 3000
F64_TOL = 1e-12
STAT_TOL = 1e-9


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(71)
    return pa.table({
        "a": pa.array(rng.integers(0, 4, N).astype(np.int32),
                      mask=rng.random(N) < 0.08),
        "b": pa.array(rng.integers(-3, 3, N).astype(np.int64),
                      mask=rng.random(N) < 0.08),
        "s": pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, N)],
                      mask=rng.random(N) < 0.05),
        "v": pa.array(rng.normal(10, 3, N), mask=rng.random(N) < 0.05),
        "q": rng.integers(1, 51, N).astype(np.float64),
    })


def _both(build, tbl, parts=1, conf=None, cache=False):
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(tbl, num_partitions=parts)
        out.append(build(api, df.cache() if cache else df).collect())
    return out


def _equal(got, want, exact, approx=(), ordered=False, abs_tol=None):
    """The exact columns exactly; the approx ones to F64_TOL relative, or
    within abs_tol where given, row by row in the exact columns' order."""
    assert_tables_equal(got.select(exact), want.select(exact),
                        ignore_order=not ordered)
    if approx and abs_tol is None:
        assert_tables_equal(got.select(exact + list(approx)),
                            want.select(exact + list(approx)),
                            ignore_order=not ordered, approx_float=F64_TOL)
    elif approx:
        def rows(t):
            r = t.select(exact + list(approx)).to_pylist()
            return r if ordered else sorted(r, key=lambda x: [
                (x[k] is None, str(x[k])) for k in exact])
        for g, w in zip(rows(got), rows(want)):
            for c in approx:
                assert (g[c] is None) == (w[c] is None), (g, w)
                assert g[c] is None or abs(g[c] - w[c]) <= abs_tol, (g, w)


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("children", [2, 3])
def test_union_widens_and_keeps_partition_order(children, parts, table):
    # int32 UNION float64 widens to float64; nulls pass; the children's
    # partitions follow one another, so the rows compare in order
    def build(api, df):
        col, lit, T = api.col, api.lit, api.T
        first = df.filter(col("b") < lit(0)).select(col("a"), col("s"))
        second = df.select(col("v").alias("x"), col("s"))
        third = df.filter(col("a") == lit(1)).select(
            col("b").cast(T.INT32).alias("y"), lit("third").alias("s"))
        out = first.union(second)
        return out.union(third) if children == 3 else out
    got, want = _both(build, table, parts)
    assert got.schema.field("a").type == pa.float64()
    assert got.num_rows == want.num_rows > N
    _equal(got, want, ["a", "s"], ordered=True)


def test_union_of_two_dictionaries_groups_equal_strings(monkeypatch):
    # two caches with different vocabularies for the same strings: the
    # aggregate's concat must unify or flatten them, so each string
    # forms one group
    rng = np.random.default_rng(5)
    left = pa.table({"s": np.array(["pear", "fig", "kiwi"])[
        rng.integers(0, 3, 500)], "v": rng.integers(0, 9, 500)})
    right = pa.table({"s": np.array(["kiwi", "lime", "pear", "fig"])[
        rng.integers(0, 4, 700)], "v": rng.integers(0, 9, 700)})
    mixed = []
    orig = K._concat_columns

    def spy(cols, rows, cap):
        if cols[0].is_string and len({id(c.data.get("dict_bytes"))
                                      for c in cols if c.is_dict}) > 1:
            mixed.append(1)
        return orig(cols, rows, cap)
    monkeypatch.setattr(K, "_concat_columns", spy)
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        a = s.create_dataframe(left).cache()
        b = s.create_dataframe(right).cache()
        out.append(a.union(b).group_by("s").agg(
            api.F.count().alias("n"), api.F.sum("v").alias("sv")).collect())
    got, want = out
    _equal(got, want, ["s", "n", "sv"])
    assert sorted(got["s"].to_pylist()) == ["fig", "kiwi", "lime", "pear"]
    assert mixed


# ---------------------------------------------------------------------------
# Expand: rollup, cube, grouping sets
# ---------------------------------------------------------------------------

def _sets_aggs(api):
    col, F = api.col, api.F
    return [F.sum(col("v")).alias("sv"), F.count().alias("n"),
            F.max(col("q")).alias("mq"), F.grouping_id().alias("gid")]


#: name -> (build, key columns of the output, float columns)
GROUPINGS = {
    "rollup_1": (lambda api, df: df.rollup("a"), ["a"]),
    "rollup_2_string": (lambda api, df: df.rollup("s", "a"), ["s", "a"]),
    "rollup_3": (lambda api, df: df.rollup(
        "a", (api.col("b") % api.lit(2)).alias("b2"), "s"),
        ["a", "b2", "s"]),
    "cube_2": (lambda api, df: df.cube("a", "b"), ["a", "b"]),
    "cube_3_string": (lambda api, df: df.cube("s", "a", "b"),
                      ["s", "a", "b"]),
    "sets_by_index": (lambda api, df: df.grouping_sets(
        [(0, 1), (1,), ()], "a", "s"), ["a", "s"]),
    "sets_by_name": (lambda api, df: df.grouping_sets(
        [("b", "a"), ("s",), ("a",)], "a", "b", "s"), ["a", "b", "s"]),
}


@pytest.mark.parametrize("shape", sorted(GROUPINGS))
def test_grouping_sets_match_jax(shape, table):
    grouped, keys = GROUPINGS[shape]
    got, want = _both(lambda api, df: grouped(api, df).agg(*_sets_aggs(api)),
                      table)
    v = table["v"].to_numpy(zero_copy_only=False)
    _equal(got, want, keys + ["n", "mq", "gid"], ["sv"],
           abs_tol=1e-12 * np.nansum(np.abs(v)))
    assert got.num_rows == want.num_rows > 3


def test_grouping_markers_and_key_nulls_stay_apart(table):
    # a null key value (gid 0) and the rolled-up null (gid 1) are
    # different rows; grouping() reads each key's bit
    def build(api, df):
        col, F = api.col, api.F
        return df.rollup("a", "b").agg(
            F.count().alias("n"), F.grouping(col("a")).alias("ga"),
            F.grouping(col("b")).alias("gb"),
            F.grouping_id().alias("gid"))
    got, want = _both(build, table, parts=3)
    _equal(got, want, ["a", "b", "n", "ga", "gb", "gid"])
    rows = got.to_pylist()
    null_b = {(r["a"], r["gid"]) for r in rows if r["b"] is None}
    assert any(g == 0 for _, g in null_b) and any(g == 1 for _, g in null_b)
    assert all(r["gid"] == 2 * r["ga"] + r["gb"] for r in rows)
    assert {r["gid"] for r in rows} == {0, 1, 3}


def test_grouping_outside_grouping_sets_raises(table):
    api = torch_api()
    df = api.session().create_dataframe(table)
    with pytest.raises(api.E.SparkException, match="ROLLUP"):
        df.group_by("a").agg(api.F.grouping(api.col("a"))).collect()
    with pytest.raises(api.E.SparkException, match="not a group-by key"):
        df.rollup("a").agg(api.F.grouping(api.col("b"))).collect()


def _expand_form_jax(session) -> str:
    """'stacked' when the JAX package fused the Expand (a fused stage or
    an aggregate's absorbed chain), else 'per_projection'."""
    forms = []

    def walk(e):
        members = (getattr(e, "members", None) or []) \
            + (getattr(e, "pre_chain_members", None) or [])
        if any(isinstance(m, JX.ExpandExec) for m in members):
            forms.append("stacked")
        elif isinstance(e, JX.ExpandExec):
            forms.append("per_projection")
        for c in e.children:
            walk(c)
    walk(session._last_exec)
    assert len(forms) == 1, forms
    return forms[0]


class _UpdateRoutes:
    """Per aggregate update, 'packed' or 'general', in both packages: the
    update's dispatch keys through each package's ``fuse.fused`` (the
    port's take the JAX package's key families since stage fusion)."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        for mod, out in ((PF, self.port), (JF, self.jax)):
            monkeypatch.setattr(mod, "fused", self._spy(mod.fused, out))

    @staticmethod
    def _spy(orig_fused, out):
        def fused(key, builder):
            name = key[0] if isinstance(key, tuple) else ""
            if name == "hashagg_packed_update":
                out.append("packed")
            elif name in ("hashagg_update", "hashagg_chain_update"):
                out.append("general")
            return orig_fused(key, builder)
        return fused


def _run_with_sessions(build, tbl):
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        out.append((s, build(api, s.create_dataframe(tbl).cache()).collect()))
    return out


@pytest.fixture(scope="module")
def lineitem():
    return H.make_lineitem(20_000)


def test_rollup_shipdate_stacks_and_takes_chunked_segsum(lineitem,
                                                         monkeypatch):
    # computed keys make the JAX package fuse the fixed-width Expand into
    # one batch of 3 x 32768 rows: three chunks of 32768. Ship dates in
    # [8750, 8950] span 2 years and 29 weeks, so the packed key takes 12
    # bits and the chunk gate passes (3 x 2^12 <= 32768), as twelve
    # 2^23-row chunks with 18 bits pass it at 30M rows
    monkeypatch.setattr(JPS, "CHUNK_ROWS", 32768)
    monkeypatch.setattr(S, "CHUNK_ROWS", 32768)
    routes = _UpdateRoutes(monkeypatch)
    chunks, jax_chunks = [], []
    orig = X._AggKernels._chunked_segsum_agg
    jorig = JX._AggKernels._chunked_pallas_agg

    def spy(kern, live, key_cols, specs, spec, ranges, k):
        chunks.append(k)
        return orig(kern, live, key_cols, specs, spec, ranges, k)

    def jspy(kern, *a, **kw):
        jax_chunks.append(1)
        return jorig(kern, *a, **kw)
    monkeypatch.setattr(X._AggKernels, "_chunked_segsum_agg", spy)
    monkeypatch.setattr(JX._AggKernels, "_chunked_pallas_agg", jspy)
    def build(api, df):
        col, lit = api.col, api.lit
        return H.rollup_shipdate(api, df.filter(
            (col("l_shipdate") >= lit(8750))
            & (col("l_shipdate") <= lit(8950))))
    (ts, got), (js, want) = _run_with_sessions(build, lineitem)
    _equal(got, want, ["ship_year", "ship_week", "n"], ["rev"])
    assert _expand_form_jax(js) == "stacked"
    assert [e.stacked for e in ts.last_exec.walk()
            if isinstance(e, X.ExpandExec)] == [True]
    assert routes.port == routes.jax == ["packed"]
    assert chunks == [3] and jax_chunks
    assert got.num_rows == 30 + 2 + 1


def test_q1_rollup_runs_one_batch_per_grouping_set(lineitem, monkeypatch):
    routes = _UpdateRoutes(monkeypatch)
    (ts, got), (js, want) = _run_with_sessions(H.q1_rollup, lineitem)
    _equal(got, want, ["l_returnflag", "l_linestatus", "n", "gid"],
           ["sum_qty", "sum_price", "avg_disc"])
    assert _expand_form_jax(js) == "per_projection"
    assert [e.stacked for e in ts.last_exec.walk()
            if isinstance(e, X.ExpandExec)] == [False]
    assert routes.port == routes.jax and len(routes.port) == 3
    assert got.num_rows == 6 + 3 + 1


def test_float_key_expand_is_absorbed_and_stacked(table, monkeypatch):
    # a float key keeps the aggregate off the packed route, so the JAX
    # package absorbs the Expand into the aggregate's update
    routes = _UpdateRoutes(monkeypatch)

    def build(api, df):
        col = api.col
        return df.select(col("a"), col("v"), col("q")).rollup(
            "v", "a").agg(api.F.sum(col("q")).alias("sq"),
                          api.F.count().alias("n"))
    (ts, got), (js, want) = _run_with_sessions(build, table)
    _equal(got, want, ["v", "a", "n"], ["sq"])
    assert _expand_form_jax(js) == "stacked"
    assert [e.stacked for e in ts.last_exec.walk()
            if isinstance(e, X.ExpandExec)] == [True]
    assert routes.port == routes.jax == ["general"]


def test_cube_flags_matches_jax(lineitem):
    got, want = _both(H.cube_flags, lineitem, cache=True)
    _equal(got, want, ["l_returnflag", "l_linestatus", "n", "g_rf", "g_ls"],
           ["sum_qty"])
    assert got.num_rows == 6 + 3 + 2 + 1


# ---------------------------------------------------------------------------
# Range
# ---------------------------------------------------------------------------

RANGES = {
    "ascending": (3, 5000, 7, 1),
    "descending": (100, -50, -3, 1),
    "empty": (5, 5, 1, 2),
    "negative_step_empty": (0, 10, -1, 1),
    "partitions": (-20, 3001, 2, 3),
}


@pytest.mark.parametrize("name", sorted(RANGES))
def test_range_matches_jax(name):
    start, end, step, parts = RANGES[name]
    out = []
    conf = {"spark.rapids.sql.reader.batchSizeRows": 500}
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        out.append(s.range(start, end, step, num_partitions=parts)
                   .collect())
    got, want = out
    assert got.column_names == ["id"] and got.schema.field("id").type \
        == pa.int64()
    _equal(got, want, ["id"], ordered=True)
    assert got["id"].to_pylist() == list(range(start, end, step))


def test_range_batches_and_device_values():
    api = torch_api()
    s = api.session({"spark.rapids.sql.reader.batchSizeRows": 1000})
    df = s.range(0, 7000, 1, num_partitions=3)
    s.collect(df.plan)
    root = s.last_exec
    sizes = [[int(b.num_rows) for b in root.execute_partition(p)]
             for p in range(3)]
    assert sizes == [[1000, 1000, 334]] + [[1000, 1000, 333]] * 2
    assert s.range(10).count() == 10 and s.range(2, 2).count() == 0


def test_range_agg_matches_closed_form():
    got, want = [], []
    for api in (torch_api(), jax_api()):
        s = api.session({"spark.rapids.sql.reader.batchSizeRows": 4096})
        got.append(H.range_agg(api, s, n=50_000, parts=3, m=1009).collect())
    _equal(got[0], got[1], ["k", "s", "n"])
    k, sums, counts = H.range_agg_answer(50_000, 1009)
    d = {r["k"]: (r["s"], r["n"]) for r in got[0].to_pylist()}
    assert d == {int(a): (int(b), int(c)) for a, b, c in zip(k, sums, counts)}


# ---------------------------------------------------------------------------
# set operations, pivot, crosstab
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(9)
    n = 400
    return pa.table({
        "k": pa.array(rng.integers(0, 6, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "t": pa.array(np.array(["u", "v", ""])[rng.integers(0, 3, n)],
                      mask=rng.random(n) < 0.1),
        "x": pa.array(rng.integers(0, 3, n).astype(np.float64),
                      mask=rng.random(n) < 0.1),
    })


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("op", ["intersect", "subtract"])
def test_set_operations_are_null_safe_and_positional(op, parts, pairs):
    # the other side's columns are renamed and reordered: pairing is by
    # position; nulls match nulls, and "" and 0 stay apart from them
    def build(api, df):
        col, lit = api.col, api.lit
        mine = df.filter(col("x") != lit(2.0)).select("k", "t")
        other = df.filter(col("k") != lit(3)).select(
            col("k").alias("kk"), col("t").alias("tt"))
        return getattr(mine, op)(other)
    got, want = _both(build, pairs, parts)
    _equal(got, want, ["k", "t"])
    rows = got.to_pylist()
    assert len({(r["k"], r["t"]) for r in rows}) == len(rows) > 0
    if op == "intersect":
        assert any(r["k"] is None or r["t"] is None for r in rows)


def test_set_operation_arity_mismatch_raises(pairs):
    api = torch_api()
    df = api.session().create_dataframe(pairs)
    with pytest.raises(api.E.SparkException, match="same number"):
        df.subtract(df.select("k"))


def test_orders_setops_matches_jax(monkeypatch):
    _, orders = H.make_tables(10_000)
    got, want = _both(H.orders_setops, orders, parts=3, cache=True)
    _equal(got, want, ["op", "n", "sum_ok", "sum_ck"], ordered=True)
    assert got["op"].to_pylist() == ["intersect", "except"]


@pytest.mark.parametrize("values", ["inferred", "explicit"])
def test_pivot_matches_jax(values, pairs):
    # the null pivot value is a column of its own; a count of a
    # (key, value) pair without rows is null, not 0
    def build(api, df):
        col, F = api.col, api.F
        vals = None if values == "inferred" else [0.0, 1.0, 2.0, None, 7.0]
        return df.group_by("t").pivot("x", vals).agg(
            F.count().alias("n"), F.sum(col("k")).alias("sk"),
            F.min_by(col("k"), col("x")).alias("mk"))
    got, want = _both(build, pairs)
    names = got.column_names
    assert names == want.column_names
    assert names[:4] == ["t", "null_n", "null_sk", "null_mk"] \
        or names[:4] == ["t", "0.0_n", "0.0_sk", "0.0_mk"]
    _equal(got, want, names)
    if values == "explicit":
        assert got["7.0_n"].null_count == got.num_rows
    cnt = pa.table({"x": pa.array([1.0, None, 2.0]), "g": ["a", "b", "b"]})
    got, want = _both(lambda api, df: df.group_by("g").pivot("x").agg(
        api.F.count()), cnt)
    _equal(got, want, got.column_names)
    row_a = [r for r in got.to_pylist() if r["g"] == "a"][0]
    assert row_a["null"] is None and row_a["1.0"] == 1


def test_pivot_flags_matches_jax(lineitem):
    # the smoke's pivot: values inferred by the eager distinct, then nine
    # gated aggregates on the tiny-bucket route
    got, want = _both(H.pivot_flags, lineitem, cache=True)
    assert got.column_names == want.column_names == [
        "l_linestatus", "A_price", "A_n", "N_price", "N_n", "R_price",
        "R_n"]
    _equal(got, want, ["l_linestatus", "A_n", "N_n", "R_n"],
           ["A_price", "N_price", "R_price"])
    assert got.num_rows == 2


def test_crosstab_matches_jax(pairs):
    got, want = _both(lambda api, df: df.crosstab("t", "k"), pairs)
    assert got.column_names == want.column_names
    _equal(got, want, got.column_names)
    assert got.column_names[0] == "t_k"
    assert all(got[c].null_count == 0 for c in got.column_names[1:])


# ---------------------------------------------------------------------------
# dropna, fillna, drop, rename, show, head/take/first
# ---------------------------------------------------------------------------

DROPNA = {"any": dict(), "all": dict(how="all"), "thresh": dict(thresh=2),
          "subset": dict(subset=["k", "x"])}


@pytest.mark.parametrize("mode", sorted(DROPNA))
def test_dropna_matches_jax(mode, pairs):
    # every 17th x a NaN (missing to dropna), and five rows all missing
    x = [float("nan") if i % 17 == 0 else v
         for i, v in enumerate(pairs["x"].to_pylist())]
    nan = pa.table({"k": [None] * 5 + pairs["k"].to_pylist()[5:],
                    "t": [None] * 5 + pairs["t"].to_pylist()[5:],
                    "x": [None] * 4 + [float("nan")] + x[5:]},
                   schema=pairs.schema)
    got, want = _both(lambda api, df: df.dropna(**DROPNA[mode]), nan)
    _equal(got, want, ["k", "t", "x"], ordered=True)
    assert 0 < got.num_rows < nan.num_rows


@pytest.mark.parametrize("fill", ["numeric", "string", "subset"])
def test_fillna_matches_jax(fill, pairs):
    args = {"numeric": (1.5,), "string": ("?",),
            "subset": (-7, ["x"])}[fill]
    got, want = _both(lambda api, df: df.fillna(*args), pairs)
    _equal(got, want, ["k", "t", "x"], ordered=True)
    assert got.schema == pairs.schema
    filled = {"numeric": ["k", "x"], "string": ["t"], "subset": ["x"]}[fill]
    assert all(got[c].null_count == 0 for c in filled)
    assert all(got[c].null_count == pairs[c].null_count
               for c in got.column_names if c not in filled)


def test_drop_and_rename_match_jax(pairs):
    def build(api, df):
        return (df.drop("t", "missing").withColumnRenamed("X", "ratio")
                .with_column_renamed("k", "key"))
    got, want = _both(build, pairs)
    assert got.column_names == want.column_names == ["key", "ratio"]
    _equal(got, want, ["key", "ratio"], ordered=True)
    api = torch_api()
    df = api.session().create_dataframe(pairs)
    with pytest.raises(api.E.SparkException, match="every column"):
        df.drop("k", "t", "x")
    assert df.dtypes == [("k", "int64"), ("t", "string"), ("x", "float64")]


def test_show_head_take_first_match_jax(pairs):
    outs = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(pairs, num_partitions=3) \
            .filter(api.col("k") > api.lit(0))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            df.show(30)
            df.show(3, truncate=1)
            df.limit(2).show()
            df.print_schema()
        outs.append((buf.getvalue(), df.head(), df.head(1), df.take(4),
                     df.first(), df.filter(api.col("k") > api.lit(99))
                     .head(), df.to_pandas()))
    assert outs[0][:6] == outs[1][:6]
    assert outs[0][6].equals(outs[1][6])  # NaN equal to NaN
    text = outs[0][0]
    assert "only showing top 30 rows" in text and "NULL" in text
    assert outs[0][5] is None and len(outs[0][3]) == 4


# ---------------------------------------------------------------------------
# describe, corr, cov, approx_quantile
# ---------------------------------------------------------------------------

def _cells(t: pa.Table):
    return {c: t[c].to_pylist() for c in t.column_names}


def test_describe_corr_cov_match_jax(lineitem):
    small = lineitem.slice(0, 5000)
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(small, num_partitions=3)
        table, corr = H.describe_li(api, df)
        out.append((_cells(table), corr,
                    df.cov("l_quantity", "l_discount"),
                    df.select("l_orderkey", "l_shipdate").describe()
                    .columns))
    (got, corr, cov, names), (want, jcorr, jcov, jnames) = out
    assert got["summary"] == want["summary"] == \
        ["count", "mean", "stddev", "min", "max"]
    for c in H.DESCRIBE_COLS:
        assert got[c][0] == want[c][0] == "5000"
        assert got[c][3:] == want[c][3:]  # min and max, exactly
        for g, w in zip(got[c][1:3], want[c][1:3]):
            assert abs(float(g) - float(w)) <= STAT_TOL * abs(float(w))
    assert abs(corr - jcorr) <= STAT_TOL * abs(jcorr)
    assert abs(cov - jcov) <= STAT_TOL * abs(jcov)
    assert names == jnames == ["summary", "l_orderkey", "l_shipdate"]


def test_describe_of_a_string_column_raises_naming_a3(pairs):
    # min/max over strings is tagged to the CPU in both packages: the
    # whole aggregate runs there, with the same cells
    out = [_cells(api.session().create_dataframe(pairs, num_partitions=3)
                  .describe("t", "x").collect())
           for api in (torch_api(), jax_api())]
    assert out[0] == out[1]
    assert out[0]["t"][0] == str(len(pairs["t"].drop_null()))
    assert out[0]["t"][3:] == ["", "v"]


def test_approx_quantile_matches_jax(pairs):
    probs = [0.0, 0.1, 0.5, 0.99, 1.0]
    out = [api.session().create_dataframe(pairs).approx_quantile("x", probs)
           for api in (torch_api(), jax_api())]
    assert out[0] == out[1] and out[0][0] == 0.0 and out[0][-1] == 2.0


# ---------------------------------------------------------------------------
# sample and random_split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
def test_sample_and_random_split_keep_the_jax_rows(parts, lineitem):
    # several 1500-row batches per partition: rand counts the rows of the
    # input collected into one partition, as the JAX package's CPU filter
    # does
    conf = {"spark.rapids.sql.reader.batchSizeRows": 1500}
    small = lineitem.slice(0, 8000).append_column(
        "row", pa.array(np.arange(8000)))
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(small, num_partitions=parts)
        out.append([df.sample(0.1, seed=7).collect()]
                   + [d.collect() for d in df.random_split([1, 2, 3],
                                                           seed=5)])
    for got, want in zip(*out):
        _equal(got, want, got.column_names, ordered=True)
    r = H.splitmix_rand(8000, 7)
    assert out[0][0]["row"].to_pylist() == np.nonzero(r < 0.1)[0].tolist()
    split_rows = sorted(x for t in out[0][1:] for x in t["row"].to_pylist())
    assert split_rows == list(range(8000))


def test_sample_li_matches_numpy_stream(lineitem):
    got, want = _both(H.sample_li, lineitem, cache=True)
    _equal(got, want, ["n", "s"])
    keep = H.splitmix_rand(lineitem.num_rows, 11) < 0.01
    okey = lineitem["l_orderkey"].to_numpy()
    assert got.to_pylist() == [{"n": int(keep.sum()),
                                "s": int(okey[keep].sum())}]


def test_rand_outside_projection_or_filter_raises(table):
    # an aggregate of rand runs on the CPU in both packages, drawing the
    # device stream over the input collected into partition 0
    got, want = _both(lambda api, df: df.group_by("a").agg(
        api.F.sum(api.F.rand(3)).alias("r"), api.F.count().alias("n")),
        table, parts=3)
    _equal(got, want, ["a", "n", "r"])


# ---------------------------------------------------------------------------
# the smoke's union shape
# ---------------------------------------------------------------------------

def test_union_repart_hashes_every_union_batch(lineitem, monkeypatch):
    launches = []
    orig = MK.murmur3_int32

    def spy(values, seed):
        launches.append(values.shape[0])
        return orig(values, seed)
    monkeypatch.setattr(MK, "murmur3_int32", spy)
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        many = s.create_dataframe(lineitem, num_partitions=3).cache()
        one = s.create_dataframe(lineitem).cache()
        out.append(H.union_repart(api, many, one).collect())
        if not out[1:]:
            # the port's plan: a union of 4 partitions below a hash
            # exchange, a cast projection over the first child's
            ops = {type(e).__name__ for e in s.last_exec.walk()}
            assert {"UnionExec", "ShuffleExchangeExec",
                    "ProjectExec"} <= ops
            assert len(launches) == 4
    got, want = out
    _equal(got, want, ["l_shipdate", "n"], ["sum_qty"])
    assert got.schema.field("sum_qty").type == pa.float64()
    assert got.num_rows == len(set(lineitem["l_shipdate"].to_pylist()))
