"""The port's expressions of ``expr/core.py``, ``expr/math.py`` (greatest,
least, the bitwise and shift family) and ``expr/misc.py`` (rand) against
the JAX package.

Each test builds a small seeded table, runs the same projection through
both packages on the CPU (the port with ``device="cpu"``) and compares the
live rows in order. Every comparison here is exact: the expressions are
elementwise, and both packages compute each row with the same operations
(floats compare with ``==``, NaN equal to NaN; where the sign of a zero
matters the bits are compared too).
"""
import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
N = 2000


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(61)
    a = rng.integers(-60, 60, N).astype(np.int32)
    a[:4] = [I32.min, I32.max, -1, 0]
    b = rng.integers(-9, 10, N).astype(np.int64)
    b[:4] = [-1, -1, I64.min, I64.max]
    big = rng.integers(-2 ** 40, 2 ** 40, N).astype(np.int64)
    big[:3] = [I64.min, I64.max, -1]
    x = rng.normal(0, 50, N)
    x[4:12] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5, 1e300]
    f = rng.normal(0, 3, N).astype(np.float32)
    f[4:8] = [np.nan, -0.0, np.inf, 0.0]
    words = np.array(["alpha", "beta", "", "gamma delta", "é-ü"])
    return pa.table({
        "a": pa.array(a, mask=rng.random(N) < 0.1),
        "b": pa.array(b, mask=rng.random(N) < 0.1),
        "big": big,
        "x": pa.array(x, mask=rng.random(N) < 0.1),
        "f": f,
        "s": pa.array(np.array(["A", "N", "R"])[rng.integers(0, 3, N)],
                      mask=rng.random(N) < 0.05),
        "ls": np.array(["F", "O"])[rng.integers(0, 2, N)],
        # high-cardinality strings stay flat on upload
        "c": pa.array([f"{words[i % 5]}#{i}" for i in range(N)],
                      mask=rng.random(N) < 0.1),
        "ok": rng.random(N) < 0.5,
    })


def _both(table, build, cache=False, conf=None, parts=1):
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table, num_partitions=parts)
        if cache:
            df = df.cache()
        out.append(build(api, df).collect())
    return out


def _bits(t: pa.Table, name: str) -> np.ndarray:
    v = t[name].to_numpy(zero_copy_only=False)
    return np.asarray(v, np.float64).view(np.int64)


def _unary(api):
    c, F = api.col, api.F
    return [(-c("a")).alias("neg_a"), (-c("b")).alias("neg_b"),
            (-c("x")).alias("neg_x"), (-c("f")).alias("neg_f"),
            F.abs(c("a")).alias("abs_a"), F.abs(c("big")).alias("abs_big"),
            F.abs(c("x")).alias("abs_x"), F.abs(c("f")).alias("abs_f")]


def _int_div(api):
    c, lit, E = api.col, api.lit, api.E
    return [E.IntegralDivide(c("b"), c("a")).alias("b_div_a"),
            E.IntegralDivide(c("a"), lit(7)).alias("a_div_7"),
            E.IntegralDivide(c("big"), lit(-1)).alias("big_div_m1"),
            E.IntegralDivide(c("big"), c("b")).alias("big_div_b"),
            E.IntegralDivide(c("x"), lit(3)).alias("x_div_3"),
            (c("big") % lit(-1)).alias("big_rem_m1"),
            (c("a") % c("b")).alias("a_rem_b")]


def _null_safe(api):
    c, lit, E = api.col, api.lit, api.E
    return [E.EqualNullSafe(c("a"), c("b")).alias("ab"),
            E.EqualNullSafe(c("x"), lit(1.5)).alias("x15"),
            E.EqualNullSafe(c("s"), lit("N")).alias("sN"),
            E.EqualNullSafe(c("c"), c("c")).alias("cc"),
            E.EqualNullSafe(c("s"), c("ls")).alias("s_ls")]


def _nan_null(api):
    c, F = api.col, api.F
    return [F.isnan(c("x")).alias("nan_x"), F.isnan(c("f")).alias("nan_f"),
            F.isnull(c("x")).alias("null_x"), F.isnull(c("c")).alias("null_c")]


def _in(api):
    c = api.col
    return [c("a").isin(1, 2, 3).alias("a_in"),
            c("a").isin(1, None).alias("a_in_null"),
            c("x").isin(0.0, 1.5, float("inf")).alias("x_in"),
            c("s").isin("A", "R").alias("s_in"),
            c("c").isin("alpha#0", "beta#1", "x").alias("c_in"),
            c("ok").isin(True).alias("ok_in")]


def _case_numeric(api):
    c, lit, F, E = api.col, api.lit, api.F, api.E
    return [F.when(c("a") > lit(0), c("a")).when(c("x") < lit(0.0), c("x"))
            .otherwise(lit(-1)).alias("case3"),
            F.when(c("b") == lit(0), c("big")).alias("no_else"),
            F.when(c("ok"), lit(1.0)).otherwise(c("f")).alias("bool_pred"),
            E.If(c("a").is_null(), c("b"), c("a")).alias("if_null"),
            F.when(c("x") > lit(0.0), c("a")).when(c("x") < lit(0.0), c("b"))
            .alias("two_no_else")]


def _case_strings(api):
    c, lit, F, E = api.col, api.lit, api.F, api.E
    return [F.when(c("s") == lit("R"), lit("returned"))
            .when(c("s") == lit("A"), c("ls"))
            .otherwise(lit("none")).alias("dict_lit"),
            F.when(c("a") > lit(0), c("c")).otherwise(c("s"))
            .alias("flat_dict"),
            F.when(c("ok"), c("c")).alias("flat_no_else"),
            E.If(c("x") > lit(0.0), lit("pos"), c("c")).alias("lit_flat"),
            F.coalesce(c("s"), c("c"), lit("?")).alias("coalesce_s")]


def _nulls(api):
    c, lit, F, E = api.col, api.lit, api.F, api.E
    return [F.nullif(c("a"), lit(0)).alias("nullif_a"),
            F.nullif(c("x"), c("x")).alias("nullif_self"),
            F.nvl(c("x"), lit(-7.0)).alias("nvl_x"),
            F.coalesce(c("a"), c("b"), lit(99)).alias("coalesce_n"),
            E.NullOf(c("big")).alias("null_of"),
            F.nvl(F.nullif(c("s"), lit("A")), c("ls")).alias("nvl_s")]


def _markers(api):
    c, E = api.col, api.E
    return [E.KnownNotNull(c("big")).alias("knn"),
            E.KnownFloatingPointNormalized(c("x")).alias("kfpn"),
            E.NormalizeNaNAndZero(c("x")).alias("norm_x"),
            E.NormalizeNaNAndZero(c("f")).alias("norm_f"),
            E.AtLeastNNonNulls(2, c("a"), c("x"), c("c")).alias("at2"),
            E.AtLeastNNonNulls(1, c("f"), c("s")).alias("at1")]


def _extremes(api):
    c, lit, F = api.col, api.lit, api.F
    return [F.greatest(c("a"), c("b"), lit(-5)).alias("g_int"),
            F.least(c("a"), c("x")).alias("l_mixed"),
            F.greatest(c("x"), c("f")).alias("g_float"),
            F.least(c("b"), c("big")).alias("l_long")]


CASES = {"unary": _unary, "int_div": _int_div, "null_safe": _null_safe,
         "nan_null": _nan_null, "in": _in, "case_numeric": _case_numeric,
         "case_strings": _case_strings, "nulls": _nulls,
         "markers": _markers, "extremes": _extremes}


@pytest.mark.parametrize("cache", [False, True], ids=["arrow", "cached"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expressions_match_jax_exactly(case, cache, table):
    got, want = _both(table, lambda api, df: df.select(
        *CASES[case](api)), cache=cache)
    assert_tables_equal(got, want)
    if case == "markers":
        # NormalizeNaNAndZero turns -0.0 into 0.0: the bits must agree
        for name in ("norm_x", "norm_f"):
            g, w = _bits(got, name), _bits(want, name)
            ok = ~np.isnan(got[name].to_numpy(zero_copy_only=False)
                           .astype(np.float64))
            assert np.array_equal(g[ok], w[ok]), name


def test_integer_extremes_wrap_like_jax(table):
    got, want = _both(table, lambda api, df: df.select(
        *_unary(api), *_int_div(api)))
    d = got.to_pydict()
    # MIN_VALUE negates and abs-es to itself; MIN_VALUE div -1 wraps
    assert d["neg_a"][0] == I32.min and d["abs_a"][0] == I32.min
    assert d["big_div_m1"][0] == I64.min and d["big_rem_m1"][0] == 0
    assert_tables_equal(got, want)


def test_in_list_null_is_kleene(table):
    got, _ = _both(table, lambda api, df: df.select(
        api.col("a"), api.col("a").isin(1, None).alias("m")))
    for a, m in zip(got["a"].to_pylist(), got["m"].to_pylist()):
        assert m == (True if a == 1 else None)


@pytest.mark.parametrize("cache", [False, True], ids=["arrow", "cached"])
def test_string_in_list_with_null(cache, table):
    # the JAX package raises on a null in a string IN list (it evaluates
    # the untyped null literal as a string column), so this holds the
    # port to Spark's answer instead: true on a match, else null
    P = torch_api()
    df = P.session().create_dataframe(table)
    if cache:
        df = df.cache()
    got = df.select(P.col("s"), P.col("s").isin("A", None).alias("m"),
                    P.col("c"), P.col("c").isin("beta#1", None).alias("n")
                    ).to_pydict()
    assert got["m"] == [True if s == "A" else None for s in got["s"]]
    assert got["n"] == [True if c == "beta#1" else None for c in got["c"]]


def test_partition_ids_count_live_rows_across_batches(table):
    # 3 partitions of several 256-row batches, filtered: the ids count the
    # live rows of each partition across its batches
    conf = {"spark.rapids.sql.reader.batchSizeRows": 256}

    def build(api, df):
        c, lit, F = api.col, api.lit, api.F
        return df.filter(c("big") > lit(0)).select(
            c("big"), F.spark_partition_id().alias("pid"),
            F.monotonically_increasing_id().alias("mid"),
            (F.monotonically_increasing_id() + lit(1)).alias("mid1"))
    got, want = _both(table, build, conf=conf, parts=3)
    assert_tables_equal(got, want)
    d = got.to_pydict()
    for p in range(3):
        mids = [m for q, m in zip(d["pid"], d["mid"]) if q == p]
        assert mids == [(p << 33) + i for i in range(len(mids))]


def test_partition_context_outside_a_projection_raises(table):
    # an aggregate has no partition context: both packages run it on the
    # CPU over the input collected into partition 0 (a filter gets the
    # context on the device, below)
    got, want = _both(table, lambda api, df: df.agg(
        api.F.sum(api.F.monotonically_increasing_id()).alias("s")),
        parts=3)
    assert_tables_equal(got, want)
    assert got["s"].to_pylist() == [N * (N - 1) // 2]


def test_partition_context_in_a_filter_matches_jax(table):
    # the JAX package runs such a filter on the CPU over its input
    # collected into one partition; the port collects, then filters with
    # partition 0's context, on the device
    conf = {"spark.rapids.sql.reader.batchSizeRows": 256}

    def build(api, df):
        c, lit, F = api.col, api.lit, api.F
        return df.filter(c("big") > lit(0)).filter(
            (F.monotonically_increasing_id() % lit(7) == lit(3))
            & (F.spark_partition_id() == lit(0))
            & (F.rand(5) < lit(0.8))).select(c("big"))
    got, want = _both(table, build, conf=conf, parts=3)
    assert_tables_equal(got, want)
    assert 0 < got.num_rows < N // 7


@pytest.mark.parametrize("kind", ["int_div_zero", "cast_overflow"])
def test_ansi_errors_only_for_live_rows(kind, table):
    # the filtered-out rows still hold a zero divisor or an out-of-range
    # float in their planes: only a live one may raise
    conf = {"spark.sql.ansi.enabled": True}

    def build(api, df, keep_bad):
        c, lit, F, E, T = api.col, api.lit, api.F, api.E, api.T
        if kind == "int_div_zero":
            ok, expr = c("b") != lit(0), E.IntegralDivide(c("big"), c("b"))
        else:
            ok = F.abs(c("x")) < lit(1e6)
            expr = c("x").cast(T.INT32)
        return df.filter(lit(True) if keep_bad else ok).select(
            expr.alias("v"))
    results = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table)
        with pytest.raises(Exception, match="DIVIDE_BY_ZERO|CAST_OVERFLOW"):
            build(api, df, True).collect()
        results.append(build(api, df, False).collect())
    assert results[0].num_rows > N // 2
    assert_tables_equal(*results)


def test_cast_errors_name_their_roadmap_item(table):
    # string casts run on the device, with the JAX package's device
    # answer and no CPU node
    got, want = _both(table, lambda api, df: df.select(
        api.col("a").cast(api.T.STRING).alias("s"),
        api.col("ok").cast(api.T.STRING).alias("o")))
    assert_tables_equal(got, want)
    P = torch_api()
    s = P.session()
    s.create_dataframe(table).select(P.col("a").cast(P.T.STRING)).collect()
    report = s.last_meta.explain()
    assert "ROADMAP A9" not in report and "!" not in report


# ---------------------------------------------------------------------------
# the bitwise and shift family, and rand
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bits_table():
    rng = np.random.default_rng(62)
    n = 700
    i32 = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
    i32[:4] = [I32.min, I32.max, -1, 0]
    i64 = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    i64[:4] = [I64.min, I64.max, -1, 0]
    # distances -1, 0, width - 1, width, width + 3 and beyond, both signs
    d32 = np.resize([-1, 0, 31, 32, 35, 5, -33, 64], n).astype(np.int32)
    d64 = np.resize([-1, 0, 63, 64, 67, 9, -65, 128], n).astype(np.int32)
    # an int64 distance past int32 wraps when cast to the value's type
    dl = np.resize([-1, 0, 31, 32, 35, (1 << 32) + 3, -(1 << 40)], n)
    row = np.arange(n)
    null = row % 11 == 5
    return pa.table({
        "i": pa.array(i32, mask=null), "j": rng.integers(
            I32.min, I32.max, n, dtype=np.int64).astype(np.int32),
        "l": pa.array(i64, mask=row % 11 == 8),
        "m": rng.integers(I64.min, I64.max, n, dtype=np.int64),
        "d32": pa.array(d32, mask=row % 11 == 6), "d64": d64,
        "dl": dl.astype(np.int64)})


def _bitwise(api):
    c, lit, F, MA = api.col, api.lit, api.F, api.MA
    return [MA.BitwiseAnd(c("i"), c("j")).alias("and_i"),
            MA.BitwiseOr(c("i"), c("l")).alias("or_il"),
            MA.BitwiseXor(c("l"), c("m")).alias("xor_l"),
            MA.BitwiseAnd(c("l"), lit(0xFF)).alias("and_lit"),
            F.bitwise_not(c("i")).alias("not_i"),
            F.bitwise_not(c("l")).alias("not_l")]


def _shifts(api):
    c, lit, F = api.col, api.lit, api.F
    out = []
    for name, fn in (("shl", F.shiftleft), ("shr", F.shiftright),
                     ("shru", F.shiftrightunsigned)):
        out += [fn(c("i"), c("d32")).alias(f"{name}_i"),
                fn(c("l"), c("d64")).alias(f"{name}_l"),
                fn(c("i"), c("dl")).alias(f"{name}_i_long"),
                fn(c("m"), c("dl")).alias(f"{name}_m_long"),
                fn(c("i"), lit(-1)).alias(f"{name}_i_m1"),
                fn(c("l"), lit(64)).alias(f"{name}_l_64")]
    return out


@pytest.mark.parametrize("cache", [False, True], ids=["arrow", "cached"])
@pytest.mark.parametrize("case", ["bitwise", "shifts"])
def test_bitwise_and_shifts_match_jax_exactly(case, cache, bits_table):
    build = {"bitwise": _bitwise, "shifts": _shifts}[case]
    out = []
    for api in (torch_api(), jax_api()):
        from importlib import import_module
        api.MA = import_module(api.F.__name__.replace(
            "sql.functions", "expr.math"))
        df = api.session().create_dataframe(bits_table)
        if cache:
            df = df.cache()
        out.append(df.select(*build(api)).collect())
    got, want = out
    assert_tables_equal(got, want)
    if case == "shifts":
        d = got.to_pydict()
        # Java: MIN_VALUE >>> 31 is 1, -1 >>> -1 is 1, x << 32 is x
        assert d["shru_i_m1"][0] == 1 and d["shru_i_m1"][2] == 1
        assert d["shl_l_64"][1] == I64.max and d["shr_l_64"][0] == I64.min
        assert d["shl_i"][5] is None and d["shl_i"][6] is None


@pytest.mark.parametrize("parts", [1, 3])
def test_rand_in_a_projection_matches_jax(parts, table):
    # per partition, rand counts its live rows across 256-row batches
    conf = {"spark.rapids.sql.reader.batchSizeRows": 256}

    def build(api, df):
        c, lit, F = api.col, api.lit, api.F
        return df.filter(c("b") != lit(0)).select(
            c("big"), F.rand(11).alias("r"), F.rand(-3).alias("r_neg"),
            (F.rand() * lit(10.0)).alias("r10"),
            F.spark_partition_id().alias("pid"))
    got, want = _both(table, build, conf=conf, parts=parts)
    assert_tables_equal(got, want)
    for name in ("r", "r_neg", "r10"):
        assert np.array_equal(_bits(got, name), _bits(want, name))
    r = np.asarray(got["r"].to_numpy())
    assert ((r >= 0) & (r < 1)).all()
    if parts == 1:
        assert np.array_equal(r, H.splitmix_rand(got.num_rows, 11))
