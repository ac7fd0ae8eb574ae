"""DECIMAL64 in the port against the JAX package: the Arrow round trip,
literals, arithmetic and comparisons across scales, the casts (HALF_UP
scale-down), sum/avg/min/max on every aggregate route, group-by, join and
sort on decimal keys, a decimal Parquet file, and q1/q6 over a small
``lineitem_dec``.

Tolerances: decimal values, keys, counts and decimal sums are exact.
FLOAT64 results of row expressions (a decimal's value, a division, a
product past 18 digits) are within a relative 1e-15 (a few ulp): XLA
turns the JAX package's division by a power of ten into a product with
its reciprocal, where the port divides, correctly rounded, and a product
of two such values carries both roundings. Aggregates that
add floats (averages) are within a relative 1e-12, the tolerance of
their float counterparts.
"""
import decimal
import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.exec import nodes as X

D = decimal.Decimal
N = 3000
ROUTES = ("_global_update", "_bucket_update", "_sort_agg",
          "_packed_sort_agg", "_scatter_agg", "_chunked_segsum_agg",
          "_segsum_or_fallback")


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(12)
    mask = rng.random(N) < 0.1
    return pa.table({
        "k": rng.integers(0, 30, N).astype(np.int32),
        "kw": rng.integers(0, 5000, N).astype(np.int64) * 1_000_003,
        "kf": np.round(rng.uniform(0, 20, N)),
        "flag": np.array(["A", "N", "R"])[rng.integers(0, 3, N)],
        "a": H.decimal_array(rng.integers(-10 ** 8, 10 ** 8, N), 10, 2,
                             mask=mask),
        "b": H.decimal_array(rng.integers(-10 ** 9, 10 ** 9, N), 12, 4),
        "dk": H.decimal_array(rng.integers(-40, 40, N) * 25, 6, 2),
        "i": rng.integers(-500, 500, N).astype(np.int32),
        "f": rng.normal(0, 100, N),
    })


def _run(build, table, parts=1, conf=None):
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table, num_partitions=parts)
        out.append(build(api, df).collect())
    return out


def _same(a, b, tol=None) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y, tol)
                                        for x, y in zip(a, b))
    if isinstance(a, float):
        if math.isnan(a):
            return math.isnan(b)
        if tol is not None:
            return abs(a - b) <= tol * max(abs(a), abs(b))
    return a == b and type(a) is type(b)


def _assert_rows(got, want, keys=None, tol=None):
    assert got.schema == want.schema
    g, w = got.to_pylist(), want.to_pylist()
    if keys:
        g = sorted(g, key=lambda r: tuple(str(r[k]) for k in keys))
        w = sorted(w, key=lambda r: tuple(str(r[k]) for k in keys))
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for c in rw:
            assert _same(rg[c], rw[c], tol), (c, rg[c], rw[c])


class _Spy:
    def __init__(self, monkeypatch):
        self.hits = set()
        for name in ROUTES:
            orig = getattr(X._AggKernels, name)

            def spy(kern, *a, _name=name, _orig=orig, **k):
                self.hits.add(_name)
                return _orig(kern, *a, **k)
            monkeypatch.setattr(X._AggKernels, name, spy)


# ---------------------------------------------------------------------------
# Arrow in and out
# ---------------------------------------------------------------------------

def test_arrow_round_trip(table):
    t = pa.table({
        "p18": pa.array([D("999999999999999999"), D("-999999999999999999"),
                         None, D("0"), D("-1")], pa.decimal128(18, 0)),
        "s4": pa.array([D("-1.2345"), D("0.0001"), D("99.9999"), None,
                        D("-0.5000")], pa.decimal128(9, 4)),
    })
    for src in (t, table, t.slice(1, 3)):
        got = B.to_arrow(B.from_arrow(src, "cpu"), src.column_names)
        assert got.equals(src.combine_chunks())
    # the same planes as the JAX package's upload
    from spark_rapids_tpu.columnar import batch as JB
    jb = JB.from_arrow(t)
    tb = B.from_arrow(t, "cpu")
    for jc, tc in zip(jb.columns, tb.columns):
        v = np.asarray(jc.validity)
        assert np.array_equal(np.asarray(jc.data)[:5][v[:5]],
                              tc.data.numpy()[:5][v[:5]])


def test_a_value_past_int64_raises():
    words = np.array([5, 0, 0, 1], np.int64)  # the second value is 2^64
    arr = pa.Array.from_buffers(pa.decimal128(18, 0), 2,
                                [None, pa.py_buffer(words)])
    t = pa.table({"d": arr})
    with pytest.raises(OverflowError, match="64 bits"):
        B.from_arrow(t, "cpu")
    from spark_rapids_tpu.columnar import batch as JB
    with pytest.raises(OverflowError):
        JB.from_arrow(t)


def test_types_map_both_ways():
    for p, s in ((1, 0), (15, 2), (18, 18)):
        dt = TT.from_arrow(pa.decimal128(p, s))
        assert dt == TT.DecimalType(p, s) and TT.to_arrow(dt) == \
            pa.decimal128(p, s)
    with pytest.raises(NotImplementedError, match="18 digits"):
        TT.from_arrow(pa.decimal128(19, 2))
    assert TT.common_type(TT.DecimalType(10, 2), TT.DecimalType(12, 4)) \
        == TT.DecimalType(12, 4)
    assert TT.common_type(TT.DecimalType(17, 1), TT.DecimalType(5, 4)) \
        == TT.DecimalType(18, 4)
    assert TT.common_type(TT.DecimalType(10, 2), TT.INT64) \
        == TT.DecimalType(10, 2)
    assert TT.common_type(TT.DecimalType(10, 2), TT.FLOAT32) == TT.FLOAT64


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

def _exprs(api):
    col, lit = api.col, api.lit
    a, b, i, f = col("a"), col("b"), col("i"), col("f")
    return [
        (a + b).alias("add"), (a - b).alias("sub"), (b - a).alias("rsub"),
        (a * b).alias("mul_f64"), (col("dk") * col("dk")).alias("mul_dec"),
        (a * i).alias("mul_int"), (a / b).alias("div"),
        (a / i).alias("div_int"), (a + i).alias("add_int"),
        (a + f).alias("add_f64"), (a % col("nz")).alias("mod"),
        (-a).alias("neg"), api.F.abs(a).alias("abs"),
        (a + lit(D("1.5"))).alias("add_lit"),
        (a * lit(D("0.25"))).alias("mul_lit"),
        (a > b).alias("gt"), (a == b).alias("eq"), (a <= lit(D("0.5"))).alias(
            "le_lit"), (a < i).alias("lt_int"), (a >= f).alias("ge_f64"),
        lit(D("-12.340")).alias("lit"),
    ]


ULPS = 1e-15


@pytest.mark.parametrize("parts", [1, 3])
def test_arithmetic_and_comparisons(table, parts):
    def build(api, df):
        # a divisor without zeros: the JAX package's decimal remainder by
        # zero is a NaN that its collect cannot convert (ROADMAP C)
        nz = (api.col("dk") + api.lit(D("10.01"))).alias("nz")
        return df.with_column("nz", nz).select(*_exprs(api))
    got, want = _run(build, table, parts)
    assert got.schema.field("mul_dec").type == pa.decimal128(13, 4)
    assert got.schema.field("mul_f64").type == pa.float64()
    assert got.schema.field("add").type == pa.decimal128(12, 4)
    _assert_rows(got, want, tol=ULPS)


def test_remainder_by_zero_is_null(table):
    P = torch_api()
    rows = P.session().create_dataframe(table).select(
        (P.col("a") % P.col("dk")).alias("m"), "a", "dk").collect().to_pylist()
    assert any(r["dk"] == 0 for r in rows)
    for r in rows:
        assert (r["m"] is None) == (r["a"] is None or r["dk"] == 0)


def test_literals_infer_precision_and_scale():
    P = torch_api()
    assert P.lit(D("-12.340")).data_type() == TT.DecimalType(5, 3)
    assert P.lit(D("0.05")).data_type() == TT.DecimalType(3, 2)
    assert P.lit(D("24")).data_type() == TT.DecimalType(2, 0)


def _casts(api):
    col, T = api.col, api.T
    return [
        col("h").cast(T.DecimalType(6, 1)).alias("to_s1"),
        col("h").cast(T.DecimalType(6, 0)).alias("to_s0"),
        col("h").cast(T.DecimalType(8, 4)).alias("up"),
        col("h").cast(T.DecimalType(2, 1)).alias("overflow"),
        col("h").cast(T.INT32).alias("to_int"),
        col("h").cast(T.FLOAT64).alias("to_f64"),
        col("h").cast(T.FLOAT32).alias("to_f32"),
        col("x").cast(T.DecimalType(9, 2)).alias("f_to_dec"),
        col("n").cast(T.DecimalType(12, 2)).alias("i_to_dec"),
        col("n").cast(T.DecimalType(3, 1)).alias("i_overflow"),
    ]


def test_casts_round_half_up():
    h = [D("0.50"), D("-0.50"), D("1.25"), D("-1.25"), D("1.24"),
         D("-1.26"), D("2.55"), D("-2.45"), D("99.99"), None]
    t = pa.table({"h": pa.array(h, pa.decimal128(6, 2)),
                  "x": [0.125, -0.125, 1.005, 2.675, -7.5, 1e7, np.nan, 0.0,
                        3.14159, 1.0],
                  "n": np.array([0, 1, -1, 99, -99, 100, 7, 12345, -5, 3],
                                np.int64)})
    got, want = _run(lambda api, df: df.select(*_casts(api)), t)
    # NaN to a decimal is null, as in Spark; the JAX package gives 0.00
    assert got["f_to_dec"][6].as_py() is None
    assert want["f_to_dec"][6].as_py() == D("0.00")
    want = want.set_column(7, "f_to_dec", got["f_to_dec"])
    _assert_rows(got, want, tol=ULPS)
    # HALF_UP: .5 away from zero, at either sign
    assert got["to_s1"].to_pylist()[:8] == [
        D("0.5"), D("-0.5"), D("1.3"), D("-1.3"), D("1.2"), D("-1.3"),
        D("2.6"), D("-2.5")]
    assert got["to_s0"].to_pylist()[:4] == [D("1"), D("-1"), D("1"), D("-1")]
    assert got["overflow"].to_pylist()[8] is None
    assert got["to_int"].to_pylist()[:4] == [0, 0, 1, -1]


# ---------------------------------------------------------------------------
# aggregates on every route
# ---------------------------------------------------------------------------

def _aggs(api):
    F, col = api.F, api.col
    return [F.sum(col("a")).alias("sa"), F.sum(col("b")).alias("sb"),
            F.avg(col("a")).alias("ma"), F.avg(col("b")).alias("mb"),
            F.min(col("a")).alias("mn"), F.max(col("b")).alias("mx"),
            F.count(col("a")).alias("n")]


@pytest.mark.parametrize("keys,route", [
    ((), "_global_update"), (("flag",), "_bucket_update"),
    (("k",), "_scatter_agg"), (("kw", "k"), "_packed_sort_agg"),
    (("kf",), "_sort_agg"), (("dk",), "_scatter_agg")])
@pytest.mark.parametrize("parts", [1, 3])
def test_aggregates_on_every_route(table, monkeypatch, keys, route, parts):
    spy = _Spy(monkeypatch)

    def build(api, df):
        g = df.group_by(*keys) if keys else df
        return g.agg(*_aggs(api))
    got, want = _run(build, table, parts)
    assert route in spy.hits
    assert got.schema.field("sa").type == pa.decimal128(18, 2)
    assert got.schema.field("sb").type == pa.decimal128(18, 4)
    _assert_rows(got, want, keys, tol=1e-12)


def test_decimal_sum_is_exact(table):
    P = torch_api()
    got = P.session().create_dataframe(table, num_partitions=3).group_by(
        "k").agg(P.F.sum(P.col("b")).alias("sb")).collect()
    ref = table.group_by("k").aggregate([("b", "sum")])
    want = dict(zip(ref["k"].to_pylist(), ref["b_sum"].to_pylist()))
    assert dict(zip(got["k"].to_pylist(), got["sb"].to_pylist())) == want


def test_segsum_route_takes_decimal_averages(monkeypatch):
    # a decimal average sums doubles: the segsum gates admit it
    from spark_rapids_tpu_torch.ops import segsum as S
    spy = _Spy(monkeypatch)
    n = 4 * S.TILE
    rng = np.random.default_rng(8)
    t = pa.table({"g": rng.integers(0, 3000, n).astype(np.int32),
                  "d": H.decimal_array(rng.integers(0, 10 ** 6, n), 9, 2)})
    got, want = _run(lambda api, df: df.group_by("g").agg(
        api.F.avg(api.col("d")).alias("m"),
        api.F.count(api.col("d")).alias("c")), t)
    assert "_segsum_or_fallback" in spy.hits
    _assert_rows(got, want, ["g"], tol=1e-12)


# ---------------------------------------------------------------------------
# decimal keys: group-by, join, sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
def test_group_join_sort_on_decimal_keys(table, parts):
    dim = pa.table({"dk": H.decimal_array(np.arange(-40, 40) * 25, 6, 2),
                    "label": [f"d{j}" for j in range(80)]})

    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        df = s.create_dataframe(table, num_partitions=parts)
        d = s.create_dataframe(dim)
        g = df.group_by("dk").agg(api.F.count().alias("n"),
                                  api.F.sum(api.col("a")).alias("sa"))
        j = df.join(d, on="dk").group_by("label").agg(
            api.F.sum(api.col("b")).alias("sb"))
        srt = df.select("dk", "a", "i").sort(api.col("dk").desc(),
                                              api.col("i"), api.col("a"))
        out.append((g.collect(), j.collect(), srt.collect()))
    (g1, j1, s1), (g2, j2, s2) = out
    _assert_rows(g1, g2, ["dk"])
    _assert_rows(j1, j2, ["label"])
    _assert_rows(s1, s2)
    assert g1.num_rows == 80


def test_top_n_on_a_decimal_key(table):
    got, want = _run(lambda api, df: df.select("b", "i").sort(
        api.col("b").desc()).limit(17), table, parts=3)
    _assert_rows(got, want)


# ---------------------------------------------------------------------------
# Parquet, and q1/q6 over lineitem_dec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_decode", ["true", "false"])
def test_decimal_parquet_file(table, tmp_path, device_decode):
    path = str(tmp_path / "dec.parquet")
    pq.write_table(table, path, row_group_size=1000)
    conf = {"spark.rapids.sql.decode.device.enabled": device_decode}
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).read_parquet(path)
        out.append(df.filter(api.col("a") > api.lit(D("0.5"))).group_by(
            "k").agg(*_aggs(api)).collect())
    _assert_rows(*out, ["k"], tol=1e-12)
    P = torch_api()
    whole = P.session(conf).read_parquet(path).collect()
    assert whole.equals(table)


@pytest.fixture(scope="module")
def lineitem_dec():
    return H.lineitem_dec(H.make_lineitem(20_000))


def test_lineitem_dec_is_exact(lineitem_dec):
    # each float is the double nearest its decimal: unscaled / 100
    li = H.make_lineitem(20_000)
    for c in H.DEC_COLS:
        unscaled = B.from_arrow(lineitem_dec.select([c]), "cpu").columns[
            0].data[:li.num_rows].numpy()
        assert np.array_equal(unscaled / 100.0, li[c].to_numpy())


@pytest.mark.parametrize("query", ["q1_dec", "q6_dec", "disc_groups"])
@pytest.mark.parametrize("parts", [1, 4])
def test_tpch_shapes_over_lineitem_dec(lineitem_dec, query, parts):
    got, want = _run(getattr(H, query), lineitem_dec, parts)
    keys = {"q1_dec": ["l_returnflag", "l_linestatus"], "q6_dec": None,
            "disc_groups": ["l_discount"]}[query]
    _assert_rows(got, want, keys, tol=1e-12)
    if query == "q1_dec":
        # the decimal sums are pyarrow's, exactly
        f = lineitem_dec.filter(pc.less_equal(lineitem_dec["l_shipdate"],
                                              10471))
        ref = f.group_by(["l_returnflag", "l_linestatus"]).aggregate(
            [("l_quantity", "sum"), ("l_extendedprice", "sum")])
        want_sums = {(a, b): (x, y) for a, b, x, y in zip(
            *[ref[c].to_pylist() for c in (
                "l_returnflag", "l_linestatus", "l_quantity_sum",
                "l_extendedprice_sum")])}
        got_sums = {(a, b): (x, y) for a, b, x, y in zip(
            got["l_returnflag"].to_pylist(), got["l_linestatus"].to_pylist(),
            got["sq"].to_pylist(), got["sp"].to_pylist())}
        assert got_sums == want_sums


# ---------------------------------------------------------------------------
# ROADMAP C14: math over DECIMAL gives Spark's value and type
# ---------------------------------------------------------------------------

C14_VALUES = ["272.7688", "-272.7650", "272.7650", "0.0500", "-0.0500",
              "99999999.9999", "-0.0001", None]


def _c14_table():
    return pa.table({"x": pa.array(
        [None if v is None else decimal.Decimal(v) for v in C14_VALUES],
        pa.decimal128(12, 4))})


def _spark_round(v, d, mode):
    """Spark's round/bround of a Decimal to d places, in BigDecimal's
    terms (HALF_UP or HALF_EVEN)."""
    if v is None:
        return None
    q = decimal.Decimal(1).scaleb(-max(d, 0)) if d >= 0 \
        else decimal.Decimal(1).scaleb(-d)
    r = v.quantize(q, rounding=mode) if d >= 0 else \
        (v / q).quantize(decimal.Decimal(1), rounding=mode) * q
    return r.quantize(decimal.Decimal(1).scaleb(-min(4, max(d, 0))))


@pytest.mark.parametrize("d", [-2, -1, 0, 1, 3, 4, 6])
def test_round_and_bround_of_decimals_are_spark_s(d):
    """round is HALF_UP and bround HALF_EVEN on the unscaled value, typed
    decimal(p - s + 1 + min(s, d), min(s, d)) (d >= 0) or
    decimal(max(p - s + 1, 1 - d), 0), on the device and the CPU. The
    JAX package answers with a double of the unscaled value for round,
    and the input unchanged for bround (C14)."""
    t = _c14_table()
    vals = t.column("x").to_pylist()
    scale = min(4, d) if d >= 0 else 0
    prec = 12 - 4 + 1 + min(4, d) if d >= 0 else max(12 - 4 + 1, 1 - d)
    api = torch_api()
    df = api.session().create_dataframe(t).select(
        api.F.round(api.col("x"), d).alias("r"),
        api.F.bround(api.col("x"), d).alias("b"))
    for got in (df.collect(), df.collect_cpu()):
        assert got.schema.field("r").type == pa.decimal128(prec, scale)
        assert got.schema.field("b").type == pa.decimal128(prec, scale)
        assert got.column("r").to_pylist() == [
            _spark_round(v, d, decimal.ROUND_HALF_UP) for v in vals]
        assert got.column("b").to_pylist() == [
            _spark_round(v, d, decimal.ROUND_HALF_EVEN) for v in vals]
    if d == 1:
        api = jax_api()
        jax = api.session().create_dataframe(t).select(
            api.F.round(api.col("x"), d).alias("r"),
            api.F.bround(api.col("x"), d).alias("b")).collect()
        assert jax.column("r").to_pylist()[0] == 2727688.0
        assert jax.column("b").to_pylist()[0] == decimal.Decimal("272.7688")


def test_round_roadmap_case():
    api = torch_api()
    got = api.session().create_dataframe(_c14_table()).select(
        api.F.round(api.col("x"), 1).alias("r")).collect()
    assert got.schema.field("r").type == pa.decimal128(10, 1)
    assert got.column("r").to_pylist()[0] == decimal.Decimal("272.8")


def test_floor_ceil_and_double_functions_of_decimals():
    """floor and ceil are integer ops on the unscaled value, typed
    decimal(p - s + 1, 0); sqrt, log, pow and the other double functions
    read unscaled / 10^scale. The JAX package answers floor/ceil as the
    unscaled int64 and sqrt of the unscaled value (C14)."""
    t = _c14_table()
    vals = t.column("x").to_pylist()
    api = torch_api()
    F, c = api.F, api.col
    df = api.session().create_dataframe(t).select(
        F.floor(c("x")).alias("fl"), F.ceil(c("x")).alias("ce"),
        F.sqrt(c("x")).alias("sq"), F.log10(c("x")).alias("lg"),
        F.pow(c("x"), 2.0).alias("pw"), F.exp(c("x") / c("x")).alias("e1"))
    for got in (df.collect(), df.collect_cpu()):
        assert got.schema.field("fl").type == pa.decimal128(9, 0)
        assert got.column("fl").to_pylist() == [
            None if v is None else v.to_integral_value(decimal.ROUND_FLOOR)
            for v in vals]
        assert got.column("ce").to_pylist() == [
            None if v is None else v.to_integral_value(decimal.ROUND_CEILING)
            for v in vals]
        for name, fn in (("sq", math.sqrt), ("lg", math.log10)):
            for v, g in zip(vals, got.column(name).to_pylist()):
                if v is None or v <= 0:
                    continue
                assert abs(g - fn(float(v))) <= 1e-12 * abs(fn(float(v)))
        for v, g in zip(vals, got.column("pw").to_pylist()):
            if v is not None:
                assert abs(g - float(v) ** 2) <= 1e-12 * float(v) ** 2
    api = jax_api()
    jax = api.session().create_dataframe(t).select(
        api.F.floor(api.col("x")).alias("fl"),
        api.F.sqrt(api.col("x")).alias("sq")).collect().to_pylist()[0]
    assert jax["fl"] == 2727688
    assert abs(jax["sq"] - math.sqrt(2727688)) < 1e-9
