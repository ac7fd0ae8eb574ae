"""The port's aggregates of ``expr/aggregates.py`` against the JAX package:
first/last and the moments on every aggregate route, the segmented
aggregates (percentile, approx_percentile, min_by, max_by) with and
without keys over one and three partitions, and the sixth slice's smoke
shapes at a small size with their routes.

Tolerances:
- keys, counts, first/last, min_by/max_by and percentiles are exact,
  except one ulp (relative 2.3e-16) on a percentile whose interpolation
  fraction is not 0 or 1/2: XLA's CPU backend contracts the JAX package's
  ``lo + (hi - lo) * frac`` into a fused multiply-add, where the port
  rounds twice, as Spark and numpy do;
- variance and stddev are exact on the packed routes (packed sort and
  scatter), which sum fixed-point integer limbs in both packages, and on
  single-partition segsum sums;
- on the routes that add floats in ``torch.sum``/``index_add_`` order
  (global, tiny-bucket, sort) and wherever the JAX package plans
  partial -> exchange -> final while the port collects, they are held to
  a relative 1e-9 (``sumsq - sum^2/n`` magnifies low-bit differences).
"""
import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.ops import pallas_segsum as JPS

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import segsum as S

N = 6000
ROUTES = ("_global_update", "_bucket_update", "_sort_agg",
          "_packed_sort_agg", "_scatter_agg", "_chunked_segsum_agg",
          "_segsum_or_fallback")


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(77)
    v = rng.normal(100, 30, N)
    v[[3, 4, 5, 9]] = [-0.0, 0.0, np.nan, -0.0]
    return pa.table({
        "k": rng.integers(0, 40, N).astype(np.int32),
        "kw": rng.integers(0, 3000, N).astype(np.int64) * 100_000,
        "kf": np.round(rng.uniform(0, 20, N)),
        "flag": np.array(["A", "N", "R"])[rng.integers(0, 3, N)],
        "v": pa.array(v, mask=rng.random(N) < 0.1),
        "i": pa.array(rng.integers(-50, 50, N).astype(np.int32),
                      mask=rng.random(N) < 0.1),
        "f": rng.normal(0, 3, N).astype(np.float32),
        "o": pa.array(rng.integers(0, 25, N).astype(np.int64),
                      mask=rng.random(N) < 0.1),
        "s": pa.array([f"s{j % 97}" for j in range(N)]),
    })


class _Spy:
    def __init__(self, monkeypatch):
        self.hits = set()
        for name in ROUTES:
            orig = getattr(X._AggKernels, name)

            def spy(kern, *a, _name=name, _orig=orig, **k):
                self.hits.add(_name)
                return _orig(kern, *a, **k)
            monkeypatch.setattr(X._AggKernels, name, spy)


def _run(build, table, parts=1, cache=True):
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(table, num_partitions=parts)
        out.append(build(api, df.cache() if cache else df).collect())
    return out


def _compare(got, want, keys, exact, approx=None):
    """Exact columns exactly, the approx ones to a relative tolerance,
    rows matched by their keys."""
    assert_tables_equal(got.select(keys + exact), want.select(keys + exact),
                        ignore_order=True)
    if approx:
        assert_tables_equal(got.select(keys + approx[0]),
                            want.select(keys + approx[0]),
                            ignore_order=True, approx_float=approx[1])


def _moments(api):
    c, F = api.col, api.F
    return [F.first(c("v")).alias("fv"), F.last(c("v")).alias("lv"),
            F.first(c("i")).alias("fi"), F.last(c("f")).alias("lf"),
            F.count(c("v")).alias("n"),
            F.stddev(c("v")).alias("sd"), F.stddev_pop(c("i")).alias("sdp"),
            F.variance(c("f")).alias("var"), F.var_pop(c("v")).alias("vp"),
            F.avg(c("v")).alias("av")]


EXACT = ["fv", "lv", "fi", "lf", "n"]
MOMENTS = ["sd", "sdp", "var", "vp", "av"]

#: route -> (group keys, the route's method, are the moments exact)
ROUTE_CASES = {
    "global": ([], "_global_update", False),
    "tiny_bucket": (["flag"], "_bucket_update", False),
    # 4 x 98 buckets: past the per-bucket reductions, a bounded scatter
    "tiny_bucket_scatter": (["flag", "s"], "_bucket_update", False),
    "sort": (["kf"], "_sort_agg", False),
    "packed_sort": (["kw"], "_packed_sort_agg", True),
    "scatter": (["k"], "_scatter_agg", True),
}


@pytest.mark.parametrize("route", sorted(ROUTE_CASES))
def test_first_last_and_moments_on_every_route(route, table, monkeypatch):
    keys, method, exact = ROUTE_CASES[route]
    spy = _Spy(monkeypatch)

    def build(api, df):
        g = df.group_by(*keys) if keys else df
        return g.agg(*_moments(api))
    got, want = _run(build, table)
    if exact:
        _compare(got, want, keys, EXACT + MOMENTS)
    else:
        _compare(got, want, keys, EXACT, (MOMENTS, 1e-9))
    assert method in spy.hits
    assert got.num_rows == want.num_rows > 0


@pytest.mark.parametrize("parts", [1, 3])
def test_first_last_keep_row_order_across_batches_and_partitions(
        parts, table):
    # uncached 1000-row batches: per-batch states merged in batch order,
    # and several partitions collected in partition order
    conf = {"spark.rapids.sql.reader.batchSizeRows": 1000}
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(table, num_partitions=parts)
        out.append(df.group_by("k").agg(
            api.F.first(api.col("v")).alias("fv"),
            api.F.last(api.col("o")).alias("lo"),
            api.F.stddev(api.col("v")).alias("sd")).collect())
    _compare(out[0], out[1], ["k"], ["fv", "lo"], (["sd"], 1e-9))


def test_segsum_gate_keeps_moments_off_the_kernel(table, monkeypatch):
    spy = _Spy(monkeypatch)
    got, want = _run(lambda api, df: df.group_by("kw").agg(
        api.F.sum(api.col("v")).alias("s"),
        api.F.variance(api.col("v")).alias("var")), table)
    _compare(got, want, ["kw"], ["s", "var"])
    assert "_segsum_or_fallback" not in spy.hits


def _segmented(api):
    c, F = api.col, api.F
    return [F.percentile(c("v"), 0.5).alias("p50"),
            F.percentile(c("i"), 0.0).alias("p0"),
            F.approx_percentile(c("f"), 0.9).alias("p90"),
            F.percentile_approx(c("v"), 1.0).alias("p100"),
            F.min_by(c("v"), c("o")).alias("mb"),
            F.max_by(c("i"), c("v")).alias("xb"),
            F.max_by(c("s"), c("f")).alias("xs"),
            F.count().alias("n")]


SEGMENTED = ["p50", "p0", "p100", "mb", "xb", "xs", "n"]
#: a fused multiply-add in the JAX package on the CPU (module docstring)
ONE_ULP = 2.3e-16


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("keys", [[], ["k"], ["flag"]],
                         ids=["global", "int_key", "string_key"])
def test_segmented_aggregates_match_jax(keys, parts, table):
    def build(api, df):
        g = df.group_by(*keys) if keys else df
        return g.agg(*_segmented(api))
    got, want = _run(build, table, parts)
    _compare(got, want, keys, SEGMENTED, (["p90"], ONE_ULP))


@pytest.mark.parametrize("keys", [[], ["k"]], ids=["collect", "hash"])
def test_segmented_aggregates_exchange_raw_rows(keys, table):
    # several partitions: raw rows meet by key (or in one partition)
    # before one complete aggregate per partition
    P = torch_api()
    s = P.session()
    df = s.create_dataframe(table, num_partitions=3)
    g = df.group_by(*keys) if keys else df
    g.agg(P.F.percentile(P.col("v"), 0.25)).collect()
    names = [type(e).__name__ for e in s.last_exec.walk()]
    want = "ShuffleExchangeExec" if keys else "CollectExchangeExec"
    assert names[:2] == ["HashAggregateExec", want]
    assert s.last_exec.num_partitions == (3 if keys else 1)


def test_percentile_orders_zeros_and_nan_like_jax():
    # the JAX package's sort puts every NaN above +inf and keeps -0.0 and
    # 0.0 in row order: the interpolated results agree bit for bit
    vals = [0.0, -0.0, 1.0, np.nan, -0.0, -1.0, 0.0, np.inf, -np.inf, np.nan]
    t = pa.table({"g": np.repeat(np.arange(4), len(vals)).astype(np.int32),
                  "v": np.concatenate([vals, vals[::-1], vals[2:] + vals[:2],
                                       [-0.0] * len(vals)])})

    def build(api, df):
        F, c = api.F, api.col
        return df.group_by("g").agg(
            *[F.percentile(c("v"), p).alias(f"p{j}")
              for j, p in enumerate((0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))])
    got, want = _run(build, t, cache=False)
    got, want = got.sort_by("g"), want.sort_by("g")
    for name in got.column_names[1:]:
        g = got[name].to_numpy().view(np.int64)
        w = want[name].to_numpy().view(np.int64)
        nan = np.isnan(got[name].to_numpy())
        assert np.array_equal(np.isnan(want[name].to_numpy()), nan), name
        assert np.array_equal(g[~nan], w[~nan]), name


def test_min_by_ties_go_to_the_first_row(table):
    t = pa.table({"g": [1, 1, 1, 2, 2, 2], "v": [10, 20, 30, 40, 50, 60],
                  "o": [5, 3, 3, None, 7, 7]})
    got, want = _run(lambda api, df: df.group_by("g").agg(
        api.F.min_by(api.col("v"), api.col("o")).alias("mb"),
        api.F.max_by(api.col("v"), api.col("o")).alias("xb")), t,
        cache=False)
    assert_tables_equal(got, want, ignore_order=True)
    assert dict(zip(got["g"].to_pylist(), got["mb"].to_pylist())) == \
        {1: 20, 2: 50}


@pytest.mark.parametrize("agg", ["min", "max", "first", "last", "min_by",
                                 "collect_list", "collect_set"])
def test_what_the_jax_package_runs_on_the_cpu_raises(agg, table):
    # the JAX package's CPU fallbacks now fall back in the port too, with
    # the same answer; collect_list/collect_set over strings run on the
    # device in both packages and give the same lists in the same order
    def build(api, df):
        if agg == "min_by":
            fn = api.F.min_by(api.col("v"), api.col("s"))
        else:
            fn = getattr(api.F, agg)(api.col("s"))
        return df.group_by("k").agg(fn.alias("r"))
    got, want = _run(build, table, parts=3)
    assert got.num_rows == 40
    assert_tables_equal(got, want, ignore_order=True)


# ---------------------------------------------------------------------------
# the smoke shapes, small
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem():
    return H.make_lineitem(30_000)


def test_q14_case_takes_the_chunked_segsum_route(lineitem, monkeypatch):
    # capacity 32768 = 2 chunks of 16384; the CASE sum and the revenue sum
    # are exact, as every segsum sum is
    monkeypatch.setattr(JPS, "CHUNK_ROWS", 16384)
    monkeypatch.setattr(S, "CHUNK_ROWS", 16384)
    spy = _Spy(monkeypatch)
    got, want = _run(H.q14_case, lineitem)
    _compare(got, want, ["l_shipdate"], ["promo", "rev", "n"])
    assert "_chunked_segsum_agg" in spy.hits and got.num_rows == 2200


def test_q1_stats_takes_the_tiny_bucket_route(lineitem, monkeypatch):
    spy = _Spy(monkeypatch)
    got, want = _run(H.q1_stats, lineitem)
    _compare(got, want, ["l_returnflag", "l_linestatus"],
             ["first_ship", "last_disc", "n"],
             (["sd_q", "vp_p", "avg_abs"], 1e-9))
    assert spy.hits == {"_bucket_update"} and got.num_rows == 6


def test_stats_by_order_takes_the_scatter_route(lineitem, monkeypatch):
    spy = _Spy(monkeypatch)
    got, want = _run(H.stats_by_order, lineitem)
    _compare(got, want, ["k"], ["sd_p", "var_d", "first_q"])
    assert spy.hits == {"_scatter_agg"} and got.num_rows == 3000


def test_pctl_shuffled_exchanges_then_sorts(lineitem, monkeypatch):
    spy = _Spy(monkeypatch)
    P = torch_api()
    s = P.session()
    got = H.pctl_shuffled(P, s.create_dataframe(
        lineitem, num_partitions=3).cache()).collect()
    want = H.pctl_shuffled(jax_api(), jax_api().session().create_dataframe(
        lineitem, num_partitions=3).cache()).collect()
    _compare(got, want, ["l_shipdate"], ["p50", "top", "cheap"],
             (["p90"], ONE_ULP))
    assert spy.hits == {"_sort_agg"} and got.num_rows == 2200
    assert "ShuffleExchangeExec" in [type(e).__name__
                                     for e in s.last_exec.walk()]


def test_cleanse_rows_matches_jax_row_by_row(lineitem):
    def ints(t):
        return t.set_column(t.column_names.index("ts"), "ts",
                            t["ts"].cast(pa.int64()))
    got, want = _run(H.cleanse_rows, lineitem, parts=3)
    assert got.column_names == list(H.CLEANSE_COLS)
    assert_tables_equal(ints(got), ints(want))
    sat = got["sat"].to_numpy()
    assert (sat == 2 ** 63 - 1).any() and (sat < 2 ** 63 - 1).any()
