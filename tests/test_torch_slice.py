"""The port's first slice end to end against the JAX package.

Both sessions take the same seeded lineitem table (bench.py's columns at
50k rows), cache it, and run the slice's query shapes; the results are
compared as key-sorted tables.

Tolerances:
- keys and counts are exact everywhere;
- sums on the packed-radix routes (segsum, chunked segsum, scatter
  buckets) are exact: both packages sum integer digits and limbs;
- q6's global sum and q1's tiny-bucket sums are plain float64 reductions
  (``jnp.sum`` and ``torch.sum``), whose summation orders differ between
  XLA and ATen, so they are compared to a relative 1e-12.

The JAX session plans these aggregates over 8 virtual devices as
partial -> exchange -> final where the port plans collect -> complete;
results are compared, not plans.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import (
    jax_api, make_lineitem, q1, q6, q72shfl, repart_agg, torch_api,
)

from spark_rapids_tpu.exec import tpu_nodes as JX
from spark_rapids_tpu.ops import pallas_kernels as JPK
from spark_rapids_tpu.ops import pallas_segsum as JPS

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.ops import segsum as S

ROWS = 50_000


@pytest.fixture(scope="module")
def lineitem():
    return make_lineitem(ROWS)


@pytest.fixture(scope="module")
def sessions(lineitem):
    J, P = jax_api(), torch_api()
    return (J, J.session().create_dataframe(lineitem).cache(),
            P, P.session().create_dataframe(lineitem).cache())


def _spy(monkeypatch, cls, name):
    hits = []
    orig = getattr(cls, name)

    def spy(self, *a, **k):
        hits.append(1)
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, name, spy)
    return hits


def _compare(query, sessions, approx=None, **kw):
    J, dj, P, dp = sessions
    got = query(P, dp, **kw).collect()
    want = query(J, dj, **kw).collect()
    assert_tables_equal(got, want, ignore_order=True, approx_float=approx)
    return got


def test_session_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        assert TorchSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSession()
    assert TorchSession(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("query,approx", [(q6, 1e-12), (q1, 1e-12)],
                         ids=["q6", "q1"])
def test_plain_reduction_queries_match_jax(query, approx, sessions,
                                           monkeypatch):
    routes = {n: _spy(monkeypatch, X._AggKernels, n)
              for n in ("_global_update", "_bucket_update")}
    out = _compare(query, sessions, approx)
    assert out.num_rows == (1 if query is q6 else 6)
    assert routes["_global_update" if query is q6 else "_bucket_update"]


@pytest.mark.parametrize("query", [q72shfl, repart_agg],
                         ids=["q72shfl", "repart_agg"])
@pytest.mark.parametrize("value", ["l_quantity", "l_extendedprice"])
def test_segsum_route_queries_match_jax_exactly(query, value, sessions,
                                                monkeypatch):
    seg = _spy(monkeypatch, X._AggKernels, "_segsum_agg")
    fell_back = _spy(monkeypatch, X._AggKernels, "_scatter_agg")
    out = _compare(query, sessions, value=value)
    assert out.num_rows == (5000 if query is q72shfl else 2200)
    assert seg and not fell_back


@pytest.mark.parametrize("query,want", [(q72shfl, 10), (repart_agg, 11)],
                         ids=["q72shfl", "repart_agg"])
def test_segsum_payload_holds_only_real_lanes(query, want, sessions,
                                              monkeypatch):
    # 1 live count + the key digits + 6 float digits. q72shfl's projection
    # folds into the aggregate (plan/prune.py, as in the JAX package), so
    # its key l_orderkey % 100000 packs by its static range, 18 bits: 3
    # digits. repart_agg's 12-bit key takes 2; after the exchange the
    # value plane carries validity, which adds a count lane and a
    # some-valid lane
    lanes = []
    orig = S.segsum

    def spy(gid, payload, outcap):
        lanes.append(payload.shape[0])
        return orig(gid, payload, outcap)
    monkeypatch.setattr(S, "segsum", spy)
    P, dp = sessions[2], sessions[3]
    query(P, dp).collect()
    assert lanes == [want]


def test_chunked_segsum_route_matches_jax(lineitem, monkeypatch):
    # capacity 32768 = 2 chunks of 16384; the 12-bit l_shipdate key keeps
    # the 2 * 4096-row partial merge within the chunk size
    monkeypatch.setattr(JPS, "CHUNK_ROWS", 16384)
    monkeypatch.setattr(S, "CHUNK_ROWS", 16384)
    port = _spy(monkeypatch, X._AggKernels, "_chunked_segsum_agg")
    ref = _spy(monkeypatch, JX._AggKernels, "_chunked_pallas_agg")
    t = lineitem.slice(0, 30_000)

    def query(api):
        col, F = api.col, api.F
        return api.session().create_dataframe(t).group_by(
            col("l_shipdate")).agg(F.sum("l_extendedprice").alias("s"),
                                   F.count("l_discount").alias("c"),
                                   F.avg("l_quantity").alias("a"))
    assert_tables_equal(query(torch_api()).collect(),
                        query(jax_api()).collect(), ignore_order=True)
    assert port and ref


def test_group_overflow_falls_back_to_scatter(sessions, monkeypatch):
    # ~23 rows per l_shipdate group exceed a shrunken exact-digit bound
    monkeypatch.setattr(JPS, "MAX_GROUP_ROWS", 8)
    monkeypatch.setattr(S, "MAX_GROUP_ROWS", 8)
    seg = _spy(monkeypatch, X._AggKernels, "_segsum_agg")
    fallback = _spy(monkeypatch, X._AggKernels, "_scatter_agg")
    _compare(repart_agg, sessions, value="l_extendedprice")
    assert seg and fallback


def test_nan_and_inf_fall_back_to_scatter(monkeypatch):
    rng = np.random.default_rng(3)
    n = 20_000
    v = rng.uniform(-100, 100, n)
    v[[5, 700]] = np.nan
    v[[9000]] = np.inf
    v[[9001, 15000]] = -np.inf
    t = pa.table({"k": rng.integers(0, 3000, n).astype(np.int64),
                  "v": pa.array(v, mask=rng.random(n) < 0.05)})
    fallback = _spy(monkeypatch, X._AggKernels, "_scatter_agg")
    J, P = jax_api(), torch_api()

    def query(api):
        col, F = api.col, api.F
        return api.session().create_dataframe(t).group_by(col("k")).agg(
            F.sum("v").alias("s"), F.count("v").alias("c"))
    assert_tables_equal(query(P).collect(), query(J).collect(),
                        ignore_order=True)
    assert fallback


def test_segsum_disabled_takes_scatter_route(lineitem, monkeypatch):
    # the JAX flag is process-wide and first-session-wins: set it directly
    monkeypatch.setattr(JPK, "_ENABLED", False)
    seg = _spy(monkeypatch, X._AggKernels, "_segsum_agg")
    J, P = jax_api(), torch_api()
    off = {"spark.rapids.sql.pallas.enabled": "false"}
    dj = J.session(off).create_dataframe(lineitem)
    dp = P.session(off).create_dataframe(lineitem)
    assert_tables_equal(q72shfl(P, dp, value="l_extendedprice").collect(),
                        q72shfl(J, dj, value="l_extendedprice").collect(),
                        ignore_order=True)
    assert not seg


def test_multi_batch_scan_merges_partials(lineitem):
    # uncached scans of 8192-row batches: one update per batch, then the
    # packed merge of the partial states
    conf = {"spark.rapids.sql.reader.batchSizeRows": 8192}
    J, P = jax_api(), torch_api()
    t = lineitem.slice(0, 30_000)

    def query(api):
        col, F = api.col, api.F
        return (api.session(conf).create_dataframe(t)
                .filter(col("l_discount") > api.lit(0.02))
                .group_by(col("l_returnflag"), col("l_shipdate"))
                .agg(F.sum("l_quantity").alias("s"),
                     F.count("l_quantity").alias("c"),
                     F.min("l_extendedprice").alias("lo"),
                     F.max("l_extendedprice").alias("hi")))
    assert_tables_equal(query(P).collect(), query(J).collect(),
                        ignore_order=True)


def test_exchange_partitions_rows_like_jax(lineitem):
    from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
    from spark_rapids_tpu.ops import kernels as JK
    from spark_rapids_tpu_torch.columnar.batch import to_arrow
    from spark_rapids_tpu_torch.plan.overrides import convert_plan
    t = lineitem.slice(0, 20_000).select(["l_shipdate", "l_orderkey"])
    P = torch_api()
    df = P.session().create_dataframe(t).repartition(
        4, P.col("l_shipdate"), P.col("l_orderkey"))
    root, _ = convert_plan(df.plan, df.session.conf, "cpu")
    got = [[r for b in root.execute_partition(p)
            for r in to_arrow(b, t.schema.names).to_pylist()]
           for p in range(4)]
    jb = jax_from_arrow(t)
    h = np.asarray(JK.partition_hash_batch(jb.columns, jb.num_rows))
    pid = np.mod(h[:t.num_rows].astype(np.int64), 4)
    rows = t.to_pylist()
    want = [[r for r, q in zip(rows, pid) if q == p] for p in range(4)]
    assert got == want  # same rows, in input order, per partition


def test_with_column_count_and_ansi_divide(lineitem):
    P = torch_api()
    df = P.session().create_dataframe(lineitem.slice(0, 5000))
    w = df.with_column("x", P.col("l_quantity") / P.lit(0.0))
    assert w.columns[-1] == "x" and w.count() == 5000
    assert w.filter(P.col("x").is_null()).count() == 5000
    ansi = P.session({"spark.sql.ansi.enabled": True}).create_dataframe(
        lineitem.slice(0, 100))
    with pytest.raises(SparkException, match="DIVIDE_BY_ZERO"):
        ansi.select((P.col("l_quantity") / P.lit(0.0)).alias("x")).collect()


def test_routes_not_ported_yet_raise_with_their_name(lineitem):
    P = torch_api()
    J = jax_api()
    # a window the JAX package runs on the CPU runs there in the port too
    ranked = []
    for api in (P, J):
        w = api.Window.partition_by(api.col("l_linestatus")) \
            .order_by(api.col("l_returnflag"))
        ranked.append(api.session().create_dataframe(lineitem.slice(0, 1000))
                      .select(api.col("l_orderkey"),
                              api.F.rank().over(w).alias("rk")).collect())
    assert_tables_equal(*ranked, ignore_order=True)
    # the masked partitioning mode (ported with ROADMAP A5) runs, and
    # answers as the compact mode and the JAX package's masked mode do
    parted = []
    for api, mode in ((P, "masked"), (P, "compact"), (J, "masked")):
        parted.append(api.session({"spark.rapids.shuffle.partitioning": mode})
                      .create_dataframe(lineitem.slice(0, 1000))
                      .repartition(4, api.col("l_shipdate")).collect())
    assert_tables_equal(parted[0], parted[1])
    assert_tables_equal(parted[0], parted[2])
    # routes that raised before they were ported, the packed sort route
    # (keys packing into more than 23 bits), the round-robin exchange and
    # the cross join, now match the JAX package
    got = []
    for api in (P, J):
        d = api.session().create_dataframe(lineitem.slice(0, 1000))
        got.append((
            d.select((api.col("l_orderkey") * api.lit(100_000)).alias("k"),
                     api.col("l_quantity"))
            .group_by(api.col("k")).agg(api.F.count("l_quantity")).collect(),
            d.repartition(4).collect(),
            d.limit(30).join(d.limit(20), how="cross").collect()))
    assert_tables_equal(got[0][0], got[1][0], ignore_order=True)
    assert_tables_equal(got[0][1], got[1][1])
    assert_tables_equal(got[0][2], got[1][2], ignore_order=True)


#: the stated exceptions to the JAX defaults: the roofline peaks are the
#: H100 SXM's (HBM3 3350 GB/s, FP32 on CUDA cores 66900 GFLOP/s; NVIDIA's
#: data sheet at 700 W), not the TPU's
PORT_DEFAULTS = {"spark.rapids.obs.audit.peakGbps": (3350.0, 819.0),
                 "spark.rapids.obs.audit.peakGflops": (66900.0, 197000.0)}


def test_conf_keys_and_defaults_match_jax():
    from spark_rapids_tpu import config as JC
    from spark_rapids_tpu_torch import config as PC
    jax_conf = JC.RapidsConf()
    for key in PC.keys():
        assert key in JC._REGISTRY, key
        want = PORT_DEFAULTS.get(key, (jax_conf.get(key),) * 2)
        assert (PC.RapidsConf().get(key), jax_conf.get(key)) == \
            (want[0], want[-1]), key


def test_expressions_match_jax():
    rng = np.random.default_rng(12)
    n = 3000
    t = pa.table({
        "a": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "b": pa.array(rng.integers(-7, 8, n), mask=rng.random(n) < 0.1),
        "x": pa.array(rng.normal(0, 100, n), mask=rng.random(n) < 0.1),
        "f": pa.array(rng.normal(0, 3, n).astype(np.float32)),
        "s": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32()),
    })

    def query(api):
        col, lit = api.col, api.lit
        return api.session().create_dataframe(t).select(
            (col("a") + col("b")).alias("add"),
            (col("a") - lit(3)).alias("sub"),
            (col("a") * col("b")).alias("mul"),
            (col("x") / col("b")).alias("div"),
            (col("a") % col("b")).alias("rem"),
            (col("x") % lit(7.5)).alias("frem"),
            ((col("a") > lit(0)) | (col("x") < lit(0.0))).alias("or"),
            ((col("a") <= col("b")) & ~(col("f") >= lit(1.0))).alias("and"),
            (col("a") == col("b")).alias("eq"),
            (col("s") == lit("N")).alias("seq"),
            col("x").is_null().alias("isnull"),
            col("b").is_not_null().alias("notnull"),
            col("x").cast(api.T.INT32).alias("x_i32"),
            col("f").cast(api.T.INT8).alias("f_i8"),
            col("b").cast(api.T.INT16).alias("b_i16"),
            col("a").cast(api.T.FLOAT64).alias("a_f64"),
            col("b").cast(api.T.BOOLEAN).alias("b_bool"),
            col("d").alias("d"))
    J, P = jax_api(), torch_api()
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu_torch import types as PT
    J.T, P.T = JT, PT
    assert_tables_equal(query(P).collect(), query(J).collect())


_US_PER_DAY = 86_400_000_000


def _temporal_casts(api):
    c, T = api.col, api.T
    return [c("ts").cast(T.DATE).alias("ts_date"),
            c("ts").cast(T.INT64).alias("ts_long"),
            c("ts").cast(T.INT32).alias("ts_int"),
            c("d").cast(T.TIMESTAMP).alias("date_ts"),
            c("i").cast(T.TIMESTAMP).alias("int_ts"),
            c("l").cast(T.TIMESTAMP).alias("long_ts")]


def _saturating_casts(api):
    c, T = api.col, api.T
    return [c(src).cast(dst).alias(f"{src}_{name}")
            for src in ("f64", "f32")
            for name, dst in (("long", T.INT64), ("int", T.INT32),
                              ("short", T.INT16))]


@pytest.mark.parametrize("casts", [_temporal_casts, _saturating_casts],
                         ids=["timestamp_date_units", "float_to_int_saturates"])
def test_casts_match_jax(casts):
    # the unit-converting arms of timestamps and dates, and float-to-long
    # saturating at 2**63 - 1, compared exactly (timestamps as their int64
    # microseconds: some are outside Python's datetime range)
    t = pa.table({
        "ts": pa.array([0, -1, 3 * _US_PER_DAY + 5, -(_US_PER_DAY + 1), None,
                        1_700_000_000_123_456], pa.timestamp("us")),
        "d": pa.array([0, -1, 5, 19675, None, -3000], pa.date32()),
        "i": pa.array([0, -1, 5, 100_000, None, 2 ** 31 - 1], pa.int32()),
        "l": pa.array([0, -1, 5, 2 ** 40, None, -2 ** 62], pa.int64()),
        "f64": [np.inf, 9.3e18, 2.0 ** 63, 1e300, -np.inf, np.nan],
        "f32": pa.array([np.inf, 9.3e18, 2.0 ** 63, 1e30, -np.inf, np.nan],
                        pa.float32()),
    })

    def query(api):
        out = api.session().create_dataframe(t).select(*casts(api)).collect()
        return pa.table({n: out[n].cast(pa.int64())
                         if pa.types.is_timestamp(out[n].type) else out[n]
                         for n in out.column_names})
    got, want = query(torch_api()), query(jax_api())
    assert_tables_equal(got, want)
    if casts is _saturating_casts:
        assert got["f64_long"].to_pylist()[:4] == [2 ** 63 - 1] * 4
    else:
        assert got["ts_date"].cast(pa.int32()).to_pylist() == \
            [0, -1, 3, -2, None, 19675]
