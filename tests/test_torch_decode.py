"""Device-side Parquet decode of the PyTorch port against the JAX package.

The port's host half (``io/encoded.py``) must build the same numpy planes
as the JAX package's on the same file, and its decode (``ops/decode.py``
with the bitslice wrapper, which runs its plain version here because the
tensors lie on the CPU) must produce the same column planes as
``pallas_decode.decode_batch``, whose bit-slice runs as a Pallas kernel in
interpret mode. Every decode comparison is exact, over the padded tail
too. The files come from the generator of ``tests/test_device_decode.py``.

At the session level, ``read_parquet`` queries through
``TorchSession(device="cpu")`` are held to the JAX ``TpuSession``: keys
and counts exactly, plain float64 reductions to a relative 1e-12 (XLA and
ATen sum in different orders), the packed segsum route exactly.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from asserts import assert_tables_equal
from test_device_decode import MIXED_KINDS, _col, _with_nulls
from torch_port_helpers import (
    jax_api, make_lineitem, q1, q6, repart_agg, torch_api,
)

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.io import encoded as JE
from spark_rapids_tpu.ops import pallas_decode as JPD

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.io import encoded as E
from spark_rapids_tpu_torch.ops import bitslice as BS
from spark_rapids_tpu_torch.ops import decode as D

DEVICE_ON = {"spark.rapids.sql.decode.device.enabled": "true"}
DEVICE_OFF = {"spark.rapids.sql.decode.device.enabled": "false"}
BENCH_WRITE = dict(use_dictionary=["l_shipdate", "l_quantity",
                                   "l_returnflag", "l_linestatus"],
                   compression="snappy", data_page_version="1.0")


# ---------------------------------------------------------------------------
# the bit-slice
# ---------------------------------------------------------------------------

def _bitslice_inputs(n=4096, n_words=1000, seed=0):
    """Random words and masks of widths 0-32, with offsets that start on
    a word (sh == 0), fall in the last word and run past the plane (the
    clamp applies)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, n_words, dtype=np.uint64
                         ).astype(np.uint32)
    bitoff = rng.integers(0, n_words * 32 + 500, n).astype(np.int64)
    bitoff[:64] = np.arange(64) * 32                      # sh == 0
    bitoff[64:96] = (n_words - 1) * 32 + np.arange(32)   # last word
    width = rng.integers(0, 33, n)
    width[:8] = 32
    mask = np.where(width >= 32, 0xFFFFFFFF,
                    (1 << (width % 32)) - 1).astype(np.uint32)
    return words, bitoff, mask, width


def _jax_bitslice(words, bitoff, mask, kernel):
    widx = np.clip(bitoff >> 5, 0, len(words) - 2)
    sh = (bitoff & 31).astype(np.uint32)
    out = kernel(jnp.asarray(words[widx]), jnp.asarray(words[widx + 1]),
                 jnp.asarray(sh), jnp.asarray(mask))
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitslice_plain_matches_pallas_kernel_and_lax_twin(seed):
    words, bitoff, mask, _ = _bitslice_inputs(seed=seed)
    got = BS.bitslice(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(bitoff),
                      torch.from_numpy(mask.view(np.int32)))
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, _jax_bitslice(words, bitoff, mask, JPD.bitslice_u32_pallas))
    np.testing.assert_array_equal(
        got, _jax_bitslice(words, bitoff, mask, JPD.bitslice_u32_lax))


def test_bitslice_takes_any_length():
    # the TPU kernel needs 1024-row blocks; the port's takes any n
    words, bitoff, mask, _ = _bitslice_inputs(n=3000, seed=4)
    got = BS.bitslice(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(bitoff[:1001]),
                      torch.from_numpy(mask.view(np.int32)[:1001]))
    want = _jax_bitslice(words, bitoff[:1001], mask[:1001],
                         JPD.bitslice_u32_lax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_width_mask_and_words_match_jax():
    width = np.arange(33, dtype=np.int32)
    got = BS.width_mask(torch.from_numpy(width)).numpy().view(np.uint32)
    want = np.array([(1 << w) - 1 for w in range(33)], np.uint64
                    ).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    pool = np.random.default_rng(1).integers(0, 256, 4096).astype(np.uint8)
    np.testing.assert_array_equal(
        BS.words_of(torch.from_numpy(pool)).numpy().view(np.uint32),
        np.asarray(JPD._words(jnp.asarray(pool))))


def test_bitslice_wrapper_checks_inputs():
    w = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(4, dtype=torch.int64)
    m = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        BS.bitslice(w.to(torch.int64), b, m)
    with pytest.raises(TypeError):
        BS.bitslice(w[:1], b, m)
    with pytest.raises(TypeError):
        BS.bitslice(w, b.to(torch.int32), m)
    with pytest.raises(TypeError):
        BS.bitslice(w, b, m[:3])
    before = BS.launches
    BS.bitslice(w, b, m)
    assert BS.launches == before  # the plain version is no launch


# ---------------------------------------------------------------------------
# host planes and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _same_min_capacity(monkeypatch):
    # a JAX session publishes its capacity floor process-wide; the port's
    # default floor is the JAX conf's default, so pin the JAX side to it
    from spark_rapids_tpu.columnar import batch as JB
    from spark_rapids_tpu_torch.columnar import batch as PB
    monkeypatch.setattr(JB, "MIN_CAPACITY", PB.MIN_CAPACITY)


def _fields(pkg_types, spec):
    return [pkg_types.StructField(n, getattr(pkg_types, type(dt).__name__)())
            for n, dt in spec]


def _both_batches(path, spec, batch_rows=1 << 20, **kw):
    """The port's and the JAX package's host batches of one file."""
    md = pq.ParquetFile(path).metadata
    groups = list(range(md.num_row_groups))
    port = list(E.read_encoded_batches(path, md, groups, _fields(PT, spec),
                                       batch_rows, **kw))
    ref = list(JE.read_encoded_batches(path, md, groups, _fields(JT, spec),
                                       batch_rows, **kw))
    assert len(port) == len(ref)
    return port, ref


def _assert_planes_equal(hp, hj):
    assert (hp.num_rows, hp.cap, hp.fallback, hp.encoded_bytes) == (
        hj.num_rows, hj.cap, hj.fallback,
        hj.encoded_bytes - sum(8 for c in hj.columns if c is not None))
    for cp, cj in zip(hp.columns, hj.columns):
        assert (cp is None) == (cj is None)
        if cp is None:
            continue
        assert (cp.kind, cp.meta, cp.bounds) == (cj.kind, cj.meta, cj.bounds)
        assert cp.nnz == int(cj.planes["nnz"][0])
        assert set(cp.planes) == set(cj.planes) - {"nnz"}
        for k, v in cp.planes.items():
            assert v.dtype == cj.planes[k].dtype, k
            np.testing.assert_array_equal(v, cj.planes[k], err_msg=k)


def _assert_decode_equal(hp, hj, table, spec):
    """Port decode == JAX decode, plane for plane over the whole capacity,
    and == pyarrow over the live rows."""
    got = D.decode_batch(E.upload(hp, {}, "cpu"))
    want = JPD.decode_batch(JE.upload(hj, {}))
    assert got.num_rows == int(want.num_rows) == hp.num_rows
    for (name, _), cp, cj in zip(spec, got.columns, want.columns):
        np.testing.assert_array_equal(cp.data.numpy(), np.asarray(cj.data),
                                      err_msg=name)
        assert (cp.validity is None) == (cj.validity is None), name
        if cp.validity is not None:
            np.testing.assert_array_equal(cp.validity.numpy(),
                                          np.asarray(cj.validity))
        assert cp.bounds == cj.bounds
        n = hp.num_rows
        assert not cp.data[n:].any(), f"{name}: nonzero padded tail"
        host = table.column(name).combine_chunks()
        valid = ~np.asarray(host.is_null())
        data = host.fill_null(False if pa.types.is_boolean(host.type) else 0)
        if pa.types.is_timestamp(host.type):
            data = data.cast(pa.int64())
        pv = np.ones(n, bool) if cp.validity is None \
            else cp.validity[:n].numpy()
        np.testing.assert_array_equal(pv, valid, err_msg=name)
        np.testing.assert_array_equal(
            np.where(valid, cp.data[:n].numpy(), 0),
            np.where(valid, np.asarray(data).astype(cp.data.numpy().dtype),
                     0), err_msg=name)


def _roundtrip(tmp_path, table, spec, name="m.parquet", **write_kw):
    path = str(tmp_path / name)
    pq.write_table(table, path, **write_kw)
    port, ref = _both_batches(path, spec)
    for hp, hj in zip(port, ref):
        assert not hp.fallback, hp.fallback
        _assert_planes_equal(hp, hj)
        _assert_decode_equal(hp, hj, table, spec)
    assert sum(h.num_rows for h in port) == table.num_rows


@pytest.mark.parametrize("nulls", ["none", "sparse", "dense", "all"])
def test_decode_matches_jax_null_densities(tmp_path, nulls):
    rng = np.random.default_rng(7)
    n = 3000
    cols, spec = {}, []
    for kind in MIXED_KINDS:
        arr, dt = _col(rng, n, kind)
        cols[kind] = _with_nulls(rng, arr, nulls)
        spec.append((kind, dt))
    # small pages and row groups: multi-page definition-level splicing and
    # per-page dictionary widths
    _roundtrip(tmp_path, pa.table(cols), spec, compression="SNAPPY",
               row_group_size=1200, use_dictionary=["i32_dict"],
               data_page_size=4096, data_page_version="1.0")


@pytest.mark.parametrize("n", [8, 1023, 1024, 1025, 4096, 4097])
def test_decode_matches_jax_bucket_boundaries(tmp_path, n):
    rng = np.random.default_rng(n)
    arr, dt = _col(rng, n, "i64_plain")
    b, bt = _col(rng, n, "bool")
    d, ddt = _col(rng, n, "i32_dict")
    _roundtrip(tmp_path, pa.table({"v": _with_nulls(rng, arr, "sparse"),
                                   "b": b, "d": d}),
               [("v", dt), ("b", bt), ("d", ddt)], use_dictionary=["d"],
               data_page_version="1.0")


@pytest.mark.parametrize("nulls", ["none", "sparse"])
def test_decode_matches_jax_delta_restarts(tmp_path, nulls):
    rng = np.random.default_rng(3)
    arr, dt = _col(rng, 12000, "i64_delta")
    # tiny pages: every page restarts its own delta stream
    _roundtrip(tmp_path, pa.table({"d": _with_nulls(rng, arr, nulls)}),
               [("d", dt)], use_dictionary=False,
               column_encoding={"d": "DELTA_BINARY_PACKED"},
               row_group_size=5000, data_page_size=2048,
               data_page_version="1.0")


def test_decode_matches_jax_rle_booleans(tmp_path):
    rng = np.random.default_rng(5)
    runs = np.repeat(rng.random(30) < 0.5, 150)
    arr = pa.array(np.concatenate([runs, rng.random(900) < 0.5]))
    _roundtrip(tmp_path, pa.table({"b": arr}), [("b", JT.BooleanType())],
               use_dictionary=False, column_encoding={"b": "RLE"},
               data_page_version="1.0")


def test_decode_matches_jax_date_timestamp(tmp_path):
    rng = np.random.default_rng(11)
    n = 3000
    t = pa.table({
        "d": pa.array(rng.integers(8000, 12000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 2 ** 48, n).astype(np.int64),
                       pa.timestamp("us")),
    })
    _roundtrip(tmp_path, t, [("d", JT.DateType()),
                             ("ts", JT.TimestampType())],
               data_page_version="1.0")


def test_lineitem_planes_match_jax_and_decode_exactly(tmp_path):
    # bench.py's writer settings: dictionary shipdate/quantity codes,
    # PLAIN prices and keys, the two flags strings (a per-column fallback)
    t = make_lineitem(20_000)
    path = str(tmp_path / "li.parquet")
    pq.write_table(t, path, row_group_size=4096, **BENCH_WRITE)
    spec = [(f.name, getattr(JT, type(PT.from_arrow(f.type)).__name__)())
            for f in t.schema]
    port, ref = _both_batches(path, spec, batch_rows=8192)
    assert len(port) == 3
    for hp, hj in zip(port, ref):
        _assert_planes_equal(hp, hj)
        assert set(hp.fallback) == {"l_returnflag", "l_linestatus"}
        kinds = {n: c.kind for (n, _), c in zip(spec, hp.columns) if c}
        assert kinds == {"l_orderkey": "plain", "l_quantity": "dict",
                         "l_extendedprice": "plain", "l_discount": "plain",
                         "l_shipdate": "dict"}


@pytest.mark.parametrize("conf,falls_back", [
    ({}, {"s"}), ({"delta_enabled": False}, {"s", "dl"}),
    ({"max_bits": 8}, {"s", "w", "dl"})],
    ids=["default", "delta-off", "max-bits-8"])
def test_fallback_reasons_match_jax(tmp_path, conf, falls_back):
    rng = np.random.default_rng(2)
    n = 2000
    t = pa.table({
        "s": pa.array(["a", "bb", None, "ccc"] * (n // 4)),
        "i": pa.array(np.arange(n, dtype=np.int64)),
        "w": pa.array(rng.integers(0, 1000, n).astype(np.int32)),
        "dl": pa.array(np.cumsum(rng.integers(0, 2000, n)).astype(np.int64)),
        "dec": pa.array([1, 2, None, 4] * (n // 4), pa.decimal128(9, 2)),
        "lst": pa.array([[1, 2], None, [3], []] * (n // 4)),
    })
    path = str(tmp_path / "fb.parquet")
    pq.write_table(t, path, use_dictionary=["w"],
                   column_encoding={"i": "PLAIN", "dl": "DELTA_BINARY_PACKED"},
                   data_page_version="1.0")
    spec = [("s", JT.StringType()), ("i", JT.Int64Type()),
            ("w", JT.Int32Type()), ("dl", JT.Int64Type())]
    port, ref = _both_batches(path, spec, **conf)
    assert port[0].fallback == ref[0].fallback
    assert set(port[0].fallback) == falls_back
    # the footer probe agrees with the JAX package's, unported types too
    pfields = _fields(PT, spec)
    assert E.probe_support(path, pfields) == JE.probe_support(
        path, _fields(JT, spec))
    assert E.probe_support(path, pfields[:1]) == {"s": port[0].fallback["s"]}


def test_probe_support_on_a_file_without_row_groups(tmp_path):
    path = str(tmp_path / "empty.parquet")
    pq.write_table(pa.table({"i": pa.array([], pa.int64())}), path)
    assert E.probe_support(path, _fields(PT, [("i", JT.Int64Type())])) == \
        JE.probe_support(path, _fields(JT, [("i", JT.Int64Type())]))


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem_file(tmp_path_factory):
    t = make_lineitem(60_000)
    path = str(tmp_path_factory.mktemp("pq") / "lineitem.parquet")
    # 8 row groups coalesced into 4 batches: the aggregates merge partials
    pq.write_table(t, path, row_group_size=8192, **BENCH_WRITE)
    return t, path


SMALL_BATCHES = {"spark.rapids.sql.reader.batchSizeRows": 16384}
Q6_COLS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q1_COLS = ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
           "l_extendedprice", "l_discount"]


def _scans(session):
    return [e for e in session.last_exec.walk()
            if isinstance(e, (X.EncodedParquetSourceExec,
                              X.ParquetScanExec))]


@pytest.mark.parametrize("query,cols,approx", [
    (q6, Q6_COLS, 1e-12), (q1, Q1_COLS, 1e-12),
    (repart_agg, ["l_shipdate", "l_quantity"], None)],
    ids=["pq_q6", "pq_q1_mixed", "pq_repart_agg"])
@pytest.mark.parametrize("conf", [DEVICE_ON, DEVICE_OFF],
                         ids=["device-decode", "host-decode"])
def test_parquet_queries_match_jax(lineitem_file, query, cols, approx, conf):
    _, path = lineitem_file
    J, P = jax_api(), torch_api()
    full = {**conf, **SMALL_BATCHES}
    ps = P.session(full)
    got = query(P, ps.read_parquet(path, columns=cols)).collect()
    want = query(J, J.session(full).read_parquet(path, columns=cols)
                 ).collect()
    assert_tables_equal(got, want, ignore_order=True, approx_float=approx)
    assert got.num_rows == {q6: 1, q1: 6, repart_agg: 2200}[query]
    scan, = _scans(ps)
    assert scan.metrics["numOutputRows"] == 60_000
    if conf is DEVICE_ON:
        assert isinstance(scan, X.EncodedParquetSourceExec)
        assert scan.metrics["numOutputBatches"] == 4
        want_fb = {"l_returnflag", "l_linestatus"} if query is q1 else set()
        assert set(scan.fallback_columns) == want_fb
        assert scan.metrics["numDecodeFallbackColumns"] == 4 * len(want_fb)
    else:
        assert isinstance(scan, X.ParquetScanExec)


def test_device_and_host_decode_scans_are_byte_identical(tmp_path,
                                                         lineitem_file):
    rng = np.random.default_rng(13)
    n = 4000
    cols = {kind: _col(rng, n, kind)[0] for kind in MIXED_KINDS}
    cols["i64_plain"] = _with_nulls(rng, cols["i64_plain"], "sparse")
    cols["f64"] = _with_nulls(rng, cols["f64"], "sparse")
    cols["s"] = pa.array(np.array(["aa", "bb", "cc", None], object)[
        rng.integers(0, 4, n)])
    mixed = str(tmp_path / "mixed.parquet")
    pq.write_table(pa.table(cols), mixed, row_group_size=1500,
                   compression="SNAPPY", data_page_version="1.0")
    P = torch_api()
    for path in (mixed, lineitem_file[1]):
        dev = P.session({**DEVICE_ON, **SMALL_BATCHES}).read_parquet(path)
        host = P.session({**DEVICE_OFF, **SMALL_BATCHES}).read_parquet(path)
        a, b = dev.collect(), host.collect()
        assert a.equals(b)
        assert a.equals(pq.read_table(path).cast(a.schema))


@pytest.mark.parametrize("reader", ["PERFILE", "MULTITHREADED",
                                    "COALESCING"])
def test_host_decode_reader_types_agree(lineitem_file, reader):
    t, path = lineitem_file
    P = torch_api()
    s = P.session({**DEVICE_OFF, **SMALL_BATCHES,
                   "spark.rapids.sql.format.parquet.reader.type": reader,
                   "spark.rapids.sql.multiThreadedRead.numThreads": 3})
    assert s.read_parquet(path).collect().equals(t)


def test_pruning_composes_with_device_decode(tmp_path, monkeypatch):
    # pruned row groups are never read or uploaded, and pruning plus
    # device decode equals the unpruned host decode
    n = 2000
    t = pa.table({"i": pa.array(np.arange(n, dtype=np.int64)),
                  "f": pa.array(np.linspace(-5.0, 5.0, n))})
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(t, path, row_group_size=200, data_page_version="1.0")
    P = torch_api()

    def q(s):
        return s.read_parquet(path).filter(P.col("i") >= P.lit(1500))

    sdev = P.session(DEVICE_ON)
    uploads = []
    orig = E.upload

    def spy(hb, *a, **k):
        uploads.append(list(hb.groups))
        return orig(hb, *a, **k)
    monkeypatch.setattr(E, "upload", spy)
    dev = q(sdev).collect()
    scan, = _scans(sdev)
    assert scan.metrics["numRowGroupsPruned"] == 7  # groups 0..6 refuted
    assert scan.metrics["numOutputRows"] == 600
    assert uploads == [[7, 8, 9]]
    host = q(P.session(DEVICE_OFF)).collect()
    assert dev.equals(host) and dev.num_rows == 500
    # the JAX package prunes the same groups
    J = jax_api()
    js = J.session(DEVICE_ON)
    j = js.read_parquet(path).filter(J.col("i") >= J.lit(1500)).collect()
    m = next(v for k, v in js.last_metrics().items()
             if k.startswith("EncodedParquetSourceExec"))
    assert m["numRowGroupsPruned"] == 7 and j.equals(dev)


def test_pushdown_renames_through_projections_and_ors_branches(tmp_path):
    n = 2000
    t = pa.table({"i": pa.array(np.arange(n, dtype=np.int64)),
                  "v": pa.array(np.arange(n, dtype=np.float64))})
    path = str(tmp_path / "p.parquet")
    pq.write_table(t, path, row_group_size=250)
    P = torch_api()
    s = P.session(DEVICE_ON)
    df = s.read_parquet(path).select(P.col("i").alias("k"), P.col("v"))
    out = df.filter(P.col("k") < P.lit(300)).collect()
    assert out.num_rows == 300
    scan, = _scans(s)
    assert scan.metrics["numRowGroupsPruned"] == 6
    # a computed column does not map to the file: no pruning, same answer
    df = s.read_parquet(path).select((P.col("i") + P.lit(0)).alias("k"))
    assert df.filter(P.col("k") < P.lit(300)).collect().num_rows == 300
    scan, = _scans(s)
    assert scan.metrics["numRowGroupsPruned"] == 0


def test_read_parquet_directories_and_hive_layout(tmp_path):
    t = make_lineitem(3000)
    d = tmp_path / "flat"
    d.mkdir()
    pq.write_table(t.slice(0, 1000), str(d / "a.parquet"))
    pq.write_table(t.slice(1000), str(d / "b.parquet"))
    pq.write_table(t.slice(0, 10), str(d / "_skip.parquet"))
    P = torch_api()
    df = P.session().read_parquet(str(d))
    assert df.collect().num_rows == 3000
    assert len(_scans(df.session)) == 1
    assert df.session.last_exec.num_partitions == 2
    cols = P.session().read_parquet(str(d), columns=["l_discount",
                                                     "l_shipdate"])
    assert cols.columns == ["l_discount", "l_shipdate"]
    with pytest.raises(KeyError):
        P.session().read_parquet(str(d), columns=["nope"]).columns
    # a k=v layout is a hive-partitioned scan: the partition column is
    # last, an integer, as in the JAX package (tests/test_torch_readers.py
    # holds the layouts against it)
    hive = tmp_path / "hive" / "k=1"
    hive.mkdir(parents=True)
    pq.write_table(t, str(hive / "a.parquet"))
    got = P.session().read_parquet(str(tmp_path / "hive"))
    assert got.columns == t.column_names + ["k"]
    assert set(got.collect().column("k").to_pylist()) == {1}
    with pytest.raises(FileNotFoundError):
        P.session().read_parquet(str(tmp_path / "none*.parquet"))


def test_unread_columns_of_unported_types_are_ignored(tmp_path):
    t = pa.table({"dec": pa.array([1, 2, None] * 100, pa.decimal128(9, 2)),
                  "i": pa.array(np.arange(300, dtype=np.int64))})
    path = str(tmp_path / "dec.parquet")
    pq.write_table(t, path)
    P = torch_api()
    for conf in (DEVICE_ON, DEVICE_OFF):
        df = P.session(conf).read_parquet(path, columns=["i"])
        assert df.collect().equals(t.select(["i"]))
    # decimals are a ported type now: the column decodes on the host, per
    # column, on both routes
    for conf in (DEVICE_ON, DEVICE_OFF):
        assert P.session(conf).read_parquet(path).collect().equals(t)


def test_timestamps_round_trip_through_both_routes(tmp_path):
    rng = np.random.default_rng(4)
    n = 3000
    t = pa.table({"ts": pa.array(rng.integers(0, 2 ** 48, n),
                                 pa.timestamp("us"),
                                 mask=rng.random(n) < 0.1)})
    path = str(tmp_path / "ts.parquet")
    pq.write_table(t, path)
    P = torch_api()
    for conf in (DEVICE_ON, DEVICE_OFF):
        assert P.session(conf).read_parquet(path).collect().equals(t)


@pytest.mark.cuda
def test_decode_on_card_matches_plain_version():
    # decided inside the test: collection must not depend on the machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    words, bitoff, mask, _ = _bitslice_inputs(n=1 << 20, n_words=1 << 16)
    w = torch.from_numpy(words.view(np.int32)).cuda()
    b = torch.from_numpy(bitoff).cuda()
    m = torch.from_numpy(mask.view(np.int32)).cuda()
    assert torch.equal(BS.bitslice(w, b, m), BS.bitslice_plain(w, b, m))
    assert torch.equal(BS.bitslice(w, b[5:-3], m[5:-3]),
                       BS.bitslice_plain(w, b[5:-3], m[5:-3]))
