"""The file readers in the port against the JAX package: the reader cases
of tests/test_io.py (CSV, ORC and JSON round trips, a multi-file scan,
CSV without a header, hive partition discovery, partition-value escaping,
reordered columns, partition-file pruning, the Avro round trip and
aggregate), a mixed hive layout's error, null and integer partition
values, CSV type pinning, and the formats phase's reader shapes of
chip_smoke.py at 20,000 lineitem rows.

Files are written with pyarrow, the JAX package's writers or the port's
``io/avro.write_avro``. Each program runs through the JAX package's
device path (on the CPU here) and the port's device path and CPU
backend, Parquet on both decode routes (host and device); answers
compare with tests/asserts.py ``assert_tables_equal``, exactly but for
the float sums of bench.py's shapes, relative 1e-12.
"""
import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pcsv
import pyarrow.parquet as pq
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.io.avro import read_avro as jax_read_avro
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.io.avro import read_avro, write_avro

DECODE = "spark.rapids.sql.decode.device.enabled"


def _t(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(np.array(["a", "b", "c"], object)[rng.integers(0, 3,
                                                                     n)]),
        "i": pa.array(rng.integers(-100, 100, n).astype(np.int64)),
        "f": pa.array(np.round(rng.uniform(-5, 5, n), 4)),
    })


def both(build, conf=None, ignore_order=True, approx=None):
    """build(api, session) in both packages: the port's device and CPU
    answers equal the JAX package's. Returns (port table, port
    session)."""
    got = {}
    for name, api in (("torch", torch_api()), ("jax", jax_api())):
        s = api.session(conf)
        df = build(api, s)
        got[name] = df.collect()
        if name == "torch":
            got["torch_cpu"] = df.collect_cpu()
            port_s = s
    for other in ("jax", "torch_cpu"):
        assert_tables_equal(got["torch"], got[other],
                            ignore_order=ignore_order, approx_float=approx)
    return got["torch"], port_s


def _scan(session):
    return [e for e in session.last_exec.walk()
            if isinstance(e, (X.ParquetScanExec, X.EncodedParquetSourceExec,
                              X.TextScanExec))]


def _jax_write(t, path, fmt, parts=1, partition_by=None):
    s = jax_api().session()
    w = s.create_dataframe(t, num_partitions=parts).write
    if partition_by:
        w = w.partition_by(partition_by)
    getattr(w, fmt)(path)


# -- tests/test_io.py's reader cases ---------------------------------------

def test_csv_write_read_roundtrip(tmp_path):
    path = str(tmp_path / "out_csv")
    _jax_write(_t(), path, "csv")
    out, s = both(lambda api, s: s.read_csv(path).group_by("k").agg(
        api.F.sum(api.col("i"))))
    assert out.num_rows == 3 and type(_scan(s)[0]) is X.TextScanExec


def test_orc_write_read_roundtrip(tmp_path):
    path = str(tmp_path / "out_orc")
    _jax_write(_t(), path, "orc")
    out, _ = both(lambda api, s: s.read_orc(path))
    assert out.num_rows == 50


def test_json_write_read_roundtrip(tmp_path):
    t = _t(20)
    path = str(tmp_path / "out_json")
    _jax_write(t, path, "json")
    out, _ = both(lambda api, s: s.read_json(path).agg(
        api.F.sum(api.col("i"))))
    assert list(out.to_pydict().values())[0][0] == sum(t["i"].to_pylist())


@pytest.mark.parametrize("device_decode", [True, False])
def test_multifile_scan(tmp_path, device_decode):
    path = str(tmp_path / "multi")
    _jax_write(_t(40), path, "parquet", parts=4)
    out, s = both(lambda api, s: s.read_parquet(path).filter(
        api.col("i") > api.lit(0)), conf={DECODE: device_decode})
    assert s.last_exec.num_partitions == len(
        [f for f in os.listdir(path) if f.endswith(".parquet")])


def test_csv_no_header(tmp_path):
    p = str(tmp_path / "raw.csv")
    with open(p, "w") as f:
        f.write("1,foo\n2,bar\n")
    out, _ = both(lambda api, s: s.read_csv(p, header=False))
    assert out.num_rows == 2 and len(out.column_names) == 2


@pytest.mark.parametrize("device_decode", [True, False])
def test_partitioned_roundtrip_with_discovery(tmp_path, device_decode):
    t = _t()
    path = str(tmp_path / "disc")
    _jax_write(t, path, "parquet", partition_by="k")
    out, _ = both(lambda api, s: s.read_parquet(path).group_by("k").agg(
        api.F.sum(api.col("i")), api.F.count(api.col("f"))),
        conf={DECODE: device_decode})
    want = {k: sum(i for kk, i in zip(t["k"].to_pylist(),
                                      t["i"].to_pylist()) if kk == k)
            for k in "abc"}
    assert {r["k"]: list(r.values())[1] for r in out.to_pylist()} == want


def test_partition_value_escaping(tmp_path):
    t = pa.table({"k": ["a/b", "c=d", "plain"], "v": [1, 2, 3]})
    path = str(tmp_path / "esc")
    _jax_write(t, path, "parquet", partition_by="k")
    out, _ = both(lambda api, s: s.read_parquet(path).select(api.col("k"),
                                                             api.col("v")))
    assert sorted(out.column("k").to_pylist()) == ["a/b", "c=d", "plain"]


@pytest.mark.parametrize("device_decode", [True, False])
def test_read_columns_reordered(tmp_path, device_decode):
    path = str(tmp_path / "ord")
    _jax_write(_t(10), path, "parquet")
    out, _ = both(lambda api, s: s.read_parquet(path, columns=["f", "k"]),
                  conf={DECODE: device_decode}, ignore_order=False)
    assert out.column_names == ["f", "k"]
    # partition columns come last, whatever the requested order
    hive = str(tmp_path / "hive")
    _jax_write(_t(10), hive, "parquet", partition_by="k")
    out, _ = both(lambda api, s: s.read_parquet(hive, columns=["k", "f"]),
                  conf={DECODE: device_decode})
    assert out.column_names == ["f", "k"]


@pytest.mark.parametrize("device_decode", [True, False])
def test_parquet_partition_file_pruning(tmp_path, device_decode):
    path = str(tmp_path / "pt")
    _jax_write(_t(60), path, "parquet", partition_by="k")
    out, s = both(lambda api, s: s.read_parquet(path).filter(
        api.col("k") == api.lit("b")), conf={DECODE: device_decode})
    scan, = _scan(s)
    assert len(scan._kept_files) == 1 < len(scan.plan.paths)
    assert scan.metrics["numFilesPruned"] == len(scan.plan.paths) - 1
    assert set(out.column("k").to_pylist()) == {"b"}


def test_avro_roundtrip(tmp_path):
    t = pa.table({
        "i": pa.array([1, None, 3], pa.int32()),
        "l": pa.array([10, 20, None], pa.int64()),
        "f": pa.array([1.5, None, -2.5], pa.float64()),
        "s": pa.array(["a", "bb", None]),
        "b": pa.array([True, None, False]),
        "d": pa.array([datetime.date(2020, 1, 2), None,
                       datetime.date(1999, 12, 31)], pa.date32()),
        "ts": pa.array([datetime.datetime(2020, 1, 2, 3, 4, 5), None,
                        datetime.datetime(1970, 1, 1)], pa.timestamp("us")),
    })
    for codec in ("null", "deflate"):
        path = str(tmp_path / f"t_{codec}.avro")
        write_avro(path, t, codec=codec)
        assert read_avro(path).to_pylist() == t.to_pylist()
        # the port's writer, the JAX package's reader
        assert jax_read_avro(path).equals(read_avro(path))
        both(lambda api, s: s.read_avro(path).filter(
            api.col("l") > api.lit(5)))


def test_avro_aggregate(tmp_path):
    t = pa.table({"k": pa.array(["x", "y", "x", "x"]),
                  "v": pa.array([1, 2, 3, 4], pa.int64())})
    path = str(tmp_path / "agg.avro")
    write_avro(path, t, codec="deflate")
    out, _ = both(lambda api, s: s.read_avro(path).group_by(
        api.col("k")).agg(api.F.sum("v").alias("sv")))
    assert sorted(out.to_pylist(), key=lambda r: r["k"]) == [
        {"k": "x", "sv": 8}, {"k": "y", "sv": 2}]


# -- layouts and types ------------------------------------------------------

def test_mixed_hive_layout_raises_as_the_jax_package(tmp_path):
    root = tmp_path / "mixed"
    (root / "k=1").mkdir(parents=True)
    (root / "other").mkdir()
    pq.write_table(_t(5), str(root / "k=1" / "a.parquet"))
    pq.write_table(_t(5), str(root / "other" / "b.parquet"))
    msgs = []
    for api in (torch_api(), jax_api()):
        with pytest.raises(ValueError, match="mixed layout") as e:
            api.session().read_parquet(str(root))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(FileNotFoundError):
        torch_api().session().read_parquet(str(tmp_path / "none*.parquet"))


@pytest.mark.parametrize("device_decode", [True, False])
def test_null_and_integer_partition_values(tmp_path, device_decode):
    root = tmp_path / "nulls"
    for y, k in (("2020", "a%20b"), ("2021", "__HIVE_DEFAULT_PARTITION__"),
                 ("__HIVE_DEFAULT_PARTITION__", "c")):
        d = root / f"y={y}" / f"k={k}"
        d.mkdir(parents=True)
        pq.write_table(_t(7, seed=len(str(d))).drop(["k"]),
                       str(d / "part-0.parquet"))
    out, s = both(lambda api, s: s.read_parquet(str(root)).filter(
        api.col("y") >= api.lit(2021)).group_by("y", "k").agg(
        api.F.count(api.col("i")).alias("n")), conf={DECODE: device_decode})
    assert out.to_pylist() == [{"y": 2021, "k": None, "n": 7}]
    scan, = _scan(s)
    assert scan.plan.schema.types[-2:] == [torch_api().T.INT64,
                                           torch_api().T.STRING]
    # y >= 2021 refutes the 2020 file; a null partition value refutes
    # every comparison
    assert len(scan._kept_files) == 1
    out, _ = both(lambda api, s: s.read_parquet(str(root)).select(
        api.col("k"), api.col("y")), conf={DECODE: device_decode})
    assert sorted(map(str, out.column("k").to_pylist())) == \
        ["None"] * 7 + ["a b"] * 7 + ["c"] * 7


def test_csv_types_pinned_to_the_first_block(tmp_path):
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    with open(a, "w") as f:
        f.write("x,y\n1,p\n2,q\n")
    with open(b, "w") as f:
        f.write("x,y\n3,r\n4,s\n")
    out, s = both(lambda api, s: s.read_csv(a, b).select(
        (api.col("x") * api.lit(2)).alias("x2"), api.col("y")))
    assert out.column("x2").to_pylist() == [2, 4, 6, 8]
    assert s.last_exec.num_partitions == 2


# -- the formats phase's reader shapes (chip_smoke.py) ----------------------

@pytest.fixture(scope="module")
def formats_files(tmp_path_factory):
    li, od = H.make_tables(20_000)
    d = tmp_path_factory.mktemp("formats")
    hive = str(d / "hive")
    assert H.write_hive_lineitem(li, hive, row_group_size=4096) == 6
    csv = str(d / "lineitem.csv")
    pcsv.write_csv(li.slice(0, 5000), csv)
    orders = od.set_column(1, "o_orderdate",
                           od.column("o_orderdate").cast(pa.date32()))
    orc = str(d / "orders.orc")
    import pyarrow.orc as porc
    porc.write_table(orders, orc)
    avro = str(d / "orders.avro")
    write_avro(avro, orders.slice(0, 600), codec="deflate")
    return {"hive": hive, "csv": csv, "orc": orc, "avro": avro}


@pytest.mark.parametrize("shape,device_decode", [
    ("fm_hive_q1", True), ("fm_hive_q1", False),
    ("fm_hive_pruned", True), ("fm_csv_q1", None), ("fm_orc", None),
    ("fm_avro", None)])
def test_smoke_reader_shapes(formats_files, shape, device_decode):
    def build(api, s):
        if shape == "fm_hive_q1":
            return H.q1(api, s.read_parquet(formats_files["hive"]))
        if shape == "fm_hive_pruned":
            return H.fm_hive_pruned(api, s.read_parquet(formats_files["hive"]))
        if shape == "fm_csv_q1":
            return H.q1(api, s.read_csv(formats_files["csv"]))
        reader = s.read_orc if shape == "fm_orc" else s.read_avro
        return H.orders_by_year(api, reader(formats_files[shape[3:]]))
    conf = None if device_decode is None else {DECODE: device_decode}
    out, s = both(build, conf=conf, approx=1e-12)
    assert out.num_rows > 0
    if shape == "fm_hive_pruned":
        scan, = _scan(s)
        assert (len(scan._kept_files), len(scan.plan.paths)) == (2, 6)


# -- ROADMAP C24: a string partition column used as a boolean --------------

def _bool_partitions(tmp_path):
    root = tmp_path / "flags"
    for b in ("true", "false"):
        d = root / f"b={b}"
        d.mkdir(parents=True)
        pq.write_table(_t(6, seed=len(b)).drop(["k"]),
                       str(d / "part-0.parquet"))
    return str(root)


def test_string_partition_column_as_a_boolean_c24(tmp_path):
    """Both packages type a hive column of true/false values STRING, as
    Spark does. A filter on it alone is Spark's analysis error
    DATATYPE_MISMATCH.FILTER_NOT_BOOLEAN, raised by the port when the
    plan is built; ``b == true`` casts the string to a boolean, by Spark's
    coercion, and answers the true partition's rows. The JAX package
    fails both at run time on its device (a fault of the reference)."""
    from spark_rapids_tpu_torch.expr.core import SparkException
    root = _bool_partitions(tmp_path)
    api = torch_api()
    df = api.session().read_parquet(root)
    assert df.plan.schema.types[-1] == api.T.STRING
    with pytest.raises(SparkException, match="FILTER_NOT_BOOLEAN"):
        df.filter(api.col("b"))
    for dev in (True, False):
        s = api.session({DECODE: dev})
        df = s.read_parquet(root).filter(
            api.col("b") == api.lit(True)).select(api.col("i"), api.col("b"))
        got = df.collect()
        assert_tables_equal(got, df.collect_cpu(), ignore_order=True)
        want = _t(6, seed=len("true"))["i"].to_pylist()
        assert sorted(got["i"].to_pylist()) == sorted(want)
        assert set(got["b"].to_pylist()) == {"true"}
    japi = jax_api()
    jdf = japi.session().read_parquet(root)
    with pytest.raises(AttributeError, match="astype"):
        jdf.filter(japi.col("b")).collect()
    with pytest.raises(Exception, match="string indexing"):
        jdf.filter(japi.col("b") == japi.lit(True)).collect()
