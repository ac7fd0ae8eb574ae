"""The port's writers against the JAX package: ``DataFrame.write``
(``io/writer.py``: Parquet, ORC, CSV and JSON, ``partition_by`` with
``__HIVE_DEFAULT_PARTITION__`` and escaping, the modes,
maxRecordsPerFile as an option and as spark.sql.files.maxRecordsPerFile,
``WriteStats`` / ``last_write_stats``, ``_SUCCESS``) and the async write
throttle (``io/async_io.py``).

These are tests/test_io.py's write cases (:31-98, :116-163, :409) with the
port writing; the files are read back by both packages, and the
answers compare with tests/asserts.py ``assert_tables_equal`` against
the written table and against the JAX package's reads.
"""
import logging
import os
import threading
import time
from collections import Counter

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu_torch.io.async_io import (
    ThrottlingExecutor, TrafficController,
)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _t(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(np.array(["a", "b", "c"], object)[rng.integers(0, 3,
                                                                     n)]),
        "i": pa.array(rng.integers(-100, 100, n).astype(np.int64)),
        "f": pa.array(np.round(rng.uniform(-5, 5, n), 4)),
    })


def _port():
    return torch_api().session()


def _read_both(fmt, path, build=None, **kw):
    """(port table, JAX table) of ``build(api, reader(path))`` in both
    packages; the port's device answer also equals its CPU backend's."""
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        df = getattr(s, f"read_{fmt}")(path, **kw)
        if build is not None:
            df = build(api, df)
        out.append(df.collect())
        if len(out) == 1:
            assert_tables_equal(out[0], df.collect_cpu(), ignore_order=True)
    assert_tables_equal(out[0], out[1], ignore_order=True)
    return out[0]


def _sorted(t: pa.Table, names):
    return t.select(names).sort_by([(n, "ascending") for n in names])


def test_parquet_write_read_roundtrip(tmp_path):
    t = _t()
    path = str(tmp_path / "out_parquet")
    _port().create_dataframe(t, num_partitions=3).write.parquet(path)
    assert os.path.exists(os.path.join(path, "_SUCCESS"))
    assert len([f for f in os.listdir(path) if f.endswith(".parquet")]) == 3
    back = _read_both("parquet", path)
    assert _sorted(back, t.schema.names).equals(_sorted(t, t.schema.names))


def test_csv_write_read_roundtrip(tmp_path):
    t = _t()
    path = str(tmp_path / "out_csv")
    _port().create_dataframe(t).write.csv(path)
    back = _read_both("csv", path, lambda api, df: df.group_by("k").agg(
        api.F.sum(api.col("i")).alias("si"), api.F.count().alias("n")))
    want = {k: (sum(i for kk, i in zip(t["k"].to_pylist(),
                                       t["i"].to_pylist()) if kk == k),
                c) for k, c in Counter(t["k"].to_pylist()).items()}
    assert {r["k"]: (r["si"], r["n"]) for r in back.to_pylist()} == want


def test_orc_write_read_roundtrip(tmp_path):
    t = _t()
    path = str(tmp_path / "out_orc")
    _port().create_dataframe(t).write.orc(path)
    back = _read_both("orc", path)
    assert _sorted(back, t.schema.names).equals(_sorted(t, t.schema.names))


def test_json_write_read_roundtrip(tmp_path):
    t = _t(20)
    path = str(tmp_path / "out_json")
    _port().create_dataframe(t).write.json(path)
    back = _read_both("json", path, lambda api, df: df.agg(
        api.F.sum(api.col("i")).alias("si"), api.F.count().alias("n")))
    assert back.to_pylist() == [{"si": sum(t["i"].to_pylist()), "n": 20}]


def test_partitioned_write_layout(tmp_path):
    t = _t()
    path = str(tmp_path / "out_part")
    _port().create_dataframe(t).write.partition_by("k").parquet(path)
    subdirs = sorted(d for d in os.listdir(path) if d.startswith("k="))
    assert subdirs == ["k=a", "k=b", "k=c"]
    # reading a single partition dir yields only that key's rows
    one = _read_both("parquet", os.path.join(path, "k=a"))
    assert one.num_rows == sum(1 for v in t["k"].to_pylist() if v == "a")
    assert "k" not in one.schema.names  # not duplicated in the files
    # the root reads back through hive discovery in both packages
    got = _read_both("parquet", path, lambda api, df: df.group_by("k").agg(
        api.F.count().alias("n"), api.F.sum(api.col("i")).alias("si")))
    assert {r["k"]: r["n"] for r in got.to_pylist()} == \
        dict(Counter(t["k"].to_pylist()))


def test_partition_nulls_and_escaping(tmp_path):
    t = pa.table({"k": ["a/b", "c=d", None, "plain", None],
                  "v": [1, 2, 3, 4, 5]})
    path = str(tmp_path / "esc")
    w = _port().create_dataframe(t, num_partitions=2).write
    w.partition_by("k").parquet(path)
    dirs = sorted(d for d in os.listdir(path) if d.startswith("k="))
    assert "k=__HIVE_DEFAULT_PARTITION__" in dirs
    assert all("/" not in d[2:] for d in dirs) and len(dirs) == 4
    assert w.last_write_stats["numParts"] == 4
    back = _read_both("parquet", path)
    assert sorted(back.to_pylist(), key=lambda r: r["v"]) == t.to_pylist()


def test_write_modes(tmp_path):
    t = _t(10)
    path = str(tmp_path / "out_modes")
    df = _port().create_dataframe(t)
    df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.mode("errorifexists").parquet(path)
    df.write.mode("append").parquet(path)
    assert _read_both("parquet", path).num_rows == 20
    df.write.mode("overwrite").parquet(path)
    assert _read_both("parquet", path).num_rows == 10


def test_multifile_write_and_filter(tmp_path):
    path = str(tmp_path / "multi")
    _port().create_dataframe(_t(40), num_partitions=4).write.parquet(path)
    s = _port()
    df = s.read_parquet(path)
    assert df.count() == 40
    assert len(df.plan.paths) == 4  # one partition per file
    _read_both("parquet", path, lambda api, d: d.filter(
        api.col("i") > api.lit(0)))


def test_max_records_per_file_and_write_stats(tmp_path):
    t = pa.table({"k": pa.array((np.arange(100) % 4).astype(np.int64)),
                  "v": pa.array(np.arange(100).astype(np.float64))})
    stats = {}
    for name, api in (("torch", torch_api()), ("jax", jax_api())):
        df = api.session().create_dataframe(t)
        w = df.write.mode("overwrite").option("maxRecordsPerFile", 30)
        p = str(tmp_path / f"out_{name}")
        w.parquet(p)
        files = [f for f in os.listdir(p) if f.endswith(".parquet")]
        assert len(files) == 4  # 100 rows / 30 -> 4 part files
        assert sum(pq.ParquetFile(os.path.join(p, f)).metadata.num_rows
                   for f in files) == 100
        st = dict(w.last_write_stats)
        assert st["numOutputBytes"] > 0
        assert df.last_write_stats == st
        assert df.session.last_write_stats == st
        w2 = df.write.mode("overwrite").partition_by("k")
        w2.parquet(str(tmp_path / f"out2_{name}"))
        stats[name] = (st["numFiles"], st["numOutputRows"], st["numParts"],
                       w2.last_write_stats["numParts"],
                       w2.last_write_stats["numOutputRows"])
    assert stats["torch"] == stats["jax"] == (4, 100, 0, 4, 100)


def test_max_records_per_file_conf(tmp_path):
    s = torch_api().session({"spark.sql.files.maxRecordsPerFile": "7"})
    p = str(tmp_path / "conf")
    s.create_dataframe(_t(40), num_partitions=2).write.parquet(p)
    files = [f for f in os.listdir(p) if f.endswith(".parquet")]
    assert len(files) == 6  # two partitions of 20 rows: 3 files each
    assert s.last_write_stats["numFiles"] == 6
    assert _read_both("parquet", p).num_rows == 40


def test_write_of_a_query_matches_jax(tmp_path):
    """A grouped query over a serialized exchange, written as a task wave
    of 4 partitions, holds the rows the JAX package's write holds."""
    t = _t(400, seed=8)
    tables = []
    for name, api in (("torch", torch_api()), ("jax", jax_api())):
        s = api.session({"spark.rapids.shuffle.mode": "SERIALIZED"})
        df = s.create_dataframe(t, num_partitions=3).repartition(
            4, api.col("k")).filter(api.col("i") > api.lit(-50)).select(
            api.col("k"), (api.col("i") * api.lit(2)).alias("i2"),
            api.col("f"))
        p = str(tmp_path / name)
        df.write.partition_by("k").parquet(p)
        tables.append(pq.read_table(p).select(["i2", "f", "k"]))
    assert_tables_equal(tables[0].cast(tables[1].schema), tables[1],
                        ignore_order=True)


def test_traffic_controller_bounds_inflight():
    tc = TrafficController(100)
    ex = ThrottlingExecutor(4, tc)
    peak = []

    def work():
        peak.append(tc.in_flight)
        time.sleep(0.01)

    fs = [ex.submit(60, work) for _ in range(6)]
    for f in fs:
        f.result()
    ex.shutdown()
    assert max(peak) <= 100  # never two 60-byte writes in flight
    assert tc.in_flight == 0


def test_traffic_controller_stall_warning(caplog):
    ctrl = TrafficController(100, stall_warn_s=0.05)
    ctrl.acquire(80)
    release = threading.Timer(0.25, ctrl.release, args=(80,))
    release.start()
    with caplog.at_level(logging.WARNING, logger="spark_rapids_tpu_torch"):
        t0 = time.monotonic()
        ctrl.acquire(80)  # blocks past the 50ms warn threshold
        waited = time.monotonic() - t0
    release.join()
    ctrl.release(80)
    assert waited >= 0.2  # admission semantics unchanged: it WAITED
    assert sum("async write throttle stalled" in r.message
               for r in caplog.records) == 1
