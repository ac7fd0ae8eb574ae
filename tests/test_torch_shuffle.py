"""The port's serialized shuffle against the JAX package: the kudo wire
format (``shuffle/serde.py``: frames byte for byte the JAX package's for
codecs none and zlib and every column kind, blobs read across packages,
the C packer against its Python plain version, CRC and frame
corruption), the shuffle store's disk paging, the SERIALIZED mode of the
hash exchange (taken, streamed or not, with the same blob order; the
aggregate and the full join of tests/test_shuffle.py:121-151 against the
JAX package), the cross-process exchange (a directory written by the JAX
package in a subprocess and read by the port, a directory written by the
port in a subprocess that imports no JAX and read by the JAX package,
co-partitioning across packages) and tests/test_faults.py's serde and
shuffle cases (:388-436).

Answers compare with tests/asserts.py ``assert_tables_equal`` on live
rows.
"""
import decimal
import math
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from data_gen import DoubleGen, IntegerGen, LongGen, RepeatSeqGen, \
    StringGen, gen_df
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.columnar.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.shuffle import exchange_files as jax_files
from spark_rapids_tpu.shuffle import serde as jax_serde
from spark_rapids_tpu_torch.columnar.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.runtime import faults
from spark_rapids_tpu_torch.shuffle import exchange_files, serde
from spark_rapids_tpu_torch.shuffle.store import ShuffleStore

SERIALIZED = {"spark.rapids.shuffle.mode": "SERIALIZED"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        return set(a) == set(b) and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


def _kinds(n=300, seed=5):
    """One table per column kind of the wire format."""
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    ints = rng.integers(-10 ** 6, 10 ** 6, n)
    words = np.array(["", "a", "bb", "ccc", "déjà", "x" * 40], object)
    return {
        "fixed": pa.table({
            "i8": pa.array(ints.astype(np.int8), mask=nulls),
            "i16": pa.array(ints.astype(np.int16)),
            "i32": pa.array(ints.astype(np.int32), mask=nulls),
            "i64": pa.array(ints * 10 ** 9),
            "f32": pa.array(rng.normal(size=n).astype(np.float32)),
            "f64": pa.array(np.where(nulls, np.nan, rng.normal(size=n))),
            "b": pa.array(rng.random(n) < 0.5, mask=nulls),
        }),
        "datetime": pa.table({
            "d": pa.array(ints.astype(np.int32) % 30000, pa.date32(),
                          mask=nulls),
            "ts": pa.array(ints * 86_400_000_000 // 7, pa.timestamp("us")),
        }),
        "decimal": pa.table({
            "dec": pa.array([None if m else decimal.Decimal(v).scaleb(-2)
                             for m, v in zip(nulls,
                                             (ints % 10 ** 7).tolist())],
                            pa.decimal128(12, 2)),
        }),
        "null": pa.table({"n": pa.nulls(n), "i": pa.array(ints)}),
        "dict": pa.table({"s": pa.array(words[rng.integers(0, 6, n)],
                                        mask=nulls)}),
        "flat": pa.table({"s": pa.array([f"u{i}-{v}" for i, v in
                                         enumerate(ints)], mask=nulls)}),
        "array": pa.table({"a": pa.array(
            [None if m else list(range(int(v) % 5))
             for m, v in zip(nulls, ints)], pa.list_(pa.int64()))}),
        "map": pa.table({"m": pa.array(
            [None if m else [(f"k{j}", float(v + j))
                             for j in range(int(v) % 3)]
             for m, v in zip(nulls, ints)],
            pa.map_(pa.string(), pa.float64()))}),
        "struct": pa.table({"st": pa.array(
            [None if m else {"x": int(v), "y": f"w{int(v) % 7}"}
             for m, v in zip(nulls, ints)],
            pa.struct([("x", pa.int64()), ("y", pa.string())]))}),
    }


KINDS = list(_kinds(4))


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("kind", KINDS)
def test_frames_identical_between_packages(kind, codec):
    t = _kinds()[kind]
    ours = serde.serialize_batch(from_arrow(t, "cpu"), codec)
    theirs = jax_serde.serialize_batch(jax_from_arrow(t), codec)
    assert ours == theirs
    back = to_arrow(serde.deserialize_batch(theirs), t.schema.names)
    assert _eq(back.to_pylist(), t.to_pylist())
    back = jax_to_arrow(jax_serde.deserialize_batch(ours), t.schema.names)
    assert _eq(back.to_pylist(), t.to_pylist())


def test_blob_rows_trimmed_and_repadded():
    t = _kinds(3000)["fixed"]
    b = from_arrow(t, "cpu")
    assert b.capacity == 4096
    blob = serde.serialize_batch(b, "none")
    # capacity padding never ships: 3000 live rows of 8+2+... bytes
    assert len(blob) < 3000 * 40
    back = serde.deserialize_batch(blob)
    assert back.capacity == 4096 and back.num_rows == 3000
    # a masked batch ships its live rows only
    live = np.zeros(b.capacity, np.bool_)
    live[:3000:3] = True
    import torch
    masked = X.ColumnarBatch(b.columns, int(live.sum()),
                             torch.from_numpy(live))
    got = to_arrow(serde.deserialize_batch(serde.serialize_batch(masked)),
                   t.schema.names)
    assert _eq(got.to_pylist(), t.take(np.arange(0, 3000, 3)).to_pylist())


def test_native_packer_matches_plain_version():
    rng = np.random.default_rng(9)
    for n in (0, 1, 3, 7, 8, 31, 32, 33, 100, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 2 ** 63):
            want = serde._py_xxhash64(data, seed)
            arr = np.frombuffer(data or b"\0", np.uint8)
            got = serde.kudo_lib().kudo_xxhash64(serde._u8p(arr), n, seed)
            assert got == want, (n, seed)
    for t in _kinds(200).values():
        meta, planes = serde.describe_batch(from_arrow(t, "cpu"))
        frame = serde._pack_frame(meta, planes)
        assert frame == serde._py_pack_frame(meta, planes)
        for unpack in (serde._unpack_frame, serde._py_unpack_frame):
            m, bufs = unpack(frame)
            assert m == meta
            assert [bytes(b) for b in bufs] == \
                [np.ascontiguousarray(p).tobytes() for p in planes]
        for codec in ("none", "zlib"):
            assert serde.pack(meta, planes, codec) == \
                serde.pack(meta, planes, codec, native=False)


def test_kernel_error_when_the_packer_cannot_build(monkeypatch):
    from spark_rapids_tpu_torch.ops import _build
    monkeypatch.setattr(serde, "_KUDO", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "host_compiler_path",
                        lambda: "/nonexistent/g++")
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        os.path.join(REPO, "build", "torch_kernels_absent"))
    try:
        with pytest.raises(_build.KernelError):
            serde.serialize_batch(from_arrow(_kinds(8)["fixed"], "cpu"))
    finally:
        import shutil
        shutil.rmtree(os.path.join(REPO, "build", "torch_kernels_absent"),
                      ignore_errors=True)


def test_codecs():
    assert serde.codec_id("none") == 0 and serde.codec_id("zlib") == 2
    assert serde.resolve_codec("auto") == jax_serde._resolve_auto()
    for bad in ("lz4", "snappy"):
        with pytest.raises(ValueError):
            serde.codec_id(bad)
    try:
        import zstandard  # noqa: F401
    except ImportError:
        with pytest.raises(ValueError):
            serde.codec_id("zstd")
        return
    t = _kinds()["dict"]
    blob = serde.serialize_batch(from_arrow(t, "cpu"), "zstd")
    assert blob[0] == serde.CODEC_ZSTD
    back = jax_to_arrow(jax_serde.deserialize_batch(blob), t.schema.names)
    assert _eq(back.to_pylist(), t.to_pylist())


def test_crc_and_frame_corruption():
    t = _kinds(200)["fixed"]
    blob = serde.serialize_batch(from_arrow(t, "cpu"), "zlib")
    assert int(serde.deserialize_batch(blob).num_rows) == 200
    with pytest.raises(serde.ShuffleCorruptionError):
        serde.deserialize_batch(faults.corrupt_bytes(blob))
    # corruption in the codec/header region is caught too
    with pytest.raises(serde.ShuffleCorruptionError):
        serde.deserialize_batch(bytes([blob[0] ^ 0xFF]) + blob[1:])
    with pytest.raises(serde.ShuffleCorruptionError):
        serde.deserialize_batch(b"\x01\x02")
    # a frame corrupted under a valid wire CRC: the frame's xxhash64
    meta, planes = serde.describe_batch(from_arrow(t, "cpu"))
    frame = bytearray(serde._pack_frame(meta, planes))
    frame[len(frame) // 2] ^= 0x01
    import struct
    import zlib
    crc = zlib.crc32(bytes(frame), zlib.crc32(b"\x00")) & 0xFFFFFFFF
    bad = b"\x00" + struct.pack("<I", crc) + bytes(frame)
    for native in (True, False):
        with pytest.raises(serde.ShuffleCorruptionError):
            serde.deserialize_batch(bad, native=native)
    # unverified reads skip both checks
    assert int(serde.deserialize_batch(bad, verify=False).num_rows) == 200


def test_store_spills_to_disk(tmp_path):
    store = ShuffleStore(4, host_budget_bytes=1000, spill_dir=str(tmp_path))
    blobs = {p: [os.urandom(400) for _ in range(3)] for p in range(4)}
    for p, bl in blobs.items():
        for b in bl:
            store.add(p, b, rows=7)
    assert store.bytes_spilled > 0
    assert store.totals()["bytes_written"] == 4 * 3 * 400
    for p in range(4):
        assert list(store.iter_partition(p)) == blobs[p]
        assert [store.read_blob(p, i) for i in range(3)] == blobs[p]
        assert store.partition_rows(p) == 21
    store.close()


def test_store_concurrent_writers_and_spills(tmp_path):
    """More writer threads than cores add to one store under a budget
    that keeps spilling: no blob is lost, each partition keeps its
    writer's order, and the byte and row tallies add up."""
    import threading
    store = ShuffleStore(4, host_budget_bytes=4096, spill_dir=str(tmp_path))
    n_threads, per = 2 * (os.cpu_count() or 4), 40
    blobs = {t: [os.urandom(64 + (t * per + i) % 200) for i in range(per)]
             for t in range(n_threads)}
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def write(t):
            for b in blobs[t]:
                store.add(t % 4, b, rows=1)
        threads = [threading.Thread(target=write, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    assert store.bytes_spilled > 0
    total = sum(len(b) for bl in blobs.values() for b in bl)
    assert store.totals()["bytes_written"] == total
    for p in range(4):
        got = list(store.iter_partition(p))
        assert store.partition_rows(p) == len(got)
        for t in range(p, n_threads, 4):
            mine = [b for b in got if b in set(blobs[t])]
            assert mine == blobs[t]
    store.close()


def _agg_program(api, s, repart):
    df = gen_df(s, [("k", RepeatSeqGen(IntegerGen(min_val=0, max_val=40),
                                       length=30)),
                    ("v", LongGen(min_val=-(1 << 40), max_val=1 << 40)),
                    ("s", StringGen())],
                length=2000, seed=67, num_partitions=4)
    if repart:
        df = df.repartition(4, api.col("k"))
    return df.group_by(api.col("k")).agg(api.F.sum("v").alias("sv"),
                                         api.F.count().alias("n"))


def _exchanges(session):
    return [e for e in session.last_exec.walk()
            if isinstance(e, X.ShuffleExchangeExec)]


@pytest.mark.parametrize("budget", [None, 2048])
@pytest.mark.parametrize("repart", [False, True])
def test_serialized_aggregate_matches_jax(budget, repart):
    conf = dict(SERIALIZED)
    if budget:
        conf["spark.rapids.shuffle.hostSpillBudget"] = budget
    want = _agg_program(jax_api(), jax_api().session(conf), repart).collect()
    s = torch_api().session(conf)
    df = _agg_program(torch_api(), s, repart)
    got = df.collect()
    assert_tables_equal(got, want, ignore_order=True)
    assert_tables_equal(got, df.collect_cpu(), ignore_order=True)
    if repart:
        (ex,) = _exchanges(s)
        written = ex.metrics["shuffleBytesWritten"]
        assert written > 0 and ex._store.totals()["bytes_written"] == written
        assert (ex.metrics["shuffleBytesSpilled"] > 0) == bool(budget)


def test_serialized_full_join_matches_jax():
    def program(api, s):
        lspec = [("k", RepeatSeqGen(IntegerGen(min_val=0, max_val=50),
                                    length=40)), ("lv", LongGen())]
        rspec = [("k", RepeatSeqGen(IntegerGen(min_val=25, max_val=75),
                                    length=35)),
                 ("rv", DoubleGen(no_nans=True))]
        return gen_df(s, lspec, length=800, seed=71, num_partitions=3).join(
            gen_df(s, rspec, length=600, seed=73, num_partitions=3),
            on="k", how="full")
    want = program(jax_api(), jax_api().session(SERIALIZED)).collect()
    s = torch_api().session({**SERIALIZED,
                             "spark.rapids.sql.join.broadcastRowThreshold":
                             "0"})
    got = program(torch_api(), s).collect()
    assert_tables_equal(got, want, ignore_order=True)
    assert all(e.metrics["shuffleBytesWritten"] > 0 for e in _exchanges(s))
    assert len(_exchanges(s)) == 2


def _repart_blobs(conf):
    api = torch_api()
    s = api.session({**SERIALIZED, **conf})
    rng = np.random.default_rng(3)
    t = pa.table({"k": rng.integers(0, 9, 5000).astype(np.int32),
                  "v": rng.normal(size=5000)})
    df = s.create_dataframe(t, num_partitions=5).repartition(6,
                                                             api.col("k"))
    out = df.collect()
    (ex,) = _exchanges(s)
    store = ex._store
    return out, [[store.read_blob(p, i) for i in range(store.num_blobs(p))]
                 for p in range(6)]


def test_serialized_taken_and_blob_order():
    """SERIALIZED really runs the store (MULTITHREADED and ICI, which on
    one card is the device exchange, do not); streamed or not, with one
    writer thread or eight, every partition holds the same blobs in the
    same order."""
    base_out, base = _repart_blobs({})
    assert sum(len(p) for p in base) >= 5
    for conf in ({"spark.rapids.sql.pipeline.enabled": "false"},
                 {"spark.rapids.sql.pipeline.depth": "0"},
                 {"spark.rapids.shuffle.multiThreaded.writer.threads": "1"},
                 {"spark.rapids.shuffle.multiThreaded.reader.threads": "1",
                  "spark.rapids.shuffle.partitioning": "masked"}):
        out, blobs = _repart_blobs(conf)
        assert blobs == base, conf
        assert out.equals(base_out)
    for mode in ("MULTITHREADED", "ICI"):
        s = torch_api().session({"spark.rapids.shuffle.mode": mode})
        df = s.create_dataframe(pa.table({"k": [1, 2, 3]})).repartition(
            2, torch_api().col("k"))
        assert df.count() == 3
        (ex,) = _exchanges(s)
        assert ex._store is None and ex.metrics["shuffleBytesWritten"] == 0


def test_skew_split_sizes_lazy_partitions_by_tally():
    api = torch_api()
    rng = np.random.default_rng(4)
    k = np.where(rng.random(40000) < 0.7, 5, rng.integers(0, 64, 40000))
    t = pa.table({"k": k.astype(np.int32), "v": rng.integers(0, 9, 40000)})
    conf = dict(SERIALIZED)
    s = api.session(conf)
    df = s.create_dataframe(t, num_partitions=4).repartition(
        8, api.col("k")).group_by(api.col("k")).agg(api.F.sum("v").alias("s"))
    got = df.collect()
    want = jax_api().session(conf).create_dataframe(
        t, num_partitions=4).repartition(8, jax_api().col("k")).group_by(
        jax_api().col("k")).agg(jax_api().F.sum("v").alias("s")).collect()
    assert_tables_equal(got, want, ignore_order=True)
    (ex,) = _exchanges(s)
    rows = [item.rows for part in ex._out for item in part]
    assert sum(r or 0 for r in rows) == 40000
    (split,) = [d for d in s.last_aqe()["decisions"]
                if d["kind"] == "skew_split"]
    assert split["rows"] == max(r or 0 for r in rows) > 28000


# -- cross-process and cross-package exchange files --------------------------

def _xproc_table(n=700):
    return pa.table({"k": [i % 11 for i in range(n)],
                     "v": list(range(n)),
                     "s": ["name%d" % (i % 5) for i in range(n)]})


def _check_mounted(df_of, root, api, to_arrow_fn, read_batches):
    out = df_of().group_by(api.col("k")).agg(
        api.F.sum("v").alias("sv"), api.F.count().alias("n")).to_pydict()
    got = {k: [sv, n] for k, sv, n in zip(out["k"], out["sv"], out["n"])}
    exp = {}
    for i in range(700):
        exp.setdefault(i % 11, [0, 0])
        exp[i % 11][0] += i
        exp[i % 11][1] += 1
    assert got == exp
    seen = {}
    for r in range(4):
        for b in read_batches(root, r):
            for key in to_arrow_fn(b, ["k", "v", "s"]).to_pydict()["k"]:
                assert seen.setdefault(key, r) == r
    return seen


def test_jax_subprocess_writes_port_reads(tmp_path):
    root = str(tmp_path / "xproc")
    writer = f"""
import jax
jax.config.update("jax_platforms", "cpu")
import pyarrow as pa
from spark_rapids_tpu.sql.session import TpuSession
from spark_rapids_tpu.shuffle.exchange_files import write_exchange
s = TpuSession()
t = pa.table({{'k': [i % 11 for i in range(700)],
               'v': list(range(700)),
               's': ['name%d' % (i % 5) for i in range(700)]}})
write_exchange(s.create_dataframe(t, num_partitions=3), {root!r},
               keys=['k'], n_out=4)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", writer], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    api = torch_api()
    s = api.session()
    df = exchange_files.read_exchange(s, root)
    assert df.plan.schema.names == ["k", "v", "s"]
    assert df.plan.n_reduce == 4
    _check_mounted(lambda: exchange_files.read_exchange(s, root), root, api,
                   to_arrow, exchange_files.read_partition_batches)
    assert any(isinstance(e, X.ShuffleFileScanExec)
               for e in s.last_exec.walk())
    assert_tables_equal(df.collect(), df.collect_cpu(), ignore_order=True)


def test_port_subprocess_writes_jax_reads(tmp_path):
    root = str(tmp_path / "xproc")
    writer = f"""
import sys
import pyarrow as pa
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.shuffle.exchange_files import write_exchange
s = TorchSession(device="cpu")
t = pa.table({{'k': [i % 11 for i in range(700)],
               'v': list(range(700)),
               's': ['name%d' % (i % 5) for i in range(700)]}})
write_exchange(s.create_dataframe(t, num_partitions=3), {root!r},
               keys=['k'], n_out=4)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'spark_rapids_tpu'))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", writer], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    api = jax_api()
    s = api.session()
    _check_mounted(lambda: jax_files.read_exchange(s, root), root, api,
                   jax_to_arrow, jax_files.read_partition_batches)


def test_exchange_files_copartition_across_packages(tmp_path):
    """Each key lands in the same reduce partition whichever package
    wrote the directory (B1's bits match), and the files are the same
    bytes for codec none."""
    t = _xproc_table()
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    exchange_files.write_exchange(
        torch_api().session().create_dataframe(t, num_partitions=3), ours,
        ["k"], 4, codec="none")
    jax_files.write_exchange(
        jax_api().session().create_dataframe(t, num_partitions=3), theirs,
        ["k"], 4, codec="none")
    seen_ours = _check_mounted(
        lambda: jax_files.read_exchange(jax_api().session(), ours), ours,
        jax_api(), jax_to_arrow, jax_files.read_partition_batches)
    seen_theirs = _check_mounted(
        lambda: exchange_files.read_exchange(torch_api().session(), theirs),
        theirs, torch_api(), to_arrow, exchange_files.read_partition_batches)
    assert seen_ours == seen_theirs
    assert exchange_files.read_manifest(ours) == \
        jax_files.read_manifest(theirs)


# -- tests/test_faults.py's serde and shuffle cases ---------------------------

def _fault_table(rows=2000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 7, rows),
                     "v": rng.integers(-1000, 1000, rows)})


def _shuffle_df(api, sess, t):
    return sess.create_dataframe(t, num_partitions=2) \
        .repartition(2, "k").group_by("k") \
        .agg(api.F.sum(api.col("v")).alias("s"))


def _fault_session(**conf):
    return torch_api().session({"spark.rapids.sql.reader.batchSizeRows":
                                "512", **SERIALIZED, **conf})


def _canon(table):
    return sorted(table.to_pylist(), key=repr)


def test_shuffle_read_one_shot_corruption_recovers():
    t = _fault_table()
    api = torch_api()
    clean = _canon(_shuffle_df(api, _fault_session(), t).collect())
    assert clean == _canon(_shuffle_df(
        jax_api(), jax_api().session(SERIALIZED), t).collect())
    s = _fault_session(**{"spark.rapids.debug.faults":
                          "shuffle.read:corrupt:1"})
    out = _shuffle_df(api, s, t).collect()
    assert s.last_action_status == ("ok", None)
    assert _canon(out) == clean
    assert s.last_task_metrics()["shuffleCorruptionRetries"] == 1
    assert faults.fault_counts().get("shuffle.read") == 1


def test_shuffle_write_persistent_corruption_degrades():
    t = _fault_table()
    api = torch_api()
    clean = _canon(_shuffle_df(api, _fault_session(), t).collect())
    s = _fault_session(**{"spark.rapids.fallback.cpu.enabled": "true",
                          "spark.rapids.debug.faults":
                          "shuffle.write:corrupt:1"})
    out = _shuffle_df(api, s, t).collect()
    assert s.last_action_status == ("degraded", "ShuffleCorruptionError")
    assert _canon(out) == clean


def test_shuffle_write_corruption_without_fallback_raises():
    s = _fault_session(**{"spark.rapids.debug.faults":
                          "shuffle.write:corrupt:1"})
    with pytest.raises(serde.ShuffleCorruptionError):
        _shuffle_df(torch_api(), s, _fault_table()).collect()
    assert s.last_action_status[0] == "failed"
