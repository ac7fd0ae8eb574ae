"""The port's table formats against the JAX package: ``sql/hive.py``
(LazySimpleSerDe text, ``\\N``, partition directories), ``sql/delta.py``
(log replay, commits, checkpoints, time travel, vacuum,
ConcurrentModification, delete/update/merge), ``sql/merge.py``
(MergeInto) and ``sql/iceberg.py`` (metadata, Avro manifests, snapshots).

The programs of tests/test_hive.py, test_delta.py, test_merge_into.py and
test_iceberg.py run through both packages, each with that file's
assertions; their answers (rows, counts, history, layouts) must be
equal. Logs carry timestamps and uuids, so tables and action kinds are
compared, never raw log bytes. Then tables cross the packages: a table
written by one is read, appended to, updated and merged by the other.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _pkg(name):
    if name == "jax":
        from spark_rapids_tpu.expr.core import SparkException
        from spark_rapids_tpu.io.avro import read_avro
        from spark_rapids_tpu.sql import delta, hive, iceberg, merge
        api = jax_api()
    else:
        from spark_rapids_tpu_torch.expr.core import SparkException
        from spark_rapids_tpu_torch.io.avro import read_avro
        from spark_rapids_tpu_torch.sql import delta, hive, iceberg, merge
        api = torch_api()
    return SimpleNamespace(name=name, api=api, s=api.session(), delta=delta,
                           hive=hive, iceberg=iceberg, merge=merge,
                           read_avro=read_avro, SparkException=SparkException)


def _t(k, v):
    return pa.table({"k": pa.array(k, pa.int64()),
                     "v": pa.array(v, pa.float64())})


def _rows(table_or_df, key=repr):
    t = table_or_df.collect() if hasattr(table_or_df, "collect") \
        else table_or_df
    return sorted(t.to_pylist(), key=key)


# -- tests/test_hive.py -------------------------------------------------------

def _hive_schema():
    return pa.schema([("k", pa.int64()), ("v", pa.float64()),
                      ("s", pa.string()), ("p", pa.string())])


def hive_roundtrip_with_partitions(m, p):
    t = pa.table({"k": pa.array([1, 2, None, 4], pa.int64()),
                  "v": pa.array([1.5, None, 3.25, 4.0]),
                  "s": pa.array(["a", "b\tc", None, "d"]),
                  "p": pa.array(["x", "y", "x", None])})
    ht = m.hive.HiveTable(m.s, p, _hive_schema(), partition_cols=["p"])
    assert ht.insert(m.s.create_dataframe(t)) == 4
    dirs = sorted(d for d in os.listdir(p) if "=" in d)
    assert dirs == ["p=__HIVE_DEFAULT_PARTITION__", "p=x", "p=y"]
    f = next(os.path.join(p, "p=x", n) for n in os.listdir(
        os.path.join(p, "p=x")) if not n.startswith("_"))
    line = open(f, encoding="utf-8").readline().rstrip("\n")
    assert m.hive.DEFAULT_DELIM in line
    got = m.hive.HiveTable(m.s, p, _hive_schema(),
                           partition_cols=["p"]).to_df()
    assert _rows(got) == _rows(t)
    return dirs, _rows(got)


def hive_malformed_cells_read_null(m, p):
    os.makedirs(p)
    d, null = m.hive.DEFAULT_DELIM, m.hive.NULL_TOKEN
    with open(os.path.join(p, "part-0"), "w") as f:
        f.write(d.join(["12", "notafloat", "ok"]) + "\n")
        f.write(d.join([null, "2.5", null]) + "\n")
        f.write("7\n")  # short row: missing cells read as NULL
    schema = pa.schema([("k", pa.int64()), ("v", pa.float64()),
                        ("s", pa.string())])
    got = m.hive.HiveTable(m.s, p, schema).to_df().collect().to_pylist()
    assert got == [{"k": 12, "v": None, "s": "ok"},
                   {"k": None, "v": 2.5, "s": None},
                   {"k": 7, "v": None, "s": None}]
    return got


def hive_insert_overwrite_and_engine_query(m, p):
    col, F = m.api.col, m.api.F
    t1 = pa.table({"k": [1, 2], "v": [1.0, 2.0], "s": ["a", "b"],
                   "p": ["x", "x"]})
    t2 = pa.table({"k": [3], "v": [3.0], "s": ["c"], "p": ["y"]})
    ht = m.hive.HiveTable(m.s, p, _hive_schema(), partition_cols=["p"])
    ht.insert(m.s.create_dataframe(t1))
    ht.insert(m.s.create_dataframe(t2))
    n2 = ht.to_df().count()
    ht.insert(m.s.create_dataframe(t2), overwrite=True)
    n1 = ht.to_df().count()
    out = ht.to_df().group_by("p").agg(F.sum(col("v")).alias("sv"))
    assert (n2, n1, out.to_pydict()["sv"]) == (3, 1, [3.0])
    return n2, n1


def hive_delimiter_and_null_token_escaping(m, p):
    schema = pa.schema([("s", pa.string()), ("t", pa.string())])
    t = pa.table({"s": pa.array(["a\x01b", "line1\nline2", "\\N", "",
                                 None]),
                  "t": pa.array(["x", "y", "z", "w", "v"])})
    m.hive.HiveTable(m.s, p, schema).insert(m.s.create_dataframe(t))
    got = _rows(m.hive.HiveTable(m.s, p, schema).to_df())
    assert got == _rows(t)
    return got


# -- tests/test_delta.py ------------------------------------------------------

def delta_create_and_read_roundtrip(m, p):
    m.delta.DeltaTable.create(m.s, p, _t([1, 2, 3], [1.0, 2.0, 3.0]))
    log0 = os.path.join(p, "_delta_log", "0" * 20 + ".json")
    actions = [json.loads(line) for line in open(log0) if line.strip()]
    kinds = sorted({k for a in actions for k in a})
    assert {"commitInfo", "protocol", "metaData", "add"} <= set(kinds)
    got = _rows(m.delta.DeltaTable.for_path(m.s, p).to_df())
    assert [r["k"] for r in got] == [1, 2, 3]
    return kinds, got


def delta_append_and_time_travel(m, p):
    dt = m.delta.DeltaTable.create(m.s, p, _t([1], [1.0]))
    dt.append(m.s.create_dataframe(_t([2], [2.0])))
    dt.append(m.s.create_dataframe(_t([3], [3.0])))
    counts = (dt.to_df().count(), dt.to_df(version=1).count(),
              dt.to_df(version=0).count())
    hist = [(h["version"], h["operation"]) for h in dt.history()]
    assert counts == (3, 2, 1)
    assert [v for v, _ in hist] == [2, 1, 0]
    assert hist[-1][1] == "CREATE TABLE AS SELECT"
    return counts, hist


def delta_delete_copy_on_write(m, p):
    col, lit = m.api.col, m.api.lit
    dt = m.delta.DeltaTable.create(
        m.s, p, _t(list(range(10)), [float(i) for i in range(10)]))
    n = dt.delete(col("k") >= lit(7))
    got = [r["k"] for r in _rows(dt.to_df(), key=lambda r: r["k"])]
    assert n == 3 and got == list(range(7))
    assert all(a["dataChange"] for a in dt.log.snapshot().files.values())
    assert dt.delete() == 7 and dt.to_df().count() == 0
    return n, got


def delta_update_conditional(m, p):
    col, lit = m.api.col, m.api.lit
    dt = m.delta.DeltaTable.create(m.s, p, _t([1, 2, 3, 4], [1., 2., 3.,
                                                            4.]))
    n = dt.update({"v": col("v") * lit(10.0)}, col("k") > lit(2))
    got = {r["k"]: r["v"] for r in dt.to_df().collect().to_pylist()}
    assert n == 2 and got == {1: 1.0, 2: 2.0, 3: 30.0, 4: 40.0}
    return n, sorted(got.items())


def delta_merge_transactional(m, p):
    dt = m.delta.DeltaTable.create(m.s, p, _t([1, 2, 3], [1., 2., 3.]))
    src = m.s.create_dataframe(_t([2, 3, 9], [20., 30., 90.]))
    (dt.merge(src, on=["k"])
       .when_matched_update({"v": m.api.col("__src_v")})
       .when_not_matched_insert()
       .execute())
    got = {r["k"]: r["v"] for r in dt.to_df().collect().to_pylist()}
    assert got == {1: 1.0, 2: 20.0, 3: 30.0, 9: 90.0}
    assert dt.history()[0]["operation"] == "MERGE"
    return sorted(got.items())


def delta_optimistic_concurrency_conflict(m, p):
    m.delta.DeltaTable.create(m.s, p, _t([1], [1.0]))
    a = m.delta.DeltaTable.for_path(m.s, p)
    b = m.delta.DeltaTable.for_path(m.s, p)
    snap_a, snap_b = a.log.snapshot(), b.log.snapshot()
    a.log.commit(snap_a.version + 1, [], "WRITE")
    with pytest.raises(m.delta.ConcurrentModification):
        b.log.commit(snap_b.version + 1, [], "WRITE")
    return m.delta.DeltaLog(p).versions_on_disk()


def delta_checkpoint_replay(m, p):
    dt = m.delta.DeltaTable.create(m.s, p, _t([0], [0.0]))
    for i in range(1, 12):
        dt.append(m.s.create_dataframe(_t([i], [float(i)])))
    names = os.listdir(os.path.join(p, "_delta_log"))
    assert any(n.endswith(".checkpoint.parquet") for n in names)
    assert "_last_checkpoint" in names
    dt2 = m.delta.DeltaTable.for_path(m.s, p)
    counts = (dt.to_df().count(), dt2.to_df().count(),
              dt2.to_df(version=3).count())
    assert counts == (12, 12, 4)
    return counts


def delta_vacuum_drops_unreferenced(m, p):
    col, lit = m.api.col, m.api.lit
    dt = m.delta.DeltaTable.create(m.s, p, _t([1, 2], [1., 2.]))
    dt.delete(col("k") == lit(1))  # rewrites the file, tombstones old
    dropped = dt.vacuum(retain_hours=0.0)
    assert len(dropped) == 1 and dt.to_df().count() == 1
    return len(dropped)


def delta_delete_null_condition_keeps_rows(m, p):
    col, lit = m.api.col, m.api.lit
    t = pa.table({"k": pa.array([1, 2, None, 4], pa.int64()),
                  "v": pa.array([1., 2., 3., 4.], pa.float64())})
    dt = m.delta.DeltaTable.create(m.s, p, t)
    n = dt.delete(col("k") >= lit(3))   # NULL >= 3 is NULL: row kept
    got = sorted(r["v"] for r in dt.to_df().collect().to_pylist())
    assert n == 1 and got == [1.0, 2.0, 3.0]
    return n, got


def delta_checkpoint_is_spec_typed_schema(m, p):
    import pyarrow.parquet as pq
    dt = m.delta.DeltaTable.create(m.s, p, _t([0], [0.0]))
    for i in range(1, 11):
        dt.append(m.s.create_dataframe(_t([i], [float(i)])))
    cp = [n for n in os.listdir(os.path.join(p, "_delta_log"))
          if n.endswith(".checkpoint.parquet")]
    t = pq.read_table(os.path.join(p, "_delta_log", cp[0]))
    assert {"protocol", "metaData", "add", "remove"} <= set(t.schema.names)
    for name in ("protocol", "metaData", "add"):
        assert pa.types.is_struct(t.schema.field(name).type), name
    rows = t.to_pylist()
    assert sum(1 for r in rows if r["protocol"] is not None) == 1
    meta = next(r["metaData"] for r in rows if r["metaData"] is not None)
    assert json.loads(meta["schemaString"])["type"] == "struct"
    adds = [r["add"] for r in rows if r["add"] is not None]
    assert len(adds) == 11 and all(a["path"].endswith(".parquet")
                                   for a in adds)
    return str(t.schema), meta["schemaString"]


# -- tests/test_merge_into.py -------------------------------------------------

def _target(s):
    return s.create_dataframe({
        "id": pa.array([1, 2, 3, 4, 5], pa.int64()),
        "v": pa.array([10.0, 20.0, 30.0, 40.0, 50.0]),
        "tag": pa.array(["a", "b", "c", "d", "e"])})


def _source(s):
    return s.create_dataframe({
        "id": pa.array([2, 4, 6, 7], pa.int64()),
        "v": pa.array([200.0, 400.0, 600.0, 700.0]),
        "tag": pa.array(["B", "D", "F", "G"])})


def _merged(m, build):
    mi = build(m.merge.merge_into(_target(m.s), _source(m.s), on=["id"]))
    dev = mi.result().collect()
    if m.name == "torch":
        assert_tables_equal(dev, mi.result().collect_cpu(),
                            ignore_order=True)
    return _rows(dev, key=lambda r: r["id"])


def merge_upsert(m, p):
    col = m.api.col
    rows = _merged(m, lambda mi: mi.when_matched_update(
        {"v": col("__src_v"), "tag": col("__src_tag")})
        .when_not_matched_insert())
    got = {r["id"]: (r["v"], r["tag"]) for r in rows}
    assert got[2] == (200.0, "B") and got[4] == (400.0, "D")
    assert got[1] == (10.0, "a")
    assert got[6] == (600.0, "F") and got[7] == (700.0, "G")
    assert len(got) == 7
    return rows


def merge_update_only(m, p):
    col, lit = m.api.col, m.api.lit
    rows = _merged(m, lambda mi: mi.when_matched_update(
        {"v": col("__src_v") * lit(2.0)}))
    got = {r["id"]: r["v"] for r in rows}
    assert got[2] == 400.0 and got[4] == 800.0 and len(got) == 5
    return rows


def merge_delete(m, p):
    rows = _merged(m, lambda mi: mi.when_matched_delete())
    assert [r["id"] for r in rows] == [1, 3, 5]
    return rows


def merge_conditional_clauses(m, p):
    col, lit = m.api.col, m.api.lit
    rows = _merged(m, lambda mi: mi.when_matched_update(
        {"v": col("__src_v")}, condition=col("__src_v") > lit(300.0))
        .when_not_matched_insert(condition=col("v") < lit(650.0)))
    got = {r["id"]: r["v"] for r in rows}
    assert got[2] == 20.0 and got[4] == 400.0
    assert 6 in got and 7 not in got and len(got) == 6
    return rows


def merge_insert_defaults_missing_to_null(m, p):
    src = m.s.create_dataframe({"id": pa.array([9], pa.int64()),
                                "v": pa.array([900.0])})
    mi = m.merge.merge_into(_target(m.s), src, on=["id"]) \
        .when_not_matched_insert()
    rows = _rows(mi.result(), key=lambda r: r["id"])
    got = {r["id"]: r["tag"] for r in rows}
    assert got[9] is None and len(got) == 6
    return rows


def merge_cardinality_violation(m, p):
    col = m.api.col
    dup = m.s.create_dataframe({"id": pa.array([2, 2], pa.int64()),
                                "v": pa.array([1.0, 2.0]),
                                "tag": pa.array(["x", "y"])})
    with pytest.raises(m.SparkException, match="multiple source rows"):
        m.merge.merge_into(_target(m.s), dup, on=["id"]) \
            .when_matched_update({"v": col("__src_v")}).result()
    # duplicates that match NO target row are fine
    dup2 = m.s.create_dataframe({"id": pa.array([100, 100], pa.int64()),
                                 "v": pa.array([1.0, 2.0]),
                                 "tag": pa.array(["x", "y"])})
    rows = _rows(m.merge.merge_into(_target(m.s), dup2, on=["id"])
                 .when_matched_update({"v": col("__src_v")}).result())
    assert len(rows) == 5
    return rows


def merge_execute_writeback(m, p):
    col = m.api.col
    m.merge.merge_into(_target(m.s), _source(m.s), on=["id"]) \
        .when_matched_update({"v": col("__src_v")}) \
        .when_not_matched_insert() \
        .execute_to(p)
    back = m.s.read_parquet(p).to_pydict()
    got = dict(zip(back["id"], back["v"]))
    assert got[2] == 200.0 and got[6] == 600.0 and len(got) == 7
    return sorted(got.items())


# -- tests/test_iceberg.py ----------------------------------------------------

def iceberg_create_layout_and_read(m, p):
    m.iceberg.IcebergTable.create(m.s, p, _t([1, 2, 3], [1., 2., 3.]))
    assert open(os.path.join(p, "metadata", "version-hint.text")).read() \
        == "1"
    meta = json.load(open(os.path.join(p, "metadata", "v1.metadata.json")))
    assert meta["format-version"] == 1
    assert meta["schema"]["fields"][0]["name"] == "k"
    snap = meta["snapshots"][0]
    ml = m.read_avro(os.path.join(p, snap["manifest-list"])).to_pylist()
    assert ml[0]["added_data_files_count"] == 1
    entry = m.read_avro(os.path.join(p, ml[0]["manifest_path"])) \
        .to_pylist()[0]
    assert entry["status"] == 1
    assert entry["data_file"]["file_format"] == "PARQUET"
    assert entry["data_file"]["record_count"] == 3
    got = _rows(m.iceberg.IcebergTable.for_path(m.s, p).to_df())
    assert [r["k"] for r in got] == [1, 2, 3]
    return meta["schema"], got


def iceberg_append_and_time_travel(m, p):
    t = m.iceberg.IcebergTable.create(m.s, p, _t([1], [1.0]))
    s0 = t.snapshots()[0]["snapshot_id"]
    t.append(m.s.create_dataframe(_t([2], [2.0])))
    t.append(m.s.create_dataframe(_t([3], [3.0])))
    snaps = t.snapshots()
    counts = (t.to_df().count(), len(snaps), t.to_df(snapshot_id=s0).count(),
              t.to_df(snapshot_id=snaps[1]["snapshot_id"]).count(),
              m.iceberg.IcebergTable.for_path(m.s, p).to_df().count())
    assert counts == (3, 3, 1, 2, 3)
    return counts, [s["operation"] for s in snaps]


def iceberg_engine_queries(m, p):
    col, lit, F = m.api.col, m.api.lit, m.api.F
    rng = np.random.default_rng(4)
    t = m.iceberg.IcebergTable.create(
        m.s, p, _t(rng.integers(0, 10, 500).tolist(),
                   rng.uniform(0, 5, 500).tolist()))
    out = (t.to_df().filter(col("v") > lit(1.0)).group_by("k")
           .agg(F.sum(col("v")).alias("sv"), F.count().alias("n")))
    rows = _rows(out, key=lambda r: r["k"])
    assert len(rows) <= 10
    return [(r["k"], round(r["sv"], 9), r["n"]) for r in rows]


def iceberg_optimistic_commit_conflict(m, p):
    m.iceberg.IcebergTable.create(m.s, p, _t([1], [1.0]))
    a = m.iceberg.IcebergTable.for_path(m.s, p)
    b = m.iceberg.IcebergTable.for_path(m.s, p)
    a.append(m.s.create_dataframe(_t([2], [2.0])))
    meta = b._metadata(1)
    with pytest.raises(m.iceberg.IcebergConcurrentCommit):
        b._commit_metadata(2, meta)
    return a.to_df().count()


PROGRAMS = [
    hive_roundtrip_with_partitions, hive_malformed_cells_read_null,
    hive_insert_overwrite_and_engine_query,
    hive_delimiter_and_null_token_escaping,
    delta_create_and_read_roundtrip, delta_append_and_time_travel,
    delta_delete_copy_on_write, delta_update_conditional,
    delta_merge_transactional, delta_optimistic_concurrency_conflict,
    delta_checkpoint_replay, delta_vacuum_drops_unreferenced,
    delta_delete_null_condition_keeps_rows,
    delta_checkpoint_is_spec_typed_schema,
    merge_upsert, merge_update_only, merge_delete,
    merge_conditional_clauses, merge_insert_defaults_missing_to_null,
    merge_cardinality_violation, merge_execute_writeback,
    iceberg_create_layout_and_read, iceberg_append_and_time_travel,
    iceberg_engine_queries, iceberg_optimistic_commit_conflict,
]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda f: f.__name__)
def test_program_matches_jax(program, tmp_path):
    got = {name: program(_pkg(name), str(tmp_path / name / "tbl"))
           for name in ("torch", "jax")}
    assert got["torch"] == got["jax"]


# -- tables across the packages ----------------------------------------------

def test_delta_written_by_jax_updated_by_port(tmp_path):
    jx, pt = _pkg("jax"), _pkg("torch")
    p = str(tmp_path / "tbl")
    jx.delta.DeltaTable.create(jx.s, p, _t([1, 2, 3, 4], [1., 2., 3., 4.]))
    dt = pt.delta.DeltaTable.for_path(pt.s, p)
    dt.append(pt.s.create_dataframe(_t([5], [5.0])))
    col, lit = pt.api.col, pt.api.lit
    assert dt.update({"v": col("v") + lit(100.0)}, col("k") >= lit(4)) == 2
    assert dt.delete(col("k") == lit(1)) == 1
    (dt.merge(pt.s.create_dataframe(_t([2, 9], [-2.0, 9.0])), on=["k"])
       .when_matched_update({"v": col("__src_v")})
       .when_not_matched_insert().execute())
    want = {2: -2.0, 3: 3.0, 4: 104.0, 5: 105.0, 9: 9.0}
    for m in (jx, pt):
        t = m.delta.DeltaTable.for_path(m.s, p)
        assert {r["k"]: r["v"] for r in t.to_df().collect().to_pylist()} \
            == want
        assert [h["operation"] for h in t.history()] == \
            ["MERGE", "DELETE", "UPDATE", "WRITE", "CREATE TABLE AS SELECT"]
        assert t.to_df(version=0).count() == 4
    # the port's table, deleted from by the JAX package
    p2 = str(tmp_path / "tbl2")
    pt.delta.DeltaTable.create(pt.s, p2, _t([1, 2, 3], [1., 2., 3.]))
    jt = jx.delta.DeltaTable.for_path(jx.s, p2)
    assert jt.delete(jx.api.col("k") > jx.api.lit(1)) == 2
    assert pt.delta.DeltaTable.for_path(pt.s, p2).to_df().collect() \
        .to_pylist() == [{"k": 1, "v": 1.0}]


def test_iceberg_and_hive_across_packages(tmp_path):
    jx, pt = _pkg("jax"), _pkg("torch")
    p = str(tmp_path / "ice")
    jx.iceberg.IcebergTable.create(jx.s, p, _t([1, 2], [1., 2.]))
    it = pt.iceberg.IcebergTable.for_path(pt.s, p)
    s0 = it.snapshots()[0]["snapshot_id"]
    it.append(pt.s.create_dataframe(_t([3], [3.0])))
    jt = jx.iceberg.IcebergTable.for_path(jx.s, p)
    assert _rows(jt.to_df()) == _rows(it.to_df())
    assert jt.to_df().count() == 3 and jt.to_df(snapshot_id=s0).count() == 2
    assert it.data_files() == jt.data_files()
    # hive text written by the port reads in the JAX package
    h = str(tmp_path / "hive")
    t = pa.table({"k": pa.array([1, None, 3], pa.int64()),
                  "v": pa.array([0.5, 1.5, None]),
                  "s": pa.array(["a", None, "c\x01d"]),
                  "p": pa.array(["x", "y", None])})
    pt.hive.HiveTable(pt.s, h, _hive_schema(), partition_cols=["p"]) \
        .insert(pt.s.create_dataframe(t))
    got = jx.hive.HiveTable(jx.s, h, _hive_schema(),
                            partition_cols=["p"]).to_df()
    assert _rows(got) == _rows(t)
