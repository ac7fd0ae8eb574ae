"""The array collection operations (expr/array_ops.py) and the
complex-type extractors' edges in the port against the JAX package: one
case or more for each test of tests/test_array_ops.py, every class on
ints, doubles (NaN, -0.0, inf) and strings with null rows, null elements
and empty rows, the indices' edges (negative, zero, past the end, ANSI),
the host tier against the JAX package's CPU, and each class's numpy
``eval_cpu`` against its device answer.

Inputs are made with numpy from a seed, at a few hundred rows. Tolerance:
none (NaN equal to NaN, -0.0 equal to 0.0). Where the JAX package's answer
is not Spark's, the test says which ROADMAP C entry records it and holds
the port to Spark's.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest

from torch_port_helpers import jax_api, torch_api
from test_torch_nested import assert_same, run_both, same, seeded_table

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.expr import array_ops as AO
from spark_rapids_tpu_torch.expr.core import BoundRef, EvalCtx


def _arrays(n=70, seed=13, lo=-20, hi=20, null_p=0.12):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        if rng.random() < 0.1:
            rows.append(None)
            continue
        ln = int(rng.integers(0, 7))
        rows.append([None if rng.random() < null_p else int(v)
                     for v in rng.integers(lo, hi, ln)])
    return rows


def _tbl(n=70, seed=13):
    """The JAX package's own test table (tests/test_array_ops.py)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(_arrays(n, seed), pa.list_(pa.int64())),
        "b": pa.array(_arrays(n, seed + 1), pa.list_(pa.int64())),
        "v": pa.array(rng.integers(-20, 20, n).astype(np.int64)),
        "s": pa.array(rng.integers(-3, 4, n).astype(np.int32)),
        "l": pa.array(rng.integers(0, 5, n).astype(np.int32)),
    })


def _device_equals_cpu(build, table):
    """The port's device answer equals its own CPU backend's."""
    api = torch_api()
    df = build(api, api.session().create_dataframe(table))
    assert_same(df.collect(), df.collect_cpu())


# ---------------------------------------------------------------------------
# The JAX package's tests/test_array_ops.py
# ---------------------------------------------------------------------------

def test_array_min_max():
    q = (lambda api, df: df.select(api.F.array_min(api.col("a")).alias("mn"),
                                   api.F.array_max(api.col("a")).alias("mx")))
    run_both(q, _tbl())
    _device_equals_cpu(q, _tbl())


def test_array_min_max_float_nan():
    rows = [[1.5, float("nan"), -2.0], [float("nan")], [], None, [3.25],
            [-0.0, 0.0, None]]
    t = pa.table({"a": pa.array(rows, pa.list_(pa.float64()))})
    q = (lambda api, df: df.select(api.F.array_min(api.col("a")).alias("mn"),
                                   api.F.array_max(api.col("a")).alias("mx")))
    run_both(q, t)
    _device_equals_cpu(q, t)


def test_array_position_and_remove():
    q = (lambda api, df: df.select(
        api.F.array_position(api.col("a"), api.col("v")).alias("p"),
        api.F.array_position(api.col("a"), api.lit(7)).alias("p7"),
        api.F.array_remove(api.col("a"), api.col("v")).alias("r")))
    run_both(q, _tbl())
    _device_equals_cpu(q, _tbl())


def test_slice():
    def q(api, df):
        F, col, lit = api.F, api.col, api.lit
        return df.select(
            F.slice(col("a"), F.when(col("s") == lit(0), lit(1))
                    .otherwise(col("s")), col("l")).alias("sl"),
            F.slice(col("a"), lit(2), lit(2)).alias("s22"),
            F.slice(col("a"), lit(-2), lit(3)).alias("sneg"),
            F.slice(col("a"), lit(-9), lit(2)).alias("sfar"))
    run_both(q, _tbl())
    _device_equals_cpu(q, _tbl())


def test_sort_array():
    q = (lambda api, df: df.select(
        api.F.sort_array(api.col("a")).alias("sa"),
        api.F.sort_array(api.col("a"), asc=False).alias("sd")))
    run_both(q, _tbl())
    _device_equals_cpu(q, _tbl())


def test_flatten():
    rng = np.random.default_rng(2)
    rows = []
    for _ in range(50):
        if rng.random() < 0.1:
            rows.append(None)
            continue
        outer = []
        for _ in range(int(rng.integers(0, 4))):
            if rng.random() < 0.1:
                outer.append(None)
            else:
                outer.append([int(v) for v in
                              rng.integers(-9, 9, int(rng.integers(0, 4)))])
        rows.append(outer)
    t = pa.table({"aa": pa.array(rows, pa.list_(pa.list_(pa.int64())))})
    q = (lambda api, df: df.select(api.F.flatten(api.col("aa")).alias("f")))
    # an array of arrays is outside both packages' nested signature: the
    # scan and the projection run on the CPU
    run_both(q, t, placed=["Project", "InMemorySource"])
    # the device arm (the outer offsets read through the inner ones),
    # held to eval_cpu on the same batch
    _eval_equals_eval_cpu(AO.Flatten, t)


def _eval_equals_eval_cpu(cls, t):
    from spark_rapids_tpu_torch.exec.cpu_backend import (
        cols_to_table, table_to_cols,
    )
    batch = B.from_arrow(t, "cpu")
    ctx = EvalCtx(batch.columns, batch.num_rows, batch.capacity, "cpu")
    e = cls(BoundRef(0, batch.columns[0].dtype))
    got = B.to_arrow(type(batch)([e.eval(ctx)], batch.num_rows), ["r"])
    want = cols_to_table([e.eval_cpu(table_to_cols(t))], ["r"])
    assert same(got.to_pylist(), want.to_pylist())


def test_array_distinct():
    q = (lambda api, df: df.select(
        api.F.array_distinct(api.col("a")).alias("d")))
    run_both(q, _tbl(seed=40))
    _device_equals_cpu(q, _tbl(seed=40))


def test_array_set_ops():
    q = (lambda api, df: df.select(
        api.F.array_union(api.col("a"), api.col("b")).alias("u"),
        api.F.array_intersect(api.col("a"), api.col("b")).alias("i"),
        api.F.array_except(api.col("a"), api.col("b")).alias("e")))
    run_both(q, _tbl(seed=41))
    _device_equals_cpu(q, _tbl(seed=41))


def test_arrays_overlap():
    q = (lambda api, df: df.select(
        api.F.arrays_overlap(api.col("a"), api.col("b")).alias("o")))
    run_both(q, _tbl(seed=42))
    _device_equals_cpu(q, _tbl(seed=42))


# ---------------------------------------------------------------------------
# Every class over ints, doubles and strings (null elements present, so the
# JAX package's element validity is its own plane: C7 stays out)
# ---------------------------------------------------------------------------

SEEDED = {
    "a": ("b_a", 2), "f": ("b_f", 2.0), "w": ("b_w", "a"),
}


def _seeded_pairs(seed=11):
    t = seeded_table(400, seed)
    u = seeded_table(400, seed + 100)
    return t.append_column("b_a", u["a"]).append_column(
        "b_f", u["f"]).append_column("b_w", u["w"])


OPS = {
    "size_and_index": lambda api, c, b, v: [
        api.F.size(c).alias("n"), api.F.element_at(c, 2).alias("e2"),
        api.F.element_at(c, -2).alias("em2"), c.getItem(1).alias("g1"),
        c.getItem(api.col("k")).alias("gk")],
    "contains_position_remove": lambda api, c, b, v: [
        api.F.array_contains(c, v).alias("c"),
        api.F.array_position(c, api.lit(v)).alias("p"),
        api.F.array_remove(c, api.lit(v)).alias("r")],
    "slice": lambda api, c, b, v: [
        api.F.slice(c, api.lit(1), api.lit(3)).alias("s"),
        api.F.slice(c, api.lit(-3), api.lit(2)).alias("sn")],
    "distinct": lambda api, c, b, v: [api.F.array_distinct(c).alias("d")],
    "union": lambda api, c, b, v: [api.F.array_union(c, b).alias("u")],
    "intersect_except": lambda api, c, b, v: [
        api.F.array_intersect(c, b).alias("i"),
        api.F.array_except(c, b).alias("e")],
    "overlap": lambda api, c, b, v: [api.F.arrays_overlap(c, b).alias("o")],
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("src", sorted(SEEDED))
def test_every_class_over_element_types(op, src):
    other, value = SEEDED[src]
    t = _seeded_pairs()

    def q(api, df):
        return df.select(api.col("k"), *OPS[op](
            api, api.col(src), api.col(other), value))
    if op == "union" and src == "w":
        # the JAX package's device concatenation of string arrays raises
        # (C8): the port is held to its own CPU backend
        _device_equals_cpu(q, t)
        return
    run_both(q, t)
    _device_equals_cpu(q, t)


@pytest.mark.parametrize("src", ["a", "f"])
def test_sort_and_extremes_over_numbers(src):
    q = (lambda api, df: df.select(
        api.F.sort_array(api.col(src)).alias("sa"),
        api.F.sort_array(api.col(src), False).alias("sd"),
        api.F.array_min(api.col(src)).alias("mn"),
        api.F.array_max(api.col(src)).alias("mx")))
    run_both(q, _seeded_pairs())
    _device_equals_cpu(q, _seeded_pairs())


def test_string_sort_and_extremes_run_on_the_cpu():
    q = (lambda api, df: df.select(
        api.F.sort_array(api.col("w")).alias("sa"),
        api.F.array_max(api.col("w")).alias("mx")))
    run_both(q, _seeded_pairs(), placed=["Project"])


def test_map_lookup_with_duplicate_keys_takes_the_first():
    t = pa.table({"m": pa.array([[("a", 1), ("a", 2), ("b", 3)], [],
                                 None, [("b", None), ("a", 5)]],
                                pa.map_(pa.string(), pa.int64())),
                  "k": pa.array(["a", "a", "a", "b"])})
    q = (lambda api, df: df.select(
        api.F.element_at(api.col("m"), "a").alias("a"),
        api.F.element_at(api.col("m"), api.col("k")).alias("byk"),
        api.col("m").getItem("b").alias("b")))
    run_both(q, t)
    _device_equals_cpu(q, t)


def test_struct_fields_of_null_rows_and_dates():
    """A null struct row may hold valid children: the field is null there.
    Dates come out of a struct, an array and a map on the device and on
    the port's CPU backend."""
    d = datetime.date
    t = pa.table({
        "st": pa.StructArray.from_arrays(
            [pa.array([1, 2, None]), pa.array([d(2000, 1, 1)] * 3)],
            names=["x", "d"], mask=pa.array([False, True, False])),
        "ad": pa.array([[d(1999, 5, 1), d(2001, 2, 3)], [], None],
                       pa.list_(pa.date32()))})
    q = (lambda api, df: df.select(
        api.col("st").getField("x").alias("x"),
        api.col("st").getField("d").alias("d"),
        api.F.element_at(api.col("ad"), 1).alias("e1")))
    run_both(q, t)
    _device_equals_cpu(q, t)
    _device_equals_cpu(lambda api, df: df.select(
        api.F.array_max(api.col("ad")).alias("mx")), t)


def test_cpu_extremes_of_dates_c12():
    """The JAX package's CPU backend cannot build a DATE result of
    array_max from Python dates (C12); the port's converts them."""
    t = pa.table({"ad": pa.array([[datetime.date(1999, 5, 1)]],
                                 pa.list_(pa.date32()))})
    api, japi = torch_api(), jax_api()
    q = (lambda a, df: df.select(a.F.array_max(a.col("ad")).alias("m")))
    assert q(api, api.session().create_dataframe(t)).collect_cpu() \
        .to_pylist() == [{"m": datetime.date(1999, 5, 1)}]
    with pytest.raises(TypeError):
        q(japi, japi.session().create_dataframe(t)).collect_cpu()


# ---------------------------------------------------------------------------
# Index edges and errors
# ---------------------------------------------------------------------------

def test_element_at_zero_raises_in_both():
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(_tbl()).select(
            api.F.element_at(api.col("a"), 0).alias("z"))
        with pytest.raises(Exception, match="ElementAtIndexZero"):
            df.collect()
        with pytest.raises(Exception, match="indices start at 1"):
            df.collect_cpu()


@pytest.mark.parametrize("start,length,match", [
    (0, 1, "SliceStartZero"), (1, -1, "SliceNegativeLength")])
def test_slice_errors_in_both(start, length, match):
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(_tbl()).select(
            api.F.slice(api.col("a"), api.lit(start), api.lit(length)))
        with pytest.raises(Exception, match=match):
            df.collect()


def test_ansi_out_of_bounds_raises_in_both():
    conf = {"spark.sql.ansi.enabled": "true"}
    for api in (torch_api(), jax_api()):
        df = api.session(conf).create_dataframe(_tbl()).select(
            api.col("a").getItem(50).alias("g"))
        with pytest.raises(Exception, match="ArrayIndexOutOfBounds"):
            df.collect()


# ---------------------------------------------------------------------------
# The host tier and map_entries
# ---------------------------------------------------------------------------

def _maps_table():
    return pa.table({
        "k": pa.array([1, 2, 3, 4], pa.int32()),
        "w": pa.array([["a", None, "bb"], [], None, ["z"]],
                      pa.list_(pa.string())),
        "a": pa.array([[1, 2], [3], None, []], pa.list_(pa.int64())),
        "m": pa.array([[("x", 1.0)], [], None, [("y", None)]],
                      pa.map_(pa.string(), pa.float64())),
        "s": pa.array(["p:1,q:2", "", None, "r"]),
    })


def test_host_tier_equals_jax():
    def q(api, df):
        F, col, lit = api.F, api.col, api.lit
        return df.select(
            F.array_repeat(col("k"), lit(2)).alias("rep"),
            F.array_join(col("w"), "|").alias("j"),
            F.array_join(col("w"), "|", "~").alias("jn"),
            F.arrays_zip(col("a"), col("w")).alias("z"),
            F.map_from_arrays(col("a"), col("a")).alias("mfa"),
            F.map_concat(col("m"), F.map_from_arrays(
                F.array(lit("n")), F.array(lit(0.5)))).alias("mc"),
            F.str_to_map(col("s")).alias("sm"),
            F.map_entries(col("m")).alias("me"))
    run_both(q, _maps_table(), placed=["Project"])


@pytest.mark.parametrize("case,match", [
    ("concat", "Duplicate map key"), ("from_arrays", "differ in length"),
    ("str_to_map", "Duplicate map key")])
def test_host_tier_errors_in_both(case, match):
    t = pa.table({"m": pa.array([[("x", 1)]], pa.map_(pa.string(),
                                                      pa.int64())),
                  "a": pa.array([[1, 2]], pa.list_(pa.int64())),
                  "s": pa.array(["a:1,a:2"])})
    for api in (torch_api(), jax_api()):
        F, col = api.F, api.col
        df = api.session().create_dataframe(t)
        e = {"concat": F.map_concat(col("m"), col("m")),
             "from_arrays": F.map_from_arrays(col("a"), F.array(col("a"))),
             "str_to_map": F.str_to_map(col("s"))}[case]
        with pytest.raises(Exception, match=match):
            df.select(e.alias("r")).collect()


def test_map_entries_on_the_device_equals_its_cpu():
    """map_entries' array<struct> result stays off the device by its
    signature (both packages); its device arm is the map's planes under
    another type, held here to its eval_cpu."""
    _eval_equals_eval_cpu(AO.MapEntries, _maps_table().select(["m"]))
