"""The higher-order functions (expr/hof.py) in the port against the JAX
package: the nine programs of tests/test_hof.py, nulls at every level
(null rows, null elements, empty arrays and maps, a null lambda result),
outer references from a lambda body, nested lambdas, the three-valued
exists/forall, transform_keys' errors, the placement of a lambda holding
a CPU-only expression, localization inside a lambda body, and the
formats phase's lambda shapes of chip_smoke.py at 2,000 orders.

Each program runs through the JAX package (its device path, on the CPU
here) and through the port's device path and its CPU backend; the three
answers compare with tests/asserts.py ``assert_tables_equal``. Tolerance:
none, but the summed shapes over doubles, held to relative 1e-12 (the
two packages sum in their own order).
"""
import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu_torch.expr import hof as PH
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import overrides as PO


def both(build, table, placed=(), ignore_order=False, approx=None,
         conf=None, parts=1):
    """build(api, df) over ``table`` in both packages: the JAX package's
    device answer, the port's device answer and its CPU backend's must
    agree, and so must the two placements, whose CPU nodes are
    ``placed``. Returns the port's table."""
    got = {}
    where = {}
    for name, api, overrides in (("torch", torch_api(), PO),
                                 ("jax", jax_api(), JO)):
        s = api.session(conf)
        df = build(api, s.create_dataframe(table, num_partitions=parts))
        got[name] = df.collect()
        if name == "torch":
            got["torch_cpu"] = df.collect_cpu()
        where[name] = H.placement(overrides, df, s.conf)
    for other in ("jax", "torch_cpu"):
        assert_tables_equal(got["torch"], got[other],
                            ignore_order=ignore_order, approx_float=approx)
    assert where["torch"] == where["jax"]
    assert [n for n, _ in where["torch"]] == list(placed)
    return got["torch"]


# the JAX package's own inputs (tests/test_hof.py)

def _arrays(n=60, seed=7):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        if rng.random() < 0.1:
            rows.append(None)
            continue
        ln = int(rng.integers(0, 6))
        rows.append([None if rng.random() < 0.15 else int(v)
                     for v in rng.integers(-50, 50, ln)])
    base = rng.integers(1, 10, n).astype(np.int64)
    return pa.table({"a": pa.array(rows, pa.list_(pa.int64())),
                     "m": pa.array(base)})


def _two_arrays(n=50, seed=11):
    rng = np.random.default_rng(seed)

    def mk():
        rows = []
        for _ in range(n):
            if rng.random() < 0.1:
                rows.append(None)
                continue
            ln = int(rng.integers(0, 5))
            rows.append([int(v) for v in rng.integers(-20, 20, ln)])
        return pa.array(rows, pa.list_(pa.int64()))
    return pa.table({"a": mk(), "b": mk()})


def _maps(n=40, seed=3):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        if rng.random() < 0.1:
            rows.append(None)
            continue
        k = rng.choice(20, size=int(rng.integers(0, 5)), replace=False)
        rows.append([(int(kk), int(rng.integers(-30, 30))) for kk in k])
    return pa.table({"m": pa.array(rows, pa.map_(pa.int64(), pa.int64()))})


# -- the programs of tests/test_hof.py --------------------------------------

def test_transform_simple():
    both(lambda api, df: df.select(api.F.transform(
        api.col("a"), lambda x: x * api.lit(2) + api.lit(1)).alias("t")),
        _arrays())


def test_transform_with_index_and_outer_ref():
    both(lambda api, df: df.select(
        api.F.transform(api.col("a"), lambda x, i: x + i).alias("ti"),
        api.F.transform(api.col("a"), lambda x: x * api.col("m"))
        .alias("to")), _arrays())


def test_filter_lambda():
    both(lambda api, df: df.select(
        api.F.filter(api.col("a"), lambda x: x > api.lit(0)).alias("f"),
        api.F.filter(api.col("a"),
                     lambda x, i: i % api.lit(2) == api.lit(0)).alias("fe")),
        _arrays())


def test_exists_forall_three_valued():
    out = both(lambda api, df: df.select(
        api.F.exists(api.col("a"), lambda x: x > api.lit(25)).alias("ex"),
        api.F.forall(api.col("a"), lambda x: x > api.lit(-49)).alias("fa")),
        _arrays())
    # a null element with no deciding one gives null
    assert None in out.column("ex").to_pylist()


def test_zip_with():
    both(lambda api, df: df.select(api.F.zip_with(
        api.col("a"), api.col("b"), lambda x, y: x + y).alias("z")),
        _two_arrays())


def test_transform_values_and_map_filter():
    both(lambda api, df: df.select(
        api.F.transform_values(api.col("m"),
                               lambda k, v: v * api.lit(3)).alias("tv"),
        api.F.map_filter(api.col("m"),
                         lambda k, v: v > api.lit(0)).alias("mf")), _maps())


def test_transform_keys():
    both(lambda api, df: df.select(api.F.transform_keys(
        api.col("m"), lambda k, v: k + api.lit(100)).alias("tk")), _maps())


def test_aggregate_fold_cpu_tier():
    both(lambda api, df: df.select(
        api.F.aggregate(api.col("a"), api.lit(0),
                        lambda acc, x: acc + api.F.coalesce(x, api.lit(0)))
        .alias("s"),
        api.F.aggregate(api.col("a"), api.lit(1),
                        lambda acc, x: acc * api.F.coalesce(x, api.lit(1)),
                        lambda acc: acc + api.lit(5)).alias("p")),
        _arrays(), placed=["Project"])


def test_nested_hof():
    both(lambda api, df: df.select(api.F.transform(
        api.F.filter(api.col("a"), lambda x: x.is_not_null()),
        lambda x: x - api.lit(1)).alias("nf")), _arrays())


# -- nulls, empties, outer references, nesting -------------------------------

def _doubles(n=300, seed=5):
    """Arrays of doubles and strings with null rows, null elements and
    empty rows, a key and a map with string keys."""
    rng = np.random.default_rng(seed)

    def arr(gen):
        out = []
        for _ in range(n):
            r = rng.random()
            if r < 0.1:
                out.append(None)
            elif r < 0.2:
                out.append([])
            else:
                out.append([None if rng.random() < 0.15 else gen()
                            for _ in range(int(rng.integers(1, 7)))])
        return out
    maps = []
    for _ in range(n):
        r = rng.random()
        if r < 0.1:
            maps.append(None)
            continue
        keys = rng.choice(["AF", "NO", "RF", "RO", "xy"],
                          size=int(rng.integers(0, 4)), replace=False)
        maps.append([(str(k), None if rng.random() < 0.1
                      else float(rng.integers(1, 60))) for k in keys])
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n).astype(np.int64)),
        "d": pa.array(arr(lambda: float(rng.integers(-20, 20)) / 4)),
        "s": pa.array(arr(lambda: str(rng.choice(["a", "bb", "", "Cc"])))),
        "mp": pa.array(maps, pa.map_(pa.string(), pa.float64())),
    })


def test_null_lambda_results_and_empty_rows():
    both(lambda api, df: df.select(
        api.F.transform(api.col("d"), lambda x: x / (x - x)).alias("nul"),
        api.F.transform(api.col("d"), lambda x, i: x * i).alias("xi"),
        api.F.filter(api.col("d"), lambda x: x.is_null()).alias("fn"),
        api.F.size(api.F.filter(api.col("d"), lambda x: x > api.lit(1.0)))
        .alias("n"),
        api.F.exists(api.col("d"), lambda x: x.is_null()).alias("en"),
        api.F.forall(api.col("d"), lambda x: x < api.lit(5.0)).alias("fa")),
        _doubles())


def test_outer_reference_and_string_elements():
    both(lambda api, df: df.select(
        api.col("k"),
        api.F.transform(api.col("d"), lambda x: x + api.col("k"))
        .alias("dk"),
        api.F.filter(api.col("s"), lambda x: api.F.length(x) > api.col("k"))
        .alias("sk"),
        api.F.exists(api.col("s"), lambda x: x == api.lit("bb")).alias("e"),
        api.F.zip_with(api.col("d"), api.col("s"),
                       lambda x, y: x + api.F.length(y)).alias("z")),
        _doubles())


def test_lambda_inside_lambda_reads_outer_parameter():
    """ROADMAP C17: an inner lambda reading the outer lambda's parameter
    and an outer array. The port gathers both to the inner element plane
    and gives Spark's answer on the device and the CPU; the JAX package's
    device passes the outer binding on at the outer plane's length and
    answers wrongly, and its CPU backend raises."""
    t = _doubles(60)

    def build(api, df):
        return df.select(api.F.transform(
            api.col("d"), lambda x: api.F.size(api.F.filter(
                api.col("d"), lambda y: y > x))).alias("rank"))
    want = [None if d is None else
            [sum(1 for y in d if y is not None and x is not None and y > x)
             for x in d] for d in t.column("d").to_pylist()]
    api = torch_api()
    df = build(api, api.session().create_dataframe(t))
    assert df.collect().column("rank").to_pylist() == want
    assert df.collect_cpu().column("rank").to_pylist() == want
    api = jax_api()
    df = build(api, api.session().create_dataframe(t))
    assert df.collect().column("rank").to_pylist() != want
    with pytest.raises(ValueError):
        df.collect_cpu()


def test_map_lambdas_string_keys():
    both(lambda api, df: df.select(
        api.F.transform_values(api.col("mp"),
                               lambda k, v: v * api.lit(2.0)).alias("tv"),
        api.F.map_filter(api.col("mp"),
                         lambda k, v: v > api.lit(10.0)).alias("mf"),
        api.F.transform_keys(api.col("mp"),
                             lambda k, v: api.F.lower(k)).alias("tk")),
        _doubles())


@pytest.mark.parametrize("parts", [1, 3])
def test_lambda_over_filtered_batch(parts):
    """ROADMAP C18: a lambda reading an outer column after a filter. The
    port gives Spark's answer on the device and the CPU; the JAX
    package's device answers wrongly (its CPU backend is right)."""
    t = _doubles()

    def build(api, df):
        return df.filter(api.col("k") > api.lit(1)).select(
            api.col("k"), api.F.transform(api.col("d"),
                                          lambda x: x * api.col("k"))
            .alias("t"))
    want = sorted(repr((r["k"], None if r["d"] is None else
                        [None if x is None else x * r["k"] for x in r["d"]]))
                  for r in t.to_pylist() if r["k"] > 1)

    def rows(tbl):
        return sorted(repr((r["k"], r["t"])) for r in tbl.to_pylist())
    api = torch_api()
    df = build(api, api.session().create_dataframe(t, num_partitions=parts))
    assert rows(df.collect()) == want
    assert rows(df.collect_cpu()) == want
    api = jax_api()
    df = build(api, api.session().create_dataframe(t, num_partitions=parts))
    assert rows(df.collect()) != want
    assert rows(df.collect_cpu()) == want


@pytest.mark.parametrize("fn", ["null_key", "duplicate_key"])
def test_transform_keys_errors(fn):
    t = pa.table({"m": pa.array([[(1, 2), (2, 3)]],
                                pa.map_(pa.int64(), pa.int64()))})
    for dev in ("device", "cpu"):
        api = torch_api()
        col, lit, F = api.col, api.lit, api.F
        body = (lambda k, v: api.E.Literal(None, api.T.INT64)) \
            if fn == "null_key" else (lambda k, v: k - k)
        df = api.session({"spark.sql.ansi.enabled": True}).create_dataframe(
            t).select(F.transform_keys(col("m"), body).alias("x"))
        with pytest.raises(SparkException):
            df.collect() if dev == "device" else df.collect_cpu()


def test_cpu_expression_in_a_lambda_tags_the_function():
    # reverse() has no device arm: the whole projection goes to the CPU,
    # with the JAX package's reason
    both(lambda api, df: df.select(api.F.transform(
        api.col("s"), lambda x: api.F.reverse(x)).alias("r")),
        _doubles(), placed=["Project"])


def test_lambda_types_bind_before_a_rewrite():
    e = torch_api().F.transform(torch_api().col("d"), lambda x: x + 1)
    from spark_rapids_tpu_torch.plan.nodes import bind_expr
    from spark_rapids_tpu_torch import types as T
    schema = T.Schema((T.StructField("d", T.ArrayType(T.FLOAT64)),))
    bound = PH.bind_lambda_types(bind_expr(e, schema))
    assert bound.vars[0].dtype == T.FLOAT64
    assert bound.data_type() == T.ArrayType(T.FLOAT64)


def test_lambda_in_a_non_utc_session():
    """ROADMAP C19: the session zone inside a lambda body. The port's
    localization binds the lambda's parameter types first, so hour() of
    a timestamp element reads the New York wall clock (Spark's answer);
    the JAX package's pass sees the parameter untyped and answers in
    UTC."""
    import datetime
    import zoneinfo
    us = [[1_700_000_000_000_000, None], [1_600_000_000_000_000], None]
    t = pa.table({"ts": pa.array(us, pa.list_(pa.timestamp("us")))})
    ny = zoneinfo.ZoneInfo("America/New_York")
    want = [None if r is None else
            [None if v is None else datetime.datetime.fromtimestamp(
                v / 1e6, ny).hour for v in r] for r in us]
    conf = {"spark.sql.session.timeZone": "America/New_York"}

    def build(api):
        return api.session(conf).create_dataframe(t).select(
            api.F.transform(api.col("ts"), lambda x: api.F.hour(x))
            .alias("h"))
    df = build(torch_api())
    assert df.collect().column("h").to_pylist() == want
    assert df.collect_cpu().column("h").to_pylist() == want
    assert build(jax_api()).collect().column("h").to_pylist() == [
        [22, None], [12], None]


# -- the formats phase's lambda shapes (chip_smoke.py) -----------------------

@pytest.fixture(scope="module")
def orders_nested():
    li, od = H.make_tables(20_000)
    return H.make_orders_nested(li, od)


@pytest.mark.parametrize("shape", ["lx_array_preds", "lx_zip_explode",
                                   "lx_map_lambdas", "lx_fold_fb"])
def test_smoke_lambda_shapes(orders_nested, shape):
    placed = ["Project"] if shape == "lx_fold_fb" else []
    both(getattr(H, shape), orders_nested, placed=placed,
         ignore_order=True, approx=1e-12)
