"""The nested types in the port against the JAX package: struct and map
columns through Arrow, the complex-type expressions of expr/complex.py,
sequence, the explode family through GenerateExec (all four forms, after a
filter, over 1 and 3 partitions), stack in both lowerings, the placement
report of every nested tag, SQL and plan ingestion, and the nested phase
of chip_smoke.py at 3,000 orders with its routes.

Inputs are built with numpy from a seed, or written out, at a few
thousand rows at most. Tolerance: none; rows and lists compare exactly
(NaN equal to NaN, -0.0 equal to 0.0 as == has it), except the sums of
the explode shapes' aggregates, relative 1e-12, and nx_stack's sums over
30,000 lines, relative 1e-12 too (both packages sum in their own order).

Where the JAX package's answer is not Spark's, the port is held to
Spark's and the test says which ROADMAP C entry records it: C7 (the JAX
package's device set operations read element validity through the row
count), C8 (its device array_union of strings raises), C9 (its CPU set
operations keep every NaN), C10 (its device membership compares an int
array with a double one by their keys' bits).
"""
import datetime
import math

import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu.plan.ingest import ingest as jax_ingest
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan.ingest import ingest

D = datetime.date


def same(a, b, rel=0.0) -> bool:
    """Recursive equality of Python rows: NaN equals NaN; floats within
    ``rel`` (relative) when it is set."""
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k], rel) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b


def _canon(t: pa.Table, sort: bool):
    rows = t.to_pylist()
    if sort:
        rows.sort(key=lambda r: repr(r).replace("-0.0", "0.0"))
    return rows


def assert_same(got: pa.Table, want: pa.Table, sort=False, rel=0.0):
    assert got.schema.names == want.schema.names
    g, w = _canon(got, sort), _canon(want, sort)
    assert len(g) == len(w), (g[:5], w[:5])
    for i, (a, b) in enumerate(zip(g, w)):
        assert same(a, b, rel), f"row {i}: port {a!r} jax {b!r}"


def _walk(meta):
    yield meta
    for c in meta.children:
        yield from _walk(c)


def placement(overrides, df, conf):
    """(node, reasons) of every node a package's tagging keeps off the
    device, with the JAX package's TPU named GPU."""
    meta = overrides.wrap_and_tag(df.plan, conf)
    return [(type(m.plan).__name__,
             [r.replace("TPU", "GPU") for r in m.reasons])
            for m in _walk(meta) if m.reasons]


def run_both(build, table, parts=1, conf=None, sort=False, rel=0.0,
             placed=()):
    """build(api, df) in both packages over ``table``; asserts equal rows
    and equal placement, and that the nodes kept off the device are
    ``placed``. Returns the port's table."""
    out, where = [], []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session(conf)
        df = build(api, s.create_dataframe(table, num_partitions=parts))
        out.append(df.collect())
        where.append(placement(overrides, df, s.conf))
    assert_same(out[0], out[1], sort=sort, rel=rel)
    assert where[0] == where[1]
    assert [n for n, _ in where[0]] == list(placed)
    return out[0]


def nested_table():
    """The JAX package's own test table (tests/test_nested_types.py)."""
    return pa.table({
        "k": pa.array([1, 2, 3, 4, 5], pa.int32()),
        "a": pa.array([[1, 2], [], None, [3, None, 5], [6]],
                      pa.list_(pa.int64())),
        "sa": pa.array([["x", "y"], None, [], ["z"], [None, "w"]],
                       pa.list_(pa.string())),
        "st": pa.array([{"x": 1, "y": "p"}, {"x": None, "y": "q"}, None,
                        {"x": 4, "y": None}, {"x": 5, "y": "r"}],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array([[("a", 1.0)], [("b", 2.0), ("c", 3.0)], [], None,
                       [("d", None)]], pa.map_(pa.string(), pa.float64())),
    })


def seeded_table(n=600, seed=7):
    """Arrays of ints, doubles (NaN, -0.0, inf) and strings with null rows,
    null elements and empty rows; a struct with a date; maps with string
    and int keys (a duplicate key in some rows, as Arrow allows)."""
    rng = np.random.default_rng(seed)

    def arr(gen, p_row=0.12, p_el=0.12, maxlen=6):
        out = []
        for _ in range(n):
            if rng.random() < p_row:
                out.append(None)
                continue
            out.append([None if rng.random() < p_el else gen()
                        for _ in range(int(rng.integers(0, maxlen + 1)))])
        return out
    fl = [0.0, -0.0, 1.5, 2.0, float("nan"), -3.25, float("inf")]
    words = ["a", "bb", "", "ccc", "a", "dd"]
    return pa.table({
        "k": pa.array(rng.integers(-3, 6, n).astype(np.int32)),
        "a": pa.array(arr(lambda: int(rng.integers(-4, 5))),
                      pa.list_(pa.int64())),
        "f": pa.array(arr(lambda: fl[int(rng.integers(0, len(fl)))]),
                      pa.list_(pa.float64())),
        "w": pa.array(arr(lambda: words[int(rng.integers(0, 6))]),
                      pa.list_(pa.string())),
        "st": pa.array([None if rng.random() < 0.1 else {
            "x": None if rng.random() < 0.2 else int(rng.integers(-9, 9)),
            "d": D(1995, 1, 1) + datetime.timedelta(int(rng.integers(0, 900))),
            "s": words[int(rng.integers(0, 6))]} for _ in range(n)],
            pa.struct([("x", pa.int64()), ("d", pa.date32()),
                       ("s", pa.string())])),
        "m": pa.array([None if rng.random() < 0.1 else [
            (words[int(rng.integers(0, 6))],
             None if rng.random() < 0.2 else fl[int(rng.integers(0, 7))])
            for _ in range(int(rng.integers(0, 4)))] for _ in range(n)],
            pa.map_(pa.string(), pa.float64())),
        "mi": pa.array([None if rng.random() < 0.1 else [
            (int(rng.integers(-2, 3)), int(rng.integers(0, 50)))
            for _ in range(int(rng.integers(0, 4)))] for _ in range(n)],
            pa.map_(pa.int32(), pa.int64())),
    })


# ---------------------------------------------------------------------------
# Arrow round trips
# ---------------------------------------------------------------------------

ROUND_TRIPS = {
    "struct": pa.array([{"x": 1, "y": "a", "d": D(2000, 1, 2)}, None,
                        {"x": None, "y": None, "d": None}],
                       pa.struct([("x", pa.int64()), ("y", pa.string()),
                                  ("d", pa.date32())])),
    "map": pa.array([[("a", 1.0), ("a", 2.0)], None, [], [("b", None)]],
                    pa.map_(pa.string(), pa.float64())),
    "array_of_struct": pa.array([[{"p": 1}, None, {"p": None}], None, []],
                                pa.list_(pa.struct([("p", pa.int32())]))),
    "map_of_string": pa.array([[("k", "v"), ("", None)], [], None],
                              pa.map_(pa.string(), pa.string())),
    "struct_of_array": pa.array([{"l": [1, 2]}, {"l": None}, None],
                                pa.struct([("l", pa.list_(pa.int16()))])),
    "map_of_array": pa.array([[(3, ["x", None])], None, [(4, [])]],
                             pa.map_(pa.int64(), pa.list_(pa.string()))),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_arrow_round_trip(name):
    arr = ROUND_TRIPS[name]
    t = pa.table({"c": arr, "i": pa.array(range(len(arr)), pa.int32())})
    got = B.to_arrow(B.from_arrow(t, "cpu"), t.column_names)
    assert got.schema == t.schema
    assert same(got.to_pylist(), t.to_pylist())
    for api in (torch_api(), jax_api()):
        out = api.session().create_dataframe(t).collect()
        assert out.schema == t.schema and same(out.to_pylist(),
                                               t.to_pylist())


def test_arrow_null_rows_own_non_empty_slices():
    """Arrow lets a null list or map row own elements; the device layout
    drops them, over a sliced input too (a partition)."""
    offsets = pa.array([0, 2, 5, 6], pa.int32())
    mask = pa.array([False, True, False])
    lst = pa.ListArray.from_arrays(offsets, pa.array(np.arange(6.0)),
                                   mask=mask)
    mp = pa.MapArray.from_arrays(offsets, pa.array(list("abcdef")),
                                 pa.array(np.arange(6)), mask=mask)
    t = pa.table({"l": lst, "m": mp})
    col = B.from_arrow(t, "cpu").columns[0]
    assert col.data["offsets"][:4].tolist() == [0, 2, 2, 3]
    for part in (t, t.slice(1, 2)):
        got = B.to_arrow(B.from_arrow(part, "cpu"), part.column_names)
        assert got.to_pylist() == part.to_pylist()
    run_both(lambda api, df: df.select(api.F.explode_outer(api.col("m"))),
             t, parts=2)


def test_struct_and_map_types_round_trip_through_types():
    from spark_rapids_tpu_torch import types as T
    st = T.StructType((T.StructField("a", T.INT32),
                       T.StructField("b", T.MapType(T.STRING, T.FLOAT64))))
    assert T.from_arrow(T.to_arrow(st)) == st
    assert repr(st) == "struct<a:int32,b:map<string,float64>>"
    assert T.Sigs.COMMON.nested().supports(T.MapType(T.STRING, T.INT64))
    assert not T.Sigs.COMMON.nested().supports(
        T.MapType(T.STRING, T.ArrayType(T.INT64)))


# ---------------------------------------------------------------------------
# The JAX package's tests/test_nested_types.py, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,colname", [
    ("explode", "a"), ("explode_outer", "a"), ("posexplode", "a"),
    ("posexplode_outer", "a"), ("explode", "sa"), ("explode_outer", "sa"),
    ("explode", "m"), ("explode_outer", "m")])
def test_explode_variants(fn, colname):
    run_both(lambda api, df: df.select(
        api.col("k"), getattr(api.F, fn)(api.col(colname))), nested_table())


def test_explode_preserves_order_after_filter():
    run_both(lambda api, df: df.filter(api.col("k") != api.lit(2)).select(
        api.col("k"), api.F.explode_outer(api.col("a")).alias("v")),
        nested_table())


def test_size_element_at_contains():
    def q(api, df):
        F, col = api.F, api.col
        return df.select(F.size(col("a")).alias("sz"),
                         F.size(col("m")).alias("szm"),
                         F.element_at(col("a"), 1).alias("e1"),
                         F.element_at(col("a"), -1).alias("em1"),
                         F.element_at(col("m"), "b").alias("mb"),
                         col("a").get_item(0).alias("i0"),
                         F.array_contains(col("a"), 3).alias("c3"))
    run_both(q, nested_table())


def test_struct_field_access():
    run_both(lambda api, df: df.select(
        api.col("st").get_field("x").alias("x"),
        api.col("st").getField("y").alias("y"),
        (api.col("st").get_field("x") + api.col("k")).alias("xk")),
        nested_table())


def test_map_keys_values():
    run_both(lambda api, df: df.select(
        api.F.map_keys(api.col("m")).alias("mk"),
        api.F.map_values(api.col("m")).alias("mv")), nested_table())


def test_create_array():
    run_both(lambda api, df: df.select(
        api.F.array(api.col("k"), api.col("k") * api.lit(10)).alias("arr"),
        api.F.array(api.col("k"), api.lit(2.5)).alias("widened")),
        nested_table())


def test_explode_then_aggregate():
    run_both(lambda api, df: df.select(
        api.col("k"), api.F.explode(api.col("a")).alias("v"))
        .group_by(api.col("k")).agg(api.F.sum("v").alias("sv"),
                                    api.F.count("v").alias("cv")),
        nested_table(), sort=True)


@pytest.mark.parametrize("shape", ["filter", "sort", "union", "limit"])
def test_nested_passthrough(shape):
    def q(api, df):
        col = api.col
        if shape == "filter":
            return df.filter(col("k") > api.lit(1)).select(
                col("k"), col("a"), col("st"), col("m"), col("sa"))
        if shape == "sort":
            return df.order_by(col("k").desc()).select(
                col("k"), col("a"), col("sa"), col("m"), col("st"))
        if shape == "union":
            one = df.select(col("k"), col("a"), col("m"), col("st"))
            return one.union(one)
        return df.select(col("k"), col("a"), col("m")).limit(3)
    run_both(q, nested_table(), sort=shape == "union")


def test_nested_cache_and_partitions():
    """A cached nested table over 3 partitions, filtered and collected
    (the exchange-free concatenation of nested partitions)."""
    t = seeded_table(300, 3)
    for api in (torch_api(),):
        df = api.session().create_dataframe(t, num_partitions=3).cache()
        got = df.filter(api.col("k") > api.lit(0)).collect()
    want = jax_api().session().create_dataframe(t).filter(
        jax_api().col("k") > jax_api().lit(0)).collect()
    assert_same(got, want)


def test_gen_nested_random():
    from data_gen import (ArrayGen, DoubleGen, IntegerGen, LongGen, MapGen,
                          RepeatSeqGen, StringGen, StructGen, gen_table)
    spec = [("k", RepeatSeqGen(IntegerGen(min_val=0, max_val=30),
                               length=25)),
            ("a", ArrayGen(LongGen(), max_len=5)),
            ("sa", ArrayGen(StringGen(min_len=0, max_len=6), max_len=4)),
            ("st", StructGen([("p", IntegerGen()),
                              ("q", DoubleGen(no_nans=True))])),
            ("m", MapGen(StringGen(min_len=1, max_len=3), LongGen(),
                         max_len=4))]
    run_both(lambda api, df: df.select(
        api.col("k"), api.F.explode_outer(api.col("a")).alias("v")),
        gen_table(spec, 512, 47))
    run_both(lambda api, df: df.select(
        api.F.size(api.col("a")).alias("sz"),
        api.F.element_at(api.col("a"), 2).alias("e2"),
        api.col("st").get_field("p").alias("p"),
        api.F.element_at(api.col("m"), "ab").alias("mab")),
        gen_table(spec, 512, 53))
    run_both(lambda api, df: df.select(
        api.col("k"), api.F.explode(api.col("sa")).alias("sv"))
        .group_by(api.col("sv")).agg(api.F.count().alias("n")),
        gen_table(spec, 512, 59), sort=True)


def test_nested_join_falls_back():
    t = nested_table()

    def q(api, df):
        right = df.select(api.col("k").alias("rk")).limit(2)
        return df.join(right, api.col("k") == api.col("rk"), "inner")
    run_both(q, t, sort=True, placed=["Join"])


def test_explode_with_nested_sibling_falls_back():
    run_both(lambda api, df: df.select(
        api.col("sa"), api.F.explode(api.col("a")).alias("v")),
        nested_table(), placed=["Generate"])


def test_explode_with_struct_sibling_on_device():
    run_both(lambda api, df: df.select(
        api.col("st"), api.F.explode(api.col("a")).alias("v")),
        nested_table())


def test_order_by_nested_falls_back():
    run_both(lambda api, df: df.order_by(api.col("a").asc()).select(
        api.col("k"), api.col("a")), nested_table(), placed=["Sort"])


def test_explode_requires_array_or_map():
    for api in (torch_api(), jax_api()):
        with pytest.raises(Exception, match="array or map"):
            api.session().create_dataframe(nested_table()).select(
                api.F.explode(api.col("k")))


# ---------------------------------------------------------------------------
# GenerateExec: all four forms, after a filter, over 1 and 3 partitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("fn", ["explode", "explode_outer", "posexplode",
                                "posexplode_outer"])
@pytest.mark.parametrize("src", ["f", "w", "mi"])
def test_generate_forms(fn, src, parts):
    """Over ~600 rows of the seeded table, after a filter that kills some
    rows, carrying a struct; the output keeps the child planes' capacity
    with a live mask, so the collect compacts it."""
    t = seeded_table()

    def q(api, df):
        col = api.col
        return df.filter(col("k") != api.lit(2)).select(
            col("k"), col("st"), getattr(api.F, fn)(col(src)))
    got = run_both(q, t, parts=parts, sort=parts > 1)
    assert got.num_rows > 0


def test_generate_output_is_a_masked_batch_at_child_capacity():
    api = torch_api()
    s = api.session()
    df = s.create_dataframe(nested_table()).select(
        api.col("k"), api.F.posexplode_outer(api.col("a")))
    df.collect()
    gen = [e for e in s.last_exec.walk() if isinstance(e, X.GenerateExec)]
    assert len(gen) == 1
    batch = next(gen[0].execute_partition(0))
    # 5 rows of capacity 1024, 6 elements in a 1024-element child: the
    # outer form scatters into 1024 + 1024 slots
    assert batch.capacity == 2048 and batch.row_mask is not None
    assert int(batch.num_rows) == 8


# ---------------------------------------------------------------------------
# stack: the Expand lowering and the union of selects
# ---------------------------------------------------------------------------

def _expand_forms(port_session):
    return [e.stacked for e in port_session.last_exec.walk()
            if isinstance(e, X.ExpandExec)]


def test_stack_lowers_onto_expand():
    t = seeded_table(200, 4)
    run_both(lambda api, df: df.select(api.col("k"), api.F.stack(
        3, api.lit("p"), api.col("k"), api.lit("q"),
        api.col("k") + api.lit(1), api.lit("r"))), t)
    api = torch_api()
    s = api.session()
    df = s.create_dataframe(t).select(api.F.stack(
        2, api.col("k"), api.col("k") * api.lit(2)).alias("v"))
    assert type(df.plan).__name__ == "Expand"
    df.collect()
    assert _expand_forms(s) == [False]


def test_stack_beside_a_generator_lowers_to_a_union():
    """Another item with its own lowering (an explode): one select per
    stack row, unioned; each select lowers the explode to a Generate and
    binds the stack's value against it. The JAX package binds the values
    to the input's schema first, so they read the Generate's columns by
    the input's positions (ROADMAP C11): the port is held to the union of
    the two selects, run one by one in the JAX package."""
    t = seeded_table(120, 5)

    def q(api, df):
        return df.select(api.F.stack(2, api.col("k"),
                                     api.col("k") + api.lit(10)).alias("v"),
                         api.F.explode(api.col("a")).alias("e"))
    api, japi = torch_api(), jax_api()
    got = q(api, api.session().create_dataframe(t))
    assert type(got.plan).__name__ == "Union"
    assert all(type(c.children[0]).__name__ == "Generate"
               for c in got.plan.children)
    jdf = japi.session().create_dataframe(t)
    want = pa.concat_tables([jdf.select(
        v.alias("v"), japi.F.explode(japi.col("a")).alias("e")).collect()
        for v in (japi.col("k"), japi.col("k") + japi.lit(10))])
    assert_same(got.collect(), want, sort=True)
    with pytest.raises(pa.ArrowInvalid, match="Schema at index 1"):
        q(japi, jdf).collect()


def test_stack_and_explode_errors_match_jax():
    t = nested_table()
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(t)
        with pytest.raises(Exception, match="only one generator"):
            df.select(api.F.explode(api.col("a")),
                      api.F.explode(api.col("sa")))
        with pytest.raises(Exception, match="row count must be positive"):
            api.F.stack(0, api.col("k"))
        with pytest.raises(Exception, match="mixes"):
            df.select(api.F.stack(2, api.col("k"), api.lit("x")))


# ---------------------------------------------------------------------------
# Tags: every nested tag's placement report equals the JAX package's
# ---------------------------------------------------------------------------

TAG_CASES = {
    "map_entries": (lambda api, df: df.select(
        api.F.map_entries(api.col("m")).alias("e")), ["Project"]),
    "create_array_strings": (lambda api, df: df.select(
        api.F.array(api.lit("x"), api.lit("y")).alias("e")), ["Project"]),
    "sort_array_strings": (lambda api, df: df.select(
        api.F.sort_array(api.col("sa")).alias("e")), ["Project"]),
    "array_min_strings": (lambda api, df: df.select(
        api.F.array_min(api.col("sa")).alias("e")), ["Project"]),
    "cpu_tier": (lambda api, df: df.select(
        api.F.array_join(api.col("sa"), "-").alias("j"),
        api.F.array_repeat(api.col("k"), api.lit(2)).alias("r"),
        api.F.sequence(api.col("k"), api.lit(3)).alias("q")), ["Project"]),
    "group_by_array": (lambda api, df: df.group_by(api.col("a")).agg(
        api.F.count().alias("n")), ["Aggregate"]),
    "order_by_struct": (lambda api, df: df.order_by(api.col("st")),
                        ["Sort"]),
    "collect_list_struct": (lambda api, df: df.group_by(api.col("k")).agg(
        api.F.collect_list(api.col("st")).alias("l")), ["Aggregate"]),
    "sibling_map": (lambda api, df: df.select(
        api.col("m"), api.F.explode(api.col("a"))), ["Generate"]),
    "repartition_struct": (lambda api, df: df.repartition(
        2, api.col("k")), ["Repartition"]),
    "struct_sibling": (lambda api, df: df.select(
        api.col("st"), api.F.posexplode(api.col("m"))), []),
}


@pytest.mark.parametrize("case", sorted(TAG_CASES))
def test_nested_tags_equal_jax(case):
    build, placed = TAG_CASES[case]
    sort = case in ("group_by_array", "collect_list_struct",
                    "repartition_struct")
    if case == "order_by_struct":
        # the JAX package's CPU orders a struct with a null string field
        # by Python comparison of None (raises): compare the reports only
        where = []
        for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
            s = api.session()
            where.append(placement(overrides, build(
                api, s.create_dataframe(nested_table())), s.conf))
        assert where[0] == where[1] and [n for n, _ in where[0]] == placed
        return
    run_both(build, nested_table(), sort=sort, placed=placed)


def test_xxhash64_of_nested_values_chains_them_c5():
    """The JAX package tags xxhash64 of a struct to the CPU, as the port
    does, and its CPU then raises (C5). Spark chains a struct's fields:
    xxhash64(st) is xxhash64(st.x, st.y), and a null struct keeps the
    seed 42; an array chains its elements, a map each key then value."""
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session()
        df = s.create_dataframe(nested_table()).select(
            api.F.xxhash64(api.col("st")).alias("h"))
        assert [n for n, _ in placement(overrides, df, s.conf)] == \
            ["Project"]
    api = torch_api()
    col, F = api.col, api.F
    df = api.session().create_dataframe(nested_table())
    got = df.select(F.xxhash64(col("st")).alias("a"),
                    F.xxhash64(col("st").get_field("x"),
                               col("st").get_field("y")).alias("b"),
                    F.xxhash64(col("a")).alias("arr"),
                    F.xxhash64(col("m")).alias("map")).collect().to_pylist()
    assert [r["a"] for r in got] == [
        42 if i == 2 else r["b"] for i, r in enumerate(got)]
    flat = df.select(F.xxhash64(F.element_at(col("a"), 1),
                                F.element_at(col("a"), 2)).alias("h"),
                     F.xxhash64(F.element_at(F.map_keys(col("m")), 1),
                                F.element_at(F.map_values(col("m")), 1))
                     .alias("hm")).collect().to_pylist()
    assert got[0]["arr"] == flat[0]["h"]      # [1, 2]
    assert got[0]["map"] == flat[0]["hm"]     # {a: 1.0}
    assert got[2]["arr"] == 42 and got[3]["map"] == 42


# ---------------------------------------------------------------------------
# sequence, SQL and plan ingestion
# ---------------------------------------------------------------------------

def test_sequence_equals_jax():
    t = pa.table({"a": pa.array([1, 5, 3, None, -2], pa.int64()),
                  "b": pa.array([4, 1, 3, 2, 2], pa.int64()),
                  "s": pa.array([1, -2, 1, 1, 2], pa.int64())})
    run_both(lambda api, df: df.select(
        api.F.sequence(api.col("a"), api.col("b")).alias("q"),
        api.F.sequence(api.col("a"), api.col("b"), api.col("s"))
        .alias("qs")), t, placed=["Project"])
    for api in (torch_api(), jax_api()):
        with pytest.raises(Exception, match="step must not be zero"):
            api.session().create_dataframe(t).select(api.F.sequence(
                api.col("a"), api.col("b"), api.lit(0))).collect()


SQL_QUERIES = [
    "SELECT k, v FROM (SELECT k, explode(a) AS v FROM t) WHERE v > 1",
    "SELECT k, size(a) AS n, element_at(a, 1) AS e, "
    "array_contains(a, 3) AS c FROM t",
    "SELECT k, sort_array(a) AS s, array_max(a) AS mx FROM t",
    "SELECT key, value FROM (SELECT explode(m) FROM t)",
]


@pytest.mark.parametrize("query", SQL_QUERIES)
def test_sql_reaches_the_nested_functions_like_jax(query):
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        s.create_or_replace_temp_view("t", s.create_dataframe(
            nested_table()))
        out.append(s.sql(query).collect())
    assert_same(*out)


def test_sql_struct_field_raises_like_jax():
    msgs = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        s.create_or_replace_temp_view("t", s.create_dataframe(
            nested_table()))
        with pytest.raises(KeyError) as e:
            s.sql("SELECT st.x AS x, explode(a) AS v FROM t")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("gen", ["explode", "explode_outer", "posexplode",
                                 "posexplode_outer"])
def test_ingest_generate_equals_jax(gen):
    doc = {"version": 1, "plan": {
        "node": "generate", "generator": gen,
        "input": {"expr": "col", "name": "a"},
        "child": {"node": "in_memory",
                  "rows": {"k": [1, 2, 3], "a": [[1, 2], [], None]}}}}
    got = ingest(doc, torch_api().session()).collect()
    want = jax_ingest(doc, jax_api().session()).collect()
    assert_same(got, want)
    bad = dict(doc, plan=dict(doc["plan"], generator="inline"))
    with pytest.raises(SparkException, match="unknown generator"):
        ingest(bad, torch_api().session())


# ---------------------------------------------------------------------------
# The reference's faults (ROADMAP C7-C10): the port gives Spark's answer
# ---------------------------------------------------------------------------

def test_set_ops_without_null_elements_c7():
    """No null element, so the child has no validity plane: the JAX
    package's device reads element e >= the row count as null (C7) and
    drops distinct values; the port and both CPU backends keep them."""
    t = pa.table({"a": pa.array([[1.0, 2.0, 3.0, 2.0]],
                                pa.list_(pa.float64())),
                  "b": pa.array([[3.0, 4.0]], pa.list_(pa.float64()))})

    def q(api, df):
        F, col = api.F, api.col
        return df.select(F.array_distinct(col("a")).alias("d"),
                         F.array_intersect(col("a"), col("b")).alias("i"),
                         F.array_except(col("a"), col("b")).alias("e"),
                         F.arrays_overlap(col("a"), col("b")).alias("o"))
    spark = [{"d": [1.0, 2.0, 3.0], "i": [3.0], "e": [1.0, 2.0],
              "o": True}]
    api = torch_api()
    df = q(api, api.session().create_dataframe(t))
    assert df.collect().to_pylist() == spark
    assert df.collect_cpu().to_pylist() == spark
    japi = jax_api()
    jdf = q(japi, japi.session().create_dataframe(t))
    assert jdf.collect_cpu().to_pylist() == spark
    assert jdf.collect().to_pylist() != spark


def test_string_array_union_c8():
    t = pa.table({"a": pa.array([["x", "y"], None, ["z"]],
                                pa.list_(pa.string())),
                  "b": pa.array([["y", None], ["q"], []],
                                pa.list_(pa.string()))})

    def q(api, df):
        return df.select(api.F.array_union(api.col("a"), api.col("b"))
                         .alias("u"))
    api = torch_api()
    df = q(api, api.session().create_dataframe(t))
    want = [{"u": ["x", "y", None]}, {"u": None}, {"u": ["z"]}]
    assert df.collect().to_pylist() == want == df.collect_cpu().to_pylist()
    japi = jax_api()
    with pytest.raises(NotImplementedError, match="string array concat"):
        q(japi, japi.session().create_dataframe(t)).collect()


def test_nan_is_one_set_value_c9():
    nan = float("nan")
    t = pa.table({"a": pa.array([[nan, 1.0, nan, None]],
                                pa.list_(pa.float64())),
                  "b": pa.array([[nan, None]], pa.list_(pa.float64()))})

    def q(api, df):
        F, col = api.F, api.col
        return df.select(F.array_distinct(col("a")).alias("d"),
                         F.array_union(col("a"), col("b")).alias("u"),
                         F.array_except(col("a"), col("b")).alias("e"),
                         F.arrays_overlap(col("a"), col("b")).alias("o"))
    api = torch_api()
    df = q(api, api.session().create_dataframe(t))
    dev, cpu = df.collect().to_pylist(), df.collect_cpu().to_pylist()
    assert same(dev, cpu)
    assert same(dev, [{"d": [nan, 1.0, None], "u": [nan, 1.0, None],
                       "e": [1.0], "o": True}])
    japi = jax_api()
    jcpu = q(japi, japi.session().create_dataframe(t)).collect_cpu()
    assert len(jcpu.to_pylist()[0]["d"]) == 4  # every NaN kept


def test_membership_in_the_common_type_c10():
    t = pa.table({"a": pa.array([[1, 2], [5], None], pa.list_(pa.int64()))})

    def q(api, df):
        F, col, lit = api.F, api.col, api.lit
        small = F.array(lit(1.0), lit(2.5))
        return df.select(F.arrays_overlap(col("a"), small).alias("o"),
                         F.array_intersect(col("a"), small).alias("i"))
    api = torch_api()
    df = q(api, api.session().create_dataframe(t))
    want = [{"o": True, "i": [1.0]}, {"o": False, "i": []},
            {"o": None, "i": None}]
    assert df.collect().to_pylist() == want == df.collect_cpu().to_pylist()


# ---------------------------------------------------------------------------
# chip_smoke.py's nested phase at 3,000 orders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orders_nested():
    li, od = H.make_tables(30_000)
    return li, H.make_orders_nested(li, od)


#: shape -> (port routes, CPU nodes, Expand forms) at 3,000 orders
SMOKE_SHAPES = {
    "nx_explode_daily": ({"_segsum_or_fallback"}, [], []),
    "nx_posexplode_outer": ({"_scatter_agg"}, [], []),
    "nx_array_rows": (set(), [], []),
    "nx_struct_rows": (set(), [], []),
    "nx_map_groups": ({"_bucket_update"}, [], []),
    "nx_stack": ({"_sort_agg"}, [], [False]),
    "nx_cpu_collections_fb": (set(), ["Project"], []),
    "nx_sibling_fb": ({"_scatter_agg"}, ["Generate"], []),
    "sql_nested": ({"_segsum_or_fallback"}, [], []),
    "ingest_generate": ({"_scatter_agg"}, ["Generate"], []),
}


SET_COLUMNS = ("ad", "ov", "au", "ai", "ae")


def _dedup(vals):
    out = []
    for v in vals:
        if v not in out:
            out.append(v)
    return out


def _check_set_columns(got: pa.Table, nested: pa.Table):
    rows = {r["o_orderkey"]: r["l_qty"] for r in nested.to_pylist()}
    small = list(H.NX_SET)
    for r in got.to_pylist():
        q = rows[r["o_orderkey"]]
        assert r["ad"] == _dedup(q)
        assert r["ov"] == any(x in small for x in q)
        assert r["au"] == _dedup(q + small)
        assert r["ai"] == _dedup([x for x in q if x in small])
        assert r["ae"] == _dedup([x for x in q if x not in small])


def _route_spy(monkeypatch):
    hits = set()
    for m in ("_global_update", "_bucket_update", "_segsum_or_fallback",
              "_chunked_segsum_agg", "_scatter_agg", "_sort_agg",
              "_packed_sort_agg"):
        orig = getattr(X._AggKernels, m)

        def spy(kern, *a, _m=m, _o=orig, **k):
            hits.add(_m)
            return _o(kern, *a, **k)
        monkeypatch.setattr(X._AggKernels, m, spy)
    return hits


def _smoke_df(shape, api, s, li, nested):
    if shape == "nx_stack":
        return H.nx_stack(api, s.create_dataframe(li))
    n1 = s.create_dataframe(nested)
    if shape == "nx_explode_daily":
        return H.nx_explode_daily(api, s.create_dataframe(
            nested, num_partitions=8))
    if shape == "sql_nested":
        s.create_or_replace_temp_view("orders_nested", H.nx_view(api, n1))
        return s.sql(H.SQL_NESTED)
    return getattr(H, shape)(api, n1)


@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES))
def test_smoke_nested_shapes_equal_jax(shape, orders_nested, tmp_path,
                                       monkeypatch):
    li, nested = orders_nested
    hits = _route_spy(monkeypatch)
    out, where, sessions = [], [], []
    for api, overrides, ing in ((torch_api(), PO, ingest),
                                (jax_api(), JO, jax_ingest)):
        s = api.session()
        if shape == "ingest_generate":
            import pyarrow.parquet as pq
            path = str(tmp_path / "flat.parquet")
            pq.write_table(H.orders_nested_flat(nested), path)
            df = ing(H.nx_generate_doc(path), s)
        else:
            df = _smoke_df(shape, api, s, li, nested)
        out.append(df.collect())
        where.append(placement(overrides, df, s.conf))
        sessions.append(s)
        if overrides is PO:
            port_routes = set(hits)
    routes, cpu, forms = SMOKE_SHAPES[shape]
    sort = shape not in ("nx_array_rows", "nx_struct_rows",
                         "nx_cpu_collections_fb")
    if shape == "nx_array_rows":
        # l_qty holds no null element: the JAX package's device set
        # operations are C7's there, so those columns are held to Python
        _check_set_columns(out[0], nested)
        keep = [c for c in out[0].column_names if c not in SET_COLUMNS]
        out = [t.select(keep) for t in out]
    assert_same(out[0], out[1], sort=sort, rel=1e-12)
    assert where[0] == where[1]
    assert [n for n, _ in where[0]] == cpu
    assert port_routes == routes
    assert _expand_forms(sessions[0]) == forms
    if forms:
        # the JAX package's Expand ran fused (a fused stage's member) or
        # one projection per batch (an ExpandExec of its own)
        jax_execs = {type(e).__name__ for e in _jax_walk(
            sessions[1]._last_exec)}
        assert ("ExpandExec" in jax_execs) == (not forms[0])


def _jax_walk(e):
    yield e
    for c in e.children:
        yield from _jax_walk(c)


@pytest.mark.parametrize("form", ["dataframe", "sql"])
def test_explode_of_a_built_array_c16(form):
    """ROADMAP C16: the JAX package's CPU backend raises on an explode of
    an array built in the query (``if not items:`` over a numpy array,
    spark_rapids_tpu/exec/cpu_backend.py:296); both of the port's tiers
    answer, as does the JAX package's device."""
    t = pa.table({"k": pa.array([1, 2, None], pa.int64())})
    want = [{"k": 1, "e": 1}, {"k": 1, "e": 2}, {"k": 2, "e": 2},
            {"k": 2, "e": 3}, {"k": None, "e": None}, {"k": None, "e": None}]

    def build(api):
        s = api.session()
        df = s.create_dataframe(t)
        if form == "sql":
            s.create_or_replace_temp_view("t", df)
            return s.sql("SELECT k, explode(array(k, k + 1)) AS e FROM t")
        return df.select(api.col("k"), api.F.explode(api.F.array(
            api.col("k"), api.col("k") + api.lit(1))).alias("e"))

    def rows(tbl):
        return sorted(tbl.to_pylist(), key=repr)
    df = build(torch_api())
    assert rows(df.collect()) == rows(df.collect_cpu()) == sorted(want,
                                                                  key=repr)
    jdf = build(jax_api())
    assert rows(jdf.collect()) == sorted(want, key=repr)
    with pytest.raises(ValueError, match="truth value"):
        jdf.collect_cpu()
