"""The JSON functions and the NULL type in the port against the JAX
package: the programs of tests/test_json_functions.py, json_tuple and
to_json, the untyped NULL (literals, CASE, coalesce, array(), IN lists,
casts, SQL and a Catalyst plan, raise_error's type, a null column through
Arrow, an exchange and a union), and the formats phase's JSON shapes of
chip_smoke.py (read_json of nested documents, get_json_object,
json_tuple, from_json, to_json, null_sql) at a few thousand rows.

Each program runs through the JAX package's device path (on the CPU
here) and the port's device path and CPU backend; the answers compare
with tests/asserts.py ``assert_tables_equal``, exactly but for the summed
doubles of the shapes, relative 1e-12. Where the JAX package's device
raises (a null in a string IN list, ROADMAP C, known), the port is held
to the JAX package's CPU backend, which is Spark's answer.
"""
import pyarrow as pa
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.plan import overrides as PO


def both(build, make_df, placed=(), ignore_order=False, approx=None,
         jax_cpu=False):
    """build(api, make_df(api, session)) in both packages; the port's
    device and CPU answers equal the JAX package's (its CPU backend's
    when ``jax_cpu``), and the placements agree. Returns the port's
    table."""
    got, where = {}, {}
    for name, api, overrides in (("torch", torch_api(), PO),
                                 ("jax", jax_api(), JO)):
        s = api.session()
        df = build(api, make_df(api, s))
        got[name] = df.collect_cpu() if name == "jax" and jax_cpu \
            else df.collect()
        if name == "torch":
            got["torch_cpu"] = df.collect_cpu()
        where[name] = H.placement(overrides, df, s.conf)
    for other in ("jax", "torch_cpu"):
        assert_tables_equal(got["torch"], got[other],
                            ignore_order=ignore_order, approx_float=approx)
    assert where["torch"] == where["jax"]
    assert [n for n, _ in where["torch"]] == list(placed)
    return got["torch"]


# the JAX package's documents (tests/test_json_functions.py)
DOCS = [
    '{"a": 1, "b": {"c": "x"}, "arr": [10, 20, 30]}',
    '{"a": null, "b": {}}',
    '{"a": "text with \\"quote\\""}',
    'not json at all',
    None,
    '[1, 2, 3]',
    '{"a": 2.5, "flag": true, "arr": [{"k": 1}, {"k": 2}]}',
    '{"b": {"c": {"d": 7}}}',
    '{"a": 9007199254740993}',
]


def _docs(api, s):
    return s.create_dataframe({"j": pa.array(DOCS, pa.string())})


def test_get_json_object_paths():
    both(lambda api, df: df.select(
        *[api.F.get_json_object(api.col("j"), p).alias(n)
          for n, p in (("a", "$.a"), ("bc", "$.b.c"), ("bcd", "$.b.c.d"),
                       ("arr1", "$.arr[1]"), ("all", "$.arr[*]"),
                       ("top0", "$[0]"), ("mi", "$.missing"),
                       ("ks", "$.arr[*].k"), ("q", "$['a']"),
                       ("bad", "a.b"))]), _docs, placed=["Project"])


def test_get_json_object_renders_unquoted_and_compact():
    out = both(lambda api, df: df.select(
        api.F.get_json_object(api.col("j"), "$.a").alias("a"),
        api.F.get_json_object(api.col("j"), "$.b").alias("b")), _docs,
        placed=["Project"]).to_pydict()
    assert out["a"][2] == 'text with "quote"'
    assert out["b"][0] == '{"c":"x"}'


def test_from_json_struct():
    def build(api, df):
        T = api.T
        schema = T.StructType((T.StructField("a", T.FLOAT64),
                               T.StructField("flag", T.BOOLEAN),
                               T.StructField("b", T.StructType((
                                   T.StructField("c", T.STRING),)))))
        return df.select(api.F.from_json(api.col("j"), schema).alias("p"))
    both(build, _docs, placed=["Project"])


def test_from_json_then_extract():
    def build(api, df):
        T = api.T
        schema = T.StructType((T.StructField("a", T.INT64),))
        return df.select(api.F.from_json(api.col("j"), schema).alias("p")) \
            .select(api.col("p").get_field("a").alias("a"))
    both(build, _docs, placed=["Project"])


def test_json_fallback_visible():
    both(lambda api, df: df.select(
        api.F.get_json_object(api.col("j"), "$.a").alias("a")), _docs,
        placed=["Project"])


@pytest.mark.parametrize("kind", ["array", "map"])
def test_from_json_arrays_and_maps(kind):
    def build(api, df):
        T = api.T
        dt = T.ArrayType(T.INT64) if kind == "array" \
            else T.MapType(T.STRING, T.INT64)
        return df.select(api.F.from_json(api.col("j"), dt).alias("p"))
    docs = ['[1, 2, 3]', '{"a": 1, "b": null}', '[]', '{}', 'x', None,
            '[1.5, 2]', '{"k": 2.0}']
    both(build, lambda api, s: s.create_dataframe({"j": docs}),
         placed=["Project"])


def test_json_tuple_and_to_json():
    rows = [{"x": 1, "y": "p"}, {"x": None, "y": "q"}, None]
    t = pa.table({
        "j": ['{"a": 1, "b": {"c": [1, 2]}, "d": true}', '{"b": null}',
              'nope', None],
        "st": pa.array(rows + [{"x": 4, "y": None}],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array([[("a", 1.5)], [], None, [("b", None), ("c", 2.0)]],
                      pa.map_(pa.string(), pa.float64())),
    })
    both(lambda api, df: df.select(
        api.F.json_tuple(api.col("j"), "a", "b", "d").alias("jt"),
        api.F.to_json(api.col("st")).alias("s"),
        api.F.to_json(api.col("m")).alias("m")),
        lambda api, s: s.create_dataframe(t), placed=["Project"])


# -- NullType ---------------------------------------------------------------

def _small(api, s):
    return s.create_dataframe({"k": [1, 2, 3, None],
                               "s": ["a", None, "c", "d"],
                               "d": [1.5, None, -2.0, 4.0]})


@pytest.mark.parametrize("kind", ["numeric", "string"])
def test_null_literal_case_coalesce_and_array(kind):
    """The untyped NULL beside numbers, and beside strings, where the JAX
    package's device raises as it does on a null in a string IN list
    (ROADMAP C, known): there the port is held to its CPU backend."""
    def build(api, df):
        col, lit, F = api.col, api.lit, api.F
        if kind == "string":
            return df.select(
                F.when(col("k") > lit(1), lit(None)).otherwise(col("s"))
                .alias("c2"),
                F.coalesce(lit(None), col("s")).alias("cs"),
                (col("s") == lit(None)).alias("eq"))
        return df.select(
            lit(None).alias("z"),
            F.when(col("k") > lit(1), col("d")).alias("c1"),
            F.when(col("k") > lit(1), lit(None)).otherwise(col("d"))
            .alias("c2"),
            F.coalesce(lit(None), col("k"), lit(7)).alias("co"),
            (col("k") + lit(None)).alias("plus"),
            (col("d") == lit(None)).alias("eq"),
            lit(None).cast(api.T.INT32).alias("ci"))
    out = both(build, _small, jax_cpu=kind == "string")
    if kind == "numeric":
        assert out.schema.field("z").type == pa.null()
        assert out.column("co").to_pylist() == [1, 2, 3, 7]
    else:
        assert out.column("cs").to_pylist() == ["a", None, "c", "d"]


def test_array_with_a_null_element():
    out = both(lambda api, df: df.select(
        api.F.array(api.lit(None), api.col("k")).alias("a")), _small)
    assert out.column("a").to_pylist()[0] == [None, 1]


def test_empty_array_is_array_of_null():
    """ROADMAP C20: array() is an empty array<null> on every row (Spark's
    answer) on the port's device and CPU; the JAX package's CPU backend,
    where its tag sends it, makes a column of no rows: alone, the result
    has no rows; beside another column, the table cannot be built."""
    api = torch_api()
    df = _small(api, api.session()).select(
        api.F.array().alias("e"), api.F.size(api.F.array()).alias("n"))
    for got in (df.collect(), df.collect_cpu()):
        assert got.schema.field("e").type == pa.list_(pa.null())
        assert got.to_pydict() == {"e": [[]] * 4, "n": [0] * 4}
    api = jax_api()
    df = _small(api, api.session())
    assert df.select(api.F.array().alias("e")).collect().num_rows == 0
    with pytest.raises(pa.ArrowInvalid):
        df.select(api.col("k"), api.F.array().alias("e")).collect()


def test_null_in_a_string_in_list():
    # the JAX package's device raises here (ROADMAP C, known); its CPU
    # backend gives Spark's answer
    out = both(lambda api, df: df.select(
        api.col("s"), api.col("s").isin("a", None).alias("m")), _small,
        jax_cpu=True)
    assert out.column("m").to_pylist() == [True, None, None, None]


def test_null_column_through_arrow_exchange_and_union():
    def build(api, df):
        col, lit = api.col, api.lit
        z = df.select(col("k"), lit(None).alias("z"))
        return z.union(z).repartition(3, col("k"))
    out = both(build, _small, ignore_order=True)
    assert out.num_rows == 8 and out.column("z").null_count == 8
    # the carrier: an int8 plane, every row invalid
    c = B.column_from_arrow(pa.nulls(5), PT.NULL, 8, "cpu")
    assert c.data.dtype.is_floating_point is False and \
        not bool(c.validity.any())
    back = B.to_arrow(B.from_arrow(pa.table({"z": pa.nulls(3)}), "cpu"))
    assert back.column(0).type == pa.null() and back.column(0).null_count == 3


def test_sql_null_and_catalyst_types():
    li = H.make_lineitem(3000)
    got = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        s.create_or_replace_temp_view("lineitem", s.create_dataframe(li))
        df = s.sql(H.NULL_SQL)
        got.append(df.collect() if api.T is PT else df.collect_cpu())
        got.append(s.sql("SELECT l_returnflag, NULL AS z, CASE WHEN "
                         "l_quantity > 25 THEN NULL ELSE l_quantity END AS q"
                         " FROM lineitem WHERE l_discount < 0.02").collect())
    assert_tables_equal(got[0], got[2], ignore_order=True)
    assert_tables_equal(got[1], got[3], ignore_order=True)
    want = sum(1 for f in li.column("l_returnflag").to_pylist() if f == "A")
    assert got[0].to_pylist() == [{"l_returnflag": "A", "z": None, "n": want}]
    assert PT.common_type(PT.NULL, PT.INT32) == PT.INT32
    assert PT.to_arrow(PT.NULL) == pa.null()
    assert PT.from_arrow(pa.null()) == PT.NULL
    assert PT.Sigs.COMMON.supports(PT.NULL)


def test_raise_error_is_null_typed():
    api = torch_api()
    e = api.F.raise_error(api.lit("boom"))
    assert e.data_type() == PT.NULL


# -- the formats phase's JSON shapes (chip_smoke.py) -------------------------

@pytest.fixture(scope="module")
def formats_data(tmp_path_factory):
    li, od = H.make_tables(20_000)
    nested = H.make_orders_nested(li, od)
    docs = H.orders_json_lines(li, od, 1500)
    path = str(tmp_path_factory.mktemp("json") / "orders.json")
    with open(path, "w") as f:
        f.write("\n".join(docs) + "\n")
    return li, nested, docs, path


def test_orders_json_lines_are_the_lines(formats_data):
    import json
    li, _, docs, _ = formats_data
    parsed = [json.loads(d) for d in docs]
    key = li.column("l_orderkey").to_numpy()
    assert sum(len(d["price"]) for d in parsed) == int((key < 1500).sum())
    assert all(len(d["qty"]) == len(d["price"]) == len(d["flag"])
               for d in parsed)
    assert [d["orderkey"] for d in parsed] == list(range(1500))


def test_fm_json_lines(formats_data):
    li, _, _, path = formats_data
    out = both(H.fm_json_lines, lambda api, s: s.read_json(path),
               ignore_order=True, approx=1e-12)
    key = li.column("l_orderkey").to_numpy()
    assert sum(out.column("n").to_pylist()) == int((key < 1500).sum())


@pytest.mark.parametrize("shape", ["js_path_rows", "js_from_json"])
def test_js_shapes(formats_data, shape):
    _, _, docs, _ = formats_data
    both(getattr(H, shape),
         lambda api, s: s.create_dataframe({"doc": docs[:400]}),
         placed=H.FORMATS_CPU_NODES[shape], ignore_order=True,
         approx=1e-12)


def test_js_to_json_fb(formats_data):
    _, nested, _, _ = formats_data
    both(H.js_to_json_fb, lambda api, s: s.create_dataframe(nested),
         placed=["Project"], ignore_order=True)
