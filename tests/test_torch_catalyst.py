"""Plan ingestion in the port against the JAX package, on the CPU: Spark's
Catalyst plan JSON (``plan/catalyst.py``) and the versioned plan contract
(``plan/ingest.py``).

- Every Catalyst plan of ``tests/golden_plans/`` (the files whose nodes
  carry a ``class``) through both ``ingest_catalyst`` over the same
  Parquet files, one case per file: the same answer.
- The contract cases of ``tests/test_plan_ingest.py`` through both
  ``ingest``: ``generate``, ``text_scan`` (ROADMAP A7) and a function of
  A9d (``to_json``) answer as the JAX package does.
- What the port's types cannot carry raises: a decimal above 18 digits;
  an unsupported class raises the JAX package's message.

Tolerances: exact, but float sums and averages, relative 1e-12 (the JAX
package aggregates over the tests' eight virtual devices, partial ->
exchange -> final, the port once: the adds may run in another order).
"""
import glob
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from asserts import assert_tables_equal
import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan.catalyst import ingest_catalyst as jax_catalyst
from spark_rapids_tpu.plan.ingest import ingest as jax_ingest

from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan.catalyst import ingest_catalyst
from spark_rapids_tpu_torch.plan.ingest import ingest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_plans")
F64_TOL = 1e-12


def _catalyst_files():
    out = []
    for path in sorted(glob.glob(os.path.join(GOLDEN, "*.json"))):
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, list) and doc and "class" in doc[0]:
            out.append(os.path.basename(path)[:-5])
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The Parquet files of tests/test_catalyst_plans.py and a session of
    each package."""
    data = tmp_path_factory.mktemp("catalyst_data")
    rng = np.random.default_rng(31)
    n = 4000
    pq.write_table(pa.table({
        "l_orderkey": rng.integers(0, 300, n),
        "l_quantity": np.round(rng.uniform(1, 100, n), 2),
        "l_extendedprice": np.round(rng.uniform(1, 1000, n), 2),
        "l_discount": np.round(rng.uniform(0, 0.1, n), 3),
        "l_shipdate": rng.integers(0, 200, n).astype(np.int32),
        "l_flag": np.array(["A", "B", "C"])[rng.integers(0, 3, n)],
    }), str(data / "lineitem.parquet"))
    pq.write_table(pa.table({
        "o_orderkey": np.arange(300, dtype=np.int64),
        "o_orderdate": rng.integers(0, 200, 300).astype(np.int32),
        "o_prio": np.array(["HIGH", "LOW"])[rng.integers(0, 2, 300)],
    }), str(data / "orders.parquet"))
    return str(data), torch_api().session(), jax_api().session()


@pytest.mark.parametrize("name", _catalyst_files())
def test_golden_catalyst_plan_answers_like_jax(name, env):
    data, port, ref = env
    with open(os.path.join(GOLDEN, name + ".json")) as f:
        raw = f.read().replace("$DATA", data)
    got = ingest_catalyst(raw, port).collect()
    want = jax_catalyst(raw, ref).collect()
    assert got.num_rows == want.num_rows
    # sort_limit and q3's top 10 keep their order; the rest is a set
    ordered = name in ("sort_limit", "q3_join_agg_topn")
    assert_tables_equal(got, want, ignore_order=not ordered,
                        approx_float=F64_TOL)


def test_unsupported_class_raises_like_jax(env):
    _, port, ref = env
    bad = json.dumps([{"class": "org.apache.spark.sql.execution.python."
                       "ArrowEvalPythonExec", "num-children": 0}])
    messages = []
    for fn, s in ((ingest_catalyst, port), (jax_catalyst, ref)):
        with pytest.raises(Exception, match="ArrowEvalPythonExec") as e:
            fn(bad, s)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _literal_plan(data, dtype, value):
    """A ProjectExec of one Literal over the lineitem scan."""
    scan = {"class": "org.apache.spark.sql.execution.FileSourceScanExec",
            "num-children": 0, "paths": [data + "/lineitem.parquet"]}
    lit = [{"class": "org.apache.spark.sql.catalyst.expressions.Literal",
            "num-children": 0, "value": value, "dataType": dtype}]
    return json.dumps([{"class": "org.apache.spark.sql.execution.ProjectExec",
                        "num-children": 1, "projectList": [lit]}, scan])


def test_port_types_raise_where_they_cannot_carry(env):
    data, port, ref = env
    got = ingest_catalyst(_literal_plan(data, "decimal(12,2)", "12.50"),
                          port).collect()
    want = jax_catalyst(_literal_plan(data, "decimal(12,2)", "12.50"),
                        ref).collect()
    assert got.num_rows == 4000 and got.column(0)[0] == want.column(0)[0]
    with pytest.raises(SparkException, match="DECIMAL64"):
        ingest_catalyst(_literal_plan(data, "decimal(20,2)", "1.00"), port)
    # the untyped null is NullType since ROADMAP A9d, as in the JAX
    # package: a column of nulls
    got = ingest_catalyst(_literal_plan(data, "null", None), port).collect()
    want = jax_catalyst(_literal_plan(data, "null", None), ref).collect()
    assert got.schema.types == want.schema.types == [pa.null()]
    assert got.num_rows == want.num_rows == 4000


# ---------------------------------------------------------------------------
# the versioned contract (tests/test_plan_ingest.py's cases)
# ---------------------------------------------------------------------------

def _q6_doc(path):
    return {"version": 1, "plan": {
        "node": "aggregate", "keys": [],
        "aggs": [{"fn": "sum", "alias": "rev",
                  "child": {"expr": "mul",
                            "left": {"expr": "col", "name": "price"},
                            "right": {"expr": "col", "name": "disc"}}}],
        "child": {"node": "filter",
                  "condition": {"expr": "and",
                                "left": {"expr": "ge",
                                         "left": {"expr": "col",
                                                  "name": "disc"},
                                         "right": {"expr": "lit",
                                                   "value": 0.05}},
                                "right": {"expr": "lt",
                                          "left": {"expr": "col",
                                                   "name": "qty"},
                                          "right": {"expr": "lit",
                                                    "value": 24.0}}},
                  "child": {"node": "parquet_scan", "paths": [path]}}}}


JOIN_DOC = {"version": 1, "plan": {
    "node": "limit", "n": 3,
    "child": {"node": "sort",
              "orders": [{"expr": {"expr": "col", "name": "v"},
                          "ascending": False}],
              "child": {"node": "join", "how": "inner",
                        "left_keys": [{"expr": "col", "name": "k"}],
                        "right_keys": [{"expr": "col", "name": "k"}],
                        "left": {"node": "in_memory",
                                 "rows": {"k": [1, 2, 3, 4],
                                          "v": [10, 20, 30, 40]}},
                        "right": {"node": "in_memory",
                                  "rows": {"k": [2, 3, 4, 5]}}}}}}

CALLS_DOC = {"version": 1, "plan": {
    "node": "project",
    "exprs": [{"expr": "alias", "name": "r",
               "child": {"expr": "call", "fn": "round",
                         "args": [{"expr": "col", "name": "x"}]}},
              {"expr": "alias", "name": "c",
               "child": {"expr": "cast", "type": "decimal(10,2)",
                         "child": {"expr": "col", "name": "x"}}}],
    "child": {"node": "filter",
              "condition": {"expr": "ne",
                            "left": {"expr": "col", "name": "x"},
                            "right": {"expr": "lit", "value": 2.0}},
              "child": {"node": "in_memory",
                        "rows": {"x": [1.25, 2.0, 3.5, -4.5]}}}}}


@pytest.fixture(scope="module")
def q6_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ingest") / "li.parquet")
    pq.write_table(pa.table({
        "qty": pa.array([10.0, 30.0, 5.0, 20.0]),
        "price": pa.array([100.0, 200.0, 300.0, 400.0]),
        "disc": pa.array([0.05, 0.06, 0.02, 0.07])}), path)
    return path


@pytest.mark.parametrize("case", ["q6", "join_sort_limit", "calls"])
def test_contract_answers_like_jax(case, env, q6_path):
    _, port, ref = env
    doc = {"q6": _q6_doc(q6_path), "join_sort_limit": JOIN_DOC,
           "calls": CALLS_DOC}[case]
    df = ingest(doc, port)
    got, want = df.collect(), jax_ingest(doc, ref).collect()
    assert_tables_equal(got, want, ignore_order=case == "calls")
    assert_tables_equal(df.collect_cpu(), got, ignore_order=True)
    if case == "q6":
        assert abs(got.to_pylist()[0]["rev"]
                   - (100 * 0.05 + 400 * 0.07)) < 1e-9


GENERATE_DOC = {"version": 1, "plan": {
    "node": "generate", "generator": "explode",
    "input": {"expr": "call", "fn": "sequence",
              "args": [{"expr": "lit", "value": 1},
                       {"expr": "col", "name": "n"}]},
    "child": {"node": "in_memory", "rows": {"n": [2, 3]}}}}

TEXT_DOC = {"version": 1, "plan": {"node": "text_scan", "format": "csv",
                                   "paths": ["lineitem.csv"]}}


def _text_doc(tmp_path):
    """TEXT_DOC over a CSV file of bench.py's lineitem columns."""
    import pyarrow.csv as pcsv
    path = str(tmp_path / "lineitem.csv")
    pcsv.write_csv(H.make_lineitem(500), path)
    return {"version": 1, "plan": dict(TEXT_DOC["plan"], paths=[path])}

CALL_A9_DOC = {"version": 1, "plan": {
    "node": "project",
    "exprs": [{"expr": "call", "fn": "to_json",
               "args": [{"expr": "col", "name": "s"}]}],
    "child": {"node": "in_memory",
              "rows": {"s": [{"a": 1}, {"a": 3}]}}}}

#: a datetime call the port has since the datetime slice
CALL_YEAR_DOC = {"version": 1, "plan": {
    "node": "project",
    "exprs": [{"expr": "call", "fn": "year",
               "args": [{"expr": "col", "name": "d"}]},
              {"expr": "call", "fn": "add_months",
               "args": [{"expr": "col", "name": "d"},
                        {"expr": "lit", "value": 13}]}],
    "child": {"node": "in_memory", "rows": {"d": [1, 2, -800, 20000]}}}}


@pytest.mark.parametrize("case,doc,item", [
    ("generate", GENERATE_DOC, None),
    ("text_scan", TEXT_DOC, "ROADMAP A7"),
    ("call_not_ported", CALL_A9_DOC, "ROADMAP A9")])
def test_contract_raises_at_ingest_naming_the_roadmap(case, doc, item, env,
                                                     tmp_path):
    # the ROADMAP items these cases named are ported: A7's text_scan and
    # A9d's to_json answer as the JAX package does
    _, port, ref = env
    if case == "text_scan":
        doc = _text_doc(tmp_path)
    if case != "generate":
        got = ingest(doc, port).collect()
        assert_tables_equal(got, jax_ingest(doc, ref).collect())
        if case == "call_not_ported":
            assert [list(r.values())[0] for r in got.to_pylist()] == \
                ['{"a":1}', '{"a":3}']
        else:
            assert got.num_rows == 500
        return
    if case == "generate":
        # the nested slice ported Generate: the port answers as the JAX
        # package does (the sequence input runs on the CPU in both)
        got = ingest(doc, port).collect()
        assert_tables_equal(got, jax_ingest(doc, ref).collect())
        assert sorted(r["col"] for r in got.to_pylist()) == [1, 1, 2, 2, 3]
        return


def test_contract_datetime_call_equals_jax(env):
    _, port, ref = env
    assert_tables_equal(ingest(CALL_YEAR_DOC, port).collect(),
                        jax_ingest(CALL_YEAR_DOC, ref).collect())


def test_contract_version_gate(env):
    _, port, ref = env
    with pytest.raises(SparkException, match="version") as e:
        ingest({"version": 99, "plan": {}}, port)
    with pytest.raises(Exception, match="version") as j:
        jax_ingest({"version": 99, "plan": {}}, ref)
    assert str(e.value) == str(j.value)
