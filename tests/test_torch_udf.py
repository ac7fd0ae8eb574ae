"""The port's UDF tier (``sql/udf.py``, ``sql/udf_compiler.py``,
``runtime/pyworker.py``) against the JAX package's, on the CPU.

- The row tier: the programs of ``tests/test_expr_breadth.py``'s row-UDF
  test through both packages, nulls included, tagged to the CPU with the
  JAX package's reason (``torch_udf`` where it says ``jax_udf``).
- The bytecode compiler: ``compile_udf`` accepts and rejects the same
  lambdas, and the compiled trees print the same (``fingerprint``), but
  for ``min``/``max``, which the JAX package builds with the argument list
  as one child (ROADMAP C21) and the port with the arguments. The
  programs of ``tests/test_udf_compiler.py``: compiled against row tier,
  Python ``%`` and ``//`` on negatives, closure constants, ``len`` of
  strings and the compiler key switched off.
- ``torch_udf`` against ``jax_udf`` for one function written with
  operators only, on both of the port's backends; a result that is not a
  tensor on the batch's device raises.
- A Project holding a UDF stays above the aggregate in both packages'
  pruned plans.
- The worker pool: one run at parallelism 2 through the session, and
  what a spawned worker has loaded (no JAX, no CUDA); the pool is shut
  down after.

Tolerances: exact, but where a compiled tree calls a transcendental
(sqrt, log, pow): relative 1e-12 between the packages (XLA's CPU math
is not numpy's libm, see ``tests/test_torch_math.py``), and compiled
against the row tier relative 1e-9, the JAX package's own rule in
``tests/test_udf_compiler.py``.
"""
from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.expr import core as JE
from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu.plan import prune as JP
from spark_rapids_tpu.sql import udf_compiler as JUC

from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan import prune as PP
from spark_rapids_tpu_torch.runtime import pyworker
from spark_rapids_tpu_torch.sql import udf as PU
from spark_rapids_tpu_torch.sql import udf_compiler as PUC

COMPILER_ON = {"spark.rapids.sql.udfCompiler.enabled": "true"}


def _both(conf=None):
    return [(api, api.session(conf)) for api in (torch_api(), jax_api())]


def _run_both(build, table, conf=None, num_partitions=1):
    """(port result, JAX result) of build(api, df) over ``table``."""
    out = []
    for api, s in _both(conf):
        out.append(build(api, s.create_dataframe(
            table, num_partitions=num_partitions)).collect())
    return out


# ---------------------------------------------------------------------------
# the row tier
# ---------------------------------------------------------------------------

def _square_plus(a, b):
    if a is None:
        return None
    return a * a + (b or 0)


def _square_plus_query(api, df):
    f = api.udf(_square_plus, return_type=api.T.INT64)
    return df.select(f(api.col("a"), api.col("b")).alias("r"))


SQUARE_TABLE = pa.table({"a": pa.array([1, 2, None], pa.int64()),
                         "b": pa.array([10, None, 30], pa.int64())})


def test_row_udf_matches_jax_and_tags_to_the_cpu():
    got, want = _run_both(_square_plus_query, SQUARE_TABLE)
    assert got.to_pydict()["r"] == [11, 4, None]
    assert_tables_equal(got, want)
    (papi, ps), (japi, js) = _both()
    pdf = _square_plus_query(papi, ps.create_dataframe(SQUARE_TABLE))
    jdf = _square_plus_query(japi, js.create_dataframe(SQUARE_TABLE))
    port = H.placement(PO, pdf, ps.conf)
    ref = [(node, [r.replace("jax_udf", "torch_udf") for r in reasons])
           for node, reasons in H.placement(JO, jdf, js.conf)]
    assert port == ref == [("Project", [
        "Project: python UDF '_square_plus' runs on CPU (use torch_udf "
        "for device execution)"])]


# ---------------------------------------------------------------------------
# the bytecode compiler
# ---------------------------------------------------------------------------

def _straight_line(a, b):
    s = a + b
    d = a - b
    return s * d


def _loop(x):
    t = 0
    for _ in range(3):
        t += x
    return t


_K = 10


def _closure():
    k = _K

    def shifted(x):
        return x + k
    return shifted


#: name -> (function, argument types, compiles?)
COMPILE_CASES = {
    "arith": (lambda x: x * 2 + 1, ("INT64",), True),
    "ratio": (lambda x, y: (x - y) / (x + y + 1), ("FLOAT64", "FLOAT64"),
              True),
    "ternary": (lambda x: x if x > 0 else -x, ("INT64",), True),
    "math": (lambda x: math.sqrt(x) + math.log(x + 1.0), ("FLOAT64",),
             True),
    "straight_line": (_straight_line, ("INT64", "INT64"), True),
    "pymod": (lambda x, y: x % y, ("INT64", "INT64"), True),
    "pyfloordiv": (lambda x, y: x // y, ("INT64", "INT64"), True),
    "closure": (_closure(), ("INT64",), True),
    "len": (lambda s: len(s), ("STRING",), True),
    "casts": (lambda x: float(x) + int(x) + round(x), ("FLOAT64",), True),
    "floor_ceil": (lambda x: math.floor(x / 3.0) + math.ceil(x / 7.0),
                   ("FLOAT64",), True),
    "bits": (lambda x: (x & 12) | (x ^ 5) << 1, ("INT64",), True),
    "compare": (lambda x, y: not (x <= y) and x != 3, ("INT64", "INT64"),
                False),
    "pow_abs": (lambda x: abs(x) ** 0.5 if x > 0 else 0.0, ("INT64",),
                True),
    "loop": (_loop, ("INT64",), False),
    "unknown_call": (lambda x: hash(x), ("INT64",), False),
    "list": (lambda x: [x, x], ("INT64",), False),
    "method": (lambda s: s.lower(), ("STRING",), False),
    "none_test": (_square_plus, ("INT64", "INT64"), False),
}


def _refs(E, T, names):
    return [E.BoundRef(i, getattr(T, n), f"c{i}")
            for i, n in enumerate(names)]


@pytest.mark.parametrize("case", list(COMPILE_CASES))
def test_compile_udf_accepts_and_rejects_like_jax(case):
    fn, names, compiles = COMPILE_CASES[case]
    papi, japi = torch_api(), jax_api()
    got = PUC.compile_udf(fn, _refs(papi.E, papi.T, names))
    want = JUC.compile_udf(fn, _refs(japi.E, japi.T, names))
    assert (got is not None) == (want is not None) == compiles
    if compiles:
        assert got.fingerprint() == want.fingerprint()


def test_min_max_compile_to_their_arguments():
    """ROADMAP C21: the JAX package's compiler builds min/max as
    Least/Greatest of one child, the argument list; the port's takes the
    arguments, and the compiled tree evaluates to Python's answer."""
    fn = lambda x: abs(x) + max(x, 0) + min(x, 10)  # noqa: E731
    want = JUC.compile_udf(fn, [JE.BoundRef(0, jax_api().T.INT64, "c0")])
    least = want.children[1]
    assert type(least).__name__ == "Least"
    assert isinstance(least.children[0], list)
    api = torch_api()
    s = api.session(COMPILER_ON)
    vals = [-20, -3, 0, 4, 15, None]
    df = s.create_dataframe(pa.table({"a": pa.array(vals, pa.int64())}))
    e = api.udf(fn, return_type=api.T.INT64)(api.col("a"))
    assert not isinstance(e, PU.PythonRowUDF)
    got = df.select(e.alias("r")).collect().column("r").to_pylist()
    assert got == [None if v is None else fn(v) for v in vals]


ROW_TIER_CASES = {
    "poly": lambda x: x * x - 2 * x + 7,
    "collatz": lambda x: x if x % 2 == 0 else 3 * x + 1,
    "pow_abs": lambda x: abs(x) ** 0.5 if x > 0 else 0.0,
    "floor_ceil": lambda x: math.floor(x / 3.0) + math.ceil(x / 7.0),
}


@pytest.mark.parametrize("case", list(ROW_TIER_CASES))
def test_compiled_matches_jax_and_the_row_tier(case):
    fn = ROW_TIER_CASES[case]
    rng = np.random.default_rng(11)
    table = pa.table({"a": pa.array(rng.integers(-100, 100, 50)
                                    .astype(np.int64))})

    def compiled(api, df):
        e = api.udf(fn, return_type=api.T.FLOAT64)(api.col("a"))
        assert type(e).__name__ != "PythonRowUDF"
        return df.select(e.alias("c"))

    got, want = _run_both(compiled, table, COMPILER_ON)
    assert_tables_equal(got, want, approx_float=1e-12)
    api = torch_api()
    s = api.session()
    row = s.create_dataframe(table).select(PU.PythonRowUDF(
        fn, api.T.FLOAT64, [api.col("a")]).alias("c")).collect()
    for g, e in zip(got.column("c").to_pylist(),
                    row.column("c").to_pylist()):
        assert (g is None) == (e is None)
        if g is not None:
            assert abs(g - e) <= 1e-9 * max(1.0, abs(e)), (g, e)


PYSEM_TABLE = pa.table({
    "a": pa.array([-7, 7, -7, 7, 0, -1], pa.int64()),
    "b": pa.array([3, 3, -3, -3, 3, 2], pa.int64()),
    "s": pa.array(["ab", "héllo", None, "", "x", "yz"])})


def _pysem_query(api, df):
    T, col = api.T, api.col
    k = _closure()
    return df.select(
        api.udf(lambda x, y: x % y, return_type=T.INT64)(
            col("a"), col("b")).alias("m"),
        api.udf(lambda x, y: x // y, return_type=T.INT64)(
            col("a"), col("b")).alias("d"),
        api.udf(k, return_type=T.INT64)(col("a")).alias("k"),
        api.udf(lambda s: len(s), return_type=T.INT32)(
            col("s")).alias("n"))


@pytest.mark.parametrize("compiler", ["on", "off"])
def test_python_semantics_match_jax(compiler):
    """Python's % and //, a closure constant and len of strings give
    equal answers in both packages with the compiler on (device
    expressions) and off (the row tier)."""
    conf = COMPILER_ON if compiler == "on" else None
    table = PYSEM_TABLE
    if compiler == "off":
        # the row tier calls len(None): no null strings there
        table = table.set_column(2, "s", pa.array(
            ["ab", "héllo", "q", "", "x", "yz"]))
    got, want = _run_both(_pysem_query, table, conf)
    assert_tables_equal(got, want)
    av, bv = [-7, 7, -7, 7, 0, -1], [3, 3, -3, -3, 3, 2]
    d = got.to_pydict()
    assert d["m"] == [x % y for x, y in zip(av, bv)]
    assert d["d"] == [x // y for x, y in zip(av, bv)]
    assert d["k"] == [x + _K for x in av]
    # compiled: null-propagating device expressions
    assert d["n"] == ([2, 5, None, 0, 1, 2] if compiler == "on"
                      else [2, 5, 1, 0, 1, 2])
    api = torch_api()
    s = api.session(conf)
    s.create_dataframe(PYSEM_TABLE)  # activates the session conf
    e = api.udf(lambda x: x + 1, return_type=api.T.INT64)(api.col("a"))
    assert isinstance(e, PU.PythonRowUDF) == (compiler == "off")


# ---------------------------------------------------------------------------
# the columnar UDF
# ---------------------------------------------------------------------------

def _columnar_query(api, df):
    f = api.col_udf(H.qty_if_cheap, return_type=api.T.FLOAT64)
    return df.select(api.col("l_orderkey"),
                     f(api.col("l_quantity"), api.col("l_discount"))
                     .alias("v"))


@pytest.fixture(scope="module")
def lineitem():
    t = H.make_lineitem(3000)
    rng = np.random.default_rng(5)
    q = t.column("l_quantity").to_numpy()
    return t.set_column(3, "l_quantity", pa.array(
        q, mask=rng.random(len(q)) < 0.1))


def test_torch_udf_equals_jax_udf_on_both_backends(lineitem):
    got, want = _run_both(_columnar_query, lineitem, num_partitions=2)
    assert_tables_equal(got, want)
    vals = got.column("v")
    assert 0 < vals.null_count < len(vals)  # its own validity and nulls
    api = torch_api()
    s = api.session()
    df = _columnar_query(api, s.create_dataframe(lineitem))
    assert all(m.can_run_on_tpu for m in PO.wrap_and_tag(
        df.plan, s.conf).walk())
    # the CPU backend runs the same function on CPU tensors
    cpu = api.session({"spark.rapids.sql.mode": "explainOnly"})
    assert_tables_equal(_columnar_query(api, cpu.create_dataframe(
        lineitem)).collect(), got)


def test_torch_udf_result_off_the_device_raises():
    api = torch_api()
    s = api.session()
    df = s.create_dataframe(pa.table({"x": [1.0, 2.0]}))
    as_numpy = api.col_udf(lambda x: x[0].numpy(),
                           return_type=api.T.FLOAT64)
    with pytest.raises(TypeError, match="not a torch.Tensor"):
        df.select(as_numpy(api.col("x")).alias("y")).collect()
    # a tensor on another device than the batch's is never moved
    with pytest.raises(RuntimeError, match="the batch is on cuda"):
        PU._on_device(torch.zeros(2), torch.device("cuda"), "f", "values")


# ---------------------------------------------------------------------------
# the plan: a UDF's Project is never absorbed into the aggregate
# ---------------------------------------------------------------------------

def _grouped(kind):
    def build(api, df):
        col, F, T = api.col, api.F, api.T
        if kind == "row":
            f = api.udf(H.flag_tag, return_type=T.STRING)
            v = f(col("l_returnflag"), col("l_linestatus"))
        else:
            f = api.col_udf(H.qty_if_cheap, return_type=T.FLOAT64)
            v = f(col("l_quantity"), col("l_discount"))
        return (df.select(col("l_returnflag"), v.alias("u"))
                .group_by(col("l_returnflag"))
                .agg(F.count("u").alias("n")))
    return build


@pytest.mark.parametrize("kind", ["row", "columnar"])
def test_udf_project_stays_above_the_aggregate(kind, lineitem):
    for (api, s), prune in zip(_both(), (PP.prune_plan, JP.prune_plan)):
        df = _grouped(kind)(api, s.create_dataframe(lineitem))
        plan = prune(df.plan)
        assert type(plan).__name__ == "Aggregate"
        proj = plan.children[0]
        assert type(proj).__name__ == "Project"
        assert any(type(e).__name__.endswith("UDF") for ex in proj.exprs
                   for e in _walk(ex))
    got, want = _run_both(_grouped(kind), lineitem)
    assert_tables_equal(got, want, ignore_order=True)


def _walk(e):
    yield e
    for c in e.children:
        yield from _walk(c)


# ---------------------------------------------------------------------------
# the worker pool
# ---------------------------------------------------------------------------

def test_pool_runs_spawned_workers_without_jax():
    """One run through the session at parallelism 2 (20,000 rows, above
    the pool's 2 x 8192 threshold) equals the JAX package's in-process
    answer, and each spawned worker has loaded neither JAX nor the JAX
    package, nor initialised CUDA."""
    table = H.make_lineitem(20_000)
    try:
        pyworker.shutdown_pool()
        api = torch_api()
        s = api.session({"spark.rapids.sql.python.workerPool.parallelism":
                         "2"})
        got = H.udf_row_flags(api, s.create_dataframe(table)).collect()
        assert pyworker._POOL is not None and pyworker._POOL_SIZE == 2
        japi = jax_api()
        js = japi.session({"spark.rapids.sql.python.workerPool.enabled":
                           "false"})
        want = H.udf_row_flags(japi, js.create_dataframe(table)).collect()
        assert_tables_equal(got, want, ignore_order=True)
        env = pyworker.map_rows(H.worker_environment,
                                [(i,) for i in range(20_000)], 2)
        assert env is not None and set(env) == {(False, False)}
    finally:
        pyworker.shutdown_pool()
    assert pyworker._POOL is None
