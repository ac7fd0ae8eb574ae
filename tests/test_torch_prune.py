"""Column pruning (``plan/prune.py``) and the static cost pass
(``plan/cost.py``) of the port against the JAX package, on the CPU.

- The cases of ``tests/test_prune.py`` on both packages: the pruned plans
  have the same node types and schemas, and the results are equal.
- The smoke's q72shfl, q3join and stats_by_order shapes: the pruned plan
  is the JAX package's (the Project absorbed into the aggregate, the
  join's inputs cut to the columns used), and the port's aggregate takes
  the route the JAX package's takes (one device on both sides: the JAX
  package sees the tests' eight virtual devices otherwise).
- Pruning a plan twice, or a subtree shared by two DataFrames or held by
  a cached relation, changes no answer.
- With spark.rapids.sql.optimizer.enabled the placement report, reasons
  and all, is the JAX package's on three plans, one of which reverts.

Tolerances: keys, counts and every row result are exact; float sums of
the aggregate routes are exact too (both packages sum integer digits and
limbs), but the moments of stats_by_order, relative 1e-12 (the tolerance
of ``tests/test_torch_aggregates.py``).
"""
import jax
import numpy as np
import pyarrow as pa
import pytest

import torch_port_helpers as H
from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.exec import fuse as JFUSE
from spark_rapids_tpu.exec import tpu_nodes as JX
from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu.plan import prune as JP

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan import prune as PP


@pytest.fixture(scope="module")
def tables():
    lineitem, orders = H.make_tables(20_000)
    return lineitem, orders


@pytest.fixture
def one_device(monkeypatch):
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])


def _shape(plan):
    """The plan as nested (node type, [(column, type)], children)."""
    return (type(plan).__name__,
            [(f.name, type(f.dtype).__name__) for f in plan.schema.fields],
            [_shape(c) for c in plan.children])


def _both(build):
    """[(port DataFrame, port prune), (JAX DataFrame, JAX prune)]."""
    return [(build(api, api.session()), prune)
            for api, prune in ((torch_api(), PP.prune_plan),
                               (jax_api(), JP.prune_plan))]


# ---------------------------------------------------------------------------
# tests/test_prune.py's cases on both packages
# ---------------------------------------------------------------------------

def _join_case(api, s):
    c = api.col
    left = s.create_dataframe({"k": [1, 2, 3, 4], "a": [10, 20, 30, 40],
                               "b": [1.0, 2.0, 3.0, 4.0],
                               "unused1": [0, 0, 0, 0]})
    right = s.create_dataframe({"rk": [2, 3, 5], "c": [200, 300, 500],
                                "unused2": [9, 9, 9]})
    return left.join(right, on=[(c("k"), c("rk"))], how="inner").select(
        c("k"), c("c"))


def _join_condition_case(api, s):
    c = api.col
    left = s.create_dataframe({"k": [1, 1, 2], "x": [5, 6, 7],
                               "dead": [0, 0, 0]})
    right = s.create_dataframe({"rk": [1, 2], "y": [5, 9], "dead2": [1, 1]})
    return left.join(right, on=(c("k") == c("rk")) & (c("x") > c("y")),
                     how="inner").select(c("k"), c("x"), c("y"))


def _window_case(api, s):
    c = api.col
    df = s.create_dataframe(pa.table({
        "g": pa.array([1, 1, 2, 2, 2], type=pa.int64()),
        "o": pa.array([3, 1, 2, 5, 4], type=pa.int64()),
        "v": pa.array([1.0, 2.0, 3.0, 4.0, 5.0]),
        "unused": pa.array([0, 0, 0, 0, 0], type=pa.int64())}))
    w = api.Window.partition_by(c("g")).order_by(c("o"))
    return df.select(c("g"), api.F.rank().over(w).alias("rk"))


PRUNE_CASES = {"join": _join_case, "join_condition": _join_condition_case,
               "window": _window_case}


@pytest.mark.parametrize("case", list(PRUNE_CASES))
def test_prune_cases_match_jax(case):
    (port, pp), (ref, jp) = _both(PRUNE_CASES[case])
    got_plan, want_plan = pp(port.plan), jp(ref.plan)
    assert _shape(got_plan) == _shape(want_plan)
    # the pass moved something: the join's or window's input is cut
    assert _shape(got_plan) != _shape(port.plan) or case == "join_condition"
    assert_tables_equal(port.collect(), ref.collect(), ignore_order=True)


# ---------------------------------------------------------------------------
# the smoke's shapes: plan and route
# ---------------------------------------------------------------------------

#: route -> (the port's _AggKernels method, the JAX package's)
ROUTE_PAIRS = {"segsum": ("_segsum_or_fallback", "_pallas_seg_agg"),
               "chunked_segsum": ("_chunked_segsum_agg",
                                  "_chunked_pallas_agg"),
               "scatter": ("_scatter_agg", "_bucket_scatter_agg_xla")}

SHAPES = {
    "q72shfl": (lambda a, li, od: H.q72shfl(a, li), ["k"], None),
    "q3join": (lambda a, li, od: H.q3join(a, li, od), None, None),
    "stats_by_order": (lambda a, li, od: H.stats_by_order(a, li), ["k"],
                       1e-12),
}


def _taken(hits):
    """The routes entered, less the scatter fallback of a segsum route:
    XLA traces both branches of the JAX package's fallback cond, so its
    spy sees the scatter route whether it runs or not."""
    if hits & {"segsum", "chunked_segsum"}:
        return hits - {"scatter"}
    return hits


def _routes(monkeypatch):
    hits = {"port": set(), "jax": set()}
    for route, (mine, theirs) in ROUTE_PAIRS.items():
        for side, cls, name in (("port", X._AggKernels, mine),
                                ("jax", JX._AggKernels, theirs)):
            orig = getattr(cls, name)

            def spy(*a, _side=side, _route=route, _orig=orig, **k):
                hits[_side].add(_route)
                return _orig(*a, **k)
            monkeypatch.setattr(cls, name, spy)
    return hits


def _agg_node(plan):
    while type(plan).__name__ != "Aggregate":
        plan = plan.children[0]
    return plan


@pytest.mark.parametrize("shape", list(SHAPES))
def test_smoke_shapes_prune_and_route_like_jax(shape, tables, one_device,
                                               monkeypatch):
    build, keys, approx = SHAPES[shape]
    li, od = tables
    (port, pp), (ref, jp) = _both(lambda api, s: build(
        api, s.create_dataframe(li).cache(), s.create_dataframe(od)))
    got_plan, want_plan = pp(port.plan), jp(ref.plan)
    assert _shape(got_plan) == _shape(want_plan)
    agg = _agg_node(got_plan)
    # the projection under the aggregate is absorbed
    assert type(agg.children[0]).__name__ != "Project"
    if shape == "q3join":
        join = agg.children[0]
        assert type(join).__name__ == "Join"
        assert [len(c.schema.fields) for c in join.children] == [3, 1]
    hits = _routes(monkeypatch)
    # the JAX package's routes show when its kernels are traced: drop the
    # fused kernels an earlier test of this process compiled
    JFUSE.clear_cache()
    got, want = port.collect(), ref.collect()
    assert _taken(hits["port"]) == _taken(hits["jax"]) and hits["port"]
    if approx is None:
        assert_tables_equal(got, want, ignore_order=keys is not None)
    else:
        assert_tables_equal(got, want, ignore_order=True,
                            approx_float=approx)


def test_pruning_twice_and_shared_subtrees_keep_answers(tables):
    li, od = tables
    out = []
    for api in (torch_api(), jax_api()):
        c, F = api.col, api.F
        s = api.session()
        # the JAX package's cache scan holds a lock that a cache nested in
        # another one waits on: only the outer relation is cached here
        lic, odf = s.create_dataframe(li), s.create_dataframe(od)
        j, rev = H._q3_joined(api, lic, odf)
        base = j.select(c("l_orderkey"), c("o_orderdate"), rev)
        by_key = base.group_by(c("l_orderkey")).agg(F.sum("rev").alias("r"))
        by_date = base.group_by(c("o_orderdate")).agg(F.count().alias("n"))
        held = base.cache()
        on_cache = held.group_by(c("o_orderdate")).agg(
            F.sum("rev").alias("r"))
        runs = [by_key.collect(), by_date.collect(), by_key.collect(),
                on_cache.collect(), on_cache.collect(), by_date.collect()]
        assert runs[0].equals(runs[2]) and runs[1].equals(runs[5])
        assert runs[3].equals(runs[4])
        out.append(runs)
    for got, want in zip(*out):
        assert_tables_equal(got, want, ignore_order=True)


# ---------------------------------------------------------------------------
# the static cost pass
# ---------------------------------------------------------------------------

def _tiny(api, s):
    c = api.col
    return s.create_dataframe({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}) \
        .filter(c("k") > api.lit(1)).select(c("k"), (c("v") * 2).alias("w"))


def _wide(api, s, n=200_000):
    c = api.col
    t = pa.table({"k": np.arange(n) % 97, "v": np.arange(n) * 0.5})
    return s.create_dataframe(t).filter(c("k") > api.lit(3)).select(
        c("k"), (c("v") + 1.0).alias("w"))


def _join_small_build(api, s):
    c, F = api.col, api.F
    dim = s.create_dataframe({"k": list(range(50)),
                              "tag": [j % 3 for j in range(50)]})
    return _wide(api, s).join(dim, on=[(c("k"), c("k"))]).group_by(
        c("tag")).agg(F.sum(c("w")).alias("s"))


COST_PLANS = {"reverts": (_tiny, True), "stays": (_wide, False),
              "build_side_reverts": (_join_small_build, True)}
OPT_ON = {"spark.rapids.sql.optimizer.enabled": "true"}


@pytest.mark.parametrize("plan", list(COST_PLANS))
def test_cost_pass_reports_like_jax(plan):
    build, reverts = COST_PLANS[plan]
    reports = []
    for api, ov in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session(OPT_ON)
        df = build(api, s)
        reports.append(ov.explain_plan(df.plan, s.conf, all_ops=True)
                       .replace("TPU", "GPU"))
        off = ov.explain_plan(df.plan, api.session().conf, all_ops=True)
        assert "cost model" not in off
    assert reports[0] == reports[1]
    assert ("cost model: est." in reports[0]) == reverts
    if plan == "reverts":
        api = torch_api()
        s = api.session(OPT_ON)
        got = _tiny(api, s).collect()
        assert [type(m.plan).__name__ for m in s.last_meta.walk()
                if m.reasons] == ["Project", "Filter", "InMemorySource"]
        want = _tiny(jax_api(), jax_api().session()).collect()
        assert_tables_equal(got, want)
        assert isinstance(s.last_exec, X.CpuFallbackExec)


def test_port_caches_nest(tables):
    # a cached relation over a cached relation materializes the inner one
    # under the outer one's lock, which is reentrant in the port
    li, od = tables
    api = torch_api()
    c, F = api.col, api.F
    s = api.session()
    j, rev = H._q3_joined(api, s.create_dataframe(li).cache(),
                          s.create_dataframe(od).cache())
    held = j.select(c("o_orderdate"), rev).cache()
    got = held.group_by(c("o_orderdate")).agg(F.sum("rev").alias("rev"))
    want = H.q3_revenue_by_date(api, s.create_dataframe(li),
                                s.create_dataframe(od)).select(
        c("o_orderdate"), c("rev"))
    assert_tables_equal(got.collect(), want.collect(), ignore_order=True)
