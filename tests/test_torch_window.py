"""The port's window functions against the JAX package, on the CPU.

Three levels, each on the same seeded inputs through both packages:
- ``ops/window`` function by function on the same boundary flags: the
  segment layout, the rank family, ntile, the running and bounded
  sum/count, the segmented min/max scan and lead/lag;
- every window function and window aggregate through the DataFrame
  front door, on the packed route (integer order keys; rows in input
  order) and the general route (a float and an integer order key; rows
  in sorted order), under five frames, ascending and descending with
  nulls first and last, null partition and order keys, over a masked
  input; then the hash and collect exchanges below ``WindowExec``, two
  specs in one select, ``with_column``, ``distinct`` and
  ``drop_duplicates``;
- the smoke's window shapes (bench.py's q67win among them) whole, with
  the route each package takes.

Tolerances: counts, ranks, ntile, integer sums (mod 2^64), lead/lag,
first/last/nth values, min/max and percent_rank/cume_dist (integers and
one division) are exact. Float running and bounded sums and averages are
held to an absolute 1e-12 x sum(|x|) over the plane: both packages take
``cs - cs[start] + x[start]`` over one whole-plane cumsum, but XLA and
ATen cumsum in different orders, so the low bits differ. Over a float32
operand both cumsums run in float32, and the sums and averages are held
to 1e-6 x sum(|x|) (``F32_SUM_TOL``).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import (
    dedupe_orders, jax_api, make_lineitem, q67win, torch_api,
    win_global_top, win_rank_family, win_running, win_shuffled,
)

from spark_rapids_tpu.exec import fuse as JF
from spark_rapids_tpu.ops import window as JW

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.ops import window as W

SUM_TOL = 1e-12
#: float32 operands: both packages run the running sums' cumsum in
#: float32 over the whole plane, in different orders; 1e-6 x sum(|x|) is
#: eight float32 roundings (eps 1.2e-7) at the largest running sum, and
#: the two differ by at most 4e-9 x sum(|x|) here
F32_SUM_TOL = 1e-6


# ---------------------------------------------------------------------------
# ops/window, function by function
# ---------------------------------------------------------------------------

def _flags(n, seed, p_seg, p_peer):
    rng = np.random.default_rng(seed)
    segb = rng.random(n) < p_seg
    segb[0] = True
    peerb = segb | (rng.random(n) < p_peer)
    return segb, peerb


BOUNDARIES = {"random": (0.05, 0.3), "every_row": (1.0, 1.0),
              "one_segment": (0.0, 0.1)}


def _np(t):
    return np.asarray(t)


@pytest.fixture(params=list(BOUNDARIES), scope="module")
def layout(request):
    n = 4096
    segb, peerb = _flags(n, 3, *BOUNDARIES[request.param])
    j = JW.segment_layout(jnp.asarray(segb), jnp.asarray(peerb))
    p = W.segment_layout(torch.from_numpy(segb), torch.from_numpy(peerb))
    return segb, peerb, j, p


def test_segment_layout_and_rank_family_match_jax(layout):
    segb, peerb, j, p = layout
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    js, je, jps, _ = j
    ps, pe, pps, _ = p
    np.testing.assert_array_equal(W.row_number(ps).numpy(),
                                  _np(JW.row_number(js)))
    np.testing.assert_array_equal(W.rank(ps, pps).numpy(),
                                  _np(JW.rank(js, jps)))
    np.testing.assert_array_equal(
        W.dense_rank(torch.from_numpy(segb), torch.from_numpy(peerb),
                     ps).numpy(),
        _np(JW.dense_rank(jnp.asarray(segb), jnp.asarray(peerb), js)))
    for k in (1, 3, 7, 5000):
        np.testing.assert_array_equal(W.ntile(k, ps, pe).numpy(),
                                      _np(JW.ntile(k, js, je)))


def _values(n, kind, seed=4):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.8
    if kind == "int":
        return rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64), valid
    if kind == "i32":
        return rng.integers(-1000, 1000, n).astype(np.int32), valid
    if kind == "bool":
        return rng.random(n) < 0.5, valid
    x = rng.normal(0, 1e5, n)
    if kind == "f64_special":
        x = np.where(rng.random(n) < 0.05, np.nan, x)
        x = np.where(rng.random(n) < 0.03, np.inf, x)
        x = np.where(rng.random(n) < 0.03, -np.inf, x)
        x = np.where(rng.random(n) < 0.03, -0.0, x)
    return x, valid


#: the JAX package's functions, jitted: run eagerly, each primitive of an
#: associative scan compiles on its own
_J_RUNNING = jax.jit(JW.running_sum_count)
_J_BOUNDED = jax.jit(JW.bounded_sum_count, static_argnums=(4, 5))
_J_MINMAX = jax.jit(JW.running_minmax, static_argnums=(0,))
_J_LEAD_LAG = jax.jit(JW.lead_lag, static_argnums=(3,))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["int", "f64"])
def test_running_and_bounded_sums_match_jax(layout, kind):
    segb, _, j, p = layout
    n = segb.shape[0]
    x, valid = _values(n, kind)
    tol = SUM_TOL * np.abs(x[valid]).sum() if kind == "f64" else 0
    jx, jv, px, pv = jnp.asarray(x), jnp.asarray(valid), \
        torch.from_numpy(x), torch.from_numpy(valid)
    js, je, _, jpe = j
    ps, pe, _, ppe = p
    for jfe, pfe in ((je, pe), (jpe, ppe), (jnp.arange(n), torch.arange(n))):
        js_, jc = _J_RUNNING(jx, jv, js, jfe)
        ps_, pc = W.running_sum_count(px, pv, ps, pfe)
        _close(ps_.numpy(), _np(js_), tol)
        np.testing.assert_array_equal(pc.numpy(), _np(jc))
    # frames that are empty for some rows included: (2, 1), (-5, -3)
    for lo, hi in ((-2, 2), (None, 0), (0, None), (2, 1), (-5, -3),
                   (None, None), (1, None)):
        js_, jc = _J_BOUNDED(jx, jv, js, je, lo, hi)
        ps_, pc = W.bounded_sum_count(px, pv, ps, pe, lo, hi)
        _close(ps_.numpy(), _np(js_), tol)
        np.testing.assert_array_equal(pc.numpy(), _np(jc))


@pytest.mark.parametrize("kind", ["int", "i32", "bool", "f64_special"])
def test_running_minmax_matches_jax(layout, kind):
    segb, _, j, p = layout
    n = segb.shape[0]
    x, valid = _values(n, kind, seed=6)
    js, je, _, jpe = j
    ps, pe, _, ppe = p
    jid = jnp.cumsum(jnp.asarray(segb).astype(jnp.int32))
    for op in ("min", "max"):
        for jfe, pfe in ((je, pe), (jpe, ppe),
                         (jnp.arange(n), torch.arange(n))):
            jv, jc = _J_MINMAX(op, jnp.asarray(x), jnp.asarray(valid), jid,
                               js, jfe)
            pv, pc = W.running_minmax(op, torch.from_numpy(x),
                                      torch.from_numpy(valid), ps, pfe)
            np.testing.assert_array_equal(pc.numpy(), _np(jc))
            some = _np(jc) > 0  # the value is null where nothing counted
            np.testing.assert_array_equal(pv.numpy()[some], _np(jv)[some])


def test_lead_lag_matches_jax(layout):
    segb, _, _, _ = layout
    n = segb.shape[0]
    x, valid = _values(n, "f64", seed=8)
    jid = jnp.cumsum(jnp.asarray(segb).astype(jnp.int32))
    pid = torch.cumsum(torch.from_numpy(segb).to(torch.int32), 0)
    for off in (1, -1, 3, -3, 0):
        jv, jok = _J_LEAD_LAG(jnp.asarray(x), jnp.asarray(valid), jid, off)
        pv, pok = W.lead_lag(torch.from_numpy(x), torch.from_numpy(valid),
                             pid, off)
        np.testing.assert_array_equal(pok.numpy(), _np(jok))
        np.testing.assert_array_equal(pv.numpy(), _np(jv))


# ---------------------------------------------------------------------------
# every window function through the front door
# ---------------------------------------------------------------------------

def _table(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    of = np.round(rng.normal(0, 5, n), 1)
    of = np.where(rng.random(n) < 0.03, np.nan, of)
    of = np.where(rng.random(n) < 0.03, -0.0, of)
    return pa.table({
        "p": pa.array(rng.integers(0, 12, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "o": pa.array(rng.integers(-20, 40, n).astype(np.int32),
                      mask=rng.random(n) < 0.08),
        "of": pa.array(of, mask=rng.random(n) < 0.05),
        "x": pa.array(rng.normal(0, 100, n), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "xs": pa.array(rng.choice([1.5, -2.0, np.nan, np.inf, -np.inf, 0.0,
                                   7.0], n), mask=rng.random(n) < 0.1),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "keep": rng.random(n) < 0.85,
        "x32": pa.array(rng.normal(0, 100, n).astype(np.float32),
                        mask=rng.random(n) < 0.1),
    })


#: frame name -> rows_between bounds (None: the spec's default frame)
FRAMES = {"default_range": None, "unbounded_rows": (None, None),
          "rows_m2_p2": (-2, 2), "rows_to_current": (None, 0),
          "rows_from_current": (0, None)}
#: (ascending, nulls_first) variants; each frame takes one
ORDERS = [(True, None), (False, None), (True, False), (False, True)]
#: the frames min/max and first/last/nth support on the device
EXTREMA_FRAMES = {"default_range", "unbounded_rows", "rows_to_current"}


def _order(api, name, asc, nulls_first):
    c = api.col(name)
    if nulls_first is None:
        return c.asc() if asc else c.desc()
    if asc:
        return c.asc_nulls_first() if nulls_first else c.asc_nulls_last()
    return c.desc_nulls_first() if nulls_first else c.desc_nulls_last()


def _window_query(api, df, route, frame, variant):
    col, F = api.col, api.F
    asc, nf = ORDERS[variant]
    keys = ["o"] if route == "packed" else ["of", "o"]
    w = api.Window.partition_by(col("p")).order_by(
        *[_order(api, k, asc, nf) for k in keys])
    if FRAMES[frame] is not None:
        w = w.rows_between(*FRAMES[frame])
    fns = {"sum_x": F.sum(col("x")), "sum_i": F.sum(col("i")),
           "cnt_x": F.count(col("x")), "cnt": F.count(),
           "avg_x": F.avg(col("x")), "avg_i": F.avg(col("i")),
           "sum_x32": F.sum(col("x32")), "avg_x32": F.avg(col("x32"))}
    if frame == "default_range":
        # the rank family and lead/lag read no frame
        fns.update({
            "rn": F.row_number(), "rk": F.rank(), "drk": F.dense_rank(),
            "nt": F.ntile(4), "pr": F.percent_rank(), "cd": F.cume_dist(),
            "ld_x": F.lead(col("x")), "lg_i2": F.lag(col("i"), 2),
            "ld_i3": F.lead(col("i"), 3, 0),
            "lg_x": F.lag(col("x"), 1, -1.0)})
    if frame in EXTREMA_FRAMES:
        fns.update({
            "min_x": F.min(col("x")), "max_x": F.max(col("x")),
            "min_i": F.min(col("i")), "max_i": F.max(col("i")),
            "min_xs": F.min(col("xs")), "max_xs": F.max(col("xs")),
            "min_b": F.min(col("b")), "max_b": F.max(col("b")),
            "first_x": F.first_value(col("x")),
            "last_i": F.last_value(col("i")),
            "nth_x2": F.nth_value(col("x"), 2),
            "nth_i3": F.nth_value(col("i"), 3)})
    return df.filter(col("keep")).select(
        col("p"), col("o"), col("of"), col("x"), col("i"),
        *[f.over(w).alias(name) for name, f in fns.items()])


def _assert_window_equal(got: pa.Table, want: pa.Table, tol: float,
                         summed=None, tol32=None):
    """Row for row in order; the float sum and average columns (by
    default those named sum_* and avg_*) to tol, those of float32
    operands (named *_x32) to tol32, the rest exactly (NaN equal to
    NaN)."""
    assert got.schema.names == want.schema.names
    assert got.num_rows == want.num_rows
    for name in want.schema.names:
        g, w_ = got[name].to_pylist(), want[name].to_pylist()
        is_sum = name in summed if summed is not None \
            else name.startswith(("sum_", "avg_"))
        if not is_sum:
            assert all(a == b or (isinstance(a, float) and isinstance(b, float)
                                  and math.isnan(a) and math.isnan(b))
                       for a, b in zip(g, w_)), name
            continue
        bound = tol32 if name.endswith("_x32") else tol
        for a, b in zip(g, w_):
            assert (a is None) == (b is None), name
            if a is not None:
                assert abs(a - b) <= bound, (name, a, b)


def _routes(monkeypatch):
    """Spies on the route each package's WindowExec takes."""
    port = {"packed": [], "general": []}
    for r in port:
        orig = getattr(X.WindowExec, f"_{r}")

        def spy(self, *a, _o=orig, _r=r, **k):
            port[_r].append(1)
            return _o(self, *a, **k)
        monkeypatch.setattr(X.WindowExec, f"_{r}", spy)
    jax_keys = []
    orig_fused = JF.fused

    def fused(key, builder):
        if isinstance(key, tuple) and str(key[0]).startswith("window"):
            jax_keys.append(key[0])
        return orig_fused(key, builder)
    monkeypatch.setattr(JF, "fused", fused)

    def taken():
        p = sorted(r for r, hits in port.items() if hits)
        j = sorted({"general" if k == "window" else "packed"
                    for k in jax_keys})
        return p, j
    return taken


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("route", ["packed", "general"])
def test_window_functions_match_jax(route, frame, monkeypatch):
    t = _table()
    x = np.asarray(t["x"].to_numpy(zero_copy_only=False))
    i = np.asarray(t["i"].to_numpy(zero_copy_only=False))
    x32 = np.asarray(t["x32"].to_numpy(zero_copy_only=False), np.float64)
    tol = SUM_TOL * max(np.nansum(np.abs(x)), np.nansum(np.abs(i)))
    taken = _routes(monkeypatch)
    variant = list(FRAMES).index(frame) % len(ORDERS)
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(t)
        out.append(_window_query(api, df, route, frame, variant).collect())
    _assert_window_equal(out[0], out[1], tol,
                         tol32=F32_SUM_TOL * np.nansum(np.abs(x32)))
    assert taken() == ([route], [route])


@pytest.mark.parametrize("case", ["hash_exchange", "collect_exchange"])
def test_window_over_partitions_matches_jax(case):
    t = _table(seed=9)
    out = []
    for api in (torch_api(), jax_api()):
        col, F = api.col, api.F
        s = api.session()
        df = s.create_dataframe(t, num_partitions=4)
        if case == "hash_exchange":
            w = api.Window.partition_by(col("p")).order_by(col("o"))
        else:
            w = api.Window.order_by(col("of"), col("o").desc())
        out.append((s, df.select(col("p"), col("o"), col("of"), col("x"),
                                 F.rank().over(w).alias("rk"),
                                 F.sum(col("i")).over(w).alias("si"))
                    .collect()))
    (ps, got), (_, want) = out
    assert_tables_equal(got, want, ignore_order=True)
    names = {type(e).__name__ for e in ps.last_exec.walk()}
    assert {"WindowExec", "ShuffleExchangeExec" if case == "hash_exchange"
            else "CollectExchangeExec"} <= names


def test_two_specs_with_column_distinct_and_drop_duplicates():
    t = _table(seed=10)
    out = []
    for api in (torch_api(), jax_api()):
        col, F = api.col, api.F
        df = api.session().create_dataframe(t)
        w1 = api.Window.partition_by(col("p")).order_by(col("o"))
        w2 = api.Window.partition_by(col("b")).order_by(col("i").desc())
        two = df.select(col("p"), col("o"), col("i"),
                        F.row_number().over(w1).alias("r1"),
                        (F.dense_rank().over(w2) * 10).alias("r2"),
                        F.max(col("x")).over(w1))
        withc = df.with_column("x", F.sum(col("x")).over(w1))
        out.append((two, withc.collect(), df.select("p", "b").distinct()
                    .collect(), df.drop_duplicates(["p", "b"]).collect(),
                    df.dropDuplicates().count()))
    (ptwo, *got), (jtwo, *want) = out
    windows = [n for n in _walk_plan(ptwo.plan)
               if type(n).__name__ == "WindowNode"]
    assert len(windows) == 2
    # a bare window aggregate is named after its function, as in JAX
    assert ptwo.columns == jtwo.columns \
        == ["p", "o", "i", "r1", "r2", "windowagg"]
    assert_tables_equal(ptwo.collect(), jtwo.collect(), ignore_order=True)
    x = np.asarray(t["x"].to_numpy(zero_copy_only=False))
    _assert_window_equal(got[0], want[0], SUM_TOL * np.nansum(np.abs(x)),
                         summed={"x"})
    assert_tables_equal(got[1], want[1], ignore_order=True)
    # one whole row per (p, b), whichever row each package keeps
    assert got[2].num_rows == want[2].num_rows == got[1].num_rows
    assert got[2].schema == t.schema
    assert got[3] == want[3] == t.num_rows


def _walk_plan(node):
    yield node
    for c in node.children:
        yield from _walk_plan(c)


# ---------------------------------------------------------------------------
# the smoke's window shapes, whole
# ---------------------------------------------------------------------------

#: shape -> (partitions of the cache, route both packages take)
SHAPES = {"q67win": (q67win, 1, "packed"),
          "win_rank_family": (win_rank_family, 1, "packed"),
          "win_running": (win_running, 1, "general"),
          "win_shuffled": (win_shuffled, 4, "packed"),
          "win_global_top": (win_global_top, 4, "general"),
          "dedupe_orders": (dedupe_orders, 1, "packed")}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_smoke_window_shapes_match_jax(shape, monkeypatch):
    query, parts, route = SHAPES[shape]
    li = make_lineitem(20_000)
    taken = _routes(monkeypatch)
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(li, num_partitions=parts).cache()
        out.append(query(api, df).collect())
    assert_tables_equal(out[0], out[1], ignore_order=True, approx_float=1e-9)
    assert out[0].num_rows > 0
    assert taken() == ([route], [route])


def test_drop_duplicates_keeps_one_row_per_key():
    li = make_lineitem(20_000)
    P = torch_api()
    got = dedupe_orders(P, P.session().create_dataframe(li).cache()).collect()
    assert got.num_rows == len(set(li["l_orderkey"].to_pylist()))
    assert sorted(got["l_orderkey"].to_pylist()) \
        == sorted(set(li["l_orderkey"].to_pylist()))
    # each kept row is a whole input row
    rows = set(map(tuple, li.to_pandas().itertuples(index=False)))
    assert all(tuple(r.values()) in rows for r in got.to_pylist())


# ---------------------------------------------------------------------------
# what the JAX package runs on the CPU runs there in the port too
# ---------------------------------------------------------------------------

FALLBACKS = {
    "string_order": lambda P, w: P.F.rank().over(w.order_by(P.col("s"))),
    "string_operand": lambda P, w: P.F.lag(P.col("s")).over(
        w.order_by(P.col("o"), P.col("s"))),
    "bounded_min": lambda P, w: P.F.min(P.col("x")).over(
        w.order_by(P.col("o")).rows_between(-1, 1)),
    "other_aggregate": lambda P, w: P.F.variance(P.col("x")).over(
        w.order_by(P.col("o"))),
    "nth_value_frame": lambda P, w: P.F.nth_value(P.col("x"), 2).over(
        w.order_by(P.col("o")).rows_between(-1, 0)),
}
REASONS = {"string_order": "ORDER BY on strings",
           "string_operand": "string-typed window operands",
           "bounded_min": "bounded-rows min/max",
           "other_aggregate": "VarianceSamp not supported",
           "nth_value_frame": "NthValue supports only"}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_cpu_fallbacks_raise_with_the_jax_reason(case):
    t = _table(n=200).append_column(
        "s", pa.array([f"s{k % 7}" for k in range(200)]))
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        w = api.Window.partition_by(api.col("p"))
        out.append(s.create_dataframe(t).select(
            api.col("p"), api.col("o"), api.col("x"),
            FALLBACKS[case](api, w).alias("v")).collect())
        if not out[1:]:
            assert [type(e.plan).__name__ for e in s.last_exec.walk()
                    if type(e).__name__ == "CpuFallbackExec"] \
                == ["WindowNode"]
            assert REASONS[case] in s.last_meta.explain()
    assert_tables_equal(out[0], out[1], ignore_order=True)


def test_ordered_function_without_order_by_is_an_error():
    P = torch_api()
    df = P.session().create_dataframe(_table(n=100))
    with pytest.raises(ValueError, match="requires the window to be ordered"):
        df.select(P.F.rank().over(P.Window.partition_by(P.col("p"))))
    # an aggregate needs no order: the whole partition
    got = df.select(P.col("p"), P.F.sum(P.col("i")).over(
        P.Window.partition_by(P.col("p"))).alias("t")).collect()
    want = {}
    for p, i in zip(_table(n=100)["p"].to_pylist(),
                    _table(n=100)["i"].to_pylist()):
        if i is not None:
            want[p] = want.get(p, 0) + i
    assert all(t == want.get(p) for p, t in zip(got["p"].to_pylist(),
                                                 got["t"].to_pylist()))
