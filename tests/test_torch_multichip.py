"""Multi-device execution of the port (``parallel/``, ``exec/sharded.py``,
the ICI exchange, the multi-device aggregate plan) against the JAX
package's, on the CPU.

The 14 programs of ``tests/test_multichip.py`` run through both packages:
the JAX package over the suite's 8 virtual CPU devices (conftest), the
port under ``virtual_devices(8)``, which repeats the one ``cpu`` device
eight times, so both plan for the same 8-device mesh. Checked: equal
Arrow answers (integers exact, f64 sums relative 1e-12), equal plan
shapes (``ShardedStageExec`` placement, fallback reasons, aggregate
modes), the ICI metric, the seeded shard skew, the mesh fingerprint's
cache isolation and the failure paths under the port's rule (only a
failed build falls back; an OOM retries the wave; a cancellation
propagates). Then numpy-seeded cases of each ``parallel`` function
against the JAX function run in ``shard_map`` over the 8 devices.
"""
import numpy as np
import pyarrow as pa
import pytest

import jax
import jax.numpy as jnp

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.parallel import mesh as JMESH

import torch

from spark_rapids_tpu_torch import config as PC
from spark_rapids_tpu_torch.parallel import mesh as MESH

F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def eight_devices():
    with MESH.virtual_devices(8):
        yield


def _sorted(tbl):
    return tbl.sort_by([(c, "ascending") for c in tbl.column_names])


def _data(rows=4000):
    # v carries nulls so the sharded path exercises masked planes
    return {"g": [i % 23 for i in range(rows)],
            "v": [i if i % 7 else None for i in range(rows)],
            "d": [float(i % 13) * 0.5 for i in range(rows)]}


def _narrow(api, s, data):
    col, lit = api.col, api.lit
    return (s.create_dataframe(data, num_partitions=8)
            .filter(col("v") % lit(5) != lit(0))
            .select(col("g"), (col("v") * lit(3)).alias("v3"),
                    (col("d") * lit(2.0)).alias("d2")))


def _both(conf):
    """(port session, JAX session) under one conf."""
    return torch_api().session(dict(conf)), jax_api().session(dict(conf))


def _jax_tree(s):
    return s._last_exec.tree_string()


def _port_tree(s):
    return s.last_exec.tree_string()


def _nodes(root):
    """Every operator of a tree (either package), children first
    visited in order."""
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(list(getattr(n, "children", []))))
    return out


def _plan_shape(root):
    """(class, aggregate mode, fused members) of every operator, top
    down: ShardedStageExec's placement, the aggregate modes."""
    return [(type(n).__name__, getattr(n, "mode", None),
             tuple(type(m).__name__ for m in getattr(n, "members", ())))
            for n in _nodes(root)]


# -- mesh construction / validation -----------------------------------------

def test_make_mesh_validates_axis_names():
    for bad in ((), ("part", "part"), ("part", 7)):
        with pytest.raises(ValueError):
            JMESH.make_mesh(1, axis_names=bad)
        with pytest.raises(ValueError):
            MESH.make_mesh(1, axis_names=bad)


def test_make_mesh_rejects_oversubscription_and_bad_dp():
    assert len(MESH.mesh_devices()) == len(jax.devices()) == 8
    for mod in (JMESH, MESH):
        with pytest.raises(ValueError):
            mod.make_mesh(9)
        with pytest.raises(ValueError):
            mod.make_mesh(4, dp=3)
        with pytest.raises(ValueError):
            mod.make_mesh(4, dp=2, axis_names=("part",))
    assert MESH.make_mesh(8, dp=2).shape == {"dp": 2, "part": 4}
    assert dict(JMESH.make_mesh(8, dp=2).shape) == {"dp": 2, "part": 4}


def test_virtual_devices_repeat_the_platform_and_restore():
    assert MESH.mesh_devices() == [torch.device("cpu")] * 8
    with MESH.virtual_devices(3):
        assert len(MESH.mesh_devices()) == 3
    assert len(MESH.mesh_devices()) == 8
    with pytest.raises(ValueError):
        with MESH.virtual_devices(0):
            pass


def test_check_mesh_devices_raises_typed_error_on_stale():
    mesh = MESH.make_mesh(2, axis_names=(MESH.PART_AXIS,))
    MESH.check_mesh_devices(mesh)  # a live mesh passes
    # a card index past what the process sees is stale
    stale = MESH.Mesh(np.array([torch.device("cpu"),
                                torch.device("cuda", 64)], dtype=object),
                      (MESH.PART_AXIS,))
    with pytest.raises(MESH.MeshDeviceError):
        MESH.check_mesh_devices(stale)


def test_multichip_devices_clamps():
    for devices, want in ((None, 8), (10_000, 8), (2, 2)):
        conf = {"spark.rapids.sql.multichip.enabled": "true"}
        if devices is not None:
            conf["spark.rapids.sql.multichip.devices"] = str(devices)
        port, ref = _both(conf)
        assert MESH.multichip_devices(port.conf) == want
        assert JMESH.multichip_devices(ref.conf) == want


# -- stage-cache fingerprint isolation --------------------------------------

def test_compile_fingerprint_isolates_mesh_shape():
    from spark_rapids_tpu.runtime.compile_cache import _fp_of as jfp
    from spark_rapids_tpu_torch.runtime.compile_cache import _fp_of as pfp
    for fp_of, api in ((pfp, torch_api()), (jfp, jax_api())):
        off = api.session({}).conf
        on2 = api.session({"spark.rapids.sql.multichip.enabled": "true",
                           "spark.rapids.sql.multichip.devices": "2"}).conf
        on8 = api.session({"spark.rapids.sql.multichip.enabled": "true",
                           "spark.rapids.sql.multichip.devices": "8"}).conf
        assert fp_of(on2) != fp_of(on8)
        assert not any("mesh" in str(part) for part in fp_of(off))
        assert fp_of(off) != fp_of(on8)
    assert pfp(on8) == jfp(jax_api().session(
        {"spark.rapids.sql.multichip.enabled": "true",
         "spark.rapids.sql.multichip.devices": "8"}).conf)


def test_conf_set_refingerprints():
    from spark_rapids_tpu_torch.runtime.compile_cache import _fp_of
    conf = torch_api().session({}).conf
    before = _fp_of(conf)
    conf.set("spark.rapids.sql.multichip.enabled", "true")
    assert _fp_of(conf) == before + ("mesh", MESH.PART_AXIS, 8)


# -- planner eligibility ----------------------------------------------------

def test_planner_shards_narrow_chain():
    port, ref = _both({"spark.rapids.sql.multichip.enabled": "true"})
    got = _narrow(torch_api(), port, _data(2000)).collect()
    want = _narrow(jax_api(), ref, _data(2000)).collect()
    assert got.num_rows > 0
    assert_tables_equal(got, want, ignore_order=True)
    assert "ShardedStageExec" in _port_tree(port)
    assert _plan_shape(port.last_exec) == _plan_shape(ref._last_exec)
    for s in (port, ref):
        snaps = s.last_metrics()
        assert sum(v.get("shardWaves", 0) for v in snaps.values()) >= 1


def test_fallback_reasons_cover_wide_types_and_carry():
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.exec import sharded as JSH
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exec import sharded as PSH

    def nodes(T):
        class _Field:
            def __init__(self, name, dtype):
                self.name, self.dtype = name, dtype

        class _Schema:
            def __init__(self, fields):
                self.fields = fields

        class _Body:
            has_carry = False
            exhausts = False
            name = "project"
            key = ("stage",)

        class _CarryBody(_Body):
            has_carry = True
            name = "limit"

        def node(body, dtype):
            return type("N", (), {
                "bodies": [body()], "members": [],
                "children": [type("C", (), {"schema": _Schema(
                    [_Field("s", dtype)])})()]})()
        return (node(_Body, T.StringType()), node(_CarryBody, T.Int64Type()),
                node(_Body, T.Int64Type()))

    for SH, T in ((PSH, PT), (JSH, JT)):
        wide, carry, ok = nodes(T)
        assert "StringType" in SH._fallback_reason(wide)
        assert "loop state" in SH._fallback_reason(carry)
        assert SH._fallback_reason(ok) is None
    pw, pc, _ = nodes(PT)
    jw, jc, _ = nodes(JT)
    assert PSH._fallback_reason(pw) == JSH._fallback_reason(jw)
    assert PSH._fallback_reason(pc) == JSH._fallback_reason(jc)


def test_limit_stage_records_its_fallback_reason():
    conf = {"spark.rapids.sql.multichip.enabled": "true"}
    reasons = []
    for api in (torch_api(), jax_api()):
        s = api.session(conf)
        col, lit = api.col, api.lit
        df = (s.create_dataframe(_data(2000), num_partitions=8)
              .filter(col("v") > lit(10))
              .select(col("g"), (col("v") + lit(1)).alias("v1"))
              .limit(50))
        assert df.collect().num_rows == 50
        root = s.last_exec if hasattr(s, "last_exec") else s._last_exec
        reasons.append(sorted(
            getattr(n, "_shard_fallback_reason", None) or ""
            for n in _nodes(root)))
    assert reasons[0] == reasons[1]


# -- parity: sharded against one-device and against the JAX package --------

@pytest.mark.parametrize("ansi", ["false", "true"])
def test_sharded_parity_masked_and_ansi(ansi):
    data = _data(3000)
    outs = {}
    for flag in ("true", "false"):
        port, ref = _both({"spark.rapids.sql.multichip.enabled": flag,
                           "spark.sql.ansi.enabled": ansi})
        outs[flag] = _sorted(_narrow(torch_api(), port, data).collect())
        want = _sorted(_narrow(jax_api(), ref, data).collect())
        assert_tables_equal(outs[flag], want)
        engaged = "ShardedStageExec" in _port_tree(port)
        assert engaged == (flag == "true")
        assert engaged == ("ShardedStageExec" in _jax_tree(ref))
    assert outs["true"].equals(outs["false"])


def test_shuffle_agg_parity_and_ici_metric():
    data = _data(3000)
    outs = {}
    for flag in ("true", "false"):
        port, ref = _both({"spark.rapids.sql.multichip.enabled": flag})
        got = []
        for api, s in ((torch_api(), port), (jax_api(), ref)):
            F, col = api.F, api.col
            df = (s.create_dataframe(data, num_partitions=8)
                  .group_by(col("g")).agg(F.sum("v").alias("sv"),
                                          F.count().alias("n")))
            got.append(_sorted(df.collect()))
            ici = sum(v.get("iciExchangeTime", 0)
                      for v in s.last_metrics().values())
            assert (ici > 0) == (flag == "true")
        assert got[0].equals(got[1])
        # the multi-device plan: partial -> hash exchange -> final
        assert _plan_shape(port.last_exec) == _plan_shape(ref._last_exec)
        assert ("HashAggregateExec", "partial", ()) in _plan_shape(
            port.last_exec)
        outs[flag] = got[0]
    assert outs["true"].equals(outs["false"])


def test_ici_exchange_of_dict_strings_and_f64_sums():
    """String keys ride the lanes where both packages hold them as
    dictionaries (vocabularies aligned), else both take the device
    exchange; f64 sums agree to 1e-12 relative."""
    rng = np.random.default_rng(5)
    t = pa.table({"s": [f"w{x}" for x in rng.integers(0, 40, 5000)],
                  "x": rng.normal(0, 1e3, 5000)})
    got, ici = [], []
    for api in (torch_api(), jax_api()):
        s = api.session({"spark.rapids.shuffle.mode": "ICI"})
        df = (s.create_dataframe(t, num_partitions=8)
              .group_by(api.col("s"))
              .agg(api.F.sum("x").alias("sx"), api.F.count().alias("n")))
        got.append(df.collect())
        ici.append(sum(v.get("iciExchangeTime", 0)
                       for v in s.last_metrics().values()) > 0)
    assert ici[0] == ici[1]
    assert_tables_equal(got[0], got[1], ignore_order=True,
                        approx_float=F64_TOL)


def test_sharded_expand_matches_one_device():
    """An Expand member (rollup) packs shards shard-major."""
    rng = np.random.default_rng(9)
    t = pa.table({"a": rng.integers(0, 5, 3000).astype(np.int64),
                  "b": rng.integers(0, 3, 3000).astype(np.int64),
                  "x": rng.integers(0, 100, 3000).astype(np.int64)})
    got = {}
    for flag in ("true", "false"):
        for name, api in (("port", torch_api()), ("jax", jax_api())):
            s = api.session({"spark.rapids.sql.multichip.enabled": flag})
            df = (s.create_dataframe(t, num_partitions=8)
                  .filter(api.col("x") > api.lit(3))
                  .rollup("a", "b").agg(api.F.sum("x").alias("sx")))
            got[(flag, name)] = _sorted(df.collect())
    base = got[("false", "jax")]
    for k, v in got.items():
        assert v.equals(base), k


def test_shard_bodies_evaluate_on_the_shards_device():
    """A shard on another device than the session's evaluates there:
    literals included, under a key naming that device. The meta device
    stands in for a second card (the CPU has only one device)."""
    from spark_rapids_tpu_torch.expr.core import col, lit
    s = torch_api().session({"spark.rapids.sql.multichip.enabled": "true"})
    df = s.create_dataframe(_data(400), num_partitions=8)
    (df.filter(col("g") % lit(3) != lit(1))
     .select((col("d") * lit(2.0) + lit(1.0)).alias("d2"),
             (col("g") + lit(1)).alias("g1")).collect())
    (node,) = [n for n in s.last_exec.walk()
               if type(n).__name__ == "ShardedStageExec"]
    assert node._bodies_on(node.device) is node.bodies
    meta = torch.device("meta")
    assert [b.key[-1] for b in node._bodies_on(meta)] == ["meta", "meta"]
    in_types = [f.dtype for f in node.children[0].schema.fields]
    cap = 1024
    assert node._key(meta, 8, cap, in_types) \
        != node._key(node.device, 8, cap, in_types)
    batch = next(iter(node.children[0].execute_partition(0)))
    packed = node._pack([batch, None], max(cap, batch.capacity), meta)
    out, _errs, _rows = node._build(meta)()(packed, 0, 2)
    assert {c.data.device for c in out.columns} == {meta}
    assert out.live_mask().device == meta


# -- shard-skew observability -----------------------------------------------

def test_resolve_shards_folds_skew():
    from spark_rapids_tpu.analysis.kernel_audit import _resolve_shards as jr
    from spark_rapids_tpu_torch.analysis.kernel_audit import (
        _resolve_shards as pr,
    )
    notes = [(4, np.array([100, 300, 100, 100])),
             (4, np.array([100, 100, 100, 100]))]
    doc = pr([(n, torch.tensor(r)) for n, r in notes])
    assert doc == jr(notes)
    assert doc["rows_per_shard"] == [200, 400, 200, 200]
    assert doc["skew"] == 1.6  # 400 / mean(250)
    assert pr([]) is None and jr([]) is None


def test_roofline_reports_seeded_skew():
    rows = 4000
    data = {"g": [i % 8 for i in range(rows)], "v": list(range(rows))}
    docs = []
    for api in (torch_api(), jax_api()):
        s = api.session({"spark.rapids.sql.multichip.enabled": "true",
                         "spark.rapids.obs.audit.enabled": "true"})
        col, lit = api.col, api.lit
        df = (s.create_dataframe(data, num_partitions=8)
              .filter(col("v") % lit(8) == lit(0))
              .select(col("g"), (col("v") + lit(1)).alias("v1")))
        df.collect()
        shards = (s.last_roofline() or {}).get("shards")
        assert shards is not None
        assert shards["n_shards"] == 8 and shards["waves"] >= 1
        assert len(shards["rows_per_shard"]) == 8
        assert shards["skew"] >= 1.0
        docs.append(shards)
    assert docs[0]["rows_per_shard"] == docs[1]["rows_per_shard"]
    assert docs[0]["skew"] == docs[1]["skew"]
    port = torch_api().session({"spark.rapids.sql.multichip.enabled":
                                "true", "spark.rapids.obs.audit.enabled":
                                "true"})
    from spark_rapids_tpu_torch.analysis import kernel_audit as KA
    port.create_dataframe(data, num_partitions=8).filter(
        torch_api().col("v") > torch_api().lit(5)).select(
        torch_api().col("g"), (torch_api().col("v") * torch_api().lit(2))
        .alias("w")).collect()
    assert any(line.strip().startswith("shards")
               for line in KA.render_text(port.last_roofline()))


def test_history_record_carries_the_mesh(tmp_path):
    from torch_port_helpers import reset_torch_runtime
    recs = []
    for flag in ("true", "false"):
        reset_torch_runtime()  # the history store is process-wide
        s = torch_api().session({
            "spark.rapids.sql.multichip.enabled": flag,
            "spark.rapids.obs.historyDir": str(tmp_path / flag)})
        _narrow(torch_api(), s, _data(500)).collect()
        from spark_rapids_tpu_torch.runtime.obs import history as H
        recs.append([r for r in H.QueryHistoryStore(
            str(tmp_path / flag)).read_all()
            if r.get("type") == "query"][-1])
    reset_torch_runtime()
    assert recs[0]["mesh"] == {"n_devices": 8, "axes": ["part"]}
    assert "mesh" not in recs[1]


# -- failure paths ------------------------------------------------------------

def test_build_failure_falls_back_to_single_device(monkeypatch):
    from spark_rapids_tpu_torch.exec import fuse
    data = _data(2000)
    expect = _sorted(_narrow(torch_api(), torch_api().session({}),
                             data).collect())
    orig = fuse.fused

    def boom(key, builder):
        if key and key[0] == "sharded_stage":
            raise RuntimeError("synthetic sharded build failure")
        return orig(key, builder)

    monkeypatch.setattr(fuse, "fused", boom)
    s = torch_api().session({"spark.rapids.sql.multichip.enabled": "true"})
    got = _sorted(_narrow(torch_api(), s, data).collect())
    assert got.equals(expect)  # per-slot replay through the fused path
    (node,) = [n for n in s.last_exec.walk()
               if type(n).__name__ == "ShardedStageExec"]
    assert node._failed


def test_error_while_a_wave_runs_propagates(monkeypatch):
    """The port's rule: a failure raised while the composed function runs
    is never replayed one-device."""
    from spark_rapids_tpu_torch.exec import sharded as SH

    def broken(self, dev):
        def build():
            def fn(batch, pid, k):
                raise RuntimeError("synthetic failure inside a wave")
            return fn
        return build

    from spark_rapids_tpu_torch.exec import fuse
    monkeypatch.setattr(SH.ShardedStageExec, "_build", broken)
    fuse.clear_cache()  # the broken builder must run
    s = torch_api().session({"spark.rapids.sql.multichip.enabled": "true"})
    try:
        with pytest.raises(RuntimeError, match="inside a wave"):
            _narrow(torch_api(), s, _data(500)).collect()
        (node,) = [n for n in s.last_exec.walk()
                   if type(n).__name__ == "ShardedStageExec"]
        assert not node._failed
    finally:
        fuse.clear_cache()


def test_wave_retry_on_injected_oom():
    from spark_rapids_tpu_torch.runtime.retry import OomInjector, set_backoff
    data = _data(2000)
    expect = _sorted(_narrow(torch_api(), torch_api().session({}),
                             data).collect())
    s = torch_api().session({"spark.rapids.sql.multichip.enabled": "true"})
    set_backoff(0.0, 0.0)
    OomInjector.configure(num_ooms=1)
    try:
        got = _sorted(_narrow(torch_api(), s, data).collect())
    finally:
        OomInjector.configure(num_ooms=0)
    assert got.equals(expect)
    assert "ShardedStageExec" in _port_tree(s)


def test_cancellation_not_swallowed_by_fallback(monkeypatch):
    from spark_rapids_tpu_torch.exec import fuse
    from spark_rapids_tpu_torch.runtime.lifecycle import QueryCancelledError
    orig = fuse.fused

    def cancelled(key, builder):
        if key and key[0] == "sharded_stage":
            raise QueryCancelledError("cancelled by user")
        return orig(key, builder)

    monkeypatch.setattr(fuse, "fused", cancelled)
    s = torch_api().session({"spark.rapids.sql.multichip.enabled": "true"})
    with pytest.raises(QueryCancelledError):
        _narrow(torch_api(), s, _data(1000)).collect()


def test_outside_the_context_one_device_plans_as_before():
    with MESH.virtual_devices(1):
        s = torch_api().session({})
        df = (s.create_dataframe(_data(500), num_partitions=4)
              .group_by(torch_api().col("g"))
              .agg(torch_api().F.count().alias("n")))
        df.collect()
        names = [n for n, _m, _f in _plan_shape(s.last_exec)]
    assert "ShuffleExchangeExec" not in names
    assert "CollectExchangeExec" in names


# -- the parallel functions against the JAX ones in shard_map ---------------

def _jax_mesh():
    return JMESH.make_mesh(8, axis_names=("part",))


def _shard_map(fn, mesh, n_in, n_out_specs):
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    spec = P("part")
    return shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                     out_specs=n_out_specs(spec))


@pytest.mark.parametrize("seed", [0, 1])
def test_route_rows_matches_jax(seed):
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as PX
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 8, 200)
    v = rng.random(200) < 0.7
    want = [np.asarray(z) for z in JX.route_rows(jnp.asarray(t),
                                                 jnp.asarray(v), 8)]
    got = PX.route_rows(torch.from_numpy(t), torch.from_numpy(v), 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("send_cap", [0, 4, 16])
def test_all_to_all_exchange_matches_jax(send_cap):
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as PX
    rng = np.random.default_rng(3)
    n = 8 * 32
    x = rng.integers(-10**6, 10**6, n)
    f = rng.normal(size=n)
    valid = rng.random(n) < 0.8
    target = rng.integers(0, 8, n).astype(np.int32)

    def shard_fn(x, f, valid, target):
        return JX.all_to_all_exchange({"x": x, "f": f}, valid, target,
                                      ("part",), send_cap=send_cap)
    fn = _shard_map(shard_fn, _jax_mesh(), 4,
                    lambda s: ({"x": s, "f": s}, s))
    jp, jv = jax.jit(fn)(jnp.asarray(x), jnp.asarray(f), jnp.asarray(valid),
                         jnp.asarray(target))
    devs = MESH.mesh_devices(8)
    ch = [np.split(a, 8) for a in (x, f, valid, target)]
    pp, pv = PX.all_to_all_exchange(
        [{"x": torch.from_numpy(ch[0][i]), "f": torch.from_numpy(ch[1][i])}
         for i in range(8)],
        [torch.from_numpy(ch[2][i]) for i in range(8)],
        [torch.from_numpy(ch[3][i]) for i in range(8)], devs, send_cap)
    got_v = torch.cat(pv).numpy()
    np.testing.assert_array_equal(got_v, np.asarray(jv))
    for k in ("x", "f"):
        got = torch.cat([p[k] for p in pp]).numpy()
        np.testing.assert_array_equal(got[got_v], np.asarray(jp[k])[got_v])


def test_broadcast_planes_matches_jax():
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as PX
    rng = np.random.default_rng(4)
    x = rng.integers(0, 100, 64)
    v = rng.random(64) < 0.5
    fn = _shard_map(lambda x, v: JX.broadcast_planes({"x": x}, v, ("part",)),
                    _jax_mesh(), 2, lambda s: ({"x": s}, s))
    jp, jv = jax.jit(fn)(jnp.asarray(x), jnp.asarray(v))
    pp, pv = PX.broadcast_planes(
        [{"x": torch.from_numpy(c)} for c in np.split(x, 8)],
        [torch.from_numpy(c) for c in np.split(v, 8)], MESH.mesh_devices(8))
    np.testing.assert_array_equal(torch.cat(pv).numpy(), np.asarray(jv))
    np.testing.assert_array_equal(torch.cat([p["x"] for p in pp]).numpy(),
                                  np.asarray(jp["x"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_local_sorted_group_agg_matches_jax(seed):
    from spark_rapids_tpu.parallel import exchange as JX
    from spark_rapids_tpu_torch.parallel import exchange as PX
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2**64 - 1, 128, dtype=np.uint64)
    key[::3] = key[1]  # repeated keys
    valid = rng.random(128) < 0.9
    a = rng.integers(-1000, 1000, 128)
    b = rng.normal(size=128)
    want = JX.local_sorted_group_agg(jnp.asarray(key), jnp.asarray(valid),
                                     {"a": jnp.asarray(a),
                                      "b": jnp.asarray(b)})
    got = PX.local_sorted_group_agg(torch.from_numpy(key.view(np.int64)),
                                    torch.from_numpy(valid),
                                    {"a": torch.from_numpy(a),
                                     "b": torch.from_numpy(b)})
    live = np.asarray(want["groups"])
    np.testing.assert_array_equal(got["groups"].numpy(), live)
    np.testing.assert_array_equal(got["keys"].numpy()[live],
                                  np.asarray(want["keys"]).view(np.int64)[live])
    for k in ("count", "sum_a"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["sum_b"].numpy(), np.asarray(want["sum_b"]),
                               rtol=F64_TOL, atol=1e-12)


def test_shard_sum_is_the_psum():
    from spark_rapids_tpu_torch.parallel import exchange as PX
    vals = [{"s": torch.tensor([i, 2 * i])} for i in range(8)]
    got = PX.shard_sum(vals, torch.device("cpu"))
    assert got["s"].tolist() == [28, 56]


def test_splitmix64_matches_jax():
    from spark_rapids_tpu.parallel import distributed as JD
    from spark_rapids_tpu_torch.parallel import distributed as PD
    rng = np.random.default_rng(7)
    x = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    want = np.asarray(JD.splitmix64(jnp.asarray(x.view(np.uint64))))
    got = PD.splitmix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


def test_distributed_groupby_sum_matches_jax():
    from spark_rapids_tpu.parallel import distributed as JD
    from spark_rapids_tpu_torch.parallel import distributed as PD
    rng = np.random.default_rng(8)
    n = 8 * 64
    key = rng.integers(0, 20, n).astype(np.uint64)
    valid = rng.random(n) < 0.9
    v = rng.integers(0, 1000, n)
    jm = _jax_mesh()
    jstep = JD.make_distributed_groupby_sum(
        jm, lambda valid, vals: vals["v"] > 100, ["v"])
    want = jstep(JD.shard_global(jm, jnp.asarray(key)),
                 JD.shard_global(jm, jnp.asarray(valid)),
                 {"v": JD.shard_global(jm, jnp.asarray(v))})
    pm = MESH.make_mesh(8, axis_names=("part",))
    pstep = PD.make_distributed_groupby_sum(
        pm, lambda valid, vals: vals["v"] > 100, ["v"])
    got = pstep(torch.from_numpy(key.view(np.int64)),
                PD.shard_global(pm, valid),
                {"v": torch.from_numpy(v)})
    live = np.asarray(want["groups"])
    np.testing.assert_array_equal(got["groups"].numpy(), live)
    np.testing.assert_array_equal(
        got["keys"].numpy()[live], np.asarray(want["keys"]).view(np.int64)[live])
    for k in ("count", "sum_v"):
        np.testing.assert_array_equal(got[k].numpy()[live],
                                      np.asarray(want[k])[live])


def test_distributed_reduction_matches_jax():
    from spark_rapids_tpu.parallel import distributed as JD
    from spark_rapids_tpu_torch.parallel import distributed as PD
    rng = np.random.default_rng(10)
    n = 8 * 50
    valid = rng.random(n) < 0.8
    p = rng.integers(0, 10**6, n)

    def jred(valid, vals):
        return jnp.sum(jnp.where(valid, vals["p"], 0))

    def pred(valid, vals):
        return torch.where(valid, vals["p"], 0).sum()
    jm = _jax_mesh()
    want = JD.make_distributed_reduction(jm, jred)(
        JD.shard_global(jm, jnp.asarray(valid)),
        {"p": JD.shard_global(jm, jnp.asarray(p))})
    pm = MESH.make_mesh(8, axis_names=("part",))
    got = PD.make_distributed_reduction(pm, pred)(
        torch.from_numpy(valid), {"p": torch.from_numpy(p)})
    assert int(got) == int(want) == int(p[valid].sum())


def test_conf_keys_match_the_jax_defaults():
    for key in ("spark.rapids.sql.multichip.enabled",
                "spark.rapids.sql.multichip.devices"):
        assert PC.registry()[key].default == JC.registry()[key].default
