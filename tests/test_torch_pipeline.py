"""The port's scan pipelines (``runtime/pipeline.py``) and shared host pool
(``runtime/host_pool.HostTaskPool``) against the JAX package, on the CPU.

- tests/test_pipeline.py's cases: the iterator's order and count, a
  producer exception, early close, the TaskContext binding and the pool
  worker's context restored; pipelined equals synchronous equals the JAX
  package; depth 0 gives the synchronous plan; the trace shows producer/
  consumer overlap; a producer error fails the query; a LIMIT leaks no
  thread; retry-OOM through a pipelined stage; the pipelined SERIALIZED
  shuffle and the deferred offsets fetch equal the synchronous path; an
  injected ``pipeline.producer`` death fails cleanly and degrades with
  correct results; a corrupt shuffle read recovers under the pipelined
  path. (Its dispatch-budget case counts fused XLA dispatches, which the
  port does not have, and its TrafficController cases are
  tests/test_torch_write.py's.)
- The port's own: ``insert_pipelines`` wraps the scan classes the JAX
  package's wraps for the same programs, a producer's KernelError is
  raised and never run again, a setup failure runs synchronously, the
  deferred offsets copy, and the tensors a batch hands over.
- ``HostTaskPool``: tiers by thread, inline at depth 2, ``map_ordered``
  order and its ``max_concurrency`` cap, the submitter's query id on the
  worker.

Data comes from numpy seeds; answers are compared with
``asserts.assert_tables_equal`` (floats to 1e-9 relative where the
summation order differs between the packages, exact between the port's
two paths).
"""
import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.csv as pcsv
import pyarrow.parquet as pq
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, reset_torch_runtime, torch_api

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.columnar.batch import from_arrow
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.ops._build import KernelError
from spark_rapids_tpu_torch.runtime import faults, lifecycle
from spark_rapids_tpu_torch.runtime import pipeline as PL
from spark_rapids_tpu_torch.runtime.host_pool import (
    HostTaskPool, get_host_pool,
)
from spark_rapids_tpu_torch.runtime.pipeline import PipelinedIterator
from spark_rapids_tpu_torch.runtime.task import TaskContext
from spark_rapids_tpu_torch.sql import functions as F

BATCH = {"spark.rapids.sql.reader.batchSizeRows": "1024"}
SYNC = {"spark.rapids.sql.pipeline.enabled": "false"}


@pytest.fixture(autouse=True)
def _fresh_runtime():
    fired = faults.fault_counts()
    reset_torch_runtime()
    yield
    reset_torch_runtime()
    # the fault tally is process-wide and survives re-configuration: the
    # injections here must not show in another file's counts
    with faults._LOCK:
        faults._FIRED.clear()
        faults._FIRED.update(fired)


def _table(rows, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 40, rows),
        "v": rng.integers(-1000, 1000, rows),
        "d": rng.uniform(0, 1, rows),
    })


def _session(**conf):
    return TorchSession({**BATCH, **conf}, device="cpu")


def _non_pool_threads():
    """Live threads the pipeline could have leaked; the shared pool's
    workers are excluded by name."""
    return {t for t in threading.enumerate()
            if t.is_alive() and not t.name.startswith("rapids-host-pool")}


def _tree_classes(root):
    out = []

    def walk(n):
        out.append(type(n).__name__)
        for c in n.children:
            walk(c)
    walk(root)
    return out


# ---------------------------------------------------------------------------
# PipelinedIterator unit behavior
# ---------------------------------------------------------------------------

def test_iterator_overlap_wall_clock():
    """depth >= 1 overlaps producer and consumer: 5 x (50 ms produce + 50
    ms consume) lands well under the 500 ms serial sum."""
    def src():
        for i in range(5):
            time.sleep(0.05)
            yield i

    t0 = time.monotonic()
    pit = PipelinedIterator(src(), depth=2)
    got = []
    for item in pit:
        time.sleep(0.05)
        got.append(item)
    pit.close()
    overlapped = time.monotonic() - t0
    assert got == list(range(5))
    assert overlapped < 0.42, overlapped  # serial would be >= 0.5


@pytest.mark.parametrize("n,depth", [(257, 3), (5, 1), (0, 2)])
def test_iterator_preserves_order_and_count(n, depth):
    pit = PipelinedIterator(iter(range(n)), depth=depth)
    assert list(pit) == list(range(n))
    pit.close()


def test_iterator_producer_exception_propagates():
    def src():
        yield 1
        yield 2
        raise ValueError("decode exploded")

    pit = PipelinedIterator(src(), depth=2)
    got = []
    with pytest.raises(ValueError, match="decode exploded"):
        for item in pit:
            got.append(item)
    pit.close()
    assert got == [1, 2]


def test_iterator_early_close_cancels_producer():
    """Closing mid-stream stops production promptly, runs the source
    generator's finally and leaves no thread beyond the pool's."""
    state = {"produced": 0, "closed": False}

    def src():
        try:
            for i in range(10_000):
                state["produced"] += 1
                yield i
        finally:
            state["closed"] = True

    before = _non_pool_threads()
    pit = PipelinedIterator(src(), depth=2)
    it = iter(pit)
    assert next(it) == 0
    assert next(it) == 1
    pit.close()
    assert state["closed"], "source generator finally did not run"
    # bounded lookahead: queue depth + one stashed item + the two taken
    assert state["produced"] <= 2 + 2 + 2
    assert _non_pool_threads() == before


def test_iterator_taskcontext_and_query_binding():
    """The producer runs on a pool worker but sees the consumer task's
    TaskContext and query id."""
    seen = {}

    def src():
        seen["ctx"] = TaskContext.peek()
        seen["qid"] = lifecycle.current_query_id()
        seen["thread"] = threading.current_thread().name
        yield 1

    prev = lifecycle.bind(4242)
    try:
        with TaskContext(partition_id=3) as ctx:
            pit = PipelinedIterator(src(), depth=1, ctx=ctx)
            assert list(pit) == [1]
            pit.close()
    finally:
        lifecycle.bind(prev)
    assert seen["ctx"] is ctx
    assert seen["qid"] == 4242
    assert seen["thread"].startswith("rapids-host-pool")


def test_iterator_pool_worker_context_restored():
    """A refill leaks neither the task nor the query id into the pool
    worker it borrowed."""
    prev = lifecycle.bind(77)
    try:
        with TaskContext() as ctx:
            pit = PipelinedIterator(iter([1, 2, 3]), depth=1, ctx=ctx)
            assert list(pit) == [1, 2, 3]
            pit.close()
    finally:
        lifecycle.bind(prev)
    pool = get_host_pool()
    futs = [pool.submit(lambda: (TaskContext.peek(),
                                 lifecycle.current_query_id()))
            for _ in range(pool.n_threads * 2)]
    assert all(f.result() == (None, None) for f in futs)


# ---------------------------------------------------------------------------
# HostTaskPool
# ---------------------------------------------------------------------------

def test_host_pool_tiers_and_inline_depth_two():
    pool = get_host_pool()

    def tier():
        return threading.current_thread().name, HostTaskPool._depth()

    def nested():
        inner = pool.submit(tier).result()
        innermost = pool.submit(
            lambda: pool.submit(tier).result()).result()
        return tier(), inner, innermost

    (t0_name, d0), (t1_name, d1), (t2_name, d2) = \
        pool.submit(nested).result()
    assert t0_name.startswith("rapids-host-pool-t0") and d0 == 1
    assert t1_name.startswith("rapids-host-pool-t1") and d1 == 2
    # a submission from a tier-1 worker runs inline on that worker
    assert t2_name.startswith("rapids-host-pool-t1") and d2 == 2
    assert HostTaskPool._depth() == 0
    assert set(pool.queue_depths()) == {"tier0", "tier1"}


@pytest.mark.parametrize("cap", [1, 3])
def test_host_pool_map_ordered_order_and_cap(cap):
    pool = get_host_pool()
    lock = threading.Lock()
    live = {"now": 0, "max": 0}
    rng = np.random.default_rng(cap)
    delays = rng.uniform(0, 0.01, 24)

    def work(i):
        with lock:
            live["now"] += 1
            live["max"] = max(live["max"], live["now"])
        time.sleep(delays[i])
        with lock:
            live["now"] -= 1
        return i * i

    out = list(pool.map_ordered(work, range(24), max_concurrency=cap))
    assert out == [i * i for i in range(24)]
    assert 1 <= live["max"] <= cap


def test_host_pool_submit_binds_query_id():
    pool = get_host_pool()
    prev = lifecycle.bind(9001)
    try:
        seen = pool.submit(lifecycle.current_query_id).result()
    finally:
        lifecycle.bind(prev)
    assert seen == 9001
    assert pool.submit(lifecycle.current_query_id).result() is None


# ---------------------------------------------------------------------------
# end to end: the planner pass and queries
# ---------------------------------------------------------------------------

def _write_inputs(tmp_path, t):
    pq.write_table(t, str(tmp_path / "t.parquet"), row_group_size=1500)
    pcsv.write_csv(t, str(tmp_path / "t.csv"))
    return {"parquet": str(tmp_path / "t.parquet"),
            "csv": str(tmp_path / "t.csv")}


def _agg(api, df):
    col_, lit_, F_ = api.col, api.lit, api.F
    return (df.filter(col_("v") > lit_(-500))
            .group_by("k").agg(F_.sum(col_("v")).alias("sv"),
                               F_.count().alias("n"),
                               F_.sum(col_("d")).alias("sd")))


#: name -> (extra conf, source(api, session, paths, t)): every scan class
#: insert_pipelines wraps, under an aggregate (or a join) so it is not the
#: plan's root
PROGRAMS = {
    "in_memory_2parts": ({}, lambda api, s, p, t:
                         _agg(api, s.create_dataframe(t, num_partitions=2))),
    "parquet_host": ({"spark.rapids.sql.decode.device.enabled": "false"},
                     lambda api, s, p, t: _agg(api,
                                               s.read_parquet(p["parquet"]))),
    "parquet_device": ({}, lambda api, s, p, t:
                       _agg(api, s.read_parquet(p["parquet"]))),
    "csv": ({}, lambda api, s, p, t: _agg(api, s.read_csv(p["csv"]))),
    "join": ({}, lambda api, s, p, t: s.create_dataframe(t).join(
        s.create_dataframe(t.slice(0, 300)).select(
            api.col("k").alias("k2"), api.col("v").alias("v2")),
        api.col("v") == api.col("v2")).group_by("k").agg(
        api.F.count().alias("n"))),
    "cached": ({}, lambda api, s, p, t: _agg(
        api, s.create_dataframe(t, num_partitions=2).cache())),
}


def _run(api, name, paths, t, conf):
    extra, build = PROGRAMS[name]
    s = api.session({**BATCH, **extra, **conf})
    return s, build(api, s, paths, t)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_pipelined_equals_sync_equals_jax(name, tmp_path):
    t = _table(9_000)
    paths = _write_inputs(tmp_path, t)
    s_pipe, df_pipe = _run(torch_api(), name, paths, t, {})
    got = df_pipe.collect()
    pipes = [e for e in s_pipe.last_exec.walk()
             if type(e).__name__ == "PipelineExec"]
    assert pipes and all(
        e.metrics["pipelineDepth"] == 2 for e in pipes), \
        s_pipe.last_exec.tree_string()
    _, df_sync = _run(torch_api(), name, paths, t, SYNC)
    sync = df_sync.collect()
    assert_tables_equal(got, sync, ignore_order=True)
    _, df_jax = _run(jax_api(), name, paths, t, {})
    assert_tables_equal(got, df_jax.collect(), ignore_order=True,
                        approx_float=1e-9)


def _convert(s, df):
    from spark_rapids_tpu_torch.plan.overrides import convert_plan
    root, _ = convert_plan(df.plan, s.conf, s.device)
    return root


def _pipelined_scans(root):
    """Sorted names of the scans each PipelineExec wraps, and of every
    scan class in the tree."""
    wrapped, scans = [], []
    seen = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        name = type(n).__name__
        if name.endswith("ScanExec") or name == "EncodedParquetSourceExec":
            scans.append(name)
        if name == "PipelineExec":
            wrapped.append(type(n.children[0]).__name__)
        for c in list(getattr(n, "members", None) or []) + list(n.children):
            walk(c)
    walk(root)
    return sorted(wrapped), sorted(set(scans))


@pytest.mark.parametrize("name", list(PROGRAMS) + ["root_scan"])
def test_insert_pipelines_placements_match_jax(name, tmp_path):
    """The scan classes wrapped in PipelineExec, compared by name with the
    JAX package's tree for the same program (its tree also holds fused
    stages; their members are walked too)."""
    from spark_rapids_tpu.plan.overrides import convert_plan as jconvert
    t = _table(4_000)
    paths = _write_inputs(tmp_path, t)
    if name == "root_scan":
        s_t = torch_api().session(BATCH)
        df_t = s_t.create_dataframe(t)
        s_j = jax_api().session(BATCH)
        df_j = s_j.create_dataframe(t)
    else:
        s_t, df_t = _run(torch_api(), name, paths, t, {})
        s_j, df_j = _run(jax_api(), name, paths, t, {})
    got = _pipelined_scans(_convert(s_t, df_t))
    want = _pipelined_scans(jconvert(df_j.plan, s_j.conf)[0])
    assert got[0] == want[0], (got, want)
    if name == "root_scan":
        assert got[0] == [] and got[1] == ["InMemoryScanExec"]
    if name == "cached":
        assert "CachedScanExec" in got[1] and \
            "CachedScanExec" not in got[0]


@pytest.mark.parametrize("conf", [{"spark.rapids.sql.pipeline.depth": "0"},
                                  SYNC])
def test_depth_zero_equals_synchronous_plan_and_results(conf):
    t = _table(8_000)
    s0 = _session(**conf)
    df0 = s0.create_dataframe(t).filter(col("v") > lit(0)).group_by(
        "k").agg(F.sum(col("v")).alias("s"))
    assert "PipelineExec" not in _tree_classes(
        _convert(s0, df0))
    s1 = _session()
    df1 = s1.create_dataframe(t).filter(col("v") > lit(0)).group_by(
        "k").agg(F.sum(col("v")).alias("s"))
    assert "PipelineExec" in _tree_classes(_convert(s1, df1))
    assert_tables_equal(df0.collect(), df1.collect(), ignore_order=True)


def test_trace_shows_producer_consumer_overlap(tmp_path):
    """The DEBUG trace carries pipelineProduce spans from the producer;
    with a bounded queue some batch is produced after the consumer's
    first aggregate span began."""
    t = _table(60_000)
    s = _session(**{"spark.rapids.sql.trace.enabled": "true",
                    "spark.rapids.sql.trace.path": str(tmp_path),
                    "spark.rapids.sql.trace.level": "DEBUG"})
    (s.create_dataframe(t, num_partitions=1)
     .filter(col("v") > lit(-900))
     .group_by("k").agg(F.sum(col("v")).alias("sv"))).collect()
    with open(s.last_trace_paths["trace"]) as f:
        events = json.load(f)["traceEvents"]
    produce = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == "pipelineProduce"]
    consume = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("ph") == "X" and "HashAggregate" in e.get("name", "")]
    assert produce, "no pipelineProduce spans in DEBUG trace"
    assert consume, "no consumer-side agg spans in trace"
    assert max(ts for ts, _ in produce) > min(ts for ts, _ in consume)


def test_producer_error_fails_query(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(4_000), path, row_group_size=256)
    s = _session(**{"spark.rapids.sql.decode.device.enabled": "false"})
    df = s.read_parquet(path).filter(col("v") > lit(0)).group_by("k").agg(
        F.count().alias("n"))
    with open(path, "wb") as f:
        f.write(b"not a parquet file at all")
    before = _non_pool_threads()
    with pytest.raises(Exception):
        df.collect()
    assert s.last_action_status == ("failed", None)
    assert _non_pool_threads() == before


def test_limit_early_exit_no_thread_leak():
    t = _table(200_000)
    s = _session()
    before = _non_pool_threads()
    r = (s.create_dataframe(t).filter(col("d") >= lit(0.0))
         .limit(7).collect())
    assert r.num_rows == 7
    assert _non_pool_threads() == before
    # the pipeline engaged AND stopped early: far fewer batches crossed
    # the boundary than the ~196 the input holds
    lm = s.last_metrics()
    pipe = next(v for k, v in lm.items() if k.startswith("PipelineExec"))
    assert pipe["pipelineDepth"] >= 1
    assert pipe["numOutputBatches"] < 50


def test_retry_oom_through_pipelined_stage():
    t = _table(20_000)

    def q(s):
        return (s.create_dataframe(t, num_partitions=2)
                .group_by("k").agg(F.sum(col("v")).alias("sv"),
                                   F.count().alias("n")))

    expected = q(_session(**SYNC)).collect()
    s = _session(**{"spark.rapids.sql.test.injectRetryOOM": "3"})
    got = q(s).collect()
    assert s.last_task_metrics().get("retryCount", 0) >= 1
    assert_tables_equal(got, expected, ignore_order=True)


SERIALIZED = {"spark.rapids.shuffle.mode": "SERIALIZED",
              "spark.rapids.shuffle.multiThreaded.writer.threads": "4"}


def _repart_agg(s, t):
    return (s.create_dataframe(t, num_partitions=4).repartition(4, "k")
            .group_by("k").agg(F.count().alias("n"),
                               F.sum(col("v")).alias("sv")))


def test_pipelined_serialized_shuffle_matches_sync():
    """The streaming writer (pipeline on) gives the synchronous serde
    path's answer, and both went through the serialized store."""
    t = _table(24_000)
    s_pipe = _session(**SERIALIZED)
    r_pipe = _repart_agg(s_pipe, t).collect()
    s_sync = _session(**SERIALIZED, **SYNC)
    r_sync = _repart_agg(s_sync, t).collect()
    for s in (s_pipe, s_sync):
        ex = [e for e in s.last_exec.walk()
              if type(e).__name__ == "ShuffleExchangeExec"]
        assert ex and ex[0].metrics["shuffleBytesWritten"] > 0
    assert_tables_equal(r_pipe, r_sync, ignore_order=True)


@pytest.mark.parametrize("parts", [1, 3])
def test_deferred_offsets_fetch_matches_sync(parts, monkeypatch):
    """The compact exchange with the one-deep deferred offsets fetch
    emits exactly the sub-batches (contents and per-partition row order)
    of the eager dispatch-then-fetch loop, and really defers: batch i's
    offsets are read after batch i+1's counting sort was dispatched."""
    from spark_rapids_tpu_torch.columnar.batch import to_arrow
    from spark_rapids_tpu_torch.exec import nodes as X
    from spark_rapids_tpu_torch.plan.overrides import convert_plan
    t = _table(6_000)
    events = []
    real_dispatch = X._ExchangeExec._dispatch_compact
    real_emit = X._ExchangeExec._emit_compact

    def dispatch(self, batch, pid):
        events.append("dispatch")
        return real_dispatch(self, batch, pid)

    def emit(self, batch, dispatched, out):
        events.append("emit")
        return real_emit(self, batch, dispatched, out)

    monkeypatch.setattr(X._ExchangeExec, "_dispatch_compact", dispatch)
    monkeypatch.setattr(X._ExchangeExec, "_emit_compact", emit)

    def drain(conf):
        events.clear()
        s = _session(**conf)
        df = s.create_dataframe(t, num_partitions=parts).repartition(4, "k")
        ex, _ = convert_plan(df.plan, s.conf, s.device)
        assert type(ex).__name__ == "ShuffleExchangeExec"
        out = []
        for p in range(ex.num_partitions):
            with TaskContext(partition_id=p):
                out.append([to_arrow(b, df.plan.schema.names).to_pylist()
                            for b in ex.execute_partition(p)])
        return out, list(events), ex.partition_fetches

    pipe, pipe_events, pipe_fetches = drain({})
    sync, sync_events, sync_fetches = drain(SYNC)
    assert pipe == sync
    assert pipe_fetches == sync_fetches == pipe_events.count("dispatch")
    assert sync_events[:2] == ["dispatch", "emit"]
    assert pipe_events[:3] == ["dispatch", "dispatch", "emit"]


def test_start_d2h_on_the_cpu():
    t = torch.arange(9, dtype=torch.int64)
    np.testing.assert_array_equal(PL.start_d2h(t).numpy(), np.arange(9))


def test_batch_tensors_cover_every_plane():
    """The handoff's record_stream walk reaches every plane of a batch:
    flat and dictionary strings, validity, arrays and structs, a row mask
    and a lazy row count."""
    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnarBatch, LazyRowCount,
    )
    t = pa.table({
        "i": pa.array([1, None, 3]),
        "s": pa.array(["a", "bb", None]),
        "ds": pa.array(["x", "x", "x"]).dictionary_encode(),
        "arr": pa.array([[1, 2], None, [3]]),
        "st": pa.array([{"a": 1, "b": "u"}, None, {"a": 2, "b": "v"}]),
    })
    b = from_arrow(t, "cpu")
    b = ColumnarBatch(b.columns, LazyRowCount(torch.tensor(3)),
                      torch.tensor([True, False, True, False]))
    want = set()

    def collect(x):
        if isinstance(x, torch.Tensor):
            want.add(id(x))
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, list):
            for v in x:
                collect(v)
        elif x is not None:
            collect(x.data)
            collect(x.validity)
    collect(b.columns)
    want |= {id(b.row_mask), id(b.num_rows._dev)}
    assert {id(x) for x in PL.batch_tensors(b)} == want


def test_encoded_batch_tensors(tmp_path):
    """An EncodedBatch's planes and ready columns are walked too."""
    from spark_rapids_tpu_torch.io import encoded as ENC
    path = str(tmp_path / "t.parquet")
    pq.write_table(_table(3_000), path, row_group_size=1000)
    pf = pq.ParquetFile(path)
    fields = _session().read_parquet(path).plan.schema.fields
    hb = next(ENC.read_encoded_batches(path, pf.metadata, [0, 1], fields,
                                       4096, 32, True))
    eb = ENC.upload(hb, {}, "cpu")
    planes = [p for c in eb.columns for p in c.planes.values()]
    assert planes
    assert {id(x) for x in PL.batch_tensors(eb)} >= {id(p) for p in planes}


# ---------------------------------------------------------------------------
# failures on the producer side
# ---------------------------------------------------------------------------

def test_injected_producer_death_fails_cleanly_no_leak():
    from spark_rapids_tpu_torch.runtime.faults import InjectedFaultError
    t = _table(60_000)
    s = _session(**{"spark.rapids.debug.faults":
                    "pipeline.producer:ioerror:1,3"})
    df = (s.create_dataframe(t, num_partitions=1)
          .filter(col("v") > lit(-900))
          .group_by("k").agg(F.sum(col("v")).alias("sv")))
    before = _non_pool_threads()
    with pytest.raises(InjectedFaultError):
        df.collect()
    assert s.last_action_status == ("failed", None)
    time.sleep(0.2)
    assert _non_pool_threads() == before


def test_injected_producer_death_degrades_with_correct_results():
    t = _table(60_000)

    def q(s):
        return (s.create_dataframe(t, num_partitions=1)
                .filter(col("v") > lit(-900))
                .group_by("k").agg(F.sum(col("v")).alias("sv")))

    expected = q(_session()).collect()
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true",
                    "spark.rapids.debug.faults":
                    "pipeline.producer:ioerror:1,3"})
    before = _non_pool_threads()
    got = q(s).collect()
    assert s.last_action_status == ("degraded", "InjectedFaultError")
    assert_tables_equal(got, expected, ignore_order=True)
    time.sleep(0.2)
    assert _non_pool_threads() == before


def test_producer_kernel_error_is_raised_not_rerun(monkeypatch):
    """A KernelError on the producer side reaches the consumer and fails
    the query: no synchronous rerun, no CPU degradation."""
    from spark_rapids_tpu_torch.exec import nodes as X
    calls = {"n": 0}

    def broken(self, pidx):
        calls["n"] += 1
        yield from ()
        raise KernelError("bitslice failed to launch")

    monkeypatch.setattr(X.InMemoryScanExec, "execute_partition", broken)
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true"})
    df = s.create_dataframe(_table(3_000)).group_by("k").agg(
        F.count().alias("n"))
    with pytest.raises(KernelError, match="bitslice"):
        df.collect()
    assert calls["n"] == 1
    assert s.last_action_status == ("failed", None)


def test_setup_failure_runs_synchronously(monkeypatch, caplog):
    t = _table(5_000)

    def fail(*a, **k):
        raise RuntimeError("no stream")

    monkeypatch.setattr(PL, "PipelinedIterator", fail)
    s = _session()
    df = s.create_dataframe(t).group_by("k").agg(F.count().alias("n"))
    got = df.collect()
    pipe = next(v for k, v in s.last_metrics().items()
                if k.startswith("PipelineExec"))
    assert pipe["pipelineDepth"] == 0
    assert any("running synchronously" in r.message for r in caplog.records)
    want = _session(**SYNC).create_dataframe(t).group_by("k").agg(
        F.count().alias("n")).collect()
    assert_tables_equal(got, want, ignore_order=True)


def test_shuffle_read_corruption_recovers_under_pipelined_path():
    t = _table(24_000)
    expected = _repart_agg(_session(**SERIALIZED), t).collect()
    s = _session(**SERIALIZED, **{
        "spark.rapids.debug.faults": "shuffle.read:corrupt:1"})
    before = _non_pool_threads()
    got = _repart_agg(s, t).collect()
    assert s.last_action_status == ("ok", None)
    assert s.last_task_metrics().get("shuffleCorruptionRetries") == 1
    assert_tables_equal(got, expected, ignore_order=True)
    time.sleep(0.2)
    assert _non_pool_threads() == before
