"""The port's memory runtime (spark_rapids_tpu_torch/runtime/memory.py and
retry.py): the spill cascade, retry on OOM, split-retry, injection, the
task accumulators, and the OOM typing of a hand kernel's launch status.

tests/test_memory_retry.py's 15 cases run against the port with the same
assertions (its four trace-reading cases keep their accumulator
assertions; the trace instants are ROADMAP A11). Each end-to-end case also
runs the same program through the JAX package without injection and
compares the answers.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import reset_torch_runtime

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, from_arrow, to_arrow,
)
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.runtime.memory import (
    SpillFramework, SpillableColumnarBatch, get_spill_framework,
    peek_spill_framework, reset_spill_framework,
)
from spark_rapids_tpu_torch.runtime.retry import (
    OomInjector, TpuRetryOOM, TpuSplitAndRetryOOM, is_device_oom,
    with_retry, with_retry_no_split,
)
from spark_rapids_tpu_torch.runtime.task import TaskContext
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _batch(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return from_arrow(pa.table({"a": rng.integers(0, 50, n),
                                "b": rng.uniform(0, 1, n)}), "cpu")


def _session(conf=None):
    return TorchSession(conf, device="cpu")


def _jax_session(conf=None):
    from spark_rapids_tpu.sql.session import TpuSession
    return TpuSession(conf)


def test_spill_handle_roundtrip_tiers():
    fw = SpillFramework(1 << 30, 1 << 30)
    b = _batch(64)
    h = fw.register(b)
    expect = b.columns[0].data.clone()
    assert h.tier == "device"
    assert h.spill_to_host() == h.size
    assert h.tier == "host"
    assert h.spill_to_disk() == h.size
    assert h.tier == "disk"
    back = h.get()
    assert h.tier == "device"
    assert torch.equal(back.columns[0].data, expect)
    h.close()


def test_reserve_spills_largest_first():
    big, small = _batch(4096, 1), _batch(64, 2)
    fw = SpillFramework(big.device_memory_size()
                        + small.device_memory_size() + 1024, 1 << 30)
    hb, hs = fw.register(big), fw.register(small)
    fw.reserve(2048)  # must evict someone; biggest first
    assert hb.tier == "host"
    assert hs.tier == "device"
    assert fw.metrics["spill_count"] == 1


def test_reserve_cascades_to_disk():
    b1, b2 = _batch(1024, 1), _batch(1024, 2)
    host_budget = b1.device_memory_size() // 2  # host can't hold a batch
    fw = SpillFramework(b1.device_memory_size() + 512, host_budget)
    h1 = fw.register(b1)
    h2 = fw.register(b2)  # over budget already; reserve forces the drain
    fw.reserve(1024)
    tiers = sorted([h1.tier, h2.tier])
    assert "disk" in tiers  # spilled through host to disk
    assert fw.metrics["spill_to_disk_bytes"] > 0


def test_reserve_raises_when_nothing_spillable():
    fw = SpillFramework(1 << 20, 1 << 30)
    with pytest.raises(TpuRetryOOM):
        fw.reserve(1 << 21)  # larger than the whole budget


def test_with_retry_injected_retry_succeeds():
    OomInjector.configure(num_ooms=2)
    calls = []

    def attempt(b):
        calls.append(1)
        return int(b.num_rows)

    out = list(with_retry(attempt, _batch(10)))
    assert out == [10]
    assert len(calls) == 1  # injector fired before the attempt ran


def test_with_retry_split_produces_partials():
    OomInjector.configure(num_ooms=1, split=True)
    seen = []

    def attempt(b):
        seen.append(int(b.num_rows))
        return int(b.num_rows)

    out = list(with_retry(attempt, _batch(10)))
    assert sum(out) == 10
    assert len(out) == 2  # split in half, both halves processed


def test_with_retry_split_cascades_to_single_row_limit():
    OomInjector.configure(num_ooms=100, split=True)
    with pytest.raises(TpuSplitAndRetryOOM):
        list(with_retry(lambda b: 1, _batch(2)))


def test_with_retry_no_split():
    OomInjector.configure(num_ooms=1)
    assert with_retry_no_split(lambda: 42) == 42


def _kv_table():
    return pa.table({"k": ["a", "b"] * 32, "v": list(range(64))})


def test_agg_with_injected_split_retry_correct():
    # injected split-retry inside the aggregate's update must not change
    # the answer: the same program without injection, through the port
    # and through the JAX package
    t = _kv_table()
    plain = _session().create_dataframe(t).group_by("k") \
        .agg(F.sum(col("v"))).collect()
    s = _session({"spark.rapids.sql.test.injectRetryOOM": "1,0,split"})
    injected = s.create_dataframe(t).group_by("k") \
        .agg(F.sum(col("v"))).collect()
    assert sorted(map(tuple, (r.items() for r in injected.to_pylist()))) \
        == sorted(map(tuple, (r.items() for r in plain.to_pylist())))
    assert s.last_task_metrics().get("splitAndRetryCount") == 1
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.sql import functions as JF
    ref = _jax_session().create_dataframe(t).group_by("k") \
        .agg(JF.sum(jcol("v"))).collect()
    assert_tables_equal(injected, ref, ignore_order=True)


def test_cache_pages_out_under_tiny_budget():
    # a budget smaller than two cached partitions forces the cache to page
    reset_spill_framework()
    t = pa.table({"x": np.arange(20000, dtype=np.int64),
                  "y": np.random.default_rng(0).uniform(0, 1, 20000)})
    s = _session({"spark.rapids.memory.tpu.budgetBytes": 400_000})
    df = s.create_dataframe(t, num_partitions=4).cache()
    assert df.count() == 20000
    # run several queries; each rematerialization may evict another
    assert df.filter(col("x") > lit(10000)).count() == 9999
    got = df.agg(F.sum(col("x"))).to_pydict()
    assert list(got.values())[0][0] == 20000 * 19999 // 2
    assert peek_spill_framework().metrics["spill_count"] > 0
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.sql import functions as JF
    rows = df.filter(col("x") % lit(7) == lit(3)).group_by(
        (col("x") % lit(5)).alias("m")).agg(F.sum(col("y")).alias("sy"))
    ref = _jax_session().create_dataframe(t).cache().filter(
        jcol("x") % 7 == 3).group_by((jcol("x") % 5).alias("m")).agg(
        JF.sum(jcol("y")).alias("sy"))
    assert_tables_equal(rows.collect(), ref.collect(), ignore_order=True,
                        approx_float=1e-9)
    reset_spill_framework()


def test_leak_audit_reports_unreleased_handles():
    # reference RapidsBufferCatalog leak tracking: an unreleased handle is
    # named with its registration stack; releasing clears the report
    from spark_rapids_tpu_torch import types as T
    fw = SpillFramework(1 << 20, 1 << 20)
    fw.leak_audit = True
    b = ColumnarBatch([ColumnVector(T.INT64,
                                    torch.zeros(128, dtype=torch.int64))],
                      128)
    h = fw.register(b)
    leaks = fw.leak_report()
    assert len(leaks) == 1 and leaks[0][2] is not None
    assert "register" in leaks[0][2] or "test_leak" in leaks[0][2]
    with pytest.raises(AssertionError, match="not released"):
        fw.assert_no_leaks()
    fw.unregister(h)
    assert fw.leak_report() == []
    fw.assert_no_leaks()
    # expected_live tolerates legitimately persistent registrations
    h2 = fw.register(b)
    fw.assert_no_leaks(expected_live=1)
    fw.unregister(h2)


# ---------------------------------------------------------------------------
# per-task accumulators (the trace instants beside them are ROADMAP A11)
# ---------------------------------------------------------------------------

def test_retry_accumulators_roll_up_under_injection():
    try:
        OomInjector.configure(num_ooms=2)
        with TaskContext(partition_id=0) as ctx:
            out = list(with_retry(lambda b: int(b.num_rows), _batch(10)))
            assert out == [10]
            assert ctx.metric("retryCount").value == 2
            assert ctx.metric("retryWastedTime").value >= 0
    finally:
        OomInjector.configure(0)


def test_split_retry_accumulators_and_instants():
    try:
        OomInjector.configure(num_ooms=1, split=True)
        with TaskContext(partition_id=0) as ctx:
            out = list(with_retry(lambda b: int(b.num_rows), _batch(10)))
            assert sum(out) == 10 and len(out) == 2
            assert ctx.metric("splitAndRetryCount").value == 1
    finally:
        OomInjector.configure(0)


def test_spill_accumulators_and_instants():
    # a reservation-forced spill charges the spilling task's accumulators
    # (bytes + time) and its high-water mark of registered device bytes
    big = _batch(4096, 1)
    small = _batch(64, 2)
    fw = SpillFramework(big.device_memory_size()
                        + small.device_memory_size() + 1024, 1 << 30)
    with TaskContext(partition_id=3) as ctx:
        hb, hs = fw.register(big), fw.register(small)
        fw.reserve(2048)
        assert hb.tier == "host"
        assert ctx.metric("spillToHostBytes").value == hb.size
        assert ctx.metric("spillToHostTime").value > 0
        assert ctx.metric("maxDeviceBytesHeld").value >= hb.size
        hb.close()
        hs.close()


def test_end_to_end_injection_query_traces_retries():
    # the same answer, and the retry shows in the query's task totals
    t = _kv_table()
    s = _session({"spark.rapids.sql.test.injectRetryOOM": "1",
                  "spark.rapids.retry.backoffBaseMs": "0"})
    got = s.create_dataframe(t).group_by("k") \
        .agg(F.sum(col("v"))).collect()
    assert sorted(r["k"] for r in got.to_pylist()) == ["a", "b"]
    assert s.last_task_metrics().get("retryCount", 0) >= 1
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.sql import functions as JF
    ref = _jax_session().create_dataframe(t).group_by("k") \
        .agg(JF.sum(jcol("v"))).collect()
    assert_tables_equal(got, ref, ignore_order=True)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def test_is_device_oom_is_a_type_test():
    """The caching allocator raises torch.OutOfMemoryError; a user error
    whose message says "out of memory" is not an OOM and is not retried."""
    assert is_device_oom(torch.OutOfMemoryError("CUDA out of memory"))
    assert not is_device_oom(RuntimeError("CUDA out of memory"))
    assert not is_device_oom(MemoryError("out of memory"))
    calls = []

    def attempt():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return "done"

    from spark_rapids_tpu_torch.runtime.retry import set_backoff
    set_backoff(0.0, 0.0)
    fw = get_spill_framework()
    drains = fw.metrics["oom_drains"]
    with TaskContext() as ctx:
        assert with_retry_no_split(attempt) == "done"
        assert ctx.metric("retryCount").value == 1
    assert len(calls) == 2 and fw.metrics["oom_drains"] == drains + 1


@pytest.mark.parametrize("rc,exc", [(2, torch.OutOfMemoryError),
                                    (700, "KernelError"),
                                    (1, "KernelError")])
def test_build_check_maps_allocation_failure_to_oom(rc, exc):
    """A hand kernel's launch status of cudaErrorMemoryAllocation (2)
    raises torch.OutOfMemoryError, which the retry drains and retries;
    any other code raises a KernelError (a RuntimeError), never an
    OOM."""
    from spark_rapids_tpu_torch.ops import _build
    if exc == "KernelError":
        exc = _build.KernelError
    _build.check(0, "segsum")  # success raises nothing
    with pytest.raises(exc, match=f"error {rc}") as ei:
        _build.check(rc, "segsum")
    assert is_device_oom(ei.value) == (rc == 2)
    assert isinstance(ei.value, RuntimeError)


def _nested_batch():
    t = pa.table({
        "i": pa.array([1, None, 3, 4, 5], pa.int64()),
        "s": pa.array(["ab", None, "", "héllo", "x" * 40]),
        "st": pa.array([{"f": 1, "g": "a"}, None, {"f": None, "g": "bb"},
                        {"f": 4, "g": None}, {"f": 5, "g": "e"}],
                       pa.struct([("f", pa.int32()), ("g", pa.string())])),
        "m": pa.array([[("k1", 1)], None, [], [("a", 2), ("b", None)],
                       [("z", 9)]], pa.map_(pa.string(), pa.int64())),
        "l": pa.array([[1.5, None], None, [], [2.0], [3.0, 4.0, 5.0]],
                      pa.list_(pa.float64())),
    })
    return t, from_arrow(t, "cpu")


@pytest.mark.parametrize("through_disk", [False, True])
def test_spill_roundtrip_nested_batch(tmp_path, through_disk):
    """A batch with a string plane, a struct, a map and an array column
    pages to the host (and the disk) and comes back equal, bounds and
    all."""
    t, b = _nested_batch()
    b.columns[0].bounds = (1, 5)
    fw = SpillFramework(1 << 30, 1 << 30, spill_dir=str(tmp_path))
    h = fw.register(b)
    assert h.spill_to_host() == h.size and h.tier == "host"
    if through_disk:
        assert h.spill_to_disk() == h.size and h.tier == "disk"
        assert list(tmp_path.iterdir())
    back = h.get()
    assert h.tier == "device"
    assert to_arrow(back, t.schema.names).equals(t)
    assert back.columns[0].bounds == (1, 5)
    h.close()
    assert not list(tmp_path.iterdir())


def test_spillable_batch_of_masked_lazy_batch():
    """A masked batch with its row count still a device scalar pages out
    and back with the mask and the count."""
    from spark_rapids_tpu_torch.columnar.batch import LazyRowCount
    b = _batch(100)
    mask = b.live_mask() & (b.columns[0].data % 2 == 0)
    mb = ColumnarBatch(b.columns, LazyRowCount(mask.sum(dtype=torch.int32)),
                       mask)
    fw = SpillFramework(1 << 30, 1 << 30)
    sb = SpillableColumnarBatch(mb, fw)
    sb.handle.spill_to_host()
    back = sb.get_batch()
    assert int(back.num_rows) == int(mask.sum())
    assert torch.equal(back.row_mask, mask)
    sb.close()
    assert fw.leak_report() == []
