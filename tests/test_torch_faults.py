"""The port's failure domains: fault injection (runtime/faults.py), the
dispatch watchdog and circuit breaker (runtime/watchdog.py), graceful CPU
degradation, and the retry backoff.

tests/test_faults.py's cases run against the port with the same
assertions, but for its serde, shuffle, healthz and history cases (the
serialized shuffle is ROADMAP A10; healthz and history are A11). The
JAX package's is_device_oom matches jaxlib messages; the port's is a type
test (tests/test_torch_memory_retry.py). Each answered end-to-end case
also runs the same program through the JAX package without injection.
"""
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import reset_torch_runtime

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.expr.core import SparkException, col
from spark_rapids_tpu_torch.runtime import faults, watchdog
from spark_rapids_tpu_torch.runtime.faults import InjectedFaultError
from spark_rapids_tpu_torch.runtime.retry import (
    OomInjector, TpuRetryOOM, set_backoff, with_retry_no_split,
)
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _fresh_runtime():
    reset_torch_runtime()
    yield
    reset_torch_runtime()


def _table(rows=2000, seed=11):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 7, rows),
        "v": rng.integers(-1000, 1000, rows),
    })


def _session(**conf):
    base = {"spark.rapids.sql.reader.batchSizeRows": "512"}
    base.update(conf)
    return TorchSession(base, device="cpu")


def _agg(sess, t, parts=1):
    return sess.create_dataframe(t, num_partitions=parts) \
        .group_by("k").agg(F.sum(col("v")).alias("s"))


def _canon(table):
    return sorted(table.to_pylist(), key=repr)


def _jax_agg(t, parts=1):
    """The same program through the JAX package, without injection."""
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession
    return TpuSession({"spark.rapids.sql.reader.batchSizeRows": "512"}) \
        .create_dataframe(t, num_partitions=parts) \
        .group_by("k").agg(JF.sum(jcol("v")).alias("s")).collect()


# ---------------------------------------------------------------------------
# FaultInjector unit behavior
# ---------------------------------------------------------------------------

def test_spec_grammar_roundtrip():
    sched = faults.parse_spec(
        "scan.decode:ioerror:3,1;shuffle.read:corrupt;retry.oom:oom:2")
    assert set(sched) == {"scan.decode", "shuffle.read", "retry.oom"}
    s = sched["scan.decode"][0]
    assert (s.kind, s.remaining, s.skip) == ("ioerror", 3, 1)
    assert sched["shuffle.read"][0].remaining == 1


@pytest.mark.parametrize("spec,frag", [
    ("nosuch.site:ioerror", "unknown fault site"),
    ("scan.decode:explode", "unknown fault kind"),
    ("scan.decode:corrupt", "data site"),
    ("scan.decode", "expected"),
    ("scan.decode:ioerror:x", "count/skip"),
])
def test_spec_grammar_rejects(spec, frag):
    with pytest.raises(ValueError, match=frag):
        faults.parse_spec(spec)


def test_site_roster_is_the_jax_packages():
    from spark_rapids_tpu.runtime import faults as JF
    assert set(faults.SITES) == set(JF.SITES)
    assert faults.BYTE_SITES == JF.BYTE_SITES
    assert faults.KINDS == JF.KINDS


def test_site_count_skip_and_disarm():
    faults.configure("scan.decode:ioerror:2,1")
    faults.site("scan.decode")  # skipped pass
    with pytest.raises(InjectedFaultError):
        faults.site("scan.decode")
    with pytest.raises(InjectedFaultError):
        faults.site("scan.decode")
    faults.site("scan.decode")  # schedule exhausted -> disarmed
    assert not faults.armed("scan.decode")
    assert faults.fault_counts().get("scan.decode", 0) >= 2


def test_site_bytes_corrupt_and_delay():
    faults.configure("shuffle.read:corrupt:1", delay_ms=1.0)
    data = b"x" * 64
    bad = faults.site_bytes("shuffle.read", data)
    assert bad != data and len(bad) == len(data)
    assert faults.site_bytes("shuffle.read", data) == data  # exhausted
    faults.configure("scan.decode:delay:1", delay_ms=40.0)
    t0 = time.perf_counter()
    faults.site("scan.decode")
    assert time.perf_counter() - t0 >= 0.03


def test_oom_kind_raises_retryable():
    faults.configure("retry.oom:oom:1")
    with pytest.raises(TpuRetryOOM):
        faults.site("retry.oom")


def test_disabled_is_noop():
    faults.configure("")
    assert not faults.armed("scan.decode")
    faults.site("scan.decode")
    assert faults.site_bytes("shuffle.read", b"ab") == b"ab"


def test_retry_loop_consumes_injected_oom():
    faults.configure("retry.oom:oom:2")
    calls = []

    def attempt():
        calls.append(1)
        return 42

    set_backoff(0.0, 0.0)
    assert with_retry_no_split(attempt) == 42
    assert len(calls) == 1  # two injected OOMs fired BEFORE the attempt


# ---------------------------------------------------------------------------
# retry backoff; a user error that mentions memory
# ---------------------------------------------------------------------------

def test_retry_backoff_folds_into_block_time():
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    OomInjector.configure(num_ooms=2)
    set_backoff(30.0, 100.0)
    t0 = time.perf_counter()
    with TaskContext() as ctx:
        assert with_retry_no_split(lambda: 7) == 7
        blocked = ctx.metric("retryBlockTime").value
    elapsed = time.perf_counter() - t0
    # attempts 1+2 back off >= (30+60)/2 ms at minimum jitter
    assert elapsed >= 0.04, elapsed
    assert blocked >= 0.04e9, blocked


def test_retry_backoff_zero_base_disables():
    OomInjector.configure(num_ooms=2)
    set_backoff(0.0, 0.0)
    t0 = time.perf_counter()
    assert with_retry_no_split(lambda: 7) == 7
    assert time.perf_counter() - t0 < 0.5


def test_user_oom_message_not_retried():
    set_backoff(0.0, 0.0)
    calls = []

    def attempt():
        calls.append(1)
        raise RuntimeError("Out of memory in user code")

    with pytest.raises(RuntimeError, match="user code"):
        with_retry_no_split(attempt)
    assert len(calls) == 1  # no retry loop, no drain


# ---------------------------------------------------------------------------
# circuit breaker and watchdog
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    b = watchdog.CircuitBreaker(failure_threshold=2, base_backoff_s=0.05,
                                max_backoff_s=1.0)
    assert b.allow() and b.state == "closed"
    b.record_failure("E1")
    assert b.state == "closed"
    b.record_failure("E2")
    assert b.state == "open"
    assert not b.allow()  # backoff not elapsed
    time.sleep(0.06)
    assert b.allow()  # transitions to half-open, grants ONE probe
    assert b.state == "half_open"
    assert not b.allow()  # second caller waits for the probe's verdict
    b.record_failure("E3")  # probe failed: open again, doubled backoff
    assert b.state == "open"
    assert b.state_doc()["backoff_s"] == pytest.approx(0.1)
    time.sleep(0.11)
    assert b.allow()
    b.record_success()
    assert b.state == "closed"
    assert b.state_doc()["backoff_s"] == pytest.approx(0.05)


def test_breaker_half_open_reprobe_after_unrecorded_verdict():
    """A probe whose outcome is never recorded must not wedge the breaker
    half-open forever: after another backoff window a new probe is
    granted."""
    b = watchdog.CircuitBreaker(failure_threshold=1, base_backoff_s=0.05,
                                max_backoff_s=1.0)
    b.record_failure("E")
    time.sleep(0.06)
    assert b.allow()  # half-open probe granted
    assert not b.allow()  # probe in flight
    time.sleep(0.06)  # ... and its verdict never arrives
    assert b.allow()  # re-probe instead of permanent half-open
    b.record_success()
    assert b.state == "closed"


def test_watchdog_detects_wedged_dispatch():
    watchdog.uninstall_for_tests()
    wd = watchdog.DispatchWatchdog(timeout_s=0.05)
    wd.start()
    try:
        with wd.guard("device.dispatch"):
            time.sleep(0.2)
        deadline = time.time() + 2
        while wd.timeouts_reported == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert wd.timeouts_reported == 1
        with wd.guard("device.dispatch"):
            pass  # fast dispatch: no report
        time.sleep(0.1)
        assert wd.timeouts_reported == 1
        assert watchdog.breaker().state_doc()["last_error_class"] == \
            "DispatchTimeout"
    finally:
        wd.stop()
        watchdog.uninstall_for_tests()


def test_watchdog_disabled_guard_is_null():
    watchdog.uninstall_for_tests()
    assert not watchdog.active()
    with watchdog.guard("device.dispatch") as g:
        assert g is None


def test_watchdog_guards_a_wedged_query_batch():
    """End to end: a device.dispatch wedge longer than the watchdog's
    deadline is reported once and records a breaker failure; the query
    itself still answers."""
    t = _table()
    s = _session(**{"spark.rapids.watchdog.enabled": "true",
                    "spark.rapids.watchdog.dispatchTimeoutSeconds": "0.05",
                    "spark.rapids.debug.faults.wedgeSeconds": "0.3",
                    "spark.rapids.debug.faults": "device.dispatch:wedge:1"})
    out = _agg(s, t).collect()
    wd = watchdog._WATCHDOG
    assert wd is not None
    deadline = time.time() + 5
    while wd.timeouts_reported == 0 and time.time() < deadline:
        time.sleep(0.01)
    assert wd.timeouts_reported == 1
    assert watchdog.breaker().state_doc()["consecutive_failures"] == 1
    assert s.last_action_status == ("ok", None)
    assert _canon(out) == _canon(_agg(_session(), t).collect())


# ---------------------------------------------------------------------------
# graceful degradation (session layer)
# ---------------------------------------------------------------------------

def test_degrades_to_cpu_with_correct_results():
    t = _table()
    clean = _canon(_agg(_session(), t).collect())
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true",
                    "spark.rapids.debug.faults": "scan.decode:ioerror:99"})
    out = _agg(s, t).collect()
    assert _canon(out) == clean
    assert s.last_action_status == ("degraded", "InjectedFaultError")
    assert_tables_equal(out, _jax_agg(t), ignore_order=True)


def test_no_fallback_conf_raises():
    s = _session(**{"spark.rapids.debug.faults": "scan.decode:ioerror:99"})
    with pytest.raises(InjectedFaultError):
        _agg(s, _table()).collect()
    assert s.last_action_status == ("failed", None)


def test_user_semantic_error_never_degrades():
    # an ANSI arithmetic error is a USER error: it must surface even
    # with fallback on (the CPU backend would raise it identically)
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true",
                    "spark.sql.ansi.enabled": "true"})
    df = s.create_dataframe({"a": [1, 2, 3], "b": [1, 0, 2]}) \
        .select((col("a") / col("b")).alias("q"))
    with pytest.raises(SparkException):
        df.collect()
    assert s.last_action_status[0] == "failed"


def test_kernel_launch_failure_never_degrades(monkeypatch):
    """A hand kernel whose launch fails (a fake status of 700,
    cudaErrorIllegalAddress) raises a KernelError even with CPU fallback
    on: degradation never hides a kernel. The hash exchange's int32 key
    reaches the murmur3 wrapper."""
    from spark_rapids_tpu_torch.ops import _build
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK

    def failing_launch(values, seed, *args, **kwargs):
        _build.check(700, "murmur3_int32")
    monkeypatch.setattr(MK, "murmur3_int32", failing_launch)
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true"})
    t = pa.table({"k": pa.array(np.arange(64) % 5, pa.int32()),
                  "v": pa.array(np.arange(64), pa.int64())})
    df = s.create_dataframe(t, num_partitions=2).repartition(4, col("k")) \
        .group_by("k").agg(F.sum(col("v")).alias("s"))
    with pytest.raises(_build.KernelError, match="error 700"):
        df.collect()
    assert s.last_action_status == ("failed", None)
    assert watchdog.breaker().state == "closed"


def test_kernel_build_failure_never_degrades(monkeypatch, tmp_path):
    """No nvcc: the build's failure is a KernelError, which no degrade
    takes."""
    from spark_rapids_tpu_torch.ops import _build
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelError, match="nvcc not found") as ei:
        _build.nvcc_path()
    assert not TorchSession._degradable(ei.value)
    assert TorchSession._degradable(RuntimeError("a device error"))


def test_exhausted_oom_retries_degrade():
    s = _session(**{"spark.rapids.fallback.cpu.enabled": "true",
                    "spark.rapids.retry.backoffBaseMs": "0",
                    "spark.rapids.debug.faults": "retry.oom:oom:50"})
    t = _table()
    out = _agg(s, t).collect()
    assert s.last_action_status[0] == "degraded"
    assert _canon(out) == _canon(_agg(_session(), t).collect())
    assert_tables_equal(out, _jax_agg(t), ignore_order=True)


def test_breaker_opens_and_skips_device():
    watchdog.uninstall_for_tests()
    t = _table()
    s = _session(**{
        "spark.rapids.fallback.cpu.enabled": "true",
        "spark.rapids.watchdog.breakerFailureThreshold": "2",
        "spark.rapids.watchdog.breakerBaseBackoffSeconds": "60",
        "spark.rapids.debug.faults": "scan.decode:ioerror:99"})
    for _ in range(2):
        s.conf.set(C.FAULTS_SPEC, "scan.decode:ioerror:99")
        _agg(s, t).collect()
    assert watchdog.breaker().state == "open"
    # breaker open: the device path is skipped entirely; the armed fault
    # cannot fire because no scan runs on the engine
    s.conf.set(C.FAULTS_SPEC, "scan.decode:ioerror:99")
    before = faults.fault_counts().get("scan.decode", 0)
    out = _agg(s, t).collect()
    assert s.last_action_status == ("degraded", "circuit_open")
    assert faults.fault_counts().get("scan.decode", 0) == before
    assert _canon(out) == _canon(_agg(_session(), t).collect())
    assert_tables_equal(out, _jax_agg(t), ignore_order=True)


def test_breaker_half_open_probe_recovers():
    watchdog.uninstall_for_tests()
    t = _table()
    s = _session(**{
        "spark.rapids.fallback.cpu.enabled": "true",
        "spark.rapids.watchdog.breakerFailureThreshold": "1",
        "spark.rapids.watchdog.breakerBaseBackoffSeconds": "0.05",
        "spark.rapids.debug.faults": "scan.decode:ioerror:99"})
    _agg(s, t).collect()
    assert watchdog.breaker().state == "open"
    time.sleep(0.06)
    s.conf.set(C.FAULTS_SPEC, "")  # the fault "repaired itself"
    out = _agg(s, t).collect()  # half-open probe succeeds on device
    assert s.last_action_status == ("ok", None)
    assert watchdog.breaker().state == "closed"
    assert out.num_rows == 7


def test_spill_disk_fault_degrades(tmp_path):
    """The spill.disk site of the memory framework: a cache that pages
    through a host store too small to hold a partition writes to the disk
    and the write fails; with fallback on the query degrades and answers.
    (The JAX package's case of the same name drives the site through its
    serialized shuffle store, ROADMAP A10.)"""
    t = _table(20000)
    s = _session(**{"spark.rapids.memory.tpu.budgetBytes": "100000",
                    "spark.rapids.memory.host.spillStorageSize": "1024",
                    "spark.rapids.memory.spillDir": str(tmp_path),
                    "spark.rapids.fallback.cpu.enabled": "true",
                    "spark.rapids.debug.faults": "spill.disk:ioerror:99"})
    out = s.create_dataframe(t, num_partitions=4).cache() \
        .group_by("k").agg(F.sum(col("v")).alias("s")).collect()
    assert s.last_action_status == ("degraded", "InjectedFaultError")
    assert _canon(out) == _canon(_agg(_session(), t).collect())


# ---------------------------------------------------------------------------
# no leaked threads across chaos-shaped failures
# ---------------------------------------------------------------------------

def _non_service_threads():
    # the shared host pool's workers live for the process and the live
    # layer's threads are the obs layer's concern, as the JAX package's
    # test allows
    allowed = ("rapids-host-pool", "rapids-obs", "rapids-watchdog",
               "rapids-query-deadline")
    return {t.name for t in threading.enumerate()
            if not t.name.startswith(allowed)}


def test_faulted_queries_leak_no_threads():
    before = _non_service_threads()
    t = _table()
    for spec in ("scan.decode:ioerror:99", "pipeline.producer:ioerror:99",
                 "device.dispatch:oom:50"):
        s = _session(**{"spark.rapids.fallback.cpu.enabled": "true",
                        "spark.rapids.retry.backoffBaseMs": "0",
                        "spark.rapids.debug.faults": spec})
        _agg(s, t, parts=2).collect()
        assert s.last_action_status[0] in ("ok", "degraded")
    time.sleep(0.2)
    assert _non_service_threads() <= before
