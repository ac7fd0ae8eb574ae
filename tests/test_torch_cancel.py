"""The port's query lifecycle control (runtime/lifecycle.py): cooperative
cancellation through the checkpoints, deadlines, admission control, the
per-query device quota and the interruptible PrioritySemaphore.

tests/test_cancel.py's cases run against the port with the same
assertions, but for its compile choke point, pipeline refill and endpoint
cases (the port compiles no XLA programs; the pipeline and the obs
endpoint are ROADMAP A11). Where a JAX case also read the obs registry or
the attribution breakdown (A11), the port's case keeps the rest of its
assertions. Each answered query also runs through the JAX package
without faults, and the answers are compared. Every test leak-sweeps: no
stranded permits, no leaked tokens, no admission-gate occupancy.
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
from spark_rapids_tpu_torch.columnar.batch import from_arrow
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.runtime import faults, lifecycle as LC
from spark_rapids_tpu_torch.runtime.lifecycle import (
    QueryCancelledError, QueryRejectedError,
)
from spark_rapids_tpu_torch.runtime.memory import (
    SpillFramework, peek_spill_framework, reset_spill_framework,
)
from spark_rapids_tpu_torch.runtime.retry import (
    OomInjector, TpuQueryQuotaOOM, set_backoff, with_retry_no_split,
)
from spark_rapids_tpu_torch.runtime.semaphore import (
    PrioritySemaphore, peek_semaphore,
)
from spark_rapids_tpu_torch.sql import functions as F


@pytest.fixture(autouse=True)
def _leak_sweep():
    """After every test: no stranded semaphore permits or parked
    waiters, no live cancel tokens, no admission-gate occupancy. A
    gc.collect() first: a cancelled query's traceback pins its generator
    frames until the cyclic collector runs, and those frames hold task
    contexts whose completion releases permits. The sweep reaps and
    retries before declaring a leak: a cancelled query's thread may still
    be unwinding when its test returns."""
    reset_torch_runtime()
    yield
    import gc

    def _clean():
        gc.collect()
        sem = peek_semaphore()
        if sem is not None:
            if sem.available != sem.permits or sem.waiting != 0:
                return f"semaphore: available={sem.available}/" \
                       f"{sem.permits} waiting={sem.waiting}"
        if LC.token_ids():
            return f"cancel tokens: {LC.token_ids()}"
        gd = LC.gate().doc()
        if gd["active"] != 0 or gd["queued"] != 0:
            return f"admission gate: {gd}"
        return None

    leak = _clean()
    deadline = time.monotonic() + 45.0
    while leak is not None and time.monotonic() < deadline:
        time.sleep(0.1)
        leak = _clean()
    if leak is not None:
        import faulthandler
        faulthandler.dump_traceback()
    reset_torch_runtime()
    assert leak is None, f"stable leak after reap-and-retry: {leak}"


def _table(rows=20000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 7, rows),
        "v": rng.integers(-1000, 1000, rows),
    })


def _session(conf=None):
    return TorchSession(conf, device="cpu")


def _slow_session(delay_count=60, delay_ms=40, **conf):
    """A session whose scans sleep per batch (scan.decode delay faults):
    deterministic slowness with many checkpoint passes in between."""
    base = {
        "spark.rapids.sql.reader.batchSizeRows": "512",
        "spark.rapids.debug.faults": f"scan.decode:delay:{delay_count}",
        "spark.rapids.debug.faults.delayMs": str(delay_ms),
    }
    base.update(conf)
    return _session(base)


def _agg(sess, t, parts=2):
    return sess.create_dataframe(t, num_partitions=parts) \
        .group_by("k").agg(F.sum(col("v")).alias("s"))


def _jax_agg(t, parts=2, cache=False):
    """The same program through the JAX package, without faults."""
    from spark_rapids_tpu.expr.core import col as jcol
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSession
    df = TpuSession({"spark.rapids.sql.reader.batchSizeRows": "512"}) \
        .create_dataframe(t, num_partitions=parts)
    if cache:
        df = df.cache()
    return df.group_by("k").agg(JF.sum(jcol("v")).alias("s")).collect()


def _canon(table):
    return sorted(table.to_pylist(), key=repr)


def _run_async(df, **kw):
    """Start df.collect() on a thread; returns (thread, box) where box
    captures ('ok', result) or ('raised', exc)."""
    box = {}

    def run():
        try:
            box["result"] = df.collect(**kw)
            box["outcome"] = "ok"
        except BaseException as e:  # noqa: BLE001 - the test inspects it
            box["error"] = e
            box["outcome"] = "raised"

    th = threading.Thread(target=run)
    th.start()
    return th, box


def _wait_for(cond, timeout=10.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _cancel_when_running(sess, reason="user"):
    """Wait for a token to appear, then cancel it. Returns (qid, t0)."""
    _wait_for(lambda: LC.token_ids(), what="a live query token")
    qid = LC.token_ids()[0]
    t0 = time.monotonic()
    assert sess.cancel(qid, reason=reason)
    return qid, t0


# ---------------------------------------------------------------------------
# external cancel through the per-batch checkpoints
# ---------------------------------------------------------------------------

def test_cancel_mid_scan_unwinds_with_cancelled_status():
    sess = _slow_session()
    th, box = _run_async(_agg(sess, _table()))
    _wait_for(lambda: LC.token_ids(), what="token")
    time.sleep(0.15)  # let the scan get properly under way
    qid = LC.token_ids()[0]
    t0 = time.monotonic()
    assert sess.cancel(qid)
    th.join(10)
    assert box["outcome"] == "raised"
    assert isinstance(box["error"], QueryCancelledError)
    # prompt: the delay fault sleeps 40ms/batch, so a handful of batch
    # boundaries bounds the cancel->terminal latency
    assert time.monotonic() - t0 < 5.0
    assert sess.last_action_status == ("cancelled", "user")


def test_cancel_is_not_degradable_even_with_fallback_on():
    """A cancelled query must NOT re-execute on the CPU backend: that
    would resurrect exactly the work the user killed."""
    sess = _slow_session(**{"spark.rapids.fallback.cpu.enabled": "true"})
    th, box = _run_async(_agg(sess, _table()))
    _cancel_when_running(sess)
    th.join(10)
    assert box["outcome"] == "raised"
    assert isinstance(box["error"], QueryCancelledError)
    assert sess.last_action_status[0] == "cancelled"


def test_double_cancel_idempotent_and_cancel_after_finish_noop():
    sess = _slow_session(delay_count=20, delay_ms=30)
    th, box = _run_async(_agg(sess, _table()))
    qid, _ = _cancel_when_running(sess)
    assert not sess.cancel(qid), "second cancel must be a no-op"
    th.join(10)
    assert box["outcome"] == "raised"
    # after the terminal state, the token is gone: cancel is a no-op
    assert not sess.cancel(qid)
    # and a finished query's id stays a no-op too
    t = _table(2000)
    r = _agg(_session(), t).collect()
    assert len(_canon(r)) == 7
    assert_tables_equal(r, _jax_agg(t), ignore_order=True)
    assert not sess.cancel(LC._LOCAL_SEQ - 1)


def test_fault_injected_cancel_at_checkpoint():
    """A `query.cancel:cancel` schedule delivers the cancel at the Nth
    checkpoint pass. The port coalesces the scan's batches before the
    aggregate (one update, one checkpoint); a 1-byte coalesce target
    keeps the JAX package's one device dispatch per source batch."""
    sess = _session({
        "spark.rapids.sql.reader.batchSizeRows": "512",
        "spark.rapids.sql.batchSizeBytes": "1",
        "spark.rapids.debug.faults": "query.cancel:cancel:1,25",
    })
    with pytest.raises(QueryCancelledError):
        _agg(sess, _table()).collect()
    assert sess.last_action_status == ("cancelled", "fault")


def test_cancelled_query_counters_and_task_rollup():
    """The cancelled path lands in the lifecycle's cancel counter and
    latency record, and the query's tasks still sum their accumulators
    (the JAX case reads the obs registry's counters: ROADMAP A11)."""
    sess = _slow_session()
    c0 = LC.doc()["cancelled"]
    th, box = _run_async(_agg(sess, _table(), parts=4))
    _wait_for(lambda: LC.token_ids(), what="token")
    time.sleep(0.2)  # partitions running as wave tasks
    qid = LC.token_ids()[0]
    sess.cancel(qid)
    th.join(10)
    assert box["outcome"] == "raised"
    assert LC.doc()["cancelled"] == c0 + 1
    assert any(q == qid and reason == "user"
               for q, reason, _ in LC.cancel_latencies())
    assert sess.last_task_metrics().get("semaphoreHoldTime", 0) > 0


def test_cancel_mid_retry_backoff_wakes_immediately():
    """The cancellation-aware backoff sleep: a cancel mid-backoff wakes
    the sleeper instead of letting it finish a multi-second delay."""
    set_backoff(5000.0, 5000.0)  # 5s per backoff: a poll would be slow
    OomInjector.configure(4)
    tok = LC.begin_action(None, C.RapidsConf())
    try:
        threading.Timer(0.25, tok.cancel, args=("user",)).start()
        t0 = time.monotonic()
        with pytest.raises(QueryCancelledError):
            with_retry_no_split(lambda: 1)
        assert time.monotonic() - t0 < 2.0, \
            "cancel did not interrupt the backoff sleep"
    finally:
        LC.finish_action(tok, "cancelled")
        OomInjector.configure(0)
        set_backoff(10.0, 500.0)


def test_wave_start_checkpoint_unwinds_cancelled_partitions():
    """A task wave of a cancelled query: every partition still queued
    behind the wave's first tasks unwinds at its start checkpoint."""
    from spark_rapids_tpu_torch.runtime.host_pool import run_task_wave
    tok = LC.begin_action(None, C.RapidsConf())
    started = []
    try:
        def task(i):
            started.append(i)
            if i == 0:
                tok.cancel("user")
            time.sleep(0.05)
            return i

        with pytest.raises(QueryCancelledError):
            run_task_wave(task, range(40), max_concurrency=2)
        assert len(started) < 40
    finally:
        LC.finish_action(tok, "cancelled")


# ---------------------------------------------------------------------------
# the interruptible semaphore
# ---------------------------------------------------------------------------

def test_semaphore_cancel_parked_waiter():
    sem = PrioritySemaphore(1)
    sem.acquire(1)
    tok = LC.CancelToken(101)
    errs = []

    def waiter():
        try:
            sem.acquire(1, cancel_token=tok)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    _wait_for(lambda: sem.waiting == 1, what="parked waiter")
    tok.cancel("user")
    th.join(5)
    assert len(errs) == 1 and isinstance(errs[0], QueryCancelledError)
    assert sem.waiting == 0, "abandoned heap entry left behind"
    sem.release(1)
    assert sem.available == 1, "cancelled waiter stranded permits"


def test_semaphore_cancelled_after_grant_refunds_permits():
    """The race where the grant and the cancel both fire: the waiter
    must refund its reserved permits and re-run the handoff."""
    sem = PrioritySemaphore(1)
    sem.acquire(1)
    tok = LC.CancelToken(102)
    tok.cancel("user")  # already cancelled before the wakeup
    errs = []

    def waiter():
        try:
            sem.acquire(1, cancel_token=tok)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    _wait_for(lambda: sem.waiting == 1 or errs, what="waiter progress")
    sem.release(1)
    th.join(5)
    assert len(errs) == 1 and isinstance(errs[0], QueryCancelledError)
    assert sem.available == 1, "granted-then-cancelled waiter kept permits"
    assert sem.waiting == 0


def test_semaphore_abandoned_waiter_regression():
    """A waiter whose thread dies while queued (an injected
    semaphore.wait ioerror) must not leave its heap entry at the head,
    blocking every later waiter."""
    sem = PrioritySemaphore(1)
    sem.acquire(1)
    faults.configure("semaphore.wait:ioerror")
    died = []

    def doomed():
        try:
            sem.acquire(1, priority=5)  # high priority: heap HEAD
        except BaseException as e:  # noqa: BLE001
            died.append(e)

    t1 = threading.Thread(target=doomed)
    t1.start()
    t1.join(5)
    assert died and isinstance(died[0], faults.InjectedFaultError)
    assert sem.waiting == 0, "dead waiter's heap entry not removed"
    faults.configure("")
    got = []
    t2 = threading.Thread(target=lambda: (sem.acquire(1), got.append(1)))
    t2.start()
    _wait_for(lambda: sem.waiting == 1, what="second waiter parked")
    sem.release(1)  # must reach the LIVE waiter, not the dead entry
    t2.join(5)
    assert got == [1], "queue did not drain past the abandoned entry"
    sem.release(1)


def test_semaphore_nested_task_runs_under_parent_permit():
    """A task nested on the thread of a task holding a permit (a cache
    or an exchange materialized inside it) is covered by that permit;
    a task giving its permit back before it blocks frees it."""
    from spark_rapids_tpu_torch.runtime.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    sem = TpuSemaphore(1)
    with TaskContext() as outer:
        sem.acquire_if_necessary(outer)
        assert sem.available == 0
        with TaskContext() as inner:
            assert inner.parent is outer
            sem.acquire_if_necessary(inner)  # no second permit: no park
            assert sem.held() == 1
        assert TaskContext.peek() is outer
        sem.release_for_wait(outer)
        assert sem.available == 1
        sem.acquire_if_necessary(outer)
    assert sem.available == 1 and sem.held() == 0


def test_late_pipeline_producer_takes_no_permit_for_a_completed_task():
    """A pipeline producer still inside its source when the consumer's
    task unwound (a deadline fired mid-scan) reaches the scan's acquire
    for a task that has completed: it takes no permit, since nothing
    would give it back. A callback registered on a completed task runs
    at once (ROADMAP C25)."""
    from spark_rapids_tpu_torch.runtime.pipeline import PipelinedIterator
    from spark_rapids_tpu_torch.runtime.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    sem = TpuSemaphore(1)
    gate, reached = threading.Event(), threading.Event()

    def source():
        yield 1
        gate.wait(10)
        sem.acquire_if_necessary(TaskContext.peek())  # the scan's _acquire
        reached.set()
        yield 2

    with TaskContext() as ctx:
        sem.acquire_if_necessary(ctx)
        pit = PipelinedIterator(source(), depth=1, ctx=ctx)
        assert next(iter(pit)) == 1
    assert sem.available == 1
    gate.set()
    assert reached.wait(10)
    pit.close()
    assert sem.available == 1 and sem.held() == 0
    ran = []
    ctx.on_completion(lambda: ran.append("late"))
    assert ran == ["late"]


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_fires_and_records_attribution():
    """The attribution breakdown the JAX case also reads is ROADMAP A11;
    the deadline's cancel and the query's task totals remain."""
    sess = _slow_session()
    with pytest.raises(QueryCancelledError) as ei:
        _agg(sess, _table()).collect(timeout_seconds=0.3)
    assert ei.value.reason == "deadline"
    assert sess.last_action_status == ("cancelled", "deadline")
    assert sess.last_task_metrics().get("semaphoreHoldTime", 0) > 0


def test_deadline_conf_applies_and_override_wins():
    sess = _slow_session(
        **{"spark.rapids.query.timeoutSeconds": "0.3"})
    with pytest.raises(QueryCancelledError):
        _agg(sess, _table()).collect()
    # a generous per-action override outlives the conf deadline
    sess2 = _slow_session(
        delay_count=3, delay_ms=20,
        **{"spark.rapids.query.timeoutSeconds": "0.05"})
    t = _table(2000)
    r = _agg(sess2, t).collect(timeout_seconds=30.0)
    assert len(_canon(r)) == 7
    assert sess2.last_action_status[0] == "ok"
    assert_tables_equal(r, _jax_agg(t), ignore_order=True)


def test_orphaned_worker_checkpoint_raises_after_finish_action():
    """finish_action pops the token before a cancelled query's workers
    unwind; the tombstone ring makes an orphan's checkpoint raise, while
    the finishing thread itself stays exempt."""
    tok = LC.begin_action(31337, C.RapidsConf())
    tok.cancel("deadline")
    prev = LC.bind(31337)
    try:
        LC.finish_action(tok, "cancelled")
        LC.check_current()
    finally:
        LC.bind(prev)
    box = {}

    def orphan():
        LC.bind(31337)
        try:
            LC.check_current()
            box["outcome"] = "silent"
        except QueryCancelledError as e:
            box["outcome"] = "raised"
            box["reason"] = e.reason
        finally:
            LC.bind(None)

    th = threading.Thread(target=orphan)
    th.start()
    th.join(5)
    assert box["outcome"] == "raised"
    assert box["reason"] == "deadline"
    # an uncancelled finished query leaves no tombstone
    tok2 = LC.begin_action(31338, C.RapidsConf())
    LC.finish_action(tok2, "ok")
    prev = LC.bind(31338)
    try:
        LC.check_current()
    finally:
        LC.bind(prev)


def test_tombstone_ring_is_bounded():
    for i in range(200):
        tok = LC.begin_action(40000 + i, C.RapidsConf())
        tok.cancel("user")
        LC.finish_action(tok, "cancelled")
    assert len(LC._TOMBSTONES) <= LC._TOMBSTONE_CAP
    # newest entries survive, oldest were evicted
    assert 40199 in LC._TOMBSTONES and 40000 not in LC._TOMBSTONES


def test_sweeper_stop_is_per_generation():
    """Each sweeper generation owns its stop event, so a stopped
    generation can never be revived by the next one's start."""
    tok = LC.begin_action(None, C.RapidsConf(), timeout_seconds=30)
    old_sweeper, old_stop = LC._SWEEPER, LC._SWEEPER_STOP
    assert old_sweeper is not None and old_sweeper.is_alive()
    old_stop.set()
    LC.finish_action(tok, "ok")
    tok2 = LC.begin_action(None, C.RapidsConf(), timeout_seconds=30)
    try:
        assert LC._SWEEPER is not old_sweeper
        assert LC._SWEEPER_STOP is not old_stop
        assert old_stop.is_set()
        _wait_for(lambda: not old_sweeper.is_alive(), timeout=5,
                  what="old sweeper generation exit")
        assert LC._SWEEPER.is_alive()
    finally:
        LC.finish_action(tok2, "ok")


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_gate_fifo_order_and_rejection():
    gate = LC.AdmissionGate()
    gate.configure(limit=1, max_queued=2, timeout_s=10.0)
    t1 = LC.CancelToken(1)
    gate.acquire(t1)
    order = []

    def queued(tok, name):
        gate.acquire(tok)
        order.append(name)

    t2, t3 = LC.CancelToken(2), LC.CancelToken(3)
    th2 = threading.Thread(target=queued, args=(t2, "second"))
    th2.start()
    _wait_for(lambda: gate.doc()["queued"] == 1, what="first queue entry")
    th3 = threading.Thread(target=queued, args=(t3, "third"))
    th3.start()
    _wait_for(lambda: gate.doc()["queued"] == 2, what="second queue entry")
    with pytest.raises(QueryRejectedError, match="queue full"):
        gate.acquire(LC.CancelToken(4))
    gate.release(t1)
    th2.join(5)
    gate.release(t2)
    th3.join(5)
    gate.release(t3)
    assert order == ["second", "third"], "admission order not FIFO"


def test_admission_limit_raise_grants_queued_heads():
    gate = LC.AdmissionGate()
    gate.configure(limit=1, max_queued=4, timeout_s=10.0)
    t1 = LC.CancelToken(21)
    gate.acquire(t1)
    admitted = []

    def queued(tok):
        gate.acquire(tok)
        admitted.append(tok.query_id)

    t2, t3 = LC.CancelToken(22), LC.CancelToken(23)
    ths = [threading.Thread(target=queued, args=(t,)) for t in (t2, t3)]
    for th in ths:
        th.start()
    _wait_for(lambda: gate.doc()["queued"] == 2, what="two queued")
    gate.configure(limit=3, max_queued=4, timeout_s=10.0)
    for th in ths:
        th.join(5)
    assert sorted(admitted) == [22, 23], \
        "raised limit did not grant the parked queue heads"
    for t in (t1, t2, t3):
        gate.release(t)
    assert gate.doc()["active"] == 0


def test_deadline_sweeper_exits_when_idle_and_rearms():
    conf = C.RapidsConf({"spark.rapids.query.timeoutSeconds": "30"})
    tok = LC.begin_action(None, conf)
    sweeper = LC._SWEEPER
    assert sweeper is not None and sweeper.is_alive()
    LC.finish_action(tok, "ok")
    _wait_for(lambda: not sweeper.is_alive(), timeout=5,
              what="idle sweeper exit")
    tok2 = LC.begin_action(None, C.RapidsConf(), timeout_seconds=0.15)
    try:
        assert LC._SWEEPER is not None and LC._SWEEPER.is_alive()
        _wait_for(lambda: tok2.cancelled, timeout=5,
                  what="re-armed sweeper deadline")
        assert tok2.reason == "deadline"
    finally:
        LC.finish_action(tok2, "cancelled")


def test_admission_queue_wait_timeout_rejects():
    gate = LC.AdmissionGate()
    gate.configure(limit=1, max_queued=4, timeout_s=0.2)
    t1 = LC.CancelToken(11)
    gate.acquire(t1)
    with pytest.raises(QueryRejectedError, match="queue wait"):
        gate.acquire(LC.CancelToken(12))
    gate.release(t1)
    assert gate.doc() == {"limit": 1, "active": 0, "queued": 0}


def test_cancel_while_queued_for_admission_end_to_end():
    sess = _slow_session(**{
        "spark.rapids.query.maxConcurrent": "1",
        "spark.rapids.query.maxQueued": "4",
    })
    df = _agg(sess, _table())
    tha, boxa = _run_async(df)
    _wait_for(lambda: len(LC.token_ids()) == 1, what="first query")
    thb, boxb = _run_async(df)
    _wait_for(lambda: LC.gate().doc()["queued"] == 1,
              what="second query queued")
    # the live registry's ids count up: the younger token is the queued
    # one, shown in the `queued` state while it waits
    qb = max(LC.token_ids())
    from spark_rapids_tpu_torch.runtime.obs import live
    qcb = live.get(qb)
    assert qcb is not None and qcb.state == "queued"
    assert sess.cancel(qb)
    thb.join(10)
    assert boxb["outcome"] == "raised"
    assert isinstance(boxb["error"], QueryCancelledError)
    # the running query is untouched by its neighbor's cancellation
    sess.cancel(min(LC.token_ids() or [0]))  # now cancel A too (speed)
    tha.join(15)
    assert boxa["outcome"] in ("ok", "raised")


def test_max_concurrent_serializes_queries():
    sess = _session({
        "spark.rapids.sql.reader.batchSizeRows": "512",
        "spark.rapids.query.maxConcurrent": "1",
        "spark.rapids.debug.faults": "scan.decode:delay:6",
        "spark.rapids.debug.faults.delayMs": "40",
    })
    t = _table(4000)
    df = _agg(sess, t)
    results = []
    windows = []
    lock = threading.Lock()

    def run():
        t0 = time.monotonic()
        r = df.collect()
        with lock:
            windows.append((t0, time.monotonic()))
            results.append(_canon(r))

    threads = [threading.Thread(target=run) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert len(windows) == 3 and len(results) == 3
    windows.sort()
    for (s1, e1), (s2, _e2) in zip(windows, windows[1:]):
        assert s2 >= s1, "window ordering broken"
    assert LC.gate().doc()["active"] == 0
    want = _canon(_jax_agg(t))
    assert all(r == want for r in results)


# ---------------------------------------------------------------------------
# per-query device quota
# ---------------------------------------------------------------------------

def _int_batch(n=4096):
    return from_arrow(pa.table({"a": np.arange(n)}), "cpu")


def _quota_token(budget_bytes):
    conf = C.RapidsConf({
        "spark.rapids.query.deviceBudgetBytes": str(budget_bytes)})
    return LC.begin_action(None, conf)


def test_query_quota_spills_own_handles_only():
    reset_spill_framework()
    fw = SpillFramework(1 << 30, 1 << 30)
    size = _int_batch().device_memory_size()
    # neighbor query B: no quota, two resident handles
    tok_b = LC.begin_action(None, C.RapidsConf())
    hb1 = fw.register(_int_batch())
    hb2 = fw.register(_int_batch())
    LC.finish_action(tok_b, "ok")
    # query A: quota fits ~2.5 handles; the third registration must
    # spill one of A's OWN handles, never B's
    tok_a = _quota_token(int(size * 2.5))
    try:
        ha1 = fw.register(_int_batch())
        ha2 = fw.register(_int_batch())
        ha3 = fw.register(_int_batch())
        a_tiers = sorted(h.tier for h in (ha1, ha2, ha3))
        assert a_tiers == ["device", "device", "host"], \
            f"quota did not self-spill exactly one own handle: {a_tiers}"
        assert hb1.tier == "device" and hb2.tier == "device", \
            "quota pressure evicted a NEIGHBOR query's batches"
        assert fw.device_bytes_held(query_id=tok_a.query_id) \
            <= int(size * 2.5)
        for h in (ha1, ha2, ha3):
            h.close()
    finally:
        LC.finish_action(tok_a, "ok")
        hb1.close()
        hb2.close()
        reset_spill_framework()


def test_query_quota_oom_drains_own_query_in_retry():
    """TpuQueryQuotaOOM through with_retry drains ONLY the offending
    query's handles (drain_query, not drain_all)."""
    reset_spill_framework()
    from spark_rapids_tpu_torch.runtime.memory import get_spill_framework
    fw = get_spill_framework()  # the retry loop drains THE process fw
    tok_b = LC.begin_action(None, C.RapidsConf())
    hb = fw.register(_int_batch(2048))
    LC.finish_action(tok_b, "ok")
    tok_a = LC.begin_action(None, C.RapidsConf())
    ha = fw.register(_int_batch(2048))
    fired = []

    def attempt():
        if not fired:
            fired.append(1)
            raise TpuQueryQuotaOOM("over quota", query_id=tok_a.query_id)
        return "done"

    try:
        import unittest.mock as mock
        with mock.patch.object(
                SpillFramework, "drain_all",
                side_effect=AssertionError(
                    "quota OOM must not drain neighbors")):
            assert with_retry_no_split(attempt) == "done"
        assert ha.tier == "host", "own handle not drained on quota OOM"
        assert hb.tier == "device", "neighbor drained on quota OOM"
    finally:
        LC.finish_action(tok_a, "ok")
        ha.close()
        hb.close()
        reset_spill_framework()


def test_quota_isolation_end_to_end(monkeypatch):
    """A query exceeding its deviceBudgetBytes spills itself to
    completion while a concurrent under-budget query's answer and device
    dispatch count match its solo run, and every spill victim belongs to
    the over-quota query."""
    from spark_rapids_tpu_torch.exec import nodes as X
    from spark_rapids_tpu_torch.runtime.memory import SpillableHandle
    reset_spill_framework()
    t_small = _table(6000, seed=1)
    t_big = _table(30000, seed=2)

    dispatches = {}  # query_id -> batches of device work
    dlock = threading.Lock()
    orig_dispatch = X.TorchExec._dispatch

    def counted():
        qid = LC.current_query_id()
        with dlock:
            dispatches[qid] = dispatches.get(qid, 0) + 1
        return orig_dispatch()

    spilled_qids = []
    orig_spill = SpillableHandle.spill_to_host

    def tracked_spill(self):
        freed = orig_spill(self)
        if freed:
            spilled_qids.append(self.query_id)
        return freed

    sess_b = _session({"spark.rapids.sql.reader.batchSizeRows": "1024"})
    df_b = sess_b.create_dataframe(t_small, num_partitions=2).cache() \
        .group_by("k").agg(F.sum(col("v")).alias("s"))
    # warm B (the cache materializes), then measure B's solo profile
    rb = _canon(df_b.collect())
    fw = peek_spill_framework()
    b_handle_ids = set(fw._handles)
    monkeypatch.setattr(X.TorchExec, "_dispatch", staticmethod(counted))
    monkeypatch.setattr(SpillableHandle, "spill_to_host", tracked_spill)
    df_b.collect()
    _wait_for(lambda: not LC.token_ids(), what="B solo drained")
    solo_counts = [v for v in dispatches.values() if v]
    assert len(solo_counts) == 1
    solo_dispatches = solo_counts[0]
    dispatches.clear()

    # A: cached big table under a quota that fits ~1.6 of its 4
    # per-partition cache batches: materialization must self-spill
    per_part = from_arrow(t_big, "cpu").device_memory_size() // 4
    sess_a = _session({
        "spark.rapids.sql.reader.batchSizeRows": "1024",
        "spark.rapids.query.deviceBudgetBytes": str(int(per_part * 1.6))})
    df_a = sess_a.create_dataframe(t_big, num_partitions=4).cache() \
        .group_by("k").agg(F.sum(col("v")).alias("s"))

    tha, boxa = _run_async(df_a)
    _wait_for(lambda: LC.token_ids(), what="A's token")
    qid_a = LC.token_ids()[0]
    thb, boxb = _run_async(df_b)
    tha.join(60)
    thb.join(60)
    assert boxa["outcome"] == "ok", boxa.get("error")
    assert boxb["outcome"] == "ok", boxb.get("error")
    assert _canon(boxb["result"]) == rb, \
        "neighbor query's results changed under quota pressure"
    assert spilled_qids, "over-quota query never spilled itself"
    assert set(spilled_qids) == {qid_a}, \
        f"spill victims outside the over-quota query: {spilled_qids}"
    fw = peek_spill_framework()
    b_handles = [h for hid, h in fw._handles.items() if hid in b_handle_ids]
    assert b_handles and all(h.tier == "device" for h in b_handles), \
        f"neighbor batches evicted: {[h.tier for h in b_handles]}"
    qid_b = [q for q in dispatches if q != qid_a and q is not None]
    assert len(qid_b) == 1
    assert dispatches[qid_b[0]] == solo_dispatches, \
        (f"B's dispatch count changed under quota contention: "
         f"solo={solo_dispatches} concurrent={dispatches[qid_b[0]]}")
    assert_tables_equal(boxa["result"], _jax_agg(t_big, 4, cache=True),
                        ignore_order=True)
    assert_tables_equal(boxb["result"], _jax_agg(t_small, 2, cache=True),
                        ignore_order=True)
    reset_spill_framework()
