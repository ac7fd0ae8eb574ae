"""The session: entry point of the PyTorch engine.

Counterpart of ``spark_rapids_tpu/sql/session.py`` ``TpuSession``
(``create_dataframe``, ``range``, the readers: ``read_parquet`` with hive
partition discovery, ``read_csv``, ``read_json``, ``read_avro`` and
``read_orc``; the SQL front door:
``create_or_replace_temp_view``, ``table`` and ``sql``, ``collect``,
``last_aqe`` and ``explain_aqe``, the reports ``last_plan_explain``,
``last_attribution`` and ``explain_analyze``, and the device-side
compaction of sparse results before the download).
``collect`` tags the plan and converts it (``plan/overrides.py``): what
is tagged off the device runs one operator at a time on the CPU backend.
spark.rapids.sql.explain=NOT_ON_TPU|ALL logs the placement report, and
spark.rapids.sql.mode=explainOnly tags, logs and answers with the CPU
backend alone.

The action flow is the JAX package's (its session.py:229-273, :290-540):
``prepare_execution`` arms the runtime (fault injection, retry backoff,
the dispatch watchdog and breaker, the spill budgets), a top-level
``collect`` registers a cancel token and passes admission
(``runtime/lifecycle.py``), the partitions run as a task wave
(``run_partitions``), and with spark.rapids.fallback.cpu.enabled a device
failure degrades to the CPU backend. ``last_metrics()`` is every
operator's metrics of the last action; with spark.rapids.sql.trace.enabled
each action writes its trace (``runtime/trace.py``), whose paths are
``last_trace_paths``.

The live layer (``runtime/obs``, on by default) installs with the first
session: a top-level action takes a positive query id from
``obs.on_query_start`` and walks the live states (queued, planning,
executing, finishing, then its status), its exec tree attaches to the
live context in ``prepare_execution`` (``running_queries()``), and the
epilogue publishes it with ``obs.on_query_end``, after a flight dump when
the action failed, degraded or was cancelled.

Every top-level action also folds its wall time into the attribution
buckets (``runtime/obs/attribution.py``: ``last_attribution()``, the
``rapids_query_seconds_bucket`` counter) from host-clock timers only, so
the default epilogue reads nothing off the card. With
spark.rapids.obs.historyDir set it appends the JAX package's history
record (``runtime/obs/history.py``), and the measured cost pass
(``plan/cost.measured_hints``) reads those records back into planning
in ``prepare_execution``. With spark.rapids.obs.audit.enabled the kernel
cost auditor (``analysis/kernel_audit.py``) tallies the action's
dispatches and the epilogue joins them with the attribution into
``last_audit()`` and ``last_roofline()``. spark.rapids.compile.cacheDir
moves the kernel libraries' build directory, spark.rapids.compile.warmup.*
arms the history replays (``runtime/warmup.py``), and
spark.rapids.profile.dir runs each top-level action under
``torch.profiler`` (``last_profile_path``).
"""
from __future__ import annotations

import glob
import logging
import os
import threading
from typing import Dict, List, Optional

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.exec import adaptive as AQ
from spark_rapids_tpu_torch.exec.cpu_backend import execute_cpu
from spark_rapids_tpu_torch.exec.nodes import empty_table, host_table
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.plan.overrides import (
    convert_plan, localize_plan, wrap_and_tag,
)
from spark_rapids_tpu_torch.runtime import trace as TR
from spark_rapids_tpu_torch.runtime.metrics import walk_exec_tree
from spark_rapids_tpu_torch.sql.dataframe import DataFrame

_LOG = logging.getLogger("spark_rapids_tpu_torch")


def _discover_hive(root: str):
    """Walk a directory for hive-layout partitions (``k=v`` directories):
    (files, each file's partition values) or (files, None) when the
    layout is flat (reference: Spark's PartitioningAwareFileIndex). A
    value ``__HIVE_DEFAULT_PARTITION__`` is null, the others are
    URL-unescaped; Parquet files in a directory that is not a partition
    raise."""
    from urllib.parse import unquote
    files, vals = [], []
    found_parts = False
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        rel = os.path.relpath(dirpath, root)
        parts = {}
        if rel != ".":
            for seg in rel.split(os.sep):
                if "=" not in seg:
                    if any(f.endswith(".parquet") for f in filenames):
                        raise ValueError(
                            f"mixed layout under {root!r}: parquet files in "
                            f"non-partition directory {dirpath!r}")
                    parts = None
                    break
                k, _, v = seg.partition("=")
                parts[k] = (None if v == "__HIVE_DEFAULT_PARTITION__"
                            else unquote(v))
            if parts:
                found_parts = True
        if parts is None:
            continue
        for f in sorted(filenames):
            if f.endswith(".parquet") and not f.startswith("_"):
                files.append(os.path.join(dirpath, f))
                vals.append(parts)
    if not files:
        raise FileNotFoundError(f"no parquet files under {root!r}")
    return files, (vals if found_parts else None)

#: per-thread collect nesting depth: only a top-level action (depth 0 at
#: entry) opens and closes the adaptive decision list
_COLLECT_DEPTH = threading.local()

#: per-action profile captures written by this process (file names)
_PROFILE_SEQ = [0]


def nested_action_scope():
    """Make every collect on the current thread a nested action: no
    cancel token or admission, no attribution open/close, no breaker
    probe, no degradation. The warmup replays run under this."""
    import contextlib

    @contextlib.contextmanager
    def _cm():
        depth = getattr(_COLLECT_DEPTH, "d", 0)
        _COLLECT_DEPTH.d = depth + 1
        try:
            yield
        finally:
            _COLLECT_DEPTH.d = depth

    return _cm()


class TorchSession:
    """Runs DataFrame queries on one device: the CUDA card by default, the
    CPU when ``device="cpu"`` (kernels then run their plain versions).
    Asking for the card where none is available raises."""

    def __init__(self, conf: Optional[Dict] = None, device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchSession(device='cuda'): no CUDA device "
                               "is available; pass device='cpu' to run on "
                               "the CPU")
        self.conf = C.RapidsConf(conf)
        #: the root operator of the last collect, for reading its counters,
        #: and its tagged plan (``SparkPlanMeta``: placement and reasons)
        self.last_exec = None
        self.last_meta = None
        self._views: Dict[str, DataFrame] = {}
        self._last_aqe: Optional[dict] = None
        #: the last top-level action's attribution doc, its direct-record
        #: aggregate (bucket -> ns) and its wall time
        self._last_attribution: Optional[dict] = None
        self._last_attr_extra: Optional[Dict[str, int]] = None
        self._last_duration_ns = 0
        #: (status, reason) of the last top-level action
        self.last_action_status = None
        self._last_task_metrics: Dict[str, int] = {}
        #: the stats of the last ``df.write`` (io/writer.WriteStats)
        self.last_write_stats: Optional[dict] = None
        #: the artifacts of the last traced action ({"trace", "events",
        #: "metrics"} paths), None when it wrote none
        self.last_trace_paths: Optional[Dict[str, str]] = None
        #: the kernel cost audit and the roofline of the last top-level
        #: action (spark.rapids.obs.audit.enabled), else None
        self._last_audit: Optional[dict] = None
        self._last_roofline: Optional[dict] = None
        #: the Chrome trace of the last action profiled under
        #: spark.rapids.profile.dir
        self.last_profile_path: Optional[str] = None
        # live observability (spark.rapids.obs.*): the process-wide
        # registry, flight recorder and sampler, the endpoint when
        # spark.rapids.obs.port is set (its probe on this device)
        from spark_rapids_tpu_torch.runtime import obs
        obs.install(self.conf, self.device)
        # the kernel build directory and warmup (spark.rapids.compile.*);
        # the auditor arms now, so a session's first query is audited
        from spark_rapids_tpu_torch.analysis import kernel_audit
        from spark_rapids_tpu_torch.runtime import compile_cache, warmup
        compile_cache.configure(self.conf)
        kernel_audit.configure(self.conf)
        warmup.maybe_arm(self)
        # the serving layer (spark.rapids.serving.*): POST /sql on the obs
        # endpoint, the result cache, the warm-boot wait. Installs after
        # warmup arms, so a warm-boot server can wait on the replay
        from spark_rapids_tpu_torch.runtime import serving
        serving.maybe_install(self)

    def _activate(self) -> None:
        """Make this session's conf the thread's, as the JAX package's
        sources do: what is built next (a ``udf``'s compile decision,
        name binding) reads it."""
        C.set_session_conf(self.conf)

    # -- the SQL front door ------------------------------------------------
    def create_or_replace_temp_view(self, name: str, df: DataFrame) -> None:
        """Register a DataFrame for ``sql`` FROM resolution (names are
        case-insensitive). Registering advances the table epoch, which
        empties the cross-query broadcast build cache."""
        self._views[name.lower()] = df
        AQ.bump_table_version()
        # a new table may unblock pending warmup replays (one
        # module-global read when warmup is unarmed)
        from spark_rapids_tpu_torch.runtime import warmup
        warmup.notify_view_registered(self)

    createOrReplaceTempView = create_or_replace_temp_view

    def table(self, name: str) -> DataFrame:
        if name.lower() not in self._views:
            raise SparkException(f"table or view not found: {name}")
        return self._views[name.lower()]

    def sql(self, query: str) -> DataFrame:
        """A SQL string over the registered temp views (the grammar of
        ``sql/parser.py``). An uncorrelated scalar subquery runs here, on
        this session's device."""
        from spark_rapids_tpu_torch.sql.parser import parse_sql
        self._activate()
        df = parse_sql(query, self)
        try:
            # the live registry and the history record carry the SQL text
            df.plan._sql_text = query
        except Exception:  # noqa: BLE001 - a slotted plan node just
            pass  # carries no text
        return df

    def create_dataframe(self, data, num_partitions: int = 1) -> DataFrame:
        self._activate()
        if isinstance(data, dict):
            data = pa.table(data)
        if not isinstance(data, pa.Table):
            raise TypeError(type(data))
        return DataFrame(P.InMemorySource(data, num_partitions), self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> DataFrame:
        """spark.range: one int64 column ``id`` from start (inclusive) to
        end (exclusive) by step; range(n) counts from 0. The values are
        made on the device."""
        self._activate()
        if end is None:
            start, end = 0, start
        return DataFrame(P.Range(start, end, step, num_partitions), self)

    def read_parquet(self, *paths, columns=None) -> DataFrame:
        """Parquet files, directories of them (``*.parquet``, names
        starting with ``_`` skipped) or glob patterns; one partition per
        file. One directory in a hive layout (``k=v`` subdirectories)
        gives its partition columns, last in the schema. Decoded on the
        device unless spark.rapids.sql.decode.device.enabled is false."""
        self._activate()
        if len(paths) == 1 and os.path.isdir(paths[0]):
            files, part_vals = _discover_hive(paths[0])
            if part_vals is not None:
                return DataFrame(P.ParquetScan(
                    files, columns, partition_values=part_vals), self)
        return DataFrame(P.ParquetScan(
            self._expand_paths(paths, suffix=".parquet"), columns), self)

    def _expand_paths(self, paths, suffix: str = "") -> List[str]:
        """Files, a directory's files ending in ``suffix`` (names starting
        with ``_`` skipped) and glob patterns, in sorted order. The text
        readers start here, so it also activates the session's conf."""
        self._activate()
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(
                    f for f in glob.glob(os.path.join(p, "*" + suffix))
                    if os.path.isfile(f)
                    and not os.path.basename(f).startswith("_")))
            elif any(ch in p for ch in "*?["):
                files.extend(sorted(glob.glob(p)))
            else:
                files.append(p)
        if not files:
            raise FileNotFoundError(f"no input files matched {list(paths)!r}")
        return files

    def read_csv(self, *paths, header: bool = True, sep: str = ",",
                 columns=None) -> DataFrame:
        """CSV files, parsed on the host; the column types are inferred
        from the first file's first block and pinned for every file."""
        return DataFrame(P.TextScan("csv", self._expand_paths(paths),
                                    columns=columns,
                                    options={"header": header, "sep": sep}),
                         self)

    def read_json(self, *paths, columns=None) -> DataFrame:
        """JSON-lines files, parsed on the host (nested objects become
        structs, arrays arrays)."""
        return DataFrame(P.TextScan("json", self._expand_paths(paths),
                                    columns=columns), self)

    def read_avro(self, *paths, columns=None) -> DataFrame:
        """Avro object container files (``io/avro.py``)."""
        return DataFrame(P.TextScan("avro", self._expand_paths(paths),
                                    columns=columns), self)

    def read_orc(self, *paths, columns=None) -> DataFrame:
        """ORC files, read through pyarrow."""
        return DataFrame(P.TextScan("orc", self._expand_paths(paths),
                                    columns=columns), self)

    # -- execution ---------------------------------------------------------
    def prepare_execution(self, plan: P.PlanNode):
        """The preamble of every action: this session's conf becomes the
        thread's, the lock sanitizer installs when the conf asks for it,
        fault injection is armed (the general sites and the
        legacy OOM injector), the retry backoff, the dispatch watchdog and
        breaker and the spill budgets are synced, then the plan is
        converted under the measured cost pass's hints for its digest
        (``plan/cost.measured_hints``; a decision in ``last_aqe()`` when
        there are any). Returns (exec root, tagged plan)."""
        from spark_rapids_tpu_torch.analysis import kernel_audit, sanitizer
        from spark_rapids_tpu_torch.runtime import (
            compile_cache, faults, watchdog,
        )
        from spark_rapids_tpu_torch.runtime.memory import get_spill_framework
        from spark_rapids_tpu_torch.runtime.retry import (
            OomInjector, backoff_from_conf,
        )
        C.set_session_conf(self.conf)
        sanitizer.maybe_install(self.conf)
        kernel_audit.configure(self.conf)
        compile_cache.configure(self.conf)
        OomInjector.from_conf(self.conf)
        faults.from_conf(self.conf)
        backoff_from_conf(self.conf)
        watchdog.maybe_install(self.conf)
        get_spill_framework(self.conf, self.device)
        # the measured cost pass: audited history of this plan's digest
        # may set the aggregate exchange's partitions and the coalescing
        # threshold (thread-local: concurrent sessions convert under
        # their own hints)
        from spark_rapids_tpu_torch.plan import cost as COST
        hints = COST.measured_hints(plan, self.conf)
        COST.install_hints(hints)
        try:
            root, meta = convert_plan(plan, self.conf, self.device)
        finally:
            COST.clear_hints()
        if hints is not None and AQ.enabled(self.conf):
            AQ.record(AQ.MEASURED_COST, **hints.detail())
        self.last_exec, self.last_meta = root, meta
        # attach the converted tree to THIS query's live context (the
        # thread's bound query id), so /queries progress walks the
        # query's own operators; the first attach wins, so a nested
        # collect does not clobber the outer tree
        from spark_rapids_tpu_torch.runtime.obs import live
        qc = live.current_context()
        if qc is not None:
            qc.attach_exec(root)
        return root, meta

    def last_metrics(self) -> Dict[str, Dict[str, int]]:
        """Per-exec metrics of the most recent action (the SQL-UI metrics
        surface; reference GpuMetric / GpuTaskMetrics). Returns
        {ExecClass#i: {metric: value}} in ``walk_exec_tree`` order, each
        operator that recorded a metric. Reading resolves the lazy device
        row counts in one transfer an operator."""
        out = {}
        if self.last_exec is not None:
            for key, node, _d, _role, _sid in walk_exec_tree(
                    self.last_exec):
                snap = node.metrics.snapshot()
                if snap:
                    out[key] = snap
        return out

    def collect(self, plan: P.PlanNode,
                timeout_seconds: Optional[float] = None) -> pa.Table:
        """Run the plan and return its rows. A top-level action registers
        a cancel token (armed with spark.rapids.query.timeoutSeconds or
        ``timeout_seconds``) and passes the admission gate first; with
        spark.rapids.fallback.cpu.enabled a device failure that is not
        the user's re-executes on the CPU backend (status ``degraded``),
        and an open circuit breaker skips the device. The outcome is
        ``last_action_status``: (``ok``|``failed``|``degraded``|
        ``cancelled``, the reason or None). A nested collect propagates
        its failure to the outer query, which degrades whole."""
        import time

        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        from spark_rapids_tpu_torch.runtime import obs as OBS
        from spark_rapids_tpu_torch.runtime import task as TK
        from spark_rapids_tpu_torch.runtime.obs import attribution as ATTR
        # one structured trace per action (spark.rapids.sql.trace.*); a
        # nested collect (a scalar subquery, a broadcast materialization)
        # gets None and joins the enclosing query's trace
        qt = TR.start_query(self.conf)
        if qt is None and self.conf.get(C.TRACE_ENABLED):
            # another query owns the tracer: this action writes no
            # artifacts of its own, and must not show a previous one's
            self.last_trace_paths = None
        depth = getattr(_COLLECT_DEPTH, "d", 0)
        # the live token: None with obs off, NESTED for a nested collect,
        # else a fresh positive query id. The digest is taken up front so
        # the live registry and the queryStart marker carry it while the
        # query runs
        start_digest = None
        if depth == 0:
            try:
                start_digest = OBS.plan_digest(plan)
            except Exception:  # noqa: BLE001 - an undigestable plan
                pass  # still runs and registers
        ot = OBS.on_query_start(plan_digest=start_digest,
                                sql=getattr(plan, "_sql_text", None))
        if qt is not None or (ot is not None and ot is not OBS.NESTED):
            # a failure before the plan converts must snapshot or publish
            # nothing of the previous action's operators
            self.last_exec = None
        t0 = time.perf_counter_ns()
        wall0 = time.time()
        status = "ok"
        error: Optional[BaseException] = None
        degraded_reason: Optional[str] = None
        cancel_reason: Optional[str] = None
        tok = None  # this action's cancel token (top level only)
        _COLLECT_DEPTH.d = depth + 1
        if depth == 0:
            # the attribution aggregate (kernel builds, task
            # accumulators) opens whatever the obs state, so every
            # top-level action has a breakdown
            ATTR.on_query_start()
            # the kernel cost auditor's dispatch tally (one global read
            # with the audit off; the conf rides along so a mid-session
            # enable covers this query)
            from spark_rapids_tpu_torch.analysis import kernel_audit as KA
            KA.on_query_start(self.conf)
            AQ.on_query_start(self.conf)
            # the t0 marker of every top-level action, traced or not (the
            # flight ring records it too)
            TR.instant("queryStart", cat="query", args={
                "query_id": ot if isinstance(ot, int) else None,
                "plan_digest": start_digest}, level=TR.ESSENTIAL)
        cpu_gate_failed = False
        try:
            if depth == 0:
                # the token registers first, so a query is cancellable
                # while it waits for admission; its id is the live one
                # (positive) when obs minted it
                tok = LC.begin_action(ot if isinstance(ot, int) else None,
                                      self.conf,
                                      timeout_seconds=timeout_seconds)
                LC.admit(tok, self.conf)
                self._live_transition(ot, "planning")
            if depth == 0 and self._fallback_enabled():
                from spark_rapids_tpu_torch.runtime import watchdog as WD
                brk = WD.peek_breaker()
                if brk is not None and not brk.allow():
                    # breaker open: skip the device; allow() lets one
                    # probe query through per backoff window
                    status, degraded_reason = "degraded", "circuit_open"
                    try:
                        return self._execute_cpu_fallback(plan)
                    except BaseException:
                        # the device never ran: no breaker failure, and
                        # no second CPU run
                        cpu_gate_failed = True
                        status, degraded_reason = "failed", None
                        raise
            prof_dir = self.conf.get(C.PROFILE_DIR) if depth == 0 else ""
            if prof_dir:
                result = self._profiled_collect(plan, prof_dir)
            else:
                result = self._collect(plan)
            if depth == 0:
                self._record_device_success()
            return result
        except BaseException as e:
            error = e
            if depth == 0 and isinstance(e, LC.QueryCancelledError):
                # a cooperative cancel is its own terminal status, never
                # re-executed on the CPU
                status, cancel_reason = "cancelled", e.reason
                raise
            fallback = self._maybe_degrade_cpu(plan, e) \
                if depth == 0 and not cpu_gate_failed else None
            if fallback is None:
                status = "failed"
                raise
            status, degraded_reason = "degraded", type(e).__name__
            return fallback
        finally:
            _COLLECT_DEPTH.d = depth
            duration_ns = time.perf_counter_ns() - t0
            flight_dump = None
            # one resolved snapshot serves the trace and the history
            # record; neither is on by default
            lm = None
            if qt is not None:
                try:
                    lm = self.last_metrics()
                except Exception:  # noqa: BLE001
                    _LOG.warning("failed to snapshot last_metrics",
                                 exc_info=True)
            if depth == 0:
                #: (status, reason) of the most recent top-level action
                self.last_action_status = (status,
                                           degraded_reason or cancel_reason)
                # the token leaves the registry and its admission slot
                # releases before the epilogue, which runs with the query
                # visible as `finishing`
                LC.finish_action(tok, status)
                self._live_transition(ot, "finishing")
                self._last_task_metrics = TK.take_query_totals(
                    tok.query_id) if tok is not None else {}
                self._last_aqe = AQ.finish_query()
                snaps = self._attribute(lm, duration_ns)
                self._audit(snaps, duration_ns)
                if status != "ok":
                    self._outcome_instant(ot, status, error,
                                          degraded_reason, cancel_reason)
                    # the failing query's timeline, retroactively, even
                    # with tracing off (flight.dump never raises)
                    from spark_rapids_tpu_torch.runtime.obs import flight
                    flight_dump = flight.dump(
                        "query_" + status,
                        query_id=ot if isinstance(ot, int) else None,
                        error=(type(error).__name__ if error is not None
                               else degraded_reason))
            if qt is not None:
                self._end_trace(qt, status, error, lm, plan)
            if ot is not None:
                top = depth == 0
                try:
                    OBS.on_query_end(
                        ot, session=self, plan=plan, status=status,
                        error=error, duration_ns=duration_ns,
                        wall_start_unix=wall0,
                        trace_paths=(self.last_trace_paths
                                     if qt is not None else None),
                        last_metrics=lm,
                        degraded_reason=degraded_reason,
                        attribution_doc=(self._last_attribution
                                         if top else None),
                        roofline_doc=self._last_roofline if top else None,
                        aqe_doc=self._last_aqe if top else None,
                        flight_dump=flight_dump)
                except Exception:  # noqa: BLE001
                    _LOG.warning("failed to publish query to obs",
                                 exc_info=True)

    @staticmethod
    def _live_transition(ot, state: str) -> None:
        """Move a top-level query's live context to ``state`` (no-op with
        obs or progress off; the registry is advisory and never fails a
        query)."""
        if not isinstance(ot, int):
            return
        from spark_rapids_tpu_torch.runtime.obs import live
        try:
            qc = live.get(ot)
            if qc is not None:
                qc.transition(state)
        except Exception:  # noqa: BLE001
            pass

    def _outcome_instant(self, ot, status, error, degraded_reason,
                         cancel_reason) -> None:
        """The terminal marker of a top-level action that did not end
        ``ok`` (trace and flight ring): why the timeline ends where it
        does. Never raises."""
        try:
            if status == "cancelled":
                TR.instant("queryCancelled", cat="query", args={
                    "query_id": ot if isinstance(ot, int) else None,
                    "reason": cancel_reason}, level=TR.ESSENTIAL)
            elif status == "degraded":
                TR.instant("queryDegraded", cat="query", args={
                    "reason": degraded_reason,
                    "error": (type(error).__name__
                              if error is not None else None)},
                    level=TR.ESSENTIAL)
            elif status == "failed" and error is not None:
                TR.instant("queryError", cat="query", args={
                    "error": type(error).__name__,
                    "message": str(error)[:200]}, level=TR.ESSENTIAL)
        except Exception:  # noqa: BLE001 - a marker must not mask the
            _LOG.warning("failed to emit query outcome instant",
                         exc_info=True)  # query's own error

    def _attribute(self, lm, duration_ns: int):
        """Close the attribution aggregate and fold the action's wall time
        into the buckets, from ``lm`` when the epilogue took a resolved
        snapshot, else from a peek (the timers are host integers: no
        device sync). Returns the snapshot used (None if it failed).
        Never raises."""
        from spark_rapids_tpu_torch.runtime import obs as OBS
        from spark_rapids_tpu_torch.runtime.obs import attribution as ATTR
        self._last_attribution = None
        self._last_duration_ns = duration_ns
        snaps = None
        try:
            self._last_attr_extra = ATTR.finish()
            snaps = lm if lm is not None else OBS.peek_metrics(self)
            self._last_attribution = ATTR.attribute(
                snaps, duration_ns, extra=self._last_attr_extra)
        except Exception:  # noqa: BLE001 - attribution is advisory
            _LOG.warning("failed to attribute query time", exc_info=True)
        return snaps

    def _audit(self, snaps, duration_ns: int) -> None:
        """Close the kernel cost audit's dispatch tally and join it with
        the attribution's seconds into the roofline (one global read with
        the audit off). Never raises."""
        from spark_rapids_tpu_torch.analysis import kernel_audit as KA
        self._last_audit = None
        self._last_roofline = None
        try:
            self._last_audit = KA.finish_query()
            if self._last_audit is not None and snaps is not None:
                self._last_roofline = KA.roofline(
                    self._last_audit, snaps, duration_ns,
                    extra=self._last_attr_extra)
        except Exception:  # noqa: BLE001 - the audit must never fail (or
            _LOG.warning("failed to compute the kernel cost audit",
                         exc_info=True)  # mask the error of) a query

    def _profiled_collect(self, plan: P.PlanNode, prof_dir: str
                          ) -> pa.Table:
        """One top-level action under ``torch.profiler`` (host and, on the
        card, CUDA activity), written as a Chrome trace into ``prof_dir``
        (``last_profile_path``). The structured trace's spans appear in
        it as ``record_function`` ranges when spark.rapids.sql.trace is
        on. torch.profiler cannot nest, so an action started while a
        capture is active raises rather than running without one."""
        import time

        from torch.profiler import ProfilerActivity, profile
        if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
            raise RuntimeError(
                "spark.rapids.profile.dir: a torch.profiler capture is "
                "already active on this process; torch.profiler cannot "
                "nest, so this action cannot be profiled (unset the key or "
                "end the other capture)")
        os.makedirs(prof_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.last_profile_path = None
        with profile(activities=acts) as prof:
            result = self._collect(plan)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        _PROFILE_SEQ[0] += 1
        path = os.path.join(prof_dir, f"action_{os.getpid()}_"
                            f"{int(time.time())}_{_PROFILE_SEQ[0]}.json")
        prof.export_chrome_trace(path)
        self.last_profile_path = path
        return result

    def _end_trace(self, qt, status: str, error, lm, plan) -> None:
        """Finalize the action's trace with its metrics snapshot and plan
        digest, on success and failure alike. Observability never fails
        (or masks the real error of) a query: a finalize failure is
        logged."""
        from spark_rapids_tpu_torch.runtime import obs as OBS
        digest = None
        try:
            digest = OBS.plan_digest(plan)
        except Exception:  # noqa: BLE001
            pass
        # cleared first so a finalize failure can never leave a previous
        # query's artifacts looking like this one's
        self.last_trace_paths = None
        try:
            self.last_trace_paths = TR.end_query(
                qt, last_metrics=lm, status=status, error=error,
                plan_digest=digest)
        except Exception:  # noqa: BLE001
            _LOG.warning("failed to finalize query trace", exc_info=True)

    def cancel(self, query_id, reason: str = "user") -> bool:
        """Cooperatively cancel an in-flight top-level query by id (the
        ids ``running_queries()`` and the /queries endpoint report; also
        POST /queries/<id>/cancel). Threads parked on
        the semaphore, the admission queue or a retry backoff wake at
        once, and the next checkpoint raises QueryCancelledError, which
        unwinds through normal task completion. False when no such query
        is in flight."""
        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        return LC.cancel(query_id, reason=reason)

    def running_queries(self) -> List[dict]:
        """Live progress snapshots of every in-flight top-level query in
        this PROCESS (``runtime/obs/live.py``; the registry is process-
        wide, like the endpoint it feeds): query id, state, elapsed,
        per-exec batches and rows, %-complete and ETA. Sync-free: a
        snapshot never reads a row count off the card. Empty when obs or
        progress tracking is off."""
        from spark_rapids_tpu_torch.runtime.obs import live
        return live.running_docs(with_execs=True)

    def last_task_metrics(self) -> Dict[str, int]:
        """The task accumulators (the names in ``runtime/metrics.py``)
        summed over the last top-level action's tasks (the high-water
        mark for maxDeviceBytesHeld)."""
        return dict(self._last_task_metrics)

    def _fallback_enabled(self) -> bool:
        return bool(self.conf.get(C.FALLBACK_CPU_ENABLED))

    def _record_device_success(self) -> None:
        """Close the circuit on a successful device query (a half-open
        probe, or a plain success resetting the failure count). Only when
        fallback is on: the breaker must not gather state from workloads
        that fail queries on purpose with fallback off."""
        if not self._fallback_enabled():
            return
        from spark_rapids_tpu_torch.runtime import watchdog as WD
        brk = WD.peek_breaker()
        if brk is not None:
            brk.record_success()

    @staticmethod
    def _degradable(error: BaseException) -> bool:
        """Engine and device failures degrade (exhausted OOM retries,
        injected faults, a failing device call); user-semantic errors do
        not: an ANSI overflow or an unsupported operation would raise
        identically on the CPU backend. A cancelled query must end, and a
        rejected one re-executing would bypass admission. A hand kernel
        that fails to build, load or launch is never hidden behind the
        CPU backend."""
        from spark_rapids_tpu_torch.ops._build import KernelError
        from spark_rapids_tpu_torch.runtime.lifecycle import (
            QueryCancelledError, QueryRejectedError,
        )
        if isinstance(error, (KeyboardInterrupt, SystemExit,
                              GeneratorExit, QueryCancelledError,
                              QueryRejectedError, KernelError)):
            return False
        return not isinstance(error, SparkException)

    def _execute_cpu_fallback(self, plan: P.PlanNode) -> pa.Table:
        return execute_cpu(localize_plan(plan, self.conf),
                           self.conf.get(C.ANSI_ENABLED))

    def _maybe_degrade_cpu(self, plan: P.PlanNode,
                           error: BaseException) -> Optional[pa.Table]:
        """Graceful degradation (spark.rapids.fallback.cpu.enabled): the
        device path failed a top-level query; re-execute it on the CPU
        backend. None when degradation is off, the error is the user's,
        or the CPU run fails too (the device error then propagates)."""
        if not self._fallback_enabled() or not self._degradable(error):
            return None
        from spark_rapids_tpu_torch.runtime import watchdog as WD
        WD.breaker().record_failure(type(error).__name__)
        _LOG.warning(
            "query failed on the device path (%s: %s); degrading to CPU "
            "re-execution", type(error).__name__, str(error)[:200])
        try:
            return self._execute_cpu_fallback(plan)
        except Exception:  # noqa: BLE001 - surface the original error
            _LOG.warning("CPU fallback re-execution also failed",
                         exc_info=True)
            return None

    def run_partitions(self, exec_root, per_batch) -> list:
        """Every partition of an exec tree as a task (up to 16 at once,
        the Spark task-scheduler role), per_batch applied to each output
        batch; the results flat, in partition order. Wave threads carry
        the session conf, the query id and the collect depth."""
        from spark_rapids_tpu_torch.runtime.host_pool import run_task_wave
        from spark_rapids_tpu_torch.runtime.task import TaskContext
        depth = getattr(_COLLECT_DEPTH, "d", 0)

        def run(p: int) -> list:
            prev = getattr(_COLLECT_DEPTH, "d", 0)
            _COLLECT_DEPTH.d = depth
            try:
                with TaskContext(partition_id=p):
                    return [per_batch(b)
                            for b in exec_root.execute_partition(p)]
            finally:
                _COLLECT_DEPTH.d = prev

        nparts = exec_root.num_partitions
        if nparts == 1:
            return run(0)
        out = []
        for res in run_task_wave(run, range(nparts)):
            out.extend(res)
        return out

    def last_aqe(self) -> Optional[dict]:
        """The adaptive decisions of the last top-level action: the
        decision list (``decisions``), per-kind ``counts`` and the total
        ``dispatches_saved``; None when it made no decision."""
        return self._last_aqe

    def explain_aqe(self) -> List[str]:
        """The last action's adaptive decisions as report lines
        (``render_text``): a header, then one line a decision."""
        return AQ.render_text(self._last_aqe)

    def last_plan_explain(self) -> str:
        """The placement report of the last action's tagged plan."""
        return self.last_meta.explain(all_ops=True) if self.last_meta \
            else ""

    def last_attribution(self) -> Optional[dict]:
        """Wall-time attribution of the most recent top-level action
        (``runtime/obs/attribution.py``): named phase buckets summing to
        the measured wall time. The epilogue's document, else one
        recomputed from the operators' timers and the stored aggregate;
        None before any action."""
        if self._last_attribution is not None:
            return self._last_attribution
        if not self._last_duration_ns or self.last_exec is None:
            return None
        from spark_rapids_tpu_torch.runtime import obs as OBS
        from spark_rapids_tpu_torch.runtime.obs import attribution as ATTR
        try:
            return ATTR.attribute(OBS.peek_metrics(self),
                                  self._last_duration_ns,
                                  extra=self._last_attr_extra)
        except Exception:  # noqa: BLE001 - advisory
            return None

    def last_audit(self) -> Optional[dict]:
        """The kernel cost audit summary of the last top-level action
        (``analysis/kernel_audit.py``): per family dispatches, entries,
        signatures, bytes, operations, plane bytes, padding exposure and
        PCIe bytes, with the hand kernels' charges. None when
        spark.rapids.obs.audit.enabled was off for the action."""
        return self._last_audit

    def last_roofline(self) -> Optional[dict]:
        """The roofline of the last top-level action: audited bytes and
        operations joined with the attribution's seconds into achieved
        GB/s and GFLOP/s, their share of the peaks, a verdict and the
        padding waste. The epilogue's document, else one recomputed from
        the stored audit and a fresh snapshot; None with the audit off."""
        if self._last_roofline is not None:
            return self._last_roofline
        if not self._last_audit or not self._last_duration_ns \
                or self.last_exec is None:
            return None
        from spark_rapids_tpu_torch.analysis import kernel_audit as KA
        from spark_rapids_tpu_torch.runtime import obs as OBS
        try:
            return KA.roofline(self._last_audit, OBS.peek_metrics(self),
                               self._last_duration_ns,
                               extra=self._last_attr_extra)
        except Exception:  # noqa: BLE001 - advisory
            return None

    def explain_analyze(self, snaps: Optional[Dict[str, dict]] = None
                        ) -> str:
        """The physical operator tree of the most recent action annotated
        with its runtime metrics (rows, batches, dispatches, operator
        time per operator, from ``snaps`` or ``last_metrics()``), then
        the attribution, roofline and adaptive sections (the EXPLAIN ANALYZE
        surface; reference: the Spark SQL tab's metric annotations)."""
        from spark_rapids_tpu_torch.runtime.metrics import exec_rollup
        from spark_rapids_tpu_torch.runtime.obs import attribution as ATTR
        root = self.last_exec
        if root is None:
            return "<no executed plan: run an action first>"
        if snaps is None:
            snaps = self.last_metrics()
        lines: List[str] = []
        for key, node, depth, role, sid in walk_exec_tree(root):
            r = exec_rollup(snaps.get(key, {}))
            parts = [f"rows={r['rows']}", f"batches={r['batches']}"]
            if r["dispatches"]:
                parts.append(f"dispatches={r['dispatches']}")
            parts.append(f"time={r['time_ns'] / 1e6:.3f}ms")
            annot = ", ".join(parts)
            pad = "  " * depth
            if role is None:
                mark = f"*({sid}) " if sid is not None else ""
                lines.append(f"{pad}{mark}{node.name()}  [{annot}]")
            else:
                tag = "fused" if role == "member" else role
                lines.append(f"{pad}  *({sid}) {type(node).__name__} "
                             f"[{tag}]  [{annot}]")
        attr = self.last_attribution()
        if attr is not None:
            lines.append("")
            lines.extend(ATTR.render_text(attr))
        roof = self.last_roofline()
        if roof is not None:
            from spark_rapids_tpu_torch.analysis import kernel_audit as KA
            lines.append("")
            lines.extend(KA.render_text(roof))
        if self._last_aqe is not None:
            lines.append("")
            lines.extend(AQ.render_text(self._last_aqe))
        return "\n".join(lines)

    def _collect(self, plan: P.PlanNode) -> pa.Table:
        if self.conf.get(C.SQL_MODE).lower() == "explainonly":
            self.last_exec = None
            self.last_meta = wrap_and_tag(plan, self.conf)
            _LOG.info("\n%s", self.last_meta.explain(all_ops=True))
            return execute_cpu(localize_plan(plan, self.conf),
                               self.conf.get(C.ANSI_ENABLED))
        root, meta = self.prepare_execution(plan)
        explain_mode = self.conf.get(C.SQL_EXPLAIN).upper()
        if explain_mode == "ALL" or (explain_mode == "NOT_ON_TPU"
                                     and not all(m.can_run_on_tpu
                                                 for m in meta.walk())):
            _LOG.info("\n%s", meta.explain(all_ops=explain_mode == "ALL"))
        names = plan.schema.names
        tables = self.run_partitions(root, lambda b: host_table(b, names))
        return pa.concat_tables(tables) if tables \
            else empty_table(plan.schema)
