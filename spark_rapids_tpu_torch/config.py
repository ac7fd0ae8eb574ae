"""Typed config registry.

Counterpart of ``spark_rapids_tpu/config.py`` holding the keys this engine
reads. Key names and defaults are the JAX package's, so one conf dict
drives both sessions.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Optional

_REGISTRY: "Dict[str, ConfEntry]" = {}


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]
    #: a testing knob, left out of a history record's ``conf_delta``
    internal: bool = False


def _bool_conv(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


def _register(key, default, doc, conv, internal: bool = False) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    e = ConfEntry(key, default, doc, conv, internal)
    _REGISTRY[key] = e
    return e


TARGET_BATCH_SIZE = _register(
    "spark.rapids.sql.batchSizeBytes", 1 << 30,
    "Target columnar batch size in bytes; CoalesceBatchesExec concatenates "
    "batches up to this size.", int)

MAX_READER_BATCH_SIZE_ROWS = _register(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Soft cap on rows per batch produced by scans.", int)

SHUFFLE_PARTITIONING = _register(
    "spark.rapids.shuffle.partitioning", "compact",
    "Device repartition strategy for hash/round-robin/range exchanges. "
    "'compact': one stable counting sort per input batch makes each "
    "target partition contiguous, a single fetch of the n_out+1 offsets "
    "vector sizes the outputs, and downstream operators see right-sized "
    "sub-batches. 'masked': n_out full-capacity sub-batches per input "
    "batch that share the planes, each with its own selection mask and a "
    "row count left on the device. Any other value fails the exchange "
    "with a ValueError.", str)

SHUFFLE_COALESCE_TINY_ROWS = _register(
    "spark.rapids.shuffle.coalesceTinyRows", 1024,
    "Post-shuffle tiny-partition coalescing: after a compact exchange, "
    "adjacent sub-batches carrying fewer than this many rows each merge "
    "into one batch (bounded by 4x this target) before downstream "
    "operators see them. The decision reads the host-int row counts the "
    "offsets fetch already gave. 0 disables coalescing.", int)

ADAPTIVE_ENABLED = _register(
    "spark.rapids.sql.adaptive.enabled", True,
    "Adaptive query execution: pick the join strategy at run time from "
    "the measured build side, convert a shuffled hash join to broadcast "
    "when the materialized build side lands under the byte threshold, "
    "split skewed post-shuffle partitions, and reuse materialized "
    "broadcast builds across queries. Master switch for every "
    "spark.rapids.sql.adaptive.* feature below.", _bool_conv)

ADAPTIVE_MEASURED_COST = _register(
    "spark.rapids.sql.adaptive.measuredCost.enabled", True,
    "Measured cost pass: before converting a plan, read the query history "
    "store's roofline verdicts for the same plan digest and pick the "
    "aggregate exchange's partition count and the coalesceTinyRows "
    "threshold from what was measured instead of the static defaults "
    "(needs spark.rapids.obs.historyDir; a digest with no audited record "
    "keeps the static plan).", _bool_conv)

ADAPTIVE_BROADCAST_BYTES = _register(
    "spark.rapids.sql.adaptive.broadcastThresholdBytes", 64 << 20,
    "Runtime shuffle-hash -> broadcast conversion threshold: the build "
    "side of a shuffled hash join materializes its exchange first, and "
    "when its measured device bytes land at or under this many bytes the "
    "probe-side exchange never runs: the join replans as a broadcast hash "
    "join over the raw probe partitions. <= 0 disables the conversion.",
    int)

ADAPTIVE_SKEW_FACTOR = _register(
    "spark.rapids.sql.adaptive.skewFactor", 4.0,
    "Skewed-partition split: a post-shuffle partition whose row count "
    "exceeds this factor times the median partition is cut into "
    "in-order slices of about the median's rows (at most 8 a batch). "
    "<= 0 disables splitting.", float)

ADAPTIVE_BUILD_REUSE = _register(
    "spark.rapids.sql.adaptive.buildReuse.enabled", True,
    "Cache materialized broadcast build sides across queries, keyed by "
    "build-plan digest and table registration epoch, so a repeated join "
    "skips the build. Entries invalidate when any temp view is "
    "re-registered and are capped at 8.", _bool_conv)

PALLAS_ENABLED = _register(
    "spark.rapids.sql.pallas.enabled", True,
    "Take the sorted segmented-sum route (the segsum kernel) for eligible "
    "group-by sums; the scatter route runs otherwise. The two routes are "
    "different algorithms; this key never swaps a kernel for its plain "
    "version.", _bool_conv)

MULTIFILE_READER_TYPE = _register(
    "spark.rapids.sql.format.parquet.reader.type", "AUTO",
    "PERFILE, COALESCING, MULTITHREADED, or AUTO. The host-decode Parquet "
    "scan reads row groups one by one under PERFILE; the others prefetch "
    "on a bounded thread pool, and COALESCING and AUTO also concatenate "
    "row groups on the host up to the reader batch size.", str)

MULTIFILE_READER_THREADS = _register(
    "spark.rapids.sql.multiThreadedRead.numThreads", 8,
    "Row-group loads of one host-decode Parquet scan in flight at once "
    "(its lookahead) on the shared host pool, whose tier size is at "
    "least this.", int)

DEVICE_DECODE_ENABLED = _register(
    "spark.rapids.sql.decode.device.enabled", True,
    "Decode Parquet column chunks on the device: the scan uploads the "
    "still-encoded dictionary/RLE/bit-packed/delta planes and expands "
    "them on the card (io/encoded.py, ops/decode.py, the bitslice "
    "kernel). Columns outside the supported matrix fall back per column "
    "to pyarrow on the host. Off = the host-decode scan.", _bool_conv)

DEVICE_DECODE_DELTA = _register(
    "spark.rapids.sql.decode.device.delta.enabled", True,
    "Allow DELTA_BINARY_PACKED columns on the device-decode path; off "
    "falls such columns back to host decode.", _bool_conv)

DEVICE_DECODE_MAX_BITS = _register(
    "spark.rapids.sql.decode.device.maxBits", 32,
    "Widest dictionary/delta bit width decoded on the device (the "
    "bitslice kernel extracts from 32-bit word pairs); wider columns fall "
    "back per column to host decode. Values above 32 are capped at 32.",
    int)

BROADCAST_JOIN_ROW_THRESHOLD = _register(
    "spark.rapids.sql.join.broadcastRowThreshold", 1 << 22,
    "Estimated build-side row count at or below which joins broadcast "
    "the build side instead of hash-exchanging both sides.", int)

JOIN_SUBPARTITION_ROWS = _register(
    "spark.rapids.sql.join.subPartitionRows", 8 << 20,
    "Build sides larger than this many rows split by key hash into "
    "buckets joined pairwise (inner, left, semi and anti joins).", int)

SORT_OOC_BYTES = _register(
    "spark.rapids.sql.sort.outOfCoreBytes", 2 << 30,
    "Sorts over inputs larger than this run out of core: the device "
    "computes only the key permutation while the rows stage through host "
    "memory (pyarrow) and come back in reader-sized slices.", int)

RANGE_PARTITION_SAMPLE = _register(
    "spark.rapids.sql.rangePartitioning.sampleSizePerPartition", 1024,
    "Rows sampled per output partition and input batch to compute the "
    "bounds of a range exchange.", int)

ANSI_ENABLED = _register(
    "spark.sql.ansi.enabled", False,
    "ANSI mode: division by zero and overflowing casts raise instead of "
    "returning null.", _bool_conv)

CASE_SENSITIVE = _register(
    "spark.sql.caseSensitive", False,
    "Column resolution case sensitivity (Spark conf).", _bool_conv)

SESSION_TIMEZONE = _register(
    "spark.sql.session.timeZone", "UTC",
    "Session timezone. This engine evaluates timestamps in UTC only: any "
    "other value makes timezone-sensitive expressions raise at planning "
    "instead of silently returning UTC answers (reference: GpuOverrides "
    "tags non-UTC ops as unsupported). A zone of the IANA database is "
    "not refused: plan/overrides.localize_plan shifts the plan's "
    "timestamps through the zone's transition table first.", str)

# Plan tagging and the CPU fallback: the JAX package's keys, with their
# names and defaults. Per-operator keys are derived from names and need no
# registration: spark.rapids.sql.exec.<plan node> and
# spark.rapids.sql.expression.<rule name> (``RapidsConf.is_op_enabled``).

SQL_ENABLED = _register(
    "spark.rapids.sql.enabled", True,
    "Enable device acceleration of SQL plans; false runs every operator "
    "on the CPU backend (reference RapidsConf.scala:801).", _bool_conv)

SQL_MODE = _register(
    "spark.rapids.sql.mode", "executeOnTPU",
    "executeOnTPU runs supported operators on the device; explainOnly "
    "plans, tags and reports what would run on the device, and answers "
    "with the CPU backend (reference RapidsConf.scala:807).", str)

SQL_EXPLAIN = _register(
    "spark.rapids.sql.explain", "NOT_ON_TPU",
    "What to log about plan placement: NONE, NOT_ON_TPU (every fallback "
    "with its reason), ALL (reference RapidsConf.scala:2107).", str)

IMPROVED_FLOAT_OPS = _register(
    "spark.rapids.sql.improvedFloatOps.enabled", True,
    "Allow float aggregation orderings that may differ from CPU Spark in "
    "ULP-level ways (reference incompat float handling); false sends "
    "float sums, averages and moments to the CPU.", _bool_conv)

TEST_MODE = _register(
    "spark.rapids.sql.test.enabled", False,
    "Assert that everything that should be on the device is on it: a "
    "fallback to the CPU raises at plan time (reference "
    "GpuTransitionOverrides assertIsOnTheGpu).", _bool_conv,
    internal=True)

ALLOW_NON_TPU = _register(
    "spark.rapids.sql.test.allowedNonTpu", "",
    "Comma-separated plan node names allowed to fall back in test mode.",
    str, internal=True)

INCOMPAT_ENABLED = _register(
    "spark.rapids.sql.incompatibleOps.enabled", True,
    "Enable operators whose results can differ from CPU Spark in "
    "documented corner cases (reference incompatOps); false sends joins "
    "on string keys (compared by a 64-bit hash on the device) to the "
    "CPU.", _bool_conv)


OPTIMIZER_ENABLED = _register(
    "spark.rapids.sql.optimizer.enabled", False,
    "Cost-based reversion of device subtrees whose estimated device cost "
    "(incl. transfer + dispatch) exceeds the CPU cost "
    "(reference CostBasedOptimizer.scala, off by default; "
    "plan/cost.py).", _bool_conv)

SKIP_AGG_PASS_RATIO = _register(
    "spark.rapids.sql.agg.skipAggPassReductionRatio", 1.0,
    "Skip later agg passes when a pass reduces rows by less than this "
    "ratio (reference skipAggPassReductionRatio): a partial aggregate "
    "whose first batch keeps more than ratio x its rows as groups yields "
    "each batch's partial states unmerged, for the final aggregate to "
    "merge.", float)

AGG_FORCE_SINGLE_PASS = _register(
    "spark.rapids.sql.agg.forceSinglePassPartialSort", False,
    "Internal testing knob (reference forceSinglePassPartialSortAgg): "
    "concatenate a partition's input batches and run a keyed partial or "
    "complete aggregate as one update pass instead of an update per batch "
    "and a merge.", _bool_conv, internal=True)

# ---------------------------------------------------------------------------
# the query runtime: device budget and spill, retry, semaphore, faults,
# watchdog and breaker, degradation, deadlines and admission
# ---------------------------------------------------------------------------

def _float(s) -> float:
    return float(s)


CONCURRENT_TPU_TASKS = _register(
    "spark.rapids.sql.concurrentTpuTasks", 2,
    "Number of tasks admitted to the device concurrently by the semaphore "
    "(reference GpuSemaphore / RapidsConf.scala:545).", int)

DEVICE_MEMORY_FRACTION = _register(
    "spark.rapids.memory.tpu.allocFraction", 0.85,
    "Fraction of the card's memory the spill framework's budget may use "
    "(reference rmm.pool allocFraction).", _float)

DEVICE_MEMORY_BUDGET = _register(
    "spark.rapids.memory.tpu.budgetBytes", 12 << 30,
    "Cooperative device budget in bytes for registered (spillable) "
    "batches; reservations beyond it drain the spill stores (reference "
    "rmm pool size). The budget in force is the smaller of this and "
    "allocFraction x the card's memory.", int)

HOST_SPILL_LIMIT = _register(
    "spark.rapids.memory.host.spillStorageSize", 4 << 30,
    "Bytes of host memory for spilled device data before overflowing to "
    "disk (reference SpillFramework host store limit).", int)

SPILL_DIR = _register(
    "spark.rapids.memory.spillDir", "/tmp/rapids_tpu_spill",
    "Directory for disk spill files (reference RapidsDiskBlockManager); "
    "created at the first disk spill.", str)

RETRY_OOM_INJECT = _register(
    "spark.rapids.sql.test.injectRetryOOM", "",
    "Fault-injection grammar 'count[,skip[,split]]' forcing retry-OOMs "
    "for tests (reference RapidsConf.scala:1627,2753).", str,
    internal=True)

RETRY_BACKOFF_BASE_MS = _register(
    "spark.rapids.retry.backoffBaseMs", 10.0,
    "Base of the bounded exponential backoff between OOM retry attempts "
    "(after the spill-store drain): attempt n sleeps base*2^(n-1) ms, "
    "jittered to 50-100%, capped at backoffMaxMs, so concurrent tasks "
    "that OOMed together do not re-dispatch together. Folded into the "
    "retryBlockTime accumulator. 0 disables the backoff.", _float)

RETRY_BACKOFF_MAX_MS = _register(
    "spark.rapids.retry.backoffMaxMs", 500.0,
    "Cap on the per-attempt OOM retry backoff.", _float)

FAULTS_SPEC = _register(
    "spark.rapids.debug.faults", "",
    "General fault-injection schedule (runtime/faults.py): "
    "'site:kind[:count[,skip]]' entries joined by ';', where site is a "
    "registered fault site (scan.decode, shuffle.read, shuffle.write, "
    "spill.disk, device.dispatch, pipeline.producer, exchange.fetch, "
    "retry.oom, query.cancel, semaphore.wait) and kind is ioerror, "
    "corrupt (data sites only), delay, wedge, oom, or cancel (fire the "
    "current query's cancel token at the site). Empty disables "
    "injection (one global read per site pass). Generalizes "
    "injectRetryOOM, which remains the retry.oom facade.", str)

FAULTS_DELAY_MS = _register(
    "spark.rapids.debug.faults.delayMs", 50.0,
    "Sleep injected by a 'delay'-kind fault, in milliseconds.", _float)

FAULTS_WEDGE_S = _register(
    "spark.rapids.debug.faults.wedgeSeconds", 0.25,
    "Sleep injected by a 'wedge'-kind fault, in seconds. To exercise the "
    "watchdog's detection end to end, set this above "
    "spark.rapids.watchdog.dispatchTimeoutSeconds.", _float)

WATCHDOG_ENABLED = _register(
    "spark.rapids.watchdog.enabled", False,
    "Run the device dispatch watchdog (runtime/watchdog.py): a heartbeat "
    "service thread detects guarded device work exceeding "
    "dispatchTimeoutSeconds, reports each wedge once (a log warning) and "
    "records a circuit-breaker failure so later queries degrade to the "
    "CPU instead of joining the wedge. Disabled, the guard is a shared "
    "null context.", _bool_conv)

WATCHDOG_DISPATCH_TIMEOUT_S = _register(
    "spark.rapids.watchdog.dispatchTimeoutSeconds", 60.0,
    "Deadline for one guarded device dispatch before the watchdog reports "
    "it wedged and records a breaker failure.", _float)

WATCHDOG_BREAKER_THRESHOLD = _register(
    "spark.rapids.watchdog.breakerFailureThreshold", 3,
    "Consecutive device failures (failed or degraded queries, dispatch "
    "timeouts) that open the device circuit breaker. While open, and CPU "
    "fallback is enabled, queries skip the device entirely and run "
    "degraded on the CPU backend.", int)

WATCHDOG_BREAKER_BACKOFF_S = _register(
    "spark.rapids.watchdog.breakerBaseBackoffSeconds", 1.0,
    "Initial open-state backoff before the breaker half-opens and lets "
    "one probe query try the device again; doubles on each failed probe "
    "up to breakerMaxBackoffSeconds, resets on success.", _float)

WATCHDOG_BREAKER_MAX_BACKOFF_S = _register(
    "spark.rapids.watchdog.breakerMaxBackoffSeconds", 60.0,
    "Cap on the breaker's exponential open-state backoff.", _float)

FALLBACK_CPU_ENABLED = _register(
    "spark.rapids.fallback.cpu.enabled", False,
    "Graceful degradation: when a top-level query fails with an engine or "
    "device error (exhausted OOM retries, a device error, an injected "
    "fault; not user-semantic errors like an ANSI overflow, which "
    "surface unchanged), re-execute it on the CPU backend and report "
    "status 'degraded' with the triggering error class instead of "
    "'failed'. Also consults the device circuit breaker: while it is "
    "open, queries skip the device entirely. Off by default.", _bool_conv)

QUERY_TIMEOUT_S = _register(
    "spark.rapids.query.timeoutSeconds", 0.0,
    "Per-query deadline in seconds (0 disables). A sweeper thread over "
    "the live cancel tokens (runtime/lifecycle.py) fires the query's "
    "token with reason 'deadline' when the budget lapses; the query ends "
    "at its next cooperative checkpoint with status 'cancelled'. "
    "collect(timeout_seconds=...) overrides it per action.", _float)

QUERY_MAX_CONCURRENT = _register(
    "spark.rapids.query.maxConcurrent", 0,
    "Admission control over top-level actions (0 = unlimited): at most "
    "this many queries execute concurrently; excess queries park in a "
    "bounded FIFO queue. The complement of "
    "spark.rapids.sql.concurrentTpuTasks, which bounds tasks inside "
    "admitted queries on the device semaphore.", int)

QUERY_MAX_QUEUED = _register(
    "spark.rapids.query.maxQueued", 16,
    "Bound on the admission queue behind spark.rapids.query."
    "maxConcurrent: a query arriving past it is refused immediately with "
    "a typed QueryRejectedError.", int)

QUERY_QUEUE_TIMEOUT_S = _register(
    "spark.rapids.query.queueTimeoutSeconds", 30.0,
    "Longest a query may wait in the admission queue before it is refused "
    "with QueryRejectedError (0 = wait forever). Queued queries remain "
    "cancellable while they wait.", _float)

QUERY_DEVICE_BUDGET = _register(
    "spark.rapids.query.deviceBudgetBytes", 0,
    "Per-query cooperative device-bytes quota (0 disables): the spill "
    "framework keeps a per-query ledger of registered device batches, and "
    "a query exceeding its own quota spills its own batches (largest "
    "first), or raises a retryable quota OOM that drains only its own "
    "handles, instead of evicting its neighbors'.", int)

# ---------------------------------------------------------------------------
# the serialized shuffle and the writers
# ---------------------------------------------------------------------------

SHUFFLE_MODE = _register(
    "spark.rapids.shuffle.mode", "MULTITHREADED",
    "MULTITHREADED: in-process exchange on the device (compact or masked "
    "sub-batches, no files or serialization involved); SERIALIZED: the "
    "device partitioning's sub-batches serialize through the kudo wire "
    "format (shuffle/serde.py) into a spillable host store (parallel "
    "writers, compression, disk overflow) and deserialize lazily at read "
    "time; ICI: the mesh exchange (parallel/exchange.py: one lane a "
    "(source, destination) pair, sized by one count pass), taken when "
    "the mesh holds at least as many devices as output partitions, "
    "else the device exchange "
    "(reference RapidsConf.scala:1767 UCX|CACHE_ONLY|MULTITHREADED).",
    str)

SHUFFLE_VERIFY_CHECKSUMS = _register(
    "spark.rapids.shuffle.verifyChecksums", True,
    "Verify the CRC32 wire checksum (and the frame's xxhash64) of every "
    "serialized shuffle blob at read time. A corrupt blob is re-fetched "
    "from the shuffle store once (counted in shuffleCorruptionRetries) "
    "before the error surfaces: a transient disk bit-flip recovers, a "
    "persistent corruption fails the query (and degrades to the CPU when "
    "spark.rapids.fallback.cpu.enabled).", _bool_conv)

SHUFFLE_WRITER_THREADS = _register(
    "spark.rapids.shuffle.multiThreaded.writer.threads", 8,
    "Packing and compression tasks of one serialized exchange in flight "
    "at once on the shared host pool, whose tier size is at least this "
    "(reference RapidsShuffleInternalManagerBase.scala:119-218).", int)

SHUFFLE_READER_THREADS = _register(
    "spark.rapids.shuffle.multiThreaded.reader.threads", 8,
    "Blob decode tasks (verify, decompress, unpack) of one reduce "
    "partition in flight at once on the shared host pool, ahead of the "
    "consuming task, which uploads them.", int)

SHUFFLE_COMPRESSION = _register(
    "spark.rapids.shuffle.compression.codec", "auto",
    "Codec for serialized shuffle tables: auto, none, zstd, zlib "
    "(reference TableCompressionCodec). 'auto' resolves to zstd when the "
    "zstandard package is importable and to zlib (stdlib) otherwise; "
    "naming zstd explicitly without the package fails fast.", str)

SHUFFLE_HOST_BUDGET = _register(
    "spark.rapids.shuffle.hostSpillBudget", 256 << 20,
    "Host bytes the SERIALIZED shuffle store may hold resident before "
    "its largest partitions flush to disk spill files (reference "
    "ShuffleBufferCatalog spillable shuffle data).", int)

PIPELINE_ENABLED = _register(
    "spark.rapids.sql.pipeline.enabled", True,
    "Overlap host-side batch production (pyarrow decode, upload, shuffle "
    "deserialization) with device compute: a planner pass "
    "(runtime/pipeline.insert_pipelines) wraps every non-root scan in a "
    "PipelineExec, which runs the scan's generator on the shared host "
    "pool with its uploads on a side CUDA stream, so batch i+1 is "
    "decoded and uploaded while the device computes batch i (reference "
    "MultiFileReaderThreadPool / ThrottlingExecutor overlap). Also gates "
    "the compact exchange's deferred offsets fetch and the serialized "
    "exchange's streaming write. A stage whose pipeline setup fails runs "
    "synchronously.", _bool_conv)

PIPELINE_DEPTH = _register(
    "spark.rapids.sql.pipeline.depth", 2,
    "Bounded lookahead of each pipeline boundary: how many produced "
    "batches may sit decoded and uploaded ahead of the consumer. 0 "
    "disables pipelining (identical to pipeline.enabled=false).", int)

WRITER_THREADS = _register(
    "spark.rapids.sql.asyncWrite.numThreads", 4,
    "Background threads encoding and writing output files (reference "
    "io/async ThrottlingExecutor).", int)

ASYNC_WRITE_MAX_INFLIGHT = _register(
    "spark.rapids.sql.asyncWrite.maxInFlightHostMemoryBytes", 2 << 30,
    "Throttle for async output writes and the serialized exchange's "
    "packing: host bytes in flight before a producer blocks (reference "
    "io/async/TrafficController.scala).", int)

ASYNC_WRITE_STALL_WARN_S = _register(
    "spark.rapids.sql.asyncWrite.stallWarnSeconds", 60,
    "Seconds a producer may block in TrafficController.acquire before a "
    "stall warning is logged once. Admission is unchanged: the producer "
    "keeps waiting. 0 disables the warning.", int)

MAX_RECORDS_PER_FILE = _register(
    "spark.sql.files.maxRecordsPerFile", 0,
    "Maximum rows per output file (0 = unlimited). Writers split output "
    "into numbered part files past the limit (reference "
    "GpuFileFormatDataWriter maxRecordsPerFile).", int)


# ---------------------------------------------------------------------------
# UDFs, per-operator metrics and the query trace
# ---------------------------------------------------------------------------

PY_WORKER_POOL_ENABLED = _register(
    "spark.rapids.sql.python.workerPool.enabled", True,
    "Evaluate large row-UDF batches on a persistent multiprocessing "
    "worker pool (reference PySpark daemon analog). Unpicklable UDFs "
    "and small batches stay in-process.", _bool_conv)

PY_WORKER_POOL_PARALLELISM = _register(
    "spark.rapids.sql.python.workerPool.parallelism", 0,
    "Worker processes for the python UDF pool (0 = cpu count, cap 8).", int)

UDF_COMPILER_ENABLED = _register(
    "spark.rapids.sql.udfCompiler.enabled", False,
    "Translate simple Python UDF bytecode (arithmetic, comparisons, "
    "conditionals, math builtins) into fused device expressions "
    "(reference udf-compiler). Untranslatable UDFs stay on the row tier. "
    "Semantics note (same tradeoff as the reference compiler): compiled "
    "UDFs null-propagate instead of calling fn(None), and arithmetic "
    "errors yield null instead of raising (non-ANSI Spark semantics) — "
    "a row-tier UDF that RAISES on bad input behaves differently. "
    "Off by default for that reason (matching the reference).", _bool_conv)

METRICS_LEVEL = _register(
    "spark.rapids.sql.metrics.level", "MODERATE",
    "ESSENTIAL, MODERATE, or DEBUG metric collection "
    "(reference spark.rapids.sql.metrics.level).", str)

TRACE_ENABLED = _register(
    "spark.rapids.sql.trace.enabled", False,
    "Record a structured trace per query: spans for every exec's device "
    "work (tied to the same GpuMetric timers the SQL metrics use — one "
    "instrumentation point), instant events for semaphore/spill/retry/"
    "fault/watchdog activity, and a per-task accumulator event log, "
    "written as Chrome-trace-event JSON plus JSONL under "
    "spark.rapids.sql.trace.path and aggregated offline by "
    "tools/profiler_report.py (reference NvtxWithMetrics + "
    "ProfilerOnExecutor). Off by default; the disabled path costs one "
    "branch per span.", _bool_conv)

TRACE_PATH = _register(
    "spark.rapids.sql.trace.path", "/tmp/rapids_tpu_trace",
    "Directory receiving per-query trace artifacts "
    "(query_<n>_trace.json / _events.jsonl / _metrics.json) when "
    "spark.rapids.sql.trace.enabled is set (reference "
    "spark.rapids.profile pathPrefix).", str)

TRACE_LEVEL = _register(
    "spark.rapids.sql.trace.level", "MODERATE",
    "Trace verbosity, reusing the metric levels: ESSENTIAL (exec spans + "
    "task rollups), MODERATE (+ semaphore/spill/retry/dispatch instants), "
    "DEBUG (+ async writes and per-stage internals).", str)

TRACE_TASK_METRICS = _register(
    "spark.rapids.sql.trace.taskMetrics", True,
    "Roll per-task accumulators (retry count/time, spill bytes/time, "
    "semaphore wait, max device bytes held — the GpuTaskMetrics analog) "
    "into the per-query event log at task completion.", _bool_conv)

SANITIZER_ENABLED = _register(
    "spark.rapids.debug.sanitizer.enabled", False,
    "Enable the runtime concurrency sanitizer (analysis/sanitizer.py): "
    "the engine's named lock sites record a process-wide lock-"
    "acquisition-order graph, report cycles (potential ABBA deadlocks) "
    "the first time both orders are merely observed, flag locks held "
    "past the holdWarnMs threshold (blocking work inside a critical "
    "section), and flag Condition waits made while other locks are "
    "held. Findings rank in sanitizer.report() and emit sanitizerFinding "
    "trace instants via sanitizer.dump(). Debug-only: enabled runs "
    "capture a stack per acquire; disabled, every lock operation costs "
    "one global read.", _bool_conv)

SANITIZER_HOLD_WARN_MS = _register(
    "spark.rapids.debug.sanitizer.holdWarnMs", 50.0,
    "Hold-duration threshold (milliseconds) above which the sanitizer "
    "reports a held-lock-blocking finding with the acquire-site stack.",
    _float)

SANITIZER_STACK_DEPTH = _register(
    "spark.rapids.debug.sanitizer.stackDepth", 8,
    "Innermost stack frames captured per lock acquisition while the "
    "sanitizer is enabled (deeper = better reports, slower acquires).",
    int)

PLAN_VERIFY_ENABLED = _register(
    "spark.rapids.debug.planVerify.enabled", False,
    "Run the plan-invariant verifier (analysis/plan_verify.py) on every "
    "converted exec tree: schema consistency across exec boundaries and "
    "pipeline-boundary sanity. Violations raise PlanVerifyError before "
    "execution starts.", _bool_conv)

LORE_DUMP_DIR = _register(
    "spark.rapids.sql.lore.dumpPath", "",
    "When set, every exec's input batches dump as parquet under "
    "<dir>/loreId=<id>/ for local operator replay (runtime/lore.py; "
    "reference LORE, lore/GpuLore.scala).", str)


# ---------------------------------------------------------------------------
# live observability (runtime/obs): the registry, the live query registry,
# the flight recorder, the SLO detector, the sampler and the endpoint
# ---------------------------------------------------------------------------

OBS_ENABLED = _register(
    "spark.rapids.obs.enabled", True,
    "Publish live metrics into the process-wide observability registry "
    "(runtime/obs): task accumulators fold in once per task completion, "
    "per-exec rollups once per query, never per batch. Disabled, every "
    "hook costs one global read (the budget of trace.py). The registry "
    "feeds the /metrics endpoint.", _bool_conv)

OBS_PORT = _register(
    "spark.rapids.obs.port", 0,
    "When > 0, serve a background HTTP endpoint on this port: /metrics "
    "(Prometheus text format from the live registry), /healthz (JSON: "
    "device liveness via a trivial probe on a side stream, semaphore "
    "saturation, spill pressure, last-query status; HTTP 200 ok / 503 "
    "degraded), /queries and /console. 0 disables the endpoint.", int)

OBS_HISTORY_DIR = _register(
    "spark.rapids.obs.historyDir", "",
    "When set, append one JSON record per top-level action to "
    "<dir>/query_history.jsonl (runtime/obs/history.py): plan digest, "
    "physical plan, per-exec metric rollups, the annotated plan, fallback "
    "reasons, config delta, wall time and its attribution, adaptive "
    "decisions, status (ok/failed + exception class), trace artifact "
    "paths. Rendered by tools/history_server.py (query list -> annotated "
    "plan -> run-over-run diff by plan digest); the SLO baselines seed "
    "from it and the measured cost pass reads it.", str)

OBS_PROBE_TIMEOUT_MS = _register(
    "spark.rapids.obs.probeTimeoutMs", 2000,
    "Timeout for the /healthz device probe; a probe that exceeds it "
    "reports the device as blocked and flips the endpoint to degraded "
    "(503).", int)

OBS_FLIGHT_ENABLED = _register(
    "spark.rapids.obs.flight.enabled", True,
    "Run the always-on flight recorder (runtime/obs/flight.py): a "
    "bounded per-thread ring of the most recent span/instant events, "
    "fed from the SAME instrumentation points structured tracing uses, "
    "auto-dumped as a Chrome-trace file when a query fails, degrades or "
    "is cancelled, the dispatch watchdog reports a wedge, the circuit "
    "breaker opens, or a query breaches its SLO, so failures get a "
    "timeline retroactively even with spark.rapids.sql.trace.enabled "
    "off. The hot path takes no locks (one tuple store per recorded "
    "event; DEBUG-level events are filtered).", _bool_conv)

OBS_FLIGHT_PATH = _register(
    "spark.rapids.obs.flight.path",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_flight"),
    "Directory receiving flight-recorder dumps "
    "(flight_<seq>_<reason>.json, Chrome-trace/Perfetto loadable); "
    "rapids_tpu_flight under the system temporary directory by "
    "default.", str)

OBS_FLIGHT_EVENTS = _register(
    "spark.rapids.obs.flight.events", 2048,
    "Per-thread ring capacity of the flight recorder: how many recent "
    "span/instant events each thread retains for a retroactive dump. "
    "Older events are overwritten; the dump reports how many were "
    "dropped.", int)

OBS_FLIGHT_MIN_INTERVAL_S = _register(
    "spark.rapids.obs.flight.minIntervalSeconds", 5.0,
    "Rate limit between flight-recorder dumps: a failure storm dumps at "
    "most one timeline per interval instead of one per failing query. "
    "0 disables the limit (tests).", _float)

OBS_FLIGHT_MAX_DUMPS = _register(
    "spark.rapids.obs.flight.maxDumps", 50,
    "Bounded retention: only the newest N flight dump files are kept in "
    "spark.rapids.obs.flight.path; older ones are pruned after each "
    "dump.", int)

OBS_REQTRACE_ENABLED = _register(
    "spark.rapids.obs.reqtrace.enabled", False,
    "Run the per-request tail-sampled tracer (runtime/obs/reqtrace.py): "
    "every serving request buffers its span tree (the serving spans and "
    "the engine spans of its query, joined by query id) in a bounded "
    "per-request ring fed from the same instrumentation points the "
    "flight recorder uses. At request end a sampling verdict either "
    "drops the buffer or exports a self-contained per-request timeline "
    "(a Chrome trace and an OTLP-JSON-shaped file) under reqtrace.path. "
    "Errors, cancellations, deadlines, SLO breaches and runs slower than "
    "the digest baseline are always kept; ordinary requests and hot "
    "cache hits sample at reqtrace.sampleRatio. Off, each hook costs "
    "one module-global read.", _bool_conv)

OBS_REQTRACE_PATH = _register(
    "spark.rapids.obs.reqtrace.path",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_reqtrace"),
    "Directory receiving per-request timeline exports "
    "(req_<seq>_<verdict>_<trace_id>.json Chrome-trace files and the "
    "matching .otlp.json OTLP-JSON-shaped files); rapids_tpu_reqtrace "
    "under the system temporary directory by default.", str)

OBS_REQTRACE_EVENTS = _register(
    "spark.rapids.obs.reqtrace.events", 4096,
    "Per-request ring capacity: how many span/instant events one "
    "request retains for its timeline. Older events are overwritten; "
    "the export reports how many were dropped.", int)

OBS_REQTRACE_SAMPLE_RATIO = _register(
    "spark.rapids.obs.reqtrace.sampleRatio", 0.01,
    "Probability that an ordinary successful request (a hot result-cache "
    "hit included) exports its timeline. Error, cancelled, deadline, "
    "SLO-breach and slower-than-baseline requests always export. 0 "
    "keeps only the always-keep classes.", _float)

OBS_REQTRACE_MIN_INTERVAL_S = _register(
    "spark.rapids.obs.reqtrace.minIntervalSeconds", 1.0,
    "Rate limit between sampled per-request timeline exports (the "
    "always-keep verdicts bypass it). 0 disables the limit (tests).",
    _float)

OBS_REQTRACE_MAX_DUMPS = _register(
    "spark.rapids.obs.reqtrace.maxDumps", 100,
    "Bounded retention: only the newest N per-request exports (Chrome + "
    "OTLP pairs) are kept in spark.rapids.obs.reqtrace.path; older ones "
    "are pruned after each export.", int)

OBS_REPLICA_ID = _register(
    "spark.rapids.obs.replicaId", "",
    "Stable identity of THIS serving replica in a fleet. Empty (the "
    "default) derives pid-<os pid>, which is unique per process but not "
    "stable across restarts.", str)

OBS_SLO_ENABLED = _register(
    "spark.rapids.obs.slo.enabled", True,
    "Check every successful top-level query against its SLO "
    "(runtime/obs/slo.py): a per-plan-digest latency baseline (mean of "
    "the last slo.baselineWindow ok runs, armed after slo.minRuns "
    "samples) times slo.baselineFactor, plus the absolute bound "
    "slo.latencySeconds. A breach emits a slowQuery instant, bumps "
    "rapids_slo_breaches_total, surfaces on /healthz, and triggers a "
    "flight-recorder dump.", _bool_conv)

OBS_SLO_FACTOR = _register(
    "spark.rapids.obs.slo.baselineFactor", 3.0,
    "A query breaches its SLO when its wall time exceeds the per-digest "
    "baseline mean times this factor.", _float)

OBS_SLO_MIN_RUNS = _register(
    "spark.rapids.obs.slo.minRuns", 5,
    "Successful runs of a plan digest required before its baseline arms "
    "(fewer samples would flag ordinary warm-up variance).", int)

OBS_SLO_ABS_SECONDS = _register(
    "spark.rapids.obs.slo.latencySeconds", 0.0,
    "Absolute per-query latency SLO in seconds, checked regardless of "
    "baseline state. 0 disables the absolute bound (the baseline check "
    "still applies).", _float)

OBS_SLO_WINDOW = _register(
    "spark.rapids.obs.slo.baselineWindow", 32,
    "Successful runs per plan digest retained for the baseline mean "
    "(a bounded sliding window, newest runs win).", int)

OBS_CORS_ORIGIN = _register(
    "spark.rapids.obs.corsOrigin", "",
    "Value for the Access-Control-Allow-Origin header on obs endpoint "
    "responses. Empty (the default) sends no CORS header, so browser "
    "pages from other origins cannot read /queries (which carries "
    "in-flight SQL text) or /healthz.", str)

OBS_PROGRESS_ENABLED = _register(
    "spark.rapids.obs.progress.enabled", True,
    "Register every top-level action in the live query registry "
    "(runtime/obs/live.py): query id, plan digest, state machine "
    "(queued -> planning -> executing -> finishing -> ok/failed/"
    "degraded/cancelled), and per-exec batches/rows progress with "
    "%-complete and ETA derived from the plan's scan-size estimates. "
    "Surfaced by session.running_queries(), the /queries JSON endpoint "
    "and the /console live page. Progress reads never resolve lazy "
    "device counts, so a scrape adds no device syncs to a running "
    "query.", _bool_conv)

OBS_SAMPLER_ENABLED = _register(
    "spark.rapids.obs.sampler.enabled", True,
    "Run the always-on resource time-series sampler "
    "(runtime/obs/sampler.py): a service thread samples the SERIES "
    "roster (device/host bytes held, semaphore permits and waiters, "
    "host-pool queue depths, pipeline stall state, breaker state, "
    "process RSS, running queries) into bounded per-series rings "
    "every sampler.intervalMs. Exported as rapids_sampler_* gauges on "
    "/metrics, rendered as sparklines on /console, and embedded as "
    "Chrome counter tracks in every flight-recorder dump.", _bool_conv)

OBS_SAMPLER_INTERVAL_MS = _register(
    "spark.rapids.obs.sampler.intervalMs", 200,
    "Resource-sampler period in milliseconds. Each tick reads ~10 "
    "in-process gauges (no locks shared with query hot paths, no "
    "device syncs); the ring covers ringSize*intervalMs of history.",
    int)

OBS_SAMPLER_RING = _register(
    "spark.rapids.obs.sampler.ringSize", 512,
    "Samples retained per sampler series (a bounded ring, newest "
    "kept). At the default 200ms interval, 512 samples cover the last "
    "~102 seconds.", int)


# ---------------------------------------------------------------------------
# the serving layer (runtime/serving): POST /sql on the obs endpoint
# ---------------------------------------------------------------------------

SERVING_ENABLED = _register(
    "spark.rapids.serving.enabled", False,
    "Attach the query-serving layer to the obs HTTP endpoint: POST /sql "
    "accepts {sql, session?, conf?, timeout_seconds?, cache?} documents, "
    "runs each request as a top-level action through the admission gate, "
    "the per-query device quotas, deadlines and cancellation, and "
    "returns the result as Arrow IPC bytes with the wall-time "
    "attribution. Needs spark.rapids.obs.enabled with a bindable "
    "spark.rapids.obs.port. The first session that sets it installs the "
    "process-wide server.", _bool_conv)

SERVING_MAX_SESSIONS = _register(
    "spark.rapids.serving.maxSessions", 16,
    "Bound on named client sessions the server builds (each a conf-"
    "overlay session on the root session's device, sharing its temp "
    "views). A request naming a session past the bound is refused with "
    "HTTP 429 and a typed error doc.", int)

SERVING_MAX_INFLIGHT = _register(
    "spark.rapids.serving.maxInflight", 32,
    "Bound on POST /sql requests inside the server at once (admitted or "
    "parked in the admission queue). A request past it is refused at "
    "once with HTTP 429.", int)

SERVING_RESULT_CACHE_ENABLED = _register(
    "spark.rapids.serving.resultCache.enabled", True,
    "Plan-digest-keyed result cache: a hit returns the byte-identical "
    "Arrow IPC stream of an earlier execution with the same (plan "
    "digest, table epoch, conf fingerprint) key, from host memory "
    "without touching the card. Any create_or_replace_temp_view bumps "
    "the epoch and orphans every entry; plans with rand bypass it; ANSI-"
    "divergent plans never share entries.", _bool_conv)

SERVING_RESULT_CACHE_MAX_BYTES = _register(
    "spark.rapids.serving.resultCache.maxBytes", 256 << 20,
    "Byte bound on cached result payloads (Arrow IPC stream bytes, exact "
    "len() accounting). Least-recently-used entries evict; every "
    "eviction is counted.", int)

SERVING_RESULT_CACHE_MAX_ENTRIES = _register(
    "spark.rapids.serving.resultCache.maxEntries", 64,
    "Entry bound on the result cache (LRU eviction, counted), "
    "independent of the byte bound.", int)

SERVING_WARM_BOOT_ENABLED = _register(
    "spark.rapids.serving.warmBoot.enabled", True,
    "Hold the first request on the warmup replay when warmup is armed "
    "(spark.rapids.compile.warmup.enabled + obs.historyDir), so the "
    "replay's kernel-library builds never land in a request's "
    "xla_compiles delta.", _bool_conv)

SERVING_WARM_BOOT_TIMEOUT_S = _register(
    "spark.rapids.serving.warmBoot.timeoutSeconds", 60.0,
    "Longest the first request waits for the warmup replay before "
    "serving anyway (0 = don't wait). A timeout degrades to cold "
    "serving, it never fails.", _float)

SERVING_REQUEST_NICE = _register(
    "spark.rapids.serving.requestNice", 0,
    "OS niceness (0-19) of the handler thread, and of the wave and pool "
    "threads working for it, for the duration of each request on this "
    "session: the serving QoS tier. It slows only the host's issue of "
    "that request's work; the card's kernels are not prioritized (no "
    "CUDA stream priorities). Best-effort: applied per thread with "
    "setpriority, skipped where the niceness could not be restored.",
    int)

STAGE_FUSION_ENABLED = _register(
    "spark.rapids.sql.stageFusion.enabled", True,
    "Collapse maximal linear chains of narrow operators (project, filter, "
    "expand, limit, the device decode) into one FusedStageExec, and absorb "
    "a chain feeding a partial or complete hash aggregate into its update "
    "(exec/stage_fusion.py): one host call a batch through the dispatch "
    "choke point per stage. The members' bodies run eagerly, one after "
    "another, on the current stream. A stage whose composed function "
    "fails to build falls back to the unfused chain; an error raised "
    "while a batch runs propagates.", _bool_conv)

MULTICHIP_ENABLED = _register(
    "spark.rapids.sql.multichip.enabled", False,
    "Shard whole fused stages across the `part` axis of the device mesh "
    "(parallel/mesh.py) and run them as one call a device a wave of "
    "partition batches (exec/sharded.py), with the hash exchange running "
    "as the mesh's lane exchange (parallel/exchange.py) instead of the "
    "device exchange. Stages the planner cannot shard (carries, LIMIT "
    "early exit, flat string planes) stay on the one-device fused path. "
    "Stage-cache keys gain a mesh fingerprint while this is on, so "
    "sharded and one-device functions never collide.", _bool_conv)

MULTICHIP_DEVICES = _register(
    "spark.rapids.sql.multichip.devices", 0,
    "Devices to place on the `part` axis of the execution mesh when "
    "multichip is enabled: 0 means every visible device, any other value "
    "is clamped to what the process has. 1 is a valid degenerate mesh: "
    "the whole shard and wave machinery runs over a single device.", int)

BATCH_CAPACITY_MIN = _register(
    "spark.rapids.tpu.batchCapacityMinRows", 1024,
    "Minimum padded row capacity of a device batch; capacities are rounded "
    "to the buckets of runtime/shapes.py.", int)

COMPILE_SHAPES_GROWTH = _register(
    "spark.rapids.compile.shapes.growthFactor", 2.0,
    "Geometric growth factor of the capacity padding buckets "
    "(runtime/shapes.py): every batch capacity snaps to the smallest "
    "bucket >= its row count. 2.0 (default) is next-power-of-two; smaller "
    "factors pad tighter with more distinct capacities. Clamped to "
    "[1.0625, 4.0].", float)

COMPILE_SHAPES_DTYPE_ALIGN = _register(
    "spark.rapids.compile.shapes.dtypeAlign", True,
    "Round capacity buckets requested with an itemsize up to whole tiles "
    "of the JAX package's layout (8x128 elements for 4-byte lanes, 16x128 "
    "for 2-byte, 32x128 for 1-byte), so both engines pad alike. Power-of-"
    "two buckets are aligned already.", _bool_conv)

OBS_AUDIT_ENABLED = _register(
    "spark.rapids.obs.audit.enabled", False,
    "Arm the kernel cost auditor (analysis/kernel_audit.py): the first "
    "dispatch of every (stage key, input signature) resolved through the "
    "keyed stage cache runs under a counting dispatch mode that charges "
    "each aten op the bytes of its tensor inputs and outputs and its "
    "operations, and each hand kernel its formula; later dispatches of "
    "the same signature add one dict increment. Joined with the "
    "attribution's device seconds into a per-query roofline: achieved "
    "GB/s and GFLOP/s, share of the peaks, a memory/compute/dispatch-"
    "overhead verdict and the bucket ladder's padding exposure "
    "(last_roofline(), explain('analyze'), history records, "
    "rapids_roofline_* gauges, the console).", _bool_conv)

OBS_AUDIT_PEAK_GBPS = _register(
    "spark.rapids.obs.audit.peakGbps", 3350.0,
    "Memory-bandwidth roofline in GB/s for roofline attribution (3350 = "
    "the NVIDIA H100 80GB HBM3 SXM's HBM3 bandwidth, data sheet, 700 W). "
    "Achieved GB/s is audited bytes over measured device seconds; "
    "roofline_pct_bw is its share of this peak.", _float)

OBS_AUDIT_PEAK_GFLOPS = _register(
    "spark.rapids.obs.audit.peakGflops", 66900.0,
    "Compute roofline in GFLOP/s for roofline attribution (66900 = the "
    "H100 SXM's FP32 rate on CUDA cores, data sheet, 700 W; none of the "
    "engine's arithmetic uses tensor cores). Drives roofline_pct_flops "
    "and the memory-vs-compute verdict.", _float)

OBS_AUDIT_OVERHEAD_FACTOR = _register(
    "spark.rapids.obs.audit.overheadBoundFactor", 10.0,
    "A kernel group whose measured device seconds exceed this multiple "
    "of its best-case roofline time (max of bytes/peakGbps and "
    "flops/peakGflops) classifies as dispatch_overhead-bound: the "
    "device is waiting on per-dispatch latency, not moving data or "
    "computing.", _float)

COMPILE_CACHE_DIR = _register(
    "spark.rapids.compile.cacheDir", "",
    "The directory the hand kernels' libraries build into (ops/_build.py; "
    "one sub-directory per source and flags hash, so a library built by "
    "an earlier process is only loaded). Empty (the default) keeps "
    "build/torch_kernels at the root of the checkout. Process-global: "
    "the first session naming a directory wins.", str)

COMPILE_WARMUP_ENABLED = _register(
    "spark.rapids.compile.warmup.enabled", False,
    "Warmup (runtime/warmup.py): at session start, replay the most "
    "recurrent successful queries recorded in spark.rapids.obs.historyDir "
    "(their SQL text rides in the history records) on a background "
    "service thread as each referenced table is registered, priming the "
    "keyed stage cache, the kernel libraries' loads and the caching "
    "allocator's pools before the first user query needs them. Replays "
    "run on a shadow session: they touch no user-visible session state, "
    "produce no history records, and a failure is logged, never "
    "raised.", _bool_conv)

COMPILE_WARMUP_MAX_PLANS = _register(
    "spark.rapids.compile.warmup.maxPlans", 8,
    "Upper bound on distinct recurring plans the warmup replays (ranked "
    "by recurrence count, most-recurrent first).", int)

COMPILE_WARMUP_MIN_RUNS = _register(
    "spark.rapids.compile.warmup.minRuns", 2,
    "Successful history runs of a plan digest required before warmup "
    "considers it recurring (1 replays everything ever run once).", int)

PROFILE_DIR = _register(
    "spark.rapids.profile.dir", "",
    "When set, each top-level action runs under torch.profiler and "
    "writes a Chrome trace into this directory (the structured trace's "
    "spans appear in it as record_function ranges). torch.profiler "
    "cannot nest: an action started while another capture is active "
    "raises.", str)


def keys():
    return list(_REGISTRY)


def registry() -> Dict[str, ConfEntry]:
    return dict(_REGISTRY)


class RapidsConf:
    """A snapshot of config values: defaults, then explicit overrides."""

    def __init__(self, overrides: Optional[dict] = None):
        self._values: Dict[str, Any] = {k: e.default
                                        for k, e in _REGISTRY.items()}
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def get(self, entry_or_key) -> Any:
        key = entry_or_key.key if isinstance(entry_or_key, ConfEntry) \
            else entry_or_key
        return self._values.get(key)

    def set(self, entry_or_key, value) -> "RapidsConf":
        key = entry_or_key.key if isinstance(entry_or_key, ConfEntry) \
            else entry_or_key
        if key in _REGISTRY and isinstance(value, str):
            value = _REGISTRY[key].conv(value)
        self._values[key] = value
        # the stage cache's conf fingerprint is memoized on the conf
        self.__dict__.pop("_compile_fp", None)
        return self

    def is_op_enabled(self, op_key: str) -> bool:
        """A derived per-operator key (spark.rapids.sql.exec.Sort,
        spark.rapids.sql.expression.Substring): unset is enabled."""
        v = self._values.get(op_key)
        if v is None:
            return True
        return _bool_conv(v) if isinstance(v, str) else bool(v)


_local = threading.local()


def session_conf() -> RapidsConf:
    """The conf of the session whose action this thread runs (set by the
    session before it executes, carried onto task-wave threads); the
    defaults where none is bound."""
    c = getattr(_local, "conf", None)
    return c if c is not None else RapidsConf()


def set_session_conf(c: Optional[RapidsConf]) -> None:
    """Bind a session's conf to this thread and publish what is read where
    no conf rides along, as the JAX package does: the capacity floor and
    the bucket ladder (``runtime/shapes.py``), and the keyed stage
    cache's conf fingerprint (``runtime/compile_cache.py``). Unbinding
    (None) publishes nothing."""
    _local.conf = c
    if c is None:
        return
    from spark_rapids_tpu_torch.columnar import batch as _b
    from spark_rapids_tpu_torch.runtime import compile_cache as _cc
    from spark_rapids_tpu_torch.runtime import shapes as _sh
    _b.MIN_CAPACITY = max(8, int(c.get(BATCH_CAPACITY_MIN)))
    _sh.configure(c.get(COMPILE_SHAPES_GROWTH),
                  c.get(COMPILE_SHAPES_DTYPE_ALIGN))
    _cc.publish_conf(c)
