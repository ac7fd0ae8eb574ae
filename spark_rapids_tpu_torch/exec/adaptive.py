"""Adaptive query execution (counterpart of
``spark_rapids_tpu/exec/adaptive.py``).

The compact exchange already knows exact per-partition row counts on the
host (one offsets fetch per batch). This module turns them into run-time
decisions:

- ``AdaptiveShuffledHashJoinExec``: materialize the build side's exchange
  first; when its measured bytes land at or under
  spark.rapids.sql.adaptive.broadcastThresholdBytes, the probe side's
  exchange never runs and the join replans as a broadcast hash join over
  the raw probe partitions.
- the skew policy of the exchanges (``skew_threshold``): a partition
  whose rows exceed skewFactor x the median splits into bounded in-order
  slices (the split itself lives on ``exec/nodes._ExchangeExec``).
- a cross-query broadcast-build cache keyed by build-plan digest and the
  table epoch: every temp-view registration empties it, and an entry is
  honoured only while its cached relation and that relation's
  materialization are the live ones.
- the decision recorder: every decision emits an ``aqeDecision`` trace
  instant and a ``rapids_aqe_decisions_total{kind}`` counter, lands in
  the open query's list (the session's ``last_aqe()``, EXPLAIN ANALYZE's
  "adaptive" section and the history record's ``aqe``), and its saved
  dispatches count into ``rapids_aqe_dispatches_saved_total``.

The measured cost pass (``plan/cost.py``: partition counts and coalesce
thresholds from per-digest history) records its decision through this
module too, so every adaptive piece shares one observable surface.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.runtime import trace as TR

# ---------------------------------------------------------------------------
# decision recorder
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: the open query's decision list (a top-level collect opens it; None
#: between queries: a decision then still traces and counts, it just has
#: no query doc to land in)
_CUR: Optional[List[dict]] = None

#: decision kinds (the rapids_aqe_decisions_total label values)
BROADCAST_CONVERSION = "broadcast_conversion"
SKEW_SPLIT = "skew_split"
BUILD_REUSE = "build_reuse"
MEASURED_COST = "measured_cost"


def enabled(conf) -> bool:
    return bool(conf.get(C.ADAPTIVE_ENABLED))


def on_query_start(conf=None) -> None:
    """Open the active query's decision list."""
    global _CUR
    with _LOCK:
        _CUR = []


def record(kind: str, *, dispatches_saved: int = 0, **detail: Any) -> None:
    """One adaptive decision: appended to the open query's list, traced
    as an ``aqeDecision`` instant and counted in the process registry."""
    d: Dict[str, Any] = {"kind": kind}
    d.update(detail)
    if dispatches_saved:
        d["dispatches_saved"] = int(dispatches_saved)
    with _LOCK:
        if _CUR is not None:
            _CUR.append(d)
    try:
        TR.instant("aqeDecision", cat="adaptive", args=d,
                   level=TR.ESSENTIAL)
    except Exception:  # noqa: BLE001 - a marker failure must not fail
        pass  # the query the decision just sped up
    try:
        from spark_rapids_tpu_torch.runtime import obs as OBS
        st = OBS.state()
        if st is not None:
            st.registry.counter(
                "rapids_aqe_decisions_total",
                "Adaptive execution decisions by kind (aqeDecision "
                "instants; spark.rapids.sql.adaptive.*).",
                labels={"kind": kind}).inc()
            if dispatches_saved:
                st.registry.counter(
                    "rapids_aqe_dispatches_saved_total",
                    "Device dispatches adaptive execution avoided "
                    "(broadcast conversions skipping probe-side "
                    "exchanges, reused broadcast builds).").inc(
                        int(dispatches_saved))
    except Exception:  # noqa: BLE001 - observability never fails a query
        pass


def finish_query() -> Optional[dict]:
    """Close the active query's decision list into its ``aqe`` doc
    (``decisions``, per-kind ``counts``, total ``dispatches_saved``); None
    when the query made no adaptive decision."""
    global _CUR
    with _LOCK:
        cur, _CUR = _CUR, None
    if not cur:
        return None
    counts: Dict[str, int] = {}
    saved = 0
    for d in cur:
        counts[d["kind"]] = counts.get(d["kind"], 0) + 1
        saved += int(d.get("dispatches_saved", 0))
    return {"decisions": cur, "counts": counts, "dispatches_saved": saved}


def render_text(doc: Optional[dict]) -> List[str]:
    """EXPLAIN ANALYZE's "adaptive" section, one line a decision."""
    if not doc:
        return []
    n = sum(doc.get("counts", {}).values())
    lines = [f"-- adaptive ({n} decision{'s' if n != 1 else ''}, "
             f"{doc.get('dispatches_saved', 0)} dispatches saved) --"]
    for d in doc.get("decisions", []):
        detail = ", ".join(f"{k}={v}" for k, v in d.items()
                           if k != "kind")
        lines.append(f"  {d['kind']}" + (f": {detail}" if detail else ""))
    return lines


# ---------------------------------------------------------------------------
# cross-query broadcast-build cache (digest + table epoch keyed)
# ---------------------------------------------------------------------------

#: bumped by every temp-view (re-)registration: a key minted under an
#: older epoch never hits again
_TABLE_EPOCH = 0
_BUILD_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_BUILD_CACHE_CAP = 8


def table_epoch() -> int:
    with _LOCK:
        return _TABLE_EPOCH


def bump_table_version() -> None:
    """A temp view was (re-)registered: empty the whole digest cache. The
    digest cannot tell which relation a name now resolves to, and stale
    entries would pin replaced device memory."""
    global _TABLE_EPOCH
    with _LOCK:
        _TABLE_EPOCH += 1
        _BUILD_CACHE.clear()


def _build_cache_key(build_plan, skey) -> Optional[tuple]:
    try:
        from spark_rapids_tpu_torch.runtime.obs.history import plan_digest
        digest = plan_digest(build_plan)
    except Exception:  # noqa: BLE001 - an undigestable build just
        return None  # does not take part in cross-query reuse
    with _LOCK:
        epoch = _TABLE_EPOCH
    return (digest, skey, epoch)


def _reuse_on(conf) -> bool:
    return enabled(conf) and bool(conf.get(C.ADAPTIVE_BUILD_REUSE))


def build_cache_get(conf, build_plan, skey, anchor) -> Optional[dict]:
    """The materialized broadcast build of this build-plan digest. The
    digest normalizes cached-relation state out (two same-shaped
    relations collide), so a hit counts only while the entry's anchor and
    its materialization are the live ones, by identity."""
    if anchor is None or not _reuse_on(conf):
        return None
    key = _build_cache_key(build_plan, skey)
    if key is None:
        return None
    with _LOCK:
        entry = _BUILD_CACHE.get(key)
        if entry is None:
            return None
        if entry.get("anchor") is not anchor \
                or entry["mat"] is not anchor.materialized:
            del _BUILD_CACHE[key]  # stale: stop pinning old batches
            return None
        _BUILD_CACHE.move_to_end(key)
    return entry


def build_cache_put(conf, build_plan, skey, anchor, entry: dict) -> None:
    if anchor is None or not _reuse_on(conf):
        return
    key = _build_cache_key(build_plan, skey)
    if key is None:
        return
    e = dict(entry)
    e["anchor"] = anchor
    with _LOCK:
        while len(_BUILD_CACHE) >= _BUILD_CACHE_CAP:
            _BUILD_CACHE.popitem(last=False)
        _BUILD_CACHE[key] = e


# ---------------------------------------------------------------------------
# skew policy (the split itself lives on _ExchangeExec)
# ---------------------------------------------------------------------------

def skew_threshold(conf, totals: List[Optional[int]]
                   ) -> Optional[Tuple[int, int]]:
    """(threshold_rows, median_rows) of a materialized exchange's
    per-partition row totals, or None when splitting must not engage:
    adaptive off, factor <= 0, fewer than 2 partitions with known counts,
    or nothing above the threshold. A ``None`` total (a count that would
    sync) stays out of the median and its partition never splits."""
    if not enabled(conf):
        return None
    factor = float(conf.get(C.ADAPTIVE_SKEW_FACTOR))
    if factor <= 0:
        return None
    known = sorted(t for t in totals if t is not None)
    if len(known) < 2:
        return None
    mid = len(known) // 2
    median = known[mid] if len(known) % 2 else (
        (known[mid - 1] + known[mid]) // 2)
    threshold = int(factor * max(median, 1))
    if known[-1] <= threshold:
        return None
    return threshold, max(int(median), 1)


# ---------------------------------------------------------------------------
# shuffle-hash -> broadcast conversion
# ---------------------------------------------------------------------------

class AdaptiveShuffledHashJoinExec(X.TorchExec):
    """A join planned as shuffled that measures before it dispatches the
    probe side: the build side's exchange materializes first, and when
    its device bytes land at or under broadcastThresholdBytes the join
    becomes a broadcast hash join over the raw probe partitions, fed by
    the exchange's batches. Over the threshold (or when measuring would
    sync a count) the materialized exchange feeds the shuffled join: the
    build side never runs twice. Right and full joins keep the shuffled
    plan: they track build-side matches across the whole probe side."""

    def __init__(self, plan, children, conf, device, part_keys):
        super().__init__(plan, children, conf, device)
        self.part_keys = part_keys
        self._lock = threading.Lock()
        self._chosen: Optional[X.TorchExec] = None

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    @staticmethod
    def _measure(parts) -> Optional[Tuple[int, int, int]]:
        """(device bytes, rows, batches) of a materialized exchange's
        output, or None when any count would sync (masked sub-batches,
        or a serialized exchange's lazily decoded blobs): the decision
        stays free."""
        nbytes = nrows = nbatches = 0
        for part in parts:
            for b in part:
                if not isinstance(b, ColumnarBatch) \
                        or b.row_mask is not None \
                        or not isinstance(b.num_rows, int):
                    return None
                nrows += b.num_rows
                nbytes += int(b.device_memory_size())
                nbatches += 1
        return nbytes, nrows, nbatches

    def _choose(self) -> X.TorchExec:
        with X._materializing(self._lock):
            if self._chosen is not None:
                return self._chosen
            left, right = self.children
            lkeys, rkeys = self.part_keys
            n_out = left.num_partitions
            rex = X.ShuffleExchangeExec(self.plan, [right], self.conf,
                                        self.device, rkeys, n_out)
            threshold = int(self.conf.get(C.ADAPTIVE_BROADCAST_BYTES))
            measured = None
            if threshold > 0 and enabled(self.conf) \
                    and self.plan.how not in ("right", "full"):
                parts = rex._materialize()
                measured = self._measure(parts)
            if measured is not None and measured[0] <= threshold:
                nbytes, nrows, nbatches = measured
                batches = [b for part in parts for b in part]
                src = X._MaterializedExec(self.plan.children[1], batches,
                                          self.conf, self.device)
                self._chosen = X.BroadcastHashJoinExec(
                    self.plan, [left, src], self.conf, self.device)
                # the avoided work: the probe side's counting sorts and
                # offsets fetches, estimated by the build side's own
                saved = rex.partition_dispatches + rex.partition_fetches
                record(BROADCAST_CONVERSION, build_bytes=nbytes,
                       build_rows=nrows, build_batches=nbatches,
                       threshold_bytes=threshold, n_out=n_out,
                       dispatches_saved=max(saved, 1))
            else:
                lex = X.ShuffleExchangeExec(self.plan, [left], self.conf,
                                            self.device, lkeys, n_out)
                self._chosen = X.ShuffledHashJoinExec(
                    self.plan, [lex, rex], self.conf, self.device,
                    part_keys=self.part_keys)
            return self._chosen

    def execute_partition(self, pidx):
        yield from self._choose().execute_partition(pidx)


# ---------------------------------------------------------------------------
# test hook
# ---------------------------------------------------------------------------

def reset_for_tests() -> None:
    """Drop all process-global adaptive state: the open decision list,
    the build cache and the table epoch."""
    global _CUR, _TABLE_EPOCH
    with _LOCK:
        _CUR = None
        _TABLE_EPOCH = 0
        _BUILD_CACHE.clear()
