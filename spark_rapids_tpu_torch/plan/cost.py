"""The cost passes (counterpart of ``spark_rapids_tpu/plan/cost.py``;
reference CostBasedOptimizer.scala:54, CpuCostModel :284 / GpuCostModel
:334).

The static pass: with spark.rapids.sql.optimizer.enabled (off by default)
it estimates each operator's cost from row statistics and per-operator
scores (the operatorsScore.csv analog) and reverts a device subtree to
the CPU where the device plan plus its transfer and fixed dispatch costs
loses to the CPU. It only ever reverts, never forces, so results are
unaffected. The scores and the reason text are the JAX package's, so both
packages revert the same subtrees with the same words.

The measured pass (``MeasuredHints``,
spark.rapids.sql.adaptive.measuredCost.enabled): before a plan converts,
the latest successful history record of the same plan digest that carries
a roofline verdict decides the hints that conversion reads on this thread
(``install_hints``/``current_hints``): the aggregate exchange's partition
count and the exchanges' coalesceTinyRows threshold. Its third hint,
``fusion_min_members``, is derived and shows in the decision's detail, but
nothing reads it while the port has no stage fusion (ROADMAP A11e); the
JAX package with spark.rapids.sql.stageFusion.enabled=false behaves the
same way. Only the kernel cost auditor (A11e) writes roofline verdicts,
so until then a record carries one only where someone appended it.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.plan import nodes as P

#: relative cost to evaluate one row on each side: (cpu_per_row,
#: device_per_row)
OP_SCORES = {
    "Project": (1.0, 0.02),
    "Filter": (1.0, 0.02),
    "Aggregate": (4.0, 0.05),
    "Join": (6.0, 0.1),
    "Sort": (5.0, 1.0),
    "WindowNode": (6.0, 0.2),
}
TRANSFER_PER_ROW = 0.5
FIXED_DISPATCH = 50_000.0  # a round trip's latency in row-costs


def _plan_costs(plan: P.PlanNode, inherited_rows: int) -> tuple:
    """(cpu_cost, device_cost); the device cost covers compute and
    per-operator dispatch, the transfer is added once by the caller. A
    node without statistics inherits the nearest ancestor's estimate."""
    rows = plan.estimated_rows()
    rows = inherited_rows if rows is None else rows
    cpu_score, dev_score = OP_SCORES.get(type(plan).__name__, (1.0, 0.05))
    cpu = rows * cpu_score
    dev = rows * dev_score + FIXED_DISPATCH
    for c in plan.children:
        ccpu, cdev = _plan_costs(c, rows)
        cpu += ccpu
        dev += cdev
    return cpu, dev


def apply_cost_optimizer(meta, conf) -> None:
    """Walk the tagged meta tree; where a subtree's device cost with its
    input transfer exceeds its CPU cost, add a reason so conversion falls
    back (the reference's revert pass)."""
    if not conf.get(C.OPTIMIZER_ENABLED):
        return
    _visit(meta)


def _visit(meta) -> None:
    if meta.can_run_on_tpu:
        rows = meta.plan.estimated_rows()
        if rows is not None:
            cpu, dev = _plan_costs(meta.plan, rows)
            transfer = rows * TRANSFER_PER_ROW
            if dev + transfer > cpu:
                reason = (
                    f"cost model: est. TPU cost {dev + transfer:.0f} > "
                    f"CPU cost {cpu:.0f} for ~{rows} rows "
                    f"(spark.rapids.sql.optimizer.enabled)")
                _revert_all(meta, reason)
                return
    for c in meta.children:
        _visit(c)


def _revert_all(meta, reason: str) -> None:
    """Mark the whole subtree: a reverted root over device children would
    still move every batch across, the transfer the reversion avoids."""
    meta.reasons.append(reason)
    for c in meta.children:
        _revert_all(c, reason)


# ---------------------------------------------------------------------------
# the measured cost pass (the history-fed half of adaptive execution)
# ---------------------------------------------------------------------------

class MeasuredHints:
    """Per-plan conversion hints derived from audited history. A field is
    None when the measurement prescribes no change; the static plan is
    always the fallback."""

    __slots__ = ("digest", "basis", "exchange_parts",
                 "coalesce_tiny_rows", "fusion_min_members")

    def __init__(self, digest: str, basis: str,
                 exchange_parts: Optional[int] = None,
                 coalesce_tiny_rows: Optional[int] = None,
                 fusion_min_members: Optional[int] = None):
        self.digest = digest
        #: what measurement produced these hints (the decision detail)
        self.basis = basis
        #: n_out of a group-key aggregate's exchange; 1 collapses the hash
        #: exchange to a collect
        self.exchange_parts = exchange_parts
        #: spark.rapids.shuffle.coalesceTinyRows for this plan's exchanges
        self.coalesce_tiny_rows = coalesce_tiny_rows
        #: the fewest dispatching members of a fused stage (no reader in
        #: the port until stage fusion, ROADMAP A11e)
        self.fusion_min_members = fusion_min_members

    def any(self) -> bool:
        return (self.exchange_parts is not None
                or self.coalesce_tiny_rows is not None
                or self.fusion_min_members is not None)

    def detail(self) -> dict:
        d = {"digest": self.digest, "basis": self.basis}
        if self.exchange_parts is not None:
            d["exchange_parts"] = self.exchange_parts
        if self.coalesce_tiny_rows is not None:
            d["coalesce_tiny_rows"] = self.coalesce_tiny_rows
        if self.fusion_min_members is not None:
            d["fusion_min_members"] = self.fusion_min_members
        return d


_TLS = threading.local()

#: per-process memo of digest -> (history file signature, hints); the
#: history file only appends, so a changed (size, mtime_ns) invalidates
_HINT_CACHE: dict = {}
_HINT_CACHE_CAP = 256


def install_hints(hints: Optional[MeasuredHints]) -> None:
    """Bind hints to this thread for one convert_plan (the session wraps
    the call in install/clear)."""
    _TLS.hints = hints


def clear_hints() -> None:
    _TLS.hints = None


def current_hints() -> Optional[MeasuredHints]:
    return getattr(_TLS, "hints", None)


def _history_store():
    from spark_rapids_tpu_torch.runtime import obs as OBS
    st = OBS.state()
    return st.history if st is not None else None


def _file_sig(path: str):
    try:
        s = os.stat(path)
        return (s.st_size, s.st_mtime_ns)
    except OSError:
        return None


def measured_hints(plan, conf) -> Optional[MeasuredHints]:
    """Conversion hints for this plan from its own audited history: the
    latest successful record of the same digest that carries a roofline
    doc decides.

    - shuffle group dispatch_overhead-bound: the exchange is pure
      per-partition launch tax. Collapse group-key aggregate exchanges to
      one partition (exchange_parts=1) and coalesce harder (4x
      coalesceTinyRows), unless spark.rapids.shuffle.mode is ICI.
    - device_compute group dispatch_overhead-bound: coalesce harder and
      pin stage fusion at its most aggressive legal boundary
      (fusion_min_members=2).

    None (the static plan) when adaptive execution or the measured pass
    is off, no history store is open, the digest has no audited record,
    or the verdicts prescribe nothing."""
    if not conf.get(C.ADAPTIVE_ENABLED) \
            or not conf.get(C.ADAPTIVE_MEASURED_COST):
        return None
    store = _history_store()
    if store is None:
        return None
    from spark_rapids_tpu_torch.plan.prune import prune_plan
    from spark_rapids_tpu_torch.runtime.obs.history import plan_digest
    try:
        # an action's record digests its plan after convert_plan's
        # pruning, which rewrites the plan in place on its first
        # conversion: prune first, so a DataFrame built anew finds the
        # records of the same query (ROADMAP C26)
        prune_plan(plan)
        digest = plan_digest(plan)
    except Exception:  # noqa: BLE001 - an undigestable plan has no
        return None  # history to measure against
    sig = _file_sig(store.path)
    if sig is None:
        return None
    cached = _HINT_CACHE.get(digest)
    if cached is not None and cached[0] == sig:
        return cached[1]
    roof = None
    try:
        for rec in reversed(store.by_digest(digest)):
            if rec.get("status") == "ok" and rec.get("roofline"):
                roof = rec["roofline"]
                break
    except Exception:  # noqa: BLE001 - a torn or corrupt history file
        return None  # never fails planning
    hints = _derive(digest, roof, conf) if roof is not None else None
    if hints is not None and not hints.any():
        hints = None
    if len(_HINT_CACHE) >= _HINT_CACHE_CAP:
        _HINT_CACHE.clear()
    _HINT_CACHE[digest] = (sig, hints)
    return hints


def _derive(digest: str, roof: dict, conf) -> Optional[MeasuredHints]:
    groups = roof.get("groups") or {}
    shuffle_bound = (groups.get("shuffle") or {}).get("bound")
    compute_bound = (groups.get("device_compute") or {}).get("bound")
    exchange_parts = None
    coalesce = None
    fusion_min = None
    if shuffle_bound == "dispatch_overhead" \
            and str(conf.get(C.SHUFFLE_MODE)).upper() != "ICI":
        exchange_parts = 1
        coalesce = 4 * int(conf.get(C.SHUFFLE_COALESCE_TINY_ROWS))
    if compute_bound == "dispatch_overhead":
        if coalesce is None:
            coalesce = 4 * int(conf.get(C.SHUFFLE_COALESCE_TINY_ROWS))
        fusion_min = 2
    basis = (f"shuffle={shuffle_bound or 'n/a'},"
             f"device_compute={compute_bound or 'n/a'}")
    return MeasuredHints(digest, basis, exchange_parts=exchange_parts,
                         coalesce_tiny_rows=coalesce,
                         fusion_min_members=fusion_min)


def reset_for_tests() -> None:
    _HINT_CACHE.clear()
    clear_hints()
