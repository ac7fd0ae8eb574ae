"""The static cost pass (counterpart of the first half of
``spark_rapids_tpu/plan/cost.py``; reference CostBasedOptimizer.scala:54,
CpuCostModel :284 / GpuCostModel :334).

With spark.rapids.sql.optimizer.enabled (off by default) it estimates each
operator's cost from row statistics and per-operator scores (the
operatorsScore.csv analog) and reverts a device subtree to the CPU where
the device plan plus its transfer and fixed dispatch costs loses to the
CPU. It only ever reverts, never forces, so results are unaffected. The
scores and the reason text are the JAX package's, so both packages revert
the same subtrees with the same words.

The JAX package's second half, the measured cost pass
(``MeasuredHints``, spark.rapids.sql.adaptive.measuredCost.enabled), reads
the query history store and waits for ROADMAP A11d.
"""
from __future__ import annotations

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
