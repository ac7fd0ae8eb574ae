"""Plan conversion: logical plan nodes -> physical operators.

Counterpart of ``spark_rapids_tpu/plan/overrides.py`` ``convert_plan``
for this engine's nodes. Everything runs on one device: there is no
tagging and no CPU fallback yet, so a node without a conversion raises
``NotImplementedError`` with its name.
"""
from __future__ import annotations

from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.plan import nodes as P


def convert_plan(plan: P.PlanNode, conf, device) -> X.TorchExec:
    children = [convert_plan(c, conf, device) for c in plan.children]
    if isinstance(plan, P.InMemorySource):
        return X.InMemoryScanExec(plan, children, conf, device)
    if isinstance(plan, P.CachedRelation):
        return X.CachedScanExec(plan, children, conf, device)
    if isinstance(plan, P.Project):
        return X.ProjectExec(plan, children, conf, device)
    if isinstance(plan, P.Filter):
        return X.FilterExec(plan, children, conf, device)
    if isinstance(plan, P.Repartition):
        if not plan.keys:
            raise NotImplementedError("RoundRobinExchangeExec")
        return X.ShuffleExchangeExec(plan, children, conf, device, plan.keys,
                                     plan.n_out)
    if isinstance(plan, P.Aggregate):
        return _convert_aggregate(plan, children[0], conf, device)
    raise NotImplementedError(type(plan).__name__)


def _convert_aggregate(plan, child, conf, device):
    pre_filter = None
    if isinstance(child, X.FilterExec):
        # the filter folds into the aggregate's update as a live mask
        pre_filter = child.plan.condition
        child = child.children[0]
    if child.num_partitions > 1:
        # one device holds every partition: collect them and aggregate
        # once, completely (the JAX package's single-device plan)
        child = X.CoalesceBatchesExec(
            plan, [X.CollectExchangeExec(plan, [child], conf, device)],
            conf, device)
    return X.HashAggregateExec(plan, [child], conf, device,
                               pre_filter=pre_filter)
