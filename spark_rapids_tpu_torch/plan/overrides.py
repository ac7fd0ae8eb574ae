"""Plan conversion: logical plan nodes -> physical operators.

Counterpart of ``spark_rapids_tpu/plan/overrides.py`` ``convert_plan``
for this engine's nodes, with the Parquet filter pushdown that runs
before it. Convertible: in-memory, Parquet and cached scans, ranges,
unions, expands (stacked or one projection per batch, as the JAX
package's stage fusion would run them: ``mark_expand_forms``), projections
and filters over the expressions of ``expr/core.py`` (a filter that
reads the partition context, such as ``sample``'s ``rand``, over its input
collected into one partition), ``expr/math.py`` and the string
functions of ``expr/strings.py`` (length, upper/lower with the case-map
kernel, substring, concat, startswith/endswith/contains, transpilable
LIKE, string equality), hash and round-robin repartition, the hash
aggregate with its tiny-bucket, packed (scatter, segsum, sort) and sort
routes (string and float keys group by sorting; segmented aggregates such
as percentile take a hash exchange of raw rows by key first), sort (a range exchange
first over several partitions), limit and TopN, window functions (a hash
exchange on the partition keys, or a collect when there are none, below
``WindowExec``), equi-joins of every type, broadcast or shuffled as the
JAX package plans them with adaptive execution off, non-equi joins
(``BroadcastNestedLoopJoinExec``) and cross joins
(``CartesianProductExec``). Everything runs on one device: there is no
tagging and no CPU fallback yet, so what the JAX package would run on the
CPU raises ``NotImplementedError`` with its reason (a window ORDER BY on
strings, string window operands, bounded-rows min/max, min/max/first/last
over strings, min_by/max_by ordered by strings, ...), and so does
an expression the device cannot run (a LIKE pattern that needs the NFA, a
string ordering comparison).
"""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.io.parquet_pruning import split_conjuncts
from spark_rapids_tpu_torch.plan import nodes as P


def convert_plan(plan: P.PlanNode, conf, device) -> X.TorchExec:
    push_down_scan_filters(plan)
    root = _convert(plan, conf, device)
    mark_expand_forms(root)
    return root


def _convert(plan: P.PlanNode, conf, device) -> X.TorchExec:
    children = [_convert(c, conf, device) for c in plan.children]
    if isinstance(plan, P.InMemorySource):
        return X.InMemoryScanExec(plan, children, conf, device)
    if isinstance(plan, P.ParquetScan):
        if conf.get(C.DEVICE_DECODE_ENABLED):
            # the source coalesces row groups itself up to the reader
            # batch size, and encoded batches are not concatenable
            return X.DeviceDecodeScanExec(
                plan, [X.EncodedParquetSourceExec(plan, [], conf, device)],
                conf, device)
        return X.CoalesceBatchesExec(
            plan, [X.ParquetScanExec(plan, [], conf, device)], conf, device)
    if isinstance(plan, P.CachedRelation):
        return X.CachedScanExec(plan, children, conf, device)
    if isinstance(plan, P.Project):
        return X.ProjectExec(plan, children, conf, device)
    if isinstance(plan, P.Range):
        return X.RangeExec(plan, [], conf, device)
    if isinstance(plan, P.Filter):
        child = children[0]
        if E.needs_partition_context(plan.condition) \
                and child.num_partitions > 1:
            # the JAX package runs such a filter on the CPU, over its
            # input collected into one partition: partition 0, rows
            # counted from the first
            child = X.CollectExchangeExec(plan, [child], conf, device)
        return X.FilterExec(plan, [child], conf, device)
    if isinstance(plan, P.Union):
        return X.UnionExec(plan, children, conf, device)
    if isinstance(plan, P.Expand):
        return X.ExpandExec(plan, children, conf, device)
    if isinstance(plan, P.Repartition):
        if not plan.keys:
            return X.RoundRobinExchangeExec(plan, children, conf, device,
                                            plan.n_out)
        return X.ShuffleExchangeExec(plan, children, conf, device, plan.keys,
                                     plan.n_out)
    if isinstance(plan, P.Aggregate):
        return _convert_aggregate(plan, children[0], conf, device)
    if isinstance(plan, P.Limit):
        return _convert_limit(plan, children[0], conf, device)
    if isinstance(plan, P.Sort):
        return _convert_sort(plan, children[0], conf, device)
    if isinstance(plan, P.Join):
        return _convert_join(plan, children, conf, device)
    if isinstance(plan, P.WindowNode):
        return _convert_window(plan, children[0], conf, device)
    raise NotImplementedError(type(plan).__name__)


def _window_fallbacks(plan) -> List[str]:
    """What the JAX package's ``_tag_window`` sends to the CPU, with its
    reasons."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr import window as WE
    reasons = []
    for w in plan.window_exprs:
        spec, fn = w.spec, w.fn
        if any(isinstance(o.expr.data_type(), T.StringType)
               for o in spec.order_specs):
            reasons.append("window ORDER BY on strings needs host sort")
        if any(isinstance(c.data_type(), T.StringType) for c in fn.children):
            reasons.append("string-typed window operands run on CPU (device "
                           "window kernels are fixed-width planes)")
        frame = spec.resolved_frame()
        if isinstance(fn, (WE.NthValue, WE.FirstValue, WE.LastValue)) and (
                frame.lower is not None or frame.upper not in (0, None)):
            reasons.append(f"{type(fn).__name__} supports only "
                           f"unbounded-preceding frames ending at the "
                           f"current row or partition end")
        if isinstance(fn, WE.WindowAgg):
            if not isinstance(fn.fn, (A.Sum, A.Count, A.CountAll, A.Min,
                                      A.Max, A.Average)):
                reasons.append(f"{type(fn.fn).__name__} not supported in "
                               f"window frames on device")
            bounded_rows = frame.kind == "rows" and not (
                frame.lower is None and frame.upper in (0, None))
            if bounded_rows and isinstance(fn.fn, (A.Min, A.Max)):
                reasons.append("bounded-rows min/max window not yet on "
                               "device (needs a sliding-extrema kernel)")
    return reasons


def _convert_window(plan, child, conf, device):
    reasons = _window_fallbacks(plan)
    if reasons:
        raise NotImplementedError("WindowExec: " + "; ".join(reasons))
    if child.num_partitions > 1:
        # equal partition keys must meet in one partition
        spec = plan.window_exprs[0].spec
        if spec.partition_exprs:
            child = X.ShuffleExchangeExec(plan, [child], conf, device,
                                          spec.partition_exprs,
                                          child.num_partitions)
        else:
            child = X.CollectExchangeExec(plan, [child], conf, device)
    return X.WindowExec(plan, [child], conf, device)


#: ORDER BY + LIMIT n takes TopN up to this n
_TOPN_LIMIT = 100_000


def _convert_limit(plan, child, conf, device):
    if isinstance(child, X.SortExec) and plan.n <= _TOPN_LIMIT:
        # a global limit makes the sort's global order moot: TopN per
        # partition, then once more over the collected candidates
        inner = child.children[0]
        if isinstance(inner, (X.RangeExchangeExec, X.CollectExchangeExec)):
            inner = inner.children[0]
        orders = child.plan.orders
        local = X.TopNExec(plan, [inner], conf, device, orders, plan.n)
        if inner.num_partitions > 1:
            return X.TopNExec(
                plan, [X.CollectExchangeExec(plan, [local], conf, device)],
                conf, device, orders, plan.n)
        return local
    local = X.LimitExec(plan, [child], conf, device)
    if child.num_partitions > 1:
        return X.LimitExec(
            plan, [X.CollectExchangeExec(plan, [local], conf, device)],
            conf, device)
    return local


def _convert_sort(plan, child, conf, device):
    if child.num_partitions > 1 and plan.global_sort:
        # a range exchange + per-partition sorts order the whole; string
        # keys normalize to a hash, which is not their order: they collect
        if any(isinstance(o.expr.data_type(), T.StringType)
               for o in plan.orders):
            child = X.CollectExchangeExec(plan, [child], conf, device)
        else:
            child = X.RangeExchangeExec(plan, [child], conf, device,
                                        plan.orders, child.num_partitions)
    return X.SortExec(plan, [child], conf, device)


def _common_keys(plan):
    """The join keys cast to their common type on each side: murmur3 is
    width-sensitive, so both sides must hash the same type."""
    lks, rks = [], []
    for lk, rk in zip(plan.left_keys, plan.right_keys):
        ct = T.common_type(lk.data_type(), rk.data_type())
        lks.append(lk if lk.data_type() == ct else E.Cast(lk, ct))
        rks.append(rk if rk.data_type() == ct else E.Cast(rk, ct))
    return lks, rks


def _convert_join(plan, children, conf, device):
    """The JAX package's join planning with adaptive execution off: cross
    joins take the cartesian product, joins without equi keys the nested
    loop; otherwise a build side (the right) estimated at most
    spark.rapids.sql.join.broadcastRowThreshold rows broadcasts; a larger
    one under a multi-partition probe hash-exchanges both sides."""
    left, right = children
    if plan.how == "cross":
        return X.CartesianProductExec(plan, [left, right], conf, device)
    if not plan.left_keys:
        # a non-equi join: the nested loop over the whole build side;
        # right and full joins emit the unmatched build rows once, after
        # a single left partition
        if plan.how in ("right", "full") and left.num_partitions > 1:
            left = X.CollectExchangeExec(plan, [left], conf, device)
        return X.BroadcastNestedLoopJoinExec(plan, [left, right], conf,
                                             device)
    est = plan.children[1].estimated_rows()
    small = est is not None and est <= conf.get(
        C.BROADCAST_JOIN_ROW_THRESHOLD)
    multi = left.num_partitions > 1
    if multi and not small:
        lks, rks = _common_keys(plan)
        n_out = left.num_partitions
        left = X.ShuffleExchangeExec(plan, [left], conf, device, lks, n_out)
        right = X.ShuffleExchangeExec(plan, [right], conf, device, rks, n_out)
        return X.ShuffledHashJoinExec(plan, [left, right], conf, device,
                                      part_keys=(lks, rks))
    if plan.how in ("right", "full") and multi:
        left = X.CollectExchangeExec(plan, [left], conf, device)
    return X.BroadcastHashJoinExec(plan, [left, right], conf, device)


def _agg_fallbacks(plan) -> List[str]:
    """What the JAX package's aggregate rules send to the CPU
    (``_no_string_input``, ``_minmax_by_check``), with its reasons."""
    from spark_rapids_tpu_torch.expr import aggregates as A
    reasons = []
    for a in plan.aggs:
        fn = a.fn
        if isinstance(fn, (A.Min, A.Max, A.First, A.Last)) and any(
                isinstance(c.data_type(), T.StringType) for c in fn.children):
            reasons.append(f"{type(fn).__name__} over strings not supported "
                           f"on device")
        if isinstance(fn, A._MinMaxBy) \
                and isinstance(fn.children[1].data_type(), T.StringType):
            reasons.append(f"{type(fn).__name__} ordered by a string column "
                           f"runs on CPU")
    return reasons


def _convert_aggregate(plan, child, conf, device):
    reasons = _agg_fallbacks(plan)
    if reasons:
        raise NotImplementedError("HashAggregateExec: " + "; ".join(reasons)
                                  + " (a CPU fallback in the JAX package; "
                                  "ROADMAP A3)")
    pre_filter = None
    if isinstance(child, X.FilterExec) \
            and not E.needs_partition_context(child.plan.condition):
        # the filter folds into the aggregate's update as a live mask
        pre_filter = child.plan.condition
        child = child.children[0]
    if child.num_partitions > 1 and any(
            getattr(a.fn, "no_partial", False) for a in plan.aggs):
        # segmented aggregates have no mergeable state: raw rows meet by
        # group key (a hash exchange, or a collect without keys), then
        # each partition aggregates completely
        if plan.group_exprs:
            child = X.ShuffleExchangeExec(plan, [child], conf, device,
                                          plan.group_exprs,
                                          child.num_partitions)
        else:
            child = X.CollectExchangeExec(plan, [child], conf, device)
    elif child.num_partitions > 1:
        # one device holds every partition: collect them and aggregate
        # once, completely (the JAX package's single-device plan)
        child = X.CoalesceBatchesExec(
            plan, [X.CollectExchangeExec(plan, [child], conf, device)],
            conf, device)
    return X.HashAggregateExec(plan, [child], conf, device,
                               pre_filter=pre_filter)


# ---------------------------------------------------------------------------
# Parquet filter pushdown
# ---------------------------------------------------------------------------

def _as_pushed(e: E.Expression) -> Optional[E.Expression]:
    """Copy a conjunct into the shape row-group pruning reads
    (comparisons, IsNull/IsNotNull, And/Or over column refs and
    literals); None when it is not pushable."""
    if isinstance(e, E.BoundRef):
        return E.BoundRef(e.index, e.data_type(), e.name)
    if isinstance(e, E.Literal):
        return e
    if isinstance(e, E.Not):
        # only null-test negations have a sound pruning rewrite (negating
        # an interval comparison is unsound under three-valued logic)
        c = e.children[0]
        if isinstance(c, E.IsNull):
            return _as_pushed(E.IsNotNull(c.children[0]))
        if isinstance(c, E.IsNotNull):
            return _as_pushed(E.IsNull(c.children[0]))
        return None
    if isinstance(e, (E.And, E.Or, E.EqualTo, E.LessThan, E.LessThanOrEqual,
                      E.GreaterThan, E.GreaterThanOrEqual, E.IsNull,
                      E.IsNotNull)):
        kids = [_as_pushed(c) for c in e.children]
        if any(k is None for k in kids):
            return None
        return e.with_children(kids)
    return None


def _rename_refs(e: E.Expression,
                 nmap: Dict[str, str]) -> Optional[E.Expression]:
    """Rewrite column refs through a projection's output -> input name
    map; None when a ref does not map (a computed column)."""
    if isinstance(e, E.BoundRef):
        t = nmap.get(e.name)
        if t is None:
            return None
        return E.BoundRef(e.index, e.data_type(), t)
    if not e.children:
        return e
    kids = [_rename_refs(c, nmap) for c in e.children]
    if any(k is None for k in kids):
        return None
    return e.with_children(kids)


def push_down_scan_filters(plan: P.PlanNode) -> None:
    """Fill ParquetScan.pushed_filters from the Filter nodes above each
    scan, renamed through the projections between them. A scan reached
    from several branches gets the OR of the branches' conjunctions, and
    a branch that reaches it with no predicate turns pruning off.
    Idempotent: the lists are reassigned, not extended."""
    arrivals: Dict[int, List[List[E.Expression]]] = {}
    scans: Dict[int, P.ParquetScan] = {}

    def walk(node: P.PlanNode, conjs: List[E.Expression]) -> None:
        if isinstance(node, P.Filter):
            add = [p for p in map(_as_pushed, split_conjuncts(node.condition))
                   if p is not None]
            walk(node.children[0], conjs + add)
            return
        if isinstance(node, P.Project):
            nmap: Dict[str, str] = {}
            for name, ex in zip(node.names, node.exprs):
                inner = ex.children[0] if isinstance(ex, E.Alias) else ex
                if isinstance(inner, E.BoundRef):
                    nmap[name] = inner.name
            renamed = [r for r in (_rename_refs(c, nmap) for c in conjs)
                       if r is not None]
            walk(node.children[0], renamed)
            return
        if isinstance(node, P.ParquetScan):
            arrivals.setdefault(id(node), []).append(conjs)
            scans[id(node)] = node
            return
        for c in node.children:
            walk(c, [])

    walk(plan, [])
    for sid, paths in arrivals.items():
        scan = scans[sid]
        if any(not p for p in paths):
            scan.pushed_filters = []
        elif len(paths) == 1:
            scan.pushed_filters = list(paths[0])
        else:
            scan.pushed_filters = [reduce(E.Or, [reduce(E.And, p)
                                                 for p in paths])]


# ---------------------------------------------------------------------------
# The form of an Expand: the JAX package's stage-fusion gate
# ---------------------------------------------------------------------------

#: an Expand stacks at most this many projections into one batch
_EXPAND_STACK_MAX = 8


def _fusable(node) -> bool:
    """A member of a fusable chain in the JAX package
    (``exec/stage_fusion._fusable``): project, filter, limit, device
    decode, and an Expand of at most eight projections with a fixed-width
    output."""
    if isinstance(node, (X.ProjectExec, X.FilterExec, X.LimitExec,
                         X.DeviceDecodeScanExec)):
        return len(node.children) == 1
    if isinstance(node, X.ExpandExec):
        return (len(node.plan.projections) <= _EXPAND_STACK_MAX
                and not any(isinstance(dt, T.StringType)
                            for dt in node.plan.schema.types))
    return False


def _dispatching(node) -> bool:
    """Would the member cost the JAX package a dispatch unfused?"""
    if isinstance(node, X.ProjectExec):
        return node._trivial_indices() is None
    return isinstance(node, (X.FilterExec, X.ExpandExec,
                             X.DeviceDecodeScanExec))


def _has_carry(node) -> bool:
    """A projection threading the partition context keeps a carry, which
    bars its chain from an aggregate's update."""
    return isinstance(node, X.ProjectExec) and any(
        E.needs_partition_context(e) for e in node.plan.exprs)


def _chain(node):
    """The maximal fusable chain from node down, and the operator below
    it."""
    chain = []
    while _fusable(node):
        chain.append(node)
        node = node.children[0]
    return chain, node


def mark_expand_forms(node) -> None:
    """Stack each Expand that the JAX package's stage fusion (on, its
    default) would run fused (``exec/stage_fusion._rewrite``): a chain
    under an aggregate without segmented aggregates whose keys do not
    take the packed route is absorbed into its update; elsewhere a chain
    with two or more dispatching members becomes one fused stage. Every
    other Expand runs one projection per batch. This engine fuses
    nothing, so it has no fusion switch: with
    spark.rapids.sql.stageFusion.enabled=false the JAX package runs every
    Expand per projection and the two can take different routes."""
    if isinstance(node, X.HashAggregateExec) and not node.kern.has_custom \
            and not node.kern._packed_ok:
        chain, below = _chain(node.children[0])
        if chain and not any(_has_carry(m) for m in chain) \
                and any(_dispatching(m) for m in chain):
            _stack(chain)
            mark_expand_forms(below)
            return
    if _fusable(node):
        chain, below = _chain(node)
        if sum(1 for m in chain if _dispatching(m)) >= 2:
            _stack(chain)
            mark_expand_forms(below)
            return
    for c in node.children:
        mark_expand_forms(c)


def _stack(chain) -> None:
    for m in chain:
        if isinstance(m, X.ExpandExec):
            m.stacked = True
