"""Whole-stage fusion: one host call a batch for each stage of narrow operators.

Counterpart of ``spark_rapids_tpu/exec/stage_fusion.py``, on by default
(spark.rapids.sql.stageFusion.enabled). The planner pass (``fuse_stages``,
run by ``plan/overrides.convert_plan`` after conversion) walks the
converted tree and collapses maximal linear chains of narrow operators,
in the JAX package's two shapes:

- a chain of narrow operators (non-trivial Project, Filter, Expand,
  Limit, the device decode) with at least two dispatching members
  becomes a ``FusedStageExec``, whose per-batch function composes the
  members' stage bodies (``fuse.StageBody``) inside one ``fuse.fused``
  entry, threading the ANSI error planes and the members' carries (a
  projection's row base, a limit's remaining budget);
- a chain feeding the update of a partial or complete
  ``HashAggregateExec`` is absorbed into it (``pre_chain``) when the
  aggregate takes the tiny-bucket, sort or global route: no segmented
  aggregate and no packed keys, whose route needs host probes of the
  evaluated keys.

Port difference (the Hopper analog of the JAX package's one ``jit`` a
stage, ROADMAP's stated differences): the composed function runs the
members' bodies eagerly, one after another, on the current CUDA stream,
so on the card each member still launches its own kernels. A stage keeps
everything else the JAX package's has: one host call a batch through the
dispatch choke point (one cancel checkpoint, fault site and watchdog
guard), one ``stageDispatches`` count, the members' lazy row counts and
their even split of ``opTime``, the carries and the early stop at an
exhausted LIMIT. The fallback is narrower: the JAX package replays the
unfused chain when a composed trace fails; here only BUILDING the
composed function may fail over to the unfused chain (logged, and
``_failed``/``_chain_failed`` set). An error raised while a batch runs (a
SparkException, a ``KernelError``, an OOM, a cancellation, a CUDA error)
propagates unchanged and is never retried unfused.
"""
from __future__ import annotations

import logging
import time

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import compiled, fuse
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.expr.core import needs_partition_context
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import trace as TR

_LOG = logging.getLogger("spark_rapids_tpu_torch")


def _build_may_fall_back(ex: Exception) -> bool:
    """A build failure the unfused chain may replace: not an ANSI or
    analysis error, and not a cancellation."""
    from spark_rapids_tpu_torch.expr.core import SparkException
    from spark_rapids_tpu_torch.runtime.lifecycle import QueryCancelledError
    return not isinstance(ex, (SparkException, QueryCancelledError))


def rebuild_chain(members, source):
    """The original unfused operator chain over ``source`` (members
    child-most first). Each rebuilt operator shares its member's metrics,
    so rows through the fallback still show under the members."""
    prev = source
    for m in members:
        prev = type(m)(m.plan, [prev], m.conf, m.device)
        prev.metrics = m.metrics
    return prev


class FusedStageExec(X.TorchExec):
    """A linear chain of narrow operators run as ONE composed function a
    batch. ``members`` are the original operators, child-most first: they
    keep their plan nodes and metrics, but only their stage bodies run."""

    def __init__(self, plan, children, conf, device, members, stage_id=0):
        super().__init__(plan, children, conf, device)
        self.members = members
        self.stage_id = stage_id
        self.bodies = [m.stage_body() for m in members]
        self._key = ("fused_stage", tuple(b.key for b in self.bodies))
        self._failed = False

    @property
    def schema(self):
        return self.members[-1].schema

    def name(self) -> str:
        ops = "+".join(type(m).__name__.replace("Exec", "")
                       for m in reversed(self.members))
        return f"FusedStageExec({ops})"

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        sid = self.stage_id
        lines = [f"{pad}*({sid}) {self.name()}"]
        for m in reversed(self.members):
            lines.append(f"{pad}  *({sid}) {type(m).__name__} "
                         f"<- {m.plan.describe()} [fused]")
        lines.append(self.children[0].tree_string(indent + 1))
        return "\n".join(lines)

    def _build(self):
        bodies = self.bodies

        def build():
            fns = [b.builder() for b in bodies]

            def fn(batch, pid, carries):
                errs_all, rows, out_carries = [], [], []
                for f, c in zip(fns, carries):
                    batch, errs, c2 = f(batch, pid, c)
                    errs_all.append(errs)
                    out_carries.append(c2)
                    rows.append(X.live_rows(batch))
                return batch, errs_all, out_carries, rows
            return fn
        return build

    def _unfused_chain(self, source):
        return rebuild_chain(self.members, source)

    def _carry_bounds(self, in_batch, out_batch):
        bounds = [c.bounds for c in in_batch.columns]
        for b in self.bodies:
            if b.bounds_map is None:
                return
            bounds = b.bounds_map(bounds)
        for c, bd in zip(out_batch.columns, bounds):
            if bd is not None:
                c.bounds = bd

    def execute_partition(self, pidx):
        if self._failed:
            yield from self._unfused_chain(
                self.children[0]).execute_partition(pidx)
            return
        try:
            fn = fuse.fused(self._key, self._build())
        except Exception as ex:  # noqa: BLE001 - filtered below
            if not _build_may_fall_back(ex):
                raise
            self._failed = True
            _LOG.warning("stage fusion build failed for %s; falling back "
                         "to the unfused chain", self.name(), exc_info=True)
            yield from self._unfused_chain(
                self.children[0]).execute_partition(pidx)
            return
        from spark_rapids_tpu_torch.runtime.pipeline import start_d2h
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        in_batches = self.metrics.metric(M.NUM_INPUT_BATCHES)
        disp = self.metrics.metric(M.STAGE_DISPATCHES)
        # opTime: the call's host time splits evenly across members (the
        # stage records only dispatch and row metrics itself, so summing
        # opTime over a snapshot counts it once)
        member_t = [m.metrics.metric(M.OP_TIME) for m in self.members]
        member_rows = [m.metrics.metric(M.NUM_OUTPUT_ROWS)
                       for m in self.members]
        exhaust_idx = [i for i, b in enumerate(self.bodies) if b.exhausts]
        carries = [b.init_carry() for b in self.bodies]
        rng = fuse.stage_range(f"FusedStage#{self.stage_id}")
        for batch in self.children[0].execute_partition(pidx):
            self._acquire()
            in_batches.add(1)
            t0 = time.perf_counter_ns()
            with rng():
                out, errs_all, carries, rows = fn(batch, pidx, carries)
            dt = time.perf_counter_ns() - t0
            if TR.active() is not None:
                TR.emit_span(self.name(), t0, dt, cat="exec", args={
                    "stage_id": self.stage_id,
                    "members": len(self.members)})
                TR.instant("stageDispatch", cat="dispatch",
                           args={"stage_id": self.stage_id})
            for errs in errs_all:
                compiled.raise_errors(errs)
            disp.add(1)
            share = dt // len(self.members)
            for mt, mr, r in zip(member_t, member_rows, rows):
                mt.add(share)
                mr.add(r)
            out_rows.add(out.num_rows)
            self._carry_bounds(batch, out)
            # the budget's copy to the host starts before the yield and is
            # read after it, so it overlaps the consumer's work
            pending = [start_d2h(carries[i]) for i in exhaust_idx]
            yield out
            # LIMIT early exit: a zero budget means every later batch is
            # all-dead; stop consuming input (one scalar read a batch,
            # only with a limit member)
            if pending and all(int(p.numpy()) <= 0 for p in pending):
                return


# ---------------------------------------------------------------------------
# The planner pass
# ---------------------------------------------------------------------------

def _fusable(node) -> bool:
    """Static chain membership (JAX ``stage_fusion._fusable``). Trivial
    projections join chains for free but never justify one
    (``_dispatching``). Port-only: a filter reading the partition context
    stays out (the JAX package runs it on the CPU)."""
    if isinstance(node, X.FilterExec):
        return len(node.children) == 1 \
            and not needs_partition_context(node.plan.condition)
    if isinstance(node, (X.ProjectExec, X.LimitExec,
                         X.DeviceDecodeScanExec)):
        return len(node.children) == 1
    if isinstance(node, X.ExpandExec):
        if len(node.children) != 1:
            return False
        # output capacity grows n_proj-fold: fixed-width, small fans
        if len(node.plan.projections) > 8:
            return False
        return all(not isinstance(dt, (T.StringType, T.ArrayType,
                                       T.StructType, T.MapType))
                   for dt in node.plan.schema.types)
    return False


def _dispatching(node) -> bool:
    """Does this member cost a dispatch when run unfused? (Trivial
    projections and limits do not; fusing pays only when >= 2
    dispatching members collapse, or >= 1 is absorbed into an
    aggregate.)"""
    if isinstance(node, X.ProjectExec):
        return node._trivial_indices() is None
    return isinstance(node, (X.FilterExec, X.ExpandExec,
                             X.DeviceDecodeScanExec))


def _collect_chain(node):
    """The maximal fusable chain from ``node`` down: (members top first,
    the operator below). A FusedStageExec decomposes into its members, so
    an aggregate built over a fused chain still absorbs it."""
    chain = []
    cur = node
    while True:
        if isinstance(cur, FusedStageExec):
            chain.extend(reversed(cur.members))
            cur = cur.children[0]
            continue
        if not _fusable(cur):
            break
        chain.append(cur)
        cur = cur.children[0]
    return chain, cur


def _agg_absorbable(node) -> bool:
    """A partial or complete aggregate without segmented aggregates whose
    keys do not take the packed route (``_AggKernels.has_custom`` and
    ``_packed_ok``): the packed route probes the evaluated keys on the
    host each batch, which a composed function cannot feed."""
    if not isinstance(node, X.HashAggregateExec):
        return False
    if node.mode not in ("partial", "complete"):
        return False
    return not node.kern.has_custom and not node.kern._packed_ok


def fuse_stages(exec_root, conf):
    """Entry point: rewrite a converted tree, collapsing fusable chains
    (``plan/overrides.convert_plan``)."""
    if not conf.get(C.STAGE_FUSION_ENABLED):
        return exec_root
    counter = [0]
    return _rewrite(exec_root, conf, counter)


def fusion_groups(exec_root) -> list:
    """The fused stages of a converted tree as data (the history record's
    ``fusion_groups``): one entry a stage with its id, kind ("fused" or
    "absorbed") and member operator names child-most first (an absorbed
    chain ends with its aggregate). Derived from the one canonical walk,
    ``metrics.walk_exec_tree``."""
    from spark_rapids_tpu_torch.runtime.metrics import walk_exec_tree
    groups, cur = [], None
    for _k, node, _d, role, sid in walk_exec_tree(exec_root):
        if role is None:
            cur = None
            if sid is not None:
                cur = {"stage_id": sid,
                       "kind": ("fused" if getattr(node, "members", None)
                                else "absorbed"),
                       "members": [], "_self": type(node).__name__}
                groups.append(cur)
        elif cur is not None:
            cur["members"].append(type(node).__name__)
    for g in groups:
        self_name = g.pop("_self")
        if g["kind"] == "absorbed":
            g["members"].append(self_name)
    return groups


def _mark_stacked(chain) -> None:
    for m in chain:
        if isinstance(m, X.ExpandExec):
            m.stacked = True


def _rewrite(node, conf, counter):
    if _agg_absorbable(node):
        chain, input_exec = _collect_chain(node.children[0])
        bodies = [m.stage_body() for m in reversed(chain)]
        # forceSinglePass concatenates the raw child batches before one
        # update: impossible over still-encoded batches, so a chain
        # rooted at a device decode must not absorb there
        concat_ok = not (conf.get(C.AGG_FORCE_SINGLE_PASS) and any(
            isinstance(m, X.DeviceDecodeScanExec) for m in chain))
        if chain and concat_ok and all(not b.has_carry for b in bodies) \
                and any(_dispatching(m) for m in chain):
            counter[0] += 1
            node.pre_chain = bodies
            node.pre_chain_members = list(reversed(chain))
            node.fused_stage_id = counter[0]
            _mark_stacked(chain)
            node.children = [_rewrite(input_exec, conf, counter)]
            return node

    if _fusable(node):
        chain, input_exec = _collect_chain(node)
        # the fusion boundary is 2 dispatching members (fewer is illegal,
        # plan_verify PV-FUSE); the measured cost pass may raise it for
        # this plan (plan/cost.measured_hints)
        min_members = 2
        from spark_rapids_tpu_torch.plan import cost as _cost
        h = _cost.current_hints()
        if h is not None and h.fusion_min_members is not None:
            min_members = max(2, int(h.fusion_min_members))
        if sum(1 for m in chain if _dispatching(m)) >= min_members:
            counter[0] += 1
            members = list(reversed(chain))  # child-most first
            _mark_stacked(chain)
            return FusedStageExec(node.plan,
                                  [_rewrite(input_exec, conf, counter)],
                                  conf, node.device, members,
                                  stage_id=counter[0])

    node.children = [_rewrite(c, conf, counter) for c in node.children]
    return node
