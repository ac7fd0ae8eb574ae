"""Sharded stage execution: one call a device a wave of partition batches.

Counterpart of ``spark_rapids_tpu/exec/sharded.py``. Stage fusion
(``exec/stage_fusion.py``) already makes each stage one call a batch;
a 16-partition query still makes 16 of them a wave of input. Under
spark.rapids.sql.multichip.enabled this pass (``shard_stages``, run by
``plan/overrides.convert_plan`` after ``fuse_stages``) rewrites eligible
``FusedStageExec`` nodes into ``ShardedStageExec``: one batch per
partition, up to the mesh's size (``parallel/mesh.py``) a wave, each
shard on its device. Shards that share a device (one card under
``virtual_devices``) pack into one set of ``[k * capacity]`` planes and
run the composed member chain as one call; the reference runs one SPMD
program over the mesh instead.

Eligibility (the reference's rules, each recorded on a node that stays
one-device as ``_shard_fallback_reason``):

- every member body is carry-free and does not exhaust (a LIMIT budget
  or a row-base carry is per-partition loop state);
- the stage's input and output schemas are fixed-width (string and
  nested planes are ragged per batch);
- no member is a device decode (encoded vocab planes vary per batch).

Failures follow the port's narrower fallback rule (ROADMAP "Stage fusion
runs eagerly"): only a failure to BUILD the composed function replays the
wave per slot through a one-device ``FusedStageExec``, over the batches
already pulled. An OOM, a cancellation, a ``KernelError`` or a CUDA error
raised while a wave runs propagates; an OOM re-runs the wave first
(``with_retry_no_split``).

Calls ride the ``fuse.fused`` choke point: the cancel checkpoint, the
device.dispatch fault site, the watchdog, the dispatch-budget hook and
the stage cache's mesh-fingerprinted keys apply unchanged. Each wave's
per-shard output rows feed the kernel cost auditor
(``kernel_audit.note_shards``), so shard skew shows in the roofline
table and EXPLAIN ANALYZE.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnVector, ColumnarBatch, LazyRowCount, pad_batch_to,
)
from spark_rapids_tpu_torch.exec import compiled, fuse
from spark_rapids_tpu_torch.exec import nodes as X
from spark_rapids_tpu_torch.exec.stage_fusion import (
    FusedStageExec, _build_may_fall_back,
)
from spark_rapids_tpu_torch.parallel import mesh as MESH
from spark_rapids_tpu_torch.runtime import metrics as M
from spark_rapids_tpu_torch.runtime import trace as TR
from spark_rapids_tpu_torch.runtime.task import TaskContext

_LOG = logging.getLogger("spark_rapids_tpu_torch")

#: column types whose planes are ragged per batch: they cannot pack into
#: one uniform operand
_WIDE_TYPES = (T.StringType, T.ArrayType, T.StructType, T.MapType)


class _ReplaySource:
    """The batches a wave already pulled, per partition, as a child for
    the one-device fallback (the source must not run again)."""

    def __init__(self, schema, batches: Dict[int, list], num_partitions):
        self.schema = schema
        self._batches = batches
        self.num_partitions = num_partitions
        self.children: list = []

    def execute_partition(self, pidx):
        yield from self._batches.get(pidx, [])


def _shard_major(batch: ColumnarBatch, k: int, nproj: int) -> ColumnarBatch:
    """An Expand over k packed shards stacks its projections
    projection-major ([nproj, k, cap]); reorder every plane shard-major
    ([k, nproj, cap]) so each shard's slice is what the Expand gives that
    shard alone."""
    if k == 1 or nproj == 1:
        return batch

    def reorder(p):
        cap = p.shape[0] // (nproj * k)
        return p.view(nproj, k, cap).transpose(0, 1).reshape(-1)

    cols = [ColumnVector(c.dtype, reorder(c.data),
                         None if c.validity is None else reorder(c.validity),
                         c.dict_unique, c.bounds) for c in batch.columns]
    return ColumnarBatch(cols, batch.num_rows, reorder(batch.live_mask()))


class ShardedStageExec(X.TorchExec):
    """A fused stage run a wave at a time: up to n_shards partition
    batches, one per shard, one call a device. Members keep their plan
    nodes and metrics as under FusedStageExec; only the call granularity
    changes."""

    def __init__(self, plan, children, conf, device, members, stage_id=0,
                 n_shards=1):
        super().__init__(plan, children, conf, device)
        self.members = members
        self.stage_id = stage_id
        self.n_shards = int(n_shards)
        self.bodies = [m.stage_body() for m in members]
        #: device -> the member bodies evaluating there (other cards)
        self._bodies_by_dev: Dict[torch.device, list] = {}
        #: (position in the chain, projections) of each Expand member
        self._expands = [(i, len(b.key[1])) for i, b in enumerate(self.bodies)
                         if b.key and b.key[0] == "expand_stage"]
        self._devices: Optional[List[torch.device]] = None
        self._failed = False
        self._out: Optional[List[list]] = None
        self._lock = threading.Lock()

    @property
    def schema(self):
        return self.members[-1].schema

    def name(self) -> str:
        ops = "+".join(type(m).__name__.replace("Exec", "")
                       for m in reversed(self.members))
        return f"ShardedStageExec({ops})x{self.n_shards}"

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        sid = self.stage_id
        lines = [f"{pad}*({sid}) {self.name()} [sharded n={self.n_shards}]"]
        for m in reversed(self.members):
            lines.append(f"{pad}  *({sid}) {type(m).__name__} "
                         f"<- {m.plan.describe()} [sharded]")
        lines.append(self.children[0].tree_string(indent + 1))
        return "\n".join(lines)

    # -- the call ---------------------------------------------------------

    def _bodies_on(self, dev) -> list:
        """The member bodies evaluating on ``dev``: a shard's literals and
        scratch planes live on its own card."""
        if dev == self.device:
            return self.bodies
        if dev not in self._bodies_by_dev:
            self._bodies_by_dev[dev] = [m.stage_body(dev)
                                        for m in self.members]
        return self._bodies_by_dev[dev]

    def _key(self, dev, m: int, cap: int, in_dtypes) -> tuple:
        return ("sharded_stage", tuple(b.key for b in self._bodies_on(dev)),
                m, cap, tuple(str(dt.torch_dtype) for dt in in_dtypes),
                str(dev))

    def _build(self, dev):
        bodies, expands = self._bodies_on(dev), dict(self._expands)

        def build():
            fns = [b.builder() for b in bodies]

            def fn(batch, pid, k):
                errs_all, rows = [], []
                for i, (f, b) in enumerate(zip(fns, bodies)):
                    batch, errs, _ = f(batch, pid, b.init_carry())
                    if i in expands:
                        batch = _shard_major(batch, k, expands[i])
                    errs_all.append(errs)
                    rows.append(X.live_rows(batch))
                return batch, errs_all, rows
            return fn
        return build

    @staticmethod
    def _pack(slots, cap, dev) -> ColumnarBatch:
        """One group's slots (a batch, or None for a dead slot) as one
        batch of len(slots) * cap rows on ``dev``: each slot padded to
        ``cap`` with dead rows, a dead slot all dead."""
        like = next(b for b in slots if b is not None)
        parts = [pad_batch_to(b, cap, dev, like=like) for b in slots]
        live = torch.cat([p.row_mask for p in parts])
        cols = [ColumnVector(c.dtype,
                             torch.cat([p.columns[j].data for p in parts]),
                             torch.cat([p.columns[j].validity
                                        for p in parts]))
                for j, c in enumerate(parts[0].columns)]
        return ColumnarBatch(cols, LazyRowCount(live.sum(dtype=torch.int64)),
                             live)

    @staticmethod
    def _coalesce(batches):
        """One partition's pulled batches as one (a group then makes one
        wave a stage, not one per upstream batch: a partition after an
        exchange holds one batch per sender). Members are carry-free
        row-local operators, so batch boundaries carry nothing here; the
        concatenation is flagged, so a final aggregate still merges it."""
        if len(batches) <= 1:
            return batches
        return [X._coalesced(batches)]

    def _out_bounds(self, in_bounds, out_cols):
        if in_bounds is None:
            return
        bounds = in_bounds
        for b in self.bodies:
            if b.bounds_map is None:
                return
            bounds = b.bounds_map(bounds)
        for c, bd in zip(out_cols, bounds):
            if bd is not None:
                c.bounds = bd

    # -- fallback ---------------------------------------------------------

    def _single_delegate(self, source) -> FusedStageExec:
        """A one-device FusedStageExec over ``source``, sharing this
        node's metrics, so fallback rows still show under the sharded
        stage."""
        d = FusedStageExec(self.plan, [source], self.conf, self.device,
                           self.members, stage_id=self.stage_id)
        d.metrics = self.metrics
        return d

    def _run_single(self, source, pidx) -> list:
        with TaskContext(partition_id=pidx):
            return list(self._single_delegate(source).execute_partition(pidx))

    # -- the wave loop ----------------------------------------------------

    def _shard_devices(self) -> List[torch.device]:
        if self._devices is None:
            self._devices = list(MESH.make_mesh(
                self.n_shards, axis_names=(MESH.PART_AXIS,),
                like=self.device).flat())
        return self._devices

    def _materialize(self) -> List[list]:
        from spark_rapids_tpu_torch.analysis import kernel_audit as KA
        from spark_rapids_tpu_torch.runtime.retry import with_retry_no_split
        child = self.children[0]
        nparts = child.num_partitions
        m = self.n_shards
        devices = self._shard_devices()
        outs: List[list] = [[] for _ in range(nparts)]
        in_dtypes = [f.dtype for f in child.schema.fields]
        out_dtypes = [f.dtype for f in self.schema.fields]
        out_rows = self.metrics.metric(M.NUM_OUTPUT_ROWS)
        in_batches = self.metrics.metric(M.NUM_INPUT_BATCHES)
        disp = self.metrics.metric(M.STAGE_DISPATCHES)
        waves = self.metrics.metric(M.SHARD_WAVES)
        member_t = [mb.metrics.metric(M.OP_TIME) for mb in self.members]
        member_rows = [mb.metrics.metric(M.NUM_OUTPUT_ROWS)
                       for mb in self.members]
        # the slots of each device, in slot order: one call each a wave
        groups: Dict[torch.device, List[int]] = {}
        for i, d in enumerate(devices):
            groups.setdefault(d, []).append(i)
        for g0 in range(0, nparts, m):
            slot_pids = list(range(g0, min(g0 + m, nparts)))
            if self._failed:
                for pidx in slot_pids:
                    outs[pidx] = self._run_single(child, pidx)
                continue
            queues = []
            for p in slot_pids:
                with TaskContext(partition_id=p):
                    queues.append(self._coalesce(
                        list(child.execute_partition(p))))
            for w in range(max((len(q) for q in queues), default=0)):
                slots: List[Optional[ColumnarBatch]] = [
                    q[w] if w < len(q) else None for q in queues]
                n_live = sum(1 for b in slots if b is not None)
                if n_live == 0:
                    break
                slots.extend([None] * (m - len(slots)))
                cap = max(b.capacity for b in slots if b is not None)
                self._acquire()
                MESH.check_mesh_devices(devices)
                in_batches.add(n_live)
                t0 = time.perf_counter_ns()
                try:
                    fns = {dev: fuse.fused(self._key(dev, m, cap, in_dtypes),
                                           self._build(dev))
                           for dev, idx in groups.items()
                           if any(slots[i] is not None for i in idx)}
                except Exception as ex:  # noqa: BLE001 - filtered below
                    if not _build_may_fall_back(ex):
                        raise
                    self._failed = True
                    _LOG.warning("sharded stage build failed for %s; "
                                 "falling back to the one-device fused "
                                 "path", self.name(), exc_info=True)
                    rest = {pidx: queues[i][w:]
                            for i, pidx in enumerate(slot_pids)}
                    src = _ReplaySource(child.schema, rest, nparts)
                    for pidx in slot_pids:
                        outs[pidx].extend(self._run_single(src, pidx))
                    break
                calls = []
                for dev, fn in fns.items():
                    idx = groups[dev]
                    packed = self._pack([slots[i] for i in idx], cap, dev)
                    pid = slot_pids[idx[0]] if idx[0] < len(slot_pids) \
                        else 0
                    # an OOM replays the same wave (no split: the pack is
                    # already capacity-bucketed); anything else raised
                    # while it runs propagates
                    out, errs_all, rows = with_retry_no_split(
                        lambda fn=fn, packed=packed, pid=pid, k=len(idx):
                        fn(packed, pid, k))
                    calls.append((idx, out, errs_all, rows))
                dt_ns = time.perf_counter_ns() - t0
                if TR.active() is not None:
                    TR.emit_span(self.name(), t0, dt_ns, cat="exec",
                                 args={"stage_id": self.stage_id,
                                       "n_shards": m, "live_slots": n_live})
                    TR.instant("shardedDispatch", cat="dispatch",
                               args={"stage_id": self.stage_id})
                for _idx, _out, errs_all, _rows in calls:
                    for errs in errs_all:
                        compiled.raise_errors(errs)
                disp.add(len(calls))
                waves.add(1)
                share = dt_ns // len(self.members)
                for mt in member_t:
                    mt.add(share)
                # the auditor's per-shard rows, built only while it
                # collects a query
                shard_rows = torch.zeros(m, dtype=torch.int64,
                                         device=self.device) \
                    if KA.collecting() else None
                for idx, out, _errs, rows in calls:
                    for mr, r in zip(member_rows, rows):
                        mr.add(r)
                    k = len(idx)
                    cap_out = out.capacity // k
                    live = out.live_mask()
                    if shard_rows is not None:
                        shard_rows[torch.tensor(idx, device=self.device)] = \
                            live.view(k, cap_out).sum(1).to(self.device)
                    for t, i in enumerate(idx):
                        b = slots[i]
                        if b is None:
                            continue
                        lo, hi = t * cap_out, (t + 1) * cap_out
                        cols = [ColumnVector(
                            dt, c.data[lo:hi].to(self.device,
                                                 non_blocking=True),
                            None if c.validity is None else
                            c.validity[lo:hi].to(self.device,
                                                 non_blocking=True))
                            for c, dt in zip(out.columns, out_dtypes)]
                        self._out_bounds([c.bounds for c in b.columns],
                                         cols)
                        mask = live[lo:hi].to(self.device, non_blocking=True)
                        nr = LazyRowCount(mask.sum(dtype=torch.int64))
                        out_rows.add(nr)
                        outs[slot_pids[i]].append(ColumnarBatch(
                            cols, nr, mask, coalesced=b.coalesced))
                if shard_rows is not None:
                    KA.note_shards(m, shard_rows)
        return outs

    def execute_partition(self, pidx):
        with X._materializing(self._lock):
            if self._out is None:
                self._out = self._materialize()
        yield from self._out[pidx]


# ---------------------------------------------------------------------------
# The planner pass
# ---------------------------------------------------------------------------

def _fallback_reason(node) -> Optional[str]:
    """None when the fused stage can shard; otherwise why it stays
    one-device (recorded on the node for plan dumps)."""
    for b in node.bodies:
        if b.has_carry or b.exhausts:
            return (f"member {b.name or b.key[0]} carries per-partition "
                    "loop state (row_base/limit budget) that cannot live "
                    "inside one SPMD program")
    if any(isinstance(mb, X.DeviceDecodeScanExec) for mb in node.members):
        return ("device-decode input planes are per-batch ragged "
                "(encoded vocab sizes differ per shard)")
    schemas = [node.children[0].schema] + [mb.schema for mb in node.members]
    for sch in schemas:
        for f in sch.fields:
            if isinstance(f.dtype, _WIDE_TYPES):
                return (f"column {f.name} is {type(f.dtype).__name__}: "
                        "ragged byte planes cannot pack into one SPMD "
                        "operand")
    return None


def shard_stages(exec_root, conf, device=None):
    """Rewrite eligible FusedStageExec nodes into ShardedStageExec
    (``plan/overrides.convert_plan``, after ``fuse_stages``, before the
    pipeline boundaries). A no-op unless spark.rapids.sql.multichip.
    enabled."""
    if not conf.get(C.MULTICHIP_ENABLED):
        return exec_root
    m = MESH.multichip_devices(conf, like=device)

    def rewrite(node):
        node.children = [rewrite(c) for c in node.children]
        if isinstance(node, FusedStageExec):
            reason = _fallback_reason(node)
            if reason is None:
                return ShardedStageExec(node.plan, node.children, node.conf,
                                        node.device, node.members,
                                        stage_id=node.stage_id, n_shards=m)
            node._shard_fallback_reason = reason
            _LOG.debug("stage %d stays one-device: %s", node.stage_id,
                       reason)
        return node

    return rewrite(exec_root)
