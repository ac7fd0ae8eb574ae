"""LORE-analog: per-operator batch dump and local replay (counterpart of
``spark_rapids_tpu/runtime/lore.py``).

Reference parity: lore/GpuLore.scala (tag operators with ids at plan
time, dump an operator's input batches and plan to disk, re-run just
that operator locally). Enabled by spark.rapids.sql.lore.dumpPath: every
exec gets a lore id (``exec.lore_id``, also carried by its trace spans);
its INPUT batches (each child's output) are dumped as Parquet under
<dir>/loreId=<id>/input<k>/part<p>/, with the operator's tree in
plan.txt. ``replay(dir, lore_id, plan)`` rebuilds the exec from the
logical plan and re-executes it over the dumped inputs. The device-decode
source's encoded batches are not columnar rows and are not dumped: its
consumer (``DeviceDecodeScanExec``) replays over no input.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, from_arrow, to_arrow,
)


class _DumpedChild:
    """Stands in for an exec child during replay: streams dumped
    batches."""

    def __init__(self, path: str, schema, nparts: int, device):
        self.path = path
        self.schema = schema
        self.children = []
        self.num_partitions = nparts
        self.device = device

    def execute_partition(self, pidx) -> Iterator[ColumnarBatch]:
        for f in sorted(glob.glob(os.path.join(self.path, f"part{pidx}",
                                               "*.parquet"))):
            # file-scoped read: the dataset API would grow a phantom
            # loreId partition column from the dump path's k=v segment
            yield from_arrow(pq.ParquetFile(f).read(), self.device)


class LoreDumper:
    """Installed by convert_plan when the dump path is set: walks the exec
    tree, assigns ids, and wraps each node's children so the batches
    flowing INTO every operator are recorded."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self._next_id = 0

    def install(self, exec_root) -> None:
        self._walk(exec_root)

    def _walk(self, node) -> None:
        lore_id = self._next_id
        self._next_id += 1
        node.lore_id = lore_id
        d = os.path.join(self.root_dir, f"loreId={lore_id}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "plan.txt"), "w") as f:
            # the id rides in the dump itself (not just the directory
            # name), so a hot span found in a trace (exec spans carry
            # lore_id in their args) maps to replay(dir, <loreId>, plan)
            f.write(f"loreId={lore_id} exec={type(node).__name__}\n")
            f.write(node.tree_string())
        for i, child in enumerate(node.children):
            self._wrap_child(i, child, d)
            self._walk(child)

    @staticmethod
    def _wrap_child(idx, child, parent_dir) -> None:
        inner = child.execute_partition
        names = child.schema.names
        dump_dir = os.path.join(parent_dir, f"input{idx}")

        def wrapped(pidx, _inner=inner, _names=names, _dir=dump_dir):
            seq = 0
            pdir = os.path.join(_dir, f"part{pidx}")
            os.makedirs(pdir, exist_ok=True)
            for batch in _inner(pidx):
                if isinstance(batch, ColumnarBatch):
                    pq.write_table(to_arrow(batch, _names), os.path.join(
                        pdir, f"batch{seq:04d}.parquet"))
                    seq += 1
                yield batch

        child.execute_partition = wrapped


def replay(root_dir: str, lore_id: int, plan, conf=None,
           device="cuda") -> Optional[pa.Table]:
    """Re-run ONE operator over its dumped inputs, on ``device``. ``plan``
    is the original logical plan (the lore ids follow the same
    conversion order), so the exec subtree is rebuilt exactly as planned;
    its children are replaced with dumped-batch streams (reference
    lore/replay.scala restoreGpuExec). None when it yields no batch."""
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch.plan.overrides import convert_plan
    from spark_rapids_tpu_torch.runtime.task import TaskContext
    conf = conf or C.RapidsConf()
    if conf.get(C.LORE_DUMP_DIR):
        # replaying with the DUMPING conf would install a fresh dumper and
        # overwrite the recording being read; strip the key
        overrides = dict(conf._values)
        overrides.pop(C.LORE_DUMP_DIR.key, None)
        conf = C.RapidsConf(overrides)
    C.set_session_conf(conf)
    exec_root, _ = convert_plan(plan, conf, device)
    target = _find(exec_root, lore_id, counter=[0])
    if target is None:
        raise KeyError(f"no exec with lore id {lore_id}")
    d = os.path.join(root_dir, f"loreId={lore_id}")
    for i, child in enumerate(list(target.children)):
        ipath = os.path.join(d, f"input{i}")
        parts = len(glob.glob(os.path.join(ipath, "part*")))
        target.children[i] = _DumpedChild(ipath, child.schema,
                                          max(parts, 1), target.device)
    names = target.schema.names
    tables: List[pa.Table] = []
    for p in range(target.num_partitions):
        with TaskContext(partition_id=p):
            for batch in target.execute_partition(p):
                tables.append(to_arrow(batch, names))
    return pa.concat_tables(tables) if tables else None


def _find(node, lore_id: int, counter) -> object:
    my_id = counter[0]
    counter[0] += 1
    if my_id == lore_id:
        return node
    for c in node.children:
        found = _find(c, lore_id, counter)
        if found is not None:
            return found
    return None
