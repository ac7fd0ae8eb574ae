"""Distributed query-step builders over a mesh: the minimal-repro harness.

Counterpart of ``spark_rapids_tpu/parallel/distributed.py``. One Spark
stage pair (scan -> filter -> partial aggregate -> shuffle | final
aggregate) as one step over a mesh (``parallel/mesh.py``): each shard
filters its rows, hashes its keys to a destination, the lane exchange
(``parallel/exchange.py``) moves them, and each shard aggregates what it
received. The JAX package builds one ``shard_map``-ped program; here the
step runs shard after shard on each shard's device, eagerly.

A global operand is a tensor whose length the mesh size divides (split
into contiguous shards, as ``shard_global`` places it) or the list of
its shards. Results are the shards' outputs concatenated in shard order
on the mesh's first device, as ``np.asarray`` of the reference's sharded
result reads.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch

from spark_rapids_tpu_torch.ops.kernels import shr64, signed64
from spark_rapids_tpu_torch.parallel import exchange as X


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on the int64 bit pattern of a uint64 plane
    (signed arithmetic, wrapping multiplies, logical shifts masked by
    hand: CPU torch has no uint64 ``>>``)."""
    x = x.to(torch.int64)
    x = (x ^ shr64(x, 30)) * signed64(0xBF58476D1CE4E5B9)
    x = (x ^ shr64(x, 27)) * signed64(0x94D049BB133111EB)
    return x ^ shr64(x, 31)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 value of int64 bits ``x`` modulo ``n``."""
    hi = (1 << 63) % n
    low = (x & ((1 << 63) - 1)) % n
    return torch.where(x < 0, (low + hi) % n, low)


Global = Union[torch.Tensor, Sequence[torch.Tensor]]


def shard_global(mesh, arr) -> List[torch.Tensor]:
    """Split a host array (or tensor) into contiguous shards, shard i on
    the mesh's i-th device (row-major over every axis)."""
    devs = mesh.flat()
    t = torch.as_tensor(arr)
    if t.shape[0] % len(devs):
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{len(devs)} devices")
    return [c.to(d) for c, d in zip(torch.chunk(t, len(devs)), devs)]


def _shards(mesh, x: Global) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return shard_global(mesh, x)
    return [torch.as_tensor(s).to(d) for s, d in zip(x, mesh.flat())]


def make_distributed_groupby_sum(mesh, filter_fn: Callable,
                                 value_names: Sequence[str]):
    """A step computing ``SELECT key, sum(v) FOR v IN value_names,
    count(*) GROUP BY key`` with a pre-filter, over rows sharded across
    the whole mesh: ``step(key, valid, values)`` with ``key`` the int64
    bits of a uint64 group-key plane, ``valid`` bool and ``values`` a
    dict name -> numeric plane. ``filter_fn(valid, values) -> bool`` runs
    on each shard before the exchange. Returns the group planes (keys,
    groups, count, sum_*), every group on exactly one shard."""
    devs = mesh.flat()
    nparts = len(devs)

    def step(key: Global, valid: Global, values: Dict[str, Global]):
        keys = _shards(mesh, key)
        valids = _shards(mesh, valid)
        vals = {n: _shards(mesh, v) for n, v in values.items()}
        planes, keeps, targets = [], [], []
        for i in range(nparts):
            local = {n: v[i] for n, v in vals.items()}
            keeps.append(valids[i] & filter_fn(valids[i], local))
            targets.append(_umod(splitmix64(keys[i]), nparts))
            p = dict(local)
            p["__key"] = keys[i]
            planes.append(p)
        recv, rvalid = X.all_to_all_exchange(planes, keeps, targets, devs)
        outs = []
        for p, v in zip(recv, rvalid):
            rkey = p.pop("__key")
            outs.append(X.local_sorted_group_agg(rkey, v, p))
        names = ["keys", "groups", "count"] + ["sum_" + n
                                               for n in value_names]
        return {k: torch.cat([o[k].to(devs[0]) for o in outs])
                for k in names}

    return step


def make_distributed_reduction(mesh, reduce_fn: Callable):
    """A step for a full reduction without group keys: each shard reduces
    its rows (``reduce_fn(valid, values)``), then the shard sum over the
    mesh: TPC-H q6's shape (scan -> filter -> sum)."""
    devs = mesh.flat()

    def step(valid: Global, values: Dict[str, Global]):
        valids = _shards(mesh, valid)
        vals = {n: _shards(mesh, v) for n, v in values.items()}
        locals_ = [reduce_fn(valids[i], {n: v[i] for n, v in vals.items()})
                   for i in range(len(devs))]
        return X.shard_sum(locals_, devs[0])

    return step
