"""The mesh's lane exchange, broadcast and shard sum: the shuffle between shards.

Counterpart of ``spark_rapids_tpu/parallel/exchange.py``. The JAX package
runs its exchange as one SPMD program per device: route rows to [P, C]
send buffers, one ``lax.all_to_all`` over the interconnect. The port has
one process and a mesh of ``torch.device``s (``parallel/mesh.py``), so
the functions here take a list of per-shard operands, shard i's on
``devices[i]``:

- ``all_to_all_exchange``: each source builds its [P, C] send planes on
  its own device, lane j moves to shard j's device with
  ``.to(dev, non_blocking=True)`` (a peer copy across cards, no copy on
  one card), and each receiver concatenates its P lanes in source order;
- ``broadcast_planes``: the all-gather (every shard gets every shard's
  planes, concatenated in shard order);
- ``shard_sum``: the ``psum`` (the shards' values summed on one device);
- ``route_rows`` and ``local_sorted_group_agg``: the per-shard pieces.

Static-shape discipline as in the reference: send buffers are [P, C], C
the caller's ``send_cap`` (sized from real per-(source, destination)
counts) or the local capacity; rows past a lane's C drop. These are
XLA-level work in the JAX package, not Pallas kernels: torch ops here.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

#: int64 bit pattern of the reference's invalid-row key 0xFFFF...FFFF
_ALL_ONES = -1
_SIGN = -(1 << 63)


def route_rows(target: torch.Tensor, valid: torch.Tensor, num_parts: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scatter layout sending each row to its ``target`` partition:
    (order, row_idx, col_idx). Gather local rows with ``order``, then
    scatter them into a [num_parts, C+1] buffer at [row_idx, col_idx]
    (column C is the drop slot for invalid rows)."""
    n = valid.shape[0]
    dev = valid.device
    t = torch.where(valid, target.to(torch.int64),
                    torch.full_like(target, num_parts, dtype=torch.int64))
    order = torch.sort(t, stable=True).indices
    t_sorted = t[order]
    starts = torch.searchsorted(
        t_sorted, torch.arange(num_parts + 1, dtype=torch.int64, device=dev))
    row_idx = t_sorted.clamp(0, num_parts - 1)
    pos = torch.arange(n, dtype=torch.int64, device=dev) - starts[row_idx]
    col_idx = torch.where(t_sorted < num_parts, pos,
                          torch.full_like(pos, n))
    return order, row_idx, col_idx


def _lanes(plane: torch.Tensor, order, row_idx, col_idx, P: int, C: int
           ) -> torch.Tensor:
    """[P, C] send buffer of one plane: row order[i] at (row_idx[i],
    col_idx[i]); the drop column C is cut off."""
    buf = torch.zeros((P, C + 1), dtype=plane.dtype, device=plane.device)
    buf[row_idx, col_idx] = plane[order]
    return buf[:, :C]


def all_to_all_exchange(planes: Sequence[Dict[str, torch.Tensor]],
                        valid: Sequence[torch.Tensor],
                        target: Sequence[torch.Tensor],
                        devices: Sequence[torch.device],
                        send_cap: int = 0
                        ) -> Tuple[List[Dict[str, torch.Tensor]],
                                   List[torch.Tensor]]:
    """Move row i of source s to shard ``target[s][i]``. Shard s's
    ``planes``, ``valid`` and ``target`` lie on ``devices[s]``; P is the
    number of shards. ``send_cap`` bounds the rows any one source sends
    any one destination (0 = the local capacity, the conservative bound);
    rows past it are DROPPED, so callers size it from real counts.
    Returns, per shard on its device, ([P*C] planes, [P*C] valid), lane s
    of shard j holding source s's rows for j."""
    P = len(devices)
    n_max = max(int(v.shape[0]) for v in valid)
    C = int(send_cap) if send_cap else n_max
    send_valid, send_planes = [], []
    for s in range(P):
        order, row_idx, col_idx = route_rows(target[s], valid[s], P)
        # overflow beyond the sized lane drops into the slack column
        col_idx = torch.where(col_idx < C, col_idx,
                              torch.full_like(col_idx, C))
        send_valid.append(_lanes(valid[s], order, row_idx, col_idx, P, C))
        send_planes.append({k: _lanes(p, order, row_idx, col_idx, P, C)
                            for k, p in planes[s].items()})
    out_planes, out_valid = [], []
    for j, dev in enumerate(devices):
        out_valid.append(torch.cat(
            [send_valid[s][j].to(dev, non_blocking=True)
             for s in range(P)]))
        out_planes.append({
            k: torch.cat([send_planes[s][k][j].to(dev, non_blocking=True)
                          for s in range(P)])
            for k in planes[0]})
    return out_planes, out_valid


def broadcast_planes(planes: Sequence[Dict[str, torch.Tensor]],
                     valid: Sequence[torch.Tensor],
                     devices: Sequence[torch.device]
                     ) -> Tuple[List[Dict[str, torch.Tensor]],
                                List[torch.Tensor]]:
    """Replicate every shard to every device: the all-gather of the
    broadcast-join build side. Shard j gets all shards' planes
    concatenated in shard order, on ``devices[j]``."""
    out_planes, out_valid = [], []
    for dev in devices:
        out_valid.append(torch.cat([v.to(dev, non_blocking=True)
                                    for v in valid]))
        out_planes.append({k: torch.cat([p[k].to(dev, non_blocking=True)
                                         for p in planes])
                           for k in planes[0]})
    return out_planes, out_valid


def shard_sum(values: Sequence, device) -> object:
    """The ``psum``: each shard's value (a tensor, or a dict or tuple of
    them) summed elementwise on ``device``."""
    first = values[0]
    if isinstance(first, dict):
        return {k: shard_sum([v[k] for v in values], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(shard_sum([v[i] for v in values], device)
                           for i in range(len(first)))
    acc = first.to(device, non_blocking=True)
    for v in values[1:]:
        acc = acc + v.to(device, non_blocking=True)
    return acc


def local_sorted_group_agg(key: torch.Tensor, valid: torch.Tensor,
                           values: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Segmented aggregation of one shard by a 64-bit key plane (the
    int64 bit pattern of the reference's uint64 key).

    Sort by the key as unsigned (invalid rows to the end), find the group
    boundaries and sum each value plane per segment. Planes of length N:
    ``keys`` (each group's key at its slot, 0 past the groups), ``sum_*``
    per value plane, ``count`` and ``groups`` (live group slots)."""
    n = valid.shape[0]
    dev = key.device
    k = torch.where(valid, key.to(torch.int64),
                    torch.full_like(key, _ALL_ONES, dtype=torch.int64))
    # unsigned order on signed int64: flip the sign bit
    order = torch.sort(k ^ _SIGN, stable=True).indices
    ks = k[order]
    vs = valid[order]
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ks[1:] != ks[:-1]]) & vs
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    seg = torch.where(vs, seg, torch.full_like(seg, n - 1))
    slot = torch.where(boundary, seg, torch.full_like(seg, n))
    keys = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    keys[slot] = torch.where(boundary, ks, torch.zeros_like(ks))
    out = {"keys": keys[:n]}
    ngroups = boundary.sum()
    out["groups"] = torch.arange(n, device=dev) < ngroups
    ones = vs.to(torch.int64)
    out["count"] = torch.zeros(n, dtype=torch.int64,
                               device=dev).index_add_(0, seg, ones)
    for name, plane in values.items():
        p = plane[order]
        p = torch.where(vs, p, torch.zeros_like(p))
        out["sum_" + name] = torch.zeros(n, dtype=p.dtype,
                                         device=dev).index_add_(0, seg, p)
    return out
