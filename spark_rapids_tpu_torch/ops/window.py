"""Window functions as segmented scans over sorted rows.

Counterpart of ``spark_rapids_tpu/ops/window.py``. After one sort by the
(partition, order) keys, every window function is a few whole-plane
passes. All functions work in sorted row order, on:

- ``seg_start[i]`` / ``seg_end[i]``: the first and last row of i's
  partition;
- ``peer_start[i]`` / ``peer_end[i]``: the first and last row of i's peer
  group (same partition and equal order keys: rank and RANGE frames);
- rows at or past the live count are dead and sorted to the tail.

Two choices differ from the JAX package's XLA code and give the same
integers. The layout comes from a cumsum of the boundary flags and one
scatter of the boundary positions, since ``torch.cummax`` takes ~25 ms per
2^23 int64 values on an H100 (``ops/join._run_starts``); and the
segmented min/max scan, which the JAX package runs as
``lax.associative_scan``, is a log-step doubling scan (torch has no
associative scan). Float running sums keep the JAX package's formula over
one whole-plane cumsum; the two libraries still sum in different orders,
so float sums agree to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.ops import radix as R


def _first_of_runs(boundary: torch.Tensor):
    """(run number per row, run number -> first row) for boundary flags:
    row i is in run ``num[i]`` (1-based; 0 before the first flag), and
    ``starts[k]`` is run k's first row; ``starts`` holds n + 2 entries,
    entry 0 is 0 and runs past the last one start at n."""
    n = boundary.shape[0]
    device = boundary.device
    num = torch.cumsum(boundary.to(torch.int64), 0)
    starts = torch.full((n + 3,), n, dtype=torch.int64, device=device)
    starts[0] = 0
    # rows that start no run all write to slot n + 2, which is never read
    starts.scatter_(0, torch.where(boundary, num, n + 2),
                    torch.arange(n, dtype=torch.int64, device=device))
    return num, starts[:n + 2]


def segment_layout(seg_boundary: torch.Tensor, peer_boundary: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """From boundary flags to (seg_start, seg_end, peer_start, peer_end),
    inclusive int64 row indices in sorted order. An end is the next
    start less one, at most n - 1."""
    n = seg_boundary.shape[0]
    out = []
    for b in (seg_boundary, peer_boundary):
        num, starts = _first_of_runs(b)
        out.append((starts[num], (starts[num + 1] - 1).clamp(max=n - 1)))
    (seg_start, seg_end), (peer_start, peer_end) = out
    return seg_start, seg_end, peer_start, peer_end


def row_number(seg_start: torch.Tensor) -> torch.Tensor:
    n = seg_start.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=seg_start.device)
    return (idx - seg_start + 1).to(torch.int32)


def rank(seg_start: torch.Tensor, peer_start: torch.Tensor) -> torch.Tensor:
    return (peer_start - seg_start + 1).to(torch.int32)


def dense_rank(seg_boundary: torch.Tensor, peer_boundary: torch.Tensor,
               seg_start: torch.Tensor) -> torch.Tensor:
    peers_before = torch.cumsum(peer_boundary.to(torch.int64), 0)
    return (peers_before - peers_before[seg_start] + 1).to(torch.int32)


def _seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum reset at segment starts."""
    cs = torch.cumsum(x, 0)
    return cs - cs[seg_start] + x[seg_start]


def running_sum_count(vals: torch.Tensor, valid: torch.Tensor,
                      seg_start: torch.Tensor, frame_end: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum and count of the valid values over [segment start,
    frame_end[i]] (frame_end = i for a ROWS frame to the current row,
    peer_end for RANGE)."""
    masked = torch.where(valid, vals, torch.zeros_like(vals))
    cs = _seg_cumsum(masked, seg_start)
    cnt = _seg_cumsum(valid.to(torch.int64), seg_start)
    return cs[frame_end], cnt[frame_end]


def bounded_sum_count(vals: torch.Tensor, valid: torch.Tensor,
                      seg_start: torch.Tensor, seg_end: torch.Tensor,
                      lower: Optional[int], upper: Optional[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum and count over ROWS BETWEEN lower AND upper (offsets; None is
    unbounded), as differences of the segment-reset cumsums. An empty
    frame sums to 0 with count 0."""
    n = vals.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vals.device)
    lo = seg_start if lower is None else torch.maximum(idx + lower,
                                                       seg_start)
    hi = seg_end if upper is None else torch.minimum(idx + upper, seg_end)
    masked = torch.where(valid, vals, torch.zeros_like(vals))
    cs = _seg_cumsum(masked, seg_start)
    cnt = _seg_cumsum(valid.to(torch.int64), seg_start)
    empty = hi < lo
    lo_c = lo.clamp(0, n - 1)
    hi_c = hi.clamp(0, n - 1)
    # sum over [lo, hi] = cs[hi] - cs[lo] + x[lo]
    s = cs[hi_c] - cs[lo_c] + masked[lo_c]
    c = cnt[hi_c] - cnt[lo_c] + valid[lo_c].to(torch.int64)
    return torch.where(empty, torch.zeros_like(s), s), \
        torch.where(empty, 0, c)


def _seg_scan(op, x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan with an idempotent combiner (min or max):
    at step d, v[i] = op(v[i], v[i - d]) where row i - d is still in i's
    segment; log2(n) elementwise passes."""
    n = x.shape[0]
    first = torch.arange(n, dtype=torch.int64, device=x.device) - seg_start
    d = 1
    while d < n:
        take = first[d:] >= d
        x = torch.cat([x[:d], torch.where(take, op(x[d:], x[:-d]), x[d:])])
        d *= 2
    return x


def running_minmax(op: str, vals: torch.Tensor, valid: torch.Tensor,
                   seg_start: torch.Tensor, frame_end: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min or max over [segment start, frame_end[i]] and the count of
    valid values there. Floats scan their order-preserving integer image,
    which gives Spark's order (NaN above +inf, so max is NaN when any
    value is NaN, and min is NaN only when every value is)."""
    nvalid = _seg_cumsum(valid.to(torch.int64), seg_start)
    red = torch.minimum if op == "min" else torch.maximum
    if vals.dtype == torch.float64:
        img = R._f64_order_i64(vals)
    elif vals.dtype == torch.float32:
        img = R._f32_order_i32(vals)
    elif vals.dtype == torch.bool:
        img = vals.to(torch.int8)
    else:
        img = vals
    info = torch.iinfo(img.dtype)
    ident = info.max if op == "min" else info.min
    out = _seg_scan(red, torch.where(valid, img, ident), seg_start)[frame_end]
    if vals.dtype == torch.float64:
        out = R._i64_order_f64(out)
    elif vals.dtype == torch.float32:
        out = torch.where(out < 0, ~(out ^ -(1 << 31)), out).view(
            torch.float32)
    else:
        out = out.to(vals.dtype)
    return out, nvalid[frame_end]


def lead_lag(vals: torch.Tensor, valid: torch.Tensor, seg_id: torch.Tensor,
             offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The value at row i + offset while that row is in i's partition,
    else null (lag is a negative offset)."""
    n = vals.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vals.device) + offset
    in_range = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1)
    same = in_range & (seg_id[safe] == seg_id)
    return vals[safe], same & valid[safe]


def ntile(n_tiles: int, seg_start: torch.Tensor, seg_end: torch.Tensor
          ) -> torch.Tensor:
    """Spark's ntile: the first (size % n) tiles get one row more."""
    size = seg_end - seg_start + 1
    pos = torch.arange(seg_start.shape[0], dtype=torch.int64,
                       device=seg_start.device) - seg_start
    base = size // n_tiles
    rem = size % n_tiles
    cut = (base + 1) * rem  # rows covered by the bigger tiles
    tile_big = pos // torch.clamp(base + 1, min=1)
    tile_small = rem + (pos - cut) // torch.clamp(base, min=1)
    return (torch.where(pos < cut, tile_big, tile_small) + 1).to(torch.int32)
