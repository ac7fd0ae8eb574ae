"""Ungrouped, tiny-bucket and sort-based aggregation.

Counterpart of ``spark_rapids_tpu/ops/groupby.py``: ``global_agg`` (the q6
route), ``bucket_agg`` (the tiny-bucket route q1 takes: dict-string and
bool keys), each with the reductions sum, sumsq (the sum of squares of
the moments), count, min, max, first and last, and the sort route for keys that do not pack (flat strings,
dictionary keys whose vocabulary may repeat a string, floats):
``group_segments``, ``num_groups``, ``segmented_agg`` and
``gather_group_keys``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnVector, rows_tensor
from spark_rapids_tpu_torch.ops import kernels as K

_FLOATS = (torch.float32, torch.float64)


def _init(op: str, dtype: torch.dtype):
    if dtype in _FLOATS:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _float_minmax_prep(op: str, values: torch.Tensor, valid: torch.Tensor):
    """Spark float min/max: NaN above +inf, all NaNs equal, -0.0 == 0.0.
    Returns (clean plane, valid-NaN flags, valid-non-NaN flags)."""
    isnan = torch.isnan(values)
    clean = torch.where(values == 0.0, torch.zeros_like(values), values)
    clean = torch.where(valid & ~isnan, clean,
                        torch.full_like(values, _init(op, values.dtype)))
    return clean, valid & isnan, valid & ~isnan


def _float_minmax_patch(op: str, red, any_nan, any_nonnan):
    if op == "max":
        return torch.where(any_nan, float("nan"), red)
    return torch.where(any_nonnan, red, float("nan"))


def global_agg(op: str, values: torch.Tensor, valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ungrouped aggregation as masked reductions. Returns ([1] value,
    [1] validity)."""
    nvalid = valid.sum(dtype=torch.int64)
    some = (nvalid > 0).reshape(1)
    ones = torch.ones(1, dtype=torch.bool, device=values.device)
    if op in ("count", "count_all"):
        return nvalid.reshape(1), ones
    if op in ("sum", "sumsq"):
        v = values * values if op == "sumsq" else values
        return torch.where(valid, v, torch.zeros_like(v)).sum().reshape(1), \
            some
    if op in ("min", "max"):
        red = torch.amin if op == "min" else torch.amax
        if values.dtype in _FLOATS:
            clean, nanf, nonnanf = _float_minmax_prep(op, values, valid)
            out = _float_minmax_patch(op, red(clean).reshape(1),
                                      nanf.any().reshape(1),
                                      nonnanf.any().reshape(1))
            return out, some
        masked = torch.where(valid, values,
                             torch.full_like(values, _init(op, values.dtype)))
        return red(masked).reshape(1), some
    if op in ("first", "last"):
        n = values.shape[0]
        pos = torch.arange(n, device=values.device)
        if op == "first":
            sel = torch.where(valid, pos, n).min()
        else:
            sel = torch.where(valid, pos, -1).max()
        has = (sel >= 0) & (sel < n)
        return values[sel.clamp(0, n - 1)].reshape(1), (has & some).reshape(1)
    raise ValueError(f"unknown global op {op}")


def bucket_agg(op: str, values: torch.Tensor, valid: torch.Tensor,
               bucket: torch.Tensor, B: int, matmul_ok: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduction into a dense bucket space with no sort. For tiny B
    (matmul_ok) one masked reduction per bucket, else a bounded scatter;
    invalid rows go to the overflow bucket B and are dropped."""
    safe = torch.where(valid, bucket, B).to(torch.int64)
    device = values.device

    def scatter_sum(v):
        out = torch.zeros(B + 1, dtype=v.dtype, device=device)
        return out.index_add_(0, safe, v)[:B]

    def count():
        if matmul_ok:
            return torch.stack([(valid & (bucket == b)).sum(dtype=torch.int64)
                                for b in range(B)])
        return scatter_sum(valid.to(torch.int64))

    if op in ("count", "count_all"):
        return count(), torch.ones(B, dtype=torch.bool, device=device)
    if op in ("sum", "sumsq"):
        v = values * values if op == "sumsq" else values
        v = torch.where(valid, v, torch.zeros_like(v))
        if matmul_ok:
            out = torch.stack([torch.where(bucket == b, v,
                                           torch.zeros_like(v)).sum()
                               for b in range(B)])
        else:
            out = scatter_sum(v)
        return out, count() > 0
    if op in ("min", "max"):
        nvalid = scatter_sum(valid.to(torch.int64))
        reduce = "amin" if op == "min" else "amax"

        def scatter_red(v, init, how=reduce):
            out = torch.full((B + 1,), init, dtype=v.dtype, device=device)
            return out.scatter_reduce_(0, safe, v, reduce=how,
                                       include_self=True)[:B]

        if values.dtype in _FLOATS:
            clean, nanf, nonnanf = _float_minmax_prep(op, values, valid)
            out = scatter_red(clean, _init(op, values.dtype))
            any_nan = scatter_red(nanf.to(torch.int32), 0, "amax") > 0
            any_nonnan = scatter_red(nonnanf.to(torch.int32), 0, "amax") > 0
            return _float_minmax_patch(op, out, any_nan, any_nonnan), \
                nvalid > 0
        init = _init(op, values.dtype)
        masked = torch.where(valid, values, torch.full_like(values, init))
        return scatter_red(masked, init), nvalid > 0
    if op in ("first", "last"):
        # the first or last valid row position per bucket; for tiny B one
        # masked reduction per bucket (a scatter of ascending positions
        # into a few slots serializes on its atomics)
        n = values.shape[0]
        none = n if op == "first" else -1
        p = torch.where(valid, torch.arange(n, device=device), none)
        if matmul_ok:
            red = torch.amin if op == "first" else torch.amax
            sel = torch.stack([red(torch.where(bucket == b, p, none))
                               for b in range(B)])
        else:
            out = torch.full((B + 1,), none, dtype=torch.int64, device=device)
            sel = out.scatter_reduce_(
                0, safe, p, reduce="amin" if op == "first" else "amax",
                include_self=True)[:B]
        has = (sel >= 0) & (sel < n)
        return values[sel.clamp(0, n - 1)], has & (count() > 0)
    raise ValueError(f"unknown bucket op {op}")


# ---------------------------------------------------------------------------
# The sort route
# ---------------------------------------------------------------------------

def group_segments(key_cols: List[ColumnVector], num_rows, live=None):
    """Sort rows by the group keys. Returns (perm, seg_ids, boundary) over
    the full capacity: the sorting permutation, a dense group id per sorted
    position (rows past the live ones get capacity - 1; callers mask
    them), and a flag on the first sorted row of each group."""
    norm = [K.normalize_key(c, num_rows, live=live) for c in key_cols]
    perm = K.lexsort_indices([(k, n, True, True) for k, n in norm],
                             num_rows, live=live)
    cap = perm.shape[0]
    device = perm.device
    in_range = (torch.arange(cap, device=device)
                < rows_tensor(num_rows)) if live is None else live[perm]
    first = torch.zeros(cap, dtype=torch.bool, device=device)
    first[:1] = True
    boundary = first
    for k, nulls in norm:
        ks, ns = k[perm], nulls[perm]
        boundary = boundary | torch.cat([first[:1], (ks[1:] != ks[:-1])
                                         | (ns[1:] != ns[:-1])])
    boundary = boundary & in_range
    seg_ids = torch.cumsum(boundary.to(torch.int32), 0,
                           dtype=torch.int32) - 1
    seg_ids = torch.where(in_range, seg_ids, cap - 1)
    return perm, seg_ids, boundary


def num_groups(boundary: torch.Tensor) -> int:
    """The group count of group_segments' boundary (one host read)."""
    return int(boundary.sum(dtype=torch.int64).item())


def segmented_agg(op: str, values: torch.Tensor, valid: torch.Tensor,
                  seg_ids: torch.Tensor, seg_cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segmented reduction over values and valid in SORTED order.
    Returns (values[seg_cap], validity[seg_cap]). SQL null semantics:
    sum/min/max ignore nulls and are null for an all-null group; count
    counts the non-null rows. Float sums add in ``index_add_``'s order,
    which on the card is not the JAX package's order."""
    device = values.device
    idx = seg_ids.to(torch.int64)

    def seg_sum(v):
        return torch.zeros(seg_cap, dtype=v.dtype,
                           device=device).index_add_(0, idx, v)

    nvalid = seg_sum(valid.to(torch.int64))
    ones = torch.ones(seg_cap, dtype=torch.bool, device=device)
    if op == "count":
        return nvalid, ones
    if op == "count_all":
        return seg_sum(torch.ones_like(idx)), ones
    if op in ("sum", "sumsq"):
        v = values * values if op == "sumsq" else values
        return seg_sum(torch.where(valid, v, torch.zeros_like(v))), nvalid > 0
    if op in ("min", "max"):
        reduce = "amin" if op == "min" else "amax"

        def seg_red(v, init, how=reduce):
            out = torch.full((seg_cap,), init, dtype=v.dtype, device=device)
            return out.scatter_reduce_(0, idx, v, reduce=how,
                                       include_self=True)

        if values.dtype in _FLOATS:
            clean, nanf, nonnanf = _float_minmax_prep(op, values, valid)
            out = seg_red(clean, _init(op, values.dtype))
            any_nan = seg_red(nanf.to(torch.int32), 0, "amax") > 0
            any_nonnan = seg_red(nonnanf.to(torch.int32), 0, "amax") > 0
            return _float_minmax_patch(op, out, any_nan, any_nonnan), \
                nvalid > 0
        if values.dtype == torch.bool:
            init = int(_init(op, values.dtype))
            v = torch.where(valid, values.to(torch.int32), init)
            return seg_red(v, init).to(torch.bool), nvalid > 0
        init = _init(op, values.dtype)
        masked = torch.where(valid, values, torch.full_like(values, init))
        return seg_red(masked, init), nvalid > 0
    if op in ("first", "last"):
        # the first or last valid sorted position per group
        n = values.shape[0]
        pos = torch.arange(n, device=device)
        if op == "first":
            out = torch.full((seg_cap,), n, dtype=torch.int64, device=device)
            sel = out.scatter_reduce_(0, idx, torch.where(valid, pos, n),
                                      reduce="amin", include_self=True)
        else:
            out = torch.full((seg_cap,), -1, dtype=torch.int64,
                             device=device)
            sel = out.scatter_reduce_(0, idx, torch.where(valid, pos, -1),
                                      reduce="amax", include_self=True)
        has = (sel >= 0) & (sel < n)
        return values[sel.clamp(0, n - 1)], has & (nvalid > 0)
    raise ValueError(f"unknown segmented op {op}")


def gather_group_keys(key_cols: List[ColumnVector], perm: torch.Tensor,
                      boundary: torch.Tensor, num_rows,
                      live=None) -> List[ColumnVector]:
    """The first sorted row of each group as its key row, packed to the
    front of the full capacity (rows past the group count are null).
    ``live`` is the source batch's selection mask. A flat string key
    comes out as codes into its own planes (``flat_string_as_dict``)."""
    first = K._compact_indices(boundary, boundary.shape[0])
    src = torch.where(first >= 0, perm[first.clamp(min=0).to(torch.int64)],
                      -1)
    return [K.gather_column(c, src, num_rows, src_live=live)
            for c in key_cols]
