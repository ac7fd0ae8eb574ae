"""Ungrouped and tiny-bucket aggregation.

Counterpart of ``spark_rapids_tpu/ops/groupby.py`` ``global_agg`` (the q6
route) and ``bucket_agg`` (the tiny-bucket route q1 takes: dict-string and
bool keys). The sort-based group route (``group_segments`` /
``segmented_agg``) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
    if op == "sum":
        return torch.where(valid, values,
                           torch.zeros_like(values)).sum().reshape(1), some
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
    if op == "sum":
        v = torch.where(valid, values, torch.zeros_like(values))
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
    raise ValueError(f"unknown bucket op {op}")
