"""Sorted segmented sums for the group-by hot path: the CUDA kernel
``csrc/segsum.cu``, its plain PyTorch version, and the digit-lane helpers.

Counterpart of ``spark_rapids_tpu/ops/pallas_segsum.py``. The group-by
route that uses it (``exec/nodes.py`` ``_AggKernels._segsum_agg``) sorts
rows by packed key, numbers the groups densely, and encodes every
aggregate as integer digit lanes: lane 0 counts live rows, then the key's
8-bit digits, then 8-bit balanced digits of fixed-point floats. Summing
integer digits is exact in f32 while a group has at most MAX_GROUP_ROWS
rows, so the result does not depend on the order of the sum.

The constants keep the JAX package's values: they decide which route a
batch takes and therefore the low bits of the result.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from spark_rapids_tpu_torch.analysis import kernel_audit
from spark_rapids_tpu_torch.ops import _build

TILE = 1024
#: per-group row-count bound: 8-bit digits times 2^16 rows stay below 2^24
MAX_GROUP_ROWS = 1 << 16
#: digit shifts covering 47 bits below the batch max exponent
SHIFTS = (40, 32, 24, 16, 8, 0)
#: batches above this capacity run the kernel per CHUNK_ROWS slice and
#: merge the partials (the JAX package's value, sized for its device)
CHUNK_ROWS = 1 << 23

#: kernel launches since the count was last set to 0
launches = 0


def segsum_plain(gid: torch.Tensor, payload: torch.Tensor,
                 outcap: int) -> torch.Tensor:
    """Plain PyTorch version: f32 index_add_ over the ids in range."""
    out = torch.zeros(outcap, payload.shape[0], dtype=torch.float32,
                      device=payload.device)
    keep = (gid >= 0) & (gid < outcap)
    out.index_add_(0, gid[keep].to(torch.int64),
                   payload[:, keep].t().to(torch.float32))
    return out


_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = _build.load("segsum")
    if not _argtypes_set:
        lib.segsum_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.segsum_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def segsum(gid: torch.Tensor, payload: torch.Tensor,
           outcap: int) -> torch.Tensor:
    """gid int32[N], N a multiple of 8; payload bf16[P, N], one plane per
    lane, 1 <= P <= 256 (the JAX kernel takes the transpose, [N, P]). On
    the card both must start on a 16-byte boundary, and the ids must be
    sorted ascending: the kernel writes a run of equal ids that lies
    inside one block with a plain store, so an id found in two places
    would keep only one of its sums. Returns f32[outcap, P] per-id sums;
    ids outside [0, outcap) are dropped."""
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"segsum gid must be int32[N], got "
                        f"{gid.dtype}{list(gid.shape)}")
    if payload.dtype != torch.bfloat16 or payload.dim() != 2 \
            or payload.shape[1] != gid.shape[0] \
            or not 1 <= payload.shape[0] <= 256:
        raise TypeError(f"segsum payload must be bf16[P<=256, N] matching "
                        f"gid, got {payload.dtype}{list(payload.shape)}")
    if gid.device != payload.device or outcap <= 0:
        raise ValueError("segsum: gid and payload on one device, outcap > 0")
    if gid.shape[0] % 8:
        raise ValueError(f"segsum takes N a multiple of 8, got {gid.shape[0]}")
    return kernel_audit.charged("segsum", _segsum, gid, payload, outcap)


def _segsum(gid: torch.Tensor, payload: torch.Tensor,
            outcap: int) -> torch.Tensor:
    if gid.device.type == "cpu":
        return segsum_plain(gid, payload, outcap)
    if gid.device.type != "cuda":
        raise TypeError(f"no segsum kernel for device {gid.device}")
    global launches
    g = gid.contiguous()
    p = payload.contiguous()
    if g.data_ptr() % 16 or p.data_ptr() % 16:
        raise ValueError("segsum kernel needs gid and payload on 16-byte "
                         "boundaries")
    out = torch.zeros(outcap, p.shape[0], dtype=torch.float32, device=g.device)
    # the launch goes to the current device: make it the tensor's card
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = _lib().segsum_launch(g.data_ptr(), p.data_ptr(), out.data_ptr(),
                                  g.shape[0], p.shape[0], outcap, stream)
    _build.check(rc, "segsum")
    with _build.count_lock:
        launches += 1
    return out


def float_digits(clean: torch.Tensor, scale: torch.Tensor
                 ) -> List[torch.Tensor]:
    """8-bit balanced digit planes of round(clean * scale), as bf16."""
    rem = torch.round(clean * scale)
    out = []
    for shift in SHIFTS:
        if shift:
            d = torch.round(rem / float(2.0 ** shift))
            rem = rem - d * float(2.0 ** shift)
        else:
            d = torch.round(rem)
        out.append(d.to(torch.bfloat16))
    return out


def digits_to_f64(cols: List[torch.Tensor]) -> torch.Tensor:
    tot = torch.zeros(cols[0].shape[0], dtype=torch.float64,
                      device=cols[0].device)
    for d, shift in zip(cols, SHIFTS):
        tot = tot + d.to(torch.float64) * float(2.0 ** shift)
    return tot


def int_digits(code: torch.Tensor, nbits: int
               ) -> Tuple[List[torch.Tensor], List[int]]:
    """Unsigned 8-bit digit planes of a small nonnegative int plane."""
    shifts = list(range(0, nbits, 8))[::-1]
    return [((code >> sh) & 0xFF).to(torch.bfloat16) for sh in shifts], shifts


def int_digits_to_val(cols: List[torch.Tensor], shifts: List[int],
                      counts: torch.Tensor) -> torch.Tensor:
    """Per-group int values from digit-times-count sums."""
    safe = torch.clamp(counts, min=1.0).to(torch.float64)
    v = torch.zeros(cols[0].shape[0], dtype=torch.float64,
                    device=cols[0].device)
    for d, sh in zip(cols, shifts):
        v = v + torch.round(d.to(torch.float64) / safe) * float(1 << sh)
    return v
