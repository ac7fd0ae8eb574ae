"""Spark murmur3 of an int32 plane: the CUDA kernel ``csrc/murmur3.cu``
and its plain PyTorch version.

Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py``
``murmur3_int32_pallas``. Hash planes are int32 tensors holding the
uint32 bit pattern, as the JAX package returns them.

``murmur3_int32`` takes the plain version for a tensor on the CPU and
launches the kernel for a tensor on the card; there is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from spark_rapids_tpu_torch.analysis import kernel_audit
from spark_rapids_tpu_torch.ops import _build

#: kernel launches since the count was last set to 0
launches = 0

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64, split in 16-bit
    halves of c so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(k1, 0xCC9E2D51), 15), 0x1B873593)


def mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value held in int64."""
    return x.to(torch.int64) & _M32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> int32 bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _seed_u32(seed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return to_u32(seed)
    return torch.full_like(like, int(seed) & _M32, dtype=torch.int64)


def murmur3_int32_plain(values: torch.Tensor,
                        seed: Union[int, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic in int64 masked to 32
    bits (uint32 shifts and adds are not available on the CPU, and >> on
    int32 is arithmetic)."""
    k1 = mix_k1(to_u32(values))
    return from_u32(fmix(mix_h1(_seed_u32(seed, k1), k1), 4))


_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = _build.load("murmur3")
    if not _argtypes_set:
        lib.murmur3_int32_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.murmur3_int32_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def murmur3_int32(values: torch.Tensor,
                  seed: Union[int, torch.Tensor]) -> torch.Tensor:
    """Spark hashInt of every element of an int32 plane with a scalar seed
    or a per-row int32 seed plane; returns the int32 bit patterns."""
    if values.dtype != torch.int32 or values.dim() != 1:
        raise TypeError(f"murmur3_int32 takes int32[n], got "
                        f"{values.dtype}{list(values.shape)}")
    per_row = isinstance(seed, torch.Tensor)
    if per_row and (seed.dtype != torch.int32
                    or seed.shape != values.shape
                    or seed.device != values.device):
        raise TypeError("a per-row seed must be int32 of the values' shape "
                        "on the values' device")
    return kernel_audit.charged("murmur3_int32", _murmur3_int32, values,
                                seed)


def _murmur3_int32(values: torch.Tensor,
                   seed: Union[int, torch.Tensor]) -> torch.Tensor:
    per_row = isinstance(seed, torch.Tensor)
    if values.device.type == "cpu":
        return murmur3_int32_plain(values, seed)
    if values.device.type != "cuda":
        raise TypeError(f"no murmur3 kernel for device {values.device}")
    global launches
    x = values.contiguous()
    seeds = seed.contiguous() if per_row else None
    out = torch.empty_like(x)
    # the launch goes to the current device: make it the tensor's card
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().murmur3_int32_launch(
            x.data_ptr(), seeds.data_ptr() if per_row else None,
            0 if per_row else int(seed) & _M32, out.data_ptr(), x.numel(),
            stream)
    _build.check(rc, "murmur3_int32")
    with _build.count_lock:
        launches += 1
    return out
