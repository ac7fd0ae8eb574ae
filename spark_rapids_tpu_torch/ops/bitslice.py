"""Unaligned bit-field extraction: the CUDA kernel ``csrc/bitslice.cu``
and its plain PyTorch version.

Counterpart of ``spark_rapids_tpu/ops/pallas_decode.py``
``bitslice_u32_pallas`` together with its caller ``_gather_bits``: the
kernel takes the word plane, a bit offset and a mask per element and does
the two word gathers itself. Word, mask and output planes are int32
tensors holding the uint32 bit patterns.

``bitslice`` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch.ops import _build

#: kernel launches since the count was last set to 0
launches = 0

_M32 = 0xFFFFFFFF


def words_of(pool: torch.Tensor) -> torch.Tensor:
    """A uint8 byte pool as its little-endian u32 word plane (int32 bit
    patterns), without a copy: pools are a whole number of words
    (``columnar.batch.bucket_pool_bytes``). Both the host and the card
    are little-endian, so the view equals the JAX package's explicit
    byte combine (``pallas_decode._words``)."""
    return pool.view(torch.int32)


def width_mask(width: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of (1 << w) - 1 for bit widths w in [0, 32]."""
    m = (torch.ones_like(width, dtype=torch.int64)
         << width.to(torch.int64)) - 1
    return torch.where(m > 0x7FFFFFFF, m - (1 << 32), m).to(torch.int32)


def bitslice_plain(words: torch.Tensor, bitoff: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic in int64 masked to
    32 bits (torch on the CPU has no uint32 shifts, and >> on int32 is
    arithmetic)."""
    widx = (bitoff >> 5).clamp(0, words.shape[0] - 2)
    w0 = words[widx].to(torch.int64) & _M32
    w1 = words[widx + 1].to(torch.int64) & _M32
    sh = bitoff & 31
    lo = w0 >> sh
    hi = torch.where(sh == 0, 0, (w1 << ((32 - sh) & 31)) & _M32)
    out = (lo | hi) & (mask.to(torch.int64) & _M32)
    return torch.where(out > 0x7FFFFFFF, out - (1 << 32), out).to(
        torch.int32)


_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = _build.load("bitslice")
    if not _argtypes_set:
        lib.bitslice_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.bitslice_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def bitslice(words: torch.Tensor, bitoff: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """The ``mask``-masked field at bit ``bitoff[i]`` of the word plane,
    for every i: int32 words[W] (W >= 2), int64 bitoff[n], int32
    mask[n] -> int32[n]. Offsets past the plane read its last word pair
    (the clamp the JAX package's ``_gather_bits`` applies)."""
    if words.dtype != torch.int32 or words.dim() != 1 \
            or words.shape[0] < 2:
        raise TypeError(f"bitslice takes int32[W] words with W >= 2, got "
                        f"{words.dtype}{list(words.shape)}")
    if bitoff.dtype != torch.int64 or bitoff.dim() != 1:
        raise TypeError(f"bitslice takes int64[n] bit offsets, got "
                        f"{bitoff.dtype}{list(bitoff.shape)}")
    if mask.dtype != torch.int32 or mask.shape != bitoff.shape:
        raise TypeError("the mask must be int32 of the offsets' shape")
    if not (words.device == bitoff.device == mask.device):
        raise TypeError("words, offsets and mask must share a device")
    if words.device.type == "cpu":
        return bitslice_plain(words, bitoff, mask)
    if words.device.type != "cuda":
        raise TypeError(f"no bitslice kernel for device {words.device}")
    global launches
    w = words.contiguous()
    b = bitoff.contiguous()
    m = mask.contiguous()
    out = torch.empty_like(m)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = _lib().bitslice_launch(w.data_ptr(), w.numel(), b.data_ptr(),
                                m.data_ptr(), out.data_ptr(), b.numel(),
                                stream)
    _build.check(rc, "bitslice")
    with _build.count_lock:
        launches += 1
    return out
