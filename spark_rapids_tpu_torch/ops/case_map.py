"""ASCII case map over a string byte plane: the CUDA kernel
``csrc/case_map.cu`` and its plain PyTorch version.

Counterpart of ``spark_rapids_tpu/ops/pallas_kernels.py``
``ascii_case_map_pallas`` together with its ``jnp.where`` twin in
``expr/strings.py``: only ``[a-z]`` (upper) or ``[A-Z]`` (lower) move by
32; every other byte, non-ASCII UTF-8 bytes and zero padding included,
passes through. The result is always a new plane: the input may be a
vocabulary that other columns share.

``case_map`` takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on the card; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch.analysis import kernel_audit
from spark_rapids_tpu_torch.ops import _build

#: kernel launches since the count was last set to 0
launches = 0


def case_map_plain(raw: torch.Tensor, upper: bool) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's ``jnp.where`` twin)."""
    if upper:
        return torch.where((raw >= 97) & (raw <= 122), raw - 32, raw)
    return torch.where((raw >= 65) & (raw <= 90), raw + 32, raw)


_argtypes_set = False


def _lib():
    global _argtypes_set
    lib = _build.load("case_map")
    if not _argtypes_set:
        lib.case_map_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.case_map_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def case_map(raw: torch.Tensor, upper: bool) -> torch.Tensor:
    """ASCII upper (``upper=True``) or lower case of a uint8[n] byte plane,
    as a new uint8[n] plane on the same device."""
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise TypeError(f"case_map takes a uint8[n] byte plane, got "
                        f"{raw.dtype}{list(raw.shape)}")
    return kernel_audit.charged("case_map", _case_map, raw, upper)


def _case_map(raw: torch.Tensor, upper: bool) -> torch.Tensor:
    if raw.device.type == "cpu":
        return case_map_plain(raw, upper)
    if raw.device.type != "cuda":
        raise TypeError(f"no case_map kernel for device {raw.device}")
    if raw.numel() == 0:
        # a grid of 0 blocks does not launch
        return torch.empty(0, dtype=torch.uint8, device=raw.device)
    global launches
    src = raw.contiguous()
    out = torch.empty_like(src)
    # the launch goes to the current device: make it the tensor's card
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _lib().case_map_launch(src.data_ptr(), out.data_ptr(),
                                    src.numel(), int(bool(upper)), stream)
    _build.check(rc, "case_map")
    with _build.count_lock:
        launches += 1
    return out
