"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
A ``csrc/<name>.cpp`` is host code (the shuffle's frame packer,
``kudo.cpp``) and compiles with the host C++ compiler the same way.
The build runs at first use (or all at once, in parallel, through
``build_all``) and writes into ``build/torch_kernels/<name>-<hash>/`` at
the root of the checkout, keyed by a hash of the source and the flags, so
an unchanged source is never rebuilt. The directory is listed in
``.gitignore``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand kernel failed to build, load or launch. Graceful
    degradation never re-runs such a query on the CPU backend
    (``sql/session._degradable``): a broken kernel must surface."""


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only where "
                      "the CUDA toolkit is installed")


def host_compiler_path() -> str:
    for cand in ("g++", "c++"):
        path = shutil.which(cand)
        if path:
            return path
    raise KernelError("no host C++ compiler (g++) found: the host "
                      "libraries of csrc/ build only where one is "
                      "installed")


def _source(name: str) -> str:
    """csrc/<name>.cu, or the host source csrc/<name>.cpp."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cpp")


def _is_host(src: str) -> bool:
    return src.endswith(".cpp")


def _log_name(src: str) -> str:
    return "g++.log" if _is_host(src) else "nvcc.log"


def _paths(name: str):
    src = _source(name)
    flags = HOST_FLAGS if _is_host(src) else NVCC_FLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest}")
    return src, out_dir, os.path.join(out_dir, f"lib{name}.so")


def _start(name: str):
    """Start the compiler for one source unless its library exists;
    returns the running process (or None) and the paths."""
    src, out_dir, lib = _paths(name)
    if os.path.exists(lib):
        return None, out_dir, lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [host_compiler_path(), *HOST_FLAGS] if _is_host(src) \
        else [nvcc_path(), *NVCC_FLAGS]
    try:
        proc = subprocess.Popen([*cmd, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise KernelError(f"cannot start the compiler for "
                          f"{os.path.basename(src)}: {e}") from e
    return proc, out_dir, lib


def _finish(name: str, proc, out_dir: str, lib: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    src = _source(name)
    with open(os.path.join(out_dir, _log_name(src)), "w") as f:
        f.write(log)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise KernelError(f"the build of {os.path.basename(src)} "
                          f"failed:\n{log}")
    os.replace(tmp, lib)


def build_all(names: List[str]) -> Dict[str, str]:
    """Build every named source, one nvcc process each, all started
    together. Returns {name: nvcc log} for the sources built now."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        logs = {}
        for name, proc, out_dir, lib in started:
            _finish(name, proc, out_dir, lib)
            if proc is not None:
                with open(os.path.join(out_dir,
                                       _log_name(_source(name)))) as f:
                    logs[name] = f.read()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built
    first if needed. The first load's time (the build, when the library
    is not on disk yet, and the dlopen) goes to the running query's
    ``compile`` attribution bucket."""
    lib = _libs.get(name)
    if lib is None:
        t0 = time.perf_counter_ns()
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                try:
                    lib = ctypes.CDLL(_paths(name)[2])
                except OSError as e:
                    raise KernelError(f"cannot load {name}: {e}") from e
                _libs[name] = lib
        from spark_rapids_tpu_torch.runtime.obs import attribution
        attribution.record("compile", time.perf_counter_ns() - t0)
    return lib


#: guards the wrappers' launch counts: partitions run on task threads
count_lock = threading.Lock()

#: cudaError_t of a failed device allocation
CUDA_ERROR_MEMORY_ALLOCATION = 2


def check(rc: int, what: str) -> None:
    """Raise on the cudaError_t a launch function returned: an allocation
    failure as ``torch.OutOfMemoryError``, which the retry framework
    drains and retries (``runtime/retry.is_device_oom``), any other code
    as a KernelError."""
    if rc == CUDA_ERROR_MEMORY_ALLOCATION:
        import torch
        raise torch.OutOfMemoryError(
            f"{what}: CUDA launch failed with error {rc} "
            f"(cudaErrorMemoryAllocation)")
    if rc != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {rc}")
