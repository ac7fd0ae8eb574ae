"""The device mesh: an ordered tuple of ``torch.device``s.

Counterpart of ``spark_rapids_tpu/parallel/mesh.py``. The JAX package
runs one process over an XLA mesh whose axes are

- ``part``: partition parallelism; rows are hash, range or round-robin
  partitioned across it, and the shuffle's lane exchange rides it;
- ``dp``: batch parallelism within a partition.

The port keeps that model: one process, and a mesh that is an array of
devices with named axes (``Mesh``). Its devices are the visible CUDA
cards when the session runs on the card, and the one ``cpu`` device on
the CPU. ``virtual_devices(n)`` repeats them to ``n`` entries, the
port's counterpart of XLA's forced host device count: under it the
tests plan for the JAX package's 8 devices, and one card runs the whole
mesh machinery (shards that share a device run as one call a wave).
Outside it the device count is the real one.

This module is also the policy home for multi-device sizing
(``multichip_devices``/``mesh_fingerprint``, read by ``exec/sharded.py``
and the stage cache's conf fingerprint) and for the roster of modules
allowed to move data between shards (``SANCTIONED_COLLECTIVE_MODULES``,
checked by the linter's TPU-L016).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: The mesh axis sharded stages and the lane exchange ride: exec/sharded.py,
#: the exchange call sites and the stage cache's mesh fingerprint all read
#: it from here.
PART_AXIS = "part"

#: Modules allowed to call the mesh's collective functions (parallel/
#: exchange.py's lane exchange, broadcast and shard sum) or anything of
#: ``torch.distributed``. The linter's TPU-L016 fails a call site outside
#: this roster: data moved between shards by an unreviewed module is a
#: program whose shard contract nobody checked. Keys are paths relative to
#: the package root; values say why each module is sanctioned (rendered
#: into docs/torch_metrics.md by tools/torch_gen_docs.py).
SANCTIONED_COLLECTIVE_MODULES = {
    "parallel/exchange.py":
        "the shuffle collective itself: the lane exchange (one [P, C] send "
        "buffer a source, lane j copied to shard j's device), the "
        "broadcast and the shard sum",
    "parallel/distributed.py":
        "hand-built distributed groupby/reduction probes kept as the "
        "minimal-repro harness for mesh debugging",
    "exec/nodes.py":
        "ShuffleExchangeExec's ICI repartition path: the lane exchange "
        "with per-(source, destination) lane sizing",
}


class MeshDeviceError(RuntimeError):
    """A device the mesh was built over is no longer visible (a CUDA
    index past ``torch.cuda.device_count()``). Raised by
    ``check_mesh_devices`` before a sharded wave, so a stale mesh fails
    with this typed error instead of a CUDA error mid-wave."""


#: the repeat count of ``virtual_devices`` (0: the real devices). Process
#: wide, as XLA's forced device count is: task threads see it too.
_VIRTUAL = [0]


@contextlib.contextmanager
def virtual_devices(n: int):
    """Within the block, the platform's devices are repeated to ``n``
    entries (``cuda:0`` four times on a one-card machine, ``cpu`` eight
    times on the CPU). No conf key and no environment variable: the mesh
    of a session planned inside the block keeps its size."""
    if int(n) < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    prev = _VIRTUAL[0]
    _VIRTUAL[0] = int(n)
    try:
        yield
    finally:
        _VIRTUAL[0] = prev


def _platform(like=None) -> str:
    if like is not None:
        return torch.device(like).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _real_devices(kind: str) -> List[torch.device]:
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def mesh_devices(n: Optional[int] = None, like=None) -> Sequence[torch.device]:
    """The devices of the platform of ``like`` (a device or its name;
    default the card when there is one, else the CPU), repeated to the
    ``virtual_devices`` count inside that block; the first ``n``."""
    devs = _real_devices(_platform(like))
    if _VIRTUAL[0] and devs:
        devs = [devs[i % len(devs)] for i in range(_VIRTUAL[0])]
    if n is None:
        return devs
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return devs[:n]


class Mesh:
    """An array of devices with named axes (the subset of
    ``jax.sharding.Mesh`` the engine reads)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> List[torch.device]:
        """The devices in row-major order: shard i's device."""
        return list(self.devices.flat)


def _validate_axis_names(axis_names) -> Tuple[str, ...]:
    names = tuple(axis_names)
    if not names:
        raise ValueError("axis_names must name at least one mesh axis")
    for a in names:
        if not isinstance(a, str) or not a:
            raise ValueError(
                f"axis_names must be non-empty strings, got {a!r} in {names!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate mesh axis names: {names!r}")
    return names


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              axis_names=("dp", "part"), like=None) -> Mesh:
    axis_names = _validate_axis_names(axis_names)
    devs = list(mesh_devices(n_devices, like=like))
    n = len(devs)
    if n % dp != 0:
        raise ValueError(f"dp={dp} does not divide device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    if len(axis_names) == 1:
        if dp != 1:
            raise ValueError("dp > 1 needs a two-axis mesh (dp, part)")
    else:
        arr = arr.reshape(dp, n // dp)
    return Mesh(arr, axis_names)


def _visible(d: torch.device) -> bool:
    if d.type != "cuda":
        return True
    return (d.index or 0) < torch.cuda.device_count()


def check_mesh_devices(mesh) -> None:
    """Raise :class:`MeshDeviceError` if any device the mesh (a ``Mesh``
    or a sequence of devices) was built over is no longer visible. Called
    before every sharded wave."""
    devs = mesh.flat() if isinstance(mesh, Mesh) else list(mesh)
    stale = [d for d in devs if not _visible(d)]
    if stale:
        raise MeshDeviceError(
            f"mesh built over {len(devs)} devices but {len(stale)} of them "
            f"are no longer visible (stale: {[str(d) for d in stale]}); "
            "rebuild the mesh before dispatching")


def multichip_devices(conf, like=None) -> int:
    """How many devices the ``part`` axis gets under the session conf:
    spark.rapids.sql.multichip.devices (0 = all available), clamped to
    what the process has. Always >= 1."""
    from spark_rapids_tpu_torch import config as C
    avail = len(mesh_devices(like=like))
    requested = int(conf.get(C.MULTICHIP_DEVICES) or 0)
    if requested <= 0:
        return avail
    return max(1, min(requested, avail))


def mesh_fingerprint(conf) -> Tuple:
    """The mesh component of the stage cache's conf fingerprint: axis
    name and device count. A 1-device and an 8-device session never share
    an entry."""
    return (PART_AXIS, multichip_devices(conf))
