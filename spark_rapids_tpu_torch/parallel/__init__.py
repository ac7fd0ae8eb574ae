"""Distributed execution over a device mesh.

Counterpart of ``spark_rapids_tpu/parallel/``. The reference's shuffle
subsystem (its UCX transport and peer-to-peer fetch) is replaced, as in
the JAX package, by collectives over the mesh, here in one process over
a tuple of ``torch.device``s:

- hash exchange  -> the lane exchange (exchange.py): [P, C] send planes a
  source, lane j copied to shard j's device
- broadcast      -> every shard's planes concatenated on every device
- reduction aggs -> the shard sum

No ``torch.distributed``: NCCL wants one rank per process and refuses two
ranks on one card, and the JAX package has no multi-process path.
"""
from spark_rapids_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshDeviceError,
    check_mesh_devices,
    make_mesh,
    mesh_devices,
    mesh_fingerprint,
    multichip_devices,
    virtual_devices,
)
