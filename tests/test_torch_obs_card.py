"""The live layer's liveness probe on the card (no JAX here: this file
runs on a machine with an NVIDIA card, ``python -m pytest -m cuda
tests/test_torch_obs_card.py``; elsewhere it skips).

The probe of ``runtime/obs/endpoint.device_probe`` runs its op on a side
stream of its own and waits on an event of that stream alone, so it
answers while the default stream still holds queued kernels.
"""
import time

import pytest
import torch

from spark_rapids_tpu_torch.runtime.obs.endpoint import (
    DeviceProbe, device_probe,
)


@pytest.mark.cuda
def test_probe_answers_while_the_default_stream_is_busy():
    # decided inside the test: collection must not depend on the machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the probe's side stream)")
    probe = device_probe("cuda")
    assert probe()
    a = torch.randn(8192, 8192, device="cuda")
    for _ in range(40):  # ~1 s of matmuls queued on the default stream
        a = a @ a
        a = a / a.norm()
    queued = torch.cuda.Event()
    queued.record()
    doc = DeviceProbe(probe, timeout_s=2.0).check()
    assert not queued.query(), "the default stream drained before the probe"
    torch.cuda.synchronize()
    assert doc["alive"] is True and doc["probe_ms"] < 1000.0, doc
