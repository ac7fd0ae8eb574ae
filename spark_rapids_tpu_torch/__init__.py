"""spark_rapids_tpu_torch: the Spark-SQL columnar engine of
``spark_rapids_tpu`` ported to PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``).

The package mirrors the JAX package's layout so each counterpart is easy
to find. It imports neither jax nor ``spark_rapids_tpu``: what it needs
from there it keeps in its own modules.

    from spark_rapids_tpu_torch import TorchSession
    s = TorchSession()                # the CUDA card; device="cpu" for the CPU
"""
from spark_rapids_tpu_torch.sql.session import TorchSession

__all__ = ["TorchSession"]
