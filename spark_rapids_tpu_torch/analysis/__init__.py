"""Runtime checks of the engine's own invariants (counterpart of
``spark_rapids_tpu/analysis/``):

- ``sanitizer.py``: the runtime concurrency sanitizer behind
  ``spark.rapids.debug.sanitizer.enabled``: instrumented Lock/Condition
  wrappers record the lock-acquisition-order graph, detect cycles
  (potential deadlocks), held-lock blocking and waits under a foreign
  lock, and dump a ranked report through the trace.
- ``plan_verify.py``: the plan-invariant verifier that ``convert_plan``
  runs under ``spark.rapids.debug.planVerify.enabled``.

The JAX package's lint suite and kernel audit check its own source and
its XLA programs; they have no counterpart here.
"""
