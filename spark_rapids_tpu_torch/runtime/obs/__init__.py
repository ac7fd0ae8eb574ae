"""Observability helpers of spark_rapids_tpu_torch: the plan digest."""
