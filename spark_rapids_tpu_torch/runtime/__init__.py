"""runtime layer of spark_rapids_tpu_torch (see the package docstring)."""
