"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The lineitem generator and the four query shapes of the port's first slice
are written once against a package namespace, so the same program runs
through ``spark_rapids_tpu`` (the reference) and ``spark_rapids_tpu_torch``.
``from_jax_batch`` rebuilds a JAX package batch as a torch batch, so single
operations can be compared on identical inputs.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pyarrow as pa

LO, HI = 8766, 9131  # [1994-01-01, 1995-01-01) in days since epoch


def make_lineitem(rows: int, seed: int = 42) -> pa.Table:
    """bench.py's lineitem columns at `rows` rows, from a numpy seed."""
    orders = max(rows // 10, 1000)
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R"])[rng.integers(0, 3, rows)]
    status = np.array(["F", "O"])[rng.integers(0, 2, rows)]
    return pa.table({
        "l_orderkey": rng.integers(0, orders, rows).astype(np.int64),
        "l_returnflag": flags,
        "l_linestatus": status,
        "l_quantity": rng.integers(1, 51, rows).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105000.0, rows), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.10, rows), 2),
        "l_shipdate": rng.integers(8400, 10600, rows).astype(np.int32),
    })


def jax_api() -> SimpleNamespace:
    from spark_rapids_tpu.expr.core import col, lit
    from spark_rapids_tpu.sql import functions as F
    from spark_rapids_tpu.sql.session import TpuSession
    return SimpleNamespace(col=col, lit=lit, F=F,
                           session=lambda conf=None: TpuSession(conf))


def torch_api() -> SimpleNamespace:
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.expr.core import col, lit
    from spark_rapids_tpu_torch.sql import functions as F
    return SimpleNamespace(col=col, lit=lit, F=F,
                           session=lambda conf=None: TorchSession(
                               conf, device="cpu"))


def q6(api, df):
    col, lit, F = api.col, api.lit, api.F
    cond = ((col("l_shipdate") >= lit(LO)) & (col("l_shipdate") < lit(HI))
            & (col("l_discount") >= lit(0.05))
            & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0)))
    return df.filter(cond).agg(
        F.sum(col("l_extendedprice") * col("l_discount")).alias("revenue"))


def q1(api, df):
    col, lit, F = api.col, api.lit, api.F
    return (df.filter(col("l_shipdate") <= lit(10471))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sq"),
                 F.sum(col("l_extendedprice")).alias("sp"),
                 F.avg(col("l_quantity")).alias("mq"),
                 F.avg(col("l_discount")).alias("md"),
                 F.count(col("l_quantity")).alias("cnt"),
                 F.min(col("l_discount")).alias("mind"),
                 F.max(col("l_shipdate")).alias("maxs")))


def q72shfl(api, df, value="l_quantity"):
    """The grouped half of bench.py's q72shfl (the final reduction is
    compared on the host)."""
    col, lit, F = api.col, api.lit, api.F
    return (df.select((col("l_orderkey") % lit(100_000)).alias("k"),
                      col(value))
            .group_by(col("k"))
            .agg(F.sum(value).alias("s"), F.count(value).alias("c")))


def repart_agg(api, df, value="l_quantity", n=8):
    col, F = api.col, api.F
    return (df.select(col("l_shipdate"), col(value))
            .repartition(n, col("l_shipdate"))
            .group_by(col("l_shipdate"))
            .agg(F.sum(value).alias("s"), F.count(value).alias("c")))


def from_jax_batch(batch):
    """A JAX package ColumnarBatch rebuilt, plane by plane, as a torch
    ColumnarBatch on the CPU (numpy arrays in between)."""
    import torch

    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnVector, ColumnarBatch,
    )

    def t(a):
        return torch.from_numpy(np.array(a))

    cols = []
    for c in batch.columns:
        dtype = getattr(TT, type(c.dtype).__name__)()
        if isinstance(c.data, dict):
            data = {k: t(v) for k, v in c.data.items()}
        else:
            data = t(c.data)
        validity = None if c.validity is None else t(c.validity)
        cols.append(ColumnVector(dtype, data, validity,
                                 dict_unique=c.dict_unique, bounds=c.bounds))
    mask = None if batch.row_mask is None else t(batch.row_mask)
    return ColumnarBatch(cols, int(batch.num_rows), mask)
