"""The mesh on NVIDIA cards (no JAX here: this file runs on a machine with
the card, ``python -m pytest --noconftest -m cuda
tests/test_torch_multichip_card.py``; elsewhere it skips).

Three programs under spark.rapids.sql.multichip.enabled, each held to a
one-device session's answer on the same seeded data
(``virtual_devices(1)``: one card, no lane exchange):

- a filter/projection chain with literals: one ``ShardedStageExec``;
- a group-by on an int32 key: partial -> lane exchange -> final, B1
  hashing the keys in the exchange's count pass;
- a repartition by a key, then a group-by on it.

``virtual`` runs the mesh under ``virtual_devices``: four shards on a
one-card machine, two shards a card on a machine with more (shards that
share a card pack into one call). ``real`` runs it over every visible
card (two or more), one shard a card. Over several cards each shard's
stage and each source's count pass evaluate on that shard's own card: a
literal or a kernel launch on the wrong card fails the query.
"""
import contextlib

import numpy as np
import pyarrow as pa
import pytest
import torch

ROWS = 1 << 20


def _table(seed=7):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(ROWS)
    return pa.table({
        "k": pa.array(rng.integers(0, 50_000, ROWS, dtype=np.int32)),
        "day": pa.array(rng.integers(8000, 10_500, ROWS, dtype=np.int32)),
        "q": pa.array(rng.integers(1, 51, ROWS).astype(np.float64)),
        "v": pa.array(v, mask=rng.random(ROWS) < 0.05),
    })


def _programs(df, n_parts):
    from spark_rapids_tpu_torch.expr.core import col, lit
    from spark_rapids_tpu_torch.sql import functions as F

    def chain():
        return (df.filter(col("day") % lit(3) != lit(1))
                .select(col("k"), (col("q") * lit(2.0) + lit(1.0)).alias("q2"),
                        (col("v") * lit(0.5)).alias("vh"))
                .filter(col("k") % lit(7) != lit(0))
                .select((col("k") + lit(1)).alias("k1"), col("q2"),
                        (col("vh") * col("vh")).alias("vsq")))

    def group_int32():
        return df.group_by(col("k")).agg(F.sum("q").alias("s"),
                                         F.count("v").alias("c"))

    def repart_agg():
        return (df.select(col("day"), col("q"))
                .repartition(n_parts, col("day"))
                .group_by(col("day")).agg(F.sum("q").alias("s"),
                                          F.count("q").alias("c")))

    return {"chain": chain, "group_int32": group_int32,
            "repart_agg": repart_agg}


def _sorted(tbl):
    return tbl.sort_by([(c, "ascending") for c in tbl.column_names])


def _close(got, want):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        a = got[name].to_numpy(zero_copy_only=False)
        b = want[name].to_numpy(zero_copy_only=False)
        if got[name].type == pa.float64():
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["virtual", "real"])
def test_sharded_plans_answer_as_one_device(mesh):
    # decided inside the test: collection must not depend on the machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if mesh == "real" and torch.cuda.device_count() < 2:
        pytest.skip("the real mesh needs two or more cards")
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.parallel.mesh import (
        mesh_devices, virtual_devices,
    )

    table = _table()
    with virtual_devices(1):
        one = TorchSession({})
        d1 = one.create_dataframe(table, num_partitions=4)
        want = {n: _sorted(p().collect())
                for n, p in _programs(d1, 4).items()}
    ctx = virtual_devices(max(4, 2 * torch.cuda.device_count())) \
        if mesh == "virtual" else contextlib.nullcontext()
    with ctx:
        devs = mesh_devices()
        n_shards, n_cards = len(devs), len(set(devs))
        s = TorchSession({"spark.rapids.sql.multichip.enabled": "true"})
        df = s.create_dataframe(table, num_partitions=n_shards)
        for name, prog in _programs(df, n_shards).items():
            for d in range(n_cards):
                torch.cuda.reset_peak_memory_stats(d)
            before = MK.launches
            got = _sorted(prog().collect())
            torch.cuda.synchronize()
            _close(got, want[name])
            nodes = list(s.last_exec.walk())
            kinds = [type(n).__name__ for n in nodes]
            if name == "chain":
                (st,) = [n for n in nodes
                         if type(n).__name__ == "ShardedStageExec"]
                assert len(set(st._shard_devices())) == n_cards
            else:
                ici = sum(n.metrics.metric("iciExchangeTime").value
                          for n in nodes
                          if type(n).__name__ == "ShuffleExchangeExec")
                assert "ShuffleExchangeExec" in kinds and ici > 0, kinds
            if name == "group_int32":
                assert MK.launches > before  # B1 hashed the int32 keys
            # every card held some of the work
            for d in range(n_cards):
                assert torch.cuda.max_memory_allocated(d) > 0, (name, d)
