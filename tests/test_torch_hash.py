"""The port's ``hash`` and ``xxhash64`` against the JAX package, on the CPU.

Spark's murmur3 (seed 42) and xxhash64 (seed 42), compared bit for bit
with the JAX package over every fixed-width type, decimal64, date and
timestamp, and (for ``hash``) flat and dictionary strings, with nulls,
+-0.0 and NaN; one column at a time and chained, through the DataFrame,
SQL and the CPU backend. Also the kernels underneath
(``spark_murmur3_batch``, ``xxhash64_int32``/``xxhash64_int64``) on the
same planes, the tags, and ``xxhash64`` of strings, which the port hashes
as Spark does (XXH64 of the UTF-8 bytes) where the JAX package's CPU
evaluation raises.
"""
from __future__ import annotations

import decimal
import struct

import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import from_jax_batch, jax_api, torch_api

import jax.numpy as jnp
from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import kernels as JK

from spark_rapids_tpu_torch.expr.misc import xxhash64_bytes
from spark_rapids_tpu_torch.ops import kernels as K

N = 700
JAX, TORCH = jax_api(), torch_api()

FIXED = ("i8", "i16", "i32", "i64", "f32", "f64", "b", "d", "ts", "dec")
STRINGS = ("dict", "flat")


def _table(seed=9, n=N) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.1

    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25])
    f64 = np.where(rng.random(n) < 0.4, special[rng.integers(0, 7, n)],
                   rng.normal(0, 1e6, n))
    words = np.array(["", "a", "bb", "héllo", "key-1", "key-22", "ß"], object)
    return pa.table({
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                       mask=nulls()),
        "i16": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                        mask=nulls()),
        "i32": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                        mask=nulls()),
        "i64": pa.array(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                     dtype=np.int64), mask=nulls()),
        "f32": pa.array(f64.astype(np.float32), mask=nulls()),
        "f64": pa.array(f64, mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array(rng.integers(-30000, 30000, n).astype(np.int32),
                      pa.date32(), mask=nulls()),
        "ts": pa.array(rng.integers(-2 ** 50, 2 ** 50, n), pa.timestamp("us"),
                       mask=nulls()),
        "dec": pa.array([None if m else decimal.Decimal(int(v)).scaleb(-2)
                         for v, m in zip(rng.integers(-10 ** 12, 10 ** 12, n),
                                         nulls())], pa.decimal128(15, 2)),
        "dict": pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                         mask=nulls()),
        "flat": pa.array([f"row-{i}-{'x' * (i % 37)}" for i in range(n)],
                         pa.string(), mask=nulls()),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


def _select(api, s, t, exprs, parts=1):
    return s.create_dataframe(t, num_partitions=parts).select(
        *[e.alias(f"h{i}") for i, e in enumerate(exprs)])


def _both(table, make, parts=1, cpu=False):
    """make(api) -> exprs, through both packages (collect_cpu when cpu)."""
    out = []
    for api in (TORCH, JAX):
        df = _select(api, api.session(), table, make(api), parts)
        out.append(df.collect_cpu() if cpu else df.collect())
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _batches(table):
    jb = jax_from_arrow(table)
    return jb, from_jax_batch(jb)


@pytest.mark.parametrize("cols", [[c] for c in FIXED + STRINGS]
                         + [["i64", "i32", "dict", "f64"],
                            ["dict", "i32", "flat", "b", "dec"],
                            ["i32", "i16", "i8", "d"]],
                         ids=lambda c: "+".join(c))
def test_spark_murmur3_batch_bit_equal(table, cols):
    jb, pb = _batches(table.select(cols))
    want = np.asarray(JK.spark_murmur3_batch(jb.columns, jb.num_rows))
    got = K.spark_murmur3_batch(pb.columns, pb.num_rows)
    np.testing.assert_array_equal(got.numpy()[:N], want[:N])


@pytest.mark.parametrize("width", [32, 64])
def test_xxhash64_kernels_bit_equal(width):
    rng = np.random.default_rng(width)
    dt = np.int32 if width == 32 else np.int64
    info = np.iinfo(dt)
    v = np.concatenate([rng.integers(info.min, info.max, 5000, dtype=dt),
                        np.array([0, -1, info.min, info.max], dt)])
    seeds = rng.integers(-2 ** 63, 2 ** 63 - 1, v.shape[0], dtype=np.int64)
    jfn = JK.xxhash64_int32 if width == 32 else JK.xxhash64_int64
    pfn = K.xxhash64_int32 if width == 32 else K.xxhash64_int64
    for seed_j, seed_p in ((42, 42),
                           (jnp.asarray(seeds.view(np.uint64)),
                            torch.from_numpy(seeds))):
        want = np.asarray(jfn(jnp.asarray(v), seed_j))
        np.testing.assert_array_equal(
            pfn(torch.from_numpy(v), seed_p).numpy(), want)


def test_xxhash64_bytes_is_xxh64():
    """The byte form is XXH64 itself: the standard empty-input value, and
    Spark's hashInt/hashLong are XXH64 of the value's little-endian
    bytes."""
    assert xxhash64_bytes(b"", 0) & (2 ** 64 - 1) == 0xEF46DB3751D8E999
    rng = np.random.default_rng(4)
    for v in rng.integers(-2 ** 31, 2 ** 31, 50):
        assert xxhash64_bytes(struct.pack("<i", int(v)), 42) == int(
            K.xxhash64_int32(torch.tensor([int(v)]), 42)[0])
    for v in rng.integers(-2 ** 63, 2 ** 63 - 1, 50, dtype=np.int64):
        assert xxhash64_bytes(struct.pack("<q", int(v)), 7) == int(
            K.xxhash64_int64(torch.tensor([int(v)]), 7)[0])


# ---------------------------------------------------------------------------
# the functions, through the DataFrame, SQL and the CPU backend
# ---------------------------------------------------------------------------

def _hashes(cols, fn="hash"):
    def make(api):
        return [getattr(api.F, fn)(*[api.col(c) for c in cols])]
    return make


CASES = {f"hash_{c}": (_hashes([c]), 1) for c in FIXED + STRINGS}
CASES.update({f"xxhash64_{c}": (_hashes([c], "xxhash64"), 1)
              for c in FIXED})
CASES.update({
    "hash_chained": (_hashes(["i64", "i32", "dict", "f64", "flat", "b"]), 3),
    "hash_dict_first": (_hashes(["dict", "i32", "d"]), 2),
    "xxhash64_chained": (_hashes(["i32", "i64", "f32", "f64", "dec", "ts"],
                                 "xxhash64"), 3),
    "both_over_exprs": (lambda api: [
        api.F.hash(api.col("i32") + api.lit(1), api.col("i64")),
        api.F.xxhash64(api.col("d"), api.col("i8") * api.lit(2))], 2),
})


@pytest.mark.parametrize("case", list(CASES))
def test_functions_bit_equal(table, case):
    make, parts = CASES[case]
    got, want = _both(table, make, parts)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("case", ["hash_chained", "hash_dict_first",
                                  "xxhash64_chained", "hash_dec",
                                  "xxhash64_f32", "xxhash64_ts"])
def test_cpu_backend_bit_equal(table, case):
    make, parts = CASES[case]
    got, want = _both(table, make, parts, cpu=True)
    assert_tables_equal(got, want)
    device, _ = _both(table, make, parts)
    assert_tables_equal(got, device)


def test_sql_bit_equal(table):
    q = ("SELECT hash(i64, i32, dict) AS h, xxhash64(i32, f64, d) AS x, "
         "hash(flat) AS hf FROM t WHERE i16 > 0")
    out = []
    for api in (TORCH, JAX):
        s = api.session()
        s.create_or_replace_temp_view("t", s.create_dataframe(table, 2))
        out.append(s.sql(q).collect())
    assert_tables_equal(*out)


def test_hash_is_the_device_operator_and_keys_a_group_by(table):
    out = []
    for api in (TORCH, JAX):
        F, col = api.F, api.col
        s = api.session()
        df = s.create_dataframe(table, num_partitions=2).select(
            (F.hash(col("i32"), col("dict")) % api.lit(7)).alias("b"),
            col("f64"))
        out.append(df.group_by("b").agg(F.count().alias("n")).collect())
    assert_tables_equal(*out, ignore_order=True)


# ---------------------------------------------------------------------------
# tags and strings in xxhash64
# ---------------------------------------------------------------------------

def test_xxhash64_of_strings_runs_on_the_cpu(table):
    """The tag sends it to the CPU in both packages, with the same
    reason; the port then hashes each string's UTF-8 bytes with XXH64,
    chained through the running seed, where the JAX package's CPU
    evaluation raises (ROADMAP C5)."""
    from spark_rapids_tpu_torch.plan.overrides import wrap_and_tag
    from spark_rapids_tpu.plan.overrides import wrap_and_tag as jax_tag
    reasons = []
    for api, tag in ((TORCH, wrap_and_tag), (JAX, jax_tag)):
        s = api.session()
        df = _select(api, s, table, [api.F.xxhash64(api.col("i32"),
                                                    api.col("dict"))])
        stack, found = [tag(df.plan, s.conf)], []
        while stack:
            m = stack.pop()
            found += [(type(m.plan).__name__, r) for r in m.reasons]
            stack.extend(m.children)
        reasons.append(found)
    assert reasons[0] == reasons[1] == [
        ("Project",
         "Project: xxhash64 over string/nested columns runs on CPU")]
    s = TORCH.session()
    got = _select(TORCH, s, table, [TORCH.F.xxhash64(
        TORCH.col("i32"), TORCH.col("dict"))]).collect()["h0"].to_pylist()
    i32 = table["i32"].to_pylist()
    words = table["dict"].to_pylist()
    for g, a, w in zip(got, i32, words):
        h = 42 if a is None else int(K.xxhash64_int32(torch.tensor([a]),
                                                      42)[0])
        if w is not None:
            h = xxhash64_bytes(w.encode(), h)
        assert g == h
    with pytest.raises(ValueError):
        _select(JAX, JAX.session(), table,
                [JAX.F.xxhash64(JAX.col("dict"))]).collect()


def test_functions_are_ported():
    from spark_rapids_tpu_torch.sql import functions as F
    assert "hash" not in F.NOT_PORTED and "xxhash64" not in F.NOT_PORTED
