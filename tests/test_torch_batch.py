"""Batches of the PyTorch port: Arrow round trips, the capacity ladder,
batch rebuilding from the JAX package, concatenation and compaction."""
import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import batch as JB

from spark_rapids_tpu_torch.columnar import batch as B
from spark_rapids_tpu_torch.ops import kernels as K

from torch_port_helpers import from_jax_batch


def _mixed(n, seed=1, null_p=0.15):
    rng = np.random.default_rng(seed)

    def nulls(a, type=None):
        return pa.array(a, type, mask=rng.random(n) < null_p)

    return pa.table({
        "b": nulls(rng.random(n) < 0.5),
        "i8": nulls(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": nulls(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "i32": nulls(rng.integers(-2 ** 31, 2 ** 31, n,
                                  dtype=np.int64).astype(np.int32)),
        "i64": nulls(rng.integers(-2 ** 62, 2 ** 62, n)),
        "f32": nulls(rng.normal(0, 10, n).astype(np.float32)),
        "f64": nulls(rng.normal(0, 1e9, n)),
        "d": pa.array([datetime.date(2000, 1, 1)
                       + datetime.timedelta(days=int(x))
                       for x in rng.integers(0, 9000, n)], pa.date32()),
        "dict": nulls(np.array(["A", "N", "R", "héllo"])[
            rng.integers(0, 4, n)]),
        "flat": nulls([f"id-{i:06d}" for i in range(n)], pa.string()),
    })


TABLES = {
    "mixed": lambda: _mixed(3000),
    "no_nulls": lambda: _mixed(2000, seed=2, null_p=0.0),
    "bucket_edge_1024": lambda: _mixed(1024, seed=3),
    "bucket_edge_1025": lambda: _mixed(1025, seed=4),
    "empty": lambda: _mixed(0, seed=5),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_arrow_round_trip_matches_jax(name):
    t = TABLES[name]()
    port = B.to_arrow(B.from_arrow(t, "cpu"), t.schema.names)
    assert port.equals(t), (port.schema, t.schema)
    ref = JB.to_arrow(JB.from_arrow(t), t.schema.names)
    assert port.to_pylist() == ref.to_pylist()


def test_dictionary_typed_input_uploads_as_dict_codes():
    t = pa.table({"s": pa.array(["x", "y", None, "x"]).dictionary_encode()})
    b = B.from_arrow(t, "cpu")
    assert b.columns[0].is_dict and b.columns[0].dict_size == 2
    assert B.to_arrow(b, ["s"]).column(0).to_pylist() == ["x", "y", None, "x"]


@pytest.mark.parametrize("name", ["mixed", "no_nulls"])
def test_from_jax_batch_rebuilds_the_same_planes(name):
    t = TABLES[name]()
    jb = JB.from_arrow(t)
    rebuilt = from_jax_batch(jb)
    direct = B.from_arrow(t, "cpu")
    assert rebuilt.capacity == direct.capacity == jb.capacity
    for rc, dc in zip(rebuilt.columns, direct.columns):
        assert rc.dtype == dc.dtype and rc.is_dict == dc.is_dict
        planes = rc.data.items() if isinstance(rc.data, dict) \
            else [("data", rc.data)]
        for key, plane in planes:
            other = dc.data[key] if isinstance(dc.data, dict) else dc.data
            n = t.num_rows if key in ("data", "codes") else len(other)
            assert torch.equal(plane[:n], other[:n]), key
        assert (rc.validity is None) == (dc.validity is None)
        if rc.validity is not None:
            assert torch.equal(rc.validity, dc.validity)
    assert B.to_arrow(rebuilt, t.schema.names).equals(t)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 1000, 1024, 1025, 4097,
                               (1 << 23) - 1, 30_000_000])
@pytest.mark.parametrize("minimum", [8, 1024])
def test_round_capacity_matches_jax(n, minimum):
    assert B.round_capacity(n, minimum) == JB.round_capacity(n, minimum)


def test_lazy_row_count_reads_once():
    lz = B.LazyRowCount(torch.tensor(5))
    assert repr(lz) == "LazyRowCount(<device>)"
    assert int(lz) == 5 and lz._val == 5
    assert repr(lz) == "LazyRowCount(5)"


def test_concat_unifies_vocabularies():
    a = pa.table({"s": ["x", "y", None], "v": [1, 2, 3]})
    b = pa.table({"s": ["z", "x", "y", "z"], "v": [4, 5, 6, 7]})
    out = K.concat_batches([B.from_arrow(a, "cpu"), B.from_arrow(b, "cpu")])
    assert out.columns[0].dict_size == 3
    assert B.to_arrow(out, ["s", "v"]).equals(pa.concat_tables([a, b]))


def test_masked_filter_concat_and_compact():
    t = _mixed(2500, seed=8)
    parts, want = [], []
    for lo in (0, 1200):
        piece = t.slice(lo, 1300 if lo == 0 else 1300)
        b = B.from_arrow(piece, "cpu")
        keep = torch.from_numpy(np.arange(b.capacity) % 3 == 0)
        parts.append(K.mask_filter_batch(b, keep))
        idx = [i for i in range(piece.num_rows) if i % 3 == 0]
        want.append(piece.take(idx))
    cat = K.concat_batches(parts)
    assert cat.row_mask is not None and int(cat.num_rows) == sum(
        w.num_rows for w in want)
    names = t.schema.names
    want_t = pa.concat_tables(want)
    assert B.to_arrow(cat, names).equals(want_t)
    compact = K.compact_batch(cat)
    assert compact.row_mask is None
    assert compact.capacity == B.round_capacity(want_t.num_rows)
    assert B.to_arrow(compact, names).equals(want_t)
