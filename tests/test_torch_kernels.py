"""Kernel modules of the PyTorch port against the JAX package.

The murmur3 and segsum wrappers run their plain PyTorch versions here (the
tensors lie on the CPU); the same inputs, made with numpy, go through the
JAX package's Pallas kernels in interpret mode and through its lax twins.
Every comparison is exact: both sides compute integers.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import kernels as JK
from spark_rapids_tpu.ops import pallas_kernels as JPK
from spark_rapids_tpu.ops import pallas_segsum as JPS
from spark_rapids_tpu.ops import radix as JR

import spark_rapids_tpu_torch
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
from spark_rapids_tpu_torch.ops import radix as R
from spark_rapids_tpu_torch.ops import segsum as S

from torch_port_helpers import from_jax_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(spark_rapids_tpu_torch.__file__)
EDGES = np.array([-2 ** 31, -1, 0, 1, 2 ** 31 - 1], np.int32)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    tools = os.path.join(ROOT, "tools")
    out.extend(os.path.join(tools, f) for f in os.listdir(tools)
               if f.startswith("torch_") and f.endswith(".py"))
    for d, _, files in os.walk(PKG):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "spark_rapids_tpu"}, (path, roots)


def test_import_leaves_jax_out():
    mods = [m.name for m in pkgutil.walk_packages([PKG],
                                                  "spark_rapids_tpu_torch.")]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 15


def _values(n=4096, seed=3):
    v = np.random.default_rng(seed).integers(-2 ** 31, 2 ** 31, n,
                                             dtype=np.int64).astype(np.int32)
    v[:len(EDGES)] = EDGES
    return v


@pytest.mark.parametrize("seed", [42, 0, 0x7FFFFFFF, 0xFFFFFFFF])
def test_murmur3_plain_matches_pallas_kernel(seed):
    v = _values()
    want = JPK.murmur3_int32_pallas(jnp.asarray(v), jnp.uint32(seed))
    want = np.asarray(want).view(np.int32)
    got = MK.murmur3_int32(torch.from_numpy(v), seed).numpy()
    np.testing.assert_array_equal(got, want)
    # and the JAX package's lax twin (a ragged length takes it)
    twin = np.asarray(JK.murmur3_int32(jnp.asarray(v[:4000]),
                                       jnp.uint32(seed))).view(np.int32)
    np.testing.assert_array_equal(got[:4000], twin)


def test_murmur3_per_row_seed_matches_lax_twin():
    v = _values(4096, seed=5)
    seeds = _values(4096, seed=6)
    want = np.asarray(JK.murmur3_int32(
        jnp.asarray(v), jnp.asarray(seeds.view(np.uint32)))).view(np.int32)
    got = MK.murmur3_int32(torch.from_numpy(v), torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.numpy(), want)


def test_murmur3_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        MK.murmur3_int32(torch.zeros(8, dtype=torch.int64), 42)
    with pytest.raises(TypeError):
        MK.murmur3_int32(torch.zeros(8, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32))
    before = MK.launches
    MK.murmur3_int32(torch.zeros(8, dtype=torch.int32), 42)
    assert MK.launches == before  # the plain version is no launch


def _hash_table(n=3000, seed=11):
    rng = np.random.default_rng(seed)

    def nulls(a, p=0.1):
        return pa.array(a, mask=rng.random(n) < p)

    return pa.table({
        "i32": nulls(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                     .astype(np.int32)),
        "i64": nulls(rng.integers(-2 ** 62, 2 ** 62, n)),
        "f64": nulls(np.where(rng.random(n) < 0.05, -0.0,
                              rng.normal(0, 1e6, n))),
        "f32": nulls(rng.normal(0, 1e3, n).astype(np.float32)),
        "b": nulls(rng.random(n) < 0.5),
        "i8": nulls(rng.integers(-128, 128, n).astype(np.int8)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32()),
        "dict": nulls(np.array(["", "a", "héllo", "abcdefgh", "xyz12"])[
            rng.integers(0, 5, n)]),
        "flat": nulls([f"row-{i}-{'z' * (i % 7)}" for i in range(n)]),
    })


@pytest.mark.parametrize("keys", [
    ["i32"], ["dict", "i64"], ["i64", "dict"], ["f64", "f32"], ["flat"],
    ["b", "i8", "d"]], ids=lambda k: "+".join(k))
def test_partition_hash_matches_jax(keys):
    t = _hash_table().select(keys)
    jb = jax_from_arrow(t)
    pb = from_jax_batch(jb)
    want = np.asarray(JK.partition_hash_batch(jb.columns, jb.num_rows))
    got = K.partition_hash_batch(pb.columns, pb.num_rows).numpy()
    np.testing.assert_array_equal(got[:t.num_rows], want[:t.num_rows])


def _segsum_inputs(P, n=4096, outcap=2048, dead=100, seed=2):
    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(0, 1500, n - dead)).astype(np.int32)
    gid = np.concatenate([gid, np.full(dead, outcap, np.int32)])
    pay = rng.integers(-128, 129, (n, P)).astype(np.float32)
    pay[:, 0] = 1.0
    return gid, pay


def _segsum_run_inputs(shape, P, n=4096, seed=4):
    """4096 rows in runs that meet the tiles (1024 rows in the JAX kernel)
    in every way: one group over all of them; every row its own group; and
    runs that cross a tile edge, end on a tile's last row, start on the
    next tile's first row and cover a tile from edge to edge, then dead
    rows at id outcap. 8-bit digits, lane 0 the live count."""
    rng = np.random.default_rng(seed)
    if shape == "one_group":
        gid, outcap = np.zeros(n, np.int32), 2048
    elif shape == "unique":
        gid, outcap = np.arange(n, dtype=np.int32), 6144
    else:
        lengths = [1000, 48, 1000, 1, 2031]
        gid = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
        outcap = 2048
        gid = np.concatenate([gid, np.full(n - len(gid), outcap, np.int32)])
    pay = rng.integers(-128, 129, (n, P)).astype(np.float32)
    pay[:, 0] = 1.0
    return gid, pay, outcap


_SEGSUM_CASES = [("random", 8), ("random", 16)] + [
    (shape, P) for shape in ("one_group", "unique", "crossing")
    for P in (1, 9, 11, 40)]


@pytest.mark.parametrize(
    "shape,P", _SEGSUM_CASES,
    ids=[str(P) if shape == "random" else f"{shape}-{P}"
         for shape, P in _SEGSUM_CASES])
def test_segsum_plain_matches_pallas_kernel(shape, P):
    if shape == "random":
        (gid, pay), outcap = _segsum_inputs(P), 2048
    else:
        gid, pay, outcap = _segsum_run_inputs(shape, P)
    # the JAX kernel takes P a multiple of 8: zero lanes pad it, and only
    # the real lanes are compared
    padded = np.concatenate([pay, np.zeros((len(gid), -P % 8), np.float32)],
                            axis=1)
    want = np.asarray(JPS.segsum_window(
        jnp.asarray(gid), jnp.asarray(padded, jnp.bfloat16), outcap))
    assert not want[:, P:].any()
    # the port takes the lanes as planes: the transpose of the JAX layout
    got = S.segsum(torch.from_numpy(gid),
                   torch.from_numpy(pay.T.copy()).to(torch.bfloat16),
                   outcap).numpy()
    np.testing.assert_array_equal(got, want[:, :P])


def test_segsum_wrapper_checks_inputs():
    gid = torch.zeros(16, dtype=torch.int32)
    pay = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        S.segsum(gid.to(torch.int64), pay, 64)
    with pytest.raises(TypeError):
        S.segsum(gid, pay.to(torch.float32), 64)
    with pytest.raises(TypeError):
        S.segsum(gid[:8], pay, 64)
    with pytest.raises(TypeError):
        S.segsum(gid, torch.zeros(300, 16, dtype=torch.bfloat16), 64)
    with pytest.raises(ValueError):
        S.segsum(gid, pay, 0)
    with pytest.raises(ValueError):  # N must be a multiple of 8
        S.segsum(gid[:12], pay[:, :12], 64)


@pytest.mark.parametrize("scale_of", ["mixed", "tiny", "zero", "huge"])
def test_digit_helpers_match_jax(scale_of):
    rng = np.random.default_rng(9)
    vals = {"mixed": rng.uniform(-1e5, 1e5, 512),
            "tiny": rng.uniform(-1e-9, 1e-9, 512),
            "zero": np.zeros(512),
            "huge": rng.uniform(-1e300, 1e300, 512)}[scale_of]
    m = np.abs(vals).max()
    jscale = JR._exponent_scale(jnp.float64(m)) * np.float64(2.0 ** 11)
    pscale = R._exponent_scale(torch.tensor(m, dtype=torch.float64)) \
        * float(2.0 ** 11)
    assert float(jscale) == float(pscale)
    jd = JPS.float_digits(jnp.asarray(vals), jscale)
    pd = S.float_digits(torch.from_numpy(vals), pscale)
    for a, b in zip(jd, pd):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())
    np.testing.assert_array_equal(
        np.asarray(JPS.digits_to_f64([a.astype(jnp.float32) for a in jd])),
        S.digits_to_f64([b.to(torch.float32) for b in pd]).numpy())
    code = rng.integers(0, 1 << 20, 512).astype(np.int32)
    jk, jsh = JPS.int_digits(jnp.asarray(code), 20)
    pk, psh = S.int_digits(torch.from_numpy(code), 20)
    assert jsh == psh
    counts = rng.integers(1, 50, 512).astype(np.float32)
    jv = JPS.int_digits_to_val([jnp.asarray(np.asarray(a, np.float32) * counts)
                                for a in jk], jsh, jnp.asarray(counts))
    pv = S.int_digits_to_val([b.to(torch.float32) * torch.from_numpy(counts)
                              for b in pk], psh, torch.from_numpy(counts))
    np.testing.assert_array_equal(np.asarray(jv), pv.numpy())
    np.testing.assert_array_equal(pv.numpy(), code.astype(np.float64))


def _segsum_edge_cases():
    """(label, gid, payload planes, outcap) at the CUDA kernel's edges. A
    block of the kernel stages a tile of segs x 64 rows (segs =
    min(32, 256 // P), fewer where the tile would not fit in shared
    memory: 2,048 rows at P <= 8, 1,472-1,792 at P = 9-11, 64 at
    P = 256) and one thread walks each 64-row segment
    of a lane, so the cases run from part of one tile to thousands of
    tiles, and their runs end on every 8-row edge (runs of 8), on and next
    to the segment and tile edges (runs of 63-65, 1,471-1,473,
    1,599-1,601, 1,791-1,793, 2,047-2,049 and random lengths), cover
    tiles from edge to edge and span many of them (runs of 2^16 and one
    run over all rows), or are one row each. Negative ids lead and dead
    rows at id outcap trail in one family. Digits are 8-bit where no run
    passes 2^16 rows and -1/0/1 beyond, so every sum is an integer below
    2^24 and the kernel must equal index_add_ exactly."""
    rng = np.random.default_rng(12)
    lanes = (1, 4, 5, 9, 11, 40, 256)
    cases = []
    for n in (8, 2048, 2056, 6152, (1 << 17) + 8, (1 << 22) + 8):
        rows = np.arange(n, dtype=np.int64)
        mixed = np.repeat(np.arange(n), rng.choice(
            [1, 2, 7, 8, 9, 64, 100, 1600, 2047, 2048, 2049, 5000], n))[:n]
        families = {"one run": np.zeros(n), "runs of 8": rows // 8,
                    "random runs": mixed,
                    "negative and dead": rows // 5 - 50}
        for length in (1, 3, 9, 63, 64, 65, 1471, 1472, 1473, 1599, 1600,
                       1601, 1791, 1792, 1793, 2047, 2048, 2049, 1 << 16):
            families[f"runs of {length}"] = rows // length
        for i, (name, gid) in enumerate(families.items()):
            P = lanes[(i + n) % len(lanes)]
            while P * n > 1 << 26:
                P //= 2
            gid = gid.astype(np.int32)
            outcap = 1 << max(11, int(gid.max()).bit_length())
            if name == "negative and dead":
                gid[-100:] = outcap
            long_run = np.unique(gid, return_counts=True)[1].max() > 1 << 16
            lo, hi = (-1, 2) if long_run else (-128, 129)
            planes = rng.integers(lo, hi, (P, n)).astype(np.float32)
            cases.append((f"{name}, n={n}, P={P}", gid, planes, outcap))
    return cases


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    # decided inside the test: collection must not depend on the machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    v = torch.from_numpy(_values(1 << 20)).to(dev)
    assert torch.equal(MK.murmur3_int32(v, 42), MK.murmur3_int32_plain(v, 42))
    gid, pay = _segsum_inputs(16, n=1 << 16, outcap=2048)
    g = torch.from_numpy(gid).to(dev)
    p = torch.from_numpy(pay.T.copy()).to(dev).to(torch.bfloat16)
    assert torch.equal(S.segsum(g, p, 2048), S.segsum_plain(g, p, 2048))
    bad = []
    for label, gid, planes, outcap in _segsum_edge_cases():
        g = torch.from_numpy(gid).to(dev)
        p = torch.from_numpy(planes).to(dev).to(torch.bfloat16)
        if not torch.equal(S.segsum(g, p, outcap),
                           S.segsum_plain(g, p, outcap)):
            bad.append(label)
    assert not bad, bad
    # the kernel takes no ragged length and no base off a 16-byte boundary
    with pytest.raises(ValueError):
        S.segsum(g[:-3], p[:, :-3], 2048)
    with pytest.raises(ValueError):
        S.segsum(g[3:-5], p[:, 3:-5], 2048)
