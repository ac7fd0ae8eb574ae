"""Chip smoke test of the PyTorch/CUDA engine (spark_rapids_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each:

1. build: nvcc builds every kernel of csrc/ for sm_90a, in parallel, into
   build/torch_kernels/ (listed in .gitignore); prints the build seconds
   and each kernel's register use.
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (murmur3 on int32[2^25] with edge values; segsum
   on the q72shfl chunk: N = 2^23 sorted ids over ~100,000 groups, 10 bf16
   lane planes, outcap = 2^18, some dead rows at id outcap). Equality must
   be exact. Times are medians of CUDA-event timed launches.
3. path: bench.py's lineitem (30M rows, seed 42, ~TPC-H SF5) cached on the
   card with TorchSession, then four queries (q6, q1, q72shfl, and
   repartition(8, l_shipdate) + group-by), each checked against pyarrow
   on the host with bench.py's tolerances; q72shfl's 100,000 groups are
   also checked one by one. The kernels' launch counts are set to 0 before
   the path and read after; every kernel must have run, and q72shfl must
   have taken the chunked segsum route.

It then prints the kernel table ({"kernels": [...]}), the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Any
failure exits non-zero without that line; so does a machine without CUDA.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROWS = 30_000_000
LO, HI = 8766, 9131
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_NAMES = ("murmur3", "segsum")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from spark_rapids_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all(list(KERNEL_NAMES))
    secs = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "built": sorted(logs),
          "ptxas": regs})


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels():
    import torch
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []

    # B1 murmur3 on the cached batch's capacity (2^25 rows)
    n = 1 << 25
    x_np = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    x_np[:4] = [-2 ** 31, -1, 0, 2 ** 31 - 1]
    x = torch.from_numpy(x_np).to(dev)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n,
                                          dtype=np.int64).astype(np.int32)
                             ).to(dev)
    got = MK.murmur3_int32(x, 42)
    want = MK.murmur3_int32_plain(x, 42)
    got_r = MK.murmur3_int32(x, seeds)
    want_r = MK.murmur3_int32_plain(x, seeds)
    # murmur3 takes any length and offset: the kernel masks the tail
    r_n = n - 5
    got_v = MK.murmur3_int32(x[3:r_n], seeds[3:r_n])
    want_v = MK.murmur3_int32_plain(x[3:r_n], seeds[3:r_n])
    torch.cuda.synchronize()

    def max_diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    err = max(max_diff(got, want), max_diff(got_r, want_r),
              max_diff(got_v, want_v))
    if err:
        raise AssertionError(f"murmur3 kernel differs from its plain "
                             f"version (max abs err {err})")
    ms = time_ms(lambda: MK.murmur3_int32(x, 42))
    plain_ms = time_ms(lambda: MK.murmur3_int32_plain(x, 42), reps=5)
    nbytes = n * 4 + n * 4
    rows.append({"name": "murmur3_int32", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
                 "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:97",
                 "shape": f"int32[{n}], scalar seed",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": None})

    # B2 segsum at the q72shfl chunk shape: 1 live count + 3 key digits
    # (18-bit key) + 6 float digits
    N, P, outcap, ngroups, dead = 1 << 23, 10, 1 << 18, 100_000, 4096
    gid_np = np.sort(rng.integers(0, ngroups, N - dead)).astype(np.int32)
    gid_np = np.concatenate([gid_np, np.full(dead, outcap, np.int32)])
    lanes = np.zeros((P, N), np.float32)
    lanes[0, :N - dead] = 1.0                                   # live count
    lanes[1:4] = rng.integers(0, 256, (3, N))                   # key digits
    lanes[4:10] = rng.integers(-128, 129, (6, N))               # float digits
    gid = torch.from_numpy(gid_np).to(dev)
    pay = torch.from_numpy(lanes).to(dev).to(torch.bfloat16)
    got = S.segsum(gid, pay, outcap)
    want = S.segsum_plain(gid, pay, outcap)
    torch.cuda.synchronize()
    seg_err = float((got - want).abs().max())
    if seg_err != 0.0:
        raise AssertionError(f"segsum kernel differs from its plain version "
                             f"(max abs err {seg_err})")
    live = N - dead
    g64 = gid[:live].to(torch.int64)
    p32 = pay[:, :live].t().to(torch.float32).contiguous()
    ms = time_ms(lambda: S.segsum(gid, pay, outcap))
    plain_ms = time_ms(lambda: S.segsum_plain(gid, pay, outcap), reps=10)
    lib_ms = time_ms(lambda: torch.zeros(outcap, P, device=dev).index_add_(
        0, g64, p32), reps=10)
    nbytes = N * 4 + N * P * 2 + outcap * P * 4
    rows.append({"name": "segsum", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/csrc/segsum.cu",
                 "replaces": "spark_rapids_tpu/ops/pallas_segsum.py:90",
                 "shape": f"gid int32[{N}], payload bf16[{P},{N}], "
                          f"outcap {outcap}",
                 "max_abs_err": seg_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": lib_ms})
    emit({"phase": "kernels", "results": rows})
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_lineitem(rows: int):
    """bench.py make_tables' lineitem, same generator and seed."""
    import pyarrow as pa
    orders = max(rows // 10, 1000)
    rng = np.random.default_rng(42)
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


def _close(a, b, tol=1e-6):
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def host_reference(t):
    """bench.py's pyarrow baseline for the four queries."""
    import pyarrow as pa
    import pyarrow.compute as pc
    m = pc.and_(pc.and_(pc.and_(pc.greater_equal(t["l_shipdate"], LO),
                                pc.less(t["l_shipdate"], HI)),
                        pc.and_(pc.greater_equal(t["l_discount"], 0.05),
                                pc.less_equal(t["l_discount"], 0.07))),
                pc.less(t["l_quantity"], 24.0))
    f = t.filter(m)
    q6 = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"])).as_py()
    f = t.filter(pc.less_equal(t["l_shipdate"], 10471))
    g = f.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("l_quantity", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count")])
    q1 = {(rf, ls): (sq, sp, mq, md, c) for rf, ls, sq, sp, mq, md, c in zip(
        *[g[n].to_pylist() for n in (
            "l_returnflag", "l_linestatus", "l_quantity_sum",
            "l_extendedprice_sum", "l_quantity_mean", "l_discount_mean",
            "l_quantity_count")])}
    key = pa.chunked_array([np.mod(c.to_numpy(), 100_000)
                            for c in t["l_orderkey"].chunks])
    g = t.select(["l_quantity"]).append_column("k", key).group_by(
        ["k"]).aggregate([("l_quantity", "sum"), ("l_quantity", "count")])
    q72 = (g.num_rows, round(pc.sum(g["l_quantity_sum"]).as_py(), 2),
           int(pc.sum(g["l_quantity_count"]).as_py()))
    q72_groups = {k: (s, c) for k, s, c in zip(
        g["k"].to_pylist(), g["l_quantity_sum"].to_pylist(),
        g["l_quantity_count"].to_pylist())}
    g = t.group_by(["l_shipdate"]).aggregate([("l_quantity", "sum"),
                                              ("l_quantity", "count")])
    rep = {d: (s, c) for d, s, c in zip(g["l_shipdate"].to_pylist(),
                                        g["l_quantity_sum"].to_pylist(),
                                        g["l_quantity_count"].to_pylist())}
    return {"q6": q6, "q1": q1, "q72shfl": q72, "repart_agg": rep,
            "q72shfl_groups": q72_groups}


def port_queries(cached):
    from spark_rapids_tpu_torch.expr.core import col, lit
    from spark_rapids_tpu_torch.sql import functions as F

    def q6():
        cond = ((col("l_shipdate") >= lit(LO)) & (col("l_shipdate") < lit(HI))
                & (col("l_discount") >= lit(0.05))
                & (col("l_discount") <= lit(0.07))
                & (col("l_quantity") < lit(24.0)))
        out = cached.filter(cond).agg(
            F.sum(col("l_extendedprice") * col("l_discount")))
        return list(out.to_pydict().values())[0][0]

    def q1():
        d = (cached.filter(col("l_shipdate") <= lit(10471))
             .group_by("l_returnflag", "l_linestatus")
             .agg(F.sum(col("l_quantity")).alias("sq"),
                  F.sum(col("l_extendedprice")).alias("sp"),
                  F.avg(col("l_quantity")).alias("mq"),
                  F.avg(col("l_discount")).alias("md"),
                  F.count(col("l_quantity")).alias("cnt"))).to_pydict()
        return {(rf, ls): (sq, sp, mq, md, c) for rf, ls, sq, sp, mq, md, c in
                zip(d["l_returnflag"], d["l_linestatus"], d["sq"], d["sp"],
                    d["mq"], d["md"], d["cnt"])}

    def q72_grouped():
        return (cached.select((col("l_orderkey") % lit(100_000)).alias("k"),
                              col("l_quantity"))
                .group_by(col("k"))
                .agg(F.sum("l_quantity").alias("s"),
                     F.count("l_quantity").alias("c")))

    def q72shfl():
        # bench.py's shape: the grouped result is reduced on the device
        d = q72_grouped().agg(F.count(col("k")).alias("n"),
                              F.sum(col("s")).alias("ts"),
                              F.sum(col("c")).alias("tc")).to_pydict()
        return (int(d["n"][0]), round(float(d["ts"][0]), 2), int(d["tc"][0]))

    def q72shfl_groups():
        d = q72_grouped().to_pydict()
        return {k: (s, c) for k, s, c in zip(d["k"], d["s"], d["c"])}

    def repart_agg():
        d = (cached.select(col("l_shipdate"), col("l_quantity"))
             .repartition(8, col("l_shipdate"))
             .group_by(col("l_shipdate"))
             .agg(F.sum("l_quantity").alias("s"),
                  F.count("l_quantity").alias("c"))).to_pydict()
        return {k: (s, c) for k, s, c in zip(d["l_shipdate"], d["s"], d["c"])}

    return {"q6": q6, "q1": q1, "q72shfl": q72shfl, "repart_agg": repart_agg,
            "q72shfl_groups": q72shfl_groups}


def validate(name, got, want) -> bool:
    if name == "q6":
        return _close(got, want)
    if name == "q1":
        return set(got) == set(want) and all(
            all(_close(a, b) for a, b in zip(got[k][:4], want[k][:4]))
            and int(got[k][4]) == int(want[k][4]) for k in want)
    if name == "q72shfl":
        return got[0] == want[0] and _close(got[1], want[1]) \
            and got[2] == want[2]
    # repart_agg and q72shfl_groups: every group's sum and count
    return set(got) == set(want) and all(
        _close(got[k][0], want[k][0]) and got[k][1] == want[k][1]
        for k in want)


class RouteSpy:
    """Counts entries into the aggregate's routes while the path runs."""

    METHODS = ("_global_update", "_bucket_update", "_segsum_or_fallback",
               "_chunked_segsum_agg", "_scatter_agg")

    def __init__(self):
        from spark_rapids_tpu_torch.exec import nodes as X
        self.cls = X._AggKernels
        self.counts = {m: 0 for m in self.METHODS}
        self.orig = {m: getattr(self.cls, m) for m in self.METHODS}
        for m in self.METHODS:
            setattr(self.cls, m, self._wrap(m))

    def _wrap(self, m):
        orig = self.orig[m]

        def spy(kern, *a, **k):
            self.counts[m] += 1
            return orig(kern, *a, **k)
        return spy

    def take(self):
        out, self.counts = self.counts, {m: 0 for m in self.METHODS}
        return {k: v for k, v in out.items() if v}


def phase_path(rows: int):
    import torch
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.ops import murmur3_kernel as MK
    from spark_rapids_tpu_torch.ops import segsum as S
    t0 = time.perf_counter()
    table = make_lineitem(rows)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = host_reference(table)
    host_s = time.perf_counter() - t0
    emit({"phase": "path.setup", "rows": rows, "generate_s": gen_s,
          "host_reference_s": host_s})

    spy = RouteSpy()
    MK.launches = 0
    S.launches = 0
    session = TorchSession()
    t0 = time.perf_counter()
    cached = session.create_dataframe(table).cache()
    n = cached.count()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    if n != rows:
        raise AssertionError(f"cached count {n} != {rows}")
    per_query = {}
    ok = True
    for name, fn in port_queries(cached).items():
        before = (MK.launches, S.launches)
        t0 = time.perf_counter()
        got = fn()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            warm.append(time.perf_counter() - t0)
        good = validate(name, got, want[name])
        ok &= good
        launches = {"murmur3_int32": (MK.launches - before[0]) // 3,
                    "segsum": (S.launches - before[1]) // 3}
        per_query[name] = {"correct": good, "cold_s": cold,
                           "warm_s": min(warm), "launches": launches,
                           "routes": {k: v // 3 for k, v in
                                      spy.take().items()}}
        emit({"phase": "path.query", "query": name, **per_query[name]})
    counts = {"murmur3_int32": MK.launches, "segsum": S.launches}
    emit({"phase": "path", "cache_s": cache_s, "launches": counts,
          "correct": ok})
    if os.environ.get("CHIP_SMOKE_PROFILE") == "1":
        profile_queries(port_queries(cached))
    if not ok:
        raise AssertionError("a path query disagrees with pyarrow")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the path: {counts}")
    if not per_query["q72shfl"]["routes"].get("_chunked_segsum_agg"):
        raise AssertionError("q72shfl did not reach the chunked segsum route")
    return counts


def profile_queries(queries) -> None:
    """One warm run of each query under torch.profiler: the device time
    summed over CUDA kernels beside the host wall time, and the kernels
    taking the most device time (set CHIP_SMOKE_PROFILE=1; set
    CHIP_SMOKE_TRACE_DIR to also write each query's Chrome trace there)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.environ.get("CHIP_SMOKE_TRACE_DIR")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for name, fn in queries.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if out_dir:
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  f"trace_{name}.json"))
        rows = []
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue  # host-side ops would count their kernels twice
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) / 1e3
            if dev > 0:
                rows.append((dev, e.key, e.count))
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows)
        emit({"phase": "path.profile", "query": name, "wall_ms": wall_ms,
              "device_ms": device_ms,
              "device_idle_share": (max(0.0, 1 - device_ms / wall_ms)
                                    if device_ms else None),
              "top": [{"kernel": k[:80], "ms": d, "calls": c}
                      for d, k, c in rows[:8]]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card = nvidia_smi()
    print(card, flush=True)
    t_all = time.perf_counter()
    phases = {}
    t0 = time.perf_counter()
    phase_build()
    phases["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phase_kernels()
    phases["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = phase_path(ROWS)
    phases["path_s"] = time.perf_counter() - t0
    for r in rows:
        r["launches"] = counts["murmur3_int32" if r["name"] == "murmur3_int32"
                               else "segsum"]
    phases["total_s"] = time.perf_counter() - t_all
    emit({"phase": "done", **phases})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - any phase failure fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
