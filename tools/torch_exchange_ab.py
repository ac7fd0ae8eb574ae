"""Warm times of the port's small multi-partition exchange queries on a
CUDA card, for comparing two checkouts of the port on one machine.

    python3 tools/torch_exchange_ab.py [--root DIR] [--rows N] [--reps R]
        [--queries a,b] [--conf key=value ...] [--serial-waves] [--profile]

``DIR`` is the root of a checkout (default: this one): its
``spark_rapids_tpu_torch`` and ``tests/torch_port_helpers.py`` are the
ones imported, so an older checkout unpacked with ``git archive`` runs
the same queries through its own code. The queries are chip_smoke.py's
union_repart, pctl_shuffled, q3join_shuffled and repart_agg over the
joins phase's caches (lineitem and orders in 8 partitions, lineitem in
one), built the same way at ``N`` lineitem rows (30M by default);
``--queries`` runs a subset, and each ``--conf`` is set in both sessions.
``--serial-waves`` runs each task wave's tasks one after another on the
calling thread (``runtime/host_pool.run_task_wave``), to measure what the
wave's threads cost. ``--profile`` adds one traced warm collect a query
under ``torch.profiler``: its wall ms, the summed device ms of its
kernels, the device's idle share and the largest kernels.

Prints the card's name and power limit, then one JSON line per query:
the root, the confs, the median, least and most wall ms of ``R`` collects after one
warm-up, and the answer's row count. To compare two checkouts, run them
in turns in one machine session (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--rows", type=int, default=30_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--queries", default="")
    ap.add_argument("--conf", action="append", default=[])
    ap.add_argument("--serial-waves", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import torch_port_helpers as H
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr import core as E
    from spark_rapids_tpu_torch.expr.window import Window
    from spark_rapids_tpu_torch.sql import functions as F

    if args.serial_waves:
        from spark_rapids_tpu_torch.runtime import host_pool
        host_pool.run_task_wave = \
            lambda fn, items, max_concurrency=16: [fn(i) for i in items]
    print(_card(), flush=True)
    api = SimpleNamespace(col=E.col, lit=E.lit, F=F, E=E, T=T, Window=Window)
    base = {"spark.rapids.sql.test.enabled": "true",
            **dict(kv.split("=", 1) for kv in args.conf)}
    table, orders = H.make_tables(args.rows)
    s1 = TorchSession(dict(base))
    # both thresholds 0, as in chip_smoke.py: the join stays shuffled
    s8 = TorchSession({**base,
                       "spark.rapids.sql.join.broadcastRowThreshold": 0,
                       "spark.rapids.sql.adaptive.broadcastThresholdBytes":
                       0})
    li1 = s1.create_dataframe(table).cache()
    li8 = s8.create_dataframe(table, num_partitions=8).cache()
    od8 = s8.create_dataframe(orders, num_partitions=8).cache()
    for df in (li1, li8, od8):
        df.count()
    queries = {
        "union_repart": lambda: H.union_repart(api, li8, li1),
        "pctl_shuffled": lambda: H.pctl_shuffled(api, li8),
        "q3join_shuffled": lambda: H.q3join(api, li8, od8),
        "repart_agg": lambda: H.repart_agg(api, li8),
    }
    chosen = args.queries.split(",") if args.queries else list(queries)
    for name in chosen:
        make = queries[name]
        rows = make().collect().num_rows
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make().collect()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"root": root, "conf": args.conf,
                          "serial_waves": args.serial_waves, "query": name,
                          "median_ms": statistics.median(times),
                          "min_ms": min(times), "max_ms": max(times),
                          "rows": rows}), flush=True)
        if args.profile:
            print(json.dumps({"root": root, "query": name,
                              **_traced(torch, make)}), flush=True)
    return 0


def _traced(torch, make) -> dict:
    """One traced warm collect (after a traced warm-up that is dropped):
    wall ms, device ms summed over kernels, idle share, top kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.key_averages())
                 ) as prof:
        make().collect()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        make().collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.key,
                    e.count) for e in events
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and not e.key.startswith("ProfilerStep")), reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"traced_wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "top": [{"kernel": k[:60], "ms": d, "calls": c}
                    for d, k, c in rows[:6]]}


if __name__ == "__main__":
    sys.exit(main())
