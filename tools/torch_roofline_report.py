"""Offline roofline report over the PyTorch port's query history store.

The port's ``tools/roofline_report.py``: it aggregates the per-query
roofline the port's kernel cost auditor
(``spark_rapids_tpu_torch/analysis/kernel_audit.py``,
spark.rapids.obs.audit.enabled) wrote into history records: where the
attributed seconds go against the configured bandwidth and compute
peaks (an H100 SXM's by default), which queries are memory-, compute- or
dispatch-overhead-bound, and how much of the moved bytes the
shape-bucket ladder exposes as padding, per query, ranked.

    python tools/torch_roofline_report.py --history <dir> [--json] [--top N]

Reads `query_history.jsonl` (runtime/obs/history.py); only records
carrying a `roofline` doc (audited queries) contribute. Records that
also carry an `aqe` doc (exec/adaptive.py decisions) get an "adaptive"
column — decision kinds × counts and the dispatches those decisions
saved — so a verdict flip (dispatch_overhead -> memory) can be read
next to the replan that caused it.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def load_records(history_dir: str):
    path = os.path.join(history_dir, "query_history.jsonl")
    if not os.path.exists(path):
        raise SystemExit(f"no history at {path}")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("type") == "query" and rec.get("roofline"):
                out.append(rec)
    return out


def summarize(records):
    rows = []
    for rec in records:
        roof = rec["roofline"]
        tot = roof.get("total") or {}
        groups = roof.get("groups") or {}
        kernels = roof.get("kernels") or {}
        top_kernel = None
        if kernels:
            top_kernel = max(kernels.items(),
                             key=lambda kv: kv[1].get("bytes_accessed",
                                                      0))[0]
        bounds = sorted({g.get("bound") for g in groups.values()
                         if g.get("bound")})
        waste = max([g.get("padding_waste_ratio") or 0.0
                     for g in groups.values()] or [0.0])
        aqe = rec.get("aqe") or {}
        counts = aqe.get("counts") or {}
        adaptive = ",".join(f"{k}x{n}" for k, n in sorted(counts.items()))
        saved = aqe.get("dispatches_saved", 0)
        if adaptive and saved:
            adaptive += f"(-{saved}d)"
        rows.append({
            "query_id": rec.get("query_id"),
            "digest": rec.get("plan_digest"),
            "status": rec.get("status"),
            "wall_s": round(rec.get("duration_ns", 0) / 1e9, 3),
            "device_s": tot.get("seconds", 0.0),
            "gb_moved": round(tot.get("bytes_accessed", 0) / 1e9, 4),
            "achieved_gbps": tot.get("achieved_gbps", 0.0),
            "roofline_pct": tot.get("roofline_pct_bw", 0.0),
            "bound": "+".join(bounds) or "?",
            "padding_waste_max": round(waste, 3),
            "adaptive": adaptive or "-",
            "dispatches_saved": saved,
            "top_kernel": top_kernel,
        })
    rows.sort(key=lambda r: r["roofline_pct"])
    return rows


def render(rows, top: int) -> str:
    lines = [f"roofline report — {len(rows)} audited queries "
             f"(lowest roofline share first)",
             f"{'query':>6} {'wall s':>8} {'dev s':>8} {'GB':>8} "
             f"{'GB/s':>8} {'%roof':>7} {'waste<=':>8} "
             f"{'bound':<18} {'adaptive':<28} top kernel"]
    for r in rows[:top]:
        lines.append(
            f"{str(r['query_id']):>6} {r['wall_s']:>8.3f} "
            f"{r['device_s']:>8.3f} {r['gb_moved']:>8.3f} "
            f"{r['achieved_gbps']:>8.2f} {r['roofline_pct']:>7.3f} "
            f"{r['padding_waste_max'] * 100:>7.0f}% "
            f"{r['bound']:<18} {r['adaptive']:<28} {r['top_kernel']}")
    if rows:
        import math
        pcts = [r["roofline_pct"] for r in rows if r["roofline_pct"] > 0]
        if pcts:
            geo = math.exp(sum(math.log(p) for p in pcts) / len(pcts))
            lines.append(f"geomean roofline share: {geo:.4f}% over "
                         f"{len(pcts)} queries with device time")
    return "\n".join(lines)


def main() -> int:
    args = sys.argv[1:]
    hist = None
    as_json = "--json" in args
    top = 50
    if "--history" in args:
        hist = args[args.index("--history") + 1]
    if "--top" in args:
        top = int(args[args.index("--top") + 1])
    if not hist:
        raise SystemExit("usage: torch_roofline_report.py --history <dir> "
                         "[--json] [--top N]")
    rows = summarize(load_records(hist))
    if as_json:
        print(json.dumps(rows, indent=1))
    else:
        print(render(rows, top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
