"""Multi-replica fleet view over a SHARED query history store of the
port (counterpart of ``tools/fleet_report.py``, reading
``spark_rapids_tpu_torch``'s records; it imports no JAX).

N serving replicas append to one ``spark.rapids.obs.historyDir`` (the
O_APPEND JSONL store interleaves whole lines across processes), and
every query and result-cache-hit record carries its ``replica_id``
(``spark.rapids.obs.replicaId``, default pid-<pid>) and the W3C
``trace_id`` of the serving request that carried it. This tool answers
the fleet operator's question the per-replica pages cannot: **for the
same plan digest, do the replicas agree?**

For every plan digest it splits the fleet's runs per replica: run count,
p50/p99 wall, compile seconds (the attribution bucket: in the port the
kernel-library builds; a replica building what the others load is the
warm-boot regression signature), SLO breaches, failure counts, and the
result-cache hit/execute split. It then flags digests whose slowest
replica's p99 exceeds the fastest's by more than the skew factor.

It also merges the replicas' exported per-request timelines
(``spark.rapids.obs.reqtrace.path`` dirs): every ``req_*.json`` artifact
is listed with its sampling verdict and joined back to the history
records sharing its trace id.

Run:  python tools/torch_fleet_report.py <historyDir>
          [--reqtrace DIR ...] [--skew 1.5] [--json]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spark_rapids_tpu_torch.runtime.obs.history import (  # noqa: E402
    QueryHistoryStore,
)

#: req_<seq>_<verdict>_<trace8>.json — the reqtrace export pair's
#: Chrome-trace half (runtime/obs/reqtrace.py names both halves)
_ARTIFACT_RE = re.compile(
    r"^req_(\d+)_([a-z_]+)_([0-9a-f]{8})\.json$")

#: replica key for records predating the replica_id stamp (or engines
#: run with obs history but no serving layer)
UNKNOWN_REPLICA = "(unknown)"


def _pctl(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def _compile_seconds(rec: dict) -> float:
    attr = rec.get("attribution") or {}
    buckets = attr.get("buckets") or {}
    try:
        return float(buckets.get("compile") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def scan_reqtrace(dirs) -> List[dict]:
    """List exported per-request timelines across the replicas' reqtrace
    dirs: [{dir, file, seq, verdict, trace8}], newest last."""
    out: List[dict] = []
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            m = _ARTIFACT_RE.match(name)
            if m is None:
                continue
            out.append({"dir": d, "file": os.path.join(d, name),
                        "seq": int(m.group(1)), "verdict": m.group(2),
                        "trace8": m.group(3)})
    return out


def fleet_summary(records: List[dict], reqtrace_dirs=(),
                  skew_factor: float = 1.5) -> dict:
    """The whole fleet doc: per-replica totals, the per-digest
    cross-replica split, skew flags, and the merged reqtrace artifact
    index joined to history trace ids."""
    queries = [r for r in records if r.get("type") == "query"]
    hits = [r for r in records if r.get("type") == "result_cache_hit"]

    def replica(rec) -> str:
        return rec.get("replica_id") or UNKNOWN_REPLICA

    def mesh_key(rec) -> str:
        """Compact mesh-shape label ("8 part" / "single"). Multichip
        records carry rec["mesh"] = {n_devices, axes}; records without
        it ran single-device."""
        m = rec.get("mesh")
        if not isinstance(m, dict):
            return "single"
        axes = m.get("axes") or []
        return f"{m.get('n_devices', '?')} {'x'.join(str(a) for a in axes)}"

    # ---- per-replica totals ------------------------------------------------
    totals: Dict[str, dict] = {}
    for r in queries:
        t = totals.setdefault(replica(r), {
            "queries": 0, "ok": 0, "failed": 0, "cancelled": 0,
            "degraded": 0, "slo_breaches": 0, "cache_hits": 0,
            "compile_s": 0.0, "_walls": [], "_meshes": set()})
        t["queries"] += 1
        t["_meshes"].add(mesh_key(r))
        st = r.get("status", "?")
        if st in t:
            t[st] += 1
        if r.get("slo_breach") is not None:
            t["slo_breaches"] += 1
        t["compile_s"] += _compile_seconds(r)
        t["_walls"].append(r.get("duration_ns", 0) / 1e6)
    for r in hits:
        t = totals.setdefault(replica(r), {
            "queries": 0, "ok": 0, "failed": 0, "cancelled": 0,
            "degraded": 0, "slo_breaches": 0, "cache_hits": 0,
            "compile_s": 0.0, "_walls": [], "_meshes": set()})
        t["cache_hits"] += 1
    for t in totals.values():
        walls = sorted(t.pop("_walls"))
        t["p50_ms"] = round(_pctl(walls, 0.50), 3)
        t["p99_ms"] = round(_pctl(walls, 0.99), 3)
        t["compile_s"] = round(t["compile_s"], 3)
        t["meshes"] = sorted(t.pop("_meshes")) or ["single"]

    # ---- per-digest x per-replica split ------------------------------------
    digests: Dict[str, Dict[str, dict]] = {}
    for r in queries:
        d = r.get("plan_digest")
        if not d:
            continue
        cell = digests.setdefault(d, {}).setdefault(replica(r), {
            "runs": 0, "failed": 0, "slo_breaches": 0, "cache_hits": 0,
            "compile_s": 0.0, "_walls": [], "trace_ids": [],
            "_meshes": set()})
        cell["runs"] += 1
        cell["_meshes"].add(mesh_key(r))
        if r.get("status") not in ("ok", "degraded"):
            cell["failed"] += 1
        if r.get("slo_breach") is not None:
            cell["slo_breaches"] += 1
        cell["compile_s"] += _compile_seconds(r)
        cell["_walls"].append(r.get("duration_ns", 0) / 1e6)
        if r.get("trace_id"):
            cell["trace_ids"].append(r["trace_id"])
    for r in hits:
        d = r.get("plan_digest")
        if not d:
            continue
        cell = digests.setdefault(d, {}).setdefault(replica(r), {
            "runs": 0, "failed": 0, "slo_breaches": 0, "cache_hits": 0,
            "compile_s": 0.0, "_walls": [], "trace_ids": [],
            "_meshes": set()})
        cell["cache_hits"] += 1
        if r.get("trace_id"):
            cell["trace_ids"].append(r["trace_id"])
    skewed: List[dict] = []
    for d, per in digests.items():
        # p99s grouped by mesh shape: a 1-device replica being slower
        # than an 8-device one on a shuffle-heavy digest is the
        # EXPECTED scaling, not a fleet anomaly — only replicas on the
        # same mesh are comparable (history records carry rec["mesh"])
        p99s_by_mesh: Dict[str, Dict[str, float]] = {}
        for rep, cell in per.items():
            walls = sorted(cell.pop("_walls"))
            cell["p50_ms"] = round(_pctl(walls, 0.50), 3)
            cell["p99_ms"] = round(_pctl(walls, 0.99), 3)
            cell["compile_s"] = round(cell["compile_s"], 3)
            cell["trace_ids"] = cell["trace_ids"][-5:]  # newest few
            cell["meshes"] = sorted(cell.pop("_meshes")) or ["single"]
            if cell["runs"]:
                for mk in cell["meshes"]:
                    p99s_by_mesh.setdefault(mk, {})[rep] = cell["p99_ms"]
        for mk, p99s in p99s_by_mesh.items():
            if len(p99s) < 2:
                continue
            lo_rep = min(p99s, key=p99s.get)
            hi_rep = max(p99s, key=p99s.get)
            lo, hi = p99s[lo_rep], p99s[hi_rep]
            if lo > 0 and hi > lo * skew_factor:
                skewed.append({"plan_digest": d, "mesh": mk,
                               "fast": lo_rep,
                               "slow": hi_rep, "fast_p99_ms": lo,
                               "slow_p99_ms": hi,
                               "ratio": round(hi / lo, 2)})
    skewed.sort(key=lambda s: -s["ratio"])

    # ---- reqtrace artifact merge + history join ----------------------------
    artifacts = scan_reqtrace(reqtrace_dirs)
    by_trace8: Dict[str, str] = {}
    for r in queries + hits:
        tid = r.get("trace_id")
        if tid:
            by_trace8[tid[:8]] = tid
    for a in artifacts:
        a["trace_id"] = by_trace8.get(a["trace8"])

    return {
        "replicas": sorted(totals),
        "totals": totals,
        "digests": digests,
        "skewed": skewed,
        "skew_factor": skew_factor,
        "reqtrace": artifacts,
    }


def render_text(doc: dict) -> str:
    lines = [f"fleet: {len(doc['replicas'])} replica(s): "
             + ", ".join(doc["replicas"]), ""]
    lines.append(f"{'replica':<24} {'queries':>8} {'hits':>6} "
                 f"{'failed':>7} {'slo':>4} {'p50 ms':>9} {'p99 ms':>9} "
                 f"{'compile s':>10}  {'mesh'}")
    for rep in doc["replicas"]:
        t = doc["totals"][rep]
        lines.append(f"{rep:<24} {t['queries']:>8} {t['cache_hits']:>6} "
                     f"{t['failed']:>7} {t['slo_breaches']:>4} "
                     f"{t['p50_ms']:>9.1f} {t['p99_ms']:>9.1f} "
                     f"{t['compile_s']:>10.3f}  "
                     f"{', '.join(t.get('meshes', ['single']))}")
    lines.append("")
    for d, per in sorted(doc["digests"].items()):
        lines.append(f"digest {d}:")
        for rep in sorted(per):
            c = per[rep]
            lines.append(
                f"  {rep:<22} runs={c['runs']:<4} hits={c['cache_hits']:<4}"
                f" failed={c['failed']:<3} slo={c['slo_breaches']:<3}"
                f" p50={c['p50_ms']:.1f}ms p99={c['p99_ms']:.1f}ms"
                f" compile={c['compile_s']:.3f}s"
                f" mesh={','.join(c.get('meshes', ['single']))}")
    if doc["skewed"]:
        lines.append("")
        lines.append(f"cross-replica skew (p99 ratio > "
                     f"{doc['skew_factor']}x, same mesh only):")
        for s in doc["skewed"]:
            lines.append(f"  {s['plan_digest']} [{s.get('mesh', 'single')}]:"
                         f" {s['slow']} "
                         f"{s['slow_p99_ms']:.1f}ms vs {s['fast']} "
                         f"{s['fast_p99_ms']:.1f}ms ({s['ratio']}x)")
    if doc["reqtrace"]:
        lines.append("")
        lines.append(f"per-request timelines ({len(doc['reqtrace'])}):")
        for a in doc["reqtrace"]:
            join = a["trace_id"] or f"{a['trace8']}… (no history record)"
            lines.append(f"  [{a['verdict']:<17}] {join}  {a['file']}")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("history_dir",
                    help="the replicas' SHARED spark.rapids.obs.historyDir")
    ap.add_argument("--reqtrace", action="append", default=[],
                    metavar="DIR",
                    help="a replica's spark.rapids.obs.reqtrace.path dir "
                    "(repeatable); defaults to <historyDir>/reqtrace "
                    "when present")
    ap.add_argument("--skew", type=float, default=1.5,
                    help="flag digests whose slowest replica p99 exceeds "
                    "the fastest by this factor (default 1.5)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full summary as JSON")
    args = ap.parse_args()
    records = QueryHistoryStore(args.history_dir).read_all()
    dirs = list(args.reqtrace)
    default_rt = os.path.join(args.history_dir, "reqtrace")
    if not dirs and os.path.isdir(default_rt):
        dirs = [default_rt]
    doc = fleet_summary(records, reqtrace_dirs=dirs,
                        skew_factor=args.skew)
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
    else:
        sys.stdout.write(render_text(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
