"""Persistent query history: one JSON record per query, digest-matched
(counterpart of ``spark_rapids_tpu/runtime/obs/history.py``).

Every top-level action appends one JSONL record under
``spark.rapids.obs.historyDir``: plan digest, physical plan text,
per-exec metric rollups, the annotated plan, fallback reasons, config
delta, wall time and its attribution (``obs/attribution.py``), the
adaptive decisions, status (ok/failed + exception class), any SLO breach
and flight-recorder dump path, and the trace artifact paths when tracing
was on. ``tools/history_server.py`` renders the store as static HTML
(query list -> annotated plan -> run-over-run diff of the same plan
digest), ``tools/profiler_report.py --history`` cross-links a trace file
to its record through the shared digest, the SLO detector seeds its
baselines from it and the measured cost pass (``plan/cost.py``) reads its
roofline verdicts.

The record has the JAX package's keys on its default path, and its
``roofline`` when the kernel cost audit was on
(``analysis/kernel_audit.py``). It carries no ``mesh`` (one card per
session) and no ``trace_id`` (no serving layer); ``fusion_groups``
lists the plan's fused stages and absorbed chains
(``exec/stage_fusion.fusion_groups``).

The digest is a canonical hash of the LOGICAL plan tree (node type +
describe + children), so two runs of the same query land on the same
digest and become a diffable pair; the two packages agree on it for the
same program. State-dependent describes (CachedRelation's hot/cold) are
normalized out. The broadcast build cache (``exec/adaptive.py``) keys on
it too.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

HISTORY_FILE = "query_history.jsonl"


def _digest_describe(node) -> str:
    """describe() with run state normalized out, so the digest is stable
    across runs of the same query."""
    from spark_rapids_tpu_torch.plan import nodes as P
    if isinstance(node, P.CachedRelation):
        return "CachedRelation"  # hot/cold flips between runs
    return node.describe()


def plan_digest(plan) -> str:
    """Stable 16-hex digest of a logical plan tree."""

    def walk(n) -> dict:
        return {"t": type(n).__name__, "d": _digest_describe(n),
                "c": [walk(c) for c in n.children]}

    blob = json.dumps(walk(plan), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def conf_delta(conf) -> Dict[str, object]:
    """Config values differing from their registered defaults (the knobs
    that shaped this run), testing knobs left out."""
    from spark_rapids_tpu_torch import config as C
    out: Dict[str, object] = {}
    for key, entry in C.registry().items():
        if entry.internal:
            continue
        v = conf.get(key)
        if v != entry.default:
            out[key] = v
    return out


class QueryHistoryStore:
    """Append-only JSONL store, one line per record. An append is one
    O_APPEND write() (looped on a short write): the kernel serializes the
    offset, so sessions in this process or another interleave whole lines,
    and no lock is held across the file I/O."""

    def __init__(self, history_dir: str):
        self.dir = history_dir
        os.makedirs(history_dir, exist_ok=True)
        self.path = os.path.join(history_dir, HISTORY_FILE)

    def append(self, record: dict) -> None:
        data = (json.dumps(record, default=str) + "\n").encode()
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            while data:
                data = data[os.write(fd, data):]
        finally:
            os.close(fd)

    def read_all(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # a torn tail line must not kill the reader
        return out

    def by_digest(self, digest: str) -> List[dict]:
        return [r for r in self.read_all()
                if r.get("plan_digest") == digest]

    def latest(self, n: int = 50) -> List[dict]:
        return self.read_all()[-n:]


def build_query_record(*, query_id: int, wall_start_unix: float,
                       duration_ns: int, status: str,
                       error: Optional[BaseException],
                       plan, session,
                       trace_paths: Optional[dict],
                       snaps: Optional[dict] = None,
                       degraded_reason: Optional[str] = None,
                       attribution: Optional[dict] = None,
                       roofline: Optional[dict] = None,
                       aqe: Optional[dict] = None,
                       slo_breach: Optional[dict] = None,
                       flight_dump: Optional[str] = None,
                       digest: Optional[str] = None,
                       replica_id: Optional[str] = None) -> dict:
    """Assemble one history record from a finished action's state. Every
    sub-extraction is best-effort: history never fails a query. ``snaps``
    is the caller's ``last_metrics()`` snapshot; the rollups and the
    annotated plan both read it, so the record resolves the lazy device
    row counts once. ``status`` may be ``degraded`` (the CPU backend
    answered after a device failure): ``error_class`` then names the
    error and ``degraded_reason`` the policy that fired."""
    rec: Dict[str, object] = {
        "type": "query",
        "query_id": query_id,
        "wall_start_unix": wall_start_unix,
        "duration_ns": int(duration_ns),
        "status": status,
    }
    if replica_id is not None:
        rec["replica_id"] = replica_id
    if degraded_reason is not None:
        rec["degraded_reason"] = degraded_reason
    if attribution is not None:
        rec["attribution"] = attribution
    if roofline is not None:
        # the kernel cost audit's roofline (analysis/kernel_audit.py):
        # the measured cost pass reads its verdicts, and
        # tools/torch_roofline_report.py aggregates them over the store
        rec["roofline"] = roofline
    if aqe is not None:
        rec["aqe"] = aqe
    if slo_breach is not None:
        rec["slo_breach"] = slo_breach
    if flight_dump is not None:
        rec["flight_dump"] = flight_dump
    if error is not None:
        rec["error_class"] = type(error).__name__
        rec["error"] = str(error)[:500]
    if digest is not None:
        rec["plan_digest"] = digest
    else:
        try:
            rec["plan_digest"] = plan_digest(plan)
        except Exception:  # noqa: BLE001
            rec["plan_digest"] = None
    sql = getattr(plan, "_sql_text", None)
    if isinstance(sql, str) and sql:
        rec["sql"] = sql
    exec_root = getattr(session, "last_exec", None)
    try:
        if exec_root is not None:
            rec["physical_plan"] = exec_root.tree_string()
    except Exception:  # noqa: BLE001
        pass
    try:
        from spark_rapids_tpu_torch.runtime.metrics import exec_rollup
        if snaps is None:
            snaps = session.last_metrics()
        rec["execs"] = {k: dict(v, **{"_rollup": exec_rollup(v)})
                        for k, v in snaps.items()}
    except Exception:  # noqa: BLE001
        rec["execs"] = {}
    try:
        rec["annotated_plan"] = session.explain_analyze(snaps=snaps)
    except Exception:  # noqa: BLE001
        pass
    try:
        from spark_rapids_tpu_torch.exec.stage_fusion import fusion_groups
        rec["fusion_groups"] = (fusion_groups(exec_root)
                                if exec_root is not None else [])
    except Exception:  # noqa: BLE001
        rec["fusion_groups"] = []
    try:
        rec["fallback_reasons"] = _meta_reasons(
            getattr(session, "last_meta", None))
    except Exception:  # noqa: BLE001
        rec["fallback_reasons"] = []
    try:
        rec["conf_delta"] = conf_delta(session.conf)
    except Exception:  # noqa: BLE001
        rec["conf_delta"] = {}
    if trace_paths:
        rec["trace_paths"] = dict(trace_paths)
    return rec


def _meta_reasons(meta) -> List[str]:
    """The tagging tree's fallback reasons (why anything ran on the CPU),
    deduplicated in tree order."""
    if meta is None:
        return []
    out: List[str] = []
    seen = set()

    def walk(m):
        for r in getattr(m, "reasons", ()):
            if r not in seen:
                seen.add(r)
                out.append(r)
        for c in getattr(m, "children", ()):
            walk(c)

    walk(meta)
    return out
