"""Plan digests (counterpart of ``plan_digest`` and ``_digest_describe``
in ``spark_rapids_tpu/runtime/obs/history.py``): a stable 16-hex digest
of a logical plan tree, with run state normalized out. The broadcast
build cache (``exec/adaptive.py``) keys on it; the query history store
is not ported yet.
"""
from __future__ import annotations

import hashlib
import json


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
