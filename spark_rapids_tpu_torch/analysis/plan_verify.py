"""Plan-invariant verifier: structural checks over a CONVERTED exec tree
(counterpart of ``spark_rapids_tpu/analysis/plan_verify.py``).

``convert_plan`` ends with tree rewrites whose legality rules were
hand-checked when each was written. This module re-derives them from the
tree itself:

- **schema consistency** (PV-SCHEMA): every node exposes a well-formed
  ``types.Schema``; pass-through nodes (Filter/Limit/Sort/TopN/Coalesce/
  Pipeline and the exchanges) must preserve their child's column names
  and types exactly: a wrapper that changes the schema is corrupting
  data, not routing it.
- **pipeline legality** (PV-PIPE): a ``PipelineExec`` wraps exactly one
  scan, never the root, with depth >= 1: the placement rule of
  ``insert_pipelines``.
- **tree shape** (PV-TREE): children are a list, and no node is its own
  ancestor.

The JAX package's fusion rules (PV-FUSE, PV-ABSORB) and its dispatch
budgets (``dispatch_budget``, ``compare_budget``) check fused stages,
which this engine does not build; they wait for the decision on stage
fusion (ROADMAP A11e).

``spark.rapids.debug.planVerify.enabled`` makes ``convert_plan`` verify
every tree it returns. Duck-typed by class NAME, like
``metrics.walk_exec_tree``: no exec imports.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["PlanVerifyError", "check_plan", "verify_plan"]


class PlanVerifyError(AssertionError):
    """A converted exec tree violates an engine invariant. Raised before
    execution starts: a malformed plan must never reach the device."""

    def __init__(self, violations: List[str]):
        self.violations = violations
        super().__init__(
            "plan verification failed (%d violation%s):\n  " % (
                len(violations), "s" if len(violations) != 1 else "")
            + "\n  ".join(violations))


#: wrappers that must hand their child's schema through unchanged
_SCHEMA_PRESERVING = {
    "FilterExec", "LimitExec", "SortExec", "TopNExec",
    "CoalesceBatchesExec", "PipelineExec", "ShuffleExchangeExec",
    "RoundRobinExchangeExec", "RangeExchangeExec", "CollectExchangeExec",
}

#: the only nodes insert_pipelines may wrap (its scan_types tuple)
_PIPELINE_WRAPPABLE = {
    "ParquetScanExec", "EncodedParquetSourceExec", "TextScanExec",
    "InMemoryScanExec", "ShuffleFileScanExec",
}


def _cls(node) -> str:
    # PipelineExec.name() renders as "PipelineExec(depth=N)"; the class
    # name is the stable identity
    return type(node).__name__


def _schema_sig(schema) -> Optional[list]:
    try:
        return [(f.name, f.dtype) for f in schema.fields]
    except Exception:  # noqa: BLE001 - malformed schema reported by caller
        return None


def _check_schema(node, path: str, out: List[str]) -> None:
    sig = _schema_sig(node.schema)
    if sig is None:
        out.append(f"PV-SCHEMA {path}: schema is not a well-formed "
                   f"types.Schema (fields of name+dtype)")
        return
    for name, dtype in sig:
        if not isinstance(name, str) or dtype is None:
            out.append(f"PV-SCHEMA {path}: malformed field "
                       f"{name!r}:{dtype!r}")
    if _cls(node) in _SCHEMA_PRESERVING and node.children:
        child_sig = _schema_sig(node.children[0].schema)
        if child_sig is not None and child_sig != sig:
            out.append(
                f"PV-SCHEMA {path}: {_cls(node)} must preserve its "
                f"child's schema but maps {child_sig} -> {sig}")


def _check_pipeline(node, path: str, is_root: bool, out: List[str]) -> None:
    if is_root:
        out.append(f"PV-PIPE {path}: PipelineExec at the root — the "
                   f"consumer side of the boundary would be the session's "
                   f"collect loop itself (insert_pipelines only wraps "
                   f"non-root scans)")
    if len(node.children) != 1:
        out.append(f"PV-PIPE {path}: pipeline boundary must wrap exactly "
                   f"one child, has {len(node.children)}")
        return
    child = node.children[0]
    if _cls(child) not in _PIPELINE_WRAPPABLE:
        out.append(f"PV-PIPE {path}: pipeline wraps {_cls(child)} — only "
                   f"host-producing scans are legal boundaries "
                   f"({sorted(_PIPELINE_WRAPPABLE)})")
    if not isinstance(node.depth, int) or node.depth < 1:
        out.append(f"PV-PIPE {path}: lookahead depth must be >= 1, got "
                   f"{node.depth!r} (depth<=0 plans must stay unwrapped)")


def check_plan(exec_root) -> List[str]:
    """All violations in a converted exec tree (empty list = clean).
    Linear in tree size; no device work."""
    out: List[str] = []
    on_stack: set = set()

    def walk(node, path: str, is_root: bool) -> None:
        if id(node) in on_stack:
            out.append(f"PV-TREE {path}: cycle — node {_cls(node)} is "
                       f"its own ancestor")
            return
        on_stack.add(id(node))
        try:
            _check_schema(node, path, out)
            if _cls(node) == "PipelineExec":
                _check_pipeline(node, path, is_root, out)
            if not isinstance(node.children, list):
                out.append(f"PV-TREE {path}: children must be a list")
                return
            for i, c in enumerate(node.children):
                walk(c, f"{path}/{_cls(c)}[{i}]", False)
        finally:
            on_stack.discard(id(node))

    walk(exec_root, _cls(exec_root), True)
    return out


def verify_plan(exec_root) -> None:
    """Raise :class:`PlanVerifyError` listing every violation (or return
    silently). Called by ``convert_plan`` under
    ``spark.rapids.debug.planVerify.enabled``."""
    violations = check_plan(exec_root)
    if violations:
        raise PlanVerifyError(violations)
