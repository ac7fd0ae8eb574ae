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
- **fusion-group legality** (PV-FUSE / PV-ABSORB): every
  ``FusedStageExec`` member is statically fusable, >= 2 members actually
  dispatch (the pass's own bar), the member chain is linked child-most
  first, and stage ids are unique; an absorbed pre-chain hangs off a
  partial or complete ``HashAggregateExec`` with carry-free bodies.
- **pipeline legality** (PV-PIPE): a ``PipelineExec`` wraps exactly one
  scan, never the root, with depth >= 1: the placement rule of
  ``insert_pipelines``.
- **tree shape** (PV-TREE): children are a list, and no node is its own
  ancestor.
- **dispatch budget** (:func:`dispatch_budget`): the static count of
  narrow dispatches per input batch the plan shape implies, with the
  fusion groups, pipeline boundaries and the operator census, as data;
  :func:`compare_budget` names each dimension that differs.

``spark.rapids.debug.planVerify.enabled`` makes ``convert_plan`` verify
every tree it returns. Duck-typed by class NAME, like
``metrics.walk_exec_tree``: the fusion rules import the fusion pass's own
gates (``exec/stage_fusion``) when a tree has fused stages.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["PlanVerifyError", "check_plan", "verify_plan",
           "dispatch_budget", "compare_budget"]


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


def _check_fused(node, path: str, seen_stage_ids: Dict[int, str],
                 out: List[str]) -> None:
    from spark_rapids_tpu_torch.exec import stage_fusion as SF
    members = node.members
    if not members:
        out.append(f"PV-FUSE {path}: FusedStageExec with no members")
        return
    if len(node.children) != 1:
        out.append(f"PV-FUSE {path}: fused stage must have exactly one "
                   f"child, has {len(node.children)}")
    for m in members:
        if not SF._fusable(m):
            out.append(f"PV-FUSE {path}: member {_cls(m)} is not a "
                       f"fusable narrow operator")
    n_disp = sum(1 for m in members if SF._dispatching(m))
    if n_disp < 2:
        out.append(f"PV-FUSE {path}: only {n_disp} dispatching member(s) "
                   f"— fusion is only legal when >=2 dispatches collapse "
                   f"(lone narrow ops must stay unfused)")
    for i in range(len(members) - 1):
        nxt = members[i + 1]
        if not nxt.children or nxt.children[0] is not members[i]:
            out.append(f"PV-FUSE {path}: members are not a linked chain "
                       f"child-most-first at position {i + 1} "
                       f"({_cls(nxt)})")
    if node.plan is not members[-1].plan:
        out.append(f"PV-FUSE {path}: fused stage must carry the chain "
                   f"head's plan node ({_cls(members[-1])})")
    _check_stage_id(getattr(node, "stage_id", 0), path, "PV-FUSE",
                    seen_stage_ids, out)


def _check_absorbed(node, path: str, seen_stage_ids: Dict[int, str],
                    out: List[str]) -> None:
    from spark_rapids_tpu_torch.exec import stage_fusion as SF
    if _cls(node) != "HashAggregateExec":
        out.append(f"PV-ABSORB {path}: pre-chain absorbed into "
                   f"{_cls(node)} — only HashAggregateExec may absorb")
        return
    if node.mode not in ("partial", "complete"):
        out.append(f"PV-ABSORB {path}: absorbing aggregate has mode "
                   f"{node.mode!r}; only partial/complete updates may run "
                   f"a pre-chain")
    members = node.pre_chain_members
    for m in members:
        if not SF._fusable(m):
            out.append(f"PV-ABSORB {path}: pre-chain member {_cls(m)} is "
                       f"not a fusable narrow operator")
    if not any(SF._dispatching(m) for m in members):
        out.append(f"PV-ABSORB {path}: no pre-chain member dispatches — "
                   f"absorbing saves nothing")
    for body in node.pre_chain or []:
        if body.has_carry:
            out.append(f"PV-ABSORB {path}: pre-chain body {body.key!r} "
                       f"carries state — carries cannot thread through "
                       f"the aggregate's update")
    for i in range(len(members) - 1):
        nxt = members[i + 1]
        if not nxt.children or nxt.children[0] is not members[i]:
            out.append(f"PV-ABSORB {path}: pre-chain members are not a "
                       f"linked chain child-most-first at position "
                       f"{i + 1} ({_cls(nxt)})")
    _check_stage_id(getattr(node, "fused_stage_id", 0), path, "PV-ABSORB",
                    seen_stage_ids, out)


def _check_stage_id(sid, path: str, rule: str,
                    seen_stage_ids: Dict[int, str], out: List[str]) -> None:
    if not isinstance(sid, int) or sid <= 0:
        out.append(f"{rule} {path}: stage id must be a positive int, "
                   f"got {sid!r}")
        return
    prev = seen_stage_ids.get(sid)
    if prev is not None:
        out.append(f"{rule} {path}: stage id {sid} already used by "
                   f"{prev}")
    else:
        seen_stage_ids[sid] = path


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
    seen_stage_ids: Dict[int, str] = {}
    on_stack: set = set()

    def walk(node, path: str, is_root: bool) -> None:
        if id(node) in on_stack:
            out.append(f"PV-TREE {path}: cycle — node {_cls(node)} is "
                       f"its own ancestor")
            return
        on_stack.add(id(node))
        try:
            _check_schema(node, path, out)
            if getattr(node, "members", None):
                _check_fused(node, path, seen_stage_ids, out)
            if getattr(node, "pre_chain_members", None):
                _check_absorbed(node, path, seen_stage_ids, out)
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


# ---------------------------------------------------------------------------
# Dispatch budgets
# ---------------------------------------------------------------------------

def dispatch_budget(exec_root) -> dict:
    """Static per-batch dispatch budget of a converted tree: one per fused
    stage, one per aggregate update (its absorbed pre-chain rides along),
    one per standalone Filter, Expand or non-trivial Project. Wide
    operators dispatch by the data and are out of scope. With the fusion
    groups, the pipeline boundaries and the operator census."""
    from spark_rapids_tpu_torch.exec import stage_fusion as SF
    from spark_rapids_tpu_torch.runtime.metrics import walk_exec_tree

    narrow = 0
    pipeline_boundaries = 0
    exec_count = 0
    census: Dict[str, int] = {}
    for _key, node, _depth, role, _sid in walk_exec_tree(exec_root):
        name = _cls(node)
        if role is not None:
            # fused members and absorbed pre-chains never dispatch alone
            continue
        exec_count += 1
        census[name] = census.get(name, 0) + 1
        if name == "PipelineExec":
            pipeline_boundaries += 1
        elif name in ("FusedStageExec", "HashAggregateExec"):
            narrow += 1
        elif name in ("FilterExec", "ExpandExec", "ProjectExec"):
            if SF._dispatching(node):
                narrow += 1
    groups = SF.fusion_groups(exec_root)
    return {
        "narrow_dispatches_per_batch": narrow,
        "fused_stages": sum(1 for g in groups if g["kind"] == "fused"),
        "absorbed_stages": sum(1 for g in groups
                               if g["kind"] == "absorbed"),
        "fusion_groups": [
            {"kind": g["kind"], "members": g["members"]} for g in groups],
        "pipeline_boundaries": pipeline_boundaries,
        "exec_count": exec_count,
        "exec_census": dict(sorted(census.items())),
    }


def compare_budget(actual: dict, golden: dict) -> List[str]:
    """Human-readable diffs between two budgets (empty = match), key by
    key, so a failure names the dimension that differs."""
    diffs = []
    for key in sorted(set(golden) | set(actual)):
        if actual.get(key) != golden.get(key):
            diffs.append(f"{key}: golden {golden.get(key)!r} != actual "
                         f"{actual.get(key)!r}")
    return diffs
