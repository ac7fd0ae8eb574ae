"""The port's linter CLI: engine-invariant static analysis over
spark_rapids_tpu_torch/.

    python tools/torch_lint.py [--strict] [--json] [--rule TPU-LNNN ...]

The counterpart of tools/tpulint.py, with its exit codes and report:
0 when clean (suppressed violations with reasons are allowed), 1 when any
unsuppressed violation remains, or, in --strict mode, when a suppression
is missing its reason. The linter is pure AST
(spark_rapids_tpu_torch/analysis/lint.py is loaded by file path, never
importing the engine or torch), so the full-tree run stays well under the
10-second budget; the measured elapsed time is printed and enforced.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _load_lint():
    """Load analysis/lint.py WITHOUT importing spark_rapids_tpu_torch
    (whose __init__ pulls torch: seconds the lint must not pay)."""
    path = os.path.join(ROOT, "spark_rapids_tpu_torch", "analysis",
                        "lint.py")
    spec = importlib.util.spec_from_file_location("torch_lint_rules", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--strict", action="store_true",
                    help="fail on unsuppressed violations AND on disable "
                         "comments without a reason")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--rule", action="append", default=None,
                    help="only report these rule ids (repeatable)")
    ap.add_argument("--budget-seconds", type=float, default=10.0,
                    help="fail if the lint itself exceeds this wall time")
    args = ap.parse_args()

    t0 = time.perf_counter()
    lint = _load_lint()
    violations, stats = lint.lint_tree(ROOT)
    elapsed = time.perf_counter() - t0
    if args.rule:
        keep = set(args.rule)
        violations = [v for v in violations if v.rule in keep]

    live = [v for v in violations if not v.suppressed]
    suppressed = [v for v in violations if v.suppressed]
    per_rule = {}
    for v in live:
        per_rule[v.rule] = per_rule.get(v.rule, 0) + 1

    if args.json:
        print(json.dumps({
            "files": stats["files"],
            "elapsed_s": round(elapsed, 3),
            "violations": [dataclass_dict(v) for v in live],
            "suppressed": [dataclass_dict(v) for v in suppressed],
            "per_rule": per_rule,
        }, indent=1))
    else:
        for v in live:
            print(v.render(ROOT))
        if suppressed:
            print(f"-- {len(suppressed)} suppressed "
                  f"(justified # tpulint: disable sites):")
            for v in suppressed:
                print("   " + v.render(ROOT))
        print(f"torch_lint: {stats['files']} files, {len(live)} "
              f"violations, "
              f"{len(suppressed)} suppressed, {elapsed:.2f}s")

    if elapsed > args.budget_seconds:
        print(f"FAIL: lint took {elapsed:.2f}s "
              f"(budget {args.budget_seconds:.0f}s)", file=sys.stderr)
        return 1
    if live:
        return 1
    if args.strict and stats["suppressions_without_reason"]:
        print("FAIL: --strict requires every tpulint disable comment to "
              "carry a reason", file=sys.stderr)
        return 1
    return 0


def dataclass_dict(v):
    return {"rule": v.rule, "path": os.path.relpath(v.path, ROOT),
            "line": v.line, "message": v.message,
            "suppressed": v.suppressed, "reason": v.reason}


if __name__ == "__main__":
    sys.exit(main())
