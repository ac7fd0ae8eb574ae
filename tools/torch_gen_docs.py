"""Generate docs/torch_metrics.md: the port's rosters, as the linter reads them.

    python tools/torch_gen_docs.py          # rewrite docs/torch_metrics.md
    python tools/torch_gen_docs.py --check  # exit 1 when the file is stale

Counterpart of ``tools/gen_docs.py``'s metrics document, rendered from
``spark_rapids_tpu_torch``'s rosters: the metric constants of
``runtime/metrics.py`` (with their ``#:`` comments) and the task-metric
roster, the attribution buckets, fault sites, query states, sampler
series, HTTP routes, request spans and verdicts, the kernel-primitive
modules, the modules that may load a ``csrc/`` library and the collective
modules. ``tools/torch_lint.py``'s document-presence halves (TPU-L007,
L009, L011, L013-L016) read this file. Needs the port (torch), never the
JAX package.
"""
from __future__ import annotations

import ast
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
OUT = os.path.join(ROOT, "docs", "torch_metrics.md")


def _constants_with_docs(path):
    src = open(path).read()
    lines = src.splitlines()
    out = []
    for stmt in ast.parse(src, path).body:
        if not (isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            continue
        tgt = stmt.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id.isupper()):
            continue
        doc = []
        ln = stmt.lineno - 1
        while ln >= 1 and lines[ln - 1].lstrip().startswith("#:"):
            doc.insert(0, lines[ln - 1].lstrip()[2:].strip())
            ln -= 1
        out.append((stmt.value.value, tgt.id, " ".join(doc)))
    return out


def _table(title, intro, head, rows):
    lines = ["", f"## {title}", ""] + list(intro) + [
        "", f"| {head} | Notes |", "|---|---|"]
    lines += [f"| `{name}` | {doc} |" for name, doc in rows]
    return lines


def gen_metrics_md() -> str:
    sys.path.insert(0, ROOT)
    from spark_rapids_tpu_torch.analysis.kernel_audit import KERNEL_PRIMITIVES
    from spark_rapids_tpu_torch.exec import adaptive as AQ
    from spark_rapids_tpu_torch.parallel.mesh import (
        SANCTIONED_COLLECTIVE_MODULES,
    )
    from spark_rapids_tpu_torch.runtime.compile_cache import (
        SANCTIONED_KERNEL_MODULES,
    )
    from spark_rapids_tpu_torch.runtime.faults import BYTE_SITES, KINDS, SITES
    from spark_rapids_tpu_torch.runtime.obs.attribution import BUCKETS
    from spark_rapids_tpu_torch.runtime.obs.endpoint import ROUTES
    from spark_rapids_tpu_torch.runtime.obs.live import STATES
    from spark_rapids_tpu_torch.runtime.obs.reqtrace import (
        REQUEST_SPANS, VERDICTS,
    )
    from spark_rapids_tpu_torch.runtime.obs.sampler import SERIES
    from spark_rapids_tpu_torch.runtime.trace import TASK_METRIC_NAMES

    consts = _constants_with_docs(os.path.join(
        ROOT, "spark_rapids_tpu_torch", "runtime", "metrics.py"))
    documented = {name for name, _, _ in consts}
    lines = [
        "# Metric names and rosters of the PyTorch port",
        "",
        "Generated by `tools/torch_gen_docs.py` from the rosters of",
        "`spark_rapids_tpu_torch` (do not edit by hand). The port's linter,",
        "`tools/torch_lint.py`, checks every literal at a roster's call",
        "sites against these tables and every roster entry against this",
        "file (TPU-L007, L009, L011, L013-L016).",
        "",
        "## Exec metrics (runtime/metrics.py)",
        "",
        "| Name | Constant | Notes |",
        "|---|---|---|",
    ]
    lines += [f"| `{v}` | {c} | {d} |" for v, c, d in consts]
    lines += ["", "## Per-task accumulators (runtime/trace.py "
              "TASK_METRIC_NAMES)", ""]
    lines += [f"- `{n}`" + ("" if n in documented
                            else " (task-roster only)")
              for n in TASK_METRIC_NAMES]
    lines += _table(
        "Attribution buckets (runtime/obs/attribution.py BUCKETS)",
        ["Per-query wall-time phases. Every `attribution.record(\"...\")`",
         "literal uses one of these (TPU-L009)."], "Bucket",
        BUCKETS.items())
    lines += _table(
        "Fault sites (runtime/faults.py SITES)",
        ["Named crossings `spark.rapids.debug.faults` can target (kinds: "
         + ", ".join(KINDS) + "). Every `faults.site(\"...\")` /",
         "`site_bytes(\"...\")` literal uses one of these (TPU-L008)."],
        "Site", ((n, ("(data site) " if n in BYTE_SITES else "") + d)
                 for n, d in SITES.items()))
    lines += _table(
        "Query states (runtime/obs/live.py STATES)",
        ["The live registry's state machine. Every `transition(\"...\")`",
         "literal uses one of these (TPU-L011)."], "State", STATES.items())
    lines += _table(
        "Sampler series (runtime/obs/sampler.py SERIES)",
        ["Resource series of the always-on sampler (TPU-L011)."], "Series",
        SERIES.items())
    lines += _table(
        "HTTP routes (runtime/obs/endpoint.py ROUTES)",
        ["Every route the obs endpoint serves (TPU-L014)."], "Route",
        ROUTES.items())
    lines += _table(
        "Serving request spans (runtime/obs/reqtrace.py REQUEST_SPANS)",
        ["Every `request_span(\"...\")` literal uses one of these",
         "(TPU-L015)."], "Span", REQUEST_SPANS.items())
    lines += _table(
        "Tail-sampling verdicts (runtime/obs/reqtrace.py VERDICTS)",
        ["Every `_v(\"...\")` checkpoint uses one of these (TPU-L015)."],
        "Verdict", VERDICTS.items())
    lines += _table(
        "Kernel-primitive modules (analysis/kernel_audit.py "
        "KERNEL_PRIMITIVES)",
        ["Every module with an `_build.load` site of a `csrc/*.cu` source",
         "is one of these (TPU-L013); the auditor charges their kernels",
         "by formula."], "Module", KERNEL_PRIMITIVES.items())
    lines += _table(
        "Kernel-load modules (runtime/compile_cache.py "
        "SANCTIONED_KERNEL_MODULES)",
        ["The only modules that may call `_build.load` (TPU-L010)."],
        "Module", ((m, "sanctioned `_build.load` site")
                   for m in SANCTIONED_KERNEL_MODULES))
    lines += _table(
        "Collective modules (parallel/mesh.py "
        "SANCTIONED_COLLECTIVE_MODULES)",
        ["The only modules that may call the mesh's collectives",
         "(`all_to_all_exchange`, `broadcast_planes`, `shard_sum`) or",
         "`torch.distributed` (TPU-L016)."], "Module",
        SANCTIONED_COLLECTIVE_MODULES.items())
    lines += ["", "## Adaptive execution kinds (exec/adaptive.py)", ""]
    lines += [f"- `kind=\"{k}\"`" for k in (
        AQ.BROADCAST_CONVERSION, AQ.SKEW_SPLIT, AQ.BUILD_REUSE,
        AQ.MEASURED_COST)]
    lines.append("")
    return "\n".join(lines)


def main(argv) -> int:
    text = gen_metrics_md()
    if argv == ["--check"]:
        with open(OUT) as f:
            same = f.read() == text
        print("docs/torch_metrics.md is " + ("current" if same else
                                             "stale"))
        return 0 if same else 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(text)
    print("wrote docs/torch_metrics.md")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
