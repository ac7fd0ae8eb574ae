"""Golden cost signatures of the PyTorch port (NDS probe, on the CPU).

Runs the first NDS probe queries (``tools/nds_probe.py``, its builders
retargeted at ``spark_rapids_tpu_torch``) with the kernel cost auditor
armed (``analysis/kernel_audit.py``) and writes each query's cost
signature, per family: dispatches, entries, signatures ("shapes"),
operations, bytes accessed, input and output plane bytes.

    python tools/torch_gen_cost_signatures.py [--count N] [--device cpu]
                                              [--out PATH]

The recipe is the JAX package's (``tools/gen_dispatch_budgets.py``): a
fresh session and fresh tables (``gen_tables(0.002, seed=7)``), adaptive
execution pinned on, the keyed stage cache and the record table cleared
together (``clear_for_cold_audit``), the queries in sorted order. The
generator aborts on any audit finding: a pin of an incompletely audited
run is void. The default writes ``tests/torch_cost_signatures.json``,
which ``tests/test_torch_kernel_audit.py`` replays.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import types

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

SF = 0.002
SEED = 7
#: pinned, as in the JAX package's generator: adaptive execution changes
#: plan shape
ADAPTIVE = "true"
#: the prefix pinned by default (the tests replay it)
COUNT = 2
OUT = os.path.join(ROOT, "tests", "torch_cost_signatures.json")


def load_nds():
    """``tools/nds_probe.py`` as a module whose query builders read the
    port's ``TorchSession``, ``T``, ``F``, ``E``, ``col`` and ``lit``
    (the JAX package is never imported)."""
    path = os.path.join(ROOT, "tools", "nds_probe.py")
    src = open(path).read()
    src = src.replace("from spark_rapids_tpu.sql.session import TpuSession",
                      "from spark_rapids_tpu_torch import TorchSession "
                      "as TpuSession")
    src = re.sub(r"\bspark_rapids_tpu\b", "spark_rapids_tpu_torch", src)
    mod = types.ModuleType("nds_probe_port")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def cold_session(device: str = "cpu", conf=None):
    """A fresh audited session over fresh NDS tables, with the keyed
    cache and the record table cleared: (session, tables, nds module)."""
    from spark_rapids_tpu_torch import TorchSession
    from spark_rapids_tpu_torch.analysis import kernel_audit as KA
    nds = load_nds()
    base = {"spark.rapids.obs.audit.enabled": "true",
            "spark.rapids.sql.adaptive.enabled": ADAPTIVE}
    base.update(conf or {})
    sess = TorchSession(base, device=device)
    tables = nds.gen_tables(SF, seed=SEED)
    d = {name: sess.create_dataframe(t).cache()
         for name, t in tables.items()}
    KA.clear_for_cold_audit()
    return sess, d, nds


def build_cost_signatures(count: int = COUNT, device: str = "cpu"):
    """{query number: signature} of the first ``count`` sorted queries.
    Raises RuntimeError on any audit finding."""
    from spark_rapids_tpu_torch.analysis import kernel_audit as KA
    sess, d, nds = cold_session(device)
    sigs = {}
    for qn in sorted(nds.QUERIES)[:count]:
        nds.QUERIES[qn](sess, d).collect()
        sig = KA.query_signature(sess.last_audit())
        if sig is None:
            raise RuntimeError(f"q{qn}: no audit summary")
        sigs[str(qn)] = sig
    found = KA.findings()
    if found:
        raise RuntimeError("audit findings void this golden run:\n  "
                           + "\n  ".join(found[:20]))
    return sigs


def signature_doc(sigs) -> dict:
    from spark_rapids_tpu_torch.analysis.kernel_audit import (
        KERNEL_PRIMITIVES,
    )
    return {"_generator": "tools/torch_gen_cost_signatures.py",
            "_sf": SF, "_seed": SEED, "_adaptive": ADAPTIVE,
            "kernel_primitives": sorted(KERNEL_PRIMITIVES),
            "cost_signatures": sigs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=COUNT)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    doc = signature_doc(build_cost_signatures(args.count, args.device))
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(doc['cost_signatures'])} signatures to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
