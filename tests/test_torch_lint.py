"""The port's linter (``spark_rapids_tpu_torch/analysis/lint.py``,
``tools/torch_lint.py``) against the JAX package's, on the CPU.

- Every ``test_l0*`` program of ``tests/test_analysis.py`` whose rule
  form is shared runs twice, once with each linter in place of the
  module it imports: both runs pass its assertions, and each
  ``lint_source`` call gives the same rule ids, lines and suppressions.
- The rules whose form changed (L004's torch syncs, L010's torch compile
  entries and kernel loads, L013's kernel modules, L016's mesh
  collectives and ``torch.distributed``) get port-form cases, and the
  reference's forms of L010, L013 and L016 are held not to be findings
  in the port.
- The port's tree lints clean, each suppression's reason listed; the
  rosters the linter extracts equal the modules'; ``docs/torch_metrics.md``
  equals the generator's output; the CLI's exit codes and ``--json``.
"""
import importlib.util
import inspect
import json
import os
import sys
import textwrap

import pytest

import test_analysis as TA

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "spark_rapids_tpu_torch")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


PL = _load("torch_lint_rules_under_test",
           os.path.join(PKG, "analysis", "lint.py"))
JL = TA.lint

#: test_analysis.py's programs whose rule form changed in the port
CHANGED_FORM = {
    "test_l010_raw_jit_flagged", "test_l010_pallas_confined_to_roster",
    "test_l010_roster_extraction_matches_compile_cache",
    "test_l013_unrostered_cc_jit_module_flagged",
    "test_l013_pallas_call_outside_roster_flagged",
    "test_l013_roster_extraction_and_staleness",
    "test_l016_collective_outside_roster_flagged",
    "test_l016_roster_extraction_and_staleness",
}
SHARED = sorted(n for n in dir(TA)
                if n.startswith("test_l0") and n not in CHANGED_FORM)


class _Recording:
    """A linter module whose lint_source results are recorded as
    (rule, line, suppressed) lists, one per call."""

    def __init__(self, mod):
        self._mod = mod
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def lint_source(self, *a, **k):
        out = self._mod.lint_source(*a, **k)
        self.calls.append([(v.rule, v.line, v.suppressed) for v in out])
        return out


def _run(name, mod, monkeypatch, tmp_path):
    rec = _Recording(mod)
    monkeypatch.setattr(TA, "lint", rec)
    fn = getattr(TA, name)
    kwargs = {p: tmp_path for p in inspect.signature(fn).parameters}
    fn(**kwargs)
    monkeypatch.setattr(TA, "lint", JL)
    return rec.calls


def test_the_reference_programs_are_all_accounted_for():
    names = {n for n in dir(TA) if n.startswith("test_l0")}
    assert len(names) == 54
    assert CHANGED_FORM <= names
    assert len(SHARED) == 46


@pytest.mark.parametrize("name", SHARED)
def test_shared_rule_program_gives_the_reference_findings(
        name, monkeypatch, tmp_path):
    ref = _run(name, JL, monkeypatch, tmp_path)
    port = _run(name, PL, monkeypatch, tmp_path)
    assert port == ref


def _lint(src, relpath="runtime/x.py", **kw):
    return PL.lint_source(textwrap.dedent(src), "/x/" + relpath,
                          {"opTime"}, relpath=relpath, **kw)


def _rules(vs, suppressed=False):
    return [v.rule for v in vs if v.suppressed == suppressed]


# -- the port's forms --------------------------------------------------------

@pytest.mark.parametrize("call", [
    "t.item()", "t.cpu()", "t.tolist()", "t.numpy()",
    "torch.cuda.synchronize()", "torch.cuda.synchronize(dev)",
    "stream.synchronize()", "ev.synchronize()", "np.asarray(t)"])
def test_l004_torch_syncs_in_a_span_body(call):
    src = f"""
        class X:
            def f(self, m, t, stream, ev, dev):
                with self.span(m):
                    v = {call}
    """
    assert _rules(_lint(src)) == ["TPU-L004"]
    annotated = src.replace(
        "v = ", "# tpulint: deferred-fetch read after the yield\n"
        "                    v = ")
    assert _rules(_lint(annotated)) == []


def test_l004_non_syncs_and_outside_spans_pass():
    assert _rules(_lint("""
        class X:
            def f(self, m, t, d):
                with self.span(m):
                    a = t.to(dev, non_blocking=True)
                    b = torch.as_tensor(t)
                    c = d.items()
                v = t.item()
    """)) == []


@pytest.mark.parametrize("src,n", [
    ("""
        import torch
        @torch.compile
        def f(x):
            return x + 1
     """, 1),
    ("""
        import torch
        @torch.jit.script
        def f(x):
            return x + 1
        g = torch.jit.trace(f, (x,))
        h = torch.compile(f, mode="max-autotune")
     """, 3),
    ("""
        import torch
        from functools import partial
        c = partial(torch.compile, fullgraph=True)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            pass
        k = torch.cuda.make_graphed_callables(f, (x,))
        g.capture_begin()
     """, 5),
])
def test_l010_torch_compile_entries_outside_the_choke_point(src, n):
    assert _rules(_lint(src, relpath="exec/x.py")) == ["TPU-L010"] * n
    assert _rules(_lint(src, relpath="runtime/compile_cache.py")) == []


def test_l010_kernel_loads_confined_to_the_roster():
    src = """
        from spark_rapids_tpu_torch.ops import _build
        def k():
            return _build.load("murmur3")
    """
    roster = {"ops/murmur3_kernel.py"}
    assert _rules(_lint(src, relpath="ops/x.py",
                        pallas_modules=roster)) == ["TPU-L010"]
    assert _rules(_lint(src, relpath="ops/murmur3_kernel.py",
                        pallas_modules=roster)) == []


def test_l010_13_16_reference_forms_are_not_port_findings():
    """jax.jit, pallas_call, compile_cache.jit and the XLA collectives do
    not exist in the port: the port's rules do not read them."""
    vs = _lint("""
        import jax
        from jax import lax
        @jax.jit
        def f(x):
            return lax.psum(x, "part")
        def g(kern, x, mesh):
            return pl.pallas_call(kern, out_shape=x)(shard_map(
                lambda s: lax.all_to_all(s, "part", 0, 0), mesh=mesh))
        h = _cc.jit(f)
    """, relpath="exec/x.py", pallas_modules=set(),
        kernel_modules=set(), collective_modules=set())
    assert _rules(vs) == []


def test_l013_kernel_loads_need_the_roster_and_host_libraries_do_not():
    src = """
        from spark_rapids_tpu_torch.ops import _build
        def k():
            return _build.load("segsum")
        def packer():
            return _build.load("kudo")
    """
    sources = {"murmur3", "segsum", "bitslice", "case_map"}
    vs = _lint(src, relpath="ops/new_kernel.py", kernel_modules=set(),
               kernel_sources=sources, pallas_modules={"ops/new_kernel.py"})
    assert [(v.rule, v.line) for v in vs] == [("TPU-L013", 4)]
    assert _rules(_lint(src, relpath="ops/new_kernel.py",
                        kernel_modules={"ops/new_kernel.py"},
                        kernel_sources=sources,
                        pallas_modules={"ops/new_kernel.py"})) == []


@pytest.mark.parametrize("call", [
    "PX.all_to_all_exchange(p, v, t, devs)",
    "exchange.broadcast_planes(p, v, devs)",
    "shard_sum(vals, dev)",
    "dist.all_reduce(t)",
    "torch.distributed.init_process_group('gloo')",
])
def test_l016_collectives_outside_the_roster(call):
    src = f"""
        def f(p, v, t, devs, vals, dev):
            return {call}
    """
    roster = {"parallel/exchange.py"}
    assert _rules(_lint(src, relpath="exec/x.py",
                        collective_modules=roster)) == ["TPU-L016"]
    assert _rules(_lint(src, relpath="parallel/exchange.py",
                        collective_modules=roster)) == []
    assert _rules(_lint("""
        def f(x):
            return x.shard_sum_like_name
    """, relpath="exec/x.py", collective_modules=roster)) == []


# -- the port's rosters and tree ---------------------------------------------

def test_rosters_extracted_equal_the_modules():
    from spark_rapids_tpu_torch.analysis.kernel_audit import KERNEL_PRIMITIVES
    from spark_rapids_tpu_torch.parallel.mesh import (
        SANCTIONED_COLLECTIVE_MODULES,
    )
    from spark_rapids_tpu_torch.runtime.compile_cache import (
        SANCTIONED_KERNEL_MODULES,
    )
    sources = PL.kernel_sources(PKG)
    assert sources == {"murmur3", "segsum", "bitslice", "case_map"}
    assert PL.known_kernel_load_modules(PKG) == set(SANCTIONED_KERNEL_MODULES)
    kmods = PL.known_kernel_primitives(PKG)
    assert kmods == set(KERNEL_PRIMITIVES) == {
        "ops/bitslice.py", "ops/case_map.py", "ops/murmur3_kernel.py",
        "ops/segsum.py"}
    for mod in kmods:
        assert PL.module_emits_kernels(os.path.join(PKG, mod), sources), mod
    # the frame packer loads a host library: a sanctioned load, no kernel
    serde = os.path.join(PKG, "shuffle", "serde.py")
    assert not PL.module_emits_kernels(serde, sources)
    assert PL.module_emits_kernels(serde)
    cmods = PL.known_collective_modules(PKG)
    assert cmods == set(SANCTIONED_COLLECTIVE_MODULES)
    for mod in cmods:
        assert PL.module_uses_collectives(os.path.join(PKG, mod)), mod
    # the sharded stage moves slots to their devices, no collective
    assert not PL.module_uses_collectives(
        os.path.join(PKG, "exec", "sharded.py"))


#: every justified suppression in the port's tree: (path, rule) -> the
#: reason's first words
SUPPRESSIONS = {
    ("spark_rapids_tpu_torch/exec/nodes.py", "TPU-L004"):
        "range bounds need the sample values on the host",
    ("spark_rapids_tpu_torch/runtime/memory.py", "TPU-L001"):
        "np.load/unlink must be atomic with the DISK->HOST",
    ("spark_rapids_tpu_torch/io/async_io.py", "TPU-L002"):
        "standalone-writer fallback only",
}


def test_port_tree_lints_clean():
    violations, stats = PL.lint_tree(REPO)
    live = [v.render(REPO) for v in violations if not v.suppressed]
    assert live == [], "\n".join(live)
    assert stats["suppressions_without_reason"] == 0
    found = {}
    for v in violations:
        found.setdefault((os.path.relpath(v.path, REPO), v.rule),
                         set()).add(v.reason)
    assert set(found) == set(SUPPRESSIONS)
    for key, reasons in found.items():
        assert all(r.startswith(SUPPRESSIONS[key]) for r in reasons), key
    assert stats["suppressed"] == 4  # nodes.py's line holds two syncs


def test_docs_torch_metrics_is_the_generators_output():
    gen = _load("torch_gen_docs_under_test",
                os.path.join(REPO, "tools", "torch_gen_docs.py"))
    with open(os.path.join(REPO, "docs", "torch_metrics.md")) as f:
        assert f.read() == gen.gen_metrics_md()
    documented = PL.docs_metric_names(REPO)
    for name in ("gpuDecodeTime", "numFiles", "numFilesPruned",
                 "ops/segsum.py", "parallel/exchange.py"):
        assert name in documented


def test_cli_exit_codes_and_json(monkeypatch, capsys):
    cli = _load("torch_lint_cli_under_test",
                os.path.join(REPO, "tools", "torch_lint.py"))
    monkeypatch.setattr(sys, "argv", ["torch_lint.py", "--json"])
    assert cli.main() == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["violations"] == [] and doc["per_rule"] == {}
    assert len(doc["suppressed"]) == 4

    class _Seeded:
        def __getattr__(self, name):
            return getattr(PL, name)

        @staticmethod
        def lint_tree(root):
            v = PL.Violation("TPU-L005", os.path.join(root, "x.py"), 3,
                             "mutable default argument")
            return [v], {"files": 1, "violations": 1, "suppressed": 0,
                         "suppressions_without_reason": 0}
    monkeypatch.setattr(cli, "_load_lint", lambda: _Seeded())
    monkeypatch.setattr(sys, "argv", ["torch_lint.py"])
    assert cli.main() == 1
    assert "x.py:3: TPU-L005" in capsys.readouterr().out
