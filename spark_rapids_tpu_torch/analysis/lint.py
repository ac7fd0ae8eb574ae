"""The port's linter: AST checks for the engine's hand-enforced invariants.

Counterpart of ``spark_rapids_tpu/analysis/lint.py`` (``tpulint``), a
stdlib-``ast`` copy adapted to this package; it imports neither the
engine nor torch, so a full-tree run stays a fraction of a second and
usable as a pre-commit hook (``tools/torch_lint.py``). The rule ids
(``TPU-L001`` .. ``TPU-L016``) and the ``# tpulint: disable=`` /
``# tpulint: deferred-fetch`` / ``# tpulint: uncancellable`` comments are
the JAX package's, so its suppressions carry over as they are.

Rules whose form changed for the port (the rest check what the JAX
package's check, over this package's rosters):

- TPU-L004: the syncs are torch's: ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()`` and a
  stream's or event's ``.synchronize()`` (with ``np.asarray``, as in the
  reference; ``jax.device_get`` has no counterpart).
- TPU-L010: the compile entries are ``torch.compile``, ``torch.jit.*`` and
  CUDA-graph capture (``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
  ``make_graphed_callables``), allowed only in
  ``runtime/compile_cache.py``; the hand kernels' ``ops/_build.load``
  sites are confined to the ``SANCTIONED_KERNEL_MODULES`` roster of
  ``runtime/compile_cache.py`` (the reference's pallas_call roster).
- TPU-L013: a kernel-emitting module is one with an ``_build.load`` site
  of a CUDA source (``csrc/<name>.cu``; the host C++ frame packer is not
  a kernel), and its roster is ``analysis/kernel_audit.py``'s
  ``KERNEL_PRIMITIVES``.
- TPU-L016: the collectives are the mesh's (``parallel/exchange.py``'s
  ``all_to_all_exchange``, ``broadcast_planes`` and ``shard_sum``) and
  any ``torch.distributed`` call, confined to ``parallel/mesh.py``'s
  ``SANCTIONED_COLLECTIVE_MODULES``; a rostered module either calls or
  defines one.
- TPU-L007, L009, L011, L013-L016 read the port's own document,
  ``docs/torch_metrics.md`` (``tools/torch_gen_docs.py``), which
  lists the port's rosters.

No rule is dropped.

Rules
-----
TPU-L001  no ``with <lock>:`` body containing logging, trace/obs emission,
          file I/O, blocking waits, or callback invocation. A wedged log
          handler or slow disk must never extend a critical section.
TPU-L002  no bare ``ThreadPoolExecutor``/``threading.Thread`` outside
          ``runtime/host_pool.py`` — all host parallelism goes through
          the shared bounded pool (or its sanctioned task-wave/service-
          thread factories).
TPU-L003  no exec timer site bypassing ``TorchExec.span``: ``.ns()``
          metric timers in the exec layer dodge the one-instrumentation-
          point contract (trace + metric must stay a single block).
TPU-L004  no device-tensor host sync (``.item()``, ``.cpu()``,
          ``.tolist()``, ``.numpy()``, ``.synchronize()``,
          ``np.asarray``) inside a span'd timer body without a
          ``# tpulint: deferred-fetch <why>`` annotation — an
          unannotated sync serializes the host against the device inside
          a timed region (the dispatch-pipelining killer).
TPU-L005  no mutable default arguments (list/dict/set literals or
          constructors) anywhere in the package.
TPU-L006  no silently swallowed exceptions: an ``except`` over
          Exception/BaseException (or bare) whose body is just ``pass``
          must carry a justification comment on the except line.
TPU-L007  every string-literal metric name at a ``.metric("...")`` /
          ``GpuMetric("...")`` site must be registered in
          ``runtime/metrics.py`` (module constants) or the task-metric
          roster in ``runtime/trace.py``, and present in the generated
          ``docs/torch_metrics.md`` — ad-hoc names silently vanish from
          the rollups and the docs.
TPU-L008  every string-literal fault-site name at a
          ``faults.site("...")`` / ``faults.site_bytes("...")`` call
          must be registered in the ``SITES`` roster of
          ``runtime/faults.py`` — an unregistered site can never fire
          from a conf spec, silently shrinking chaos coverage (the
          fault-site twin of TPU-L007).
TPU-L009  every string-literal attribution-bucket name at an
          ``attribution.record("...")`` call must be registered in the
          ``BUCKETS`` roster of ``runtime/obs/attribution.py`` (and
          every roster bucket must appear in generated
          docs/torch_metrics.md)
          — an unregistered bucket's time silently vanishes from every
          attribution surface (the bucket twin of TPU-L007/L008).
TPU-L010  no ``torch.compile``, ``torch.jit.*`` or CUDA-graph capture
          outside ``runtime/compile_cache.py`` — every compiled entry
          routes through the sanctioned choke point so the stage cache,
          the hit/miss/build counters, the attribution ``compile``
          bucket and warmup see it (the L002/L003 pattern). The hand
          kernels' ``_build.load`` sites are likewise confined to the
          modules rostered in
          ``compile_cache.SANCTIONED_KERNEL_MODULES``.
TPU-L011  every string-literal query-state at a ``transition("...")``
          call must be registered in the ``STATES`` roster of
          ``runtime/obs/live.py``, and every rostered state and sampler
          series must appear in generated docs/torch_metrics.md — a
          typo'd
          state renders as a phantom phase on the live console and an
          off-roster series never reaches /metrics, sparklines, or
          flight dumps (the live-observability twin of TPU-L007/L009).
          The sampler's scheduled writer is its roster-keyed collector
          table, pinned by an import-time assert; the
          ``series_point("...")`` / ``sample_series("...")`` call-site
          check reserves the names for a future push-style sampling
          API so it is born lint-pinned (no such call sites exist
          today).
TPU-L012  no unbounded blocking wait (``Event.wait()`` /
          ``Condition.wait()`` with no timeout) outside the sanctioned
          waiter-protocol internals (``runtime/semaphore.py``,
          ``runtime/lifecycle.py``, ``analysis/sanitizer.py``). A
          thread parked forever on an event no cancel token reaches is
          exactly how a cancelled query strands a pool worker — every
          blocking wait must either be cancellation-aware (its event
          registered as a token waiter, or waited in bounded slices
          with a ``lifecycle.check_current()`` between them) or carry a
          ``# tpulint: uncancellable <why>`` justification.
TPU-L013  every kernel-emitting module — one containing an
          ``_build.load`` site of a CUDA source — must be registered in
          the ``KERNEL_PRIMITIVES`` roster of
          ``analysis/kernel_audit.py`` (and stale roster entries naming
          a module with no kernel sites, or absent from generated
          docs/torch_metrics.md, are flagged too). The kernel cost auditor's coverage statement — "every
          compiled computation routes through an audited entry point" —
          holds only while the roster tracks reality (the L007-L012
          roster pattern).
TPU-L014  every HTTP route literal the obs endpoint's handlers compare
          ``path`` against must be registered in the ``ROUTES`` roster
          of ``runtime/obs/endpoint.py`` (and every roster entry must
          appear in generated docs/torch_metrics.md and still match a
          handler
          literal — stale entries are flagged). The endpoint now
          carries mutating routes (POST /sql, POST
          /queries/<id>/cancel), so an undocumented or drifted route is
          an invisible API surface (the L007-L013 roster pattern).
TPU-L015  every serving request-span literal at a ``request_span("...")``
          call site must be a key of the ``REQUEST_SPANS`` roster in
          ``runtime/obs/reqtrace.py``, and every sampling-verdict
          literal at a ``_v("...")`` checkpoint (the verdict-decision
          shape, scoped to runtime/obs/ + runtime/serving/) must be a
          key of its ``VERDICTS`` roster — both with stale-entry and
          docs-presence halves. A request's exported timeline and the
          rapids_reqtrace_verdicts_total counter are operator-facing
          vocabularies: an unrostered name is an invisible phase or an
          uncountable verdict (the L007-L014 roster pattern).
TPU-L016  every mesh collective call site (``all_to_all_exchange``,
          ``broadcast_planes``, ``shard_sum``) and every
          ``torch.distributed`` call must live in a module registered in
          the ``SANCTIONED_COLLECTIVE_MODULES`` roster of
          ``parallel/mesh.py`` (with stale-entry and docs-presence
          halves). Data moved between shards by an unreviewed module is
          a program whose shard contract nobody checked, outside the
          mesh-fingerprinted stage keys and the shard-skew audit (the
          L010 confinement pattern applied to the mesh).

Suppression
-----------
``# tpulint: disable=TPU-LNNN <reason>`` on the violating line (or alone
on the line above it, when the reason outgrows the line) — or, for
TPU-L001, on the ``with`` statement opening the locked region — records
a counted, justified suppression. ``--strict`` fails on any unsuppressed
violation and on any disable comment without a reason. Deferred fetches
use ``# tpulint: deferred-fetch <why>`` (an annotation, not a
suppression: it documents that the fetch rides under device compute).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "TPU-L001": "logging/trace/obs/file-I/O/blocking call inside a held "
                "lock region",
    "TPU-L002": "bare ThreadPoolExecutor/threading.Thread outside "
                "runtime/host_pool.py",
    "TPU-L003": "exec timer bypasses TorchExec.span (.ns() in the exec "
                "layer)",
    "TPU-L004": "device->host sync inside a span'd timer body without a "
                "deferred-fetch annotation",
    "TPU-L005": "mutable default argument",
    "TPU-L006": "swallowed 'except Exception: pass' without a "
                "justification comment",
    "TPU-L007": "metric name not registered in runtime/metrics.py (or "
                "absent from docs/torch_metrics.md)",
    "TPU-L008": "fault-site name not registered in the runtime/faults.py "
                "SITES roster",
    "TPU-L009": "attribution-bucket name not registered in the "
                "runtime/obs/attribution.py BUCKETS roster",
    "TPU-L010": "torch.compile/torch.jit/CUDA-graph capture outside "
                "runtime/compile_cache.py, or an _build.load kernel site "
                "outside its SANCTIONED_KERNEL_MODULES roster",
    "TPU-L011": "query-state / sampler-series name not registered in the "
                "runtime/obs/live.py STATES or runtime/obs/sampler.py "
                "SERIES roster",
    "TPU-L012": "unbounded blocking wait (Event/Condition .wait() with "
                "no timeout) outside the sanctioned waiter-protocol "
                "internals, without an uncancellable justification",
    "TPU-L013": "kernel-emitting module (_build.load of a CUDA "
                "source) not registered in the "
                "analysis/kernel_audit.py KERNEL_PRIMITIVES roster "
                "(or a stale/undocumented roster entry)",
    "TPU-L014": "HTTP route literal not registered in the "
                "runtime/obs/endpoint.py ROUTES roster (or a "
                "stale/undocumented roster entry)",
    "TPU-L015": "serving request-span / sampling-verdict literal not "
                "registered in the runtime/obs/reqtrace.py "
                "REQUEST_SPANS / VERDICTS roster (or a "
                "stale/undocumented roster entry)",
    "TPU-L016": "mesh collective (all_to_all_exchange/broadcast_planes/"
                "shard_sum) or torch.distributed call site outside the "
                "parallel/mesh.py "
                "SANCTIONED_COLLECTIVE_MODULES roster (or a "
                "stale/undocumented roster entry)",
}

#: modules owning the cancellation waiter protocol itself: their naked
#: event waits ARE the cancel wakeup path (TPU-L012 sanctioned set)
_WAIT_SANCTIONED_FILES = (
    "runtime/semaphore.py", "runtime/lifecycle.py",
    "analysis/sanitizer.py",
)

#: receiver names under which a .site()/.site_bytes() call is the fault
#: injector (the engine imports it as `faults`, `_faults`, or `FLT`)
_FAULTS_BASES = {"faults", "_faults", "flt"}

#: receiver names under which a .record() call is the attribution engine
#: (imported as `attribution`, `_attr`, `ATTR`, or `attr`)
_ATTR_BASES = {"attribution", "_attr", "attr"}

_DISABLE_RE = re.compile(
    r"#\s*tpulint:\s*disable=(TPU-L\d{3})\b[ \t]*(.*)")
_DEFERRED_RE = re.compile(r"#\s*tpulint:\s*deferred-fetch\b[ \t]*(.*)")
_UNCANCEL_RE = re.compile(r"#\s*tpulint:\s*uncancellable\b[ \t]*(.*)")
_LOCKISH_RE = re.compile(
    r"(?:^|_)(lock|locks|glock|mutex|cv|cond|condition)$")

#: attribute terminals that mean "this call emits a log record" when the
#: receiver looks like a logger
_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical", "log"}
_LOGGER_NAMES = {"log", "logger", "logging"}
#: module-level trace entry points (runtime/trace.py)
_TRACE_FUNCS = {"instant", "span", "metric_span", "exec_span", "emit_span",
                "complete", "task_rollup", "start_query", "end_query",
                "on_task_complete", "finalize"}
_TRACE_BASES = {"trace", "tr", "tracer"}
#: (base, terminal) file-I/O pairs
_IO_PAIRS = {
    ("np", "save"), ("np", "load"), ("numpy", "save"), ("numpy", "load"),
    ("os", "unlink"), ("os", "remove"), ("os", "makedirs"),
    ("os", "rename"), ("os", "replace"), ("os", "rmdir"),
    ("shutil", "rmtree"), ("shutil", "copy"), ("shutil", "move"),
    ("json", "dump"), ("pickle", "dump"),
    ("time", "sleep"), ("subprocess", "run"), ("subprocess", "check_call"),
    ("subprocess", "check_output"),
}
#: terminals that block or do I/O on any receiver
_BLOCKING_TERMINALS = {"write", "flush", "wait", "result"}
#: bare names whose call under a lock is file I/O / console I/O
_IO_NAMES = {"open", "print"}
#: bare names that are conventionally caller-supplied callbacks
_CALLBACK_NAMES = {"fn", "cb", "callback", "hook"}

#: host-sync calls inside span bodies (TPU-L004): torch's, and numpy's
#: conversion of a tensor
_SYNC_TERMINALS = {"item", "cpu", "tolist", "numpy", "synchronize",
                   "asarray"}

#: the mesh's collective entry points (TPU-L016): calling any of these
#: moves data between shards — the module must be in the
#: parallel/mesh.py SANCTIONED_COLLECTIVE_MODULES roster
_COLLECTIVE_TERMINALS = {"all_to_all_exchange", "broadcast_planes",
                         "shard_sum"}
#: receiver names under which any call is torch.distributed's
_DIST_BASES = {"distributed", "dist"}

#: torch's compile entries (TPU-L010): terminals under ``torch`` and
#: under ``torch.cuda`` that compile or capture
_TORCH_COMPILE = {("torch", "compile"), ("cuda", "graph"),
                  ("cuda", "CUDAGraph"), ("cuda", "make_graphed_callables"),
                  ("torch", "make_graphed_callables")}
#: receiver names under which ``.load`` is the kernel builder
_BUILD_BASES = {"_build", "build"}

_OBS_FUNCS = {"on_query_start", "on_query_end", "on_task_complete",
              "state", "install"}


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def render(self, root: str) -> str:
        rel = os.path.relpath(self.path, root)
        tag = " [suppressed: %s]" % self.reason if self.suppressed else ""
        return f"{rel}:{self.line}: {self.rule}: {self.message}{tag}"


def _terminal(node: ast.AST) -> Optional[str]:
    """Final identifier of a Name/Attribute chain ('self._lock' -> '_lock')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """Identifier the terminal hangs off ('trace.instant' -> 'trace',
    'self.tracer.complete' -> 'tracer')."""
    if isinstance(node, ast.Attribute):
        return _terminal(node.value)
    return None


def _is_lockish(expr: ast.AST) -> bool:
    name = _terminal(expr)
    return bool(name and _LOCKISH_RE.search(name.lower()))


def _expr_key(expr: ast.AST) -> str:
    return ast.dump(expr)


def _is_span_call(expr: ast.AST) -> bool:
    """Is this with-item a span'd timer? self.span(m), trace.metric_span,
    trace.exec_span, <metric>.ns() (the bare timer), node.span(...)."""
    if not isinstance(expr, ast.Call):
        return False
    term = _terminal(expr.func)
    if term in ("span", "metric_span", "exec_span", "ns"):
        return True
    return False


class _FileLinter(ast.NodeVisitor):
    """One file's checks. ``pallas_modules`` keeps the reference's
    keyword: here it names the modules sanctioned for ``_build.load``
    sites (``compile_cache.SANCTIONED_KERNEL_MODULES``)."""

    def __init__(self, path: str, source: str, known_metrics: Set[str],
                 relpath: str, known_sites: Optional[Set[str]] = None,
                 known_buckets: Optional[Set[str]] = None,
                 pallas_modules: Optional[Set[str]] = None,
                 known_states: Optional[Set[str]] = None,
                 known_series: Optional[Set[str]] = None,
                 kernel_modules: Optional[Set[str]] = None,
                 known_routes: Optional[Set[str]] = None,
                 known_request_spans: Optional[Set[str]] = None,
                 known_verdicts: Optional[Set[str]] = None,
                 collective_modules: Optional[Set[str]] = None,
                 kernel_sources: Optional[Set[str]] = None):
        self.path = path
        #: names of csrc/*.cu (None: every _build.load is a kernel site)
        self.kernel_sources = kernel_sources
        self.relpath = relpath.replace(os.sep, "/")
        self.lines = source.splitlines()
        self.known_metrics = known_metrics
        self.known_sites = known_sites
        self.known_buckets = known_buckets
        self.known_states = known_states
        self.known_series = known_series
        self.kernel_modules = kernel_modules
        self.known_routes = known_routes
        self.known_request_spans = known_request_spans
        self.known_verdicts = known_verdicts
        self.collective_modules = collective_modules
        #: literals actually used at request_span()/_v() call sites —
        #: lint_tree aggregates these for the TPU-L015 stale half
        self.used_request_spans: Set[str] = set()
        self.used_verdicts: Set[str] = set()
        self.violations: List[Violation] = []
        # stack of (lock_keys, with_lineno) for held-lock regions
        self._lock_stack: List[Tuple[Set[str], int]] = []
        self._span_depth = 0
        self._in_host_pool = self.relpath.endswith("runtime/host_pool.py")
        self._in_exec_layer = "/exec/" in "/" + self.relpath
        self._in_analysis = "/analysis/" in "/" + self.relpath
        self._in_compile_cache = self.relpath.endswith(
            "runtime/compile_cache.py")
        self._wait_sanctioned = any(
            self.relpath.endswith(m) for m in _WAIT_SANCTIONED_FILES)
        self._load_sanctioned = self._in_compile_cache or (
            pallas_modules is not None
            and any(self.relpath.endswith(m) for m in pallas_modules))

    # -- helpers -----------------------------------------------------------

    def _line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def _annotated_deferred(self, lineno: int) -> bool:
        """deferred-fetch annotation on the line or either neighbor (the
        call often wraps across lines)."""
        for ln in (lineno - 1, lineno, lineno + 1):
            if _DEFERRED_RE.search(self._line(ln)):
                return True
        return False

    def _annotated_uncancellable(self, lineno: int) -> bool:
        """uncancellable annotation on the line or either neighbor."""
        for ln in (lineno - 1, lineno, lineno + 1):
            if _UNCANCEL_RE.search(self._line(ln)):
                return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str,
              also_lines: Tuple[int, ...] = ()) -> None:
        lineno = getattr(node, "lineno", 1)
        candidates = []
        for ln in (lineno,) + also_lines:
            # the disable comment sits on the statement line or — when
            # the reason is too long for the line — alone on the line
            # above it (the eslint-disable-next-line convention)
            candidates += [ln, ln - 1]
        for ln in candidates:
            m = _DISABLE_RE.search(self._line(ln))
            if m and m.group(1) == rule:
                self.violations.append(Violation(
                    rule, self.path, lineno, message, suppressed=True,
                    reason=m.group(2).strip()))
                return
        self.violations.append(Violation(rule, self.path, lineno, message))

    # -- TPU-L001 ----------------------------------------------------------

    def _check_locked_call(self, node: ast.Call) -> None:
        if not self._lock_stack:
            return
        lock_keys = set().union(*(k for k, _ in self._lock_stack))
        with_lines = tuple(ln for _, ln in self._lock_stack)
        func = node.func
        term = _terminal(func)
        base = _base_name(func)

        def hit(what: str) -> None:
            self._emit("TPU-L001", node,
                       f"{what} inside a held lock region "
                       f"(lock taken at line {with_lines[-1]})",
                       also_lines=with_lines)

        if isinstance(func, ast.Name):
            if func.id in _IO_NAMES:
                hit(f"file/console I/O call {func.id}()")
            elif func.id in _CALLBACK_NAMES:
                hit(f"callback invocation {func.id}()")
            return
        if term is None:
            return
        # a condition waiting on ITSELF is the cv protocol, not a held-
        # lock block (cv.wait releases the lock it guards)
        if term in ("wait", "notify", "notify_all") and base is not None:
            owner = func.value
            if _expr_key(owner) in lock_keys:
                return
        if term in _LOG_METHODS and base is not None \
                and (base.lower() in _LOGGER_NAMES
                     or (isinstance(func.value, ast.Call)
                         and _terminal(func.value.func) == "getLogger")):
            hit(f"logging call .{term}()")
            return
        if term in _TRACE_FUNCS and base is not None \
                and base.lower() in _TRACE_BASES:
            hit(f"trace emission {base}.{term}()")
            return
        if term in _OBS_FUNCS and base == "obs":
            hit(f"obs call obs.{term}()")
            return
        if base is not None and (base, term) in _IO_PAIRS:
            hit(f"I/O call {base}.{term}()")
            return
        if term in _BLOCKING_TERMINALS:
            hit(f"blocking call .{term}()")
            return

    # -- visitors ----------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        lock_keys: Set[str] = set()
        span = False
        for item in node.items:
            # the context expressions evaluate before the region is
            # entered — check them against the ENCLOSING state
            self.visit(item.context_expr)
        for item in node.items:
            expr = item.context_expr
            if _is_lockish(expr):
                lock_keys.add(_expr_key(expr))
            elif isinstance(expr, ast.Call) and _is_lockish(expr.func):
                # factory-style: with lock(): — rare, treat as lock
                lock_keys.add(_expr_key(expr))
            if _is_span_call(expr):
                span = True
        if lock_keys:
            self._lock_stack.append((lock_keys, node.lineno))
        if span:
            self._span_depth += 1
        for child in node.body:
            self.visit(child)
        if span:
            self._span_depth -= 1
        if lock_keys:
            self._lock_stack.pop()

    # nested defs/lambdas inside a with-block do NOT run under the lock
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self._check_jit_decorators(node)
        saved, self._lock_stack = self._lock_stack, []
        saved_span, self._span_depth = self._span_depth, 0
        self.generic_visit(node)
        self._lock_stack = saved
        self._span_depth = saved_span

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved, self._lock_stack = self._lock_stack, []
        saved_span, self._span_depth = self._span_depth, 0
        self.generic_visit(node)
        self._lock_stack = saved
        self._span_depth = saved_span

    def visit_Call(self, node: ast.Call) -> None:
        self._check_locked_call(node)
        self._check_threads(node)
        self._check_timer_bypass(node)
        self._check_host_sync(node)
        self._check_metric_name(node)
        self._check_fault_site(node)
        self._check_attr_bucket(node)
        self._check_live_obs_names(node)
        self._check_compile_entry(node)
        self._check_kernel_roster(node)
        self._check_unbounded_wait(node)
        self._check_reqtrace_names(node)
        self._check_collective_site(node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._check_swallowed(node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        self._check_route_literal(node)
        self.generic_visit(node)

    # -- TPU-L014 ----------------------------------------------------------

    def _check_route_literal(self, node: ast.Compare) -> None:
        """A handler dispatching on ``path == "/literal"`` (or ``path in
        ("/a", "/b")``) serves a route: the literal must be in the
        endpoint's ROUTES roster or it is an invisible, undocumented API
        surface. The variable must terminate in exactly ``path`` (the
        BaseHTTPRequestHandler convention) — ``opname == "/"`` in the
        UDF compiler never matches."""
        if self.known_routes is None:
            return
        operands = [node.left] + list(node.comparators)
        if not any(_terminal(o) == "path" for o in operands):
            return
        literals: List[ast.Constant] = []
        for o in operands:
            if isinstance(o, ast.Constant):
                literals.append(o)
            elif isinstance(o, (ast.Tuple, ast.List, ast.Set)):
                literals.extend(el for el in o.elts
                                if isinstance(el, ast.Constant))
        for lit in literals:
            if isinstance(lit.value, str) and lit.value.startswith("/") \
                    and lit.value not in self.known_routes:
                self._emit("TPU-L014", node,
                           f"HTTP route {lit.value!r} is not registered "
                           f"in the runtime/obs/endpoint.py ROUTES "
                           f"roster — register it so the endpoint index "
                           f"and generated docs stay complete")

    # -- TPU-L015 ----------------------------------------------------------

    def _check_reqtrace_names(self, node: ast.Call) -> None:
        """A ``request_span("...")`` literal names a phase of every
        request's exported timeline; a ``_v("...")`` literal (the
        verdict-decision checkpoint shape, meaningful only in the
        reqtrace/serving modules) names a tail-sampling outcome. Both
        vocabularies are operator-facing — they must live in the
        reqtrace rosters or they are invisible to the fleet tooling and
        the generated docs."""
        term = _terminal(node.func)
        if term == "request_span":
            # the module-level helper takes the name first; the
            # recorder method takes (ctx, name) — scan string-literal
            # positionals so both shapes register
            for arg in node.args[:2]:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    self.used_request_spans.add(arg.value)
                    if self.known_request_spans is not None \
                            and arg.value not in self.known_request_spans:
                        self._emit(
                            "TPU-L015", node,
                            f"request span {arg.value!r} is not "
                            f"registered in the runtime/obs/reqtrace.py "
                            f"REQUEST_SPANS roster — register it so "
                            f"per-request timelines and generated docs "
                            f"stay complete")
        elif term == "_v" and (
                "runtime/obs/" in self.relpath
                or "runtime/serving/" in self.relpath):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    self.used_verdicts.add(arg.value)
                    if self.known_verdicts is not None \
                            and arg.value not in self.known_verdicts:
                        self._emit(
                            "TPU-L015", node,
                            f"sampling verdict {arg.value!r} is not "
                            f"registered in the runtime/obs/reqtrace.py "
                            f"VERDICTS roster — register it so the "
                            f"verdict counter and generated docs stay "
                            f"complete")

    # -- TPU-L002 ----------------------------------------------------------

    def _check_threads(self, node: ast.Call) -> None:
        if self._in_host_pool:
            return
        term = _terminal(node.func)
        if term in ("ThreadPoolExecutor", "ProcessPoolExecutor"):
            self._emit("TPU-L002", node,
                       f"bare {term} — use runtime/host_pool.py "
                       f"(get_host_pool / run_task_wave)")
        elif term == "Thread":
            base = _base_name(node.func)
            if base in (None, "threading"):
                self._emit("TPU-L002", node,
                           "bare threading.Thread — use host_pool."
                           "spawn_service_thread for service threads")

    # -- TPU-L003 ----------------------------------------------------------

    def _check_timer_bypass(self, node: ast.Call) -> None:
        if not self._in_exec_layer:
            return
        if _terminal(node.func) == "ns" and not node.args \
                and not node.keywords:
            self._emit("TPU-L003", node,
                       "raw GpuMetric.ns() timer in the exec layer — "
                       "time device work with TorchExec.span(metric) so the "
                       "trace and the metric stay one instrumentation "
                       "point")

    # -- TPU-L004 ----------------------------------------------------------

    def _check_host_sync(self, node: ast.Call) -> None:
        if self._span_depth == 0:
            return
        term = _terminal(node.func)
        if term not in _SYNC_TERMINALS:
            return
        if term == "asarray":
            base = _base_name(node.func)
            if base not in ("np", "numpy"):
                return  # torch.as_tensor-like conversions stay put
        if term in ("item", "cpu", "tolist", "numpy", "synchronize") \
                and (node.args or node.keywords) \
                and not (term == "synchronize"
                         and _base_name(node.func) == "cuda"):
            return  # a dict's .item(k) or a call that is not the sync
        if self._annotated_deferred(node.lineno):
            return
        self._emit("TPU-L004", node,
                   f"device->host sync .{term}() inside a span'd timer "
                   f"body — defer it (start_d2h + consume after yield) or "
                   f"annotate '# tpulint: deferred-fetch <why>'")

    # -- TPU-L005 ----------------------------------------------------------

    def _check_defaults(self, node: ast.FunctionDef) -> None:
        for d in list(node.args.defaults) + [
                x for x in node.args.kw_defaults if x is not None]:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set") and not d.args
                and not d.keywords)
            if bad:
                self._emit("TPU-L005", d,
                           f"mutable default argument in {node.name}() — "
                           f"shared across calls; default to None")

    # -- TPU-L006 ----------------------------------------------------------

    def _check_swallowed(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if not broad:
            return
        if len(node.body) != 1 or not isinstance(node.body[0], ast.Pass):
            return
        # a justification comment on the except line (or the pass line)
        # documents the swallow as deliberate — the codebase convention is
        # '# noqa: BLE001 - <why>'
        for ln in range(node.lineno, node.body[0].lineno + 1):
            text = self._line(ln)
            if "#" in text and text.split("#", 1)[1].strip():
                return
        self._emit("TPU-L006", node,
                   "except Exception: pass with no justification comment "
                   "— handle it, narrow it, or document why swallowing "
                   "is safe")

    # -- TPU-L007 ----------------------------------------------------------

    def _check_metric_name(self, node: ast.Call) -> None:
        term = _terminal(node.func)
        if term == "metric":
            args = node.args
        elif term == "GpuMetric":
            args = node.args
        else:
            return
        if not args or not isinstance(args[0], ast.Constant) \
                or not isinstance(args[0].value, str):
            return
        name = args[0].value
        if name not in self.known_metrics:
            self._emit("TPU-L007", node,
                       f"metric name {name!r} is not registered in "
                       f"runtime/metrics.py (or the task-metric roster in "
                       f"runtime/trace.py) — register it so rollups and "
                       f"docs/torch_metrics.md stay complete")

    # -- TPU-L008 ----------------------------------------------------------

    def _check_fault_site(self, node: ast.Call) -> None:
        if self.known_sites is None:
            return
        term = _terminal(node.func)
        if term not in ("site", "site_bytes"):
            return
        base = _base_name(node.func)
        if base is None or base.lower() not in _FAULTS_BASES:
            return
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            return
        name = node.args[0].value
        if name not in self.known_sites:
            self._emit("TPU-L008", node,
                       f"fault site {name!r} is not registered in the "
                       f"runtime/faults.py SITES roster — register it so "
                       f"conf specs, /healthz counters, and chaos "
                       f"coverage know it exists")

    # -- TPU-L009 ----------------------------------------------------------

    def _check_attr_bucket(self, node: ast.Call) -> None:
        if self.known_buckets is None:
            return
        if _terminal(node.func) != "record":
            return
        base = _base_name(node.func)
        if base is None or base.lower() not in _ATTR_BASES:
            return
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            return
        name = node.args[0].value
        if name not in self.known_buckets:
            self._emit("TPU-L009", node,
                       f"attribution bucket {name!r} is not registered "
                       f"in the runtime/obs/attribution.py BUCKETS "
                       f"roster — register it so explain/history/"
                       f"metrics/docs attribution surfaces stay "
                       f"complete")


    # -- TPU-L011 ----------------------------------------------------------

    def _check_live_obs_names(self, node: ast.Call) -> None:
        """Query-state literals at transition() sites must be in the
        live.py STATES roster; sampler-series literals at
        series_point()/sample_series() sites in the sampler.py SERIES
        roster. `transition` needs no receiver guard: the name is the
        QueryContext state-machine verb in this codebase (grep-verified
        unique), and a future non-state transition() can suppress."""
        term = _terminal(node.func)
        if term == "transition":
            roster, kind, home = (self.known_states, "query state",
                                  "runtime/obs/live.py STATES")
        elif term in ("series_point", "sample_series"):
            roster, kind, home = (self.known_series, "sampler series",
                                  "runtime/obs/sampler.py SERIES")
        else:
            return
        if roster is None:
            return
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            return
        name = node.args[0].value
        if name not in roster:
            self._emit("TPU-L011", node,
                       f"{kind} {name!r} is not registered in the "
                       f"{home} roster — register it so the live "
                       f"console, /queries, /metrics gauges and flight "
                       f"dumps stay complete")

    # -- TPU-L012 ----------------------------------------------------------

    def _check_unbounded_wait(self, node: ast.Call) -> None:
        """``<event-or-condition>.wait()`` with no timeout parks its
        thread until someone else's set()/notify() — forever, if the
        query that owns the work was cancelled. Outside the waiter-
        protocol internals every such site must either be rebuilt
        cancellation-aware or justify itself with
        '# tpulint: uncancellable <why>'."""
        if self._wait_sanctioned:
            return
        func = node.func
        if not isinstance(func, ast.Attribute) or func.attr != "wait":
            return
        args = list(node.args) + [kw.value for kw in node.keywords]
        if args and not any(isinstance(a, ast.Constant)
                            and a.value is None for a in args):
            return  # a timeout argument bounds the park — but a literal
            # None timeout (Event.wait(None) blocks forever) does not
        if self._annotated_uncancellable(node.lineno):
            return
        self._emit("TPU-L012", node,
                   "unbounded blocking .wait() — register the event as "
                   "a cancel-token waiter (runtime/lifecycle.py), wait "
                   "in bounded slices with lifecycle.check_current() "
                   "between them, or annotate "
                   "'# tpulint: uncancellable <why>'")

    # -- TPU-L010 ----------------------------------------------------------

    def _check_jit_decorators(self, node: ast.FunctionDef) -> None:
        """Bare ``@torch.compile`` / ``@torch.jit.script`` decorators are
        Attribute nodes, not Calls: the Call visitor never sees them
        (``@torch.compile(...)`` is a Call and routes through
        _check_compile_entry)."""
        if self._in_compile_cache:
            return
        for dec in node.decorator_list:
            if isinstance(dec, ast.Attribute) and _torch_compile_entry(dec):
                self._emit("TPU-L010", dec,
                           f"@{_dotted(dec)} decorator outside "
                           f"runtime/compile_cache.py — compiled entries "
                           f"route through the sanctioned choke point")

    def _check_compile_entry(self, node: ast.Call) -> None:
        if self._in_compile_cache:
            return
        func = node.func
        if _is_build_load(func):
            if not self._load_sanctioned:
                self._emit("TPU-L010", node,
                           "_build.load outside the sanctioned kernel "
                           "modules (compile_cache.SANCTIONED_KERNEL_"
                           "MODULES) — hand kernels load there so every "
                           "build stays counted and audited")
            return
        hit = isinstance(func, ast.Attribute) and _torch_compile_entry(func)
        if not hit and _terminal(func) == "partial" and node.args:
            # partial(torch.compile, ...) / functools.partial(...)
            a0 = node.args[0]
            hit = isinstance(a0, ast.Attribute) and _torch_compile_entry(a0)
        if not hit and _terminal(func) == "capture_begin":
            hit = True  # a CUDAGraph's manual capture
        if hit:
            self._emit("TPU-L010", node,
                       f"{_dotted(func)}() outside runtime/compile_cache.py "
                       f"— route compiled entries through the keyed stage "
                       f"cache so its counters, the attribution and "
                       f"warmup see them")

    # -- TPU-L013 ----------------------------------------------------------

    def _kernel_site(self, node: ast.AST) -> None:
        """A kernel-emitting site (an _build.load of a CUDA source): the
        containing module must be in the kernel cost auditor's
        KERNEL_PRIMITIVES roster."""
        if self.kernel_modules is None or self._in_compile_cache \
                or self._in_analysis:
            return
        if self.relpath in self.kernel_modules:
            return
        self._emit("TPU-L013", node,
                   f"kernel-emitting module {self.relpath!r} is not "
                   f"registered in the analysis/kernel_audit.py "
                   f"KERNEL_PRIMITIVES roster — register it so the "
                   f"audit's coverage statement stays true and the "
                   f"golden cost-signature artifact tracks it")

    def _check_kernel_roster(self, node: ast.Call) -> None:
        if _is_build_load(node.func) \
                and _loads_kernel(node, self.kernel_sources):
            self._kernel_site(node)

    # -- TPU-L016 ----------------------------------------------------------

    def _check_collective_site(self, node: ast.Call) -> None:
        """A mesh collective (the lane exchange, the broadcast, the shard
        sum) or a ``torch.distributed`` call moves data between shards:
        confining its call sites to the rostered exchange/planner modules
        keeps the shard contract local (the TPU-L010 confinement
        pattern)."""
        if self.collective_modules is None:
            return
        if not _is_collective_call(node.func):
            return
        if self.relpath in self.collective_modules:
            return
        self._emit("TPU-L016", node,
                   f"collective {_dotted(node.func)}() in unrostered "
                   f"module {self.relpath!r} — collectives live in the "
                   f"parallel/mesh.py SANCTIONED_COLLECTIVE_MODULES "
                   f"roster so the shard contract stays local")


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for an Attribute chain (best effort)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _chain(node: ast.AST) -> List[str]:
    return _dotted(node).split(".")


def _torch_compile_entry(func: ast.Attribute) -> bool:
    """torch.compile, torch.jit.<anything>, torch.cuda.graph /
    CUDAGraph / make_graphed_callables."""
    chain = _chain(func)
    if len(chain) >= 2 and (chain[-2], chain[-1]) in _TORCH_COMPILE:
        return True
    return "jit" in chain[:-1] and chain[0] in ("torch", "_torch")


def _is_build_load(func: ast.AST) -> bool:
    return isinstance(func, ast.Attribute) and func.attr == "load" \
        and (_base_name(func) or "") in _BUILD_BASES


def _loads_kernel(node: ast.Call, kernel_sources: Optional[Set[str]]) -> bool:
    """An _build.load call of a CUDA source: its literal names a
    csrc/<name>.cu (without the source list every load counts)."""
    if kernel_sources is None:
        return True
    arg = node.args[0] if node.args else None
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value in kernel_sources
    return True  # a computed name may be a kernel


def _is_collective_call(func: ast.AST) -> bool:
    if _terminal(func) in _COLLECTIVE_TERMINALS:
        return True
    chain = _chain(func)
    return len(chain) >= 2 and any(p in _DIST_BASES for p in chain[:-1])


# ---------------------------------------------------------------------------
# Registry extraction (AST-only: no engine import)
# ---------------------------------------------------------------------------

def known_metric_names(pkg_root: str) -> Set[str]:
    """Registered metric names: module-level string constants in
    runtime/metrics.py plus the TASK_METRIC_NAMES roster in
    runtime/trace.py."""
    names: Set[str] = set()
    mpath = os.path.join(pkg_root, "runtime", "metrics.py")
    tree = ast.parse(open(mpath).read(), mpath)
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Constant) and isinstance(
                stmt.value.value, str):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id.isupper():
                    names.add(stmt.value.value)
    tpath = os.path.join(pkg_root, "runtime", "trace.py")
    ttree = ast.parse(open(tpath).read(), tpath)
    for stmt in ttree.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) \
                        and tgt.id == "TASK_METRIC_NAMES" \
                        and isinstance(stmt.value, (ast.Tuple, ast.List)):
                    for el in stmt.value.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                                el.value, str):
                            names.add(el.value)
    return names


def known_fault_sites(pkg_root: str) -> Set[str]:
    """Registered fault-site names: the keys of the SITES dict literal in
    runtime/faults.py (AST-only, like known_metric_names)."""
    sites: Set[str] = set()
    fpath = os.path.join(pkg_root, "runtime", "faults.py")
    if not os.path.exists(fpath):
        return sites
    tree = ast.parse(open(fpath).read(), fpath)
    for stmt in tree.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else []
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == "SITES" \
                    and isinstance(getattr(stmt, "value", None), ast.Dict):
                for k in stmt.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        sites.add(k.value)
    return sites


def known_attr_buckets(pkg_root: str) -> Set[str]:
    """Registered attribution-bucket names: the keys of the BUCKETS dict
    literal in runtime/obs/attribution.py (AST-only, like
    known_fault_sites)."""
    buckets: Set[str] = set()
    apath = os.path.join(pkg_root, "runtime", "obs", "attribution.py")
    if not os.path.exists(apath):
        return buckets
    tree = ast.parse(open(apath).read(), apath)
    for stmt in tree.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else []
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == "BUCKETS" \
                    and isinstance(getattr(stmt, "value", None), ast.Dict):
                for k in stmt.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        buckets.add(k.value)
    return buckets


def _dict_literal_keys(path: str, var_name: str) -> Set[str]:
    """Keys of a module-level ``VAR = {...}`` dict literal (AST-only,
    the known_fault_sites/known_attr_buckets pattern factored out)."""
    keys: Set[str] = set()
    if not os.path.exists(path):
        return keys
    tree = ast.parse(open(path).read(), path)
    for stmt in tree.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else []
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == var_name \
                    and isinstance(getattr(stmt, "value", None), ast.Dict):
                for k in stmt.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        keys.add(k.value)
    return keys


def known_query_states(pkg_root: str) -> Set[str]:
    """Registered query-state names: the keys of the STATES dict literal
    in runtime/obs/live.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "runtime", "obs", "live.py"), "STATES")


def known_sampler_series(pkg_root: str) -> Set[str]:
    """Registered sampler-series names: the keys of the SERIES dict
    literal in runtime/obs/sampler.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "runtime", "obs", "sampler.py"), "SERIES")


def known_http_routes(pkg_root: str) -> Set[str]:
    """Registered HTTP routes: the keys of the ROUTES dict literal in
    runtime/obs/endpoint.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "runtime", "obs", "endpoint.py"), "ROUTES")


def endpoint_served_routes(path: str) -> Set[str]:
    """Route literals a handler actually dispatches on: string constants
    compared against a ``path`` variable (the visit_Compare shape).
    Used for the stale-roster half of TPU-L014 — the ROUTES dict itself
    contains every literal, so a plain substring scan would be
    vacuous."""
    served: Set[str] = set()
    if not os.path.exists(path):
        return served
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left] + list(node.comparators)
        if not any(_terminal(o) == "path" for o in operands):
            continue
        for o in operands:
            lits = [o] if isinstance(o, ast.Constant) else (
                list(o.elts) if isinstance(o, (ast.Tuple, ast.List,
                                               ast.Set)) else [])
            for lit in lits:
                if isinstance(lit, ast.Constant) \
                        and isinstance(lit.value, str) \
                        and lit.value.startswith("/"):
                    served.add(lit.value)
    return served


def known_request_spans(pkg_root: str) -> Set[str]:
    """Registered serving request-span names: the keys of the
    REQUEST_SPANS dict literal in runtime/obs/reqtrace.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "runtime", "obs", "reqtrace.py"),
        "REQUEST_SPANS")


def known_reqtrace_verdicts(pkg_root: str) -> Set[str]:
    """Registered tail-sampling verdicts: the keys of the VERDICTS dict
    literal in runtime/obs/reqtrace.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "runtime", "obs", "reqtrace.py"),
        "VERDICTS")


def known_collective_modules(pkg_root: str) -> Set[str]:
    """Registered collective-calling modules: the keys of the
    SANCTIONED_COLLECTIVE_MODULES dict literal in parallel/mesh.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "parallel", "mesh.py"),
        "SANCTIONED_COLLECTIVE_MODULES")


def module_uses_collectives(path: str) -> bool:
    """Does a module call or define a collective (the mesh's collectives,
    a torch.distributed call)? Used for the stale-roster half of
    TPU-L016."""
    if not os.path.exists(path):
        return False
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_collective_call(node.func):
            return True
        if isinstance(node, ast.FunctionDef) \
                and node.name in _COLLECTIVE_TERMINALS:
            return True
    return False


def known_kernel_primitives(pkg_root: str) -> Set[str]:
    """Registered kernel-emitting modules: the keys of the
    KERNEL_PRIMITIVES dict literal in analysis/kernel_audit.py."""
    return _dict_literal_keys(
        os.path.join(pkg_root, "analysis", "kernel_audit.py"),
        "KERNEL_PRIMITIVES")


def kernel_sources(pkg_root: str) -> Set[str]:
    """Names of the CUDA sources a ``_build.load`` may name
    (``csrc/<name>.cu``)."""
    d = os.path.join(pkg_root, "csrc")
    if not os.path.isdir(d):
        return set()
    return {f[:-3] for f in os.listdir(d) if f.endswith(".cu")}


def module_emits_kernels(path: str,
                         sources: Optional[Set[str]] = None) -> bool:
    """Does a module contain a kernel-emitting site (an _build.load of a
    CUDA source)? Used for the stale-roster half of TPU-L013."""
    if not os.path.exists(path):
        return False
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_build_load(node.func) \
                and _loads_kernel(node, sources):
            return True
    return False


def known_kernel_load_modules(pkg_root: str) -> Set[str]:
    """Modules allowed to contain ``_build.load`` sites: the
    SANCTIONED_KERNEL_MODULES tuple in runtime/compile_cache.py
    (AST-only, like known_fault_sites)."""
    mods: Set[str] = set()
    cpath = os.path.join(pkg_root, "runtime", "compile_cache.py")
    if not os.path.exists(cpath):
        return mods
    tree = ast.parse(open(cpath).read(), cpath)
    for stmt in tree.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else []
        for tgt in targets:
            if isinstance(tgt, ast.Name) \
                    and tgt.id == "SANCTIONED_KERNEL_MODULES" \
                    and isinstance(getattr(stmt, "value", None),
                                   (ast.Tuple, ast.List)):
                for el in stmt.value.elts:
                    if isinstance(el, ast.Constant) and isinstance(
                            el.value, str):
                        mods.add(el.value)
    return mods


#: the port's generated document (tools/torch_gen_docs.py)
DOCS = os.path.join("docs", "torch_metrics.md")


def docs_metric_names(repo_root: str) -> Optional[Set[str]]:
    """Metric names documented in docs/torch_metrics.md (None when the
    file is missing — the doc-presence half of TPU-L007 then reports
    once)."""
    path = os.path.join(repo_root, DOCS)
    if not os.path.exists(path):
        return None
    found = set()
    # path-like tokens (ops/kernels.py) are roster entries for the
    # TPU-L013 docs-presence half, hence the "/" in the class
    for m in re.finditer(r"`([A-Za-z][A-Za-z0-9_./]*)`",
                         open(path).read()):
        found.add(m.group(1))
    return found


def docs_route_names(repo_root: str) -> Optional[Set[str]]:
    """HTTP routes documented in docs/torch_metrics.md (backtick tokens
    starting with '/' — docs_metric_names' leading-letter class cannot
    match them). None when the file is missing."""
    path = os.path.join(repo_root, DOCS)
    if not os.path.exists(path):
        return None
    return {m.group(1) for m in
            re.finditer(r"`(/[A-Za-z0-9_./<>-]*)`", open(path).read())}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str, known_metrics: Set[str],
                relpath: Optional[str] = None,
                known_sites: Optional[Set[str]] = None,
                known_buckets: Optional[Set[str]] = None,
                pallas_modules: Optional[Set[str]] = None,
                known_states: Optional[Set[str]] = None,
                known_series: Optional[Set[str]] = None,
                kernel_modules: Optional[Set[str]] = None,
                known_routes: Optional[Set[str]] = None,
                known_request_spans: Optional[Set[str]] = None,
                known_verdicts: Optional[Set[str]] = None,
                collective_modules: Optional[Set[str]] = None,
                collect: Optional[dict] = None,
                kernel_sources: Optional[Set[str]] = None
                ) -> List[Violation]:
    tree = ast.parse(source, path)
    linter = _FileLinter(path, source, known_metrics,
                         relpath if relpath is not None else path,
                         known_sites=known_sites,
                         known_buckets=known_buckets,
                         pallas_modules=pallas_modules,
                         known_states=known_states,
                         known_series=known_series,
                         kernel_modules=kernel_modules,
                         known_routes=known_routes,
                         known_request_spans=known_request_spans,
                         known_verdicts=known_verdicts,
                         collective_modules=collective_modules,
                         kernel_sources=kernel_sources)
    linter.visit(tree)
    if collect is not None:
        # cross-file usage aggregation (the TPU-L015 stale half needs
        # every call site in the tree, not just this file's)
        collect.setdefault("request_spans", set()).update(
            linter.used_request_spans)
        collect.setdefault("verdicts", set()).update(linter.used_verdicts)
    return linter.violations


def lint_tree(repo_root: str) -> Tuple[List[Violation], Dict[str, int]]:
    """Lint every .py under spark_rapids_tpu_torch/. Returns (violations,
    stats). Also cross-checks registered metric names against
    docs/torch_metrics.md (the docs half of TPU-L007)."""
    pkg_root = os.path.join(repo_root, "spark_rapids_tpu_torch")
    known = known_metric_names(pkg_root)
    sites = known_fault_sites(pkg_root)
    buckets = known_attr_buckets(pkg_root)
    pallas_mods = known_kernel_load_modules(pkg_root)
    ksources = kernel_sources(pkg_root)
    states = known_query_states(pkg_root)
    series = known_sampler_series(pkg_root)
    kernel_mods = known_kernel_primitives(pkg_root)
    routes = known_http_routes(pkg_root)
    req_spans = known_request_spans(pkg_root)
    verdicts = known_reqtrace_verdicts(pkg_root)
    coll_mods = known_collective_modules(pkg_root)
    used: dict = {}
    violations: List[Violation] = []
    n_files = 0
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            n_files += 1
            rel = os.path.relpath(path, pkg_root)
            violations.extend(lint_source(
                open(path).read(), path, known, relpath=rel,
                known_sites=sites, known_buckets=buckets,
                pallas_modules=pallas_mods,
                known_states=states, known_series=series,
                kernel_modules=kernel_mods, known_routes=routes,
                known_request_spans=req_spans, known_verdicts=verdicts,
                collective_modules=coll_mods, collect=used,
                kernel_sources=ksources))
    # the stale half of TPU-L013: a roster entry whose module no longer
    # exists or no longer emits kernels claims audit coverage that
    # isn't there
    kapath = os.path.join(pkg_root, "analysis", "kernel_audit.py")
    for mod in sorted(kernel_mods):
        mpath2 = os.path.join(pkg_root, mod.replace("/", os.sep))
        if not os.path.exists(mpath2):
            violations.append(Violation(
                "TPU-L013", kapath, 1,
                f"KERNEL_PRIMITIVES roster entry {mod!r} names a "
                f"module that does not exist"))
        elif not module_emits_kernels(mpath2, ksources):
            violations.append(Violation(
                "TPU-L013", kapath, 1,
                f"KERNEL_PRIMITIVES roster entry {mod!r} has no "
                f"_build.load site of a CUDA source — stale entry"))
    # the stale half of TPU-L014: a ROUTES entry no handler dispatch
    # literal serves claims an API surface that isn't there. Templated
    # routes (<id> segments) dispatch through a regex, not a literal —
    # skip them.
    eppath = os.path.join(pkg_root, "runtime", "obs", "endpoint.py")
    served = endpoint_served_routes(eppath)
    for route in sorted(routes):
        if "<" in route:
            continue
        if route not in served:
            violations.append(Violation(
                "TPU-L014", eppath, 1,
                f"ROUTES roster entry {route!r} matches no handler "
                f"path comparison in runtime/obs/endpoint.py — stale "
                f"entry"))
    # the stale half of TPU-L015: a roster entry no request_span()/_v()
    # call site uses claims a timeline phase / verdict that never occurs
    rtpath = os.path.join(pkg_root, "runtime", "obs", "reqtrace.py")
    for name in sorted(req_spans - used.get("request_spans", set())):
        violations.append(Violation(
            "TPU-L015", rtpath, 1,
            f"REQUEST_SPANS roster entry {name!r} matches no "
            f"request_span(...) call site — stale entry"))
    for name in sorted(verdicts - used.get("verdicts", set())):
        violations.append(Violation(
            "TPU-L015", rtpath, 1,
            f"VERDICTS roster entry {name!r} matches no _v(...) "
            f"verdict checkpoint — stale entry"))
    # the stale half of TPU-L016: a SANCTIONED_COLLECTIVE_MODULES entry
    # whose module no longer exists or no longer calls a collective
    # licenses SPMD surface area that isn't there
    mshpath = os.path.join(pkg_root, "parallel", "mesh.py")
    for mod in sorted(coll_mods):
        cpath2 = os.path.join(pkg_root, mod.replace("/", os.sep))
        if not os.path.exists(cpath2):
            violations.append(Violation(
                "TPU-L016", mshpath, 1,
                f"SANCTIONED_COLLECTIVE_MODULES roster entry {mod!r} "
                f"names a module that does not exist"))
        elif not module_uses_collectives(cpath2):
            violations.append(Violation(
                "TPU-L016", mshpath, 1,
                f"SANCTIONED_COLLECTIVE_MODULES roster entry {mod!r} "
                f"neither calls nor defines a collective — stale entry"))
    documented = docs_metric_names(repo_root)
    mpath = os.path.join(pkg_root, "runtime", "metrics.py")
    if documented is None:
        violations.append(Violation(
            "TPU-L007", mpath, 1,
            "docs/torch_metrics.md is missing — regenerate with "
            "'python tools/torch_gen_docs.py'"))
    else:
        for name in sorted(known - documented):
            violations.append(Violation(
                "TPU-L007", mpath, 1,
                f"registered metric {name!r} absent from docs/torch_metrics.md "
                f"— regenerate with 'python tools/torch_gen_docs.py'"))
        apath = os.path.join(pkg_root, "runtime", "obs", "attribution.py")
        for name in sorted(buckets - documented):
            violations.append(Violation(
                "TPU-L009", apath, 1,
                f"attribution bucket {name!r} absent from "
                f"docs/torch_metrics.md — regenerate with "
                f"'python tools/torch_gen_docs.py'"))
        lpath = os.path.join(pkg_root, "runtime", "obs", "live.py")
        for name in sorted(states - documented):
            violations.append(Violation(
                "TPU-L011", lpath, 1,
                f"query state {name!r} absent from docs/torch_metrics.md — "
                f"regenerate with 'python tools/torch_gen_docs.py'"))
        spath = os.path.join(pkg_root, "runtime", "obs", "sampler.py")
        for name in sorted(series - documented):
            violations.append(Violation(
                "TPU-L011", spath, 1,
                f"sampler series {name!r} absent from docs/torch_metrics.md "
                f"— regenerate with 'python tools/torch_gen_docs.py'"))
        for mod in sorted(kernel_mods - documented):
            violations.append(Violation(
                "TPU-L013", kapath, 1,
                f"kernel-primitive module {mod!r} absent from "
                f"docs/torch_metrics.md — regenerate with "
                f"'python tools/torch_gen_docs.py'"))
        documented_routes = docs_route_names(repo_root) or set()
        for route in sorted(routes - documented_routes):
            violations.append(Violation(
                "TPU-L014", eppath, 1,
                f"HTTP route {route!r} absent from docs/torch_metrics.md — "
                f"regenerate with 'python tools/torch_gen_docs.py'"))
        for name in sorted(req_spans - documented):
            violations.append(Violation(
                "TPU-L015", rtpath, 1,
                f"request span {name!r} absent from docs/torch_metrics.md — "
                f"regenerate with 'python tools/torch_gen_docs.py'"))
        for name in sorted(verdicts - documented):
            violations.append(Violation(
                "TPU-L015", rtpath, 1,
                f"sampling verdict {name!r} absent from docs/torch_metrics.md "
                f"— regenerate with 'python tools/torch_gen_docs.py'"))
        for mod in sorted(coll_mods - documented):
            violations.append(Violation(
                "TPU-L016", mshpath, 1,
                f"collective module {mod!r} absent from docs/torch_metrics.md "
                f"— regenerate with 'python tools/torch_gen_docs.py'"))
    stats = {
        "files": n_files,
        "violations": sum(1 for v in violations if not v.suppressed),
        "suppressed": sum(1 for v in violations if v.suppressed),
        "suppressions_without_reason": sum(
            1 for v in violations if v.suppressed and not v.reason),
    }
    return violations, stats
