"""Column pruning (counterpart of ``spark_rapids_tpu/plan/prune.py``; the
reference is Catalyst's ColumnPruning and CollapseProject, which Spark
runs before the plugin sees a plan: this engine owns its logical plans,
so it runs the pass itself).

A join gathers every column of both sides through its pairs, and a window
sorts and then gathers every input column: dropping the columns nobody
reads before those operators saves one full-capacity gather per column.
An aggregate over a projection evaluates the projection's expressions in
its own update, so the projected batch is never written.

Three rewrites, applied bottom-up by ``prune_plan``:
- Project(Join(l, r)): push the used columns below the join;
- Project(Window(c)): push the used columns below the window;
- Aggregate(Project(c)) -> Aggregate'(c): substitute the projection's
  expressions into the keys and inputs, when they are deterministic and
  context-free.
The first two rebuild the inner node with remapped BoundRefs and keep the
outer Project's schema as it was.
"""
from __future__ import annotations

from typing import Dict, List, Set

from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.plan import nodes as P


def _refs(e, out: Set[int]) -> None:
    if isinstance(e, E.BoundRef):
        out.add(e.index)
    for c in e.children:
        _refs(c, out)


def _remap(e, m: Dict[int, int]):
    def f(x):
        if isinstance(x, E.BoundRef):
            return E.BoundRef(m[x.index], x.dtype, x.name)
        return x
    return e.transform(f)


def _subset_project(child: P.PlanNode, used: List[int]) -> P.PlanNode:
    fields = child.schema.fields
    exprs = [E.BoundRef(i, fields[i].dtype, fields[i].name) for i in used]
    return P.Project(exprs, child)


def _clone_project(old: P.Project, new_child: P.PlanNode,
                   new_exprs) -> P.Project:
    q = P.Project.__new__(P.Project)
    q.children = [new_child]
    q.exprs = new_exprs
    q.names = old.names
    return q


def _prune_join(p: P.Project, j: P.Join):
    if j.how in ("left_semi", "left_anti"):
        return p  # the output is the left schema only: nothing to split
    left, right = j.children
    nl = len(left.schema.fields)
    nr = len(right.schema.fields)
    out_used: Set[int] = set()
    for e in p.exprs:
        _refs(e, out_used)
    cond_used: Set[int] = set()
    if j.condition is not None:
        _refs(j.condition, cond_used)
    used_l: Set[int] = {i for i in out_used | cond_used if i < nl}
    used_r: Set[int] = {i - nl for i in out_used | cond_used if i >= nl}
    for e in j.left_keys:
        _refs(e, used_l)
    for e in j.right_keys:
        _refs(e, used_r)
    if len(used_l) >= nl and len(used_r) >= nr:
        return p
    ul, ur = sorted(used_l), sorted(used_r)
    ml = {old: new for new, old in enumerate(ul)}
    mr = {old: new for new, old in enumerate(ur)}
    nj = P.Join.__new__(P.Join)
    nj.children = [_subset_project(left, ul) if len(ul) < nl else left,
                   _subset_project(right, ur) if len(ur) < nr else right]
    nj.left_keys = [_remap(e, ml) for e in j.left_keys]
    nj.right_keys = [_remap(e, mr) for e in j.right_keys]
    nj.how = j.how
    mc = {**{o: ml[o] for o in ul},
          **{o + nl: mr[o] + len(ul) for o in ur}}
    nj.condition = (_remap(j.condition, mc)
                    if j.condition is not None else None)
    return _clone_project(p, nj, [_remap(e, mc) for e in p.exprs])


def _prune_window(p: P.Project, w: P.WindowNode):
    from spark_rapids_tpu_torch.expr.window import WindowExpr, WindowSpec
    child = w.children[0]
    nc = len(child.schema.fields)
    out_used: Set[int] = set()
    for e in p.exprs:
        _refs(e, out_used)
    used_c: Set[int] = {i for i in out_used if i < nc}
    for we in w.window_exprs:
        for e in we.spec.partition_exprs:
            _refs(e, used_c)
        for o in we.spec.order_specs:
            _refs(o.expr, used_c)
        for e in we.fn.children:
            _refs(e, used_c)
    if len(used_c) >= nc:
        return p
    uc = sorted(used_c)
    m = {old: new for new, old in enumerate(uc)}
    nw = P.WindowNode.__new__(P.WindowNode)
    nw.children = [_subset_project(child, uc)]
    nw.names = w.names
    nexprs = []
    for we in w.window_exprs:
        spec = WindowSpec([_remap(e, m) for e in we.spec.partition_exprs],
                          [P.SortOrder(_remap(o.expr, m), o.ascending,
                                       o.nulls_first)
                           for o in we.spec.order_specs],
                          we.spec.frame)
        nexprs.append(WindowExpr(_remap(we.fn, m), spec))
    nw.window_exprs = nexprs
    # the outer projection: child columns remap, the appended window
    # columns shift down
    mo = dict(m)
    for j_ in range(len(w.window_exprs)):
        mo[nc + j_] = len(uc) + j_
    return _clone_project(p, nw, [_remap(e, mo) for e in p.exprs])


def _absorbable_project(pr: P.Project) -> bool:
    """A Project folds into its consumer only when its expressions are
    deterministic and context-free: the partition context
    (spark_partition_id, monotonically_increasing_id) and rand evaluate
    with state an aggregate's update does not carry, and the UDF tiers
    (a row UDF runs in a CPU Project of its own, a torch UDF once per
    batch of the Project that names it), so a Project holding a UDF
    stays above the aggregate."""
    from spark_rapids_tpu_torch.plan.overrides import PROJECT_ONLY_EXPRS

    def bad(e) -> bool:
        if type(e).__name__ in ("PythonRowUDF", "TorchColumnarUDF"):
            return True
        return isinstance(e, PROJECT_ONLY_EXPRS) \
            or any(bad(c) for c in e.children)

    return not any(bad(e) for e in pr.exprs)


def _absorb_project_into_agg(a: P.Aggregate, pr: P.Project) -> P.Aggregate:
    """Aggregate(Project(c)) -> Aggregate'(c): the projection's expressions
    replace the references to its columns in the keys and the aggregate
    inputs, so they are evaluated inside the aggregate's update and the
    projected batch never exists."""
    def subst(e):
        def f(x):
            if isinstance(x, E.BoundRef):
                return pr.exprs[x.index]
            return x
        return e.transform(f)

    na = P.Aggregate.__new__(P.Aggregate)
    na.children = [pr.children[0]]
    na.group_exprs = [subst(e) for e in a.group_exprs]
    na.group_names = list(a.group_names)
    na.aggs = [ag.transform(lambda n: subst(n) if isinstance(n, E.BoundRef)
                            else n) for ag in a.aggs]
    return na


def prune_plan(p: P.PlanNode) -> P.PlanNode:
    """Bottom-up pruning. Replaces children in place (a rewritten subtree
    computes the same rows, so a subtree shared with another plan stays
    sound) and returns the node, rewritten or not."""
    p.children = [prune_plan(c) for c in p.children]
    if isinstance(p, P.Project):
        c = p.children[0]
        if isinstance(c, P.Join):
            return _prune_join(p, c)
        if isinstance(c, P.WindowNode):
            return _prune_window(p, c)
    if isinstance(p, P.Aggregate):
        c = p.children[0]
        if isinstance(c, P.Project) and _absorbable_project(c):
            return _absorb_project_into_agg(p, c)
    return p
