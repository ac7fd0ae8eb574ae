"""Expression lists as one stage: the other per-batch dispatch path.

Counterpart of ``spark_rapids_tpu/exec/compiled.py``. ``run_stage``
evaluates an expression list over a batch through a function resolved in
the keyed stage cache (``runtime/compile_cache.py``) by (expression
fingerprints, batch capacity, ANSI, device). It passes the cancel
checkpoint, reports itself to the dispatch-budget hook
(``fuse.notify_dispatch``) and opens a trace span, as the JAX package's
does. Port difference: the function runs eagerly; nothing is traced.

ANSI errors come back as (code, mask) planes; ``raise_errors`` raises the
first that any live row hit (one sync per plane, only in ANSI mode).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnVector, ColumnarBatch
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.runtime import compile_cache as _cc


def _stage_builder(exprs, device, ansi: bool):
    def build():
        def stage(batch):
            ctx = E.EvalCtx(batch.columns, batch.num_rows, batch.capacity,
                            device, ansi, live=batch.live_mask())
            outs = [e.eval(ctx) for e in exprs]
            return outs, list(ctx.errors)
        return stage
    return build


def run_stage(exprs: Sequence[E.Expression], batch: ColumnarBatch,
              device, ansi: bool = False) -> List[ColumnVector]:
    """Evaluate expressions over a batch as one stage. Passthrough column
    references keep their input column's bounds; no other output carries
    any."""
    fp = tuple(e.fingerprint() for e in exprs)
    key = (fp, batch.capacity, ansi, str(device))
    fn = _cc.get("run_stage", key, _stage_builder(list(exprs), device, ansi))
    from spark_rapids_tpu_torch.exec import fuse
    from spark_rapids_tpu_torch.runtime import lifecycle as _lc
    from spark_rapids_tpu_torch.runtime import trace as TR
    _lc.check_current()  # run_stage is the other per-batch dispatch path
    fuse.notify_dispatch(("run_stage", fp))
    with TR.span("compiled.run_stage", cat="dispatch", level=TR.DEBUG,
                 args={"exprs": len(exprs)}):
        outs, errs = fn(batch)
    raise_errors(errs)
    outs = [_without_bounds(o) for o in outs]
    carry_bounds(exprs, batch.columns, outs)
    return outs


def _without_bounds(c: ColumnVector) -> ColumnVector:
    import dataclasses
    return dataclasses.replace(c, bounds=None) if c.bounds is not None \
        else c


def carry_bounds(exprs, in_cols, out_cols) -> None:
    """Carry column-stat bounds (host metadata) across a stage for
    passthrough column references."""
    for e, o in zip(exprs, out_cols):
        inner = e.children[0] if isinstance(e, E.Alias) else e
        if isinstance(inner, E.BoundRef) and inner.index < len(in_cols):
            o.bounds = in_cols[inner.index].bounds


def raise_errors(err) -> None:
    """Check a stage's ANSI error planes: a list of (code, mask), or the
    JAX package's dict of them. Syncs only when there are planes."""
    if err:
        E.raise_errors(list(err.items()) if isinstance(err, dict)
                       else err)


def run_projection(exprs: Sequence[E.Expression], batch: ColumnarBatch,
                   device, ansi: bool = False) -> ColumnarBatch:
    cols = run_stage(exprs, batch, device, ansi)
    return ColumnarBatch(cols, batch.num_rows, batch.row_mask)


def can_compile(e: E.Expression) -> Tuple[bool, str]:
    """Best-effort static check that an expression runs on the device;
    the overrides engine uses this with its registry checks."""
    sup = getattr(e, "supported_on_tpu", None)
    if sup is not None and not sup():
        return False, f"{type(e).__name__} not supported on the device"
    for c in e.children:
        ok, why = can_compile(c)
        if not ok:
            return False, why
    return True, ""
