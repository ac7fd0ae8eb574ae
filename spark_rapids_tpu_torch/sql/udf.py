"""User-defined functions (counterpart of ``spark_rapids_tpu/sql/udf.py``).

Reference parity, three tiers mirroring SURVEY.md §2.8:

- ``udf(fn, return_type)`` — row-wise Python UDF. Like Spark UDFs it is
  opaque; it executes on the CPU interpreter via per-operator fallback
  (the reference's row-based UDF bridge), on the worker pool
  (``runtime/pyworker.py``) once a batch is large enough. With
  spark.rapids.sql.udfCompiler.enabled its bytecode is first translated
  into device expressions (``sql/udf_compiler.py``).
- ``torch_udf(fn, return_type)`` — the RapidsUDF.evaluateColumnar analog:
  fn maps torch value/validity tensors on the batch's device to values,
  or to (values, validity), and runs inside the operator that evaluates
  it, one call per batch.
- ``df_udf`` style — because expressions are first-class Python objects,
  any function composing Column expressions already IS a df_udf
  (reference sql-plugin-api functions.scala / DF_UDF_README.md); no
  bytecode translation layer is needed.
"""
from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr.core import CpuCol, Expression, _valid_of


class PythonRowUDF(Expression):
    """Opaque row-wise UDF: CPU-only (per-operator fallback runs it)."""

    def __init__(self, fn: Callable, return_type: T.DataType,
                 children: List[Expression], name: str = ""):
        self.fn = fn
        self.return_type = return_type
        self.children = list(children)
        self.name = name or getattr(fn, "__name__", "udf")

    def data_type(self):
        return self.return_type

    def _params(self):
        return f"{self.name}@{id(self.fn):x}"

    def with_children(self, children):
        return PythonRowUDF(self.fn, self.return_type, children, self.name)

    def eval(self, ctx):
        raise NotImplementedError(
            f"python UDF {self.name!r} is opaque; runs on CPU "
            f"(write a torch_udf for device execution)")

    def eval_cpu(self, cols, ansi=False):
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        n = len(ins[0].values) if ins else 0
        rows = [tuple(c.values[i] if c.valid[i] else None for c in ins)
                for i in range(n)]
        out = None
        conf = C.session_conf()
        if conf.get(C.PY_WORKER_POOL_ENABLED):
            from spark_rapids_tpu_torch.runtime import pyworker
            par = conf.get(C.PY_WORKER_POOL_PARALLELISM) or \
                (os.cpu_count() or 1)
            out = pyworker.map_rows(self.fn, rows, par)
        if out is None:  # small batch / unpicklable fn: in-process
            out = [self.fn(*args) for args in rows]
        valid = np.array([r is not None for r in out], np.bool_) \
            if n else np.ones(0, np.bool_)
        if isinstance(self.return_type, T.StringType):
            vals = np.empty(len(out), object)
            vals[:] = out
        else:
            vals = np.array([0 if v is None else v for v in out]
                            ).astype(self.return_type.np_dtype)
        return CpuCol(self.return_type, vals, valid)


def _on_device(t, device: torch.device, name: str, what: str):
    """A UDF's result tensor, which must lie on the batch's device: a
    result elsewhere raises, it is never moved quietly."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"torch_udf {name!r} returned {what} of type "
                        f"{type(t).__name__}, not a torch.Tensor")
    if t.device.type != device.type or (
            device.index is not None and t.device.index is not None
            and t.device.index != device.index):
        raise RuntimeError(f"torch_udf {name!r} returned {what} on "
                           f"{t.device}; the batch is on {device}")
    return t


class TorchColumnarUDF(Expression):
    """Columnar device UDF: fn((values, validity), ...) -> values or
    (values, validity), called once per batch on the batch's device. The
    answer to RapidsUDF.evaluateColumnar (the JAX package's
    ``JaxColumnarUDF``): the user writes the columnar computation
    directly. Without a returned validity, the result is valid where
    every input is; values are cast to the return type."""

    def __init__(self, fn: Callable, return_type: T.DataType,
                 children: List[Expression], name: str = ""):
        self.fn = fn
        self.return_type = return_type
        self.children = list(children)
        self.name = name or getattr(fn, "__name__", "torch_udf")

    def data_type(self):
        return self.return_type

    def _params(self):
        return f"{self.name}@{id(self.fn):x}"

    def with_children(self, children):
        return TorchColumnarUDF(self.fn, self.return_type, children,
                                self.name)

    def eval(self, ctx):
        ins = [c.eval(ctx) for c in self.children]
        args = [(c.data, _valid_of(c, ctx)) for c in ins]
        res = self.fn(*args)
        if isinstance(res, tuple):
            vals, valid = res
            valid = _on_device(valid, ctx.device, self.name, "a validity")
        else:
            vals = res
            valid = None
            for c, (_, v) in zip(ins, args):
                valid = v if valid is None else (valid & v)
        vals = _on_device(vals, ctx.device, self.name, "values")
        if vals.dtype != self.return_type.torch_dtype:
            vals = vals.to(self.return_type.torch_dtype)
        return ColumnVector(self.return_type, vals, valid)

    def eval_cpu(self, cols, ansi=False):
        # run the SAME torch function on CPU tensors made from the numpy
        # planes: one implementation, both backends
        ins = [c.eval_cpu(cols, ansi) for c in self.children]
        args = [(torch.from_numpy(np.ascontiguousarray(c.values)),
                 torch.from_numpy(np.ascontiguousarray(c.valid)))
                for c in ins]
        res = self.fn(*args)
        if isinstance(res, tuple):
            vals = np.asarray(res[0])
            valid = np.asarray(res[1]).astype(np.bool_)
        else:
            vals = np.asarray(res)
            valid = np.ones(len(vals), np.bool_)
            for c in ins:
                valid = valid & c.valid
        return CpuCol(self.return_type,
                      vals.astype(self.return_type.np_dtype), valid)


def udf(fn: Callable = None, return_type: T.DataType = T.STRING):
    """Row-wise Python UDF decorator/factory. Simple bodies (arithmetic,
    comparisons, conditionals, math builtins) are TRANSLATED to device
    expressions by the bytecode compiler (reference udf-compiler, conf
    spark.rapids.sql.udfCompiler.enabled, read from the session conf in
    force on this thread); everything else runs on the CPU row tier via
    per-operator fallback."""
    def make(f):
        def make_expr(*cols):
            from spark_rapids_tpu_torch.expr.core import (
                Cast, Expression as _E, col as _c)
            es = [c if isinstance(c, _E) else _c(c) for c in cols]
            if C.session_conf().get(C.UDF_COMPILER_ENABLED):
                from spark_rapids_tpu_torch.sql.udf_compiler import (
                    compile_udf,
                )
                compiled = compile_udf(f, es)
                if compiled is not None:
                    try:
                        same = compiled.data_type() == return_type
                    except Exception:  # noqa: BLE001 - unresolved refs
                        same = False
                    return compiled if same else Cast(compiled, return_type)
            return PythonRowUDF(f, return_type, es)
        make_expr.__name__ = getattr(f, "__name__", "udf")
        return make_expr
    if fn is not None:
        return make(fn)
    return make


def torch_udf(fn: Callable = None, return_type: T.DataType = T.FLOAT64):
    """Columnar torch UDF decorator/factory: runs on the batch's device."""
    def make(f):
        def make_expr(*cols):
            from spark_rapids_tpu_torch.expr.core import (
                Expression as _E, col as _c,
            )
            es = [c if isinstance(c, _E) else _c(c) for c in cols]
            return TorchColumnarUDF(f, return_type, es)
        make_expr.__name__ = getattr(f, "__name__", "torch_udf")
        return make_expr
    if fn is not None:
        return make(fn)
    return make
