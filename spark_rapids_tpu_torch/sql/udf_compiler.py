"""Python-bytecode UDF compiler: CPython bytecode -> expression trees
(counterpart of ``spark_rapids_tpu/sql/udf_compiler.py``).

Reference parity: the reference's udf-compiler (CatalystExpressionBuilder
~5.8k LoC translating JVM bytecode to Catalyst so Scala lambdas run as
GPU expressions). The Python-native analog is far smaller because the
target IR (this engine's Expression trees) is already Python: we
symbolically execute the function's bytecode (`dis`) over a stack of
Expression objects, so arithmetic, comparisons, boolean logic,
conditional expressions, str/number builtins, and straight-line local
assignments all become device expressions of ``expr/core.py`` and
``expr/math.py``. Anything outside the
supported subset (loops, data-dependent iteration, unknown calls,
closures over mutable state) returns None and the UDF stays on the
row tier — the reference's fall-back-on-unsupported discipline.

Scope notes:
- backward jumps (loops) are rejected; conditional control flow is
  handled by forking the symbolic state at POP_JUMP_* and merging the
  branches into If(cond, a, b) where they reconverge.
- supported calls: abs, min, max, round, float, int, bool, len (on
  strings), and math.{sqrt, exp, log, log10, sin, cos, tan, floor,
  ceil, pow, fabs}.
- the opcode table is CPython 3.10-3.12's, as in the JAX package.
- ``min``/``max`` of several arguments become ``Least``/``Greatest`` of
  those arguments. The JAX package passes the argument list as one child
  (ROADMAP C21), which no evaluation accepts; the port does not copy that.
"""
from __future__ import annotations

import dis
import math
import re as _re
from typing import List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import core as E
from spark_rapids_tpu_torch.expr import math as MA


class _Unsupported(Exception):
    pass


_MAX_STEPS = 500


def _pymod(a: E.Expression, b: E.Expression) -> E.Expression:
    """Python %: result takes the DIVISOR's sign (Spark's Remainder takes
    the dividend's). rem + b where signs disagree."""
    rem = E.Remainder(a, b)
    fix = (E.Not(E.EqualTo(rem, E.Literal.infer(0)))
           & (E.LessThan(rem, E.Literal.infer(0))
              != E.LessThan(b, E.Literal.infer(0))))
    return E.If(fix, E.Add(rem, b), rem)


def _pyfloordiv(a: E.Expression, b: E.Expression) -> E.Expression:
    """Python //: floors toward -inf (IntegralDivide truncates to 0)."""
    q = E.IntegralDivide(a, b)
    rem = E.Remainder(a, b)
    fix = (E.Not(E.EqualTo(rem, E.Literal.infer(0)))
           & (E.LessThan(rem, E.Literal.infer(0))
              != E.LessThan(b, E.Literal.infer(0))))
    return E.If(fix, E.Subtract(q, E.Literal.infer(1)), q)


def _binary(opname: str, a: E.Expression, b: E.Expression) -> E.Expression:
    if opname == "+":
        return E.Add(a, b)
    if opname == "-":
        return E.Subtract(a, b)
    if opname == "*":
        return E.Multiply(a, b)
    if opname == "/":
        return E.Divide(a, b)
    if opname == "%":
        return _pymod(a, b)
    if opname == "//":
        return _pyfloordiv(a, b)
    if opname == "**":
        return MA.Pow(a, b)
    if opname == "&":
        return MA.BitwiseAnd(a, b)
    if opname == "|":
        return MA.BitwiseOr(a, b)
    if opname == "^":
        return MA.BitwiseXor(a, b)
    if opname == "<<":
        return MA.ShiftLeft(a, b)
    if opname == ">>":
        return MA.ShiftRight(a, b)
    raise _Unsupported(f"binary op {opname!r}")


_CMP = {"<": E.LessThan, "<=": E.LessThanOrEqual, ">": E.GreaterThan,
        ">=": E.GreaterThanOrEqual, "==": E.EqualTo,
        "!=": lambda a, b: E.Not(E.EqualTo(a, b))}


def _compare(argrepr: str, a: E.Expression, b: E.Expression) -> E.Expression:
    """Map COMPARE_OP argrepr (possibly wrapped, e.g. 3.13's 'bool(==)')
    to an expression; anything unrecognized is UNSUPPORTED — defaulting
    would silently compile the wrong predicate."""
    m = _re.search(r"(<=|>=|==|!=|<|>)", argrepr)
    if not m:
        raise _Unsupported(f"comparison {argrepr!r}")
    return _CMP[m.group(1)](a, b)


# Python 3.10 emits one opcode per operator (BINARY_ADD, ...); 3.11+
# folds them into BINARY_OP whose argrepr carries the symbol. Support
# both so the compiler works across the interpreter versions this
# engine runs under (the reference compiler has the same bytecode-
# version matrix problem, OpcodeSuite).
_BIN_OPNAMES = {
    "BINARY_ADD": "+", "BINARY_SUBTRACT": "-", "BINARY_MULTIPLY": "*",
    "BINARY_TRUE_DIVIDE": "/", "BINARY_FLOOR_DIVIDE": "//",
    "BINARY_MODULO": "%", "BINARY_POWER": "**", "BINARY_AND": "&",
    "BINARY_OR": "|", "BINARY_XOR": "^", "BINARY_LSHIFT": "<<",
    "BINARY_RSHIFT": ">>",
}
_BIN_OPNAMES.update({k.replace("BINARY_", "INPLACE_"): v
                     for k, v in _BIN_OPNAMES.items()})


class _Frame:
    __slots__ = ("stack", "locals")

    def __init__(self, stack, local_vars):
        self.stack = list(stack)
        self.locals = dict(local_vars)

    def copy(self):
        return _Frame(self.stack, self.locals)


def compile_udf(fn, arg_exprs: List[E.Expression]
                ) -> Optional[E.Expression]:
    """Translate fn's bytecode applied to arg_exprs, or None."""
    try:
        code = fn.__code__
    except AttributeError:
        return None
    if code.co_argcount != len(arg_exprs) or code.co_kwonlyargcount:
        return None
    if fn.__closure__:
        # closures over Expression-free constants could be supported;
        # reject conservatively (mutable captures change semantics)
        cells = [c.cell_contents for c in fn.__closure__]
        if not all(isinstance(v, (int, float, bool, str)) for v in cells):
            return None
    try:
        instrs = list(dis.get_instructions(fn))
        by_offset = {i.offset: idx for idx, i in enumerate(instrs)}
        local_vars = {name: ex for name, ex in
                      zip(code.co_varnames, arg_exprs)}
        cell_map = {}
        if fn.__closure__:
            for name, cell in zip(code.co_freevars, fn.__closure__):
                cell_map[name] = E.Literal.infer(cell.cell_contents)

        def run(idx: int, frame: _Frame, depth: int) -> E.Expression:
            if depth > 40:
                raise _Unsupported("branch nesting too deep")
            steps = 0
            while idx < len(instrs):
                steps += 1
                if steps > _MAX_STEPS:
                    raise _Unsupported("too many instructions")
                ins = instrs[idx]
                op = ins.opname
                st = frame.stack
                if op in ("RESUME", "PRECALL", "CACHE", "NOP",
                          "PUSH_NULL", "MAKE_CELL", "COPY_FREE_VARS"):
                    idx += 1
                elif op == "LOAD_CONST":
                    st.append(("const", ins.argval))
                    idx += 1
                elif op in ("LOAD_FAST", "LOAD_FAST_CHECK"):
                    if ins.argval not in frame.locals:
                        raise _Unsupported(f"unbound local {ins.argval}")
                    st.append(frame.locals[ins.argval])
                    idx += 1
                elif op == "LOAD_DEREF":
                    if ins.argval not in cell_map:
                        raise _Unsupported(f"free var {ins.argval}")
                    st.append(cell_map[ins.argval])
                    idx += 1
                elif op == "STORE_FAST":
                    frame.locals[ins.argval] = _as_expr(st.pop())
                    idx += 1
                elif op == "LOAD_GLOBAL":
                    g = fn.__globals__.get(ins.argval,
                                           getattr(__builtins__, "get",
                                                   lambda *_: None)(
                                               ins.argval)
                                           if isinstance(__builtins__, dict)
                                           else getattr(__builtins__,
                                                        ins.argval, None))
                    if g is None:
                        import builtins
                        g = getattr(builtins, ins.argval, None)
                    if g is None:
                        raise _Unsupported(f"global {ins.argval}")
                    st.append(("callable", g))
                    idx += 1
                elif op == "LOAD_ATTR" or op == "LOAD_METHOD":
                    base = st.pop()
                    if isinstance(base, tuple) and base[0] == "callable":
                        attr = getattr(base[1], ins.argval, None)
                        if attr is None:
                            raise _Unsupported(f"attr {ins.argval}")
                        st.append(("callable", attr))
                        idx += 1
                    else:
                        raise _Unsupported("attribute on value")
                elif op == "BINARY_OP":
                    b = _as_expr(st.pop())
                    a = _as_expr(st.pop())
                    sym = ins.argrepr.rstrip("=")
                    st.append(_binary(sym, a, b))
                    idx += 1
                elif op in _BIN_OPNAMES:  # 3.10 per-operator opcodes
                    b = _as_expr(st.pop())
                    a = _as_expr(st.pop())
                    st.append(_binary(_BIN_OPNAMES[op], a, b))
                    idx += 1
                elif op == "COMPARE_OP":
                    b = _as_expr(st.pop())
                    a = _as_expr(st.pop())
                    st.append(_compare(ins.argrepr, a, b))
                    idx += 1
                elif op == "UNARY_NEGATIVE":
                    st.append(E.UnaryMinus(_as_expr(st.pop())))
                    idx += 1
                elif op == "UNARY_NOT":
                    st.append(E.Not(_as_expr(st.pop())))
                    idx += 1
                elif op == "CALL":
                    n = ins.arg
                    args = [_as_expr(st.pop()) for _ in range(n)][::-1]
                    target = st.pop()
                    if st and isinstance(st[-1], tuple) \
                            and st[-1] == ("null",):
                        st.pop()
                    if not (isinstance(target, tuple)
                            and target[0] == "callable"):
                        raise _Unsupported("call of computed value")
                    st.append(_call(target[1], args))
                    idx += 1
                elif op in ("CALL_FUNCTION", "CALL_METHOD"):
                    # 3.10 call forms: n args above the callable; no NULL
                    # sentinel (LOAD_METHOD's self slot is folded into the
                    # single ("callable", fn) entry LOAD_METHOD pushed)
                    n = ins.arg
                    args = [_as_expr(st.pop()) for _ in range(n)][::-1]
                    target = st.pop()
                    if not (isinstance(target, tuple)
                            and target[0] == "callable"):
                        raise _Unsupported("call of computed value")
                    st.append(_call(target[1], args))
                    idx += 1
                elif op == "DUP_TOP":  # 3.10's COPY(1)
                    st.append(st[-1])
                    idx += 1
                elif op == "ROT_TWO":  # 3.10's SWAP(2)
                    st[-1], st[-2] = st[-2], st[-1]
                    idx += 1
                elif op == "JUMP_ABSOLUTE":
                    # forward only: a backward absolute jump is a loop
                    jump_idx = by_offset[ins.argval]
                    if jump_idx <= idx:
                        raise _Unsupported("loop")
                    idx = jump_idx
                elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE"):
                    cond = _as_expr(st.pop())
                    if op.endswith("TRUE"):
                        cond = E.Not(cond)
                    jump_idx = by_offset[ins.argval]
                    if jump_idx <= idx:
                        raise _Unsupported("loop")
                    then_v = run(idx + 1, frame.copy(), depth + 1)
                    else_v = run(jump_idx, frame.copy(), depth + 1)
                    return E.If(cond, then_v, else_v)
                elif op in ("JUMP_FORWARD",):
                    idx = by_offset[ins.argval]
                elif op == "RETURN_VALUE":
                    return _as_expr(st.pop())
                elif op == "RETURN_CONST":
                    return _as_expr(("const", ins.argval))
                elif op in ("COPY",):
                    st.append(st[-ins.arg])
                    idx += 1
                elif op in ("SWAP",):
                    st[-1], st[-ins.arg] = st[-ins.arg], st[-1]
                    idx += 1
                else:
                    raise _Unsupported(op)
            raise _Unsupported("fell off the end")

        return run(0, _Frame([], local_vars), 0)
    except _Unsupported:
        return None
    except Exception:  # noqa: BLE001 - never break planning on odd bytecode
        return None


def _as_expr(v) -> E.Expression:
    if isinstance(v, E.Expression):
        return v
    if isinstance(v, tuple) and v and v[0] == "const":
        if v[1] is None or isinstance(v[1], (bool, int, float, str)):
            return E.Literal.infer(v[1])
        raise _Unsupported(f"const {type(v[1]).__name__}")
    raise _Unsupported(f"non-expression {v!r}")


def _call(target, args: List[E.Expression]) -> E.Expression:
    import builtins
    if target is builtins.abs:
        return E.Abs(args[0])
    if target is builtins.min and len(args) >= 2:
        return MA.Least(*args)
    if target is builtins.max and len(args) >= 2:
        return MA.Greatest(*args)
    if target is builtins.round:
        if len(args) == 1:
            return MA.BRound(args[0], 0)  # python round is half-even
        raise _Unsupported("round with dynamic digits")
    if target is builtins.float:
        return E.Cast(args[0], T.FLOAT64)
    if target is builtins.int:
        return E.Cast(args[0], T.INT64)
    if target is builtins.bool:
        return E.Cast(args[0], T.BOOLEAN)
    if target is builtins.len:
        from spark_rapids_tpu_torch.expr.strings import StringLength
        return StringLength(args[0])
    if target is math.sqrt:
        return MA.Sqrt(args[0])
    if target is math.exp:
        return MA.Exp(args[0])
    if target is math.log:
        return MA.Log(args[0])
    if target is math.log10:
        return MA.Log10(args[0])
    if target is math.sin:
        return MA.Sin(args[0])
    if target is math.cos:
        return MA.Cos(args[0])
    if target is math.tan:
        return MA.Tan(args[0])
    if target is math.fabs:
        return E.Abs(E.Cast(args[0], T.FLOAT64))
    if target is math.floor:
        return MA.Floor(args[0])
    if target is math.ceil:
        return MA.Ceil(args[0])
    if target is math.pow:
        return MA.Pow(args[0], args[1])
    raise _Unsupported(f"call {target!r}")
