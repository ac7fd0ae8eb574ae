"""String expressions on device byte planes.

Counterpart of ``spark_rapids_tpu/expr/strings.py`` for ``length``,
``upper``/``lower``, ``substring``, ``concat``, ``startswith``/``endswith``
/``contains`` and the LIKE patterns that transpile to them. A flat column
is offsets (int32[cap + 1]) + bytes (uint8); a dictionary column's unary
ops run over its vocabulary and map back by code (``_lift_unary``).

Upper and Lower map ASCII letters only, byte by byte, with the case-map
kernel (``ops/case_map.py``), exactly as the JAX package's device path
does; Spark maps all of Unicode (the JAX package documents the
difference). Positions, lengths and substrings count UTF-8 characters, not
bytes. Per-byte work stays in uint8/bool/int32 planes: a string plane may
hold 2^30 bytes.

Every class also evaluates on the CPU backend (``eval_cpu``, the JAX
package's python string arithmetic: there upper/lower map all of Unicode,
as in the JAX package), and so do the casts to and from strings
(``cast_string_cpu``) and the LIKE patterns the device cannot run yet.
The device casts to and from strings are ``cast_string_device``, over
the byte walks of ``expr/cast_kernels.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import decimal
import re
from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector, round_capacity
from spark_rapids_tpu_torch.expr.core import (
    CpuCol, EqualTo, EvalCtx, Expression, Literal, SparkException, _valid_of,
    window_eq,
)
from spark_rapids_tpu_torch.ops import case_map as CM
from spark_rapids_tpu_torch.ops import kernels as K


def _lens(col: ColumnVector) -> torch.Tensor:
    if col.is_dict:
        o = col.data["dict_offsets"]
        vl = o[1:] - o[:-1]
        if not vl.shape[0]:
            return torch.zeros(col.capacity, dtype=o.dtype, device=o.device)
        return vl[col.data["codes"].to(torch.int64).clamp(0, vl.shape[0] - 1)]
    o = col.data["offsets"]
    return o[1:] - o[:-1]


def _starts(col: ColumnVector) -> torch.Tensor:
    return col.data["offsets"][:-1]


def _flat_view(c: ColumnVector) -> ColumnVector:
    """The vocabulary of a dictionary column viewed as a small flat
    string column."""
    return ColumnVector(T.STRING, {"offsets": c.data["dict_offsets"],
                                   "bytes": c.data["dict_bytes"]}, None)


def _flatten(c: ColumnVector) -> ColumnVector:
    """A dictionary column expanded to flat planes over its whole
    capacity (null rows empty)."""
    if not c.is_dict:
        return c
    return K.flatten_dict_column(c, c.capacity)


def _lift_unary(ctx: EvalCtx, c: ColumnVector, compute) -> ColumnVector:
    """Evaluate a unary string op. compute(flat_col, row_cap) returns a
    ColumnVector over the flat row space (its validity is ignored). A
    dictionary child is evaluated over its vocabulary and mapped back by
    code; a string result keeps the codes with the new vocabulary, which
    may now repeat a string (upper('a') == upper('A')), so it is marked
    not unique and groups by content."""
    valid = _valid_of(c, ctx)
    if c.is_dict:
        flat = _flat_view(c)
        res = compute(flat, flat.capacity)
        codes = c.data["codes"]
        if res.is_string:
            return ColumnVector(T.STRING, {
                "codes": codes,
                "dict_offsets": res.data["offsets"],
                "dict_bytes": res.data["bytes"]}, c.validity,
                dict_unique=False)
        n = res.data.shape[0]
        if not n:
            return ColumnVector(res.dtype, torch.zeros(
                codes.shape[0], dtype=res.data.dtype, device=codes.device),
                valid)
        return ColumnVector(res.dtype, res.data[codes.to(torch.int64).clamp(
            0, n - 1)], valid)
    res = compute(c, c.capacity)
    return ColumnVector(res.dtype, res.data, valid)


def _continuation(raw: torch.Tensor) -> torch.Tensor:
    """bool per byte: a UTF-8 continuation byte (10xxxxxx)."""
    return (raw & 0xC0) == 0x80


def _char_counts(flat: ColumnVector) -> torch.Tensor:
    """int32 UTF-8 characters per row: its bytes less its continuation
    bytes, located by one nonzero over the plane (none in ASCII text)."""
    o = flat.data["offsets"]
    lens = (o[1:] - o[:-1]).to(torch.int32)
    pos = torch.nonzero(_continuation(flat.data["bytes"])).flatten()
    if pos.numel():
        row = torch.searchsorted(o, pos.to(o.dtype), right=True) - 1
        keep = (row >= 0) & (row < lens.shape[0])
        lens = lens.index_add(0, row[keep].to(torch.int64),
                              torch.full_like(row[keep], -1,
                                              dtype=torch.int32))
    return lens


def _gather_ranges(raw: torch.Tensor, src_start: torch.Tensor,
                   lens: torch.Tensor) -> torch.Tensor:
    """Flat byte plane of the slices raw[src_start[i]: src_start[i] +
    lens[i]] back to back, padded with zeros to its capacity bucket."""
    row, within, total = K.expand_ranges(lens)
    out = torch.zeros(round_capacity(max(total, 1), minimum=8),
                      dtype=torch.uint8, device=raw.device)
    if total:
        src = src_start.to(torch.int64)[row.to(torch.int64)] + within
        out[:total] = raw[src]
    return out


def _offsets_of(lens: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=torch.int64, device=lens.device)
    return torch.cat([zero, torch.cumsum(lens.to(torch.int64), 0)]).to(
        torch.int32)


def select_strings(pick_a: torch.Tensor, a: ColumnVector, b: ColumnVector,
                   validity: torch.Tensor) -> ColumnVector:
    """Per row, a's string where pick_a holds, else b's, as a flat column
    (the string arm of ``Coalesce``): the two byte planes side by side,
    each row's slice gathered from the one it picks."""
    fa, fb = _flatten(a), _flatten(b)
    ra, rb = fa.data["bytes"], fb.data["bytes"]
    lens = torch.where(pick_a, _lens(fa), _lens(fb))
    starts = torch.where(pick_a, _starts(fa).to(torch.int64),
                         _starts(fb).to(torch.int64) + ra.shape[0])
    lens = torch.where(validity, lens, 0)
    return ColumnVector(T.STRING, {
        "offsets": _offsets_of(lens),
        "bytes": _gather_ranges(torch.cat([ra, rb]), starts, lens)},
        validity)


class StringLength(Expression):
    """length(): the number of UTF-8 characters (not bytes), like Spark."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return StringLength(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            return ColumnVector(T.INT32, _char_counts(flat), None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.INT32, np.array([len(v) if isinstance(v, str) else 0
                                         for v in c.values], np.int32),
                      c.valid)


class _CaseMap(Expression):
    """ASCII upper/lower over the byte plane by the case-map kernel: only
    [a-z]/[A-Z] move, non-ASCII bytes pass through (the JAX package's
    device semantics; Spark maps all of Unicode). The kernel runs on the
    card whatever the plane's length."""

    upper: bool = True

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            return ColumnVector(T.STRING, {
                "offsets": flat.data["offsets"],
                "bytes": CM.case_map(flat.data["bytes"], self.upper)}, None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        f = str.upper if self.upper else str.lower
        return CpuCol(T.STRING, _object_array(
            [f(v) if isinstance(v, str) else v for v in c.values]), c.valid)


class Upper(_CaseMap):
    upper = True


class Lower(_CaseMap):
    upper = False


class Substring(Expression):
    """substring(str, pos, len): 1-based pos, negative counts from the
    end, 0 acts as 1; character (not byte) positions, like Spark."""

    def __init__(self, child, pos: int, length: int = 1 << 30):
        self.children = [child]
        self.pos = pos
        self.length = length

    def data_type(self):
        return T.STRING

    def _params(self):
        return f"{self.pos},{self.length}"

    def with_children(self, children):
        return Substring(children[0], self.pos, self.length)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return _lift_unary(ctx, c, self._compute)

    def _compute(self, flat, cap):
        o = flat.data["offsets"].to(torch.int64)
        raw = flat.data["bytes"]
        starts, ends = o[:-1], o[1:]
        # chars before each byte, int32: a flat plane stays under 2^31 bytes
        csum = torch.empty(raw.shape[0] + 1, dtype=torch.int32,
                           device=raw.device)
        csum[0] = 0
        torch.cumsum(~_continuation(raw), 0, dtype=torch.int32,
                     out=csum[1:])
        base = csum[starts].to(torch.int64)
        nchars = csum[ends].to(torch.int64) - base
        if self.pos > 0:
            start_char = torch.clamp(nchars, max=self.pos - 1)
        elif self.pos == 0:
            start_char = torch.zeros_like(nchars)
        else:
            start_char = torch.clamp(nchars + self.pos, min=0)
        end_char = torch.minimum(start_char + max(self.length, 0), nchars)
        # the byte of char t is the last byte whose prefix char count is
        # base + t (past any continuation bytes of char t - 1)
        byte_start = torch.searchsorted(
            csum, (base + start_char).to(torch.int32), right=True,
            out_int32=True).to(torch.int64) - 1
        byte_end = torch.searchsorted(
            csum, (base + end_char).to(torch.int32), right=True,
            out_int32=True).to(torch.int64) - 1
        del csum
        byte_start = torch.minimum(torch.maximum(byte_start, starts), ends)
        byte_end = torch.minimum(torch.maximum(byte_end, byte_start), ends)
        out_lens = byte_end - byte_start
        return ColumnVector(T.STRING, {
            "offsets": _offsets_of(out_lens),
            "bytes": _gather_ranges(raw, byte_start, out_lens)}, None)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        out = []
        for v in c.values:
            if not isinstance(v, str):
                out.append(v)
                continue
            if self.pos > 0:
                start = self.pos - 1
            elif self.pos == 0:
                start = 0
            else:
                start = max(len(v) + self.pos, 0)
            out.append(v[start: start + max(self.length, 0)])
        return CpuCol(T.STRING, _object_array(out), c.valid)


class ConcatStrings(Expression):
    """concat(s1, s2, ...): null if any input is null (Spark concat)."""

    def __init__(self, *children):
        self.children = list(children)

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return ConcatStrings(*children)

    def eval(self, ctx):
        parts = [_flatten(c.eval(ctx)) for c in self.children]
        valid = _valid_of(parts[0], ctx)
        for p in parts[1:]:
            valid = valid & _valid_of(p, ctx)
        plens = [torch.where(valid, _lens(p).to(torch.int64), 0)
                 for p in parts]
        total_lens = plens[0]
        for pl in plens[1:]:
            total_lens = total_lens + pl
        new_off = _offsets_of(total_lens)
        total = int(new_off[-1].item())
        out = torch.zeros(round_capacity(max(total, 1), minimum=8),
                          dtype=torch.uint8, device=valid.device)
        acc = new_off[:-1].to(torch.int64)  # next output byte per row
        for p, pl in zip(parts, plens):
            row, within, n = K.expand_ranges(pl)
            if n:
                r = row.to(torch.int64)
                src = _starts(p).to(torch.int64)[r] + within
                out[acc[r] + within] = p.data["bytes"][src]
            acc = acc + pl
        return ColumnVector(T.STRING, {"offsets": new_off, "bytes": out},
                            valid)

    def eval_cpu(self, cols, ansi=False):
        parts = [c.eval_cpu(cols, ansi) for c in self.children]
        valid = parts[0].valid.copy()
        for p in parts[1:]:
            valid = valid & p.valid
        out = ["".join(str(p.values[i]) for p in parts) if ok else None
               for i, ok in enumerate(valid)]
        return CpuCol(T.STRING, _object_array(out), valid)


class _LiteralMatch(Expression):
    """startswith/endswith/contains with a literal pattern, compared byte
    by byte over the plane."""

    mode = "starts"  # starts | ends | contains

    def __init__(self, child, pattern: str):
        self.children = [child]
        self.pattern = pattern

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        return repr(self.pattern)

    def with_children(self, children):
        return type(self)(children[0], self.pattern)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return _lift_unary(ctx, c, self._compute)

    def _compute(self, flat, cap):
        raw = flat.data["bytes"]
        o = flat.data["offsets"]
        lens = o[1:] - o[:-1]
        pat = self.pattern.encode("utf-8")
        m = len(pat)
        if m == 0:
            return ColumnVector(T.BOOLEAN, torch.ones(
                cap, dtype=torch.bool, device=raw.device), None)
        fits = lens >= m
        if self.mode == "starts":
            return ColumnVector(T.BOOLEAN, fits & window_eq(raw, o[:-1], pat),
                                None)
        if self.mode == "ends":
            return ColumnVector(T.BOOLEAN,
                                fits & window_eq(raw, o[1:] - m, pat), None)
        # contains: a match at any byte that leaves the pattern inside its
        # row. Shifted slices keep every per-byte plane one byte wide.
        width = raw.shape[0] - m + 1
        hit_row = torch.zeros(cap, dtype=torch.bool, device=raw.device)
        if width > 0:
            hit = raw[:width] == pat[0]
            for k in range(1, m):
                hit &= raw[k:k + width] == pat[k]
            pos = torch.nonzero(hit).flatten().to(o.dtype)
            del hit
            row = (torch.searchsorted(o, pos, right=True) - 1).clamp(
                0, cap - 1).to(torch.int64)
            inside = (pos + m) <= o[row + 1]
            hit_row[row[inside]] = True
        return ColumnVector(T.BOOLEAN, fits & hit_row, None)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        f = {"starts": str.startswith, "ends": str.endswith,
             "contains": str.__contains__}[self.mode]
        return CpuCol(T.BOOLEAN, np.array(
            [bool(f(v, self.pattern)) if isinstance(v, str) else False
             for v in c.values], np.bool_), c.valid)


class StartsWith(_LiteralMatch):
    mode = "starts"


class EndsWith(_LiteralMatch):
    mode = "ends"


class Contains(_LiteralMatch):
    mode = "contains"


class Like(Expression):
    """SQL LIKE. Patterns that reduce to equality, startswith, endswith,
    both, or contains run as those expressions; a pattern of only ``%``
    matches every non-null string. Other patterns (``_`` wildcards, more
    than one inner run) need the JAX package's device NFA
    (``expr/regex.py``), which is not ported yet: planning tags them to
    the CPU (``needs_nfa``), where ``eval_cpu`` matches with ``re``."""

    def __init__(self, child, pattern: str, escape: str = "\\"):
        self.children = [child]
        self.pattern = pattern
        self.escape = escape

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        return repr(self.pattern)

    def with_children(self, children):
        return Like(children[0], self.pattern, self.escape)

    def _transpile(self):
        """An equivalent expression, or None."""
        p, esc = self.pattern, self.escape
        literal: List[str] = []
        tokens: List[str] = []
        i = 0
        while i < len(p):
            ch = p[i]
            if ch == esc and i + 1 < len(p):
                literal.append(p[i + 1])
                tokens.append("LIT")
                i += 2
            elif ch in "%_":
                tokens.append(ch)
                literal.append("")
                i += 1
            else:
                tokens.append("LIT")
                literal.append(ch)
                i += 1
        if "_" in tokens:
            return None
        runs: List[str] = []
        cur = ""
        for tk, li in zip(tokens, literal):
            if tk == "%":
                runs.append(cur)
                cur = ""
            else:
                cur += li
        runs.append(cur)
        child = self.children[0]
        if len(runs) == 1:
            return _StringEquals(child, runs[0])
        if len(runs) == 2:
            a, b = runs
            if a == "" and b == "":
                return None  # only '%': every string matches
            if a == "":
                return EndsWith(child, b)
            if b == "":
                return StartsWith(child, a)
            return _AndExpr(StartsWith(child, a), EndsWith(child, b),
                            min_len=len(a) + len(b))
        if len(runs) == 3 and runs[0] == "" and runs[2] == "" and runs[1]:
            return Contains(child, runs[1])
        return None

    def needs_nfa(self) -> bool:
        """Would the device need the NFA for this pattern?"""
        return self._transpile() is None \
            and self.pattern.replace("%", "") != ""

    def eval(self, ctx):
        t = self._transpile()
        if t is not None:
            return t.eval(ctx)
        if self.needs_nfa():
            raise NotImplementedError(
                f"LIKE pattern {self.pattern!r} needs the device NFA of "
                f"expr/regex.py, which is not ported yet")
        c = self.children[0].eval(ctx)
        return ColumnVector(T.BOOLEAN, torch.ones(
            ctx.capacity, dtype=torch.bool, device=ctx.device),
            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        prog = re.compile(_like_to_regex(self.pattern, self.escape),
                          re.DOTALL)
        return CpuCol(T.BOOLEAN, np.array(
            [bool(prog.fullmatch(v)) if isinstance(v, str) else False
             for v in c.values], np.bool_), c.valid)


def _like_to_regex(pattern: str, esc: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == esc and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append({"%": ".*", "_": "."}.get(ch, re.escape(ch)))
        i += 1
    return "".join(out)


class _StringEquals(Expression):
    def __init__(self, child, value: str):
        self.children = [child]
        self.value = value

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        return repr(self.value)

    def with_children(self, children):
        return _StringEquals(children[0], self.value)

    def eval(self, ctx):
        return EqualTo(self.children[0],
                       Literal(self.value, T.STRING)).eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.BOOLEAN, np.array(
            [v == self.value if isinstance(v, str) else False
             for v in c.values], np.bool_), c.valid)


class _AndExpr(Expression):
    """LIKE 'a%b': startswith AND endswith on a string of at least
    len(a) + len(b) bytes."""

    def __init__(self, a, b, min_len=0):
        self.children = [a, b]
        self.min_len = min_len

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        return str(self.min_len)

    def with_children(self, children):
        return _AndExpr(children[0], children[1], self.min_len)

    def eval(self, ctx):
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        res = a.data & b.data
        if self.min_len:
            src = self.children[0].children[0].eval(ctx)
            res = res & (_lens(src) >= self.min_len)
        return ColumnVector(T.BOOLEAN, res,
                            _valid_of(a, ctx) & _valid_of(b, ctx))

    def eval_cpu(self, cols, ansi=False):
        a = self.children[0].eval_cpu(cols, ansi)
        b = self.children[1].eval_cpu(cols, ansi)
        res = a.values & b.values
        if self.min_len:
            src = self.children[0].children[0].eval_cpu(cols, ansi)
            lens = np.array([len(v) if isinstance(v, str) else 0
                             for v in src.values])
            res = res & (lens >= self.min_len)
        return CpuCol(T.BOOLEAN, res, a.valid & b.valid)


def _object_array(items) -> np.ndarray:
    out = np.empty(len(items), object)
    out[:] = items
    return out


# ---------------------------------------------------------------------------
# Casts involving strings, on the CPU (the JAX package's cast_string_cpu)
# ---------------------------------------------------------------------------

_JAVA_WS = "".join(chr(c) for c in range(33))


def _java_trim(s: str) -> str:
    """Java String/UTF8String trim: strip chars <= 0x20 on both ends."""
    return s.strip(_JAVA_WS)


def _parse_dt_py(s, with_time: bool):
    """Spark's stringToDate/stringToTimestamp subset of the JAX package's
    device kernel: yyyy[-m[-d]] and yyyy-m-d[ |T]H:M:S[.ffffff], UTC."""
    if not isinstance(s, str):
        return None
    t = _java_trim(s)
    date_re = r"(\d{1,7})(?:-(\d{1,2})(?:-(\d{1,2}))?)?"
    time_re = r"(?:[ T](\d{1,2}):(\d{1,2}):(\d{1,2})(?:\.(\d+))?)?"
    m = re.fullmatch(date_re + (time_re if with_time else ""), t)
    if m is None:
        return None
    g = m.groups()
    try:
        date = datetime.date(int(g[0]), int(g[1] or 1), int(g[2] or 1))
    except ValueError:
        return None
    days = (date - datetime.date(1970, 1, 1)).days
    if not with_time:
        return days
    us = 0
    if g[3] is not None:
        hh, mi, ss = int(g[3]), int(g[4]), int(g[5])
        if hh > 23 or mi > 59 or ss > 59:
            return None
        frac = (g[6] or "")[:6].ljust(6, "0") if g[6] else "0"
        us = hh * 3_600_000_000 + mi * 60_000_000 + ss * 1_000_000 \
            + int(frac)
    return days * 86_400_000_000 + us


def _spark_float_str(v: float) -> str:
    """Java Double.toString-ish rendering (Spark's cast double -> string)."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    if v == int(v) and abs(v) < 1e16:
        return f"{int(v)}.0"
    return repr(v)


def _render(v, src: T.DataType) -> str:
    if isinstance(src, T.BooleanType):
        return "true" if v else "false"
    if isinstance(src, (T.Float32Type, T.Float64Type)):
        return _spark_float_str(float(v))
    if isinstance(src, T.DateType):
        return str(datetime.date(1970, 1, 1)
                   + datetime.timedelta(days=int(v)))
    if isinstance(src, T.TimestampType):
        iso = (datetime.datetime(1970, 1, 1) + datetime.timedelta(
            microseconds=int(v))).isoformat(sep=" ")
        # Spark trims trailing zeros of the fraction
        return iso.rstrip("0").rstrip(".") if "." in iso else iso
    if isinstance(src, T.DecimalType):
        return str(decimal.Decimal(int(v)).scaleb(-src.scale))
    return str(int(v))


#: Spark castToDouble: UTF8String.trim + Java Double.parseDouble, with
#: case-sensitive Infinity/NaN, no underscores and no bare 'inf' (python's
#: float() is more lenient)
_NUM_RE = re.compile(r"[+-]?((\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?|Infinity|NaN)")
_TRUE = ("true", "t", "yes", "y", "1")
_FALSE = ("false", "f", "no", "n", "0")


def _parse(s, dst: T.DataType):
    """The value of string s cast to dst, or None where it does not
    parse."""
    if not isinstance(s, str):
        return None
    if dst.is_integral:
        try:
            return int(s.strip())
        except ValueError:
            return None
    if isinstance(dst, (T.Float32Type, T.Float64Type)):
        t = _java_trim(s)
        return float(t.replace("Infinity", "inf")) \
            if _NUM_RE.fullmatch(t) else None
    if isinstance(dst, T.BooleanType):
        t = s.strip().lower()
        return True if t in _TRUE else (False if t in _FALSE else None)
    return _parse_dt_py(s, with_time=isinstance(dst, T.TimestampType))


def cast_string_cpu(c: CpuCol, dst: T.DataType, ansi: bool) -> CpuCol:
    """Casts to and from strings on the CPU, with the JAX package's CPU
    semantics: a string that does not parse is null (ANSI: an error)."""
    if isinstance(dst, T.StringType):
        return CpuCol(T.STRING, _object_array(
            [_render(v, c.dtype) if ok else None
             for v, ok in zip(c.values, c.valid)]), c.valid.copy())
    if isinstance(dst, T.DecimalType):
        # the JAX package has no string -> decimal cast on either side
        raise NotImplementedError(f"cast string -> {dst!r}")
    valid = c.valid.copy()
    vals = np.zeros(len(c.values), np.bool_ if isinstance(
        dst, T.BooleanType) else (np.float64 if isinstance(
            dst, (T.Float32Type, T.Float64Type)) else np.int64))
    for i, s in enumerate(c.values):
        if not valid[i]:
            continue
        v = _parse(s, dst)
        if v is None:
            if ansi:
                raise SparkException(f"[CAST_INVALID_INPUT] '{s}' to "
                                     f"{dst!r}")
            valid[i] = False
        else:
            vals[i] = v
    return CpuCol(dst, vals.astype(dst.np_dtype), valid)


def _parse_string(c: ColumnVector, valid: torch.Tensor, parse, ctx: EvalCtx):
    """(values, validity) of a string -> fixed-width cast. A dictionary
    column parses its vocabulary once and gathers by code; a row that does
    not parse is null (ANSI: a CAST_INVALID_INPUT error)."""
    if c.is_dict:
        if not c.dict_size:
            return (torch.zeros(c.capacity, dtype=torch.int64,
                                device=valid.device), torch.zeros_like(valid))
        vv, vok = parse(_flat_view(c))
        codes = c.data["codes"].to(torch.int64).clamp(0, c.dict_size - 1)
        vals, ok = vv[codes], vok[codes]
    else:
        vals, ok = parse(c)
    if ctx.ansi:
        ctx.add_error("CAST_INVALID_INPUT", valid & ~ok)
    return vals, valid & ok


def cast_string_device(c: ColumnVector, dst: T.DataType,
                       ctx: EvalCtx) -> ColumnVector:
    """Casts to and from strings on the device (the JAX package's
    ``cast_string_tpu``): boolean, integer, date and timestamp to string;
    string to integer, float, date and timestamp (``expr/cast_kernels.py``).
    The planner tags the others to the CPU (``_cast_check``)."""
    from spark_rapids_tpu_torch.expr import cast_kernels as CK
    from spark_rapids_tpu_torch.expr.core import If, _RawCol
    valid = _valid_of(c, ctx)
    src = c.dtype
    if isinstance(dst, T.StringType):
        if isinstance(src, T.BooleanType):
            # a null stays null (the JAX package's device gives "false",
            # its If's else branch; Spark and both CPU backends give null)
            out = If(_RawCol(ColumnVector(T.BOOLEAN, c.data, valid)),
                     Literal("true", T.STRING),
                     Literal("false", T.STRING)).eval(ctx)
            return dataclasses.replace(out, validity=valid)
        if isinstance(src, T.DateType):
            return CK.render_date(c.data, valid)
        if isinstance(src, T.TimestampType):
            return CK.render_timestamp(c.data.to(torch.int64), valid)
        if src.is_integral:
            return CK.render_int64(c.data.to(torch.int64), valid)
        raise NotImplementedError(f"cast {src!r} -> string on the device")
    if isinstance(src, T.StringType):
        if dst.is_integral:
            parse = CK.parse_int64
        elif isinstance(dst, (T.Float32Type, T.Float64Type)):
            parse = CK.parse_f64
        elif isinstance(dst, T.DateType):
            parse = CK.parse_date
        elif isinstance(dst, T.TimestampType):
            parse = CK.parse_timestamp
        else:
            raise NotImplementedError(f"cast string -> {dst!r} on the "
                                      f"device")
        vals, out_valid = _parse_string(c, valid, parse, ctx)
        return ColumnVector(dst, vals.to(dst.torch_dtype), out_valid)
    raise NotImplementedError(f"cast {src!r} -> {dst!r}")
