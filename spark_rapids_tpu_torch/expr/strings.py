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
    than one inner run) run as the full-match device NFA of
    ``expr/regex.py`` when they compile to one (at most 31 positions);
    planning tags the rest to the CPU (``supported_on_tpu``), where
    ``eval_cpu`` matches with ``re``."""

    def __init__(self, child, pattern: str, escape: str = "\\"):
        self.children = [child]
        self.pattern = pattern
        self.escape = escape

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        # a non-default escape keys the stage cache apart
        # (runtime/compile_cache.py); the default keeps the JAX
        # package's fingerprint
        esc = "" if self.escape == "\\" else f",{self.escape!r}"
        return repr(self.pattern) + esc

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

    def _nfa(self):
        """The pattern as a full-match NFA, or None where it does not
        compile to one. LIKE wildcards match newlines too (the CPU arm
        matches with re.DOTALL), so they translate to ``(.|\\n)``, not a
        bare ``.``."""
        from spark_rapids_tpu_torch.expr import regex as RX
        if not hasattr(self, "_nfa_cache"):
            out = []
            i = 0
            p, esc = self.pattern, self.escape
            while i < len(p):
                ch = p[i]
                if ch == esc and i + 1 < len(p):
                    ch = p[i + 1]
                    i += 2
                elif ch in "%_":
                    out.append("(.|\n)*" if ch == "%" else "(.|\n)")
                    i += 1
                    continue
                else:
                    i += 1
                out.append("\\" + ch if ch in ".^$*+?()[]{}|\\/-" else ch)
            try:
                self._nfa_cache = RX.compile_pattern("".join(out),
                                                     mode="match")
            except RX.RegexUnsupported:
                self._nfa_cache = None
        return self._nfa_cache

    def supported_on_tpu(self):
        return (self._transpile() is not None
                or self.pattern.replace("%", "") == ""
                or self._nfa() is not None)

    def eval(self, ctx):
        t = self._transpile()
        if t is not None:
            return t.eval(ctx)
        c = self.children[0].eval(ctx)
        if self.pattern.replace("%", "") == "":
            return ColumnVector(T.BOOLEAN, torch.ones(
                ctx.capacity, dtype=torch.bool, device=ctx.device),
                _valid_of(c, ctx))
        nfa = self._nfa()
        if nfa is None:
            raise NotImplementedError(
                f"LIKE pattern {self.pattern!r} on the device")
        return _lift_unary(ctx, c, lambda flat, cap: ColumnVector(
            T.BOOLEAN, _nfa_rows(nfa, flat), None))

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


def _nfa_rows(nfa, flat: ColumnVector) -> torch.Tensor:
    from spark_rapids_tpu_torch.expr import regex as RX
    return RX.nfa_eval(nfa, flat.data["offsets"], flat.data["bytes"])


class RLike(Expression):
    """Spark RLIKE: Java regex, match anywhere. Patterns inside the device
    subset run as the bit-parallel NFA of ``expr/regex.py`` over the byte
    planes; planning tags the others to the CPU, where ``eval_cpu``
    searches with ``re`` (the reference's RegexParser transpile-or-reject
    contract)."""

    def __init__(self, child, pattern: str):
        self.children = [child]
        self.pattern = pattern
        self._nfa = None
        self._nfa_err = None

    def data_type(self):
        return T.BOOLEAN

    def _params(self):
        return repr(self.pattern)

    def with_children(self, children):
        return RLike(children[0], self.pattern)

    def _compiled(self):
        from spark_rapids_tpu_torch.expr import regex as RX
        if self._nfa is None and self._nfa_err is None:
            try:
                self._nfa = RX.compile_pattern(self.pattern, mode="find")
            except RX.RegexUnsupported as e:
                self._nfa_err = str(e)
        return self._nfa

    def supported_on_tpu(self):
        return self._compiled() is not None

    def eval(self, ctx):
        nfa = self._compiled()
        if nfa is None:
            raise NotImplementedError(
                f"regex {self.pattern!r} on device: {self._nfa_err}")
        c = self.children[0].eval(ctx)
        return _lift_unary(ctx, c, lambda flat, cap: ColumnVector(
            T.BOOLEAN, _nfa_rows(nfa, flat), None))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        prog = re.compile(self.pattern)
        return CpuCol(T.BOOLEAN, np.array(
            [bool(prog.search(v)) if isinstance(v, str) else False
             for v in c.values], np.bool_), c.valid)


class _RegexCpuBase(Expression):
    """regexp_extract / regexp_replace: string results, from the tagged
    device NFA (``_tagged``) where the pattern compiles to it; the planner
    sends the others to the CPU, ``_nfa_err`` saying why."""

    _tagged = None
    _nfa_err = None

    def data_type(self):
        return T.STRING

    def supported_on_tpu(self):
        return self._tagged is not None

    def eval(self, ctx):
        if self._tagged is None:
            raise NotImplementedError(
                f"{type(self).__name__} {self.pattern!r} on device: "
                f"{self._nfa_err}")
        c = self.children[0].eval(ctx)
        return _lift_unary(ctx, c, self._compute)


class RegexpExtract(_RegexCpuBase):
    """regexp_extract: one capture group. Alternation-free patterns of at
    most ``MAX_TAG_STATES`` positions run on the device
    (``regex.compile_extract`` and ``nfa_extract``); a row that does not
    match, and a group that does not take part, give ""."""

    def __init__(self, child, pattern: str, group: int = 1):
        from spark_rapids_tpu_torch.expr.regex import (
            RegexUnsupported, compile_extract)
        self.children = [child]
        self.pattern = pattern
        self.group = group
        try:
            self._tagged = compile_extract(pattern, group)
        except RegexUnsupported as e:
            self._nfa_err = str(e)

    def _params(self):
        return f"{self.pattern!r},{self.group}"

    def with_children(self, children):
        return RegexpExtract(children[0], self.pattern, self.group)

    def _compute(self, flat, cap):
        from spark_rapids_tpu_torch.expr.regex import nfa_extract
        o = flat.data["offsets"][: cap + 1]
        raw = flat.data["bytes"]
        has, g0, g1 = nfa_extract(self._tagged, o, raw)
        lens = torch.where(has, g1 - g0, 0)
        src = o[:-1].to(torch.int64) + g0.to(torch.int64)
        return ColumnVector(T.STRING, {
            "offsets": _offsets_of(lens),
            "bytes": _gather_ranges(raw, src, lens)}, None)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        prog = re.compile(self.pattern)
        if self.group > prog.groups or self.group < 0:
            raise ValueError(
                f"regexp_extract group {self.group} out of range for "
                f"{self.pattern!r} ({prog.groups} groups)")
        out = []
        for v in c.values:
            if not isinstance(v, str):
                out.append(None)
                continue
            m = prog.search(v)
            # Spark: "" for no match AND for a non-participating group
            out.append((m.group(self.group) or "") if m else "")
        return CpuCol(T.STRING, _object_array(out), c.valid)


#: bytes of the plane ``RegexpReplace`` scatters at a time
_SPLICE_CHUNK = 1 << 26


class RegexpReplace(_RegexCpuBase):
    """regexp_replace: replace all. Patterns of the tagged-NFA subset that
    cannot match the empty string, with a literal replacement of at most
    ``_MAX_DEVICE_REPL`` bytes (no ``$n`` backrefs), run on the device:
    one span scan (``regex.nfa_match_spans``), then a splice of the byte
    plane. Every byte's output position is an exclusive prefix sum of
    (kept byte + replacement length at each match start), in int32, so
    the splice needs no row-of-byte plane; the scatters run over slices of
    the plane (``_SPLICE_CHUNK`` bytes) so their index planes stay small.
    Everything else runs on the CPU."""

    _MAX_DEVICE_REPL = 8

    def __init__(self, child, pattern: str, replacement: str):
        self.children = [child]
        self.pattern = pattern
        self.replacement = replacement
        if re.search(r"\$\d", replacement):
            self._nfa_err = "backref in replacement"
        elif len(replacement.encode()) > self._MAX_DEVICE_REPL:
            self._nfa_err = "replacement too long for device splice"
        else:
            from spark_rapids_tpu_torch.expr.regex import (
                RegexUnsupported, compile_replace)
            try:
                self._tagged = compile_replace(pattern)
            except RegexUnsupported as e:
                self._nfa_err = str(e)

    def _params(self):
        return f"{self.pattern!r},{self.replacement!r}"

    def with_children(self, children):
        return RegexpReplace(children[0], self.pattern, self.replacement)

    def _compute(self, flat, cap):
        from spark_rapids_tpu_torch.expr.regex import nfa_match_spans
        rep = list(self.replacement.encode())
        R = len(rep)
        o = flat.data["offsets"][: cap + 1].to(torch.int64)
        raw = flat.data["bytes"]
        nb = raw.shape[0]
        dev = raw.device
        flags, slen = nfa_match_spans(self._tagged, o, raw)
        # in-match bytes: +1 at each span's start, -1 past its end. Spans
        # never overlap nor cross a row's end, so no two end at one byte
        # (plain stores mark them) and the running sum is 0 or 1
        ends = torch.zeros(nb + 1, dtype=torch.int8, device=dev)
        for lo in range(0, nb, _SPLICE_CHUNK):
            at = torch.nonzero(flags[lo:lo + _SPLICE_CHUNK]).flatten() + lo
            ends[at + slen[at]] = 1
        del slen
        inm = torch.cumsum(flags.to(torch.int8) - ends[:nb], 0,
                           dtype=torch.int8)
        del ends
        keep = inm == 0
        del inm
        keep[int(o[cap].item()):] = False
        # output position of every byte: kept bytes and replacements so far
        step = keep.to(torch.int32)
        if R:
            step.add_(flags, alpha=R)
        pos = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
        torch.cumsum(step, 0, dtype=torch.int32, out=pos[1:])
        del step
        new_off = pos[o] - pos[o[0]]
        base = pos[o[0]].to(torch.int64)
        out = torch.zeros(max(nb * max(1, R), 8), dtype=torch.uint8,
                          device=dev)
        for lo in range(0, nb, _SPLICE_CHUNK):
            hi = min(lo + _SPLICE_CHUNK, nb)
            at = torch.nonzero(keep[lo:hi]).flatten() + lo
            out[pos[at].to(torch.int64) - base] = raw[at]
            if R:
                at = torch.nonzero(flags[lo:hi]).flatten() + lo
                dst = pos[at].to(torch.int64) - base
                for j, byte in enumerate(rep):
                    out[dst + j] = byte
        return ColumnVector(T.STRING, {"offsets": new_off.to(torch.int32),
                                       "bytes": out}, None)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        prog = re.compile(self.pattern)
        # Java $1 -> python \1 backrefs
        repl = re.sub(r"\$(\d)", r"\\\1", self.replacement)
        return CpuCol(T.STRING, _object_array(
            [prog.sub(repl, v) if isinstance(v, str) else v
             for v in c.values]), c.valid)


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
# String function breadth (reference stringFunctions.scala): every unary
# op rides the vocabulary lift, so a dictionary column pays O(vocabulary)
# byte work. A per-byte plane is at most int32 (a plane may hold 2^30
# bytes), each is freed once used, and none maps a byte to its row: the
# ops search prefix counts per row or reduce only the bytes that matter.
# ---------------------------------------------------------------------------

def _slice_rows(raw: torch.Tensor, new_start: torch.Tensor,
                lens: torch.Tensor) -> dict:
    """A string column taking lens[i] bytes from new_start[i]."""
    return {"offsets": _offsets_of(lens),
            "bytes": _gather_ranges(raw, new_start.to(torch.int64), lens)}


class _TrimBase(Expression):
    """trim/ltrim/rtrim of ASCII spaces (Spark's default trims ' '). Each
    row's first and last non-space byte come from one int32 prefix count
    of non-space bytes over the plane, searched per row (the JAX package
    takes a min and a max over every byte of each row)."""

    lead = True
    tail = True

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        return _lift_unary(ctx, c, self._compute)

    def _compute(self, flat, cap):
        o = flat.data["offsets"][: cap + 1].to(torch.int64)
        raw = flat.data["bytes"]
        # cnt[i]: non-space bytes before byte i
        cnt = torch.zeros(raw.shape[0] + 1, dtype=torch.int32,
                          device=raw.device)
        torch.cumsum(raw != 32, 0, dtype=torch.int32, out=cnt[1:])
        at_start, at_end = cnt[o[:-1]], cnt[o[1:]]
        has = at_end > at_start
        start, end = o[:-1], o[1:]
        if self.lead:
            # the first non-space byte p has cnt[p + 1] == at_start + 1
            first = torch.searchsorted(cnt, at_start + 1) - 1
            start = torch.where(has, first, end)
        if self.tail:
            # the last non-space byte p has cnt[p + 1] == at_end
            last = torch.searchsorted(cnt, at_end) - 1
            end = torch.where(has, last + 1, start)
        del cnt
        end = torch.maximum(end, start)
        return ColumnVector(T.STRING, _slice_rows(raw, start, end - start),
                            None)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)

        def f(v):
            if self.lead and self.tail:
                return v.strip(" ")
            return v.lstrip(" ") if self.lead else v.rstrip(" ")

        return CpuCol(T.STRING, _object_array(
            [f(v) if isinstance(v, str) else v for v in c.values]), c.valid)


class Trim(_TrimBase):
    lead = tail = True


class LTrim(_TrimBase):
    lead, tail = True, False


class RTrim(_TrimBase):
    lead, tail = False, True


class InitCap(Expression):
    """initcap: upper case after a space or at a row's start, lower case
    elsewhere, ASCII letters only on the device (the JAX package's device
    rule; the reference documents the same non-ASCII difference). The CPU
    arm maps all of Unicode, as the JAX package's CPU backend does."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return InitCap(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            o = flat.data["offsets"][: cap + 1]
            raw = flat.data["bytes"]
            nb = raw.shape[0]
            after_sep = torch.roll(raw, 1) == 32
            # the first byte of every row follows a separator
            at = o[:-1].to(torch.int64)
            after_sep[at[at < nb]] = True
            lower = torch.where((raw >= 65) & (raw <= 90), raw + 32, raw)
            out = torch.where(after_sep & (raw >= 97) & (raw <= 122),
                              raw - 32, torch.where(after_sep, raw, lower))
            return ColumnVector(T.STRING, {"offsets": flat.data["offsets"],
                                           "bytes": out}, None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)

        def f(v):
            return " ".join(w[:1].upper() + w[1:].lower()
                            for w in v.split(" "))

        return CpuCol(T.STRING, _object_array(
            [f(v) if isinstance(v, str) else v for v in c.values]), c.valid)


class Ascii(Expression):
    """ascii(s): the code point of the first character (0 for ""). The
    device decodes the first UTF-8 character, as Spark and both CPU
    backends do (the JAX package's device returns its first byte)."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return Ascii(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            o = flat.data["offsets"][: cap + 1].to(torch.int64)
            raw = flat.data["bytes"]
            nb = raw.shape[0]
            lens = o[1:] - o[:-1]
            if nb == 0:
                return ColumnVector(T.INT32, torch.zeros(
                    cap, dtype=torch.int32, device=raw.device), None)

            def at(k):
                return raw[(o[:-1] + k).clamp(0, nb - 1)].to(torch.int32)

            b0 = at(0)
            cont = [at(k) & 0x3F for k in (1, 2, 3)]
            two = ((b0 & 0x1F) << 6) | cont[0]
            three = ((b0 & 0x0F) << 12) | (cont[0] << 6) | cont[1]
            four = ((b0 & 0x07) << 18) | (cont[0] << 12) | (cont[1] << 6) \
                | cont[2]
            code = torch.where(b0 < 0xC0, b0, torch.where(
                b0 < 0xE0, two, torch.where(b0 < 0xF0, three, four)))
            return ColumnVector(T.INT32, torch.where(lens > 0, code, 0),
                                None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.INT32, np.array(
            [ord(v[0]) if isinstance(v, str) and v else 0
             for v in c.values], np.int32), c.valid)


class InStr(Expression):
    """instr(str, substr literal): the 1-based character position of the
    first occurrence, 0 where there is none (``locate`` too). The pattern
    is compared byte by byte over the plane; only the hits' positions are
    reduced into their rows."""

    def __init__(self, child, substr: str):
        self.children = [child]
        self.substr = substr

    def _params(self):
        return repr(self.substr)

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return InStr(children[0], self.substr)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        pat = self.substr.encode("utf-8")
        m = len(pat)

        def compute(flat, cap):
            o = flat.data["offsets"][: cap + 1]
            raw = flat.data["bytes"]
            nb = raw.shape[0]
            dev = raw.device
            if m == 0:
                return ColumnVector(T.INT32, torch.ones(
                    cap, dtype=torch.int32, device=dev), None)
            first_hit = torch.full((cap,), nb, dtype=torch.int64,
                                   device=dev)
            width = nb - m + 1
            if width > 0:
                hit = raw[:width] == pat[0]
                for k in range(1, m):
                    hit &= raw[k:k + width] == pat[k]
                pos = torch.nonzero(hit).flatten().to(o.dtype)
                del hit
                row = (torch.searchsorted(o, pos, right=True,
                                          out_int32=True) - 1).clamp_(
                    0, cap - 1).to(torch.int64)
                fits = (pos + m) <= o[row + 1]
                first_hit.scatter_reduce_(0, row[fits],
                                          pos[fits].to(torch.int64), "amin",
                                          include_self=True)
            found = first_hit < nb
            # the hit's byte position -> its 1-based character index
            csum = torch.empty(nb + 1, dtype=torch.int32, device=dev)
            csum[0] = 0
            torch.cumsum(~_continuation(raw), 0, dtype=torch.int32,
                         out=csum[1:])
            char_idx = csum[first_hit.clamp(0, nb)] \
                - csum[o[:-1].to(torch.int64)] + 1
            return ColumnVector(T.INT32, torch.where(found, char_idx, 0)
                                .to(torch.int32), None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.INT32, np.array(
            [v.find(self.substr) + 1 if isinstance(v, str) else 0
             for v in c.values], np.int32), c.valid)


class StringRepeat(Expression):
    """repeat(str, n literal)."""

    def __init__(self, child, n: int):
        self.children = [child]
        self.n = max(int(n), 0)

    def _params(self):
        return str(self.n)

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return StringRepeat(children[0], self.n)

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            o = flat.data["offsets"][: cap + 1].to(torch.int64)
            raw = flat.data["bytes"]
            lens = (o[1:] - o[:-1]).to(torch.int32)
            out_lens = lens * self.n
            row, within, total = K.expand_ranges(out_lens)
            out = torch.zeros(round_capacity(max(total, 1), minimum=8),
                              dtype=torch.uint8, device=raw.device)
            if total:
                r = row.to(torch.int64)
                src = o[r] + torch.remainder(within, lens[r].clamp(min=1))
                out[:total] = raw[src]
            return ColumnVector(T.STRING, {"offsets": _offsets_of(out_lens),
                                           "bytes": out}, None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.STRING, _object_array(
            [v * self.n if isinstance(v, str) else v for v in c.values]),
            c.valid)


class OctetLength(Expression):
    """octet_length(): the UTF-8 byte count."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return type(self)(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)

        def compute(flat, cap):
            o = flat.data["offsets"]
            return ColumnVector(T.INT32, (o[1: cap + 1] - o[:cap]).to(
                torch.int32), None)

        return _lift_unary(ctx, c, compute)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        return CpuCol(T.INT32, np.array(
            [len(v.encode()) if isinstance(v, str) else 0
             for v in c.values], np.int32), c.valid)


class BitLength(OctetLength):
    """bit_length(): 8 * octet_length."""

    def eval(self, ctx):
        base = super().eval(ctx)
        return ColumnVector(T.INT32, base.data * 8, base.validity)

    def eval_cpu(self, cols, ansi=False):
        base = super().eval_cpu(cols, ansi)
        return CpuCol(T.INT32, base.values * 8, base.valid)


class Left(Substring):
    """left(s, n) = substring(s, 1, n); n < 0 gives ''."""

    def __init__(self, child, n: int):
        super().__init__(child, 1, max(int(n), 0))

    def with_children(self, children):
        return Left(children[0], self.length)


class Right(Expression):
    """right(s, n): the last n characters ('' for n <= 0)."""

    def __init__(self, child, n: int):
        self.children = [child]
        self.n = int(n)

    def _params(self):
        return str(self.n)

    def with_children(self, children):
        return Right(children[0], self.n)

    def data_type(self):
        return T.STRING

    def eval(self, ctx):
        inner = Substring(self.children[0], 1, 0) if self.n <= 0 \
            else Substring(self.children[0], -self.n, self.n)
        return inner.eval(ctx)

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        n = self.n
        return CpuCol(T.STRING, _object_array(
            [v[-n:] if isinstance(v, str) and n > 0 else
             ("" if isinstance(v, str) else None) for v in c.values]),
            c.valid)


class Chr(Expression):
    """chr(n): the character of code n % 256 (Spark: a negative n gives
    '', chr(0) and chr(256) give '\\x00'); codes 128..255 are two UTF-8
    bytes."""

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return Chr(children[0])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.data.to(torch.int64)
        code = torch.where(v < 0, 0, torch.remainder(v, 256))
        two = code >= 128
        lens = torch.where(c.validity_or_default(ctx.num_rows) & (v >= 0),
                           torch.where(two, 2, 1), 0).to(torch.int32)
        row, within, total = K.expand_ranges(lens)
        out = torch.zeros(round_capacity(max(total, 1), minimum=8),
                          dtype=torch.uint8, device=v.device)
        if total:
            cd = code[row.to(torch.int64)]
            byte1 = torch.where(cd < 128, cd, 0xC0 | (cd >> 6))
            byte2 = 0x80 | (cd & 0x3F)
            out[:total] = torch.where(within == 1, byte2, byte1).to(
                torch.uint8)
        return ColumnVector(T.STRING, {"offsets": _offsets_of(lens),
                                       "bytes": out}, _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        out = []
        for v, ok in zip(c.values, c.valid):
            if not ok:
                out.append(None)
                continue
            n = int(v)
            out.append("" if n < 0 else chr(n % 256))
        return CpuCol(T.STRING, _object_array(out), c.valid)


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
