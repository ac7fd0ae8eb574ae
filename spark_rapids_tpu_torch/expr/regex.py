"""Device regex: a Java-regex subset compiled to a bit-parallel NFA.

Counterpart of ``spark_rapids_tpu/expr/regex.py`` (reference parity:
RegexParser.scala, which transpiles Java regex to cudf's engine and
rejects what it cannot express, so the expression runs on the CPU). The
pattern compiler is host Python and the JAX package's, copied: the same
subset, the same Glushkov NFA of at most 31 positions (``MAX_STATES - 1``),
the same byte classes (``.`` and negated classes expand to UTF-8
character alternations, so a multibyte character is ONE character) and
the same ``RegexUnsupported`` messages, which the planner's tag reasons
quote.

- Parsed: literals, escapes, character classes (``\\d \\w \\s`` and
  negations), ``.``, alternation, groups, greedy ``* + ? {m,n}``, anchors
  ``^ $``. Rejected (the expression runs on the CPU): backreferences,
  lookaround, lazy and possessive quantifiers, flags, named groups,
  Unicode classes, non-ASCII literals.
- The three evaluators run whole-plane torch ops over a flat string
  column's rows, in a Python loop over the longest row (one host read per
  call), where the JAX package runs ``lax.fori_loop``: ``nfa_eval``
  (RLIKE's find mode and LIKE's match mode), ``nfa_extract``
  (regexp_extract's leftmost-greedy group spans) and ``nfa_match_spans``
  (regexp_replace's non-overlapping spans).
- A state set is an int64 plane holding bits 0..31 (bit 0 is the start
  state): torch has no shifts of uint32, and bit 31 of an int32 is its
  sign. One step is ``reach(S) & B[byte]``; ``reach`` ORs the follow
  masks of S's set bits through four 256-entry tables, one per byte of S
  (host constants), instead of one masked OR per position.

Matching modes: "find" (Spark RLIKE: the pattern matches anywhere) and
"match" (the whole string, Java matches()).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

MAX_STATES = 32


class RegexUnsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RxNode:
    pass


@dataclasses.dataclass
class Atom(RxNode):
    """One byte-class position (bitset over byte values 0..255)."""
    bits: np.ndarray  # bool[256]


@dataclasses.dataclass
class Concat(RxNode):
    parts: List[RxNode]


@dataclasses.dataclass
class Alt(RxNode):
    parts: List[RxNode]


@dataclasses.dataclass
class Repeat(RxNode):
    child: RxNode
    min: int
    max: Optional[int]  # None = unbounded


@dataclasses.dataclass
class Empty(RxNode):
    pass


@dataclasses.dataclass
class Group(RxNode):
    """Capturing group marker (index 1-based). Transparent for matching;
    the tagged extraction path records its position spans."""
    index: int
    child: RxNode


def _bits_of(chars: str) -> np.ndarray:
    b = np.zeros(256, np.bool_)
    for ch in chars:
        for byte in ch.encode("utf-8"):
            if ord(ch) > 127:
                raise RegexUnsupported("non-ASCII literal in pattern")
        b[ord(ch)] = True
    return b


def _range_bits(lo: str, hi: str) -> np.ndarray:
    if ord(lo) > 127 or ord(hi) > 127:
        raise RegexUnsupported("non-ASCII class range")
    b = np.zeros(256, np.bool_)
    b[ord(lo): ord(hi) + 1] = True
    return b


_DIGIT = _range_bits("0", "9")
_WORD = _range_bits("a", "z") | _range_bits("A", "Z") | _DIGIT | _bits_of("_")
_SPACE = np.zeros(256, np.bool_)
for _c in " \t\n\x0b\f\r":
    _SPACE[ord(_c)] = True

_ASCII = np.zeros(256, np.bool_)
_ASCII[:128] = True
_LEAD2 = np.zeros(256, np.bool_)
_LEAD2[0xC0:0xE0] = True
_LEAD3 = np.zeros(256, np.bool_)
_LEAD3[0xE0:0xF0] = True
_LEAD4 = np.zeros(256, np.bool_)
_LEAD4[0xF0:0xF8] = True
_CONT = np.zeros(256, np.bool_)
_CONT[0x80:0xC0] = True


def _one_char(ascii_bits: np.ndarray) -> RxNode:
    """A class over CHARACTERS: the given ASCII bytes, or (for inclusive
    classes like ``.`` and negations) any multibyte UTF-8 character."""
    return Alt([Atom(ascii_bits & _ASCII),
                Concat([Atom(_LEAD2), Atom(_CONT)]),
                Concat([Atom(_LEAD3), Atom(_CONT), Atom(_CONT)]),
                Concat([Atom(_LEAD4), Atom(_CONT), Atom(_CONT), Atom(_CONT)])])


_ESCAPES = {
    "d": _DIGIT, "D": None, "w": _WORD, "W": None, "s": _SPACE, "S": None,
    "n": _bits_of("\n"), "t": _bits_of("\t"), "r": _bits_of("\r"),
}
_META = set(".^$*+?()[]{}|\\")


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.anchored_start = False
        self.anchored_end = False
        self.ngroups = 0

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    # pattern := alt ; alt := concat ('|' concat)*
    def parse(self) -> RxNode:
        node = self.alt(top=True)
        if self.i != len(self.p):
            raise RegexUnsupported(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self, top: bool = False) -> RxNode:
        before = (self.anchored_start, self.anchored_end)
        parts = [self.concat(top)]
        while self.peek() == "|":
            self.take()
            parts.append(self.concat(top))
        if len(parts) > 1 and (self.anchored_start, self.anchored_end) != before:
            # an anchor inside ONE branch must not anchor the others; the
            # flag model can't express per-branch anchors -> reject
            # (write ^(a|b) instead of ^a|b)
            raise RegexUnsupported("anchor inside alternation branch")
        return parts[0] if len(parts) == 1 else Alt(parts)

    def concat(self, top: bool) -> RxNode:
        parts: List[RxNode] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None or ch in ")|":
                break
            if ch == "^":
                if not (top and first):
                    raise RegexUnsupported("interior ^")
                self.take()
                self.anchored_start = True
                first = False
                continue
            if ch == "$":
                self.take()
                if self.peek() not in (None, "|"):
                    raise RegexUnsupported("interior $")
                self.anchored_end = True
                continue
            parts.append(self.quantified())
            first = False
        return Concat(parts) if parts else Empty()

    def quantified(self) -> RxNode:
        atom = self.atom()
        ch = self.peek()
        if ch in ("*", "+", "?"):
            self.take()
            if self.peek() in ("?", "+"):
                raise RegexUnsupported("lazy/possessive quantifier")
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[ch]
            return Repeat(atom, lo, hi)
        if ch == "{":
            j = self.p.find("}", self.i)
            if j < 0:
                raise RegexUnsupported("unterminated {")
            body = self.p[self.i + 1: j]
            self.i = j + 1
            if self.peek() in ("?", "+"):
                raise RegexUnsupported("lazy/possessive quantifier")
            if "," in body:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s else None
            else:
                lo = hi = int(body)
            if hi is not None and hi < lo:
                raise RegexUnsupported("bad {m,n}")
            if (hi or lo) > 16:
                raise RegexUnsupported("{m,n} too large for device NFA")
            return Repeat(atom, lo, hi)
        return atom

    def atom(self) -> RxNode:
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                raise RegexUnsupported("(?...) group")
            self.ngroups += 1
            gidx = self.ngroups
            inner = self.alt()
            if self.peek() != ")":
                raise RegexUnsupported("unterminated (")
            self.take()
            return Group(gidx, inner)
        if ch == "[":
            return self.char_class()
        if ch == ".":
            nl = np.zeros(256, np.bool_)
            nl[ord("\n")] = True
            return _one_char(_ASCII & ~nl)
        if ch == "\\":
            return self.escape()
        if ch in _META:
            raise RegexUnsupported(f"meta {ch!r}")
        if ord(ch) > 127:
            raise RegexUnsupported("non-ASCII literal")
        return Atom(_bits_of(ch))

    def escape(self) -> RxNode:
        ch = self.take()
        if ch in "\\.^$*+?()[]{}|/-":
            return Atom(_bits_of(ch))
        if ch in _ESCAPES:
            if ch == "D":
                return _one_char(_ASCII & ~_DIGIT)
            if ch == "W":
                return _one_char(_ASCII & ~_WORD)
            if ch == "S":
                return _one_char(_ASCII & ~_SPACE)
            return Atom(_ESCAPES[ch])
        raise RegexUnsupported(f"escape \\{ch}")

    def char_class(self) -> RxNode:
        neg = False
        if self.peek() == "^":
            self.take()
            neg = True
        bits = np.zeros(256, np.bool_)
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise RegexUnsupported("unterminated [")
            if ch == "]" and not first:
                self.take()
                break
            self.take()
            first = False
            if ch == "\\":
                e = self.take()
                if e in _ESCAPES and _ESCAPES[e] is not None:
                    bits |= _ESCAPES[e]
                    continue
                if e in "\\.^$*+?()[]{}|/-":
                    ch = e
                else:
                    raise RegexUnsupported(f"class escape \\{e}")
            if ord(ch) > 127:
                raise RegexUnsupported("non-ASCII in class")
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi = self.take()
                if hi == "\\":
                    hi = self.take()
                bits |= _range_bits(ch, hi)
            else:
                bits[ord(ch)] = True
        if neg:
            return _one_char(_ASCII & ~bits)
        return Atom(bits)


# ---------------------------------------------------------------------------
# Glushkov construction -> bit-parallel NFA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NFA:
    n: int                      # number of positions (states 1..n; 0 = start)
    byte_classes: np.ndarray    # bool[n, 256]
    first: int                  # bitmask of initial positions
    last: int                   # bitmask of accepting positions
    follow: List[int]           # per position, bitmask of successors
    nullable: bool
    anchored_start: bool
    anchored_end: bool
    #: Java matches() semantics: the WHOLE input must match, and the
    #: find-mode `$`-before-trailing-newline concession does NOT apply
    full_match: bool = False


def _expand_repeat(node: RxNode) -> RxNode:
    """{m,n} -> explicit concatenation (Glushkov needs *,+,? only)."""
    if isinstance(node, Repeat):
        c = _expand_repeat(node.child)
        if (node.min, node.max) in ((0, None), (1, None), (0, 1)):
            return Repeat(c, node.min, node.max)
        parts = [c] * node.min
        if node.max is None:
            parts.append(Repeat(c, 0, None))
        else:
            parts += [Repeat(c, 0, 1)] * (node.max - node.min)
        return Concat([_clone(p) for p in parts])
    if isinstance(node, Concat):
        return Concat([_expand_repeat(p) for p in node.parts])
    if isinstance(node, Alt):
        return Alt([_expand_repeat(p) for p in node.parts])
    if isinstance(node, Group):
        return Group(node.index, _expand_repeat(node.child))
    return node


def _clone(node: RxNode) -> RxNode:
    if isinstance(node, Atom):
        return Atom(node.bits.copy())
    if isinstance(node, Concat):
        return Concat([_clone(p) for p in node.parts])
    if isinstance(node, Alt):
        return Alt([_clone(p) for p in node.parts])
    if isinstance(node, Repeat):
        return Repeat(_clone(node.child), node.min, node.max)
    if isinstance(node, Group):
        return Group(node.index, _clone(node.child))
    return Empty()


def glushkov(ast: RxNode, anchored_start: bool, anchored_end: bool) -> NFA:
    ast = _expand_repeat(ast)
    atoms: List[Atom] = []

    def number(node):
        if isinstance(node, Atom):
            atoms.append(node)
            if len(atoms) > MAX_STATES - 1:
                raise RegexUnsupported(
                    f"pattern needs > {MAX_STATES - 1} NFA positions")
            return
        if isinstance(node, (Concat, Alt)):
            for p in node.parts:
                number(p)
        elif isinstance(node, (Repeat, Group)):
            number(node.child)

    number(ast)
    pos_of = {id(a): i + 1 for i, a in enumerate(atoms)}

    def analyze(node) -> Tuple[int, int, bool]:
        """returns (first_mask, last_mask, nullable); fills follow."""
        if isinstance(node, Empty):
            return 0, 0, True
        if isinstance(node, Atom):
            m = 1 << pos_of[id(node)]
            return m, m, False
        if isinstance(node, Alt):
            f = l = 0
            nul = False
            for p in node.parts:
                pf, pl, pn = analyze(p)
                f |= pf
                l |= pl
                nul = nul or pn
            return f, l, nul
        if isinstance(node, Concat):
            f = l = 0
            nul = True
            for p in node.parts:
                pf, pl, pn = analyze(p)
                # follow: every last of the prefix connects to first of p
                for i in range(1, len(atoms) + 1):
                    if l & (1 << i):
                        follow[i] |= pf
                if nul:
                    f |= pf
                l = pl | (l if pn else 0)
                nul = nul and pn
            return f, l, nul
        if isinstance(node, Repeat):
            cf, cl, cn = analyze(node.child)
            if node.max is None:  # * or +
                for i in range(1, len(atoms) + 1):
                    if cl & (1 << i):
                        follow[i] |= cf
            nul = cn or node.min == 0
            return cf, cl, nul
        if isinstance(node, Group):
            return analyze(node.child)
        raise RegexUnsupported(type(node).__name__)

    follow = [0] * (len(atoms) + 1)
    first, last, nullable = analyze(ast)
    bc = np.zeros((len(atoms) + 1, 256), np.bool_)
    for a, i in ((a, pos_of[id(a)]) for a in atoms):
        bc[i] = a.bits
    return NFA(len(atoms), bc, first, last, follow, nullable,
               anchored_start, anchored_end)


def compile_pattern(pattern: str, mode: str = "find") -> NFA:
    """Parse + compile, raising RegexUnsupported for constructs outside the
    device subset. mode='find' (RLIKE semantics) treats the pattern as
    unanchored unless ^/$ appear."""
    p = _Parser(pattern)
    ast = p.parse()
    nfa = glushkov(ast, p.anchored_start, p.anchored_end)
    if mode == "match":
        nfa.anchored_start = True
        nfa.anchored_end = True
        nfa.full_match = True
    return nfa


def _byte_table(nfa: NFA) -> np.ndarray:
    """u32[256]: for each byte value, the set of positions matching it."""
    tbl = np.zeros(256, np.uint32)
    for i in range(1, nfa.n + 1):
        tbl |= np.where(nfa.byte_classes[i], np.uint32(1 << i), np.uint32(0))
    return tbl


MAX_TAG_STATES = 12


def _first_set(node, pos_of) -> int:
    """first-position bitmask of a subtree (mirrors analyze())."""
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Atom):
        return 1 << pos_of[id(node)]
    if isinstance(node, Alt):
        f = 0
        for p in node.parts:
            f |= _first_set(p, pos_of)
        return f
    if isinstance(node, Concat):
        f = 0
        for p in node.parts:
            f |= _first_set(p, pos_of)
            if not _nullable(p):
                break
        return f
    if isinstance(node, (Repeat, Group)):
        return _first_set(node.child, pos_of)
    return 0


def _nullable(node) -> bool:
    if isinstance(node, Empty):
        return True
    if isinstance(node, Atom):
        return False
    if isinstance(node, Alt):
        return any(_nullable(p) for p in node.parts)
    if isinstance(node, Concat):
        return all(_nullable(p) for p in node.parts)
    if isinstance(node, Repeat):
        return node.min == 0 or _nullable(node.child)
    if isinstance(node, Group):
        return _nullable(node.child)
    return False


def _members(node, pos_of) -> int:
    if isinstance(node, Atom):
        return 1 << pos_of[id(node)]
    m = 0
    for c in (node.parts if isinstance(node, (Concat, Alt))
              else [node.child] if isinstance(node, (Repeat, Group))
              else []):
        m |= _members(c, pos_of)
    return m


def _has_alt(node) -> bool:
    if isinstance(node, Alt):
        return True
    kids = (node.parts if isinstance(node, (Concat, Alt))
            else [node.child] if isinstance(node, (Repeat, Group)) else [])
    return any(_has_alt(k) for k in kids)


@dataclasses.dataclass
class TaggedNFA:
    """NFA + capture-group metadata for ONE group. The tagged simulation
    is restricted to alternation-free patterns, where leftmost-greedy
    disambiguation reduces to (minimal match start, then per-step
    preference for the lowest predecessor position) — the linear-spine
    subset the reference's transpiler also handles most cleanly.
    group 0 = the whole match.

    reset_edges: (f, to) pairs whose traversal RESTARTS the group span —
    entries from outside the group plus loop-back edges of repeats that
    wrap the group (Java keeps the LAST iteration's capture); loop edges
    of repeats INSIDE the group extend the span instead.
    """
    nfa: NFA
    member_mask: int
    entry_mask: int
    reset_edges: frozenset


def compile_extract(pattern: str, group: int) -> TaggedNFA:
    """Compile for submatch extraction. Raises RegexUnsupported outside
    the tagged subset (alternation, > MAX_TAG_STATES positions, bad
    group index)."""
    p = _Parser(pattern)
    ast0 = p.parse()
    if group < 0 or group > p.ngroups:
        raise RegexUnsupported(f"group {group} of {p.ngroups}")
    if _has_alt(ast0):
        raise RegexUnsupported("alternation in extract pattern")
    if p.anchored_end:
        # the tagged accept snapshot records matches at every position;
        # $-anchoring needs an end-of-row gate (and the Java trailing-\n
        # concession) — reject to CPU rather than diverge
        raise RegexUnsupported("$-anchored extract pattern")
    ast = _expand_repeat(ast0)
    atoms: List[Atom] = []

    def number(node):
        if isinstance(node, Atom):
            atoms.append(node)
        elif isinstance(node, (Concat, Alt)):
            for q in node.parts:
                number(q)
        elif isinstance(node, (Repeat, Group)):
            number(node.child)

    number(ast)
    if len(atoms) > MAX_TAG_STATES:
        raise RegexUnsupported(
            f"extract pattern needs > {MAX_TAG_STATES} positions")
    pos_of = {id(a): i + 1 for i, a in enumerate(atoms)}

    # members/entries of every clone of the requested group (group 0 =
    # whole pattern). Multiple clones arise from {m,n} expansion; their
    # masks union — the per-edge reset set disambiguates instances.
    member_mask = 0
    entry_mask = 0
    if group == 0:
        member_mask = _members(ast, pos_of)
        entry_mask = _first_set(ast, pos_of)
    else:
        def collect(node):
            nonlocal member_mask, entry_mask
            if isinstance(node, Group) and node.index == group:
                member_mask |= _members(node, pos_of)
                entry_mask |= _first_set(node, pos_of)
                return
            for c in (node.parts if isinstance(node, (Concat, Alt))
                      else [node.child]
                      if isinstance(node, (Repeat, Group)) else []):
                collect(c)
        collect(ast)
        if member_mask == 0:
            raise RegexUnsupported("empty or never-matching group")

    # Re-run the follow analysis with edge attribution: an edge resets
    # the group when it ENTERS the group from outside, or when it is a
    # loop-back added by a repeat that is NOT inside the group.
    reset_edges = set()

    def record_edges(last_mask, first_mask, inside_group):
        for f in range(1, len(atoms) + 1):
            if last_mask & (1 << f):
                for to in range(1, len(atoms) + 1):
                    if first_mask & (1 << to) and entry_mask & (1 << to):
                        from_outside = not (member_mask & (1 << f))
                        if from_outside or not inside_group:
                            reset_edges.add((f, to))

    def analyze2(node, inside_group):
        if isinstance(node, Empty):
            return 0, 0, True
        if isinstance(node, Atom):
            m = 1 << pos_of[id(node)]
            return m, m, False
        if isinstance(node, Group):
            return analyze2(node.child,
                            inside_group
                            or (group != 0 and node.index == group))
        if isinstance(node, Concat):
            f = l = 0
            nul = True
            for q in node.parts:
                qf, ql, qn = analyze2(q, inside_group)
                record_edges(l, qf, inside_group)
                if nul:
                    f |= qf
                l = ql | (l if qn else 0)
                nul = nul and qn
            return f, l, nul
        if isinstance(node, Repeat):
            cf, cl, cn = analyze2(node.child, inside_group)
            if node.max is None:
                record_edges(cl, cf, inside_group)
            return cf, cl, cn or node.min == 0
        raise RegexUnsupported(type(node).__name__)

    analyze2(ast, group == 0)
    # seed entries (from the start state) always reset
    nfa = glushkov(ast, p.anchored_start, p.anchored_end)
    for to in range(1, nfa.n + 1):
        if nfa.first & (1 << to) and entry_mask & (1 << to):
            reset_edges.add((0, to))
        # entries reached from non-member positions reset too (concat
        # edges from before the group)
        for f in range(1, nfa.n + 1):
            if nfa.follow[f] & (1 << to) and entry_mask & (1 << to) \
                    and not (member_mask & (1 << f)):
                reset_edges.add((f, to))
    return TaggedNFA(nfa, member_mask, entry_mask, frozenset(reset_edges))


def compile_replace(pattern: str) -> TaggedNFA:
    """Compile for replace-all. The tagged whole-match subset, minus
    patterns that can match the empty string (Java inserts a replacement
    at every position for those — reject to the CPU tier rather than
    emulate) and $-anchoring (inherited from compile_extract)."""
    t = compile_extract(pattern, 0)
    if t.nfa.nullable:
        raise RegexUnsupported("pattern matches the empty string")
    return t



# ---------------------------------------------------------------------------
# Evaluation over flat string planes (torch)
# ---------------------------------------------------------------------------

_BIG = int(np.iinfo(np.int32).max)


def _reach_tables(nfa: NFA) -> np.ndarray:
    """int64[4, 256]: table k maps byte k of a state set to the OR of the
    follow masks of its set bits (bit 0, the start state, follows into
    ``first``), so reach(S) is four gathers instead of one masked OR per
    position."""
    succ = [nfa.first] + [int(f) for f in nfa.follow[1:]]
    succ += [0] * (32 - len(succ))
    tbl = np.zeros((4, 256), np.int64)
    for k in range(4):
        for bit in range(8):
            m = succ[8 * k + bit]
            if m:
                sel = (np.arange(256) >> bit) & 1 == 1
                tbl[k, sel] |= m
    return tbl


class _Rows:
    """A flat string column's rows: starts and lengths (int64), the plane,
    and the longest row, read from the device once."""

    def __init__(self, offsets: torch.Tensor, raw: torch.Tensor,
                 valid: Optional[torch.Tensor] = None):
        o = offsets.to(torch.int64)
        self.raw = raw
        self.starts = o[:-1]
        self.lens = o[1:] - o[:-1]
        self.n = self.lens.shape[0]
        self.nb = raw.shape[0]
        lens = self.lens if valid is None else torch.where(valid, self.lens,
                                                           0)
        self.maxlen = int(lens.max().item()) if self.n else 0

    def byte(self, pos: int) -> torch.Tensor:
        """int64 byte at row-relative position pos of every row (clamped
        into the plane past a row's end, as the JAX package reads)."""
        if self.nb == 0:
            return torch.zeros(self.n, dtype=torch.int64,
                               device=self.raw.device)
        idx = (self.starts + pos).clamp_(0, self.nb - 1)
        return self.raw[idx].to(torch.int64)

    def table(self, values: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(values.astype(np.int64),
                               device=self.raw.device)


def _reach(S: torch.Tensor, tables: List[Tuple[int, torch.Tensor]]):
    out = None
    for k, t in tables:
        r = t[(S >> (8 * k)) & 255] if k else t[S & 255]
        out = r if out is None else out | r
    return out if out is not None else torch.zeros_like(S)


def nfa_eval(nfa: NFA, offsets: torch.Tensor, raw: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[n_rows]: does each row's string match? One step per byte
    position up to the longest row: S = reach(S) & B[byte] over the rows'
    state sets (the JAX package's ``nfa_eval``)."""
    rows = _Rows(offsets, raw, valid)
    lens = rows.lens
    B = rows.table(_byte_table(nfa))
    full = rows.table(_reach_tables(nfa))
    # bytes of S above the last position are always 0
    tables = [(k, full[k]) for k in range(4) if 8 * k <= nfa.n]
    last = int(nfa.last)
    seed = not nfa.anchored_start
    dev = raw.device
    S = torch.ones(rows.n, dtype=torch.int64, device=dev)  # start state
    done = torch.zeros(rows.n, dtype=torch.bool, device=dev)
    pre_nl = torch.zeros_like(done)
    for pos in range(rows.maxlen):
        byte = rows.byte(pos)
        active = lens > pos
        if not nfa.full_match:
            # Java `$` (find mode) also matches just before a single
            # trailing newline: hit when the un-consumed suffix is "\n"
            pre_nl |= active & (lens == pos + 1) & (byte == 10) \
                & ((S & last) != 0)
        nxt = _reach(S, tables) & B[byte]
        if seed:
            nxt |= S & 1
        S = torch.where(active, nxt, S)
        if not nfa.anchored_end:
            done |= ((S & last) != 0) & active
    if nfa.anchored_end:
        res = ((S & last) != 0) | pre_nl
    else:
        res = done | ((S & last) != 0)
    if nfa.nullable:
        if nfa.anchored_start and nfa.anchored_end:
            # full-string semantics: the empty match covers "" (and, in
            # find mode's ^...$ form, a lone line terminator)
            res = res | (lens == 0)
            if not nfa.full_match:
                res = res | ((lens == 1) & (rows.byte(0) == 10))
        else:
            # an unanchored side means the empty match fits anywhere
            res = torch.ones_like(res)
    if valid is not None:
        res = res & valid
    return res


def _preds(nfa: NFA) -> List[List[int]]:
    """Per position, its predecessor positions (0 = the start state)."""
    preds: List[List[int]] = [[] for _ in range(nfa.n + 1)]
    for i in range(1, nfa.n + 1):
        if nfa.first & (1 << i):
            preds[i].append(0)
        for f in range(1, nfa.n + 1):
            if nfa.follow[f] & (1 << i):
                preds[i].append(f)
    return preds


def nfa_extract(t: TaggedNFA, offsets: torch.Tensor, raw: torch.Tensor):
    """Per row: (matched bool, group byte start, group byte end), int32
    row-relative positions; a matched row whose group did not participate
    reports start = end (the empty string, Spark's regexp_extract). The
    JAX package's ``nfa_extract``: per-state match-start, group-start and
    group-end registers, predecessors taken in priority order (smaller
    position first, the start state last), and an accept snapshot that
    keeps the leftmost start, then the longest end."""
    nfa = t.nfa
    n = nfa.n
    rows = _Rows(offsets, raw)
    lens = rows.lens
    nrows = rows.n
    dev = raw.device
    B = rows.table(_byte_table(nfa))
    preds = _preds(nfa)
    member = t.member_mask
    i32 = torch.int32

    def full(v):
        return torch.full((nrows,), v, dtype=i32, device=dev)

    S = torch.zeros(nrows, dtype=torch.int64, device=dev)
    ms = [full(_BIG) for _ in range(n + 1)]
    gs = [full(-1) for _ in range(n + 1)]
    ge = [full(-1) for _ in range(n + 1)]
    b_has = torch.zeros(nrows, dtype=torch.bool, device=dev)
    b_ms, b_gs, b_ge = full(_BIG), full(-1), full(-1)
    for pos in range(rows.maxlen):
        active = lens > pos
        hit_bits = B[rows.byte(pos)]
        new_ms, new_gs, new_ge, alive_bits = [None], [None], [None], []
        for to in range(1, n + 1):
            to_hit = ((hit_bits >> to) & 1) != 0
            cand_ms, cand_gs, cand_ge = full(_BIG), full(-1), full(-1)
            got = torch.zeros(nrows, dtype=torch.bool, device=dev)
            is_entry = bool(t.entry_mask & (1 << to))
            order = sorted(f for f in preds[to] if f != 0) \
                + ([0] if 0 in preds[to] else [])
            for f in order:
                if f == 0:
                    if nfa.anchored_start and pos != 0:
                        continue  # the start state is dead past position 0
                    f_alive = None  # every row
                    f_ms, f_gs, f_ge = pos, -1, -1
                else:
                    f_alive = ((S >> f) & 1) != 0
                    f_ms, f_gs, f_ge = ms[f], gs[f], ge[f]
                # the group registers across this static (f, to) edge:
                # the reset set restarts the span (Java keeps the last
                # iteration's capture), other in-group edges extend it
                if member & (1 << to):
                    e_gs = pos if ((f, to) in t.reset_edges
                                   or (is_entry and f == 0)) else f_gs
                    e_ge = pos + 1
                else:
                    e_gs, e_ge = f_gs, f_ge
                better = ~got | (cand_ms > f_ms)
                if f_alive is not None:
                    better = better & f_alive
                cand_ms = torch.where(better, f_ms, cand_ms)
                cand_gs = torch.where(better, e_gs, cand_gs)
                cand_ge = torch.where(better, e_ge, cand_ge)
                got = torch.ones_like(got) if f_alive is None \
                    else got | f_alive
            ok = got & to_hit & active
            new_ms.append(torch.where(ok, cand_ms, _BIG))
            new_gs.append(torch.where(ok, cand_gs, -1))
            new_ge.append(torch.where(ok, cand_ge, -1))
            alive_bits.append(ok)
        S2 = torch.zeros_like(S)
        for to, ok in zip(range(1, n + 1), alive_bits):
            S2 |= ok.to(torch.int64) << to
        # registers of rows past their end keep their state; index 0 (the
        # start state's) is constant
        for i in range(1, n + 1):
            ms[i] = torch.where(active, new_ms[i], ms[i])
            gs[i] = torch.where(active, new_gs[i], gs[i])
            ge[i] = torch.where(active, new_ge[i], ge[i])
        S = torch.where(active, S2, S)
        # accept snapshot: leftmost start, then longest end (latest pos)
        acc_has = torch.zeros(nrows, dtype=torch.bool, device=dev)
        acc_ms, acc_gs, acc_ge = full(_BIG), full(-1), full(-1)
        for i in range(1, n + 1):
            if nfa.last & (1 << i):
                alive = (((S2 >> i) & 1) != 0) & active
                better = alive & (~acc_has | (ms[i] < acc_ms))
                acc_ms = torch.where(better, ms[i], acc_ms)
                acc_gs = torch.where(better, gs[i], acc_gs)
                acc_ge = torch.where(better, ge[i], acc_ge)
                acc_has = acc_has | alive
        replace = acc_has & (~b_has | (acc_ms <= b_ms))
        b_has = b_has | acc_has
        b_ms = torch.where(replace, acc_ms, b_ms)
        b_gs = torch.where(replace, acc_gs, b_gs)
        b_ge = torch.where(replace, acc_ge, b_ge)
    has, bgs, bge = b_has, b_gs, b_ge
    if nfa.nullable:
        # the empty match at position 0 wins when nothing matched earlier
        take = ~has
        has = torch.ones_like(has)
        bgs = torch.where(take, 0, bgs)
        bge = torch.where(take, 0, bge)
    # a group that did not participate is the empty span
    g0 = torch.where(has & (bgs >= 0), bgs, 0)
    g1 = torch.where(has & (bge >= 0), bge, 0)
    return has, g0, torch.maximum(g1, g0)


def nfa_match_spans(t: TaggedNFA, offsets: torch.Tensor, raw: torch.Tensor):
    """Per-BYTE match layout for replace-all: (start_flags bool[nbytes],
    span_len int32[nbytes]): start_flags marks the first byte of each
    committed match and span_len its byte length.

    One left-to-right pass over the rows in parallel (the JAX package's
    ``nfa_match_spans``): per-state match-start registers merge by minimum
    (leftmost wins), a candidate (start, end) extends greedily while a
    thread with that start is alive, and commits the moment no alive
    thread could give an equal or earlier start, or at the row's end. The
    cursor then jumps past the match (non-overlapping, like Java's
    appendReplacement loop). A commit writes the two planes at its start
    byte; a row without one writes its own slot past the plane (a row
    commits at most one match a step, and matches never share a start
    byte), so no write leaves its range and none collides."""
    nfa = t.nfa
    n = nfa.n
    rows = _Rows(offsets, raw)
    lens = rows.lens
    nrows, nb = rows.n, rows.nb
    dev = raw.device
    B = rows.table(_byte_table(nfa))
    preds = _preds(nfa)
    accepting = [i for i in range(1, n + 1) if nfa.last & (1 << i)]
    i32 = torch.int32
    starts = rows.starts
    pad = nb + torch.arange(nrows, dtype=torch.int64, device=dev)
    flags = torch.zeros(nb + nrows, dtype=torch.bool, device=dev)
    slen = torch.zeros(nb + nrows, dtype=i32, device=dev)
    ms = [torch.full((nrows,), _BIG, dtype=i32, device=dev)
          for _ in range(n)]
    cand_s = torch.full((nrows,), _BIG, dtype=i32, device=dev)
    cand_e = torch.full((nrows,), -1, dtype=i32, device=dev)
    cursor = torch.zeros(nrows, dtype=i32, device=dev)
    for pos in range(rows.maxlen):
        in_row = lens > pos
        hit_bits = B[rows.byte(pos)]
        seed_ok = cursor <= pos
        if nfa.anchored_start and pos != 0:
            seed_ok = None  # the start state is dead past position 0
        new_ms = []
        for to in range(1, n + 1):
            to_hit = ((hit_bits >> to) & 1) != 0
            best = None
            for f in preds[to]:
                if f == 0:
                    if seed_ok is None:
                        continue
                    cand = torch.where(seed_ok, pos, _BIG).to(i32)
                else:
                    cand = ms[f - 1]
                best = cand if best is None else torch.minimum(best, cand)
            if best is None:
                best = torch.full((nrows,), _BIG, dtype=i32, device=dev)
            new_ms.append(torch.where(to_hit & in_row, best, _BIG))
        # accept: the least start among accepting states
        acc = torch.full((nrows,), _BIG, dtype=i32, device=dev)
        for i in accepting:
            acc = torch.minimum(acc, new_ms[i - 1])
        better = acc < cand_s
        extend = acc == cand_s
        cand_e = torch.where((better | extend) & (acc < _BIG), pos + 1,
                             cand_e)
        cand_s = torch.where(better, acc, cand_s)
        # commit when no alive thread can reach a start <= it, or row end
        min_alive = new_ms[0]
        for m in new_ms[1:]:
            min_alive = torch.minimum(min_alive, m)
        done_row = lens <= pos + 1
        commit = (cand_s < _BIG) & ((min_alive > cand_s) | done_row)
        tgt = torch.where(commit, starts + cand_s, pad)
        flags[tgt] = commit
        slen[tgt] = torch.where(commit, cand_e - cand_s, 0)
        cursor = torch.where(commit, cand_e, cursor)
        # kill threads inside the committed span; a fresh accept this same
        # step at or after the new cursor becomes the next candidate
        ms = [torch.where(m < cursor, _BIG, m) for m in new_ms]
        resee = commit & (acc >= cursor) & (acc < _BIG)
        cand_s = torch.where(commit, torch.where(resee, acc, _BIG), cand_s)
        cand_e = torch.where(commit, torch.where(resee, pos + 1, -1).to(i32),
                             cand_e)
    return flags[:nb], slen[:nb]
