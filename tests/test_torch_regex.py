"""Parity of the port's device regex (``spark_rapids_tpu_torch/expr/
regex.py``) and the expressions on it with the JAX package, on the CPU.

- The pattern compiler: the same positions, first/last/follow masks,
  nullability, anchors and byte table for every supported pattern, the
  same group metadata for extraction, and the same ``RegexUnsupported``
  message for every rejected one (the tag reasons quote it), including
  the 31-position limit (bit 31 of the state set is used) and 32.
- The three evaluators on the JAX package's corpus, against its own
  evaluators and against Python ``re``.
- LIKE (both arms), RLIKE, regexp_extract and regexp_replace through
  ``TpuSession`` and ``TorchSession(device="cpu")``, over flat and
  dictionary columns, and the placement of rejected patterns: the CPU,
  with the JAX package's reason.

Every comparison is exact.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.expr import regex as JR
from spark_rapids_tpu.plan import overrides as JO

from spark_rapids_tpu_torch.expr import regex as PR
from spark_rapids_tpu_torch.plan import overrides as PO

#: the JAX package's corpus (tests/test_regex.py), with a trailing newline
#: row for find mode's `$` and a 31-letter row
LONG31 = "abcdefghijklmnopqrstuvwxyzabcde"
CORPUS = ["", "a", "abc", "aabbb", "hello world", "123", "a1b2", "  pad  ",
          "ABC", "abcabc", "xyz", "a.b", "[x]", "über", "日本語abc", "\n",
          "line1\nline2", "aaaa", "zzz9", "foo_bar", "a-b", "3.14", "-42",
          "abc\n", "x" + LONG31 + "y", "blithely quickly"]

SUPPORTED = [
    "abc", "^abc", "abc$", "^abc$", "a+b*c?", "[abc]+", "[^abc]+",
    "[a-z0-9]+", r"\d+", r"\w+", r"\s", r"\d{2,3}", "a{2}", "(ab)+c",
    "ab|cd|ef", "^(foo|bar)_", "a.c", ".*", "x?yz", r"[-+]?\d+",
    r"\d+\.\d+", "(a|b)(c|d)", "^$", "b(l|r)[a-z]+ly", LONG31,
]

#: (pattern, the JAX package's message)
UNSUPPORTED = [
    (r"(?i)abc", "(?...) group"), (r"a(?=b)", "(?...) group"),
    (r"(a)\1", "escape \\1"), (r"a*?", "lazy/possessive quantifier"),
    (r"a*+", "lazy/possessive quantifier"), (r"\p{L}", "escape \\p"),
    ("日本", "non-ASCII literal"), ("a|^b", "anchor inside alternation branch"),
    ("a^b", "interior ^"), ("a$b", "interior $"), ("a{17}",
                                                    "{m,n} too large"),
    (LONG31 + "f", "pattern needs > 31 NFA positions"),
]

EXTRACT_CASES = [
    (r"(\d+)", 1), (r"(\d+)-(\d+)", 1), (r"(\d+)-(\d+)", 2),
    (r"([a-c]+)(\d*)", 2), (r"(a+)(a*)", 1), (r"v(\d+)\.(\d+)", 2),
    (r"(ab)+", 1), (r"(a?)(b)", 1), (r"x(y?)z", 1), (r"(\w+)\s", 1),
    (r"([0-9]{3})-([0-9]{4})", 1), (r"(a*)b", 1), ("([a-z]+)ly ", 1),
    (r"(\d+)", 0),
]

EXTRACT_REJECTED = [
    (r"(foo|bar)x", 1, "alternation in extract pattern"),
    (r"(\d+)$", 1, "$-anchored extract pattern"),
    (r"(\d+)", 2, "group 2 of 1"),
    ("(ab)cdefghijklm", 1, "extract pattern needs > 12 positions"),
]

REPLACE_CASES = [("ab", "_"), ("[0-9]+", "N"), ("a+b", "<>"), ("b", ""),
                 ("xyz", "Q"), ("^ab", "S"), ("ab*c?", "*"), ("[aeiou]+", "*")]


def _planes(corpus):
    data = "".join(corpus).encode("utf-8")
    offs = np.concatenate([[0], np.cumsum(
        [len(s.encode("utf-8")) for s in corpus])]).astype(np.int32)
    raw = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    return ((jnp.asarray(offs), jnp.asarray(raw)),
            (torch.from_numpy(offs), torch.from_numpy(raw.copy())))


def _same_nfa(a, b):
    assert (a.n, a.first, a.last, list(a.follow), a.nullable,
            a.anchored_start, a.anchored_end, a.full_match) \
        == (b.n, b.first, b.last, list(b.follow), b.nullable,
            b.anchored_start, b.anchored_end, b.full_match)
    np.testing.assert_array_equal(PR._byte_table(a), JR._byte_table(b))


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["find", "match"])
def test_compiler_matches_jax(mode):
    for p in SUPPORTED:
        _same_nfa(PR.compile_pattern(p, mode), JR.compile_pattern(p, mode))
    # bit 31 of the state set is a position at exactly 31
    assert PR.compile_pattern(LONG31).last == 1 << 31
    for p, g in EXTRACT_CASES:
        a, b = PR.compile_extract(p, g), JR.compile_extract(p, g)
        _same_nfa(a.nfa, b.nfa)
        assert (a.member_mask, a.entry_mask, a.reset_edges) \
            == (b.member_mask, b.entry_mask, b.reset_edges)


@pytest.mark.parametrize("pattern,message", UNSUPPORTED)
def test_rejections_carry_the_jax_message(pattern, message):
    msgs = []
    for rx in (PR, JR):
        with pytest.raises(rx.RegexUnsupported) as e:
            rx.compile_pattern(pattern)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and message in msgs[0]


def test_extract_and_replace_rejections_carry_the_jax_message():
    for p, g, message in EXTRACT_REJECTED:
        msgs = []
        for rx in (PR, JR):
            with pytest.raises(rx.RegexUnsupported) as e:
                rx.compile_extract(p, g)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and message in msgs[0], (p, msgs)
    for rx in (PR, JR):
        with pytest.raises(rx.RegexUnsupported,
                           match="pattern matches the empty string"):
            rx.compile_replace("a*")


# ---------------------------------------------------------------------------
# the evaluators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", SUPPORTED)
def test_nfa_eval_matches_jax_and_re(pattern):
    (jo, jr), (to, tr) = _planes(CORPUS)
    # Java's \\w, \\d and \\s are ASCII classes: re.ASCII's
    prog = re.compile(pattern, re.ASCII)
    for mode in ("find", "match"):
        got = PR.nfa_eval(PR.compile_pattern(pattern, mode), to, tr).numpy()
        if mode == "find":
            # match mode meets the JAX package's evaluator through LIKE
            # (test_regex_expressions_match_jax_on_the_device)
            want = np.asarray(JR.nfa_eval(JR.compile_pattern(pattern, mode),
                                          jo, jr, None))
            np.testing.assert_array_equal(got, want)
        f = prog.search if mode == "find" else prog.fullmatch
        assert list(got) == [bool(f(s)) for s in CORPUS], mode


def test_nfa_eval_valid_mask_and_empty_plane():
    (jo, jr), (to, tr) = _planes(CORPUS)
    valid = np.arange(len(CORPUS)) % 3 != 0
    nfa = PR.compile_pattern("b(l|r)[a-z]+ly")
    got = PR.nfa_eval(nfa, to, tr, torch.from_numpy(valid)).numpy()
    want = np.asarray(JR.nfa_eval(JR.compile_pattern("b(l|r)[a-z]+ly"),
                                  jo, jr, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    empty = PR.nfa_eval(PR.compile_pattern("^$"), torch.zeros(3, dtype=(
        torch.int32)), torch.zeros(0, dtype=torch.uint8))
    assert empty.tolist() == [True, True]


@pytest.mark.parametrize("pattern,group", EXTRACT_CASES)
def test_nfa_extract_matches_jax_and_re(pattern, group):
    pool = ["abc123def", "12-34", "x1-2y", "", "aaa", "v10.42", "ababab",
            "b", "cb", "xyz zz", "call 555-1234 now", "aab", "a1b22c333",
            "hello world", "5551234", "12345", "über 42", "quickly blithely "]
    (jo, jr), (to, tr) = _planes(pool)
    has, g0, g1 = PR.nfa_extract(PR.compile_extract(pattern, group), to, tr)
    want = JR.nfa_extract(JR.compile_extract(pattern, group), jo, jr)
    for a, b in zip((has, g0, g1), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    prog = re.compile(pattern, re.ASCII)
    for s, h, a, b in zip(pool, has.tolist(), g0.tolist(), g1.tolist()):
        m = prog.search(s)
        # a row that does not match, and a group that does not take part,
        # give ""
        expect = (m.group(group) or "") if m else ""
        assert (s.encode()[a:b].decode() if h else "") == expect, s


@pytest.mark.parametrize("pattern,rep", REPLACE_CASES)
def test_nfa_match_spans_matches_jax_and_re(pattern, rep):
    rows = ["abab", "xxabx", "", "aabb", "no match", "a1b22c333", "aaab",
            "café ab café", "ababab", "edge ab", "ab edge", "quietly bold"]
    (jo, jr), (to, tr) = _planes(rows)
    flags, slen = PR.nfa_match_spans(PR.compile_replace(pattern), to, tr)
    wf, ws = JR.nfa_match_spans(JR.compile_replace(pattern), jo, jr)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(slen.numpy(), np.asarray(ws))
    # the spans are re's non-overlapping matches, byte for byte
    offs = to.tolist()
    starts = set(np.nonzero(flags.numpy())[0].tolist())
    want = set()
    for s, base in zip(rows, offs):
        for m in re.finditer(pattern, s):
            want.add(base + len(s[:m.start()].encode()))
    assert starts == want


# ---------------------------------------------------------------------------
# the expressions through both sessions
# ---------------------------------------------------------------------------

WORDS = ["quickly", "blithely", "furiously", "ironic ideas", "bold", "",
         "über alles", "日本語 ly", "a_c", "abc", "cat", "cut", "cart", "ct",
         "slyly ruthless", "x1-22y", "a\nb", "brly", "quietly sleep"]


def _table(kind: str, n: int = 300, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    if kind == "dict":
        vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    else:
        vals = [WORDS[i] + " " + WORDS[j] + str(k) for i, j, k in zip(
            rng.integers(0, len(WORDS), n), rng.integers(0, len(WORDS), n),
            rng.integers(0, 1000, n))]
        vals[:len(WORDS)] = WORDS
    return pa.table({"s": pa.array(vals, pa.string(),
                                   mask=rng.random(n) < 0.1),
                     "k": np.arange(n, dtype=np.int64)})


def _both(kind, build):
    """(port table, port meta, JAX table, JAX meta) of one program."""
    out = []
    t = _table(kind)
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session()
        df = build(api, s.create_dataframe(t))
        out += [df.collect(), overrides.wrap_and_tag(df.plan, s.conf)]
    return out


def _cpu_nodes(meta):
    out, stack = [], [meta]
    while stack:
        m = stack.pop()
        if m.reasons:
            out.append((type(m.plan).__name__, list(m.reasons)))
        stack.extend(m.children)
    return out


#: (name, expression): every one runs on the device in both packages
DEVICE_EXPRS = {
    "like_nfa": lambda a: a.F.like(a.col("s"), "_u%"),
    "like_nfa_tail": lambda a: a.F.like(a.col("s"), "%ar_"),
    "like_a_c": lambda a: a.F.like(a.col("s"), "a_c"),
    "like_transpiled": lambda a: a.F.like(a.col("s"), "%ly"),
    "rlike": lambda a: a.F.rlike(a.col("s"), "b(l|r)[a-z]+ly"),
    "rlike_anchored": lambda a: a.F.rlike(a.col("s"), r"^[a-z]+\d*$"),
    "extract": lambda a: a.F.regexp_extract(a.col("s"), "([a-z]+)ly ", 1),
    "extract_digits": lambda a: a.F.regexp_extract(a.col("s"),
                                                   r"(\d+)-(\d+)", 2),
    "replace": lambda a: a.F.regexp_replace(a.col("s"), "[aeiou]+", "*"),
    "replace_delete": lambda a: a.F.regexp_replace(a.col("s"), "ly", ""),
    "replace_grow": lambda a: a.F.regexp_replace(a.col("s"), r"\d+", "<#>"),
}


@pytest.mark.parametrize("kind", ["flat", "dict"])
@pytest.mark.parametrize("name", list(DEVICE_EXPRS))
def test_regex_expressions_match_jax_on_the_device(name, kind):
    got, meta, want, jmeta = _both(kind, lambda a, df: df.select(
        a.col("k"), DEVICE_EXPRS[name](a).alias("v")))
    assert_tables_equal(got, want)
    assert not _cpu_nodes(meta) and not _cpu_nodes(jmeta)


def test_regex_filters_match_jax():
    got, meta, want, jmeta = _both("flat", lambda a, df: df.filter(
        a.F.rlike(a.col("s"), "b(l|r)[a-z]+ly")
        | a.F.like(a.col("s"), "_u%")).select(
        a.col("k"), a.F.regexp_extract(a.col("s"), "([a-z]+)ly ", 1)
        .alias("w")))
    assert_tables_equal(got, want)
    assert got.num_rows > 0 and not _cpu_nodes(meta)


#: patterns each package sends to the CPU, with words of its reason
REJECTED = {
    "like_long": (lambda a: a.F.like(a.col("s"), "%quick%sleep%"),
                  "does not transpile to device kernels"),
    "like_two_inner": (lambda a: a.F.like(a.col("s"), "%a%b%"),
                       "does not transpile to device kernels"),
    "rlike_flags": (lambda a: a.F.rlike(a.col("s"), "(?i)QUICK"),
                    "outside the device NFA subset: (?...) group"),
    "rlike_backref": (lambda a: a.F.rlike(a.col("s"), r"(l)\1"),
                      "outside the device NFA subset: escape \\1"),
    "rlike_lazy": (lambda a: a.F.rlike(a.col("s"), "b.*?y"),
                   "lazy/possessive quantifier"),
    "rlike_unicode": (lambda a: a.F.rlike(a.col("s"), "über"),
                      "non-ASCII literal"),
    "extract_alt": (lambda a: a.F.regexp_extract(a.col("s"),
                                                 "(quick|bold)ly", 1),
                    "alternation in extract pattern"),
    "replace_backref": (lambda a: a.F.regexp_replace(a.col("s"), "(l)y",
                                                     "$1"),
                        "backref in replacement"),
    "replace_nullable": (lambda a: a.F.regexp_replace(a.col("s"), "x*",
                                                      "-"),
                         "pattern matches the empty string"),
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_rejected_patterns_run_on_the_cpu_with_the_jax_reason(name):
    build, words = REJECTED[name]
    got, meta, want, jmeta = _both("flat", lambda a, df: df.select(
        a.col("k"), build(a).alias("v")))
    assert_tables_equal(got, want)
    nodes = _cpu_nodes(meta)
    assert nodes == [(n, [r.replace("TPU", "GPU") for r in rs])
                     for n, rs in _cpu_nodes(jmeta)]
    [(node, reasons)] = nodes
    assert node == "Project" and any(words in r for r in reasons), reasons
    assert not any("ROADMAP" in r for r in reasons)


# ---------------------------------------------------------------------------
# the smoke's regex shapes (tests/torch_port_helpers.py), at a few
# thousand rows
# ---------------------------------------------------------------------------

#: shape -> the plan node it leaves on the CPU in both packages, if any
SMOKE_SHAPES = {"rx_like_nfa": None, "rx_cpu_rows_fb": "Project",
                "rx_q13_fb": "Filter", "sql_regex": None}


@pytest.fixture(scope="module")
def text():
    import torch_port_helpers as H
    return H.make_lineitem_text(4000)


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
def test_smoke_regex_shapes_match_jax(shape, text):
    import torch_port_helpers as H
    out = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session()
        df = s.create_dataframe(text)
        if shape == "sql_regex":
            s.create_or_replace_temp_view("lineitem_text", df)
            q = s.sql(H.SQL_REGEX)
        else:
            q = getattr(H, shape)(api, df)
        out += [q.collect(), overrides.wrap_and_tag(q.plan, s.conf)]
    got, meta, want, jmeta = out
    assert got.num_rows > 0
    assert_tables_equal(got, want, ignore_order=True)
    nodes = _cpu_nodes(meta)
    assert nodes == [(n, [r.replace("TPU", "GPU") for r in rs])
                     for n, rs in _cpu_nodes(jmeta)]
    assert [n for n, _ in nodes] == ([SMOKE_SHAPES[shape]]
                                     if SMOKE_SHAPES[shape] else [])
    if shape in H.RX_FALLBACK_NODES:
        assert H.RX_FALLBACK_NODES[shape] == SMOKE_SHAPES[shape]
