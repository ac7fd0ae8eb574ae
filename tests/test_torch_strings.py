"""Parity of the port's string expressions and case-map kernel with the JAX
package, on the CPU.

The case map's plain version is held against the Pallas kernel (interpret
mode) and its ``jnp.where`` twin; each string expression runs over the
same flat and dictionary columns through ``TpuSession`` and
``TorchSession(device="cpu")``. Strings and booleans are compared exactly,
over live rows only.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from asserts import assert_tables_equal
from torch_port_helpers import from_jax_batch, jax_api, torch_api

from spark_rapids_tpu.columnar.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.ops import pallas_kernels as JPK

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.expr import core as PE
from spark_rapids_tpu_torch.expr import strings as PS
from spark_rapids_tpu_torch.ops import case_map as CM

SPECIALS = ["", "Hello World", "ÉCOLE été", "straße", "日本語テキスト",
            "MiXeD cAsE", "abc", "ABC", "abcabc", "a", "cab", "xyzabc",
            "ab%c", "_under"]


def _twin(raw: np.ndarray, upper: bool) -> np.ndarray:
    """The JAX package's jnp.where twin of the case-map kernel."""
    e = jnp.asarray(raw)
    if upper:
        return np.asarray(jnp.where((e >= 97) & (e <= 122), e - 32, e))
    return np.asarray(jnp.where((e >= 65) & (e <= 90), e + 32, e))


# ---------------------------------------------------------------------------
# the case-map kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upper", [True, False], ids=["upper", "lower"])
def test_case_map_plain_matches_pallas_kernel(upper):
    raw = np.random.default_rng(2).integers(0, 256, 4096 * 3).astype(
        np.uint8)
    want = np.asarray(JPK.ascii_case_map_pallas(jnp.asarray(raw), upper))
    got = CM.case_map(torch.from_numpy(raw), upper).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 4095])
@pytest.mark.parametrize("upper", [True, False], ids=["upper", "lower"])
def test_case_map_plain_matches_jax_twin(n, upper):
    raw = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    got = CM.case_map_plain(torch.from_numpy(raw), upper).numpy()
    np.testing.assert_array_equal(got, _twin(raw, upper))


def test_case_map_wrapper_checks_inputs_and_copies():
    before = CM.launches
    raw = torch.tensor(list(b"aZ\xc3\xa9{@`"), dtype=torch.uint8)
    out = CM.case_map(raw, True)
    assert bytes(out.tolist()) == b"AZ\xc3\xa9{@`"
    assert bytes(CM.case_map(raw, False).tolist()) == b"az\xc3\xa9{@`"
    assert out.data_ptr() != raw.data_ptr()  # never in place
    assert bytes(raw.tolist()) == b"aZ\xc3\xa9{@`"
    assert CM.case_map(torch.zeros(0, dtype=torch.uint8), True).numel() == 0
    with pytest.raises(TypeError, match="uint8"):
        CM.case_map(raw.to(torch.int32), True)
    with pytest.raises(TypeError, match="uint8"):
        CM.case_map(raw.reshape(1, -1), True)
    with pytest.raises(TypeError, match="no case_map kernel"):
        CM.case_map(torch.zeros(4, dtype=torch.uint8, device="meta"), True)
    assert CM.launches == before  # the plain version counts nothing


@pytest.mark.cuda
def test_case_map_kernel_matches_plain_on_card():
    # decided inside the test: collection must not depend on the machine
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    raw = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1 << 20) + 13).astype(np.uint8)).cuda()
    for upper in (True, False):
        for view in (raw, raw[3:], raw[:17], raw[:0]):
            assert torch.equal(CM.case_map(view, upper),
                               CM.case_map_plain(view, upper))


# ---------------------------------------------------------------------------
# expressions, flat and dictionary columns
# ---------------------------------------------------------------------------

def _strings_table(kind: str, n: int = 400, seed: int = 5) -> pa.Table:
    """Columns s and t: nulls, empty strings, non-ASCII UTF-8 and mixed
    case. ``flat``: nearly every value distinct (uploads as offsets +
    bytes); ``dict``: a few values repeated (uploads as a dictionary)."""
    rng = np.random.default_rng(seed)
    letters = list("aAbBcC xyZé日ß")
    if kind == "flat":
        pool = SPECIALS + ["".join(rng.choice(letters, rng.integers(0, 12)))
                           for _ in range(n)]
    else:
        pool = SPECIALS

    def column():
        if kind == "flat":
            vals = list(rng.permutation(np.array(pool, object))[:n])
        else:
            vals = [pool[i] for i in rng.integers(0, len(pool), n)]
        vals[:len(SPECIALS)] = SPECIALS
        return pa.array(vals, pa.string(), mask=rng.random(n) < 0.1)
    return pa.table({"s": column(), "t": column(),
                     "x": rng.integers(0, 5, n).astype(np.int64)})


def _run(kind, exprs, filt=None):
    t = _strings_table(kind)
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(t)
        if filt is not None:
            df = df.filter(filt(api))
        out.append(df.select(*exprs(api)).collect())
    assert_tables_equal(out[0], out[1])
    return out[0]


def _layout_check(kind):
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    b = from_arrow(_strings_table(kind), "cpu")
    assert b.columns[0].is_dict == (kind == "dict")


KINDS = ["flat", "dict"]


@pytest.mark.parametrize("kind", KINDS)
def test_length_and_case_maps_match_jax(kind):
    _layout_check(kind)

    def exprs(api):
        col, F = api.col, api.F
        return [col("s"), F.length(col("s")).alias("len"),
                F.upper(col("s")).alias("up"),
                F.lower(col("s")).alias("low"),
                F.length(F.upper(col("t"))).alias("len_up"),
                F.lower(F.upper(col("s"))).alias("low_up")]
    got = _run(kind, exprs)
    # the device semantics: ASCII letters only, byte for byte
    for s, up in zip(got["s"].to_pylist(), got["up"].to_pylist()):
        if s is not None:
            assert up == "".join(ch.upper() if "a" <= ch <= "z" else ch
                                 for ch in s)


SUBSTRINGS = [(1, 3), (3, 100), (0, 2), (-3, 2), (-100, 4), (2, 0), (5, 1)]


@pytest.mark.parametrize("kind", KINDS)
def test_substring_matches_jax(kind):
    def exprs(api):
        col, F = api.col, api.F
        out = [F.substring(col("s"), p, n).alias(f"sub{i}")
               for i, (p, n) in enumerate(SUBSTRINGS)]
        out.append(col("t").substr(2, 3).alias("substr"))
        out.append(F.substring(F.upper(col("s")), 1, 4).alias("sub_up"))
        return out
    _run(kind, exprs)


@pytest.mark.parametrize("kind", KINDS)
def test_concat_matches_jax(kind):
    def exprs(api):
        col, lit, F = api.col, api.lit, api.F
        return [F.concat(col("s"), lit("|"), col("t")).alias("c3"),
                F.concat(F.upper(col("s")), col("s")).alias("c2"),
                F.concat(lit("é-"), col("t"), lit("")).alias("clit")]
    _run(kind, exprs)


def test_concat_of_dict_flat_and_literal_matches_jax():
    flat = _strings_table("flat", seed=8)
    dct = _strings_table("dict", seed=9)
    t = pa.table({"f": flat["s"], "d": dct["s"]})
    out = []
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(t)
        out.append(df.select(api.F.concat(api.col("d"), api.col("f"),
                                          api.lit("!")).alias("c"),
                             api.F.concat(api.col("f"), api.col("d"))
                             .alias("c2")).collect())
    assert_tables_equal(out[0], out[1])


PATTERNS = ["abc", "é", "日本", "", "a", "ZZZ", "c "]


@pytest.mark.parametrize("kind", KINDS)
def test_literal_matches_match_jax(kind):
    def exprs(api):
        col, F = api.col, api.F
        out = []
        for i, p in enumerate(PATTERNS):
            out += [F.startswith(col("s"), p).alias(f"sw{i}"),
                    F.endswith(col("s"), p).alias(f"ew{i}"),
                    F.contains(col("s"), p).alias(f"ct{i}")]
        out.append(F.contains(F.upper(col("t")), "AB").alias("ct_up"))
        return out
    _run(kind, exprs)


LIKES = ["abc", "ab%", "%bc", "a%c", "%b%", "%", "%%", "", "ab\\%c",
         "%é%", "straße"]


@pytest.mark.parametrize("kind", KINDS)
def test_like_transpiled_forms_match_jax(kind):
    def exprs(api):
        return [api.F.like(api.col("s"), p).alias(f"l{i}")
                for i, p in enumerate(LIKES)]
    _run(kind, exprs)


@pytest.mark.parametrize("pattern", ["a_c", "%a%b%"])
def test_like_nfa_pattern_raises_naming_regex(pattern):
    # 'a_c' runs on the device NFA of expr/regex.py; '%a%b%' needs more
    # than 31 NFA positions, so both packages run it on the CPU, with the
    # JAX package's reason
    got = _run("flat", lambda api: [api.F.like(api.col("s"), pattern)
                                    .alias("m")])
    assert any(got["m"].to_pylist())
    from spark_rapids_tpu.plan import overrides as JO
    from spark_rapids_tpu_torch.plan import overrides as PO
    reports = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session()
        df = s.create_dataframe(_strings_table("flat")).select(
            api.F.like(api.col("s"), pattern))
        reports.append(overrides.wrap_and_tag(df.plan, s.conf).explain())
    on_cpu = [ln.strip() for ln in reports[0].splitlines()
              if ln.lstrip().startswith(("!", "@"))]
    assert on_cpu == [ln.strip().replace("TPU", "GPU")
                      for ln in reports[1].splitlines()
                      if ln.lstrip().startswith(("!", "@"))]
    assert bool(on_cpu) == (pattern == "%a%b%")
    assert "ROADMAP" not in reports[0]
    if on_cpu:
        assert "does not transpile to device kernels" in reports[0]


@pytest.mark.parametrize("kind", KINDS)
def test_string_equality_matches_jax(kind):
    def exprs(api):
        col, lit, F = api.col, api.lit, api.F
        return [(col("s") == col("t")).alias("st"),
                (col("s") == lit("abc")).alias("lit"),
                (lit("ÉCOLE été") == col("s")).alias("lit_left"),
                (col("s") == lit("")).alias("empty"),
                (F.upper(col("s")) == lit("ABC")).alias("up_lit"),
                (F.upper(col("s")) == F.upper(col("t"))).alias("up_up"),
                (col("s") == col("s")).alias("self")]
    _run(kind, exprs)


def test_string_equality_of_flat_and_dict_matches_jax():
    flat = _strings_table("flat", seed=11)
    dct = _strings_table("dict", seed=11)
    t = pa.table({"f": flat["s"], "d": dct["s"], "d2": dct["t"]})
    out = []
    for api in (torch_api(), jax_api()):
        col = api.col
        df = api.session().create_dataframe(t)
        out.append(df.select((col("f") == col("d")).alias("fd"),
                             (col("d") == col("f")).alias("df"),
                             (col("d") == col("d2")).alias("dd")).collect())
    assert_tables_equal(out[0], out[1])
    assert any(out[0]["fd"].to_pylist())


def test_string_literals_and_null_literal_match_jax():
    def exprs(api, T):
        col, lit = api.col, api.lit
        return [lit("x|é").alias("l"), lit("").alias("e"),
                api.Literal(None, T.STRING).alias("n"),
                api.F.concat(col("s"), api.Literal(None, T.STRING))
                .alias("cn")]
    t = _strings_table("flat")
    J, P = jax_api(), torch_api()
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expr.core import Literal as JL
    J.Literal, P.Literal = JL, PE.Literal
    got = P.session().create_dataframe(t).select(*exprs(P, PT)).collect()
    want = J.session().create_dataframe(t).select(*exprs(J, JT)).collect()
    assert_tables_equal(got, want)
    assert set(got["n"].to_pylist()) == {None}


def test_string_ordering_comparison_raises():
    # tagged to the CPU in both packages, with the same answer where both
    # operands are strings (the JAX package's CPU cannot order a null);
    # a null operand gives null
    def exprs(api):
        return [(api.col("s") < api.col("t")).alias("lt"),
                (api.col("s") >= api.lit("b")).alias("ge")]
    _run("flat", exprs, filt=lambda api: api.col("s").is_not_null()
         & api.col("t").is_not_null())
    t = _strings_table("flat")
    P = torch_api()
    got = P.session().create_dataframe(t).select(*exprs(P)).collect()
    for s, u, lt, ge in zip(t["s"].to_pylist(), t["t"].to_pylist(),
                            got["lt"].to_pylist(), got["ge"].to_pylist()):
        assert lt == (None if s is None or u is None else s < u)
        assert ge == (None if s is None else s >= "b")


def test_filtered_strings_match_jax_over_live_rows():
    def filt(api):
        return api.col("x") > api.lit(1)

    def exprs(api):
        col, F = api.col, api.F
        return [F.upper(col("s")).alias("up"), F.length(col("t")).alias("n"),
                F.concat(col("s"), col("t")).alias("c"),
                F.contains(col("s"), "b").alias("ct")]
    for kind in KINDS:
        _run(kind, exprs, filt)


@pytest.mark.parametrize("kind", KINDS)
def test_expressions_on_identical_batches_match_jax(kind):
    """Single expressions over the same planes (from_jax_batch): the
    port's validity and values equal the JAX package's over live rows."""
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.expr import strings as JS
    from spark_rapids_tpu.expr.core import BoundRef as JRef
    from spark_rapids_tpu.expr.core import EvalCtx as JCtx
    t = _strings_table(kind)
    jb = jax_from_arrow(t)
    pb = from_jax_batch(jb)
    n = t.num_rows
    cases = [(JS.StringLength, PS.StringLength, ()),
             (JS.Contains, PS.Contains, ("b",)),
             (JS.StartsWith, PS.StartsWith, ("a",)),
             (JS.EndsWith, PS.EndsWith, ("c",))]
    for jcls, pcls, args in cases:
        je = jcls(JRef(0, JT.STRING, "s"), *args)
        pe = pcls(PE.BoundRef(0, PT.STRING, "s"), *args)
        jc = je.eval_tpu(JCtx(jb.columns, n, jb.capacity, False))
        pc = pe.eval(PE.EvalCtx(pb.columns, n, pb.capacity, "cpu"))
        jv = np.asarray(jc.validity)[:n]
        pv = pc.validity.numpy()[:n]
        np.testing.assert_array_equal(pv, jv)
        np.testing.assert_array_equal(pc.data.numpy()[:n][pv],
                                      np.asarray(jc.data)[:n][jv])
