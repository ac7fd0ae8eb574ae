"""Parity of the port's string breadth with the JAX package, on the CPU:
``trim`` ... ``chr`` on the device and through the CPU backend, the CPU
row functions through the per-operator fallback, ``parse_url``,
``raise_error``, ``crc32`` and ``hive_hash``, and SQL and plan ingestion
reaching the new names.

Two answers differ from the JAX package's device on purpose, and the tests
state both: ``ascii`` of a non-ASCII string is its first code point on the
port's device (Spark's answer and both CPU backends'), where the JAX
package's device returns its first byte; ``initcap`` maps ASCII letters
only on both devices and all of Unicode on both CPU backends.

Every comparison is exact.
"""
from __future__ import annotations

import zlib

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.expr import misc as JM
from spark_rapids_tpu.expr.core import CpuCol as JaxCpuCol
from spark_rapids_tpu.plan import overrides as JO
from spark_rapids_tpu.plan.ingest import ingest as jax_ingest
from spark_rapids_tpu import types as JT

from spark_rapids_tpu_torch.expr import misc as PM
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan.ingest import ingest

SPECIALS = ["", "  padded  ", " ", "ÉCOLE été", "日本語abc", "straße",
            "quickly bold ideas", "hello  world", "ly", "a", "  ", "xlyly"]
WORDS = ["quickly", "blithely", "furiously", "ironic", "bold", "ideas",
         "sleep", "über", "x", "ly"]


def _table(kind: str, n: int = 300, seed: int = 7) -> pa.Table:
    """s: strings with nulls, spaces at either end, non-ASCII and empty
    rows (``flat``: nearly all distinct; ``dict``: a few repeated); q: an
    integer column with negatives and codes past 255; d: a double."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        vals = [" " * int(rng.integers(0, 3)) + " ".join(
            WORDS[j] for j in rng.integers(0, len(WORDS), rng.integers(
                0, 4))) + " " * int(rng.integers(0, 3)) for _ in range(n)]
    else:
        vals = [SPECIALS[i] for i in rng.integers(0, len(SPECIALS), n)]
    vals[:len(SPECIALS)] = SPECIALS
    q = rng.integers(-20, 400, n)
    return pa.table({
        "s": pa.array(vals, pa.string(), mask=rng.random(n) < 0.1),
        "q": pa.array(q.astype(np.int32), mask=rng.random(n) < 0.05),
        "d": np.round(rng.normal(0, 1000, n), 3),
        "k": np.arange(n, dtype=np.int64)})


def _device_exprs(api):
    col, lit, F = api.col, api.lit, api.F
    padded = F.concat(lit("  "), col("s"), lit(" "))
    return [col("k"),
            F.trim(padded).alias("trim"), F.ltrim(padded).alias("ltrim"),
            F.rtrim(padded).alias("rtrim"), F.trim(col("s")).alias("trim_s"),
            F.initcap(col("s")).alias("initcap"),
            F.instr(col("s"), "ly").alias("instr"),
            F.instr(col("s"), "é").alias("instr_utf8"),
            F.locate("o", col("s")).alias("locate"),
            F.repeat(F.left(col("s"), 4), 3).alias("repeat"),
            F.repeat(col("s"), 0).alias("repeat0"),
            F.octet_length(col("s")).alias("octets"),
            F.bit_length(col("s")).alias("bits"),
            F.left(col("s"), 5).alias("left5"),
            F.left(col("s"), -1).alias("left_neg"),
            F.right(col("s"), 5).alias("right5"),
            F.right(col("s"), 0).alias("right0"),
            F.chr_(col("q")).alias("chr"), F.char(col("q") + lit(64))
            .alias("char"),
            F.upper(F.trim(padded)).alias("upper_trim"),
            F.crc32(col("s")).alias("crc32"),
            F.hive_hash(col("s"), col("q"), col("d")).alias("hive")]


def _both(table, build, cpu=False):
    out = []
    for api in (torch_api(), jax_api()):
        df = build(api, api.session().create_dataframe(table))
        out.append(df.collect_cpu() if cpu else df.collect())
    return out


@pytest.mark.parametrize("kind", ["flat", "dict"])
def test_breadth_on_the_device_matches_jax(kind):
    table = _table(kind)
    got, want = _both(table, lambda a, df: df.select(*_device_exprs(a)))
    assert_tables_equal(got, want)
    P = torch_api()
    s = P.session()
    df = s.create_dataframe(table).select(*_device_exprs(P))
    assert not _cpu_nodes(PO.wrap_and_tag(df.plan, s.conf))


@pytest.mark.parametrize("kind", ["flat", "dict"])
def test_breadth_on_the_cpu_backend_matches_jax(kind):
    got, want = _both(_table(kind), lambda a, df: df.select(
        *_device_exprs(a), a.F.ascii(a.col("s")).alias("ascii")), cpu=True)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("kind", ["flat", "dict"])
def test_ascii_decodes_the_first_character(kind):
    table = _table(kind)
    got, want_dev = _both(table, lambda a, df: df.select(
        a.col("s"), a.F.ascii(a.col("s")).alias("a")))
    _, want_cpu = _both(table, lambda a, df: df.select(
        a.col("s"), a.F.ascii(a.col("s")).alias("a")), cpu=True)
    assert_tables_equal(got, want_cpu)
    rows = list(zip(got["s"].to_pylist(), got["a"].to_pylist(),
                    want_dev["a"].to_pylist()))
    assert any(s and ord(s[0]) > 127 for s, _, _ in rows)
    for s, a, jax_dev in rows:
        if s is None:
            continue
        assert a == (ord(s[0]) if s else 0)
        # the JAX package's device returns the first UTF-8 byte
        assert jax_dev == (s.encode()[0] if s else 0)


def test_initcap_device_is_ascii_and_cpu_is_unicode():
    table = pa.table({"s": ["ÉCOLE été", "hello wORLD", "ünd ähnlich"]})
    build = (lambda a, df: df.select(a.F.initcap(a.col("s")).alias("c")))
    dev, jax_dev = _both(table, build)
    cpu, jax_cpu = _both(table, build, cpu=True)
    assert dev["c"].to_pylist() == jax_dev["c"].to_pylist() \
        == ["École été", "Hello World", "ünd ähnlich"]
    assert cpu["c"].to_pylist() == jax_cpu["c"].to_pylist() \
        == ["École Été", "Hello World", "Ünd Ähnlich"]


def _cpu_nodes(meta):
    out, stack = [], [meta]
    while stack:
        m = stack.pop()
        if m.reasons:
            out.append((type(m.plan).__name__, list(m.reasons)))
        stack.extend(m.children)
    return out


#: the CPU row functions, each through one fallback Project
CPU_FUNCTIONS = {
    "reverse": lambda a: a.F.reverse(a.col("s")),
    "concat_ws": lambda a: a.F.concat_ws("-", a.col("s"), a.col("q"),
                                         a.col("s")),
    "lpad": lambda a: a.F.lpad(a.col("s"), 12, "*"),
    "rpad": lambda a: a.F.rpad(a.col("s"), 3, "ab"),
    "translate": lambda a: a.F.translate(a.col("s"), "lyé", "LY"),
    "substring_index": lambda a: a.F.substring_index(a.col("s"), " ", 2),
    "substring_index_neg": lambda a: a.F.substring_index(a.col("s"), " ",
                                                         -1),
    "md5": lambda a: a.F.md5(a.col("s")),
    "sha2": lambda a: a.F.sha2(a.col("s"), 256),
    "sha2_384": lambda a: a.F.sha2(a.col("s"), 384),
    "sha1": lambda a: a.F.sha1(a.col("s")),
    "format_number": lambda a: a.F.format_number(a.col("d"), 2),
    "find_in_set": lambda a: a.F.find_in_set(a.col("s"),
                                             a.lit("bold,ly,x,")),
    "levenshtein": lambda a: a.F.levenshtein(a.col("s"), a.lit("quickly")),
    "base64": lambda a: a.F.base64(a.col("s")),
    "unbase64": lambda a: a.F.unbase64(a.F.base64(a.col("s"))),
    "format_string": lambda a: a.F.format_string("%s:%d", a.col("s"),
                                                 a.col("q")),
    "elt": lambda a: a.F.elt(a.col("q") % a.lit(3), a.col("s"),
                             a.lit("two")),
    "soundex": lambda a: a.F.soundex(a.col("s")),
    "hex_string": lambda a: a.F.hex(a.col("s")),
    "hex_int": lambda a: a.F.hex(a.col("q")),
    "unhex": lambda a: a.F.unhex(a.F.hex(a.col("s"))),
    "bin": lambda a: a.F.bin(a.col("q")),
    "conv": lambda a: a.F.conv(a.F.hex(a.col("q")), 16, -10),
    "url_encode": lambda a: a.F.url_encode(a.col("s")),
    "url_decode": lambda a: a.F.url_decode(a.F.url_encode(a.col("s"))),
    "luhn_check": lambda a: a.F.luhn_check(a.F.bin(a.col("q"))),
    "regexp_extract_all": lambda a: a.F.regexp_extract_all(
        a.col("s"), "([a-z]+)ly", 1),
    "parse_url": lambda a: a.F.parse_url(
        a.F.concat(a.lit("https://h.example/p?k="), a.col("s")), "QUERY",
        "k"),
}


@pytest.mark.parametrize("name", list(CPU_FUNCTIONS))
def test_cpu_row_functions_fall_back_like_jax(name):
    table = _table("flat", n=120)
    out = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session()
        df = s.create_dataframe(table).select(
            api.col("k"), CPU_FUNCTIONS[name](api).alias("v"))
        out += [df.collect(), overrides.wrap_and_tag(df.plan, s.conf)]
    got, meta, want, jmeta = out
    assert_tables_equal(got, want)
    nodes = _cpu_nodes(meta)
    assert nodes == [(n, [r.replace("TPU", "GPU") for r in rs])
                     for n, rs in _cpu_nodes(jmeta)]
    [(node, reasons)] = nodes
    assert node == "Project" and any("runs on CPU" in r for r in reasons)


def test_row_function_errors_are_the_jax_package_s():
    t = pa.table({"s": ["ab", "%zz"], "k": [1, 2]})
    for api in (torch_api(), jax_api()):
        df = api.session().create_dataframe(t)
        with pytest.raises(Exception, match="invalid URL escape"):
            df.select(api.F.url_decode(api.col("s"))).collect()
        with pytest.raises(Exception, match="group 3 out of range"):
            df.select(api.F.regexp_extract_all(api.col("s"), "(a)(b)",
                                               3)).collect()
        with pytest.raises(Exception, match="boom"):
            df.select(api.F.raise_error(api.lit("boom"))).collect()
    # conv's Spark rules (tests/test_breadth3.py)
    P = torch_api()
    d = P.session().create_dataframe({"s": ["100", "-10", "ab", "zz", ""]})
    assert d.select(P.F.conv(P.col("s"), 16, -10).alias("c")).to_pydict() \
        == {"c": ["256", "-16", "171", None, None]}
    assert d.select(P.F.conv(P.col("s"), -16, 10).alias("c")).to_pydict() \
        == {"c": [None] * 5}


def test_parse_url_matches_jax():
    urls = ["https://user:pw@spark.apache.org:8080/path/p.php?query=1&k=v"
            "#Ref", "http://example.com", "not a url", None,
            "ftp://host/file.txt?x=1"]
    parts = [("HOST",), ("PATH",), ("QUERY",), ("QUERY", "k"),
             ("PROTOCOL",), ("REF",), ("FILE",), ("AUTHORITY",),
             ("USERINFO",)]
    got, want = _both(pa.table({"u": urls}), lambda a, df: df.select(
        *[a.F.parse_url(a.col("u"), *p).alias(f"p{i}")
          for i, p in enumerate(parts)]))
    assert_tables_equal(got, want)
    with pytest.raises(SparkException, match="unknown part"):
        torch_api().F.parse_url(torch_api().col("u"), "PORT")


@pytest.mark.parametrize("kind", ["flat", "dict"])
def test_crc32_matches_zlib(kind):
    table = _table(kind)
    got, _ = _both(table, lambda a, df: df.select(
        a.col("s"), a.F.crc32(a.col("s")).alias("c")))
    for s, c in zip(got["s"].to_pylist(), got["c"].to_pylist()):
        assert c == (None if s is None else zlib.crc32(s.encode()))


def test_hive_hash_matches_jax_numpy_hash():
    t = pa.table({"i": pa.array([1, -5, None, 2**40, -2**63], pa.int64()),
                  "s": pa.array(["hello", "", None, "wörld", "日本"]),
                  "f": pa.array([1.5, -0.0, 3.25, None, float("nan")]),
                  "g": pa.array([1.5, -0.0, None, 2.0, -7.25], pa.float32()),
                  "b": pa.array([True, False, None, True, False]),
                  "n": pa.array([3, None, -1, 0, 2**31 - 1], pa.int32())})
    cols = ["i", "s", "f", "g", "b", "n"]
    got, want = _both(t, lambda a, df: df.select(
        a.F.hive_hash(*[a.col(c) for c in cols]).alias("h"),
        a.F.hive_hash(a.col("s")).alias("hs")))
    assert_tables_equal(got, want)
    # the JAX package's numpy hash, chained h = 31 * h + column hash
    h = np.zeros(t.num_rows, np.int64)
    types = {"i": JT.INT64, "s": JT.STRING, "f": JT.FLOAT64,
             "g": JT.FLOAT32, "b": JT.BOOLEAN, "n": JT.INT32}
    for c in cols:
        arr = t[c]
        valid = np.asarray(arr.is_valid())
        vals = np.array(arr.to_pylist(), object) if c == "s" \
            else np.asarray(arr.fill_null(False if c == "b" else 0)).astype(
                types[c].np_dtype)
        ch = np.where(valid, JM._hive_hash_col_np(
            JaxCpuCol(types[c], vals, valid)), 0)
        np.testing.assert_array_equal(
            ch, np.where(valid, PM.hive_hash_col_np(
                PM.CpuCol(PM.T.from_arrow(arr.type), vals, valid)), 0))
        h = (h * 31 + ch) & 0xFFFFFFFF
    h = np.where(h >= 1 << 31, h - (1 << 32), h)
    assert got["h"].to_pylist() == h.tolist()
    assert got["hs"].to_pylist()[0] == 99162322  # Java "hello".hashCode()


SQL_QUERIES = [
    "SELECT k, trim(s) AS t, initcap(s) AS i, crc32(s) AS c FROM v",
    "SELECT k, regexp_extract(s, '([a-z]+)ly', 1) AS w FROM v "
    "WHERE rlike(s, 'b(l|r)[a-z]+ly') OR s LIKE '_u%'",
    "SELECT k, regexp_replace(s, '[aeiou]+', '*') AS r, "
    "instr(s, 'ly') AS p, octet_length(s) AS o, left(s, 3) AS l FROM v",
    "SELECT k, md5(s) AS m, lpad(s, 8, '-') AS p, hive_hash(s, k) AS h "
    "FROM v WHERE s LIKE '%ly'",
]


@pytest.mark.parametrize("query", SQL_QUERIES)
def test_sql_reaches_the_new_functions(query):
    out = []
    for api in (torch_api(), jax_api()):
        s = api.session()
        s.create_or_replace_temp_view("v", s.create_dataframe(
            _table("flat", n=150)))
        out.append(s.sql(query).collect())
    assert out[0].num_rows > 0
    assert_tables_equal(out[0], out[1], ignore_order=True)


def test_plan_ingestion_reaches_the_new_functions():
    doc = {"version": 1, "plan": {
        "node": "project",
        "exprs": [{"expr": "call", "fn": fn,
                   "args": [{"expr": "col", "name": "d"}]}
                  for fn in ("initcap", "crc32", "trim", "octet_length",
                             "ascii", "reverse", "md5", "hive_hash")],
        "child": {"node": "in_memory",
                  "rows": {"d": [" ab cd", "ef ", "", "ly"]}}}}
    got = ingest(doc, torch_api().session()).collect()
    want = jax_ingest(doc, jax_api().session()).collect()
    assert_tables_equal(got, want)
