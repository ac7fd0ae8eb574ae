"""The port's device casts to and from strings against the JAX package's,
on the CPU.

Integer (every width, with its extremes), boolean, date and timestamp to
string, and string to integer, double, date and timestamp, over a flat
column (many distinct strings) and a dictionary column (a small
vocabulary, parsed once and gathered by code), with malformed, blank-
padded and out-of-range strings; non-ANSI (a string that does not parse
is null) and ANSI (it raises in both packages; a column that parses does
not). The JAX package runs these casts on its device (``eval_tpu`` on the
CPU); so does the port, with no CPU node in either plan.

Tolerances: exact, string -> double included: both packages scale an
int64 mantissa by ``pow(10.0, p)`` of the same operands, and their bits
agree on the CPU (the scheme's 1-2 ulp distance from a correctly rounded
strtod is the JAX package's documented divergence, shared).
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute  # noqa: F401 - pa.compute
import pytest

from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.plan import overrides as JO

from spark_rapids_tpu_torch.plan import overrides as PO

#: strings every parse must handle the JAX package's way
EDGE = ["12", " -34 ", "+7", "", " ", "abc", "1e5", "1.5", "-0", "007",
        "9223372036854775807", "9223372036854775808", "-9223372036854775808",
        "-9223372036854775809", "99999999999999999999", " 12 3", "\t5",
        "5\n", "2147483648", "-2147483649", "1.", ".5", "-.5e-3", "1e", "e5",
        "1e+", "+-1", "Infinity", "-Infinity", "NaN", "+NaN", "infinity",
        "nan", "1.2.3", "1e-400", "1e400", "123456789012345678901234",
        "0.000000000000000000000001234", "3.14159265358979323846",
        "2020-01-01", "2020-1-1", " 2020-02-29 ", "2021-02-29", "2020-13-01",
        "2020-00-10", "2020-01-32", "2020-01-01 12:34:56",
        "2020-01-01T12:34:56.123", "2020-01-01 12:34:56.1234567",
        "2020-01-01 1:2:3", "2020-01-01 12:34", "2020-01-01 12:34:56.",
        "2020-01-01 24:00:00", "2020-01-01 23:59:60", "2020-", "2020-01-",
        "2020", "0000-01-01", "0001-01-01", "9999-12-31 23:59:59.999999",
        "10000-01-01", "-2020-01-01", "1970-01-01 00:00:00.000001",
        "1969-12-31 23:59:59.999999", "１２", "12345678901234567890",
        "1582-10-10", None]


def _flat_strings(rng, n):
    """Mostly distinct strings (the port keeps them flat), the edges at
    the front."""
    ints = rng.integers(-(2 ** 40), 2 ** 40, n)
    days = rng.integers(-25_000, 40_000, n)
    micros = rng.integers(0, 86_400_000_000, n)
    out = []
    for k in range(n):
        kind = k % 4
        if kind == 0:
            out.append(str(int(ints[k])))
        elif kind == 1:
            out.append(f"{ints[k] / 7919:.6f}")
        elif kind == 2:
            out.append(str(np.datetime64(int(days[k]), "D")))
        else:
            t = np.datetime64(int(days[k]), "D").astype("datetime64[us]") \
                + np.timedelta64(int(micros[k]), "us")
            out.append(str(t).replace("T", " " if k % 8 == 3 else "T"))
    out[:len(EDGE)] = EDGE
    return out


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(31)
    n = 800
    flat = pa.table({"s": pa.array(_flat_strings(rng, n))})
    vocab = np.array(EDGE, object)
    picks = vocab[rng.integers(0, len(vocab), n)]
    dict_t = pa.table({"s": pa.array(list(picks))})
    return {"flat": flat, "dict": dict_t}


def _run(table, build, conf=None):
    """(port table, JAX table); both plans entirely on the device."""
    out = []
    for api, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = api.session(conf)
        df = s.create_dataframe(table).select(*build(api))
        meta = overrides.wrap_and_tag(df.plan, s.conf)
        assert not any(m.reasons for m in _walk(meta)), meta.explain()
        out.append(df.collect())
    return out


def _walk(meta):
    yield meta
    for c in meta.children:
        yield from _walk(c)


def _same(got: pa.Table, want: pa.Table):
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name], want[name]
        if pa.types.is_date32(w.type):
            g, w = g.cast(pa.int32()), w.cast(pa.int32())
        elif pa.types.is_timestamp(w.type):
            g, w = g.cast(pa.int64()), w.cast(pa.int64())
        gl, wl = g.to_pylist(), w.to_pylist()
        bad = [i for i in range(len(wl)) if not (
            gl[i] == wl[i] or (isinstance(wl[i], float) and gl[i] != gl[i]
                               and wl[i] != wl[i]))]
        assert not bad, (name, [(i, gl[i], wl[i]) for i in bad[:5]])


PARSES = {
    "to_long": lambda a: a.col("s").cast(a.T.INT64),
    "to_int": lambda a: a.col("s").cast(a.T.INT32),
    "to_short": lambda a: a.col("s").cast(a.T.INT16),
    "to_byte": lambda a: a.col("s").cast(a.T.INT8),
    "to_double": lambda a: a.col("s").cast(a.T.FLOAT64),
    "to_float": lambda a: a.col("s").cast(a.T.FLOAT32),
    "to_date": lambda a: a.col("s").cast(a.T.DATE),
    "to_timestamp": lambda a: a.col("s").cast(a.T.TIMESTAMP),
}


@pytest.mark.parametrize("form", ["flat", "dict"])
@pytest.mark.parametrize("case", list(PARSES))
def test_string_parse_equals_jax(case, form, tables):
    got, want = _run(tables[form],
                     lambda a: [PARSES[case](a).alias("v"),
                                a.col("s").alias("s")])
    _same(got, want)
    if form == "flat":
        assert got["v"].null_count < got.num_rows  # something parsed


@pytest.fixture(scope="module")
def fixed():
    rng = np.random.default_rng(37)
    n = 700
    i64 = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    i64[:6] = [-(2 ** 63), 2 ** 63 - 1, 0, -1, 10 ** 18, -(10 ** 18) + 1]
    days = rng.integers(-800_000, 2_950_000, n).astype(np.int32)
    days[:5] = [-719528, -719529, 0, 2932896, 2932897]
    us = rng.integers(-(2 ** 62), 2 ** 62, n) // 1024
    us[:6] = [0, -1, 1, 1_000_000, 1_500_000, -62_167_219_200_000_001]
    mask = rng.random(n) < 0.08
    return pa.table({
        "l": pa.array(i64, mask=mask),
        "i": pa.array(i64.astype(np.int32), mask=np.roll(mask, 1)),
        "h": (i64 >> 48).astype(np.int16),
        "b": (i64 >> 56).astype(np.int8),
        "o": pa.array(i64 % 3 == 0, mask=np.roll(mask, 2)),
        "d": pa.array(days, pa.date32(), mask=np.roll(mask, 3)),
        "ts": pa.array(us, pa.timestamp("us"), mask=np.roll(mask, 4)),
    })


RENDERS = {
    "integers": lambda a: [a.col(c).cast(a.T.STRING).alias(c)
                           for c in ("l", "i", "h", "b")],
    "boolean": lambda a: [a.col("o").cast(a.T.STRING).alias("o")],
    "date": lambda a: [a.col("d").cast(a.T.STRING).alias("d")],
    "timestamp": lambda a: [a.col("ts").cast(a.T.STRING).alias("ts")],
    "round_trips": lambda a: [
        a.col("l").cast(a.T.STRING).cast(a.T.INT64).alias("l"),
        a.col("d").cast(a.T.STRING).cast(a.T.DATE).alias("d"),
        a.col("ts").cast(a.T.STRING).cast(a.T.TIMESTAMP).alias("ts")],
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_render_equals_jax(case, fixed):
    got, want = _run(fixed, RENDERS[case])
    if case == "boolean":
        # the JAX package's device renders a null boolean as "false" (its
        # If takes the else branch); the port keeps it null, as Spark and
        # both CPU backends do
        valid = fixed["o"].is_valid()
        assert got["o"].is_valid().equals(valid)
        want = want.set_column(0, "o", pa.compute.if_else(
            valid, want["o"], pa.scalar(None, pa.string())))
    _same(got, want)


def test_round_trips_are_exact_where_rendered(fixed):
    """A value renders and parses back to itself (years 1..9999)."""
    got, _ = _run(fixed, RENDERS["round_trips"])
    assert got["l"].to_pylist() == fixed["l"].to_pylist()
    d = fixed["d"].cast(pa.int32()).to_numpy(zero_copy_only=False)
    back = got["d"].cast(pa.int32()).to_pylist()
    inside = (d >= -719162) & (d <= 2932896)
    assert all(back[k] == int(d[k]) for k in np.nonzero(
        inside & np.asarray(fixed["d"].is_valid()))[0])


ANSI = {"spark.sql.ansi.enabled": "true"}


@pytest.mark.parametrize("case", ["to_int", "to_double", "to_date",
                                  "to_timestamp"])
def test_ansi_invalid_input_raises_in_both(case, tables):
    for form in ("flat", "dict"):
        for api in (torch_api(), jax_api()):
            df = api.session(ANSI).create_dataframe(tables[form]).select(
                PARSES[case](api).alias("v"))
            with pytest.raises(Exception, match="CAST_INVALID_INPUT"):
                df.collect()
    ok = pa.table({"s": ["1", " 2 ", None, "2020"] * 20})
    got, want = _run(ok, lambda a: [PARSES[case](a).alias("v")], ANSI)
    _same(got, want)


# ---------------------------------------------------------------------------
# ROADMAP C22: a float cast to a long saturates on the CPU backend too
# ---------------------------------------------------------------------------

_SATURATING = [np.inf, -np.inf, 1e300, 2.0 ** 63, 9.3e18, np.nan]
_LONG_MAX, _LONG_MIN = 2 ** 63 - 1, -(2 ** 63)
#: Spark's answers: truncated, saturated at the long range, NaN to 0
_SPARK_LONGS = [_LONG_MAX, _LONG_MIN, _LONG_MAX, _LONG_MAX, _LONG_MAX, 0]
#: the JAX package's CPU backend clips to 2.0**63, which converts to the
#: long minimum (ROADMAP C22, a fault of the reference)
_JAX_CPU_LONGS = [_LONG_MIN, _LONG_MIN, _LONG_MIN, _LONG_MIN, _LONG_MIN, 0]

TO_LONG = {
    "cast_d": lambda a: a.col("d").cast(a.T.INT64),
    "ceil_d": lambda a: a.F.ceil(a.col("d")),
    "floor_d": lambda a: a.F.floor(a.col("d")),
    "cast_f": lambda a: a.col("f").cast(a.T.INT64),
}


def _saturating_table():
    return pa.table({"d": pa.array(_SATURATING, pa.float64()),
                     "f": pa.array(_SATURATING, pa.float32())})


@pytest.mark.parametrize("case", list(TO_LONG))
def test_float_to_long_saturates_on_both_backends_c22(case):
    from spark_rapids_tpu.exec.cpu_backend import execute_cpu as jax_cpu

    from spark_rapids_tpu_torch.exec.cpu_backend import execute_cpu
    t = _saturating_table()
    tapi, japi = torch_api(), jax_api()
    df = tapi.session().create_dataframe(t).select(
        TO_LONG[case](tapi).alias("v"))
    assert df.collect()["v"].to_pylist() == _SPARK_LONGS
    assert execute_cpu(df.plan, False)["v"].to_pylist() == _SPARK_LONGS
    jdf = japi.session().create_dataframe(t).select(
        TO_LONG[case](japi).alias("v"))
    assert jdf.collect()["v"].to_pylist() == _SPARK_LONGS
    assert jax_cpu(jdf.plan, False)["v"].to_pylist() == _JAX_CPU_LONGS


def test_float_to_long_beside_a_row_udf_c22():
    """A Project holding a row UDF runs on the CPU backend, so the cast
    beside it takes the CPU conversion; under ANSI exactly 2**63 raises
    on neither backend and answers the long maximum, as Spark does."""
    from spark_rapids_tpu.exec.cpu_backend import execute_cpu as jax_cpu

    from spark_rapids_tpu_torch.exec.cpu_backend import execute_cpu
    t = _saturating_table()
    got = {}
    for name, api in (("port", torch_api()), ("jax", jax_api())):
        u = api.udf(lambda x: 1.0, api.T.FLOAT64)
        s = api.session()
        df = s.create_dataframe(t).select(
            api.col("d").cast(api.T.INT64).alias("c"),
            u(api.col("d")).alias("u"))
        got[name] = df.collect()["c"].to_pylist()
        if name == "port":
            assert "CpuFallbackExec" in s.last_exec.tree_string()
    assert got == {"port": _SPARK_LONGS, "jax": _JAX_CPU_LONGS}
    edge = pa.table({"d": pa.array([2.0 ** 63], pa.float64())})
    for api, cpu, want_cpu in ((torch_api(), execute_cpu, _LONG_MAX),
                               (jax_api(), jax_cpu, _LONG_MIN)):
        df = api.session(ANSI).create_dataframe(edge).select(
            api.col("d").cast(api.T.INT64).alias("c"))
        assert df.collect()["c"].to_pylist() == [_LONG_MAX]
        assert cpu(df.plan, True)["c"].to_pylist() == [want_cpu]
