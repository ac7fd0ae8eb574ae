"""The rest of ``expr/math.py`` in the port (all but ``Murmur3Hash``,
which comes with ROADMAP A5) against the JAX package, on the CPU.

One seeded table with the edge values (NaN, +-0, +-inf, negative inputs
to sqrt and log, halfway values for round and bround at scales -2..3,
integer extremes for pmod, factorial and pow) goes through the same
projection in both packages: the JAX package's device path (XLA on the
CPU) against the port's device path on a CPU tensor, and both packages'
CPU backends (``collect_cpu``) against each other.

Tolerances:
- floor, ceil, round, bround, rint, pmod, signum, sqrt, nanvl,
  width_bucket, factorial, positive, the bit functions, and every CPU
  backend comparison are exact (the same IEEE operations, or the same
  numpy code; floats compare with NaN equal to NaN and the sign of zero
  checked);
- the transcendental functions (exp, the logs, the trigonometric and
  hyperbolic families, cbrt, cot/sec/csc, degrees/radians, expm1, log1p,
  pow, atan2, hypot) are held to 2 ulp: XLA on the CPU, torch and numpy
  use different libms, which may round the last bits differently. The
  port's device path is held within 2 ulp of numpy's libm (what both CPU
  backends run) and of the JAX package, but where XLA's CPU approximation
  is itself coarser (measured: cbrt 101 ulp at 1e-300, log1p and atanh 95
  near -0.4, sinh and tanh 4): there the JAX package is held within
  ``XLA_ULPS`` of numpy's libm instead. Nulls and NaNs must sit on the
  same rows.

XLA flushes f64 subnormals to zero on the CPU (a documented difference of
the JAX package); the port keeps them, as Spark does. The edge values are
normal, and ``test_subnormals_are_kept`` states the difference.
"""
import importlib

import numpy as np
import pyarrow as pa
import pytest

from asserts import assert_tables_equal
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu_torch.plan import overrides as PO

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
N = 600
HALVES = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.125, -0.375, 1.005, 2.675,
          12.5, -12.5, 125.0, -125.0, 1250.0, 0.0625, 5.55, -5.55]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(71)
    x = rng.normal(0, 20, N)
    edges = [np.nan, -0.0, 0.0, np.inf, -np.inf, -4.0, -1.0, 1e300,
             -1e300, 1e-300, 2.0 ** 63, -2.0 ** 63, 9.3e18, -9.3e18]
    x[:len(edges)] = edges
    x[len(edges):len(edges) + len(HALVES)] = HALVES
    u = rng.uniform(-1.2, 1.2, N)  # the inverse trigonometric domains
    u[:4] = [np.nan, 1.0, -1.0, -0.0]
    a = rng.integers(-30, 30, N).astype(np.int32)
    a[:6] = [I32.min, I32.max, -1, 0, 20, 21]
    b = rng.integers(-7, 8, N).astype(np.int64)
    b[:6] = [-1, -1, 0, I64.min, I64.max, 3]
    big = rng.integers(-2 ** 40, 2 ** 40, N).astype(np.int64)
    big[:6] = [I64.min, I64.max, -1, 0, 125, -125]
    pos = rng.integers(-2, 70, N).astype(np.int32)
    return pa.table({
        "x": pa.array(x, mask=rng.random(N) < 0.05),
        "y": rng.normal(0, 5, N),
        "u": u,
        "f": x.astype(np.float32),
        "a": pa.array(a, mask=rng.random(N) < 0.05),
        "b": b,
        "big": big,
        "s8": rng.integers(-128, 128, N).astype(np.int8),
        "pos": pos,
        "lo": rng.choice([0.0, 10.0, -5.0, 3.0], N),
        "hi": rng.choice([10.0, 0.0, 50.0, 3.0], N),
        "nb": rng.integers(-1, 6, N).astype(np.int64),
    })


def _exact(api):
    F, c, lit = api.F, api.col, api.lit
    out = {
        "floor_x": F.floor(c("x")), "ceil_x": F.ceil(c("x")),
        "floor_a": F.floor(c("a")), "ceil_f": F.ceil(c("f")),
        "rint_x": F.rint(c("x")), "signum_x": F.signum(c("x")),
        "signum_a": F.signum(c("a")), "sqrt_x": F.sqrt(c("x")),
        "sqrt_y": F.sqrt(c("y")), "nanvl_x": F.nanvl(c("x"), c("y")),
        "nanvl_lit": F.nanvl(c("x"), lit(-7.0)),
        "pmod_ab": F.pmod(c("a"), c("b")), "pmod_bigb": F.pmod(c("big"),
                                                                c("b")),
        "pmod_xy": F.pmod(c("x"), c("y")), "pmod_x3": F.pmod(c("x"),
                                                             lit(3.5)),
        "pmod_ba": F.pmod(c("b"), c("a")),
        "factorial_a": F.factorial(c("a")),
        "factorial_b": F.factorial(c("b")),
        "positive_a": F.positive(c("a")),
        "wb": F.width_bucket(c("x"), c("lo"), c("hi"), c("nb")),
        "wb_lit": F.width_bucket(c("y"), lit(-10.0), lit(10.0), lit(7)),
        "bitcount_a": F.bit_count(c("a")),
        "bitcount_big": F.bit_count(c("big")),
        "bitcount_s8": F.bit_count(c("s8")),
        "getbit_big": F.getbit(c("big"), c("pos")),
        "getbit_a": F.getbit(c("a"), c("pos")),
        "pow_int": F.pow(c("a"), lit(2)),
    }
    for d in range(-2, 4):
        tag = f"m{-d}" if d < 0 else str(d)
        out[f"round_x_{tag}"] = F.round(c("x"), d)
        out[f"bround_x_{tag}"] = F.bround(c("x"), d)
        out[f"round_f_{tag}"] = F.round(c("f"), d)
        out[f"bround_f_{tag}"] = F.bround(c("f"), d)
        out[f"round_big_{tag}"] = F.round(c("big"), d)
        out[f"bround_big_{tag}"] = F.bround(c("big"), d)
        out[f"round_a_{tag}"] = F.round(c("a"), d)
        out[f"bround_a_{tag}"] = F.bround(c("a"), d)
    return out


def _transcendental(api):
    F, c, lit = api.F, api.col, api.lit
    unary = ("exp", "log", "log10", "log2", "sin", "cos", "tan", "cbrt",
             "cot", "sec", "csc", "degrees", "radians", "expm1", "log1p",
             "acosh", "asinh", "atanh")
    out = {f"{n}_x": getattr(F, n)(c("x")) for n in unary}
    out.update({f"{n}_y": getattr(F, n)(c("y")) for n in unary})
    # the inverse trigonometric and hyperbolic classes have no wrapper
    MA = importlib.import_module(api.E.__name__.replace(".core", ".math"))
    for cls in ("Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh"):
        out[f"{cls.lower()}_u"] = getattr(MA, cls)(c("u"))
        out[f"{cls.lower()}_y"] = getattr(MA, cls)(c("y"))
    out.update({
        "pow_xy": F.pow(c("x"), c("y")), "pow_yu": F.pow(c("y"), c("u")),
        "pow_big": F.pow(c("big"), lit(0.5)),
        "atan2": F.atan2(c("y"), c("x")), "hypot": F.hypot(c("x"), c("y")),
        "log_base": F.log(c("lo"), c("y")), "log_b2": F.log(lit(2.0),
                                                            c("x")),
    })
    return out


def _select(exprs):
    def build(api, df):
        return df.select(*[e.alias(n) for n, e in exprs(api).items()])
    return build


def _run(build, table, cpu_backend=False):
    out = []
    for api in (torch_api(), jax_api()):
        df = build(api, api.session().create_dataframe(table))
        out.append(df.collect_cpu() if cpu_backend else df.collect())
    return out


def _bits(col):
    return np.asarray(col.to_numpy(zero_copy_only=False))


#: the float-to-long columns of ``_exact``: at +inf and at or above
#: 2^63 the JAX package's CPU backend answers the long minimum (ROADMAP
#: C22, a fault of the reference); the port's saturates, as both device
#: paths and Spark do
C22_COLUMNS = ["floor_x", "ceil_x", "ceil_f"]


@pytest.mark.parametrize("backend", ["device", "cpu_backend"])
def test_exact_math_equals_jax(backend, table):
    got, want = _run(_select(_exact), table, backend == "cpu_backend")
    if backend == "cpu_backend":
        device, _ = _run(_select(_exact), table)
        for name in C22_COLUMNS:
            g, w = got[name].to_pylist(), want[name].to_pylist()
            assert g == device[name].to_pylist(), name
            diff = [i for i in range(len(g)) if g[i] != w[i]]
            assert diff and all(g[i] == 2 ** 63 - 1 and w[i] == -2 ** 63
                                for i in diff), name
        got, want = got.drop(C22_COLUMNS), want.drop(C22_COLUMNS)
    assert_tables_equal(got, want)
    for name in got.schema.names:
        g, w = got[name], want[name]
        assert g.type == w.type, name
        if pa.types.is_floating(g.type):
            # the sign of a zero counts
            gv, wv = _bits(g.fill_null(1.0)), _bits(w.fill_null(1.0))
            zero = gv == 0
            assert (np.signbit(gv[zero]) == np.signbit(wv[zero])).all(), name


def _ulps(g: np.ndarray, w: np.ndarray) -> np.ndarray:
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(all="ignore"):
        d = np.abs(g - w) / np.spacing(np.maximum(np.abs(g), np.abs(w)))
    return np.where(same, 0.0, np.nan_to_num(d, nan=np.inf))


#: XLA's CPU approximations coarser than 2 ulp, and the bound each is
#: held to against numpy's libm
XLA_ULPS = {"cbrt": 128, "log1p": 128, "atanh": 128, "sinh": 8, "tanh": 8}


def test_transcendental_math_within_two_ulp(table):
    got, want = _run(_select(_transcendental), table)
    libm, _ = _run(_select(_transcendental), table, cpu_backend=True)
    assert got.schema == want.schema == libm.schema
    for name in got.schema.names:
        g, w, m = got[name], want[name], libm[name]
        assert g.is_null().equals(w.is_null()), name
        gv, wv, mv = (_bits(c.fill_null(0.0)).astype(np.float64)
                      for c in (g, w, m))
        assert (np.isnan(gv) == np.isnan(wv)).all(), name
        assert _ulps(gv, mv).max() <= 2.0, name
        xla = XLA_ULPS.get(name.split("_")[0])
        if xla is None:
            assert _ulps(gv, wv).max() <= 2.0, name
        else:
            assert _ulps(wv, mv).max() <= xla, name


def test_transcendental_cpu_backends_are_exact(table):
    got, want = _run(_select(_transcendental), table, cpu_backend=True)
    assert_tables_equal(got, want)


def test_math_stays_on_the_device(table):
    api = torch_api()
    s = api.session()
    for exprs in (_exact, _transcendental):
        df = _select(exprs)(api, s.create_dataframe(table))
        meta = PO.wrap_and_tag(df.plan, s.conf)
        assert not [m.reasons for m in meta.walk() if m.reasons]


def test_ansi_getbit_out_of_range_raises(table):
    from spark_rapids_tpu_torch.expr.core import SparkException
    api = torch_api()
    s = api.session({"spark.sql.ansi.enabled": "true"})
    df = s.create_dataframe(table).select(
        api.F.getbit(api.col("big"), api.col("pos")).alias("g"))
    with pytest.raises(SparkException):
        df.collect()
    with pytest.raises(SparkException):
        df.collect_cpu()


def test_subnormals_are_kept(table):
    t = pa.table({"x": [5e-324, -5e-324]})
    got, want = _run(lambda api, df: df.select(
        api.F.ceil(api.col("x")).alias("c"),
        api.F.signum(api.col("x")).alias("s")), t)
    assert got.to_pydict() == {"c": [1, 0], "s": [1.0, -1.0]}
    assert want.to_pydict() == {"c": [0, 0], "s": [0.0, 0.0]}
