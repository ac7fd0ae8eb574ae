"""The port's datetime functions, session timezone and localization pass
against the JAX package, on the CPU.

- Every class of ``expr/datetime.py``: the same seeded edge values (days
  before 1970, year 0 and negative years, 1582-10-04/15, 1900-02-28/03-01,
  2000-02-29, 9999-12-31, timestamps a microsecond either side of
  midnight before 1970, and far years) through the JAX package's device
  path (``eval_tpu`` on the CPU) and the port's device arms on CPU
  tensors, then through the port's CPU backend (``eval_cpu``).
- ``expr/tzdb.py``: the five zones of ``tests/test_timezone.py`` give the
  JAX package's tables, and the device copies are uploaded once; the tz
  shifts at every transition +- 1 us and at local times inside DST gaps
  and overlaps (fold=0) against the JAX package and against Python's
  ``zoneinfo``, an independent parser.
- Non-UTC sessions: the datetime suite, the date <-> timestamp and
  timestamp -> string casts (the repair of C6 among them), a second
  collect of one DataFrame (the JAX package shifts its timestamps again
  there; the port does not), the unknown-zone error, and localization
  inside every plan node kind the JAX package's walk covers.
- The three CPU row functions (date_format, to_date, from_unixtime)
  through the fallback, and SQL and plan ingestion reaching the new
  names.

Tolerances: exact (integer results, compared as integers), except
months_between: one ulp. XLA may turn its ``/ 1e8`` into a product by a
reciprocal (as it does for decimal division), the port divides; both
keep the JAX package's order of operations.
"""
from __future__ import annotations

import datetime as dtm
from zoneinfo import ZoneInfo

import numpy as np
import pyarrow as pa
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import jax_api, torch_api

from spark_rapids_tpu.expr import tzdb as JZ
from spark_rapids_tpu.expr.core import SparkException as JaxSparkException

from spark_rapids_tpu_torch.expr import tzdb as TZ
from spark_rapids_tpu_torch.expr.core import SparkException
from spark_rapids_tpu_torch.plan import overrides as PO
from spark_rapids_tpu_torch.plan.ingest import ingest

from spark_rapids_tpu.plan.ingest import ingest as jax_ingest

ZONES = ["America/New_York", "Europe/Berlin", "Asia/Kolkata",
         "Australia/Sydney", "America/Sao_Paulo"]
DAY_US = 86_400_000_000
_EPOCH = dtm.date(1970, 1, 1)


def _day(y, m, d):
    return (dtm.date(y, m, d) - _EPOCH).days


#: edge days: 0000-01-01 and -0001-01-01 (proleptic Gregorian), the
#: Gregorian switch, the century non-leap year, a leap day, the last day
#: python's datetime knows, and the int32 ends of a DATE plane's far years
EDGE_DAYS = [0, -1, 1, -719528, -719529, -719893, _day(1582, 10, 4),
             _day(1582, 10, 15), _day(1900, 2, 28), _day(1900, 3, 1),
             _day(2000, 2, 29), _day(2000, 3, 1), _day(1999, 12, 31),
             _day(2004, 12, 31), _day(2005, 1, 2), _day(2008, 12, 29),
             _day(9999, 12, 31), -2_000_000, 5_000_000]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(23)
    n = 600
    days = rng.integers(-800_000, 2_950_000, n).astype(np.int32)
    days[:len(EDGE_DAYS)] = EDGE_DAYS
    us = rng.integers(-(2 ** 62), 2 ** 62, n) // 512
    edge_us = [-1, 0, 1, -DAY_US, -DAY_US - 1, -DAY_US + 1,
               _day(1900, 3, 1) * DAY_US - 1, _day(1900, 3, 1) * DAY_US,
               -719528 * DAY_US - 1, _day(9999, 12, 31) * DAY_US + DAY_US - 1]
    us[:len(edge_us)] = edge_us
    mask = rng.random(n) < 0.07
    return pa.table({
        "d": pa.array(days, pa.date32(), mask=mask),
        "ts": pa.array(us, pa.timestamp("us"),
                       mask=np.roll(mask, 3)),
        "n": pa.array(rng.integers(-40, 40, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "big": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "y": rng.integers(-3, 10_000, n).astype(np.int32),
        "m": rng.integers(-1, 14, n).astype(np.int32),
        "dd": rng.integers(-1, 33, n).astype(np.int32),
    })


def _ints(t: pa.Table, name: str) -> list:
    c = t[name]
    if pa.types.is_date32(c.type):
        c = c.cast(pa.int32())
    elif pa.types.is_timestamp(c.type):
        c = c.cast(pa.int64())
    return c.to_pylist()


def _ulp_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a == b or abs(a - b) <= np.spacing(max(abs(a), abs(b)))


def _same(got: pa.Table, want: pa.Table, ulp=()):
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = _ints(got, name), _ints(want, name)
        assert len(g) == len(w), name
        eq = _ulp_equal if name in ulp else (lambda a, b: a == b)
        bad = [i for i in range(len(w)) if not eq(g[i], w[i])]
        assert not bad, (name, [(i, g[i], w[i]) for i in bad[:5]])


#: case -> (columns built from an api namespace, ulp-compared columns)
CASES = {
    "year_month_day": lambda a: [a.F.year(a.col("d")).alias("y"),
                                 a.F.month(a.col("d")).alias("m"),
                                 a.F.dayofmonth(a.col("d")).alias("dm")],
    "ts_parts": lambda a: [a.F.year(a.col("ts")).alias("y"),
                           a.F.month(a.col("ts")).alias("m"),
                           a.F.dayofmonth(a.col("ts")).alias("dm")],
    "time_parts": lambda a: [a.F.hour(a.col("ts")).alias("h"),
                             a.F.minute(a.col("ts")).alias("mi"),
                             a.F.second(a.col("ts")).alias("s")],
    "weekdays": lambda a: [a.F.dayofweek(a.col("d")).alias("dw"),
                           a.F.weekday(a.col("d")).alias("wd"),
                           a.F.dayofweek(a.col("ts")).alias("dwt")],
    "quarter_doy_week": lambda a: [a.F.quarter(a.col("d")).alias("q"),
                                   a.F.dayofyear(a.col("d")).alias("doy"),
                                   a.F.weekofyear(a.col("d")).alias("w"),
                                   a.F.weekofyear(a.col("ts")).alias("wt")],
    "last_day": lambda a: [a.F.last_day(a.col("d")).alias("ld")],
    "add_months": lambda a: [a.F.add_months(a.col("d"), a.col("n"))
                             .alias("am"),
                             a.F.add_months(a.col("d"), 1).alias("am1")],
    "date_add_sub_diff": lambda a: [
        a.F.date_add(a.col("d"), a.col("n")).alias("da"),
        a.F.date_sub(a.col("d"), 3).alias("ds"),
        a.F.datediff(a.col("d"), a.F.date_add(a.col("d"), a.col("n")))
        .alias("df")],
    "trunc": lambda a: [a.F.trunc(a.col("d"), f).alias(f)
                        for f in ("year", "MM", "quarter", "week")],
    "date_trunc_subday": lambda a: [
        a.F.date_trunc(f, a.col("ts")).alias(f)
        for f in ("microsecond", "millisecond", "second", "minute", "hour",
                  "day")],
    "date_trunc_civil": lambda a: [
        a.F.date_trunc(f, a.col("ts")).alias(f)
        for f in ("week", "month", "quarter", "year")]
    + [a.F.date_trunc("month", a.col("d")).alias("of_date")],
    "date_trunc_unknown": lambda a: [
        a.F.date_trunc("fortnight", a.col("ts")).alias("bad")],
    "unix_timestamp": lambda a: [
        a.F.unix_timestamp(a.col("ts")).alias("t"),
        a.F.unix_timestamp(a.col("d")).alias("dt"),
        a.F.timestamp_seconds(a.col("n")).alias("ts")],
    "make_date": lambda a: [a.F.make_date(a.col("y"), a.col("m"),
                                          a.col("dd")).alias("md")],
    "next_day": lambda a: [a.F.next_day(a.col("d"), "TU").alias("tu"),
                           a.F.next_day(a.col("d"), "sunday").alias("su"),
                           a.F.next_day(a.col("d"), "FRIENDS").alias("no")],
    "months_between": lambda a: [
        a.F.months_between(a.col("ts"), a.col("d")).alias("mb"),
        a.F.months_between(a.col("d"), a.F.add_months(a.col("d"), 1),
                           False).alias("mbr"),
        a.F.months_between(a.F.last_day(a.col("d")),
                           a.F.last_day(a.F.add_months(a.col("d"),
                                                       a.col("n"))))
        .alias("last")],
    "unix_conversions": lambda a: [
        a.F.unix_date(a.col("d")).alias("ud"),
        a.F.date_from_unix_date(a.col("n")).alias("fd"),
        a.F.unix_micros(a.col("ts")).alias("umc"),
        a.F.unix_millis(a.col("ts")).alias("uml"),
        a.F.unix_seconds(a.col("ts")).alias("us"),
        a.F.timestamp_millis(a.col("big")).alias("tml"),
        a.F.timestamp_micros(a.col("big")).alias("tmc")],
}
ULP = {"months_between": ("mb", "mbr", "last")}
#: the unknown fmt is tagged to the CPU in both packages
CPU_TAGGED = {"trunc_unknown": lambda a: [
    a.F.trunc(a.col("d"), "day").alias("t")]}


def _select(api, table, build, conf=None):
    return api.session(conf).create_dataframe(table).select(*build(api))


@pytest.mark.parametrize("case", list(CASES) + list(CPU_TAGGED))
def test_each_class_equals_jax_device_and_cpu(case, table):
    build = CASES.get(case) or CPU_TAGGED[case]
    port = _select(torch_api(), table, build)
    want = _select(jax_api(), table, build).collect()
    ulp = ULP.get(case, ())
    _same(port.collect(), want, ulp)
    _same(port.collect_cpu(), want, ulp)
    meta = PO.wrap_and_tag(port.plan, port.session.conf)
    assert bool(meta.reasons) == (case in CPU_TAGGED), meta.reasons


def test_floor_semantics_of_the_civil_helpers():
    """Floor division and modulo of negatives, in int64: the port's one
    implementation on torch and on numpy, against python's datetime."""
    from spark_rapids_tpu_torch.expr import datetime as DT
    days = np.array(EDGE_DAYS[:-2] + list(range(-1000, 1000, 7)), np.int64)
    for xs in (torch.from_numpy(days), days):
        y, m, d = (np.asarray(v) for v in DT._civil_from_days(xs))
        for k, v in enumerate(days):
            if v >= -719162:  # python's date starts at 0001-01-01
                got = dtm.date(int(y[k]), int(m[k]), int(d[k]))
                assert got == _EPOCH + dtm.timedelta(days=int(v))
        back = np.asarray(DT._days_from_civil(*(
            torch.from_numpy(v) if isinstance(xs, torch.Tensor) else v
            for v in (y, m, d))))
        assert np.array_equal(back, days)


# ---------------------------------------------------------------------------
# tzdb and the shifts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zone", ZONES + ["UTC"])
def test_zone_tables_equal_jax_and_upload_once(zone):
    # the JAX package's table is the TZif file's; the port's goes on with
    # the footer's rule (ROADMAP C15), so the JAX table is its prefix
    for got, want in ((TZ.zone_table(zone), JZ.zone_table(zone)),
                      (TZ.local_boundaries(zone),
                       JZ.local_boundaries(zone))):
        n = len(want[0])
        assert np.array_equal(got[0][:n], want[0])
        assert np.array_equal(got[1][:n + 1], want[1])
    last, horizon, _ = TZ.table_span(zone)
    has_dst = TZ.parse_posix_tz(TZ._read_zone(zone)[3])[1] is not None
    assert horizon == (TZ.HORIZON_YEAR if has_dst else last)
    first = TZ.device_table(zone, "cpu")
    assert TZ.device_table(zone, torch.device("cpu"))[0] is first[0]
    assert TZ.source(zone).endswith(zone)


def _edge_instants(zone):
    """UTC instants at every transition of the zone from 1900 to 2037,
    +- 1 us, and local wall times inside each gap and overlap."""
    trans, offs = TZ.zone_table(zone)
    lo, hi = -2_208_988_800 * 10 ** 6, 2_145_916_800 * 10 ** 6
    keep = (trans > lo) & (trans < hi)
    t, before, after = trans[keep], offs[:-1][keep], offs[1:][keep]
    utc = np.concatenate([t - 1, t, t + 1])
    # local times: the boundary +- 1 us and the middle of the jump
    local = np.concatenate([t + before, t + after, t + before - 1,
                            t + after - 1, t + (before + after) // 2])
    return utc, local


def _zoneinfo_from_utc(zone, us):
    z = ZoneInfo(zone)
    out = []
    for v in us:
        inst = dtm.datetime(1970, 1, 1, tzinfo=dtm.timezone.utc) \
            + dtm.timedelta(microseconds=int(v))
        out.append(int(v) + int(inst.astimezone(z).utcoffset()
                                / dtm.timedelta(microseconds=1)))
    return out


def _zoneinfo_to_utc(zone, us):
    z = ZoneInfo(zone)
    out = []
    for v in us:
        naive = dtm.datetime(1970, 1, 1) + dtm.timedelta(microseconds=int(v))
        off = naive.replace(tzinfo=z, fold=0).utcoffset()
        out.append(int(v) - int(off / dtm.timedelta(microseconds=1)))
    return out


@pytest.mark.parametrize("zone", ZONES)
def test_tz_shifts_at_transitions_equal_jax_and_zoneinfo(zone):
    utc, local = _edge_instants(zone)
    rng = np.random.default_rng(5)
    rand = rng.integers(-1_500_000_000, 2_000_000_000, 200) * 10 ** 6
    n = max(len(utc), len(local)) + len(rand)
    t = pa.table({
        "u": pa.array(np.resize(np.concatenate([utc, rand]), n),
                      pa.timestamp("us")),
        "l": pa.array(np.resize(np.concatenate([local, rand]), n),
                      pa.timestamp("us"))})

    def build(a):
        return [a.F.from_utc_timestamp(a.col("u"), zone).alias("f"),
                a.F.to_utc_timestamp(a.col("l"), zone).alias("t")]
    port = _select(torch_api(), t, build)
    want = _select(jax_api(), t, build).collect()
    got = port.collect()
    _same(got, want)
    _same(port.collect_cpu(), want)
    assert _ints(got, "f") == _zoneinfo_from_utc(zone, _ints(t, "u"))
    assert _ints(got, "t") == _zoneinfo_to_utc(zone, _ints(t, "l"))


# ---------------------------------------------------------------------------
# Non-UTC sessions
# ---------------------------------------------------------------------------

def _ts_table(n=300, seed=11):
    """tests/test_timezone.py's timestamps (1922..2033, whole seconds),
    with dates and date strings beside them."""
    rng = np.random.default_rng(seed)
    secs = rng.integers(-1_500_000_000, 2_000_000_000, n)
    mask = rng.random(n) < 0.08
    days = (secs // 86_400).astype(np.int32)
    return pa.table({
        "ts": pa.array(secs * 10 ** 6, pa.timestamp("us"), mask=mask),
        "d": pa.array(days, pa.date32(), mask=np.roll(mask, 1)),
        "s": pa.array([str(_EPOCH + dtm.timedelta(days=int(v))) + " 10:30:00"
                       for v in days]),
        "sec": secs})


def _session_pair(zone):
    conf = {"spark.sql.session.timeZone": zone}
    return torch_api().session(conf), jax_api().session(conf)


def _suite(a):
    F, c, T = a.F, a.col, a.T
    return [F.year(c("ts")).alias("y"), F.month(c("ts")).alias("m"),
            F.dayofmonth(c("ts")).alias("d"), F.hour(c("ts")).alias("h"),
            F.minute(c("ts")).alias("mi"), F.second(c("ts")).alias("se"),
            F.quarter(c("ts")).alias("q"), F.dayofweek(c("ts")).alias("dw"),
            F.dayofyear(c("ts")).alias("doy"),
            F.weekofyear(c("ts")).alias("w"),
            F.last_day(c("ts").cast(T.DATE)).alias("ld"),
            F.trunc(c("ts"), "month").alias("tr"),
            F.unix_timestamp(c("ts")).alias("ut"),
            c("ts").cast(T.DATE).alias("cd"),
            c("ts").cast(T.STRING).alias("cs"),
            c("d").cast(T.TIMESTAMP).alias("dts"),
            c("s").cast(T.TIMESTAMP).alias("sts"),
            F.year(c("d")).alias("yd")]


@pytest.mark.parametrize("zone", ZONES)
def test_non_utc_session_datetime_suite_matches_jax(zone):
    t = _ts_table()
    port, ref = _session_pair(zone)
    df = port.create_dataframe(t).select(*_suite(torch_api()))
    first = df.collect()
    _same(first, ref.create_dataframe(t).select(*_suite(jax_api()))
          .collect())
    # the JAX package's plan is rewritten in place and a second collect
    # shifts again; the port's plan stays as it was
    _same(df.collect(), first)
    _same(df.collect_cpu(), first)


def test_non_utc_cast_ts_to_date_matches_jax():
    """C6: the port ignored spark.sql.session.timeZone."""
    t = pa.table({"ts": pa.array(
        [dtm.datetime(2024, 3, 7, 2, 30),   # 2024-03-06 in New York
         dtm.datetime(2024, 3, 7, 12, 0),   # 2024-03-07 in New York
         None], pa.timestamp("us"))})
    port, ref = _session_pair("America/New_York")
    got = port.create_dataframe(t).select(
        torch_api().col("ts").cast(torch_api().T.DATE).alias("d")).collect()
    want = ref.create_dataframe(t).select(
        jax_api().col("ts").cast(jax_api().T.DateType()).alias("d"))
    assert got.to_pydict() == want.to_pydict() == {
        "d": [dtm.date(2024, 3, 6), dtm.date(2024, 3, 7), None]}


@pytest.mark.parametrize("build,raises", [
    (lambda a: [a.F.year(a.col("ts")).alias("y")], True),
    (lambda a: [a.F.hour(a.col("ts")).alias("h")], True),
    (lambda a: [a.col("ts").cast(a.T.DATE).alias("cd")], False),
    (lambda a: [a.F.year(a.col("d")).alias("yd")], False)],
    ids=["year_of_ts", "hour", "cast", "year_of_date"])
def test_unknown_zone_raises_like_jax(build, raises):
    t = _ts_table(20)
    port, ref = _session_pair("Mars/Olympus_Mons")
    jdf = ref.create_dataframe(t).select(*build(jax_api()))
    pdf = port.create_dataframe(t).select(*build(torch_api()))
    if not raises:
        _same(pdf.collect(), jdf.collect())
        return
    with pytest.raises(JaxSparkException) as j:
        jdf.collect()
    with pytest.raises(SparkException) as p:
        pdf.collect()
    assert str(p.value) == str(j.value)
    assert "Mars/Olympus_Mons" in str(p.value)


def _by_node(a, df):
    """A program with timestamp expressions in every plan node kind the
    JAX package's localization walk covers."""
    F, c, W = a.F, a.col, a.Window
    h = F.hour(c("ts"))
    agg = (df.filter(F.month(c("ts")) > 3)
           .group_by(F.year(c("ts")).alias("y"))
           .agg(F.sum(h).alias("sh"), F.count(c("ts")).alias("n")))
    dim = df.select(F.dayofmonth(c("ts")).alias("k"),
                    F.minute(c("ts")).alias("mk")).filter(
        c("k") < 4).drop_duplicates()
    joined = df.select(c("ts"), F.dayofmonth(c("ts")).alias("dm")).join(
        dim, on=[(F.dayofmonth(c("ts")), c("k"))], how="inner")
    win = df.select(c("ts"), F.max(h).over(
        W.partition_by(F.year(c("ts"))).order_by(F.month(c("ts"))))
        .alias("wm"))
    roll = df.rollup(F.quarter(c("ts")).alias("q")).agg(
        F.max(h).alias("mh"))
    ordered = df.order_by(F.hour(c("ts")), c("sec")).select(c("sec"))
    return {"agg": agg, "join": joined.select(c("dm"), c("mk")),
            "window": win, "rollup": roll, "sort": ordered}


@pytest.mark.parametrize("node", ["agg", "join", "window", "rollup",
                                  "sort"])
def test_localization_in_every_node_kind(node):
    t = _ts_table(200, seed=3)
    port, ref = _session_pair("Australia/Sydney")
    got = _by_node(torch_api(), port.create_dataframe(t))[node].collect()
    want = _by_node(jax_api(), ref.create_dataframe(t))[node].collect()
    if node == "sort":
        _same(got, want)
    else:
        key = got.column_names
        _same(got.sort_by([(k, "ascending") for k in key]),
              want.sort_by([(k, "ascending") for k in key]))


def test_localize_plan_copies_and_wraps_once():
    t = _ts_table(10)
    port, _ = _session_pair("Asia/Kolkata")
    a = torch_api()
    df = port.create_dataframe(t).select(a.F.hour(a.col("ts")).alias("h"))
    before = repr(df.plan.exprs)
    once = PO.localize_plan(df.plan, port.conf)
    assert repr(df.plan.exprs) == before
    assert repr(once.exprs).count("FromUtcTimestamp") == 1
    twice = PO.localize_plan(df.plan, port.conf)
    assert repr(twice.exprs) == repr(once.exprs)


# ---------------------------------------------------------------------------
# The CPU row functions, SQL and plan ingestion
# ---------------------------------------------------------------------------

ROW_FUNCTIONS = {
    "date_format": lambda a: [a.F.date_format(a.col("d"), "yyyy/MM")
                              .alias("f"),
                              a.F.date_format(a.col("ts"),
                                              "yyyy-MM-dd HH:mm").alias("g")],
    "to_date": lambda a: [a.F.to_date(a.col("s"), "yyyy-MM-dd HH:mm:ss")
                          .alias("t")],
    "from_unixtime": lambda a: [a.F.from_unixtime(a.col("sec")).alias("u")],
}


@pytest.mark.parametrize("zone", ["UTC", "America/Sao_Paulo"])
@pytest.mark.parametrize("fn", list(ROW_FUNCTIONS))
def test_cpu_row_functions_fall_back_like_jax(fn, zone):
    from spark_rapids_tpu.plan import overrides as JO
    t = _ts_table(120, seed=8)
    port, ref = _session_pair(zone)
    pdf = port.create_dataframe(t).select(*ROW_FUNCTIONS[fn](torch_api()))
    jdf = ref.create_dataframe(t).select(*ROW_FUNCTIONS[fn](jax_api()))
    _same(pdf.collect(), jdf.collect())
    reasons = PO.wrap_and_tag(pdf.plan, port.conf).reasons
    jreasons = JO.wrap_and_tag(jdf.plan, ref.conf).reasons
    assert reasons == jreasons and reasons
    assert all("runs on CPU" in r for r in reasons)


def test_sql_reaches_the_datetime_names():
    t = _ts_table(150, seed=4)
    q = ("SELECT year(d) AS y, quarter(d) AS q, month(ts) AS m, "
         "datediff(d, date_sub(d, 30)) AS dd, weekofyear(ts) AS w, "
         "CAST(ts AS string) AS s, CAST(s AS timestamp) AS st, "
         "last_day(d) AS ld FROM tt WHERE dayofweek(d) > 1")
    out = []
    for a in (torch_api(), jax_api()):
        s = a.session()
        s.create_or_replace_temp_view("tt", s.create_dataframe(t))
        out.append(s.sql(q).collect())
    _same(*out)


def test_ingest_reaches_the_datetime_names():
    doc = {"version": 1, "plan": {
        "node": "project",
        "exprs": [{"expr": "call", "fn": fn,
                   "args": [{"expr": "col", "name": "d"}]}
                  for fn in ("year", "dayofyear", "last_day",
                             "unix_date")],
        "child": {"node": "in_memory",
                  "rows": {"d": [-1, 0, 59, 11016, -719528]}}}}
    got = ingest(doc, torch_api().session()).collect()
    want = jax_ingest(doc, jax_api().session()).collect()
    _same(got, want)


# ---------------------------------------------------------------------------
# The smoke's datetime shapes, at a small size
# ---------------------------------------------------------------------------

SHAPES = ["dt_year_month", "dt_q6_add_months", "dt_daily_repart",
          "dt_ts_groups", "dt_ts_rows", "dt_cast_checks",
          "dt_ts_string_hours", "dt_format_fb", "dt_tz_hours", "dt_tz_days",
          "dt_tz_shifts", "sql_dt"]


@pytest.fixture(scope="module")
def lineitem_dt():
    return H.lineitem_dt(H.make_lineitem(4000, seed=5))


def _sorted(t: pa.Table) -> pa.Table:
    return t.sort_by([(k, "ascending") for k in t.column_names])


@pytest.mark.parametrize("shape", SHAPES)
def test_smoke_datetime_shapes_equal_jax(shape, lineitem_dt):
    from spark_rapids_tpu.plan import overrides as JO
    zone = H.DT_SESSION_ZONE if shape.startswith("dt_tz") else "UTC"
    conf = {"spark.sql.session.timeZone": zone}
    parts = 8 if shape == "dt_daily_repart" else 1
    out, metas = [], []
    for a, overrides in ((torch_api(), PO), (jax_api(), JO)):
        s = a.session(conf)
        df = s.create_dataframe(lineitem_dt, num_partitions=parts)
        if shape == "sql_dt":
            s.create_or_replace_temp_view("lineitem_dt", df)
            q = s.sql(H.SQL_DT)
        else:
            q = getattr(H, shape)(a, df)
        out.append(q.collect())
        metas.append(overrides.wrap_and_tag(q.plan, s.conf))
    got, want = out
    if shape != "dt_ts_rows":
        got, want = _sorted(got), _sorted(want)
    _same(got, want, ulp=("mb", "revenue", "s", "sq"))
    cpu = [type(m.plan).__name__ for m in _walk(metas[0]) if m.reasons]
    assert cpu == ([H.DT_FALLBACK_NODE] if shape == "dt_format_fb" else [])


def _walk(meta):
    yield meta
    for c in meta.children:
        yield from _walk(c)


# ---------------------------------------------------------------------------
# ROADMAP C13: timestamp literals
# ---------------------------------------------------------------------------

def _c13_table():
    us = [949_320_000_000_000 + k * 86_400_000_000 * 37 for k in range(-5, 6)]
    return pa.table({"t": pa.array(us + [None], pa.timestamp("us"))})


@pytest.mark.parametrize("aware", [False, True])
def test_timestamp_literal_in_projection_comparison_and_months_between(
        aware):
    """A datetime.datetime literal is a TIMESTAMP (C13): a projection, a
    comparison and months_between, on the port's device and CPU, equal
    the JAX package's answer (naive means UTC; an aware value converts by
    its own offset)."""
    tz = dtm.timezone(dtm.timedelta(hours=-5)) if aware else None
    lit_v = dtm.datetime(2000, 1, 31, 12, 0, 0, 250_000, tzinfo=tz)
    got = []
    for api in (torch_api(), jax_api()):
        F, c, lit = api.F, api.col, api.lit
        assert lit(lit_v).data_type() == api.T.TIMESTAMP
        df = api.session().create_dataframe(_c13_table()).select(
            c("t"), lit(lit_v).alias("l"), (c("t") > lit(lit_v)).alias("gt"),
            F.months_between(c("t"), lit(lit_v)).alias("mb"))
        got.append(df.collect())
        if api.T is not jax_api().T:
            got.append(df.collect_cpu())
    _same(got[0], got[2], ulp=("mb",))
    _same(got[1], got[2], ulp=("mb",))
    want = int((lit_v.replace(tzinfo=tz or dtm.timezone.utc)
                - dtm.datetime(1970, 1, 1, tzinfo=dtm.timezone.utc))
               // dtm.timedelta(microseconds=1))
    assert got[0].column("l").cast(pa.int64()).to_pylist()[0] == want


def test_timestamp_literal_roadmap_case():
    """months_between of a timestamp column and a datetime literal: the
    JAX package's 292.5338, which the port raised on before C13."""
    t = pa.table({"t": pa.array([dtm.datetime(2024, 6, 17, 1, 8, 48)],
                                pa.timestamp("us"))})
    out = []
    for api in (torch_api(), jax_api()):
        out.append(api.session().create_dataframe(t).select(
            api.F.months_between(api.col("t"), api.lit(
                dtm.datetime(2000, 1, 31, 12))).alias("mb")).collect()
            .column("mb").to_pylist()[0])
    assert _ulp_equal(out[0], out[1]) and round(out[0], 4) == 292.5338


# ---------------------------------------------------------------------------
# ROADMAP C15: zone offsets past the TZif table
# ---------------------------------------------------------------------------

def _far_instants(n=300, seed=31):
    rng = np.random.default_rng(seed)
    span = 158 * 365 * 86_400
    return rng.integers(-span, span, n) * 10 ** 6 \
        + rng.integers(0, 10 ** 6, n)


@pytest.mark.parametrize("zone", ["America/New_York", "Europe/London"])
def test_far_instants_follow_the_footer_rule(zone):
    """300 seeded instants within +-158 years: from_utc_timestamp and
    to_utc_timestamp on the port's device and CPU equal zoneinfo's
    (Spark's answer); the JAX package's device keeps the last recorded
    offset past its table's end and differs on some (C15)."""
    us = _far_instants()
    t = pa.table({"ts": pa.array(us, pa.timestamp("us"))})
    want_from = _zoneinfo_from_utc(zone, us)
    want_to = _zoneinfo_to_utc(zone, us)

    def build(api):
        F, c = api.F, api.col
        return api.session().create_dataframe(t).select(
            F.from_utc_timestamp(c("ts"), zone).alias("f"),
            F.to_utc_timestamp(c("ts"), zone).alias("u"))
    df = build(torch_api())
    for got in (df.collect(), df.collect_cpu()):
        assert _ints(got, "f") == want_from
        assert _ints(got, "u") == want_to
    jax = build(jax_api()).collect()
    assert _ints(jax, "f") != want_from
    late = us > 2_200_000_000 * 10 ** 6
    assert np.array_equal(np.asarray(_ints(jax, "f"))[~late],
                          np.asarray(want_from)[~late])


def _tzif_slim(transitions, types, footer: str) -> bytes:
    """A version 2 TZif file (RFC 8536) with an empty version 1 block, the
    64-bit transitions and their types, and the footer's TZ string: the
    layout of a zone file built with ``zic -b slim``."""
    import struct

    def block(trans, idx, tys, chars, width):
        out = struct.pack(">4sc15x6I", b"TZif", b"2", 0, 0, 0, len(trans),
                          len(tys), len(chars))
        out += struct.pack(">%d%s" % (len(trans), "q" if width == 8 else "l"),
                           *trans)
        out += bytes(idx)
        for off, dst, ab in tys:
            out += struct.pack(">lBB", off, dst, ab)
        return out + chars
    v1 = block([], [], [(types[0][0], 0, 0)], b"LMT\0", 4)
    v2 = block([t for t, _ in transitions], [i for _, i in transitions],
               types, b"EST\0EDT\0", 8)
    return v1 + v2 + b"\n" + footer.encode() + b"\n"


def test_slim_tzif_file_extends_by_its_footer(tmp_path, monkeypatch):
    """A zone file that stops at 2007 (a slim build) still gives New
    York's daylight time after 2007, from its footer's rule."""
    def utc(y, m, d, h):
        return int(dtm.datetime(y, m, d, h, tzinfo=dtm.timezone.utc)
                   .timestamp())
    trans = []
    for y, on, off in ((2005, (4, 3), (10, 30)), (2006, (4, 2), (10, 29)),
                       (2007, (3, 11), (11, 4))):
        trans += [(utc(y, *on, 7), 1), (utc(y, *off, 6), 0)]
    data = _tzif_slim(trans, [(-18000, 0, 0), (-14400, 1, 4)],
                      "EST5EDT,M3.2.0,M11.1.0")
    (tmp_path / "Test").mkdir()
    (tmp_path / "Test" / "Slim").write_bytes(data)
    monkeypatch.setattr(TZ, "_TZPATHS", (str(tmp_path),))
    TZ.zone_table.cache_clear()
    TZ.local_boundaries.cache_clear()
    try:
        assert TZ.table_span("Test/Slim")[:2] == (2007, TZ.HORIZON_YEAR)
        us = _far_instants(300, 7)
        us = us[us > utc(2008, 1, 1, 0) * 10 ** 6]
        ny = np.asarray(_zoneinfo_from_utc("America/New_York", us)) - us
        assert np.array_equal(TZ.utc_offset_us("Test/Slim", us), ny)
        t = pa.table({"ts": pa.array(us, pa.timestamp("us"))})
        api = torch_api()
        df = api.session().create_dataframe(t).select(
            api.F.from_utc_timestamp(api.col("ts"), "Test/Slim").alias("f"))
        for got in (df.collect(), df.collect_cpu()):
            assert np.array_equal(np.asarray(_ints(got, "f")) - us, ny)
        summer = TZ.utc_offset_us("Test/Slim", np.asarray(
            [utc(2020, 7, 1, 12) * 10 ** 6]))
        assert summer[0] == -4 * 3600 * 10 ** 6
    finally:
        TZ.zone_table.cache_clear()
        TZ.local_boundaries.cache_clear()
        TZ._DEVICE_TABLES.clear()


@pytest.mark.parametrize("tz,year,want", [
    # Sydney: DST across the new year; an end at 03:00 local
    ("AEST-10AEDT,M10.1.0,M4.1.0/3", 2050, [(2050, 4, 2, 16), (2050, 10, 1,
                                                               16)]),
    # Julian day forms and hours past 24 or below 0
    ("XST3XDT,J60/25,300/-1", 2051, [(2051, 3, 2, 4), (2051, 10, 28, 1)]),
    # every instant daylight: start at day 0, end after the last day
    ("EST5EDT4,0/0,J365/25", 2052, [(2052, 1, 1, 5), (2053, 1, 1, 5)]),
])
def test_posix_rule_forms(tz, year, want):
    std, dst, start, end = TZ.parse_posix_tz(tz)
    got_t, got_o = TZ._footer_transitions(tz, -(2 ** 62), year)
    first = [dtm.datetime(1970, 1, 1) + dtm.timedelta(seconds=s)
             for s in got_t[:2]]
    assert [(d.year, d.month, d.day, d.hour) for d in first] == want
    assert set(got_o) <= {std, dst}
