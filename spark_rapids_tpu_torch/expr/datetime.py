"""Date and time expressions (counterpart of
``spark_rapids_tpu/expr/datetime.py``; reference datetimeExpressions.scala).

DateType is days since 1970-01-01 (int32); TimestampType is microseconds
since the epoch, UTC (int64). Civil dates decompose with Howard Hinnant's
branch-free days-from-civil algorithms, in int64 (``+ 719468`` and
``153 * mp`` overflow int32 at the far years), with floor division and
modulo throughout: ``torch.div(..., rounding_mode="floor")`` and
``torch.remainder`` on the device, numpy's ``floor_divide`` and ``mod``
on the host. One implementation of each helper serves both (``_fdiv``,
``_fmod``, ``_where`` dispatch on the operand), so the CPU backend's
``eval_cpu`` computes what the device computes, in numpy.

The classes: Year, Month, DayOfMonth, Hour, Minute, Second, DayOfWeek,
WeekDay, DateAdd/DateSub, DateDiff, LastDay, Quarter, DayOfYear,
WeekOfYear (ISO, Thursday rule), AddMonths (end-of-month clamp),
TruncTimestamp, TruncDate, UnixTimestampFromTs, TimestampSeconds,
FromUtcTimestamp/ToUtcTimestamp (the zone's transition table from
``expr/tzdb.py``, on the device), MakeDate, NextDay, MonthsBetween, and
the unit conversions (UnixDate, DateFromUnixDate, UnixMicros/Millis/
Seconds, TimestampMillis/Micros). A session in another zone than UTC
reaches them through ``plan/overrides.localize_plan``, which shifts the
timestamps they read.
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector
from spark_rapids_tpu_torch.expr import tzdb
from spark_rapids_tpu_torch.expr.core import (
    CpuCol, Expression, SparkException, _valid_of,
)

_DAY_US = 86_400_000_000


def _fdiv(a, b):
    """Floor division (Spark's floorDiv) of a tensor or a numpy array."""
    if isinstance(a, torch.Tensor):
        return torch.div(a, b, rounding_mode="floor")
    return np.floor_divide(a, b)


def _fmod(a, b):
    """Floor modulo (the sign of the divisor) of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return torch.remainder(a, b)
    return np.mod(a, b)


def _where(c, a, b):
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return np.where(c, a, b)


def _ones_like(x):
    return torch.ones_like(x) if isinstance(x, torch.Tensor) \
        else np.ones_like(x)


def _civil_from_days(days):
    """int64 days since the epoch -> (year, month, day), each int64."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                   # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + _where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> int64 days since the epoch (the inverse of
    _civil_from_days; the JAX module's second definition, which is the
    one its callers get)."""
    y = y - _where(m <= 2, 1, 0)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + _where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _month_len(y, m):
    """Days in month m (1..12) of year y: 31 for Jan, Mar, May, Jul, Aug,
    Oct, Dec, 30 for the others, February by the Gregorian leap rule."""
    leap = ((_fmod(y, 4) == 0) & (_fmod(y, 100) != 0)) | (_fmod(y, 400) == 0)
    base = 30 + _fmod(m + (m >= 8), 2)
    return _where(m == 2, 28 + leap, base)


def _days(c: ColumnVector):
    """int64 days since the epoch of a DATE or TIMESTAMP device column."""
    v = c.data.to(torch.int64)
    if isinstance(c.dtype, T.TimestampType):
        return _fdiv(v, _DAY_US)
    return v


def _days_np(c: CpuCol) -> np.ndarray:
    v = c.values.astype(np.int64)
    if isinstance(c.dtype, T.TimestampType):
        return np.floor_divide(v, _DAY_US)
    return v


class _Unary(Expression):
    """One child, one result plane computed by ``_compute`` from the
    child's days since the epoch, or from its raw int64 plane (``raw``),
    the same code on the device and in the CPU backend."""

    result = T.INT32
    raw = False

    def __init__(self, child):
        self.children = [child]

    def data_type(self):
        return self.result

    def with_children(self, children):
        return type(self)(children[0])

    def _compute(self, x, dtype):
        raise NotImplementedError

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        x = c.data.to(torch.int64) if self.raw else _days(c)
        out = self._compute(x, c.dtype)
        return ColumnVector(self.result, out.to(self.result.torch_dtype),
                            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        x = c.values.astype(np.int64) if self.raw else _days_np(c)
        out = self._compute(x, c.dtype)
        return CpuCol(self.result, np.asarray(out).astype(
            self.result.np_dtype), c.valid)


class _DatePart(_Unary):
    part = "year"

    def _compute(self, days, dtype):
        y, m, d = _civil_from_days(days)
        return {"year": y, "month": m, "day": d}[self.part]


class Year(_DatePart):
    part = "year"


class Month(_DatePart):
    part = "month"


class DayOfMonth(_DatePart):
    part = "day"


class _TimePart(_Unary):
    """hour/minute/second of a timestamp (in the session zone after
    localization)."""

    part = "hour"
    raw = True

    def _compute(self, us, dtype):
        sec_of_day = _fmod(_fdiv(us, 1_000_000), 86400)
        if self.part == "hour":
            return _fdiv(sec_of_day, 3600)
        if self.part == "minute":
            return _fmod(_fdiv(sec_of_day, 60), 60)
        return _fmod(sec_of_day, 60)


class Hour(_TimePart):
    part = "hour"


class Minute(_TimePart):
    part = "minute"


class Second(_TimePart):
    part = "second"


class DayOfWeek(_Unary):
    """Spark dayofweek: 1 = Sunday ... 7 = Saturday."""

    def _compute(self, days, dtype):
        return _fmod(days + 4, 7) + 1  # 1970-01-01 was a Thursday (=5)


class WeekDay(_Unary):
    """Spark weekday: 0 = Monday ... 6 = Sunday."""

    def _compute(self, days, dtype):
        return _fmod(days + 3, 7)


class Quarter(_DatePart):
    part = "quarter"

    def _compute(self, days, dtype):
        _, m, _ = _civil_from_days(days)
        return _fdiv(m - 1, 3) + 1


class DayOfYear(_DatePart):
    part = "doy"

    def _compute(self, days, dtype):
        y, _, _ = _civil_from_days(days)
        one = _ones_like(y)
        return days - _days_from_civil(y, one, one) + 1


class WeekOfYear(_DatePart):
    """ISO-8601 week number (Spark weekofyear): the Thursday of a date's
    week decides its year."""

    part = "week"

    def _compute(self, days, dtype):
        thursday = days - _fmod(days + 3, 7) + 3
        y, _, _ = _civil_from_days(thursday)
        one = _ones_like(y)
        return _fdiv(thursday - _days_from_civil(y, one, one), 7) + 1


class LastDay(_Unary):
    result = T.DATE

    def _compute(self, days, dtype):
        y, m, d = _civil_from_days(days)
        return days - d + _month_len(y, m)


class UnixTimestampFromTs(_Unary):
    """unix_timestamp(ts): seconds since the epoch (floor division); a
    DATE counts its days' seconds."""

    result = T.INT64
    raw = True

    def _compute(self, v, dtype):
        if isinstance(dtype, T.DateType):
            return v * 86_400
        return _fdiv(v, 1_000_000)


class TimestampSeconds(_Unary):
    """timestamp_seconds(long) -> timestamp."""

    result = T.TIMESTAMP
    raw = True

    def _compute(self, v, dtype):
        return v * 1_000_000


class DateAdd(Expression):
    """date_add(date, n), in int32 as Spark computes it."""

    negate = False

    def __init__(self, left, right):
        self.children = [left, right]

    def data_type(self):
        return T.DATE

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval(self, ctx):
        l = self.children[0].eval(ctx)
        r = self.children[1].eval(ctx)
        n = r.data.to(torch.int32)
        if self.negate:
            n = -n
        return ColumnVector(T.DATE, l.data.to(torch.int32) + n,
                            _valid_of(l, ctx) & _valid_of(r, ctx))

    def eval_cpu(self, cols, ansi=False):
        l = self.children[0].eval_cpu(cols, ansi)
        r = self.children[1].eval_cpu(cols, ansi)
        n = r.values.astype(np.int32)
        if self.negate:
            n = -n
        return CpuCol(T.DATE, l.values.astype(np.int32) + n,
                      l.valid & r.valid)


class DateSub(DateAdd):
    negate = True


class DateDiff(Expression):
    """datediff(end, start) in days."""

    def __init__(self, end, start):
        self.children = [end, start]

    def data_type(self):
        return T.INT32

    def with_children(self, children):
        return DateDiff(children[0], children[1])

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)
        return ColumnVector(T.INT32, e.data.to(torch.int32)
                            - s.data.to(torch.int32),
                            _valid_of(e, ctx) & _valid_of(s, ctx))

    def eval_cpu(self, cols, ansi=False):
        e = self.children[0].eval_cpu(cols, ansi)
        s = self.children[1].eval_cpu(cols, ansi)
        return CpuCol(T.INT32, e.values.astype(np.int32)
                      - s.values.astype(np.int32), e.valid & s.valid)


def _add_months(days, n):
    y, m, d = _civil_from_days(days)
    tot = y * 12 + (m - 1) + n
    ny = _fdiv(tot, 12)
    nm = _fmod(tot, 12) + 1
    lim = _month_len(ny, nm)
    return _days_from_civil(ny, nm, _where(d < lim, d, lim))


class AddMonths(Expression):
    """add_months(date, n): the day of month clamps to the target month's
    end (Spark semantics)."""

    def __init__(self, child, months):
        self.children = [child, months]

    def data_type(self):
        return T.DATE

    def with_children(self, children):
        return AddMonths(children[0], children[1])

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        n = self.children[1].eval(ctx)
        out = _add_months(_days(c), n.data.to(torch.int64))
        return ColumnVector(T.DATE, out.to(torch.int32),
                            _valid_of(c, ctx) & _valid_of(n, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        n = self.children[1].eval_cpu(cols, ansi)
        out = _add_months(_days_np(c), n.values.astype(np.int64))
        return CpuCol(T.DATE, out.astype(np.int32), c.valid & n.valid)


def _trunc_days(days, kind: str):
    """Days truncated to the start of their year ("y"), month ("m"),
    quarter ("q") or ISO week, Monday ("w")."""
    if kind == "w":
        return days - _fmod(days + 3, 7)
    y, m, d = _civil_from_days(days)
    one = _ones_like(d)
    if kind == "y":
        return _days_from_civil(y, one, one)
    if kind == "m":
        return _days_from_civil(y, m, one)
    return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)


class TruncTimestamp(Expression):
    """date_trunc(fmt, ts) -> timestamp. Sub-day levels are a floor modulo
    on microseconds; day and up truncate the civil date and return its
    midnight. An unsupported fmt gives null rows (Spark's null on a bad
    format outside ANSI)."""

    _US = {"microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
           "minute": 60_000_000, "hour": 3_600_000_000,
           "day": _DAY_US, "dd": _DAY_US}
    _CIVIL = {"week": "w", "month": "m", "mon": "m", "mm": "m",
              "quarter": "q", "year": "y", "yyyy": "y", "yy": "y"}

    def __init__(self, child, fmt: str):
        self.children = [child]
        self.fmt = fmt.lower()

    def _params(self):
        return self.fmt

    def data_type(self):
        return T.TIMESTAMP

    def with_children(self, children):
        return TruncTimestamp(children[0], self.fmt)

    def _known(self) -> bool:
        return self.fmt in self._US or self.fmt in self._CIVIL

    def _trunc_us(self, us):
        if self.fmt in self._US:
            return us - _fmod(us, self._US[self.fmt])
        return _trunc_days(_fdiv(us, _DAY_US),
                           self._CIVIL[self.fmt]) * _DAY_US

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        us = c.data.to(torch.int64)
        if not isinstance(c.dtype, T.TimestampType):
            us = us * _DAY_US  # DATE child: the implicit cast (days)
        if not self._known():
            z = torch.zeros_like(us)
            return ColumnVector(T.TIMESTAMP, z, z != 0)
        return ColumnVector(T.TIMESTAMP, self._trunc_us(us),
                            _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        us = c.values.astype(np.int64)
        if not isinstance(c.dtype, T.TimestampType):
            us = us * _DAY_US
        if not self._known():
            return CpuCol(T.TIMESTAMP, np.zeros(len(us), np.int64),
                          np.zeros(len(us), np.bool_))
        return CpuCol(T.TIMESTAMP, self._trunc_us(us).astype(np.int64),
                      c.valid)


class TruncDate(Expression):
    """trunc(date, fmt) for fmt in year/yyyy/yy/month/mon/mm/quarter/week;
    another fmt is tagged off the device (``supported_on_tpu``) and gives
    null rows."""

    _FMTS = {"year": "y", "yyyy": "y", "yy": "y", "month": "m", "mon": "m",
             "mm": "m", "quarter": "q", "week": "w"}

    def __init__(self, child, fmt: str):
        self.children = [child]
        self.fmt = fmt.lower()

    def _params(self):
        return self.fmt

    def data_type(self):
        return T.DATE

    def with_children(self, children):
        return TruncDate(children[0], self.fmt)

    def supported_on_tpu(self):
        return self.fmt in self._FMTS

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        days = _days(c)
        if not self.supported_on_tpu():
            return ColumnVector(T.DATE, torch.zeros_like(days).to(
                torch.int32), torch.zeros_like(days, dtype=torch.bool))
        out = _trunc_days(days, self._FMTS[self.fmt])
        return ColumnVector(T.DATE, out.to(torch.int32), _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        days = _days_np(c)
        if not self.supported_on_tpu():
            return CpuCol(T.DATE, np.zeros(len(days), np.int32),
                          np.zeros(len(days), np.bool_))
        out = _trunc_days(days, self._FMTS[self.fmt])
        return CpuCol(T.DATE, out.astype(np.int32), c.valid.copy())


# ---------------------------------------------------------------------------
# Timezone conversion: the zone's transition table (expr/tzdb.py) on the
# batch's device, applied with torch.searchsorted
# ---------------------------------------------------------------------------

class _TzShiftBase(Expression):
    """A per-row offset from a zone's transition table. The zone is a
    plan-time constant; an unknown zone is tagged off the device by the
    rule (``supported_on_tpu``)."""

    def __init__(self, child: Expression, zone: str):
        self.children = [child]
        self.zone = str(zone)

    def _params(self):
        return self.zone

    def with_children(self, children):
        return type(self)(children[0], self.zone)

    def data_type(self):
        return T.TIMESTAMP

    def supported_on_tpu(self):
        return tzdb.is_valid_zone(self.zone)

    #: +1 adds the offset (UTC -> local), -1 subtracts it
    sign = 1

    def _offsets(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        v = c.data.to(torch.int64).contiguous()
        return ColumnVector(T.TIMESTAMP, v + self.sign * self._offsets(v),
                            _valid_of(c, ctx))

    def _offsets_np(self, v: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        v = c.values.astype(np.int64)
        out = v + self.sign * self._offsets_np(v)
        return CpuCol(T.TIMESTAMP, np.where(c.valid, out, 0),
                      c.valid.copy())


def _lookup(keys: torch.Tensor, offsets: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """The offset in effect at each value: offsets[i] below keys[i], the
    last one above every key; a zone without transitions has one."""
    if keys.shape[0] == 0:
        return offsets[0].expand(v.shape[0])
    return offsets[torch.searchsorted(keys, v, right=True)]


class FromUtcTimestamp(_TzShiftBase):
    """from_utc_timestamp(ts, zone): shift a UTC instant so its UTC
    rendering equals the zone's wall clock."""

    def _offsets(self, v):
        return _lookup(*tzdb.device_table(self.zone, v.device), v)

    def _offsets_np(self, v):
        return tzdb.utc_offset_us(self.zone, v)


class ToUtcTimestamp(_TzShiftBase):
    """to_utc_timestamp(ts, zone): read the timestamp's UTC rendering as
    the zone's wall clock and return the instant. Times in a gap or an
    overlap take the earlier offset (fold=0, tzdb.local_boundaries), as
    java.time does."""

    sign = -1

    def _offsets(self, v):
        return _lookup(*tzdb.device_boundaries(self.zone, v.device), v)

    def _offsets_np(self, v):
        return tzdb.local_offset_us(self.zone, v)


# ---------------------------------------------------------------------------
# Datetime breadth second tier
# ---------------------------------------------------------------------------

def _make_date(y, m, d):
    """(days, ok) of make_date over int64 planes: the day count of the
    clamped year, and whether the components name a real date whose day
    count fits int32."""
    lo, hi = -6_000_000, 6_000_000  # an int32-day-safe window of years
    yc = _where(y < lo, lo, _where(y > hi, hi, y))
    days = _days_from_civil(yc, m, d)
    # the round trip catches a day past its month's end
    yy, mm, dd = _civil_from_days(days)
    ok = ((m >= 1) & (m <= 12) & (d >= 1) & (yy == yc) & (mm == m)
          & (dd == d) & (y == yc) & (days >= -(2 ** 31)) & (days < 2 ** 31))
    return days, ok


class MakeDate(Expression):
    """make_date(y, m, d): null (ANSI: an error) on invalid components."""

    def __init__(self, y, m, d):
        self.children = [y, m, d]

    def data_type(self):
        return T.DATE

    def with_children(self, children):
        return MakeDate(*children)

    def eval(self, ctx):
        cy, cm, cd = [c.eval(ctx) for c in self.children]
        days, ok = _make_date(*(c.data.to(torch.int64)
                                for c in (cy, cm, cd)))
        valid = _valid_of(cy, ctx) & _valid_of(cm, ctx) & _valid_of(cd, ctx)
        if ctx.ansi:
            ctx.add_error("InvalidDate", valid & ~ok)
        return ColumnVector(T.DATE, days.to(torch.int32), valid & ok)

    def eval_cpu(self, cols, ansi=False):
        cy, cm, cd = [c.eval_cpu(cols, ansi) for c in self.children]
        days, ok = _make_date(*(c.values.astype(np.int64)
                                for c in (cy, cm, cd)))
        valid = cy.valid & cm.valid & cd.valid
        if ansi and bool((valid & ~ok).any()):
            raise SparkException("invalid date components")
        return CpuCol(T.DATE, days.astype(np.int32), valid & ok)


class NextDay(Expression):
    """next_day(date, dayOfWeek): the first date AFTER ``date`` on the
    given weekday; null rows for a name Spark does not know (exact 2- or
    3-letter abbreviations or full names only: "FRIENDS" is not
    Friday)."""

    _DOW = {}
    for _i, _names in enumerate([("MO", "MON", "MONDAY"),
                                 ("TU", "TUE", "TUESDAY"),
                                 ("WE", "WED", "WEDNESDAY"),
                                 ("TH", "THU", "THURSDAY"),
                                 ("FR", "FRI", "FRIDAY"),
                                 ("SA", "SAT", "SATURDAY"),
                                 ("SU", "SUN", "SUNDAY")]):
        for _n in _names:
            _DOW[_n] = _i

    def __init__(self, child, day: str):
        self.children = [child]
        self.day = str(day)
        self._target = self._DOW.get(self.day.strip().upper())

    def _params(self):
        return self.day

    def with_children(self, children):
        return NextDay(children[0], self.day)

    def data_type(self):
        return T.DATE

    def _next(self, d):
        dow = _fmod(d + 3, 7)  # 1970-01-01 was a Thursday (MO=0)
        return d + _fmod(self._target - dow + 6, 7) + 1

    def eval(self, ctx):
        c = self.children[0].eval(ctx)
        if self._target is None:
            z = torch.zeros(ctx.capacity, dtype=torch.int32,
                            device=ctx.device)
            return ColumnVector(T.DATE, z, z != 0)
        out = self._next(c.data.to(torch.int64))
        return ColumnVector(T.DATE, out.to(torch.int32), _valid_of(c, ctx))

    def eval_cpu(self, cols, ansi=False):
        c = self.children[0].eval_cpu(cols, ansi)
        n = len(c.values)
        if self._target is None:
            return CpuCol(T.DATE, np.zeros(n, np.int32),
                          np.zeros(n, np.bool_))
        out = self._next(c.values.astype(np.int64))
        return CpuCol(T.DATE, out.astype(np.int32), c.valid)


class MonthsBetween(Expression):
    """months_between(end, start[, roundOff]): whole months plus a
    31-day-month fraction; two last days of their months count as whole.
    The float expression keeps the JAX package's order of operations."""

    def __init__(self, end, start, round_off: bool = True):
        self.children = [end, start]
        self.round_off = bool(round_off)

    def _params(self):
        return str(self.round_off)

    def with_children(self, children):
        return MonthsBetween(children[0], children[1], self.round_off)

    def data_type(self):
        return T.FLOAT64

    def _months(self, e_us, s_us, to_f64, rnd):
        def split(us):
            days = _fdiv(us, _DAY_US)
            y, m, d = _civil_from_days(days)
            return y, m, d, us - days * _DAY_US, days

        ey, em, ed, etod, edays = split(e_us)
        sy, sm, sd, stod, sdays = split(s_us)
        # the last day of a month: the next day is in another month
        e_last = _civil_from_days(edays + 1)[1] != em
        s_last = _civil_from_days(sdays + 1)[1] != sm
        months = (ey - sy) * 12 + (em - sm)
        whole = (e_last & s_last) | (ed == sd)
        esec = to_f64(ed) * 86400 + to_f64(etod) / 1e6
        ssec = to_f64(sd) * 86400 + to_f64(stod) / 1e6
        frac = _where(whole, 0.0, (esec - ssec) / (31.0 * 86400))
        out = to_f64(months) + frac
        if self.round_off:
            out = rnd(out * 1e8) / 1e8
        return out

    @staticmethod
    def _us(data, dtype, conv):
        v = conv(data)
        return v * _DAY_US if isinstance(dtype, T.DateType) else v

    def eval(self, ctx):
        e = self.children[0].eval(ctx)
        s = self.children[1].eval(ctx)

        def i64(x):
            return x.to(torch.int64)

        out = self._months(self._us(e.data, e.dtype, i64),
                           self._us(s.data, s.dtype, i64),
                           lambda x: x.to(torch.float64), torch.round)
        return ColumnVector(T.FLOAT64, out,
                            _valid_of(e, ctx) & _valid_of(s, ctx))

    def eval_cpu(self, cols, ansi=False):
        e = self.children[0].eval_cpu(cols, ansi)
        s = self.children[1].eval_cpu(cols, ansi)

        def i64(x):
            return x.astype(np.int64)

        out = self._months(self._us(e.values, e.dtype, i64),
                           self._us(s.values, s.dtype, i64),
                           lambda x: x.astype(np.float64), np.round)
        return CpuCol(T.FLOAT64, np.asarray(out, np.float64),
                      e.valid & s.valid)


class _TrivialConvert(_Unary):
    """A unit conversion that is one multiply or divide (a negative scale
    floor-divides)."""

    result = T.INT64
    raw = True
    scale = 1

    def _compute(self, v, dtype):
        if self.scale < 0:
            return _fdiv(v, -self.scale)
        return v * self.scale


class UnixDate(_TrivialConvert):
    """unix_date(date) -> days since the epoch (int32)."""
    result = T.INT32


class DateFromUnixDate(_TrivialConvert):
    result = T.DATE


class UnixMicros(_TrivialConvert):
    pass


class UnixMillis(_TrivialConvert):
    scale = -1000


class UnixSeconds(_TrivialConvert):
    scale = -1_000_000


class TimestampMillis(_TrivialConvert):
    result = T.TIMESTAMP
    scale = 1000


class TimestampMicros(_TrivialConvert):
    result = T.TIMESTAMP
