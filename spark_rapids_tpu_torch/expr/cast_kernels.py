"""Device string casts: string <-> integer, double, date and timestamp.

Counterpart of ``spark_rapids_tpu/expr/cast_kernels.py`` and of the
integer arms of ``spark_rapids_tpu/expr/strings.py`` (reference parity:
jni CastStrings + GpuCast.scala string conversions). The JAX package walks
the bytes in ``lax.while_loop`` until every row is done; here the walk is
a Python loop over the batch's longest string, each step whole-plane
torch ops over the rows, so a batch costs one host read (the longest
length, ``_Walker.max_len``) and no transfer per byte position. Running past a
row's end changes nothing in it, so the results are the JAX package's.
Renderings write their bytes one output column at a time into a flat
plane (a slot past its end takes the null rows' writes), not through an
n x width matrix.

The JAX package's documented divergences hold here too:
- string -> double parses an int64 mantissa (18 digits) and scales it by
  a power of ten: results can differ from correctly rounded strtod by
  ~1-2 ulp;
- date and timestamp rendering covers years 0..9999 (fixed-width
  digits); other years render as null;
- timestamps parse as ``yyyy-MM-dd[ |T]HH:mm:ss[.ffffff]`` (no zone
  suffix).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector, round_capacity
from spark_rapids_tpu_torch.expr.datetime import (
    _DAY_US, _civil_from_days, _days_from_civil, _month_len,
)


class _Walker:
    """A flat string column's rows as [start, end) byte ranges, and a
    clamped byte read."""

    def __init__(self, col: ColumnVector):
        o = col.data["offsets"].to(torch.int64)
        self.raw = col.data["bytes"]
        self.starts = o[:-1]
        self.ends = o[1:]
        self.nb = self.raw.shape[0]

    def at(self, pos: torch.Tensor) -> torch.Tensor:
        if self.nb == 0:
            return torch.zeros_like(pos)
        return self.raw[pos.clamp(0, self.nb - 1)].to(torch.int64)

    def max_len(self) -> int:
        """The longest row in bytes: the walk's one host read."""
        if self.starts.shape[0] == 0:
            return 0
        return int((self.ends - self.starts).max().item())


def _trim(w: _Walker, limit: int, space_only: bool = False):
    """Strip bytes <= 0x20 at both ends (Java UTF8String.trim, what
    Spark's string casts use), or only spaces."""
    s, e = w.starts, w.ends

    def blank(b):
        return b == 32 if space_only else b <= 32
    for _ in range(limit):
        # both ends step from the same state, as the JAX package's loop
        lead = (s < e) & blank(w.at(s))
        tail = (e > s) & blank(w.at(e - 1))
        s, e = s + lead, e - tail.to(torch.int64)
    return s, e


def _match_lit(w: _Walker, s, e, text: bytes):
    """Rows whose [s, e) slice equals ``text`` exactly."""
    ok = (e - s) == len(text)
    for j, ch in enumerate(text):
        ok = ok & (w.at(s + j) == ch)
    return ok


def _is_digit(b):
    return (b >= 48) & (b <= 57)


def parse_f64(col: ColumnVector) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f64, parsed) of a flat string column: optional sign, digits,
    '.', digits, [eE][+-]digits; 'Infinity' and 'NaN' (Java's spelling);
    blanks trimmed."""
    w = _Walker(col)
    limit = w.max_len()
    s, e = _trim(w, limit)
    n = s.shape[0]
    dev = s.device
    first = w.at(s)
    has_sign = (first == 45) | (first == 43)
    neg = first == 45
    ds = s + has_sign
    inf = _match_lit(w, ds, e, b"Infinity")
    nan = _match_lit(w, ds, e, b"NaN")

    def zeros(dtype=torch.int64):
        return torch.zeros(n, dtype=dtype, device=dev)

    acc, scale, ndig = zeros(), zeros(), zeros()
    exp, ednig, phase = zeros(), zeros(), zeros()
    esign = torch.ones(n, dtype=torch.int64, device=dev)
    good = (e > ds) & ~inf & ~nan
    done = inf | nan | (s >= e)
    # phases: 0 = integer digits, 1 = fraction digits, 2 = exponent
    for i in range(limit + 1):
        pos = ds + i
        active = (pos < e) & ~done
        b = w.at(pos)
        prev = w.at(pos - 1)
        digit = _is_digit(b)
        dv = b - 48
        # a mantissa digit: up to 18 accumulate; integer digits past 18
        # inflate the scale, fraction digits past 18 drop
        mant = active & digit & (phase < 2)
        room = ndig < 18
        acc = torch.where(mant & room, acc * 10 + dv, acc)
        scale = scale + (mant & room & (phase == 1)).to(torch.int64) \
            - (mant & ~room & (phase == 0)).to(torch.int64)
        ndig = ndig + mant
        ed = active & digit & (phase == 2)
        exp = torch.where(ed, (exp * 10 + dv).clamp(max=9999), exp)
        ednig = ednig + ed
        # '.' -> fraction (once, from phase 0 only)
        dot = active & (b == 46) & (phase == 0)
        bad_dot = active & (b == 46) & (phase != 0)
        phase = torch.where(dot, 1, phase)
        # e/E -> exponent (needs a mantissa digit first)
        is_e = (b == 101) | (b == 69)
        ee = active & is_e & (phase < 2) & (ndig > 0)
        bad_ee = active & is_e & ~ee
        phase = torch.where(ee, 2, phase)
        # an exponent sign: only right after e/E
        exp_sign = active & ((b == 45) | (b == 43)) & (phase == 2) \
            & ((prev == 101) | (prev == 69)) & (ednig == 0)
        esign = torch.where(exp_sign & (b == 45), -1, esign)
        recognized = mant | ed | dot | ee | exp_sign
        good = good & (~active | recognized) & ~bad_dot & ~bad_ee
        done = done | (pos >= e)
    good = good & (ndig > 0) & ((phase < 2) | (ednig > 0))
    p = (exp * esign - scale).to(torch.float64).clamp(-400.0, 400.0)
    v = acc.to(torch.float64) * torch.pow(10.0, p)
    v = torch.where(neg, -v, v)
    v = torch.where(inf, torch.where(neg, -torch.inf, torch.inf), v)
    v = torch.where(nan, torch.nan, v)
    return v, (good | inf | nan) & (s < e)


def _parse_ymd_hms(col: ColumnVector, with_time: bool):
    """The date and timestamp parser: (days, microseconds of the day,
    parsed)."""
    w = _Walker(col)
    limit = w.max_len()
    s, e = _trim(w, limit)
    n = s.shape[0]
    dev = s.device
    # phases: 0 y, 1 m, 2 d, 3 H, 4 M, 5 S, 6 fraction
    n_ph = 7 if with_time else 3
    accs: List[torch.Tensor] = [torch.zeros(n, dtype=torch.int64, device=dev)
                                for _ in range(n_ph)]
    digs: List[torch.Tensor] = [torch.zeros(n, dtype=torch.int64, device=dev)
                                for _ in range(n_ph)]
    phase = torch.zeros(n, dtype=torch.int64, device=dev)
    good = s < e
    done = s >= e
    for i in range(limit + 1):
        pos = s + i
        active = (pos < e) & ~done
        b = w.at(pos)
        digit = _is_digit(b)
        take = active & digit
        for k in range(n_ph):
            hit = take & (phase == k)
            accs[k] = torch.where(hit, accs[k] * 10 + (b - 48), accs[k])
            digs[k] = digs[k] + hit
        sep = active & (b == 45) & (phase < 2)
        if with_time:
            sep = sep | (active & ((b == 32) | (b == 84)) & (phase == 2)) \
                | (active & (b == 58) & ((phase == 3) | (phase == 4))) \
                | (active & (b == 46) & (phase == 5))
        phase = phase + sep
        good = good & (~active | digit | sep)
        done = done | (pos >= e)
    y = accs[0]
    m = torch.where(digs[1] > 0, accs[1], 1)
    d = torch.where(digs[2] > 0, accs[2], 1)
    # years 1..9999, as the host oracle (datetime) has them
    good = good & (digs[0] >= 1) & (digs[0] <= 7) & (y >= 1) & (y <= 9999)
    good = good & ((digs[1] == 0) | (digs[1] <= 2))
    good = good & ((digs[2] == 0) | (digs[2] <= 2))
    good = good & (m >= 1) & (m <= 12) & (d >= 1)
    good = good & (d <= _month_len(y, m.clamp(1, 12)))
    # started-but-empty segments ("2020-", "2020-01-") are invalid
    good = good & ~((phase >= 1) & (phase <= 2) & (digs[1] == 0))
    good = good & ~((phase == 2) & (digs[2] == 0))
    days = _days_from_civil(y, m, d)
    if not with_time:
        return days, torch.zeros_like(days), good & (phase <= 2)
    hh, mi, ss = accs[3], accs[4], accs[5]
    good = good & ((phase <= 2) | (phase >= 5))  # a time needs H:M:S
    has_time = phase >= 3
    good = good & (~has_time | ((digs[3] >= 1) & (digs[3] <= 2)
                                & (digs[4] >= 1) & (digs[4] <= 2)
                                & (digs[5] >= 1) & (digs[5] <= 2)
                                & (hh < 24) & (mi < 60) & (ss < 60)))
    frac, fd = accs[6], digs[6]
    good = good & ((phase < 6) | (fd >= 1))
    ten = torch.full_like(fd, 10)
    us = torch.where(fd > 0, frac * torch.pow(ten, (6 - fd).clamp(0, 6)), 0)
    us = torch.where(fd > 6, torch.div(frac, torch.pow(
        ten, (fd - 6).clamp(0, 12)), rounding_mode="floor"), us)
    usod = hh * 3_600_000_000 + mi * 60_000_000 + ss * 1_000_000 + us
    return days, torch.where(has_time, usod, 0), good


def parse_date(col: ColumnVector):
    days, _, ok = _parse_ymd_hms(col, with_time=False)
    return days.to(torch.int32), ok


def parse_timestamp(col: ColumnVector):
    days, usod, ok = _parse_ymd_hms(col, with_time=True)
    return days * _DAY_US + usod, ok


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _offsets(lens: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=lens.device),
                      lens.cumsum(0)])


class _FlatWriter:
    """Rows of at most ``width`` bytes written into one flat plane of
    round_capacity(n * width) bytes: column j of row r lands at
    offsets[r] + j when j < lens[r], else in a dump slot past the end."""

    def __init__(self, lens: torch.Tensor, width: int):
        self.lens = lens
        self.off = _offsets(lens)
        self.cap = round_capacity(max(lens.shape[0] * width, 8))
        self.flat = torch.zeros(self.cap + 1, dtype=torch.uint8,
                                device=lens.device)

    def put(self, j, chars: torch.Tensor) -> None:
        """Column j: ``j`` a host int or a per-row position tensor."""
        dest = torch.where(j < self.lens, self.off[:-1] + j, self.cap)
        self.flat[dest] = chars.to(torch.uint8)

    def column(self, valid: torch.Tensor) -> ColumnVector:
        return ColumnVector(T.STRING, {
            "offsets": self.off.to(torch.int32),
            "bytes": self.flat[:self.cap]}, valid)


def _digit(val: torch.Tensor, place: int) -> torch.Tensor:
    """The ASCII digit of val (>= 0) at 10**place."""
    return torch.remainder(torch.div(val, 10 ** place, rounding_mode="floor"),
                           10) + 48


def _put_number(wr: _FlatWriter, at: int, val, width: int) -> int:
    for i in range(width):
        wr.put(at + i, _digit(val, width - 1 - i))
    return at + width


def _put_char(wr: _FlatWriter, at: int, ch: str) -> int:
    wr.put(at, torch.full_like(wr.lens, ord(ch)))
    return at + 1


def render_date(days: torch.Tensor, valid: torch.Tensor) -> ColumnVector:
    """int32 days -> flat 'yyyy-MM-dd' strings; years outside 0..9999
    render null."""
    y, m, d = _civil_from_days(days.to(torch.int64))
    ok = valid & (y >= 0) & (y <= 9999)
    wr = _FlatWriter(torch.where(ok, 10, 0), 10)
    at = _put_number(wr, 0, y, 4)
    at = _put_char(wr, at, "-")
    at = _put_number(wr, at, m, 2)
    at = _put_char(wr, at, "-")
    _put_number(wr, at, d, 2)
    return wr.column(ok)


def render_timestamp(us: torch.Tensor, valid: torch.Tensor) -> ColumnVector:
    """int64 micros -> 'yyyy-MM-dd HH:mm:ss[.ffffff]' (trailing zeros of
    the fraction trimmed; whole seconds render without a fraction)."""
    days = torch.div(us, _DAY_US, rounding_mode="floor")
    usod = us - days * _DAY_US
    y, m, d = _civil_from_days(days)
    ok = valid & (y >= 0) & (y <= 9999)
    frac = torch.remainder(usod, 1_000_000)
    # the fraction's length: the smallest k with frac divisible by
    # 10^(6-k), 0 when there is no fraction
    flen = torch.where(frac == 0, 0, 6)
    for k in range(5, 0, -1):
        flen = torch.where((frac != 0)
                           & (torch.remainder(frac, 10 ** (6 - k)) == 0),
                           k, flen)
    lens = torch.where(ok, torch.where(flen > 0, 20 + flen, 19), 0)
    wr = _FlatWriter(lens, 26)
    at = _put_number(wr, 0, y, 4)
    at = _put_char(wr, at, "-")
    at = _put_number(wr, at, m, 2)
    at = _put_char(wr, at, "-")
    at = _put_number(wr, at, d, 2)
    at = _put_char(wr, at, " ")
    at = _put_number(wr, at, torch.div(usod, 3_600_000_000,
                                       rounding_mode="floor"), 2)
    at = _put_char(wr, at, ":")
    at = _put_number(wr, at, torch.remainder(
        torch.div(usod, 60_000_000, rounding_mode="floor"), 60), 2)
    at = _put_char(wr, at, ":")
    at = _put_number(wr, at, torch.remainder(
        torch.div(usod, 1_000_000, rounding_mode="floor"), 60), 2)
    at = _put_char(wr, at, ".")
    _put_number(wr, at, frac, 6)
    return wr.column(ok)


def render_int64(values: torch.Tensor, valid: torch.Tensor) -> ColumnVector:
    """int64 -> decimal strings. Digits come from the value's non-positive
    image (every int64 has one, INT64_MIN included), right to left: at
    most 19 digits and a sign."""
    q = torch.where(values > 0, -values, values)
    neg = values < 0
    ndig = torch.ones_like(q)
    p = 10
    for _ in range(1, 19):
        ndig = ndig + (q <= -p)
        p *= 10
    lens = torch.where(valid, ndig + neg, 0)
    wr = _FlatWriter(lens, 20)
    wr.put(torch.where(neg, 0, 20), torch.full_like(q, 45))
    for k in range(19):
        digit = 48 - torch.fmod(q, 10)
        wr.put(torch.where((k < ndig) & valid, lens - 1 - k, 20), digit)
        q = torch.div(q, 10, rounding_mode="trunc")
    return wr.column(valid)


def parse_int64(col: ColumnVector) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values int64, parsed) of a flat string column: an optional sign
    and digits, spaces (only) trimmed at both ends; anything else does not
    parse (non-ANSI Spark: null). The value wraps in int64, as in the JAX
    package."""
    w = _Walker(col)
    limit = w.max_len()
    s, e = _trim(w, limit, space_only=True)
    first = w.at(s)
    has_sign = (first == 45) | (first == 43)
    neg = first == 45
    ds = s + has_sign
    acc = torch.zeros_like(s)
    good = e > ds
    for i in range(limit):
        pos = ds + i
        active = pos < e
        b = w.at(pos)
        digit = _is_digit(b)
        acc = torch.where(active & digit, acc * 10 + (b - 48), acc)
        good = good & (~active | digit)
    return torch.where(neg, -acc, acc), good
