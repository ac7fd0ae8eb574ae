"""Timezone transition database for device-side timestamp localization.

Counterpart of ``spark_rapids_tpu/expr/tzdb.py`` (reference parity:
sql-plugin TimeZoneDB.scala + the JNI GpuTimeZoneDB, which load IANA rules
into a device table so non-UTC sessions keep datetime expressions on the
GPU):

- HOST, once per zone: parse the binary TZif file (RFC 8536) from the
  system zoneinfo directories into (transition instants, UTC offsets)
  arrays, in numpy. Zones have a few hundred transitions; the table is
  bytes, not megabytes.
- DEVICE, per batch: ``torch.searchsorted`` of the timestamp plane against
  the transition instants + one gather for the offset. The tables are
  uploaded once per (zone, device) and kept (``device_table``,
  ``device_boundaries``), so a query does not upload them again.
- Past the file's last transition, the TZif v2+ footer's POSIX TZ rule
  (``EST5EDT,M3.2.0,M11.1.0``) extends the table through the year
  ``HORIZON_YEAR`` (``_footer_transitions``), so an instant after 2037,
  or after 2007 in a slim file, takes the offset ``zoneinfo`` and Spark
  give. The JAX package's device keeps the last recorded offset there.

Local->UTC (``to_utc_timestamp``) resolves through a LOCAL-wall-time
boundary table (local_boundaries): DST gaps take the pre-gap offset and
overlaps the earlier offset, java.time's fold=0 resolution.

``source(zone)`` names the file that serves a zone: an unknown zone, or a
machine without a zone database, raises ``UnknownTimeZone``.
"""
from __future__ import annotations

import os
import struct
import threading
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

#: microseconds per second (Spark timestamps are int64 micros)
_US = 1_000_000

#: the rule of a TZif footer is unrolled through this year
HORIZON_YEAR = 9999

_TZPATHS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo",
            "/usr/share/lib/zoneinfo", "/etc/zoneinfo")


class UnknownTimeZone(ValueError):
    pass


def source(zone: str) -> str:
    """The path of the TZif file that serves ``zone``: the first search
    directory holding it."""
    if not zone or zone in (".", "..") or "//" in zone or "\0" in zone:
        raise UnknownTimeZone(zone)
    for base in _TZPATHS:
        p = os.path.join(base, *zone.split("/"))
        if os.path.isfile(p) and os.path.realpath(p).startswith(
                os.path.realpath(base)):
            return p
    raise UnknownTimeZone(zone)


def _read_tzif(zone: str) -> bytes:
    with open(source(zone), "rb") as f:
        return f.read()


def _parse_block(data: bytes, pos: int, time_size: int):
    """One TZif data block; returns (transitions, offsets_sec, base,
    next_pos)."""
    hdr = struct.unpack(">4s c 15x 6I", data[pos: pos + 44])
    magic, _ver, isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt = hdr
    if magic != b"TZif":
        raise ValueError("not a TZif file")
    pos += 44
    tfmt = ">%d%s" % (timecnt, "q" if time_size == 8 else "l")
    trans = struct.unpack_from(tfmt, data, pos)
    pos += timecnt * time_size
    idx = struct.unpack_from(">%dB" % timecnt, data, pos)
    pos += timecnt
    types = []
    for _ in range(typecnt):
        utoff, _isdst, _abbrind = struct.unpack_from(">lBB", data, pos)
        types.append(utoff)
        pos += 6
    pos += charcnt
    pos += leapcnt * (time_size + 4)
    pos += isstdcnt + isutcnt
    offsets = [types[i] for i in idx]
    #: offset BEFORE the first transition: type 0 (RFC 8536 §3.2)
    base = types[0] if types else 0
    return np.asarray(trans, np.int64), np.asarray(offsets, np.int64), \
        np.int64(base), pos


# ---------------------------------------------------------------------------
# The footer's POSIX TZ rule (RFC 8536 section 3.3, POSIX.1 TZ)
# ---------------------------------------------------------------------------

def _posix_hms(text: str, i: int):
    """``[+-]hh[:mm[:ss]]`` at text[i]: (seconds, next index). Hours may
    run to 167 (RFC 8536's extension)."""
    sign = 1
    if i < len(text) and text[i] in "+-":
        sign = -1 if text[i] == "-" else 1
        i += 1
    parts = []
    while True:
        j = i
        while j < len(text) and text[j].isdigit():
            j += 1
        if j == i:
            raise ValueError(f"bad time in TZ string {text!r}")
        parts.append(int(text[i:j]))
        i = j
        if len(parts) < 3 and i < len(text) and text[i] == ":":
            i += 1
            continue
        break
    h, m, sec = (parts + [0, 0])[:3]
    return sign * (h * 3600 + m * 60 + sec), i


def _posix_name(text: str, i: int) -> int:
    if text[i] == "<":
        return text.index(">", i) + 1
    j = i
    while j < len(text) and text[j].isalpha():
        j += 1
    if j - i < 3:
        raise ValueError(f"bad zone name in TZ string {text!r}")
    return j


def _posix_date(text: str, i: int):
    """A rule date (``Jn``, ``n`` or ``Mm.w.d``) and its optional
    ``/time``: ((kind, a, b, c), seconds, next index)."""
    if text[i] == "M":
        j = i + 1
        nums = []
        for _ in range(3):
            k = j
            while k < len(text) and text[k].isdigit():
                k += 1
            nums.append(int(text[j:k]))
            j = k + 1 if k < len(text) and text[k] == "." else k
        rule, i = ("M", *nums), j
    else:
        kind = "J" if text[i] == "J" else "n"
        if kind == "J":
            i += 1
        j = i
        while j < len(text) and text[j].isdigit():
            j += 1
        rule, i = (kind, int(text[i:j]), 0, 0), j
    at = 7200
    if i < len(text) and text[i] == "/":
        at, i = _posix_hms(text, i + 1)
    return rule, at, i


def parse_posix_tz(text: str):
    """(std UTC offset s, dst UTC offset s, start, end) of a POSIX TZ
    string, where start and end are (rule, seconds); the last three are
    None for a zone without DST. UTC offsets are local minus UTC (POSIX
    writes the opposite sign)."""
    i = _posix_name(text, 0)
    std, i = _posix_hms(text, i)
    std = -std
    if i >= len(text):
        return std, None, None, None
    i = _posix_name(text, i)
    dst = std + 3600
    if i < len(text) and text[i] not in ",;":
        dst, i = _posix_hms(text, i)
        dst = -dst
    if i >= len(text):
        # no rule: POSIX leaves it to the implementation, and the TZif
        # files always give one
        return std, None, None, None
    start, start_at, i = _posix_date(text, i + 1)
    end, end_at, i = _posix_date(text, i + 1)
    return std, dst, (start, start_at), (end, end_at)


def _rule_day(rule, year: int) -> int:
    """Days since the epoch of a rule's date in ``year``."""
    import datetime
    kind, a, b, c = rule
    jan1 = datetime.date(year, 1, 1)
    leap = year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
    if kind == "J":  # 1..365, February 29 never counted
        d = jan1 + datetime.timedelta(days=a - 1 + (leap and a >= 60))
    elif kind == "n":  # 0..365, February 29 counted
        d = jan1 + datetime.timedelta(days=a)
    else:  # Mm.w.d: day c (0 = Sunday) of week b (5 = the last) of month a
        first = datetime.date(year, a, 1)
        nxt = datetime.date(year + (a == 12), a % 12 + 1, 1)
        mdays = (nxt - first).days
        day = 1 + (c - (first.weekday() + 1) % 7) % 7 + (b - 1) * 7
        while day > mdays:
            day -= 7
        d = first.replace(day=day)
    return (d - datetime.date(1970, 1, 1)).days


def _footer_transitions(tz: str, after_s: int, from_year: int):
    """(transitions s, offsets s) of the footer rule ``tz`` from
    ``from_year`` through HORIZON_YEAR, the instants after ``after_s``
    only; the offset i applies from transition i on."""
    std, dst, start, end = parse_posix_tz(tz)
    if dst is None:
        return [], []
    out = []
    for y in range(from_year, HORIZON_YEAR + 1):
        # a DST start is read on the standard clock, an end on the DST one
        on = _rule_day(start[0], y) * 86400 + start[1] - std
        off = _rule_day(end[0], y) * 86400 + end[1] - dst
        out.extend(sorted([(on, 1, dst), (off, 0, std)]))
    out = [t for t in out if t[0] > after_s]
    return [t[0] for t in out], [t[2] for t in out]


def _footer(data: bytes, pos: int) -> str:
    """The v2+ footer's TZ string (between two newlines after the
    64-bit block), or ""."""
    if data[pos: pos + 1] != b"\n":
        return ""
    end = data.find(b"\n", pos + 1)
    return data[pos + 1: end].decode("ascii") if end > 0 else ""


def _read_zone(zone: str):
    """(transitions s, offsets s, base offset s, footer TZ string) of a
    zone's TZif file."""
    data = _read_tzif(zone)
    trans, offs, base, pos = _parse_block(data, 0, 4)
    tz = ""
    if data[4:5] in (b"2", b"3", b"4"):
        # v2+: a second block with 64-bit times supersedes the v1 data
        trans, offs, base, pos = _parse_block(data, pos, 8)
        tz = _footer(data, pos)
    return trans, offs, base, tz


@lru_cache(maxsize=256)
def zone_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_us int64[n], offsets_us int64[n+1]) for a zone.
    offsets_us[i] applies to instants < transitions_us[i] (offsets_us[0]
    before all transitions); offsets_us[n] after the last. The footer's
    rule extends the file's transitions through HORIZON_YEAR. A zone
    without transitions gives an empty table and its one fixed offset."""
    import datetime
    trans, offs, base, tz = _read_zone(zone)
    if tz:
        if len(trans):
            last = int(trans[-1])
            year = (datetime.datetime(1970, 1, 1)
                    + datetime.timedelta(seconds=last)).year
        else:
            last, year = -(2 ** 62), 1
        more_t, more_o = _footer_transitions(tz, last, year)
        if more_t:
            trans = np.concatenate([trans, np.asarray(more_t, np.int64)])
            offs = np.concatenate([offs, np.asarray(more_o, np.int64)])
    if len(trans) == 0:
        fixed = np.asarray([base * _US], np.int64)
        return np.zeros(0, np.int64), fixed
    offsets = np.concatenate([[base], offs]) * _US
    return trans * _US, offsets


def table_span(zone: str) -> Tuple[int, int, int]:
    """(the year of the TZif file's last transition, the year of the
    extended table's last one, the table's entries): what the footer rule
    added."""
    import datetime

    def year(s):
        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(seconds=int(s))).year
    trans = _read_zone(zone)[0]
    table = zone_table(zone)[0]
    return (year(trans[-1]) if len(trans) else 0,
            year(table[-1] // _US) if len(table) else 0, len(table))


def utc_offset_us(zone: str, ts_us: np.ndarray) -> np.ndarray:
    """Host-side: UTC offset (us) in effect at each UTC instant."""
    trans, offsets = zone_table(zone)
    if len(trans) == 0:
        return np.full(ts_us.shape, offsets[0], np.int64)
    idx = np.searchsorted(trans, ts_us, side="right")
    return offsets[idx]


def from_utc_us(zone: str, ts_us: np.ndarray) -> np.ndarray:
    return ts_us + utc_offset_us(zone, ts_us)


@lru_cache(maxsize=256)
def local_boundaries(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(boundaries_us int64[n], offsets_us int64[n+1]) in LOCAL wall time
    with java.time fold=0 resolution: the pre-transition offset applies
    to every local instant below boundary[i] = trans[i] +
    max(offset_before, offset_after), which resolves DST gaps to the
    pre-gap offset and overlaps to the earlier offset."""
    trans, offsets = zone_table(zone)
    if len(trans) == 0:
        return trans, offsets
    b = trans + np.maximum(offsets[:-1], offsets[1:])
    # pathological zones (day-skip offset jumps) could locally unsort the
    # boundaries; enforce monotonicity so searchsorted stays valid
    b = np.maximum.accumulate(b)
    return b, offsets


def local_offset_us(zone: str, local_us: np.ndarray) -> np.ndarray:
    """Host-side: UTC offset for LOCAL wall-clock instants (fold=0)."""
    b, offsets = local_boundaries(zone)
    if len(b) == 0:
        return np.full(local_us.shape, offsets[0], np.int64)
    idx = np.searchsorted(b, local_us, side="right")
    return offsets[idx]


def to_utc_us(zone: str, local_us: np.ndarray) -> np.ndarray:
    """local->UTC with fold=0 (earlier-offset) resolution."""
    return local_us - local_offset_us(zone, local_us)


def is_valid_zone(zone: str) -> bool:
    try:
        zone_table(zone)
        return True
    except (UnknownTimeZone, ValueError, OSError):
        return False


# ---------------------------------------------------------------------------
# Device copies of the tables
# ---------------------------------------------------------------------------

_DEVICE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_DEVICE_LOCK = threading.Lock()


def _on_device(kind: str, zone: str, device, table):
    key = (kind, zone, str(torch.device(device)))
    with _DEVICE_LOCK:
        got = _DEVICE_TABLES.get(key)
        if got is None:
            keys, offsets = table(zone)
            got = (torch.from_numpy(np.ascontiguousarray(keys, np.int64))
                   .to(device),
                   torch.from_numpy(np.ascontiguousarray(offsets, np.int64))
                   .to(device))
            _DEVICE_TABLES[key] = got
        return got


def device_table(zone: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``zone_table`` as int64 tensors on ``device``, uploaded once."""
    return _on_device("utc", zone, device, zone_table)


def device_boundaries(zone: str, device) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``local_boundaries`` as int64 tensors on ``device``, uploaded
    once."""
    return _on_device("local", zone, device, local_boundaries)
