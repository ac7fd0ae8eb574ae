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
  ``device_boundaries``), so a query does not upload them again. Future
  transitions beyond the TZif data use the last recorded offset, as in the
  JAX package.

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


@lru_cache(maxsize=256)
def zone_table(zone: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions_us int64[n], offsets_us int64[n+1]) for a zone.
    offsets_us[i] applies to instants < transitions_us[i] (offsets_us[0]
    before all transitions); offsets_us[n] after the last. A zone without
    transitions gives an empty table and its one fixed offset."""
    data = _read_tzif(zone)
    trans, offs, base, pos = _parse_block(data, 0, 4)
    if data[4:5] in (b"2", b"3"):
        # v2+: a second block with 64-bit times supersedes the v1 data
        trans, offs, base, _ = _parse_block(data, pos, 8)
    if len(trans) == 0:
        fixed = np.asarray([base * _US], np.int64)
        return np.zeros(0, np.int64), fixed
    offsets = np.concatenate([[base], offs]) * _US
    return trans * _US, offsets


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
