"""Equi-join pairs on torch tensors.

Counterpart of ``spark_rapids_tpu/ops/join.py``. Two probe strategies:

- dense: a single integer key whose build values span at most
  DENSE_KEY_RANGE_LIMIT builds a direct-address table (a counting sort of
  the build rows by key), so a probe is two gathers. When no key repeats
  on the build side (``max_dup <= 1``) each probe row has at most one
  match and the caller can emit the probe planes as they are
  (``dense_lookup``); otherwise the [start, end) ranges expand into pairs.
- general: the build rows sort by a 64-bit mix of the normalized keys;
  one stable sort of the union of build and probe hashes ranks each probe
  row into the build's run of equal hashes; the runs expand into
  candidate pairs, and exact equality of the normalized planes keeps the
  true ones.

Pairs come out probe-major, as in the JAX package. Null keys never
match. Keys are the JAX package's unsigned 64-bit values held as int64:
ordered comparisons use them with the sign bit flipped, and the mix uses
logical shifts spelled with masks (torch has no uint64 shifts on the CPU).
The host reads one scalar per probe where the match count sizes the
output, and four scalars once per dense build.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnVector, rows_tensor
from spark_rapids_tpu_torch.ops import kernels as K

_MIN64 = -(1 << 63)
_MAX64 = (1 << 63) - 1
#: splitmix64's multipliers as signed int64 bit patterns
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)

#: direct-address table budget (entries): dense integer keys (TPC-H order
#: keys, dimension ids) take the two-gather path below it
DENSE_KEY_RANGE_LIMIT = 1 << 26


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 plane."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _jax_key_bits(col: ColumnVector, key: torch.Tensor,
                  nulls: torch.Tensor) -> torch.Tensor:
    """The JAX package's u64 normalized key, as an int64 bit pattern, from
    the port's ``normalize_key`` plane: that plane is the JAX key with the
    sign bit flipped, except for booleans (the same 0/1) and float32 (the
    JAX key less 2^31). Null and dead rows keep key 0."""
    if col.is_dict or isinstance(col.dtype, T.StringType) \
            or not isinstance(col.dtype, (T.BooleanType, T.Float32Type)):
        bits = key ^ _MIN64
    elif isinstance(col.dtype, T.Float32Type):
        bits = key + (1 << 31)
    else:
        bits = key
    return torch.where(nulls, 0, bits)


def _combine_keys(cols: List[ColumnVector], num_rows, live=None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """(combined 64-bit hash, per-column normalized planes, any null): the
    hash is the JAX package's splitmix64 finalizer chain over its u64
    keys, bit for bit, as an int64 bit pattern."""
    planes = []
    any_null = None
    for c in cols:
        k, nulls = K.normalize_key(c, num_rows, live=live)
        planes.append(_jax_key_bits(c, k, nulls))
        any_null = nulls if any_null is None else (any_null | nulls)
    h = torch.zeros_like(planes[0])
    for k in planes:
        x = h ^ k
        x = (x ^ _shr(x, 30)) * _MIX1
        x = (x ^ _shr(x, 27)) * _MIX2
        h = x ^ _shr(x, 31)
    return h, planes, any_null


def _run_starts(bound: torch.Tensor) -> torch.Tensor:
    """Per position of a sorted plane, the position of the first element
    of its run of equal values (``bound`` flags those firsts): what
    ``cummax`` of the flagged positions gives, from a cumsum and a
    scatter, since ``torch.cummax`` on the card takes ~25 ms per 2^23
    int64 elements on an H100 (its scan with indices; PERF.md)."""
    n = bound.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=bound.device)
    run = torch.cumsum(bound.to(torch.int64), 0) - 1
    first = torch.zeros(n + 1, dtype=torch.int64, device=bound.device)
    first.scatter_(0, torch.where(bound, run, n), pos)
    return first[run]


def _ordered(h: torch.Tensor) -> torch.Tensor:
    """A u64 bit pattern as an int64 whose signed order is the unsigned
    order."""
    return h ^ _MIN64


# ---------------------------------------------------------------------------
# The dense direct-address table
# ---------------------------------------------------------------------------

_DENSE_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type,
                T.DateType, T.BooleanType)


def _dense_int_eligible(build_keys: List[ColumnVector],
                        probe_key_types) -> bool:
    return (len(build_keys) == 1 and len(probe_key_types) == 1
            and isinstance(build_keys[0].dtype, _DENSE_TYPES)
            and isinstance(probe_key_types[0], _DENSE_TYPES))


class DenseBuildTable:
    """Direct-address layout of a build side with one bounded integer key:
    ``starts[span + 1]`` and ``sorted_orig[bcap]`` (build rows in key
    order), with the host facts bmin, span and max_dup. When no key
    repeats, ``slot_idx[span]`` holds the build row of each key (-1 for
    none), so a probe is one gather."""

    __slots__ = ("starts", "sorted_orig", "bmin", "span", "max_dup",
                 "bcap", "build_rows", "slot_idx")

    def __init__(self, starts, sorted_orig, bmin: int, span: int,
                 max_dup: int, bcap: int, build_rows):
        self.starts = starts
        self.sorted_orig = sorted_orig
        self.bmin = bmin
        self.span = span
        self.max_dup = max_dup
        self.bcap = bcap
        self.build_rows = build_rows
        self.slot_idx = None
        if max_dup <= 1:
            occ = starts[1:] > starts[:-1]
            cand = sorted_orig[starts[:-1].clamp(0, bcap - 1).to(torch.int64)]
            self.slot_idx = torch.where(occ, cand, -1)


def prepare_dense_build(build_keys: List[ColumnVector], build_rows,
                        probe_key_types) -> Optional[DenseBuildTable]:
    """The direct-address table when the dense path applies, else None.
    ``probe_key_types``: the probe keys' DataTypes. One host read of four
    scalars: the key range, the row count and the deepest key (from the
    stable key sort the table needs anyway)."""
    if not _dense_int_eligible(build_keys, probe_key_types):
        return None
    col = build_keys[0]
    bcap = col.capacity
    device = col.device
    bv = col.data.to(torch.int64)
    pos = torch.arange(bcap, device=device)
    b_in = (pos < rows_tensor(build_rows)) & col.validity_or_default(
        build_rows)
    bmin_d = torch.where(b_in, bv, 2 ** 62).min()
    bmax_d = torch.where(b_in, bv, -2 ** 62).max()
    nbuild_d = b_in.sum(dtype=torch.int64)
    # stable counting order: build rows by (key, original index)
    skey = torch.where(b_in, bv - bmin_d, 1 << 62)
    sk, order = torch.sort(skey, stable=True)
    bound = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                       sk[1:] != sk[:-1]])
    max_dup_d = torch.where(pos < nbuild_d, pos - _run_starts(bound) + 1,
                            0).max()
    bmin, bmax, nbuild, max_dup = (int(x) for x in torch.stack(
        [bmin_d, bmax_d, nbuild_d, max_dup_d]).cpu().tolist())
    span = bmax - bmin + 1
    if nbuild <= 0 or not 0 < span <= DENSE_KEY_RANGE_LIMIT:
        return None
    starts, sorted_orig = _dense_table(bv, b_in, order, bmin, span, nbuild)
    return DenseBuildTable(starts, sorted_orig, bmin, span, max_dup, bcap,
                           build_rows)


def _dense_table(bv, b_in, order, bmin: int, span: int, nbuild: int):
    """(starts[span + 1], sorted_orig[bcap]): build rows grouped by key
    value, a counting sort; rows past the live ones are -1."""
    bcap = bv.shape[0]
    device = bv.device
    slot = torch.where(b_in, bv - bmin, span)
    cnt = torch.zeros(span + 1, dtype=torch.int32, device=device)
    cnt.index_add_(0, slot, torch.ones(bcap, dtype=torch.int32,
                                       device=device))
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                        torch.cumsum(cnt[:span], 0, dtype=torch.int32)])
    sorted_orig = torch.where(torch.arange(bcap, device=device) < nbuild,
                              order, -1)
    return starts, sorted_orig


def _probe_in(probe_key: ColumnVector, probe_rows, probe_live=None):
    """Live, valid probe rows. A masked batch has live rows anywhere: its
    live mask is combined with the validity, never ``arange < rows``."""
    if probe_live is not None:
        return probe_live if probe_key.validity is None \
            else (probe_live & probe_key.validity)
    return probe_key.validity_or_default(probe_rows)


def dense_lookup_planes(slot_idx: torch.Tensor, bmin: int, pv: torch.Tensor,
                        p_in: torch.Tensor) -> torch.Tensor:
    """Build row per probe row (-1 unmatched) through a unique-key table:
    one gather, no host read."""
    span = slot_idx.shape[0]
    slot = pv - bmin
    inside = p_in & (slot >= 0) & (slot < span)
    sl = torch.where(inside, slot, 0)
    return torch.where(inside, slot_idx[sl], -1)


def dense_lookup(table: DenseBuildTable, probe_keys: List[ColumnVector],
                 probe_rows, probe_live=None) -> torch.Tensor:
    """``dense_lookup_planes`` over probe key columns; needs max_dup <= 1."""
    pk = probe_keys[0]
    return dense_lookup_planes(table.slot_idx, table.bmin,
                               pk.data.to(torch.int64),
                               _probe_in(pk, probe_rows, probe_live))


def _dense_int_pairs(table: DenseBuildTable, pv, p_in, pcap: int):
    starts, sorted_orig, bcap = table.starts, table.sorted_orig, table.bcap
    slot = pv - table.bmin
    inside = p_in & (slot >= 0) & (slot < table.span)
    sl = torch.where(inside, slot, 0)
    lo = torch.where(inside, starts[sl], 0)
    hi = torch.where(inside, starts[sl + 1], 0)
    counts = hi - lo
    if table.max_dup <= 1:
        # unique build keys: the pairs are the matching probe rows
        idx, match_count = K.filter_indices(counts > 0, pcap)
        sel = idx.clamp(0, pcap - 1)
        out_p = torch.where(idx >= 0, sel, -1)
        bpos = torch.where(idx >= 0, lo[sel], 0).to(torch.int64)
        out_b = torch.where(idx >= 0,
                            sorted_orig[bpos.clamp(0, bcap - 1)], -1)
        return out_p, out_b, match_count
    total = int(counts.sum(dtype=torch.int64).item())
    probe_i, build_pos = K.expand_candidate_ranges(lo, hi, total)
    build_i = torch.where(build_pos >= 0,
                          sorted_orig[build_pos.clamp(0, bcap - 1)], -1)
    return probe_i, build_i, total


# ---------------------------------------------------------------------------
# Pairs
# ---------------------------------------------------------------------------

def join_pairs(build_keys: List[ColumnVector], build_rows,
               probe_keys: List[ColumnVector], probe_rows, probe_live=None):
    """Matching (probe index, build index) pairs of an equi-join as int64
    planes padded with -1, probe-major, and their count (a host int)."""
    table = prepare_dense_build(build_keys, build_rows,
                                [c.dtype for c in probe_keys])
    if table is not None:
        pk = probe_keys[0]
        return _dense_int_pairs(table, pk.data.to(torch.int64),
                                _probe_in(pk, probe_rows, probe_live),
                                pk.capacity)

    bh, bplanes, bnull = _combine_keys(build_keys, build_rows)
    ph, pplanes, pnull = _combine_keys(probe_keys, probe_rows,
                                       live=probe_live)
    bcap, pcap = bh.shape[0], ph.shape[0]
    device = bh.device
    b_in = (torch.arange(bcap, device=device) < rows_tensor(build_rows)) \
        & ~bnull
    p_live = probe_live if probe_live is not None else \
        torch.arange(pcap, device=device) < rows_tensor(probe_rows)
    p_in = p_live & ~pnull

    # the non-null build rows compacted, then sorted by hash (unsigned
    # order; the pad rows carry the all-ones sentinel and sort last)
    bidx, bcount = K.filter_indices(b_in, bcap)
    bh_c = torch.where(bidx >= 0, _ordered(bh)[bidx.clamp(min=0)], _MAX64)
    sorted_h, order = torch.sort(bh_c, stable=True)
    sorted_orig = bidx[order]

    lo, hi = _merge_rank_ranges(sorted_h, bcount, _ordered(ph), p_in)
    total = int((hi - lo).sum(dtype=torch.int64).item())
    probe_i, build_pos = K.expand_candidate_ranges(lo, hi, total)
    build_i = torch.where(
        build_pos >= 0,
        sorted_orig[build_pos.clamp(0, sorted_orig.shape[0] - 1)], -1)

    # exact equality of the normalized planes (the hash may collide)
    ok = (probe_i >= 0) & (build_i >= 0)
    psel = probe_i.clamp(0, pcap - 1)
    bsel = build_i.clamp(0, bcap - 1)
    for pp, bp in zip(pplanes, bplanes):
        ok = ok & (pp[psel] == bp[bsel])
    idx, match_count = K.filter_indices(ok, ok.shape[0])
    sel = idx.clamp(0, ok.shape[0] - 1)
    out_p = torch.where(idx >= 0, probe_i[sel], -1)
    out_b = torch.where(idx >= 0, build_i[sel], -1)
    return out_p, out_b, match_count


def _merge_rank_ranges(sorted_h: torch.Tensor, bcount: int,
                       ph: torch.Tensor, p_in: torch.Tensor):
    """Per probe row, its candidate run [lo, hi) of equal hashes in the
    sorted build plane, from one stable sort of the union of the hashes
    (all in signed order, the build's pad rows at the int64 maximum).
    The build rows come first in the union, so a stable sort puts each
    build row before the equal probe rows, as the JAX package's two-key
    sort does; its ``cummax`` of run starts is ``_run_starts`` here."""
    bcap, pcap = sorted_h.shape[0], ph.shape[0]
    device = sorted_h.device
    # dead probe rows get the sentinel too: their runs come out empty
    php = torch.where(p_in, ph, _MAX64)
    sh, si = torch.sort(torch.cat([sorted_h, php]), stable=True)
    is_probe = si >= bcap
    # build rows at union positions <= i
    nb_prefix = torch.cumsum((~is_probe).to(torch.int64), 0)
    dest = torch.where(is_probe, si - bcap, pcap)
    r = torch.zeros(pcap + 1, dtype=torch.int64, device=device)
    r.scatter_(0, dest, nb_prefix)
    r = r[:pcap].clamp(max=bcount)  # sentinel pad rows are no candidates
    last_b = r - 1  # the last build row with a hash <= the probe's
    lb = last_b.clamp(0, bcap - 1)
    eq = (last_b >= 0) & (last_b < bcount) & (sorted_h[lb] == ph) & p_in
    bound = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                       sorted_h[1:] != sorted_h[:-1]])
    return torch.where(eq, _run_starts(bound)[lb], 0), torch.where(eq, r, 0)


def probe_matched_mask(pairs_idx: torch.Tensor, cap: int) -> torch.Tensor:
    """bool[cap]: the rows of a side that appear in the pairs. Pairs hold
    live rows only, wherever they sit in a masked batch."""
    m = torch.zeros(cap + 1, dtype=torch.bool, device=pairs_idx.device)
    m[torch.where(pairs_idx >= 0, pairs_idx, cap)] = True
    return m[:cap]


def unmatched_indices(mask_matched: torch.Tensor, live: torch.Tensor):
    """(positions of the live rows not matched, their count): the outer
    joins' null-extended rows."""
    return K.filter_indices(~mask_matched & live, mask_matched.shape[0])
