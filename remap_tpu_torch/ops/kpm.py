"""Batched frame-to-frame keypoint matching (port of remap_tpu/ops/kpm.py).

The JAX matcher vmaps ``_region_votes`` over (pair, region) and
``_borda_declare`` over pairs; here those axes are written out: every
(pair, region) table pair is one row of an ``[N, ...]`` batch with
``N = P * R``.  All of it is plain tensor code (the JAX package runs it
in XLA, outside any Pallas kernel), so it runs unchanged on both devices.

Ported: the three joins of ``_region_votes`` — slot-major
(``_join_slots``), rolled (``_join_rolled``, where the slot join's int32
coordinate packing would overflow) and dense (``_join_dense``,
``multiplicity=0``) — both vote counting paths (the exact sort at
``vote_radius=0`` and the bounded histogram, here an exact integer
histogram), the Borda swing bound, ``_borda_declare`` and
``match_tables``.  Splice's ``_join_slots_scan`` is ``_join_slots`` with
``curr=True`` over ``[N, K]`` rows, one a fragment pair
(``ops.splice``).

Order contracts kept from the JAX package:

- The join's 4-word code sort is unsigned lexicographic with the invalid
  sentinel 0xFFFFFFFF last, and stable (XLA:CPU keeps equal keys in input
  order), so at ``multiplicity=1`` the same prev entry becomes the
  partner.  Words are zero-extended to int64 and folded into two signed
  int64 keys that order exactly as the unsigned word pairs do.
- Top offsets come from an iterated argmax, and ``torch.argmax`` returns
  the first maximal index: ties go to the smallest key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from remap_tpu_torch.core.regions import GridLayout
from remap_tpu_torch.ops.tables import RegionTables

_U32 = 0xFFFFFFFF


class MatchResult(NamedTuple):
    offset: torch.Tensor          # [P, 2] int32 (dx, dy)
    ok: torch.Tensor              # [P] bool
    overflow: torch.Tensor        # [P] bool — join multiplicity exceeded
    range_overflow: torch.Tensor  # [P] bool — vote radius could matter


def _encode_offset(dx, dy, w: int, h: int):
    return (dx + w) * (2 * h) + (dy + h)


def _decode_offset(key, w: int, h: int):
    return (torch.div(key, 2 * h, rounding_mode="floor") - w,
            torch.remainder(key, 2 * h) - h)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _run_counts(sorted_keys: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Per-position run lengths of ascending keys along the last axis:
    the run's length at positions that start a non-sentinel run, else 0."""
    n = sorted_keys.shape[-1]
    iota = torch.arange(n, device=sorted_keys.device)
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    start_pos = torch.where(is_start, iota, n)
    suffix_min = torch.cummin(start_pos.flip(-1), dim=-1).values.flip(-1)
    next_start = torch.cat(
        [suffix_min[..., 1:], torch.full_like(suffix_min[..., :1], n)], dim=-1
    )
    return torch.where(is_start & (sorted_keys < sentinel),
                       next_start - iota, 0)


def _sort_keys(codes: torch.Tensor, valid: torch.Tensor,
               tag: torch.Tensor):
    """Two int64 keys whose lexicographic order is the unsigned order of
    the JAX sort words ``(c0, c1, c2, (c3 << 1) | tag)`` (all-ones where
    invalid): ``hi = (c0 - 2**31) * 2**32 + c1`` and likewise ``lo``."""
    words = codes.to(torch.int64) & _U32                  # [N, n, 4]
    words[..., 3] = ((words[..., 3] << 1) & _U32) | tag
    words = torch.where(valid[..., None], words, _U32)
    hi = (words[..., 0] - (1 << 31)) * (1 << 32) + words[..., 1]
    lo = (words[..., 2] - (1 << 31)) * (1 << 32) + words[..., 3]
    return hi, lo


class _SortedRows(NamedTuple):
    """Both tables' rows in join order, with their run bookkeeping."""

    spx: torch.Tensor         # [N, 2K] x of each sorted row
    spy: torch.Tensor         # [N, 2K] y
    is_prev: torch.Tensor     # [N, 2K] a valid prev row
    is_curr: torch.Tensor     # [N, 2K] a valid (selected) curr row
    rid: torch.Tensor         # [N, 2K] run id, 1.., ascending
    d: torch.Tensor           # [N, 2K] distance to the run's start
    n_prev: torch.Tensor      # [N, 2K] prev rows of the row's run before it
    total_true: torch.Tensor  # [N] equal-code pairs an exhaustive join has


def _sorted_rows(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel) -> _SortedRows:
    """The code sort shared by the slot-major and rolled joins: prev and
    curr rows of ``[N, K]`` tables sorted by code, prev entries before curr
    ones within a run of equal codes (the origin tag), invalid rows last."""
    k = p_codes.shape[1]
    n = 2 * k
    dev = p_codes.device

    codes = torch.cat([p_codes, c_codes], dim=1)          # [N, 2K, 4]
    validc = torch.cat([p_valid, c_sel], dim=1)
    tag = torch.cat([torch.zeros(k, dtype=torch.int64, device=dev),
                     torch.ones(k, dtype=torch.int64, device=dev)])
    px = torch.cat([p_pos[..., 0], c_pos[..., 0]], dim=1).to(torch.int64)
    py = torch.cat([p_pos[..., 1], c_pos[..., 1]], dim=1).to(torch.int64)

    # stable lexicographic sort: least-significant key first
    hi, lo = _sort_keys(codes, validc, tag)
    order = torch.sort(lo, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(hi.gather(1, order), dim=1,
                                       stable=True).indices)
    shi, slo = hi.gather(1, order), lo.gather(1, order)

    s3 = slo & _U32                                       # the tagged word
    is_curr_row = (s3 & 1) != 0
    not_sent = s3 != _U32
    is_prev = ~is_curr_row & not_sent
    is_curr = is_curr_row & not_sent

    iota = torch.arange(n, device=dev)
    m3 = slo | 1                  # mask the origin bit out of run keys
    is_start = torch.ones_like(is_prev)
    is_start[:, 1:] = (shi[:, 1:] != shi[:, :-1]) | (m3[:, 1:] != m3[:, :-1])
    rid = torch.cumsum(is_start, dim=1)                   # 1..n
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values

    # prev count of each row's run
    is_prev_i = is_prev.to(torch.int64)
    pcum_ex = torch.cumsum(is_prev_i, dim=1) - is_prev_i
    start_val = torch.cummax(torch.where(is_start, pcum_ex, -1), dim=1).values
    n_prev = pcum_ex - start_val
    return _SortedRows(
        spx=px.gather(1, order), spy=py.gather(1, order), is_prev=is_prev,
        is_curr=is_curr, rid=rid, d=iota - run_start, n_prev=n_prev,
        total_true=torch.where(is_curr, n_prev, 0).sum(dim=1),
    )


def _missed(rows: _SortedRows, pair: torch.Tensor):
    """(n_missed [N], rows_missed [N]) of an enumeration ``pair``
    ``[N, S, 2K]``: the equal-code pairs it left out, and the curr rows
    with at least one partner left out."""
    n_missed = rows.total_true - pair.sum(dim=(1, 2))
    enum_row = pair.sum(dim=1)                            # [N, 2K]
    rows_missed = (rows.is_curr & (rows.n_prev > enum_row)).sum(dim=1)
    return n_missed, rows_missed


def _join_slots(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
                multiplicity: int, coord_limit: int, curr: bool = False,
                rows: Optional[_SortedRows] = None):
    """Batched ``remap_tpu.ops.kpm._join_slots`` over ``[N, K]`` tables.

    Returns (dx [N, m, 2K], dy [N, m, 2K], pair [N, m, 2K],
    n_missed [N], rows_missed [N]).  With ``curr`` it also returns what
    ``remap_tpu.ops.kpm._join_slots_scan`` adds for splice: (curr_x
    [N, 2K], curr_y [N, 2K], needed_m [N]), each sorted row's own
    coordinates and the smallest multiplicity that enumerates every pair.
    The JAX scan splits the coordinate into bit fields only to keep its
    pack inside int32; the int64 pack here needs no split, so one
    function serves both.  ``rows``: the tables' :func:`_sorted_rows`,
    sorted already (they do not depend on the multiplicity)."""
    m = multiplicity
    lim = coord_limit + 2
    if rows is None:
        rows = _sorted_rows(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel)
    spx, spy = rows.spx, rows.spy

    # the j-th partner of every curr row of a run is the run's j-th prev
    # entry: pack (run id, coordinate) so one cummax carries it forward
    slot = torch.arange(m, device=p_codes.device)[None, :, None]  # [1, m, 1]
    emit = rows.is_prev[:, None, :] & (rows.d[:, None, :] == slot)
    base = (rows.rid * lim)[:, None, :]

    def fill(v):
        packed = torch.where(emit, base + v[:, None, :] + 1, 0)
        carried = torch.cummax(packed, dim=2).values
        return torch.remainder(carried, lim) - 1

    pair = rows.is_curr[:, None, :] & (slot < rows.n_prev[:, None, :])
    dx = fill(spx) - spx[:, None, :]
    dy = fill(spy) - spy[:, None, :]
    out = (dx, dy, pair) + _missed(rows, pair)
    if curr:
        needed = torch.where(rows.is_curr, rows.n_prev, 0).amax(dim=1)
        out += (spx, spy, needed)
    return out


def _join_rolled(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
                 multiplicity: int, max_run: int):
    """Batched ``remap_tpu.ops.kpm._join_rolled`` over ``[N, K]`` tables:
    the same sorted rows as :func:`_join_slots`, each curr row's partners
    found at the backward distances ``1..max_run``.  A partner further than
    ``max_run`` back is missed even below the multiplicity, so its
    truncation (``n_missed``, ``rows_missed``) is its own.

    Returns (dx [N, S, 2K], dy [N, S, 2K], pair [N, S, 2K], n_missed [N],
    rows_missed [N]) with ``S = max_run``."""
    m = multiplicity
    rows = _sorted_rows(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel)

    def shifted(a, s):
        return torch.cat([a[:, :1].expand(-1, s), a[:, :-s]], dim=1)

    dxs, dys, pairs = [], [], []
    for s in range(1, max_run + 1):
        # partner rank within the run = d - s; keep rank < multiplicity
        pairs.append(rows.is_curr & shifted(rows.is_prev, s)
                     & (rows.rid == shifted(rows.rid, s))
                     & (rows.d - s < m) & (s <= rows.d))
        dxs.append(shifted(rows.spx, s) - rows.spx)
        dys.append(shifted(rows.spy, s) - rows.spy)
    pair = torch.stack(pairs, dim=1)
    return (torch.stack(dxs, dim=1), torch.stack(dys, dim=1), pair) + _missed(
        rows, pair)


def _join_dense(p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
                curr: bool = False):
    """Batched ``remap_tpu.ops.kpm._join_dense``: every equal-code (prev,
    curr) pair of ``[N, K]`` tables, no multiplicity limit.  Codes compare
    word by word (no ``[N, K, K, 4]`` tensor), offsets stay int32.

    Returns (dx [N, K, K], dy [N, K, K], pair [N, K, K], n_missed [N],
    rows_missed [N]): axis 1 is the prev row (a curr row's partners),
    axis 2 the curr row, as the slot-major joins; nothing is missed.  With
    ``curr``, also (curr_x [N, K], curr_y [N, K], needed_m [N] = 0) as
    :func:`_join_slots` gives them."""
    pair = p_valid[:, :, None] & c_sel[:, None, :]
    for word in range(4):
        pair &= p_codes[:, :, None, word] == c_codes[:, None, :, word]
    dx = p_pos[:, :, None, 0] - c_pos[:, None, :, 0]
    dy = p_pos[:, :, None, 1] - c_pos[:, None, :, 1]
    zero = torch.zeros(p_codes.shape[0], dtype=torch.int64,
                       device=p_codes.device)
    out = (dx, dy, pair, zero, zero)
    if curr:
        out += (c_pos[..., 0], c_pos[..., 1], zero)
    return out


def _top_by_argmax(counts: torch.Tensor, keys: torch.Tensor, picks: int):
    """Iterated argmax over the last axis: the ``picks`` largest counts
    with their keys, ties to the first position."""
    counts = counts.clone()
    top_keys, top_counts = [], []
    for _ in range(picks):
        i = torch.argmax(counts, dim=-1, keepdim=True)
        top_keys.append(keys.gather(-1, i)[..., 0])
        top_counts.append(counts.gather(-1, i)[..., 0])
        counts.scatter_(-1, i, -1)
    return torch.stack(top_keys, dim=-1), torch.stack(top_counts, dim=-1)


def _swing_bound(counts_ext: torch.Tensor, unknown: torch.Tensor,
                 region_votes: int) -> torch.Tensor:
    """Borda swing of each region ticket under ``unknown`` uncertain votes
    (remap_tpu/ops/kpm.py::_region_votes, ``swing_bound``)."""
    gaps = counts_ext[:, :-1] - counts_ext[:, 1:]
    vul = unknown[:, None] >= gaps
    first = _first_true(vul)
    swing = torch.where((unknown > 0) & vul.any(dim=1),
                        region_votes - first, 0)
    return swing.to(torch.int32)


#: pair slots ([rows, K, K]) the dense join enumerates at once; more rows
#: run in chunks, each its own batch (the rows are independent), so the
#: live set stays near 8 GB whatever the capacity and the batch
DENSE_SLOTS = 1 << 27


def _region_votes(p_codes, p_pos, p_valid, c_codes, c_pos, c_valid,
                  use_all_weights, w: int, h: int, region_votes: int,
                  multiplicity: int, vote_radius: int = 0):
    """Top-``region_votes`` offsets of ``[N]`` region pairs: (keys [N, V],
    counts [N, V], swing [N], join-involved flag [N])."""
    nrows, k = p_codes.shape[:2]
    if multiplicity == 0 and nrows > 1 and nrows * k * k > DENSE_SLOTS:
        step = max(1, DENSE_SLOTS // (k * k))
        args = (p_codes, p_pos, p_valid, c_codes, c_pos, c_valid,
                use_all_weights)
        parts = [_region_votes(*(a[i:i + step] for a in args), w=w, h=h,
                               region_votes=region_votes, multiplicity=0,
                               vote_radius=vote_radius)
                 for i in range(0, nrows, step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    sentinel = 4 * w * h
    c_weight = (c_codes[..., 3] >> 4) & 0xF
    c_sel = c_valid & (use_all_weights[:, None] | (c_weight == 2))

    if multiplicity == 0:  # exhaustive dense join (no limits)
        dx, dy, pair, n_missed, rows_missed = _join_dense(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel)
    elif 2 * p_codes.shape[1] * (max(w, h) + 2) < (1 << 31) - 1:
        dx, dy, pair, n_missed, rows_missed = _join_slots(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
            multiplicity, coord_limit=max(w, h))
    else:  # the slot join's coordinate packing would overflow int32
        dx, dy, pair, n_missed, rows_missed = _join_rolled(
            p_codes, p_pos, p_valid, c_codes, c_pos, c_sel,
            multiplicity, max_run=2 * multiplicity)
    picks = region_votes + 1

    if vote_radius > 0:
        # exact integer histogram over (dx, dy) bins; bins run (dx, dy)
        # row-major = ascending encoded key, so the first-max tie-break
        # still picks the smallest key
        r = vote_radius
        nb = 2 * r + 1
        in_range = pair & (dx.abs() <= r) & (dy.abs() <= r)
        rows_out = (pair & ~in_range).any(dim=1).sum(dim=1)
        bins = torch.where(in_range, (dx + r) * nb + (dy + r), 0)
        counts = torch.zeros((nrows, nb * nb), dtype=torch.int32,
                             device=dx.device)
        counts.scatter_add_(1, bins.reshape(nrows, -1).to(torch.int64),
                            in_range.reshape(nrows, -1).to(torch.int32))
        iotab = torch.arange(nb, device=dx.device)
        bx = iotab[:, None].expand(nb, nb).reshape(-1) - r
        by = iotab[None, :].expand(nb, nb).reshape(-1) - r
        bin_keys = _encode_offset(bx, by, w, h).expand(nrows, -1)
        top_keys, top_counts = _top_by_argmax(counts, bin_keys, picks)
        unknown = rows_missed + rows_out
    else:
        keys = torch.where(pair, _encode_offset(dx, dy, w, h), sentinel)
        skeys = torch.sort(keys.reshape(nrows, -1), dim=1).values
        counts = _run_counts(skeys, sentinel)
        top_keys, top_counts = _top_by_argmax(counts, skeys, picks)
        unknown = rows_missed

    swing = _swing_bound(top_counts, unknown, region_votes)
    return (top_keys[:, :region_votes].to(torch.int32),
            top_counts[:, :region_votes].to(torch.int32),
            swing, n_missed > 0)


def _borda_declare(keys, counts, active, swings, w: int, h: int,
                   region_count: int, region_votes: int,
                   min_active_divisor: int, runner_up_divisor: int):
    """Borda count + declare (kpm.hpp:172-211) with the declare-level
    stability flag, for ``[P]`` pairs: keys/counts ``[P, R, V]``,
    active ``[P]``, swings ``[P, R]`` -> (offset [P, 2], ok [P],
    unstable [P])."""
    sentinel = 4 * w * h
    p = keys.shape[0]
    dev = keys.device
    v = region_votes
    pts = torch.arange(v, 0, -1, device=dev)
    points = torch.where(counts > 0, pts, 0).reshape(p, -1)
    flat_keys = torch.where(counts > 0, keys, sentinel).reshape(p, -1)

    skeys, order = torch.sort(flat_keys, dim=1)
    spoints = points.gather(1, order)
    n = skeys.shape[1]
    iota = torch.arange(n, device=dev)
    is_start = torch.ones_like(skeys, dtype=torch.bool)
    is_start[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    start_pos = torch.where(is_start, iota, n)
    suffix_min = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    next_start = torch.cat(
        [suffix_min[:, 1:], torch.full_like(suffix_min[:, :1], n)], dim=1
    )
    cp = torch.cat([torch.zeros_like(spoints[:, :1]),
                    torch.cumsum(spoints, dim=1)], dim=1)
    run_total = cp.gather(1, next_start) - cp[:, :n]
    score = torch.where(is_start & (skeys < sentinel), run_total, 0)

    top2 = torch.topk(score, 2, dim=1).values
    # winner: the first start with the max score (ties -> smallest key)
    win_key = skeys.gather(1, torch.argmax(score, dim=1, keepdim=True))[:, 0]
    dx, dy = _decode_offset(win_key, w, h)

    s1, s2 = top2[:, 0], top2[:, 1]
    gate = active >= region_count // min_active_divisor
    margin = torch.div(active, runner_up_divisor, rounding_mode="floor")
    ok = gate & (s1 > 0)
    # kpm.hpp:206-209: with a runner-up, the winner must lead by active/2
    ok &= (s2 == 0) | (s1 >= s2 + margin)

    # declare-level stability under the unknown vote mass
    g = swings.sum(dim=1)
    rup_score = torch.where(skeys == win_key[:, None], 0, score)
    rup_key = skeys.gather(1, torch.argmax(rup_score, dim=1,
                                           keepdim=True))[:, 0]
    rank = torch.arange(v, device=dev)[None, None, :]
    vulnerable = rank >= (v - swings)[:, :, None]        # [P, R, V]

    def max_loss(key):
        held = (keys == key[:, None, None]) & (counts > 0)
        return torch.where(held & vulnerable, v - rank, 0).sum(dim=(1, 2))

    l1 = max_loss(win_key)
    l2 = max_loss(rup_key)
    ok_lo = gate & (s1 - l1 > 0) & (s1 - l1 >= s2 + g + margin)
    ok_hi = gate & (s1 + g > 0) & (
        (s2 - l2 <= 0) | (s1 + g >= s2 - l2 + margin)
    )
    winner_stable = s1 - l1 > s2 + g
    unstable = (g > 0) & ((ok_hi != ok_lo) | (ok & ~winner_stable))
    offset = torch.stack([dx, dy], dim=1).to(torch.int32)
    return offset, ok, unstable


def match_tables(prev: RegionTables, curr: RegionTables, layout: GridLayout,
                 weight_switch: int, region_votes: int = 3,
                 min_active_divisor: int = 4, runner_up_divisor: int = 2,
                 multiplicity: int = 8, vote_radius: int = 0) -> MatchResult:
    """Match every (prev[i], curr[i]) pair of table batches ``[P, R, ...]``.

    ``vote_radius > 0`` counts votes in a bounded-offset histogram
    (offsets beyond the radius flag ``range_overflow``); 0 = exact
    sort-based counting over the full offset range."""
    w, h = layout.width, layout.height
    p, r, k = prev.valid.shape

    # adaptive weight switch per region (kpm.hpp:219-222: < vs <=)
    use_all = (prev.wcounts[..., 2] < weight_switch) | (
        curr.wcounts[..., 2] <= weight_switch
    )                                                     # [P, R]

    def rows(t):
        return t.reshape(p * r, *t.shape[2:])

    keys, counts, swings, join_involved = _region_votes(
        rows(prev.codes), rows(prev.pos), rows(prev.valid),
        rows(curr.codes), rows(curr.pos), rows(curr.valid), rows(use_all),
        w=w, h=h, region_votes=region_votes, multiplicity=multiplicity,
        vote_radius=vote_radius,
    )
    keys = keys.reshape(p, r, region_votes)
    counts = counts.reshape(p, r, region_votes)
    swings = swings.reshape(p, r)
    join_involved = join_involved.reshape(p, r)

    active = (curr.wcounts.sum(dim=-1) > 0).sum(dim=-1).to(torch.int32)
    offset, ok, unstable = _borda_declare(
        keys, counts, active, swings, w=w, h=h,
        region_count=layout.region_count, region_votes=region_votes,
        min_active_divisor=min_active_divisor,
        runner_up_divisor=runner_up_divisor,
    )
    # an unstable declaration is the join's when truncation contributed
    # anywhere (multiplicity escalation), else the radius alone's
    join_cause = (join_involved & (swings > 0)).any(dim=1)
    return MatchResult(offset=offset, ok=ok,
                       overflow=unstable & join_cause,
                       range_overflow=unstable & ~join_cause)
