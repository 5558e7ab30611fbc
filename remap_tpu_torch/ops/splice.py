"""Fragment-to-fragment cellular matching (port of remap_tpu/ops/splice.py,
kpm.hpp:371-393).

Splicing matches whole-fragment keypoint tables (the 1x1 grid of
fgs.hpp:17): votes are bucketed per offset AND per spatial cell
(kpm.hpp:225-264); the best offset maximises matched keypoints (ties ->
smallest encoded offset); validation requires its distinct-cell count to
reach ``ratio x`` the active cells of the overlap (kpm.hpp:317-367,
384-390).

The JAX two-key ``lax.sort((okey, ckey), num_keys=2)`` is one sort of the
int64 key ``okey * C + ckey`` here, with ``C`` above every cell key; pairs
the join did not enumerate take cell key 0, so the sentinel offset's
entries sort last as they do in JAX.  ``torch.argmax`` returns the first
maximal index, so ties still go to the smallest offset key.
:func:`sort_tables` runs the slot join's code sort on its own and gives
the pair's needed multiplicity from it, so a caller can size the join
from the card and hand the same rows to :func:`match_fragments`.  Plain
tensor code (the JAX package runs it in XLA, outside any Pallas kernel),
the same on both devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from remap_tpu_torch.ops.kpm import (_join_dense, _join_slots, _sorted_rows,
                                     _SortedRows)


class CellMatch(NamedTuple):
    offset: torch.Tensor     # [2] int64 (dx, dy)
    count: torch.Tensor      # [] int64 matched keypoints of the best offset
    ok: torch.Tensor         # [] bool
    overflow: torch.Tensor   # [] bool
    #: [] int64 — the smallest multiplicity that enumerates every pair
    needed_multiplicity: torch.Tensor


class SortedTables(NamedTuple):
    rows: _SortedRows        # [1, 2K] both tables' rows in join order
    #: [] int64 — the most prev rows sharing a code with one curr row
    need: torch.Tensor


def sort_tables(p_codes, p_pos, p_valid, c_codes, c_pos,
                c_valid) -> SortedTables:
    """The slot join's code sort of two snippet tables and the pair's
    needed multiplicity, the value :func:`match_fragments` reports as
    ``needed_multiplicity`` (the rows do not depend on the
    multiplicity)."""
    rows = _sorted_rows(p_codes[None], p_pos[None], p_valid[None],
                        c_codes[None], c_pos[None], c_valid[None])
    return SortedTables(
        rows, torch.where(rows.is_curr, rows.n_prev, 0).amax())


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    start = torch.ones_like(sorted_keys, dtype=torch.bool)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return start


def match_fragments(
    p_codes, p_pos, p_valid,      # [K, 4] int32, [K, 2] int32, [K] bool
    c_codes, c_pos, c_valid,
    p_mask: torch.Tensor,         # [HB, WB] uint8 (zero-padded bucket)
    p_dims,                       # (w, h) true prev dims
    c_dims,                       # (w, h) true curr dims
    cell_w: int = 15,
    cell_h: int = 15,
    ratio: float = 0.66,
    multiplicity: int = 8,
    rows: Optional[_SortedRows] = None,
) -> CellMatch:
    """The cellular match of two snippet tables (``remap_tpu.ops.splice.
    match_fragments``); ``multiplicity=0`` is the exhaustive dense join.
    ``rows``: the tables' :func:`sort_tables` rows, which the slot join
    then does not sort again (the dense join takes none)."""
    hb, wb = p_mask.shape
    dev = p_codes.device
    args = (p_codes[None], p_pos[None], p_valid[None],
            c_codes[None], c_pos[None], c_valid[None])
    if multiplicity == 0:
        out = _join_dense(*args, curr=True)
    else:
        out = _join_slots(*args, multiplicity,
                          coord_limit=max(8192, 1 << (max(hb, wb) - 1)
                                          .bit_length()),
                          curr=True, rows=rows)
    dx, dy, pair, n_missed, _rows, scx, scy, needed = (t[0] for t in out)
    dx, dy = dx.long(), dy.long()
    scx, scy = scx.long()[None, :], scy.long()[None, :]
    # the cellular vote has no per-offset margin to bound against, so any
    # truncated pair keeps the conservative escalate-on-truncation rule
    overflow = n_missed > 0

    o_sent = 4 * wb * hb
    okey = torch.where(pair, (dx + wb) * (2 * hb) + (dy + hb), o_sent)
    # cell of a pair: (min(px,cx)//cw, min(py,cy)//ch) (kpm.hpp:225-247),
    # px = cx + dx; joins are slot-major [S, N] with curr coordinates
    # broadcast along axis 0
    stride = hb // cell_h + 2
    cellx = _floordiv(torch.minimum(scx + dx, scx), cell_w)
    celly = _floordiv(torch.minimum(scy + dy, scy), cell_h)
    ckey = torch.where(pair, cellx * stride + celly, 0)
    n_cells = (wb // cell_w + 2) * stride            # above every cell key

    skey = torch.sort((okey * n_cells + ckey).reshape(-1)).values
    so = _floordiv(skey, n_cells)
    n = so.shape[0]
    iota = torch.arange(n, device=dev)
    o_start = _run_starts(so)
    oc_start = _run_starts(skey)
    start_pos = torch.where(o_start, iota, n)
    suffix_min = torch.cummin(start_pos.flip(0), dim=0).values.flip(0)
    next_o = torch.cat([suffix_min[1:], suffix_min.new_full((1,), n)])
    live = o_start & (so < o_sent)
    # keypoints per offset run; distinct cells per offset run
    kp_count = torch.where(live, next_o - iota, 0)
    cum_cells = torch.cumsum(oc_start, dim=0)
    cells_before = cum_cells - oc_start.long()
    cell_count = torch.where(
        live, cum_cells[(next_o - 1).clamp(0, n - 1)] - cells_before, 0)

    best_i = torch.argmax(kp_count)           # ties -> smallest offset key
    best_key = so[best_i]
    best_kp = kp_count[best_i]
    best_cells = cell_count[best_i]
    bdx = _floordiv(best_key, 2 * hb) - wb
    bdy = torch.remainder(best_key, 2 * hb) - hb

    # ---- active cells of the overlap (kpm.hpp:317-367) ----------------
    pw, ph = int(p_dims[0]), int(p_dims[1])
    cw_, ch_ = int(c_dims[0]), int(c_dims[1])

    def span(delta, prev_len, curr_len):
        # JAX's two where-branches are the same expression
        return (torch.clamp(-delta, min=0),
                torch.clamp(prev_len - delta, max=curr_len))

    cxl, cxh = span(bdx, pw, cw_)
    cyl, cyh = span(bdy, ph, ch_)

    x = c_pos[:, 0].long()
    y = c_pos[:, 1].long()
    inside = c_valid & (x >= cxl) & (x < cxh) & (y >= cyl) & (y < cyh)
    bx = (x + bdx).clamp(0, wb - 1)
    by = (y + bdy).clamp(0, hb - 1)
    on_prev = p_mask[by, bx] != 0
    sel = inside & on_prev
    a_sent = 1 << 30
    acell = torch.where(
        sel,
        _floordiv(x - cxl, cell_w) * stride + _floordiv(y - cyl, cell_h),
        a_sent)
    sa = torch.sort(acell).values
    active = (_run_starts(sa) & (sa < a_sent)).sum()

    r32 = torch.tensor(ratio, dtype=torch.float32, device=dev)
    ok = (best_kp > 0) & (best_cells.to(torch.float32)
                          >= active.to(torch.float32) * r32)
    return CellMatch(offset=torch.stack([bdx, bdy]), count=best_kp, ok=ok,
                     overflow=overflow, needed_multiplicity=needed)
