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
each pair's needed multiplicity from it, so a caller can size the join
from the card and hand the same rows to :func:`match_fragments`.  Both
take a batch of ``N`` pairs at one table capacity and mask bucket, one
row a pair (the JAX functions' single pair is the ``N = 1`` case): every
sort, scan and argmax runs along a row, so a row's result does not
depend on the others.  Plain tensor code (the JAX package runs it in
XLA, outside any Pallas kernel), the same on both devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from remap_tpu_torch.ops.kpm import (_join_dense, _join_slots, _sorted_rows,
                                     _SortedRows)


class CellMatch(NamedTuple):
    offset: torch.Tensor     # [N, 2] int64 (dx, dy)
    count: torch.Tensor      # [N] int64 matched keypoints of the best offset
    ok: torch.Tensor         # [N] bool
    overflow: torch.Tensor   # [N] bool
    #: [N] int64 — the smallest multiplicity that enumerates every pair
    needed_multiplicity: torch.Tensor


class SortedTables(NamedTuple):
    rows: _SortedRows        # [N, 2K] both tables' rows in join order
    #: [N] int64 — the most prev rows sharing a code with one curr row
    need: torch.Tensor


def sort_tables(p_codes, p_pos, p_valid, c_codes, c_pos,
                c_valid) -> SortedTables:
    """The slot join's code sort of ``[N, K]`` pairs of snippet tables and
    each pair's needed multiplicity, the value :func:`match_fragments`
    reports as ``needed_multiplicity`` (the rows do not depend on the
    multiplicity)."""
    rows = _sorted_rows(p_codes, p_pos, p_valid, c_codes, c_pos, c_valid)
    return SortedTables(
        rows, torch.where(rows.is_curr, rows.n_prev, 0).amax(dim=1))


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    start = torch.ones_like(sorted_keys, dtype=torch.bool)
    start[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    return start


def match_fragments(
    p_codes, p_pos, p_valid,      # [N, K, 4] int32, [N, K, 2] int32, [N, K]
    c_codes, c_pos, c_valid,
    p_mask: torch.Tensor,         # [N, HB, WB] uint8 (zero-padded bucket)
    p_dims: torch.Tensor,         # [N, 2] (w, h) true prev dims
    c_dims: torch.Tensor,         # [N, 2] (w, h) true curr dims
    cell_w: int = 15,
    cell_h: int = 15,
    ratio: float = 0.66,
    multiplicity: int = 8,
    rows: Optional[_SortedRows] = None,
) -> CellMatch:
    """The cellular match of ``N`` pairs of snippet tables at one mask
    bucket (``remap_tpu.ops.splice.match_fragments`` on each row: the
    rows are independent, and each equals its own ``N = 1`` call);
    ``multiplicity=0`` is the exhaustive dense join.  ``rows``: the
    tables' :func:`sort_tables` rows, which the slot join then does not
    sort again (the dense join takes none)."""
    nrows, hb, wb = p_mask.shape
    dev = p_codes.device
    args = (p_codes, p_pos, p_valid, c_codes, c_pos, c_valid)
    if multiplicity == 0:
        out = _join_dense(*args, curr=True)
    else:
        out = _join_slots(*args, multiplicity,
                          coord_limit=max(8192, 1 << (max(hb, wb) - 1)
                                          .bit_length()),
                          curr=True, rows=rows)
    dx, dy, pair, n_missed, _rows, scx, scy, needed = out
    dx, dy = dx.long(), dy.long()
    scx, scy = scx.long()[:, None, :], scy.long()[:, None, :]
    # the cellular vote has no per-offset margin to bound against, so any
    # truncated pair keeps the conservative escalate-on-truncation rule
    overflow = n_missed > 0

    o_sent = 4 * wb * hb
    okey = torch.where(pair, (dx + wb) * (2 * hb) + (dy + hb), o_sent)
    # cell of a pair: (min(px,cx)//cw, min(py,cy)//ch) (kpm.hpp:225-247),
    # px = cx + dx; joins are slot-major [N, S, 2K] with curr coordinates
    # broadcast along axis 1
    stride = hb // cell_h + 2
    cellx = _floordiv(torch.minimum(scx + dx, scx), cell_w)
    celly = _floordiv(torch.minimum(scy + dy, scy), cell_h)
    ckey = torch.where(pair, cellx * stride + celly, 0)
    n_cells = (wb // cell_w + 2) * stride            # above every cell key

    skey = torch.sort((okey * n_cells + ckey).reshape(nrows, -1),
                      dim=1).values
    so = _floordiv(skey, n_cells)
    n = so.shape[1]
    iota = torch.arange(n, device=dev)
    o_start = _run_starts(so)
    oc_start = _run_starts(skey)
    start_pos = torch.where(o_start, iota, n)
    suffix_min = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    next_o = torch.cat([suffix_min[:, 1:],
                        suffix_min.new_full((nrows, 1), n)], dim=1)
    live = o_start & (so < o_sent)
    # keypoints per offset run; distinct cells per offset run
    kp_count = torch.where(live, next_o - iota, 0)
    cum_cells = torch.cumsum(oc_start, dim=1)
    cells_before = cum_cells - oc_start.long()
    cell_count = torch.where(
        live, cum_cells.gather(1, (next_o - 1).clamp(0, n - 1))
        - cells_before, 0)

    # ties -> smallest offset key
    best_i = torch.argmax(kp_count, dim=1, keepdim=True)
    best_key = so.gather(1, best_i)[:, 0]
    best_kp = kp_count.gather(1, best_i)[:, 0]
    best_cells = cell_count.gather(1, best_i)[:, 0]
    bdx = _floordiv(best_key, 2 * hb) - wb
    bdy = torch.remainder(best_key, 2 * hb) - hb

    # ---- active cells of the overlap (kpm.hpp:317-367) ----------------
    p_dims, c_dims = p_dims.long(), c_dims.long()

    def span(delta, prev_len, curr_len):
        # JAX's two where-branches are the same expression
        return (torch.clamp(-delta, min=0),
                torch.minimum(prev_len - delta, curr_len))

    cxl, cxh = (t[:, None] for t in span(bdx, p_dims[:, 0], c_dims[:, 0]))
    cyl, cyh = (t[:, None] for t in span(bdy, p_dims[:, 1], c_dims[:, 1]))

    x = c_pos[..., 0].long()
    y = c_pos[..., 1].long()
    inside = c_valid & (x >= cxl) & (x < cxh) & (y >= cyl) & (y < cyh)
    bx = (x + bdx[:, None]).clamp(0, wb - 1)
    by = (y + bdy[:, None]).clamp(0, hb - 1)
    row = torch.arange(nrows, device=dev)[:, None]
    on_prev = p_mask[row, by, bx] != 0
    sel = inside & on_prev
    a_sent = 1 << 30
    acell = torch.where(
        sel,
        _floordiv(x - cxl, cell_w) * stride + _floordiv(y - cyl, cell_h),
        a_sent)
    sa = torch.sort(acell, dim=1).values
    active = (_run_starts(sa) & (sa < a_sent)).sum(dim=1)

    r32 = torch.tensor(ratio, dtype=torch.float32, device=dev)
    ok = (best_kp > 0) & (best_cells.to(torch.float32)
                          >= active.to(torch.float32) * r32)
    return CellMatch(offset=torch.stack([bdx, bdy], dim=1), count=best_kp,
                     ok=ok, overflow=overflow, needed_multiplicity=needed)
