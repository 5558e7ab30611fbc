"""Spec: keypoint matching by offset voting (kpm.hpp).

The port's copy of remap_tpu/spec/kpm.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

Two matchers:

**Frame-to-frame grid vote** (kpm.hpp:395-415) — used by the collector:

1. Gate: count *active* regions (>=1 keypoint) of the **current** grid; if
   ``active < region_count // 4`` there is no match (kpm.hpp:400-403).
2. Per region: join the two regions' code maps; for every code present in
   both, vote every (prev_point, curr_point) pair's offset
   ``prev - curr`` (kpm.hpp:92-125).  Adaptive weight filter: all weights
   are used iff ``prev_w2 < weight_switch or curr_w2 <= weight_switch``;
   otherwise only weight-2 codes from the current region vote
   (kpm.hpp:105-125, 213-223 — note the asymmetric < / <=).
3. Keep the top ``region_votes`` offsets per region by vote count
   (kpm.hpp:127-159).
4. Borda count across regions: the region's rank-r offset earns
   ``region_votes - r`` + 1 points (3/2/1) (kpm.hpp:172-184).
5. Declare: winner needs ``top[0] >= top[1] + active // 2`` when a
   runner-up exists (kpm.hpp:199-211).

**Fragment-to-fragment cellular match** (kpm.hpp:371-393) — used by the
splicer: votes are bucketed per spatial cell ``(min(px,cx)//cw,
min(py,cy)//ch)`` (kpm.hpp:225-247); the best offset maximises *matched
keypoints* (total votes), and is accepted iff its *matched cell* count
reaches ``0.66 x`` the active cells of the overlap (kpm.hpp:281-298,
317-367, 384-390).

Tie-breaking: the reference's top-k and max_element inherit unordered_map
iteration order, which is unspecified; this spec (and the device kernels)
canonically break count ties by ascending ``(dx, dy)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from remap_tpu_torch.spec.kpe import RegionPoints

Offset = Tuple[int, int]


def _top_by_count(
    totals: Dict[Offset, int], top: int
) -> List[Tuple[Offset, int]]:
    """Top-k (offset, count) by count desc, ties by (dx, dy) asc."""
    items = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
    return items[:top]


def _count_offsets(
    prev: RegionPoints, curr: RegionPoints, only_weight2: bool
) -> Dict[Offset, int]:
    totals: Dict[Offset, int] = {}
    for code, cpts in curr.points.items():
        if only_weight2 and (code[3] >> 4) != 2:
            continue  # kpm.hpp:113-116
        ppts = prev.points.get(code)
        if ppts is None:
            continue
        for px, py in ppts:
            for cx, cy in cpts:
                off = (px - cx, py - cy)
                totals[off] = totals.get(off, 0) + 1
    return totals


def match_frames(
    prev_regions: List[RegionPoints],
    curr_regions: List[RegionPoints],
    weight_switch: int,
    region_votes: int = 3,
    min_active_divisor: int = 4,
    runner_up_divisor: int = 2,
) -> Optional[Offset]:
    """kpm::match(config, previous, current) (kpm.hpp:395-415)."""
    region_count = len(curr_regions)
    active = sum(1 for r in curr_regions if r.active)
    if active < region_count // min_active_divisor:
        return None

    borda: Dict[Offset, int] = {}
    for prev, curr in zip(prev_regions, curr_regions):
        use_all = (
            prev.counts[2] < weight_switch or curr.counts[2] <= weight_switch
        )  # kpm.hpp:219-222
        totals = _count_offsets(prev, curr, only_weight2=not use_all)
        ticket = _top_by_count(totals, region_votes)
        rank = region_votes
        for off, _count in ticket:
            borda[off] = borda.get(off, 0) + rank  # kpm.hpp:176-182
            rank -= 1

    top = _top_by_count(borda, 2)
    if not top:
        return None
    if len(top) > 1 and top[0][1] < top[1][1] + active // runner_up_divisor:
        return None  # kpm.hpp:206-209
    return top[0][0]


# ---------------------------------------------------------------------------
# Fragment-to-fragment cellular match (kpm.hpp:371-393)
# ---------------------------------------------------------------------------


def match_fragments(
    prev_region: RegionPoints,
    prev_mask: np.ndarray,   # [Hp, Wp] uint8 nonzero where atlas has votes
    curr_region: RegionPoints,
    curr_mask: np.ndarray,   # [Hc, Wc]
    cell_size: Tuple[int, int],
) -> Optional[Tuple[Offset, int]]:
    """Returns (offset, matched_keypoints) or None."""
    cw, ch = cell_size

    # offset -> {cell -> count}  (kpm.hpp:231-247)
    cells: Dict[Offset, Dict[Offset, int]] = {}
    for code, cpts in curr_region.points.items():
        ppts = prev_region.points.get(code)
        if ppts is None:
            continue
        for px, py in ppts:
            for cx, cy in cpts:
                off = (px - cx, py - cy)
                cell = (min(px, cx) // cw, min(py, cy) // ch)
                bucket = cells.setdefault(off, {})
                bucket[cell] = bucket.get(cell, 0) + 1
    if not cells:
        return None

    # Best by matched keypoints (total votes), ties by (dx, dy) asc
    # (kpm.hpp:266-298; reference tie order is unspecified hash order).
    def score(item: Tuple[Offset, Dict[Offset, int]]):
        off, bucket = item
        return (-sum(bucket.values()), off)

    best_off, best_bucket = min(cells.items(), key=score)
    matched_cells = len(best_bucket)
    matched_keypoints = sum(best_bucket.values())

    active = _count_active_cells(
        curr_region, prev_mask, curr_mask, best_off, cell_size
    )
    if matched_cells < active * 0.66:
        return None  # kpm.hpp:387-390
    return best_off, matched_keypoints


def _count_active_cells(
    curr_region: RegionPoints,
    prev_mask: np.ndarray,
    curr_mask: np.ndarray,
    offset: Offset,
    cell_size: Tuple[int, int],
) -> int:
    """kpm.hpp:317-367: distinct cells of current keypoints that fall in the
    overlap region and land on non-empty previous-mask pixels."""
    from remap_tpu_torch.core.geometry import overlap_spans

    dx, dy = offset
    hp, wp = prev_mask.shape
    hc, wc = curr_mask.shape
    (_, _), (cxl, cxh) = overlap_spans(dx, wp, wc)
    (_, _), (cyl, cyh) = overlap_spans(dy, hp, hc)

    cw, ch = cell_size
    cells = set()
    for _code, pts in curr_region.points.items():
        for x, y in pts:
            if cxl <= x < cxh and cyl <= y < cyh:
                bx, by = x + dx, y + dy
                if 0 <= bx < wp and 0 <= by < hp and prev_mask[by, bx] != 0:
                    # kpm.hpp:338-341: cell keyed by ((x-left)/cw*cw, ...)
                    cells.add(((x - cxl) // cw, (y - cyl) // ch))
    return len(cells)
