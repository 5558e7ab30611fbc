"""Spec: foreground (sprite/actor) extraction (fde.hpp).

The port's copy of remap_tpu/spec/fde.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

Against the blended fragment background, each stored frame's changed pixels
are found by equality comparison at the frame's blit position
(fde.hpp:19-55: mask = 0xff where background == frame, else 0).  Contours
are then extracted from the **median** image seeded at changed pixels
(mask == 0, fde.hpp:83-92), and contours bigger than 1/5 of the frame are
dropped (fde.hpp:94-100).

``foreground_mask`` paints each kept contour's exact pixels and then fills
its bbox *excluding the last row and column* — the reference's fill loops
treat the inclusive bbox bounds as exclusive (fde.hpp:122-146).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from remap_tpu_torch.spec import cte


def equality_mask(
    background: np.ndarray, frame: np.ndarray, pos: Tuple[int, int]
) -> np.ndarray:
    """[Hf, Wf] uint8: 0xff where background matches frame (fde.hpp:19-55)."""
    h, w = frame.shape
    x, y = pos
    bg = background[y : y + h, x : x + w]
    return np.where(bg == frame, np.uint8(0xFF), np.uint8(0))


def extract(
    background: np.ndarray,
    frame: np.ndarray,
    median: np.ndarray,
    pos: Tuple[int, int],
    area_divisor: int = 5,
) -> Tuple[cte.ContoursResult, List[cte.Contour]]:
    """fde::extractor::extract (fde.hpp:83-103): returns (all-components
    result, kept foreground contours)."""
    mask = equality_mask(background, frame, pos)
    result = cte.extract(median, pred_mask=(mask == 0))
    limit = frame.size // area_divisor
    kept = [c for c in result.contours if c.area <= limit]
    return result, kept


def foreground_mask(
    result: cte.ContoursResult,
    kept: List[cte.Contour],
    shape: Tuple[int, int],
) -> np.ndarray:
    """fde::mask (fde.hpp:122-146): contour pixels + bbox fill.

    The fill loops run ``[top_, bottom_) x [left_, right_)`` over the
    reference's *enclosure*, which carries two quirks: inclusive bounds
    treated as exclusive (the last row/column is skipped), and ``left_``
    = the quirky ``lower_`` of cdt::limits (see
    spec.cte.quirky_fill_lefts) — ``None``/greater-than-right paints
    nothing (the reference's loop body never runs)."""
    out = np.zeros(shape, dtype=np.uint8)
    for c in kept:
        out[result.labels == c.label] = 1
    for c in kept:
        b = c.bbox
        if c.fill_left is None or c.fill_left >= b.right:
            continue
        out[b.top : b.bottom, c.fill_left : b.right] = 1
    return out
