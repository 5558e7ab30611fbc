"""Spec: action-window scan (aws.hpp).

The port's copy of remap_tpu/spec/aws.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

A persistent {0,1} heatmap (init 1) is ANDed with per-pixel equality of
consecutive frames (aws.hpp:37-60).  Each step extracts the heatmap's
contours and scores them ``area * color`` — so any changed (color-0)
region scores 0 and the *first-discovered* minimal contour wins
(aws.hpp:62-69, ties keep discovery order via min_element).  While the
winning changed-region keeps growing, its bbox is tracked; it is accepted
once ``area > screen/3 and bbox.height() > 2H/5 and bbox.width() > 2W/3``
— where bbox.height()/width() are *inclusive-coordinate differences*, i.e.
real size minus one (aws.hpp:110-139, ctr.hpp:96-109).  The scan stops
after 100 stagnant frames (aws.hpp:118).

The final window is the bbox shrunk by 1px on every side; the crop region
keeps rows [top+1, bottom-1) and cols [left+1, right-1) of the screen
(aws.hpp:72-96 with mpb.hpp:30-32 — right/bottom of the raw bbox are
inclusive, so the crop drops 1 column on the left and 2 on the right).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.spec import cte

#: the reference's size_t (unsigned 64-bit) — enclosure coordinates wrap
_U64_MAX = 2**64 - 1


@dataclasses.dataclass
class WindowInfo:
    #: Winning contour bbox, inclusive coords.
    raw_bounds: Rect

    @property
    def crop(self) -> Rect:
        """Exclusive crop rect into the screen (rows/cols kept)."""
        b = self.raw_bounds
        return Rect(
            left=b.left + 1, top=b.top + 1, right=b.right - 1, bottom=b.bottom - 1
        )


def scan(
    frames: Iterable[np.ndarray],
    stagnation_limit: int = 100,
    min_area_divisor: int = 3,
    min_height_num: int = 2,
    min_height_den: int = 5,
    min_width_num: int = 2,
    min_width_den: int = 3,
) -> Optional[WindowInfo]:
    """aws::scan (aws.hpp:98-156)."""
    it = iter(frames)
    try:
        prev = next(it)
    except StopIteration:
        return None

    h, w = prev.shape
    min_area = (w * h) // min_area_divisor
    min_height = min_height_num * h // min_height_den
    min_width = min_width_num * w // min_width_den

    heatmap = np.ones((h, w), dtype=np.uint8)

    result: Optional[Rect] = None
    area = 0
    stagnation = 0

    for curr in it:
        if stagnation > stagnation_limit:
            break
        heatmap &= (prev == curr).astype(np.uint8)

        contours = cte.extract(heatmap).contours
        best = min(
            contours, key=lambda c: c.area * c.color
        )  # ties keep discovery order (stable min)

        if best.color == 0 and best.area > area:
            stagnation = 0
            area = best.area
            # the reference tracks the contour's ENCLOSURE, whose left is
            # the quirky cdt::limits lower_ (spec.cte.quirky_fill_lefts):
            # SIZE_MAX when unset, and width() underflows unsigned
            # (aws.hpp:110-139 with ctr.hpp:96-109, cdt.hpp:183-198)
            left_q = (
                best.fill_left if best.fill_left is not None else _U64_MAX
            )
            window = Rect(
                left=left_q,
                top=best.bbox.top,
                right=best.bbox.right,
                bottom=best.bbox.bottom,
            )
            width_q = (window.right - left_q) % (_U64_MAX + 1)
            if result is not None or (
                area > min_area
                and window.height > min_height
                and width_q > min_width
            ):
                result = window

        if result is not None:
            stagnation += 1

        prev = curr

    if result is None:
        return None
    return WindowInfo(raw_bounds=result)
