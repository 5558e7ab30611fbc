"""Host-side geometry helpers: rectangles and overlap spans (the port's
copy of remap_tpu/core/geometry.py; tests/test_torch_core.py holds the
two equal).

Mirrors the semantics of the reference's ``cdt`` types (cdt.hpp:12-345)
with plain tuples/dataclasses.  Device code never uses these.

Conventions: points/offsets are ``(x, y)``; array indexing is row-major
``[y, x]``.  ``Rect`` is left/top/right/bottom with *exclusive* right/bottom
unless noted (the reference mixes inclusive `enclosure` bounds and exclusive
`region` bounds; each use-site documents which).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Rect:
    """LTRB rectangle (cdt.hpp:236-278)."""

    left: int
    top: int
    right: int
    bottom: int

    @property
    def width(self) -> int:
        return self.right - self.left

    @property
    def height(self) -> int:
        return self.bottom - self.top

    @property
    def area(self) -> int:
        return self.width * self.height

    def contains(self, x: int, y: int) -> bool:
        return self.left <= x < self.right and self.top <= y < self.bottom


def overlap_spans(
    delta: int, previous: int, current: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """1-D overlap of two extents when `current` is shifted by `delta`.

    Returns ((prev_lo, prev_hi), (curr_lo, curr_hi)) — the reference's
    ``get_limits`` (kpm.hpp:302-315), used to find the intersection of two
    fragments given a match offset (offset = prev_point - curr_point).
    """
    if delta < 0:
        d = -delta
        return (0, min(previous, current - d)), (d, min(current, previous + d))
    return (delta, min(previous, current + delta)), (0, min(current, previous - delta))
