"""Spec: frame collection (frc.hpp).

The port's copy of remap_tpu/spec/frc.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

The streaming hot loop: every frame is keypoint-extracted; its grid is
matched against the *previous frame's* grid (regardless of fragment
breaks, frc.hpp:97-122); a successful match advances the accumulated
position by the offset, a failure starts a new fragment at position (0,0)
(frc.hpp:109-115, 124-127).  Every frame is blitted into the current
fragment and recorded with its image + median for the later foreground
pass.  ``complete`` normalizes fragment positions (frc.hpp:74-80).
"""

from __future__ import annotations

from typing import Iterable, List

from remap_tpu_torch.core.regions import GridLayout
from remap_tpu_torch.spec import kpe, kpm
from remap_tpu_torch.spec.fgm import Fragment

GRID_W = 4          # frc.hpp:22
GRID_H = 2          # frc.hpp:23
OVERLAP = 16        # frc.hpp:24
WEIGHT_SWITCH = 10  # frc.hpp:32
REGION_VOTES = 3    # frc.hpp:34


def collect(frames: Iterable, layout: GridLayout) -> List[Fragment]:
    fragments: List[Fragment] = []
    current: Fragment = None  # type: ignore[assignment]
    position = (0, 0)
    prev_regions = None

    for number, image in enumerate(frames):
        h, w = image.shape
        res = kpe.extract(image, layout)

        if prev_regions is None:
            current = Fragment.create(w, h)
            fragments.append(current)
            position = (0, 0)
        else:
            off = kpm.match_frames(
                prev_regions,
                res.regions,
                weight_switch=WEIGHT_SWITCH,
                region_votes=REGION_VOTES,
            )
            if off is not None:
                position = (position[0] + off[0], position[1] + off[1])
            else:
                current = Fragment.create(w, h)
                fragments.append(current)
                position = (0, 0)

        current.blit_frame(
            position, image, number, store=(image, res.median)
        )
        prev_regions = res.regions

    for frag in fragments:
        frag.normalize()
    return fragments
