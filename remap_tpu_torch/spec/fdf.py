"""Spec: foreground filtering pass (fdf.hpp).

The port's copy of remap_tpu/spec/fdf.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

Second pass over all stored frames: each fragment is blended into a static
background; every frame is diffed against it, foreground contours are
masked out, and the frame is re-blitted (votes only where the mask is 0)
into a fresh fragment of the background's dimensions (fdf.hpp:40-75).
"""

from __future__ import annotations

from typing import List, Tuple

from remap_tpu_torch.spec import fde
from remap_tpu_torch.spec.fgm import Fragment


def filter_fragments(
    fragments: List[Fragment], frame_dims: Tuple[int, int]
) -> List[Fragment]:
    """frame_dims = (height, width)."""
    results: List[Fragment] = []
    for frag in fragments:
        background, _ = frag.blend()
        h, w = background.shape
        result = Fragment.create_fixed(w, h, zero=frag.zero)
        results.append(result)

        for rec in frag.frames:
            assert rec.image is not None and rec.median is not None
            pos = (
                rec.position[0] - result.zero[0],
                rec.position[1] - result.zero[1],
            )
            cres, kept = fde.extract(background, rec.image, rec.median, pos)
            mask = fde.foreground_mask(cres, kept, rec.image.shape)
            result.blit_frame(rec.position, rec.image, rec.number, mask=mask)
    return results
