"""Spec: the full pipeline (mpb.hpp:28-41 + main.cpp:246-260).

The port's copy of remap_tpu/spec/pipeline.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

window scan -> cropped re-feed -> collect -> splice -> foreground filter ->
artifact clean -> per-fragment native-code images (callers palette-map to
RGB for PNG output).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.spec import arf, aws, fdf, fgs, frc


def build(
    frames: Sequence[np.ndarray],
    artifact_size: int = 15,
    artifact_dev: float = 2.0,
    window: Optional[aws.WindowInfo] = None,
) -> List[np.ndarray]:
    if window is None:
        window = aws.scan(iter(frames))
    if window is None:
        return []
    crop = window.crop
    cropped = [f[crop.top : crop.bottom, crop.left : crop.right] for f in frames]

    h, w = cropped[0].shape
    layout = make_layout(w, h, frc.GRID_W, frc.GRID_H, frc.OVERLAP)

    fragments = frc.collect(cropped, layout)
    spliced = fgs.splice(fragments)
    filtered = fdf.filter_fragments(spliced, (h, w))

    results = []
    for frag in filtered:
        image, mask = frag.blend()
        cleaned = arf.filter_fragment(
            frag.dots, image, mask, size=artifact_size, dev=artifact_dev
        )
        results.append(frag.crop_margins(cleaned))
    return results
