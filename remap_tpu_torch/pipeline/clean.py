"""The artifact-clean stage (port of remap_tpu/pipeline/clean.py,
mpb.hpp:79-94).

Per fragment: blend, the rare-pattern heatmap and the conditional Gaussian
colour re-selection (``ops.arf``), then the crop of the canvas's empty
margins (arf.hpp:314-328).  Fragments run one after another on their
device; the JAX package's round robin over devices is one device here.
"""

from __future__ import annotations

from typing import List

import numpy as np

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.ops import arf as arf_ops
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.pipeline.state import Fragment


def margins_of(dots: np.ndarray) -> tuple:
    """(left, top, right, bottom) empty margins of an ``[h, w, 16]`` host
    canvas; an empty canvas gives ``(w, h, w, h)``."""
    nonempty = dots.any(axis=2)
    h, w = nonempty.shape
    if not nonempty.any():
        return (w, h, w, h)
    cols = np.nonzero(nonempty.any(axis=0))[0]
    rows = np.nonzero(nonempty.any(axis=1))[0]
    return (int(cols[0]), int(rows[0]), int(w - 1 - cols[-1]),
            int(h - 1 - rows[-1]))


def margins_of_fragment(frag: Fragment) -> tuple:
    """Empty margins of a fragment's canvas, on whichever side the canvas
    lives (one ``[4]`` fetch for a device canvas)."""
    if frag.dots_dev is not None:
        h, w = frag.shape
        return tuple(int(v) for v in
                     atlas_ops.margins(frag.dots_dev[:, :h, :w]).tolist())
    return margins_of(frag.dots)


def clean_fragment(frag: Fragment, cfg: PipelineConfig,
                   device=None) -> np.ndarray:
    """The cleaned, margin-cropped ``[h', w']`` uint8 map of one fragment
    (its canvas goes to ``device`` when it has none there yet)."""
    h, w = frag.shape
    dots = frag.device_dots(device)[:, :h, :w]
    image, mask = atlas_ops.blend(dots)
    out = arf_ops.filter_fragment(
        dots, image, mask, size=cfg.artifact_filter_size,
        dev=cfg.artifact_filter_dev, threshold=cfg.artifact_heat_threshold)
    left, top, right, bottom = margins_of_fragment(frag)
    return out[top:h - bottom, left:w - right]


def clean(fragments: List[Fragment], cfg: PipelineConfig,
          device=None) -> List[np.ndarray]:
    return [clean_fragment(f, cfg, device) for f in fragments]
