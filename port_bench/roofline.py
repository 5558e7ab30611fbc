"""The bytes each kernel's function must move, counted from its shapes
and its data, and the card's peak, for the ``*_roofline`` metrics.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again, and where the work depends on the data,
what these inputs need (the arithmetic of the port's card checks,
frozen here so that it does not move with the program):

- extract (K1): the frames (1 byte a pixel) in; the medians (1), the
  keypoint weights (1) and the packed codes (4 x int32) out: 19 bytes a
  pixel.
- tables (K2): every weight byte (1 a pixel) in; the codes of the
  keypoints the tables keep (min(count, K) a region, the count from
  ``reference/keypoints.py``) and of each region's first pixel, 16 bytes
  each, in; the tables out: K entries a region of a code (16 bytes), an
  (x, y) pair of int32 and a valid byte, and a region's three int32
  counts by weight and its overflow byte.
- blit (K3): the frames in; each bin that takes a vote read and written
  (int32), the frames' other bins untouched.
"""

from __future__ import annotations

import numpy as np
import torch

#: H100 SXM HBM3 bandwidth, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
CODE_BYTES = 16
DEPTH = 16


def extract_bytes(shape) -> int:
    t, h, w = shape
    return t * h * w * (1 + 1 + 1 + CODE_BYTES)


ENTRY_BYTES = CODE_BYTES + 2 * 4 + 1
REGION_BYTES = 3 * 4 + 1


def tables_bytes(pixels: int, counts: torch.Tensor, capacity: int) -> int:
    """K2's bytes on ``pixels`` weight bytes whose regions hold
    ``counts`` keypoints (one number a frame and region)."""
    regions = counts.numel()
    kept = int(counts.clamp(max=capacity).sum())
    return (pixels + (kept + regions) * CODE_BYTES
            + regions * (capacity * ENTRY_BYTES + REGION_BYTES))


def voted_bins(frames: torch.Tensor, positions: np.ndarray) -> int:
    """Distinct (colour, y, x) bins that ``frames`` [T, h, w] vote into at
    ``positions`` [T, 2] (x, y)."""
    t, h, w = frames.shape
    dev = frames.device
    pos = torch.as_tensor(positions - positions.min(axis=0), device=dev)
    span_w = int(pos[:, 0].max()) + w
    span_h = int(pos[:, 1].max()) + h
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    key = (frames.to(torch.int64) * (span_h * span_w)
           + (pos[:, 1, None, None] + ys) * span_w + (pos[:, 0, None, None]
                                                      + xs))
    seen = torch.zeros(DEPTH * span_h * span_w, dtype=torch.bool,
                       device=dev)
    seen[key.reshape(-1)] = True
    return int(seen.sum())


def blit_bytes(frames: torch.Tensor, positions: np.ndarray) -> int:
    return frames.numel() + 2 * 4 * voted_bins(frames, positions)


def share(bytes_: float, seconds: float) -> float:
    """Percent of the bandwidth roofline: the least time over the time."""
    return 100.0 * bytes_ / HBM_BYTES_PER_S / seconds
