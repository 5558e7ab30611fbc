"""Keypoints and their grid regions, restated in PyTorch from the
extractor's rules (kpe.hpp:84-340), for the bytes that the region tables
must move.  Imports nothing of the program.

- ``keypoints``: ``[B, H, W]`` bool, True at a keypoint: a processed
  centre (``x in [2, W-2)``, ``y in [2, H-4)``) whose luminance rank
  differs from its 3x3 median, which differs from its 5x5 median (the
  largest rank with at least 4, resp. 12, pixels of the window at or
  above it).
- ``region_spans``: ``(x_lo, x_hi, y_lo, y_hi)`` of each grid region in
  index order ``xs * grid_h + ys``, overlap bands in both sections, the
  first processed row in section 0, the two bottom rows never processed,
  cut to the frame (kpe.hpp:149-306, kpr.hpp:40-91).
- ``region_counts``: ``[B, R]`` keypoints in each region.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from port_bench.reference import frozen

KH = 2
HALF3 = 4     # kpe.hpp:313
HALF5 = 12    # kpe.hpp:317


def _median(ordered: torch.Tensor, k: int, half: int) -> torch.Tensor:
    """``[B, H-k+1, W-k+1]``: the median rank of each k x k window."""
    out = torch.zeros((ordered.shape[0], ordered.shape[1] - k + 1,
                       ordered.shape[2] - k + 1), dtype=torch.int64,
                      device=ordered.device)
    for r in range(1, 16):
        ge = (ordered >= r).to(torch.int32)
        rows = sum(ge[:, i:ge.shape[1] - k + 1 + i] for i in range(k))
        count = sum(rows[:, :, j:rows.shape[2] - k + 1 + j]
                    for j in range(k))
        out = torch.where(count >= half, r, out)
    return out


def keypoints(frames: torch.Tensor) -> torch.Tensor:
    b, h, w = frames.shape
    n2o = torch.as_tensor(frozen.NATIVE_TO_ORDERED,
                          device=frames.device).long()
    ordered = n2o[frames.long()]
    y_hi, x_hi = h - KH - 2, w - KH
    p1 = ordered[:, KH:y_hi, KH:x_hi]
    # a 3x3 window centred at (y, x) starts at (y-1, x-1), a 5x5 at (y-2, x-2)
    p3 = _median(ordered, 3, HALF3)[:, KH - 1:y_hi - 1, KH - 1:x_hi - 1]
    p5 = _median(ordered, 5, HALF5)[:, 0:y_hi - KH, 0:x_hi - KH]
    out = torch.zeros((b, h, w), dtype=torch.bool, device=frames.device)
    out[:, KH:y_hi, KH:x_hi] = (p1 != p3) & (p3 != p5)
    return out


def region_spans(width: int, height: int, grid_w: int, grid_h: int,
                 overlap: int) -> List[Tuple[int, int, int, int]]:
    rw = width // grid_w - overlap // 2
    xs = []
    for s in range(grid_w):
        lo = KH if s == 0 else KH + s * (rw + overlap) - overlap
        hi = width - KH if s == grid_w - 1 else KH + (s + 1) * (rw + overlap)
        xs.append((lo, min(hi, width)))
    rh = height // grid_h - overlap // 2
    ys = []
    for s in range(grid_h):
        lo = KH if s == 0 else KH + 1 + s * (rh + overlap) - overlap
        hi = height - KH - 2 if s == grid_h - 1 else (
            KH + 1 + (s + 1) * (rh + overlap))
        ys.append((lo, min(hi, height)))
    return [(x0, x1, y0, y1) for x0, x1 in xs for y0, y1 in ys]


def region_counts(points: torch.Tensor,
                  spans: List[Tuple[int, int, int, int]]) -> torch.Tensor:
    return torch.stack([points[:, y0:y1, x0:x1].sum(dim=(1, 2))
                        for x0, x1, y0, y1 in spans], dim=1)
