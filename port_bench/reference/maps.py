"""What a map build of a generated session must give, worked out from
the session alone (its frames and the camera path it was rendered
along), in plain NumPy and PyTorch.  Imports nothing of the program.

- ``expected_crop``: the action area the window scan must find: inside
  the HUD and the border, one pixel in at the top left and two at the
  bottom right, as the reference's window rules place it (aws.hpp).
- ``expected_motion``: each frame's offset (the camera's step from the
  frame before) and whether it matches: every frame but the first, the
  noise frame and the frame after it.
- ``vote_canvas``: every frame's colour votes at its canvas position,
  ``[16, H, W]``, the sum that collect's blit pass and splice's merges
  make of a fragment.
- ``foreground.filtered_canvas``: the votes of the frames' background
  pixels alone, the canvas the foreground stage makes of a fragment.
- ``clean.clean_canvas``: the map of a canvas.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DEPTH = 16


def expected_crop(h: int, w: int, hud_rows: int, border: int
                  ) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) of the crop."""
    return (border + 1, max(hud_rows, border) + 1, w - border - 2,
            h - border - 2)


def expected_motion(path: Sequence[Tuple[int, int]],
                    noise_at: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets [N, 2] int64, matched [N] bool): offset t = camera t -
    camera t-1 (the keypoint convention, prev point - curr point)."""
    p = np.asarray(path, np.int64)
    offsets = np.zeros_like(p)
    offsets[1:] = p[1:] - p[:-1]
    matched = np.ones(len(p), bool)
    matched[0] = False
    if noise_at is not None:
        matched[noise_at] = False
        if noise_at + 1 < len(p):
            matched[noise_at + 1] = False
    return offsets, matched


def add_votes(flat: torch.Tensor, frames: torch.Tensor, pos: torch.Tensor,
              shape: Tuple[int, int], keep: Optional[torch.Tensor] = None
              ) -> None:
    """Add to ``flat`` (``[16 * H * W]`` int64) one vote a pixel of
    ``frames`` ``[N, h, w]`` at canvas positions ``pos`` ``[N, 2]``
    (x, y), or only where ``keep`` ``[N, h, w]`` is True."""
    _, h, w = frames.shape
    ch, cw = shape
    dev = frames.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    idx = (frames.to(torch.int64) * (ch * cw)
           + (pos[:, 1, None, None] + ys) * cw + (pos[:, 0, None, None] + xs))
    idx = idx.reshape(-1) if keep is None else idx[keep]
    flat.index_add_(0, idx, torch.ones(idx.numel(), dtype=torch.int64,
                                       device=dev))


def vote_canvas(frames: torch.Tensor, positions: Sequence[Tuple[int, int]],
                shape: Tuple[int, int], chunk: int = 64,
                bits: int = 16) -> torch.Tensor:
    """``[16, H, W]`` int64 votes of ``frames`` ``[N, h, w]`` (uint8, on
    any device) at canvas ``positions`` (x, y), wrapped at ``2**bits``
    as a counter of that width wraps."""
    ch, cw = shape
    dev = frames.device
    flat = torch.zeros(DEPTH * ch * cw, dtype=torch.int64, device=dev)
    pos = torch.as_tensor(np.asarray(positions, np.int64).reshape(-1, 2),
                          device=dev)
    for i in range(0, len(frames), chunk):
        add_votes(flat, frames[i:i + chunk], pos[i:i + chunk], shape)
    return (flat & ((1 << bits) - 1)).view(DEPTH, ch, cw)


def blend(canvas: torch.Tensor) -> np.ndarray:
    """The canvas's background: the colour with the most votes (the first
    of equal maxima), 0 where none (fgm.hpp:115-135)."""
    image = torch.argmax(canvas, dim=0)
    mask = canvas.amax(dim=0) > 0
    return (image * mask).to(torch.uint8).cpu().numpy()


def differing(got: np.ndarray, want: np.ndarray) -> int:
    """Elements that differ; every element of the larger, where the
    shapes differ."""
    if got.shape != want.shape:
        return max(got.size, want.size, 1)
    return int(np.count_nonzero(got != want))


def maps_differ(got: List[np.ndarray], want: List[np.ndarray]) -> int:
    """Pixels by which two lists of maps differ."""
    n = sum(differing(g, w) for g, w in zip(got, want))
    for extra in (got[len(want):] + want[len(got):]):
        n += max(extra.size, 1)
    return n
