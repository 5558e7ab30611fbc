"""What the streaming step must give on a clip played over and over, from
the clip's camera path alone, in plain NumPy and PyTorch.  Imports
nothing of the program.

Stream frame k is clip frame k mod n.  Its offset is the camera's step
from the frame before (0 for the stream's first frame, the only one that
does not match), and its position the sum of the offsets.  The stitch
window of ``h + 2 pad`` by ``w + 2 pad`` follows the camera: before each
batch is voted in, on each axis where the batch's span leaves the window
but fits in it, the window's origin moves to centre the span (the votes
move with it, and those that fall out are lost).  Every frame votes its
pixels' colours at its position less the origin, clamped to the window.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

DEPTH = 16


@dataclasses.dataclass
class Stream:
    offsets: np.ndarray          # [total, 2] int64
    matched: np.ndarray          # [total] bool
    steps: List[Tuple[Tuple[int, int], np.ndarray]]  # (shift, [b, 2] pos)
    anchor: Tuple[int, int]
    position: Tuple[int, int]
    window: Tuple[int, int]      # (height, width) of the stitch window
    frame_hw: Tuple[int, int]
    batch: int


def stream(path: Sequence[Tuple[int, int]], total: int, batch: int,
           pad: int, w: int, h: int) -> Stream:
    p = np.asarray(path, np.int64)
    n = len(p)
    k = np.arange(total)
    # the walk is a palindrome: the clip's last frame is one step from its
    # first, and every pass starts where the last began
    pos = p[k % n] - p[0]
    offsets = np.zeros((total, 2), np.int64)
    offsets[1:] = pos[1:] - pos[:-1]
    matched = k > 0
    limit = np.array([2 * pad, 2 * pad], np.int64)
    anchor = np.array([-pad, -pad], np.int64)
    steps = []
    for lo_i in range(0, total, batch):
        bp = pos[lo_i:lo_i + batch]
        lo, hi = bp.min(axis=0), bp.max(axis=0)
        rel_lo, rel_hi = lo - anchor, hi - anchor
        fits = hi - lo <= limit
        out = (rel_lo < 0) | (rel_hi > limit)
        centred = np.floor_divide(rel_lo + rel_hi - limit, 2)
        delta = np.where(out & fits, centred, 0)
        anchor = anchor + delta
        anchored = np.minimum(np.maximum(bp - anchor, 0), limit)
        steps.append(((int(delta[0]), int(delta[1])), anchored))
    return Stream(offsets=offsets, matched=matched, steps=steps,
                  anchor=(int(anchor[0]), int(anchor[1])),
                  position=(int(pos[-1][0]), int(pos[-1][1])),
                  window=(h + 2 * pad, w + 2 * pad), frame_hw=(h, w),
                  batch=batch)


def _shift(atlas: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[c, y, x] = atlas[c, y + dy, x + dx], zero outside."""
    out = torch.zeros_like(atlas)
    _, hh, ww = atlas.shape
    ys, ye = max(0, -dy), min(hh, hh - dy)
    xs, xe = max(0, -dx), min(ww, ww - dx)
    if ye > ys and xe > xs:
        out[:, ys:ye, xs:xe] = atlas[:, ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def _vote(atlas: torch.Tensor, frames: torch.Tensor, entries: np.ndarray,
          chunk: int = 64) -> None:
    """Add ``count`` votes of clip frame ``f`` at (x, y) for each entry
    row (f, x, y, count)."""
    _, hh, ww = atlas.shape
    _, h, w = frames.shape
    dev = atlas.device
    flat = atlas.view(-1)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    e = torch.as_tensor(entries, device=dev)
    for i in range(0, len(e), chunk):
        part = e[i:i + chunk]
        f = frames[part[:, 0]].to(torch.int64)
        idx = (f * (hh * ww) + (part[:, 2, None, None] + ys) * ww
               + (part[:, 1, None, None] + xs))
        weight = part[:, 3, None, None].expand_as(idx)
        flat.index_add_(0, idx.reshape(-1), weight.reshape(-1))


def atlas(frames: np.ndarray, want: Stream, device, bits: int = 16
          ) -> torch.Tensor:
    """``[16, H + 2 pad, W + 2 pad]`` int64: the window's votes after the
    stream, wrapped at ``2**bits`` as a counter of that width wraps."""
    n = len(frames)
    dev = torch.device(device)
    clip = torch.as_tensor(frames, device=dev)
    ah, aw = want.window
    out = torch.zeros((DEPTH, ah, aw), dtype=torch.int64, device=dev)
    group: List[np.ndarray] = []

    def flush():
        if not group:
            return
        rows = np.concatenate(group)
        uniq, counts = np.unique(rows, axis=0, return_counts=True)
        _vote(out, clip, np.concatenate([uniq, counts[:, None]], axis=1))
        group.clear()

    b = want.batch
    for j, ((dx, dy), anchored) in enumerate(want.steps):
        if dx or dy:
            flush()
            out = _shift(out, dx, dy)
        f = (np.arange(j * b, j * b + len(anchored)) % n)[:, None]
        group.append(np.concatenate([f, anchored], axis=1))
    flush()
    return out & ((1 << bits) - 1)
