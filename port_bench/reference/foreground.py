"""The foreground filter of a fragment, restated in PyTorch over a batch
of frames at once: each frame's foreground mask, by the rules that
``frozen.foreground_mask`` states one frame at a time (fde.hpp:19-146),
and the canvas of the votes that the frames' background pixels cast
(fdf.hpp:40-75).  Imports nothing of the program.

- ``median3``: the extractor's 3x3 median in native codes (kpe.hpp:308-340).
- ``components``: 4-connected equal-value components of the interior
  ``[1, H-2) x [1, W-1)``, each named by the flat index of its first
  pixel in row-major order, found by hooking every component's root to
  the least label next to it and jumping pointers until nothing moves.
- ``foreground_masks``: the components seeded at pixels that differ from
  the background, no larger than 1/area_divisor of the frame, painted,
  then each one's box filled from its quirky left (cdt.hpp:183-190).
- ``filtered_canvas``: ``[16, H, W]`` votes of every frame where its mask
  is 0, wrapped at ``2**bits``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import frozen
from port_bench.reference import maps

HALF3 = 4     # kpe.hpp:313
KH = 2        # kernel half


def median3(frames: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` uint8 medians of ``frames``: the largest luminance
    rank with at least HALF3 pixels of the 3x3 window at or above it, on
    the centres ``x in [2, W-2)``, ``y in [2, H-4)``; 0 elsewhere."""
    b, h, w = frames.shape
    dev = frames.device
    n2o = torch.as_tensor(frozen.NATIVE_TO_ORDERED, device=dev).long()
    o2n = torch.as_tensor(frozen.ORDERED_TO_NATIVE, device=dev)
    ordered = n2o[frames.long()]
    p3 = torch.zeros((b, h - 2, w - 2), dtype=torch.int64, device=dev)
    for r in range(1, 16):
        ge = (ordered >= r).to(torch.int32)
        rows = ge[:, :-2] + ge[:, 1:-1] + ge[:, 2:]
        count = rows[:, :, :-2] + rows[:, :, 1:-1] + rows[:, :, 2:]
        p3 = torch.where(count >= HALF3, r, p3)
    out = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    out[:, KH:h - KH - 2, KH:w - KH] = o2n[
        p3[:, KH - 1:h - KH - 3, KH - 1:w - KH - 1]]
    return out


def interior_of(b: int, h: int, w: int, dev) -> torch.Tensor:
    inside = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    inside[:, 1:h - 2, 1:w - 1] = True
    return inside


def components(image: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` int64: each interior pixel's component, named by the
    flat index (over the whole batch) of its first pixel in row-major
    order; every other pixel names itself and joins nothing."""
    b, h, w = image.shape
    dev = image.device
    n = b * h * w
    inside = interior_of(b, h, w, dev)
    same_x = (image[:, :, 1:] == image[:, :, :-1]) & inside[:, :, 1:] & \
        inside[:, :, :-1]
    same_y = (image[:, 1:] == image[:, :-1]) & inside[:, 1:] & inside[:, :-1]
    big = torch.tensor(n, dtype=torch.int64, device=dev)
    lab = torch.arange(n, dtype=torch.int64, device=dev)
    while True:
        grid = lab.view(b, h, w)
        least = grid.clone()
        least[:, :, 1:] = torch.minimum(
            least[:, :, 1:], torch.where(same_x, grid[:, :, :-1], big))
        least[:, :, :-1] = torch.minimum(
            least[:, :, :-1], torch.where(same_x, grid[:, :, 1:], big))
        least[:, 1:] = torch.minimum(
            least[:, 1:], torch.where(same_y, grid[:, :-1], big))
        least[:, :-1] = torch.minimum(
            least[:, :-1], torch.where(same_y, grid[:, 1:], big))
        least = least.view(-1)
        # every label lies in its pixel's component and never above the
        # pixel's index: hook each root to the least label next to any of
        # its pixels, then jump to the root
        nxt = torch.minimum(lab.scatter_reduce(0, lab, least, "amin"), least)
        while True:
            jumped = nxt[nxt]
            if torch.equal(jumped, nxt):
                break
            nxt = jumped
        if torch.equal(nxt, lab):
            return lab.view(b, h, w)
        lab = nxt


def quirky_lefts(labels: torch.Tensor) -> torch.Tensor:
    """``[B*H*W]`` int64 indexed by label: the enclosure's ``lower_``
    (cdt.hpp:183-190 with ctr.hpp:96-109), the least run-endpoint x that
    is not a strict running maximum of the endpoints before it in
    row-major order, or W when there is none."""
    b, h, w = labels.shape
    dev = labels.device
    n = b * h * w
    inside = interior_of(b, h, w, dev)
    diff_l = torch.ones_like(inside)
    diff_l[:, :, 1:] = labels[:, :, 1:] != labels[:, :, :-1]
    diff_r = torch.ones_like(inside)
    diff_r[:, :, :-1] = labels[:, :, :-1] != labels[:, :, 1:]
    ends = ((diff_l | diff_r) & inside).view(-1).nonzero().squeeze(1)
    out = torch.full((n,), w, dtype=torch.int64, device=dev)
    if ends.numel() == 0:
        return out
    lab = labels.view(-1)[ends]
    lab, order = torch.sort(lab, stable=True)
    xs = ends[order] % w
    starts = torch.ones_like(lab, dtype=torch.bool)
    starts[1:] = lab[1:] != lab[:-1]
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    base = seg * (w + 1)
    running = torch.cummax(base + xs, 0).values - base
    prior = torch.zeros_like(running)
    prior[1:] = running[:-1]
    prior[starts] = 0
    take = xs <= prior
    return out.scatter_reduce(0, lab[take], xs[take], "amin")


def foreground_masks(background: torch.Tensor, frames: torch.Tensor,
                     positions: torch.Tensor, area_divisor: int = 5
                     ) -> torch.Tensor:
    """``[B, H, W]`` bool, True = foreground, of ``frames`` ``[B, H, W]``
    uint8 at canvas ``positions`` ``[B, 2]`` (x, y) against
    ``background`` ``[HB, WB]`` uint8."""
    b, h, w = frames.shape
    dev = frames.device
    n = b * h * w
    pos = positions.to(torch.int64)
    ys = pos[:, 1, None, None] + torch.arange(h, device=dev)[None, :, None]
    xs = pos[:, 0, None, None] + torch.arange(w, device=dev)[None, None, :]
    changed = (background[ys, xs] != frames).view(-1)
    labels = components(median3(frames))
    inside = interior_of(b, h, w, dev).view(-1)
    lab = labels.view(-1)[inside]
    py = torch.arange(h, device=dev).view(1, h, 1).expand(b, h, w)
    px = torch.arange(w, device=dev).view(1, 1, w).expand(b, h, w)
    py, px = py.reshape(-1)[inside], px.reshape(-1)[inside]
    area = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, lab, torch.ones_like(lab))
    right = torch.full((n,), -1, dtype=torch.int64, device=dev
                       ).scatter_reduce(0, lab, px, "amax")
    top = torch.full((n,), h, dtype=torch.int64, device=dev
                     ).scatter_reduce(0, lab, py, "amin")
    bottom = torch.full((n,), -1, dtype=torch.int64, device=dev
                        ).scatter_reduce(0, lab, py, "amax")
    seeded = torch.zeros(n, dtype=torch.bool, device=dev)
    seeded[lab[changed[inside]]] = True
    kept = seeded & (area > 0) & (area <= (h * w) // area_divisor)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[inside] = kept[lab]
    # each kept box [top, bottom) x [left, right) whose left lies inside
    # the frame and before its right, by a table of corner signs summed
    # down and across
    left = quirky_lefts(labels)
    roots = (kept & (left < w) & (left < right)).nonzero().squeeze(1)
    frame = roots // (h * w)
    stride = (h + 1) * (w + 1)
    corners = torch.zeros(b * stride, dtype=torch.int64, device=dev)
    for yy, xx, sign in ((top, left, 1), (top, right, -1),
                         (bottom, left, -1), (bottom, right, 1)):
        corners.index_add_(
            0, frame * stride + yy[roots] * (w + 1) + xx[roots],
            torch.full_like(roots, sign))
    boxes = corners.view(b, h + 1, w + 1).cumsum(1).cumsum(2)[:, :h, :w]
    return mask.view(b, h, w) | (boxes > 0)


def filtered_canvas(frames: torch.Tensor,
                    positions: Sequence[Tuple[int, int]],
                    shape: Tuple[int, int], background: torch.Tensor,
                    area_divisor: int = 5, chunk: int = 64,
                    bits: int = 16) -> torch.Tensor:
    """``[16, H, W]`` int64 votes of ``frames`` ``[N, h, w]`` at canvas
    ``positions`` (x, y), each pixel voting where its frame's foreground
    mask against ``background`` is 0, wrapped at ``2**bits``."""
    dev = frames.device
    pos = torch.as_tensor(np.asarray(positions, np.int64).reshape(-1, 2),
                          device=dev)
    flat = torch.zeros(maps.DEPTH * shape[0] * shape[1], dtype=torch.int64,
                       device=dev)
    for i in range(0, len(frames), chunk):
        f, p = frames[i:i + chunk], pos[i:i + chunk]
        fg = foreground_masks(background, f, p, area_divisor)
        maps.add_votes(flat, f, p, shape, keep=~fg)
    return (flat & ((1 << bits) - 1)).view(maps.DEPTH, *shape)
