"""Contour-level motion detection (port of remap_tpu/ops/motion.py, the
functional form of the reference's mod.hpp).

The reference ships an unused contour motion detector (mod.hpp:15-245):
given two frames and a global camera adjustment, it

1. marks contours whose aligned cells changed colour or edge flags
   (mod.hpp:125-142),
2. for every marked contour's edge cell, searches a window around the
   aligned previous position for cells with identical edge flags and
   colour, voting the displacement (mod.hpp:191-208),
3. declares a contour moving when its best displacement is nonzero and
   outvotes half the contour's perimeter (mod.hpp:214-237).

Contours are the component labels of ``curr``: K4a
(``ops.kernels.cc.label_components_batch``, ``csrc/cc.cu``) on CUDA
tensors, its plain version on CPU tensors, equal to the JAX package's
``ops/cc.py label_components``.  The rest is plain torch ops: edge flags
from shifted compares, the window search as a static shift loop, votes by
per-contour ``index_add_``.  Boundaries clip the window, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from remap_tpu_torch.device import get_device
from remap_tpu_torch.ops.kernels import cc as kcc


def edge_flags(image: torch.Tensor) -> torch.Tensor:
    """[H, W] uint8 edge bitmask: 1=left 2=right 4=top 8=bottom set when
    the neighbour differs or lies outside the interior (ctr.hpp:64-70,
    cte.hpp:119-147)."""
    h, w = image.shape
    dev = image.device
    img = image.to(torch.int32)
    pad = F.pad(img, (1, 1, 1, 1), value=-1)

    def nb(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    out = ((nb(0, -1) != img).to(torch.int32)
           | ((nb(0, 1) != img).to(torch.int32) << 1)
           | ((nb(-1, 0) != img).to(torch.int32) << 2)
           | ((nb(1, 0) != img).to(torch.int32) << 3))
    # border-adjacent neighbours count as edges (horizon, cte.hpp:149-166)
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    horizon = ((xs == 1).to(torch.int32)
               | ((xs == w - 2).to(torch.int32) << 1)
               | ((ys == 1).to(torch.int32) << 2)
               | ((ys == h - 2).to(torch.int32) << 3))
    out = out | horizon
    interior = torch.zeros((h, w), dtype=torch.bool, device=dev)
    interior[1:-1, 1:-1] = True
    return torch.where(interior, out, 0).to(torch.uint8)


class MotionResult(NamedTuple):
    offset: torch.Tensor   # [L, 2] int32 best displacement per label slot
    moving: torch.Tensor   # [L] bool
    votes: torch.Tensor    # [L] int32 winning vote count


def detect(prev_image, curr_image, adjustment, half: int = 4,
           device=None) -> MotionResult:
    """Per-contour motion of ``curr`` vs ``prev`` ([H, W] uint8 each);
    label slots ``L = H*W`` are the flat-index component labels of
    ``curr``.  ``adjustment`` is the global camera motion (dx, dy), two
    ints.  Tensors run on their own device; arrays run on ``device``,
    CUDA unless the caller names the CPU (raises without CUDA)."""
    if isinstance(curr_image, torch.Tensor) and device is None:
        dev = curr_image.device
    else:
        dev = get_device(device)
    prev = torch.as_tensor(prev_image, device=dev)
    curr = torch.as_tensor(curr_image, device=dev)
    if prev.shape != curr.shape or curr.dim() != 2:
        raise ValueError(f"prev {tuple(prev.shape)} and curr "
                         f"{tuple(curr.shape)}: expected two [H, W] frames")
    ax, ay = (int(a) for a in torch.as_tensor(adjustment).tolist())
    h, w = curr.shape
    big = h * w

    labels = kcc.label_components_batch(curr.contiguous()[None])[0]
    labels = labels.reshape(-1)
    safe = labels.clamp(0, big - 1).long()
    interior = labels < big

    curr_i = curr.to(torch.int32).reshape(-1)
    e_curr = edge_flags(curr).to(torch.int32).reshape(-1)
    # prev and its edge flags padded by half + 64 with -1, which matches
    # no colour and no flags; the shifts clip to that pad
    m = half + 64
    pcol = F.pad(prev.to(torch.int32), (m, m, m, m), value=-1)
    pedge = F.pad(edge_flags(prev).to(torch.int32), (m, m, m, m), value=-1)

    def shift_prev(arr, dx, dy):
        """prev sampled at curr position + adjustment + (dx, dy)."""
        sx = min(max(ax + dx, -m), m)
        sy = min(max(ay + dy, -m), m)
        return arr[m + sy:m + sy + h, m + sx:m + sx + w].reshape(-1)

    def segment_sum(flags):
        return torch.zeros(big, dtype=torch.int32, device=dev).index_add_(
            0, safe, flags.to(torch.int32))

    changed = ((shift_prev(pcol, 0, 0) != curr_i)
               | (shift_prev(pedge, 0, 0) != e_curr))
    # a segment max of 0/1 values: empty segments stay 0, so False
    marked = torch.zeros(big, dtype=torch.int32, device=dev).scatter_reduce(
        0, safe, (interior & changed).to(torch.int32), "amax",
        include_self=True) > 0

    edge = (e_curr > 0) & interior
    is_edge_cell = edge & marked[safe]
    perimeter = segment_sum(edge)

    # static window loop, dy outer, dx inner; a strict > keeps the first
    # maximum: vote (dx, dy) where prev at +adj+(dx, dy) matches.  prev
    # matches at curr + (dx, dy), so the contour's forward motion since
    # the previous frame is -(dx, dy)
    window = [(dx, dy) for dy in range(-half, half + 1)
              for dx in range(-half, half + 1)]
    # the same offsets made on the device (a host copy would wait for it)
    i = torch.arange(len(window), dtype=torch.int32, device=dev)
    offsets = torch.stack([half - i % (2 * half + 1),
                           half - i // (2 * half + 1)], dim=-1)
    best_votes = torch.zeros(big, dtype=torch.int32, device=dev)
    best_off = torch.zeros((big, 2), dtype=torch.int32, device=dev)
    for (dx, dy), off in zip(window, offsets):
        match = (is_edge_cell & (shift_prev(pcol, dx, dy) == curr_i)
                 & (shift_prev(pedge, dx, dy) == e_curr))
        votes = segment_sum(match)
        better = votes > best_votes
        best_off = torch.where(better[:, None], off, best_off)
        best_votes = torch.where(better, votes, best_votes)

    moving = (best_votes > perimeter // 2) & (best_off != 0).any(dim=-1)
    return MotionResult(offset=best_off, moving=moving, votes=best_votes)
