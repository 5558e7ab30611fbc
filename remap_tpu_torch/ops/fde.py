"""Foreground masks of stored frames against their fragment's background
(port of remap_tpu/ops/fde.py: ``equality_mask``, ``_seg_cummax``,
``_masks_from_stats_sorted``, ``extract_batch``).

Per frame (fde.hpp): the changed mask against the blended background at
the frame's position, the equal-valued components of the frame's median
image (K4), and the foreground: each component with a changed pixel and
an area of at most ``frame_area / area_divisor`` (fde.hpp:94-100), painted
as its exact pixels plus its bbox without the last row and column
(fde.hpp:122-146 treats inclusive bounds as exclusive), the bbox's left
edge being the reference enclosure's quirky ``lower_`` (cdt.hpp:183-190).

One route serves every frame size: K4's labels and stats, then one sort
per frame and segmented scans.  The JAX package picks among three
assemblies by TPU memory ceilings and int32 encode limits; here every
encode is int64, and the bbox fill is dense (four corner scatters per
kept root into ``[B, H+1, W+1]``, then two prefix sums), so nothing
branches on the data and ``extract_batch`` never waits for the device.
"""

from __future__ import annotations

import torch

from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops.kernels import cc as kcc
from remap_tpu_torch.utils import profiling


def equality_mask(background: torch.Tensor, frames: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """``[B, H, W]`` bool, True where each frame equals the background
    ``[HB, WB]`` at its position ``(x, y)``.  Starts are clamped so the
    window fits, as ``lax.dynamic_slice`` clamps them."""
    _, h, w = frames.shape
    hb, wb = background.shape
    dev = frames.device
    pos = positions.to(torch.int64)
    y0 = pos[:, 1].clamp(0, hb - h)
    x0 = pos[:, 0].clamp(0, wb - w)
    ys = y0[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    xs = x0[:, None, None] + torch.arange(w, device=dev)[None, None, :]
    return background[ys, xs] == frames


def seg_cummax(vals: torch.Tensor, seg: torch.Tensor,
               base: int) -> torch.Tensor:
    """Inclusive running max along the last axis within segments: ``vals``
    in ``[0, base)``, ``seg`` the nondecreasing segment index.  The encode
    ``seg * base + val`` never leaks across segments; int64 keeps it
    exact at any frame size."""
    enc = seg.to(torch.int64) * base
    return torch.cummax(enc + vals.to(torch.int64), dim=-1).values - enc


def _rev(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-1,))


def masks_from_stats_sorted(labels: torch.Tensor, stats: torch.Tensor,
                            area_limit: int) -> torch.Tensor:
    """``[B, H, W]`` bool foreground from K4's labels and ``[B, 5, H, W]``
    stats (minx, miny, maxx, maxy, has_changed).

    Each frame's pixels are sorted by (label, pixel index), one int64 key
    ``label * H*W + index``; the keys are unique (the index is), so any
    sort gives the one order and stability does not matter.  Every
    component is then a run in row-major order: its area is the run's
    length, its root (first pixel) the run's start, and the quirky
    fill-left (the minimum over run-endpoint xs that are not strict
    running maxima in row-major order) a segmented exclusive cummax and a
    reverse segmented min."""
    b, h, w = labels.shape
    big = h * w
    dev = labels.device
    i64 = torch.int64
    flat = labels.reshape(b, big).to(i64)
    interior = flat < big

    # run endpoints: a label change to the left or right within the row
    lab = labels.to(i64)
    edge = torch.full((b, h, 1), big + 1, dtype=i64, device=dev)
    to_left = torch.cat([edge, lab[:, :, :-1]], dim=2)
    to_right = torch.cat([lab[:, :, 1:], edge], dim=2)
    ep = ((lab != to_left) | (lab != to_right)).reshape(b, big) & interior
    chg = stats[:, 4].reshape(b, big) > 0

    idx = torch.arange(big, dtype=i64, device=dev)
    key = torch.where(interior, flat, big) * big + idx
    skey, spos = torch.sort(key, dim=1)
    sl = skey // big
    sxs = spos % w
    sep = ep.gather(1, spos)
    schg = chg.gather(1, spos)
    valid = sl < big

    bound = torch.ones_like(valid)
    bound[:, 1:] = sl[:, 1:] != sl[:, :-1]
    starts = bound & valid
    seg = (torch.cumsum(starts.to(i64), dim=1) - 1).clamp(min=0)

    # area = segment length; the exterior block, sorted last, is a segment
    # of its own so that it never extends the last component
    idx_b = idx.expand(b, big)
    start_idx = torch.cummax(torch.where(bound, idx_b, -1), dim=1).values
    nxt = torch.where(bound, idx_b, big)
    suffix_min = _rev(torch.cummin(_rev(nxt), dim=1).values)
    next_start = torch.cat(
        [suffix_min[:, 1:], torch.full((b, 1), big, dtype=i64, device=dev)],
        dim=1)
    area = next_start - start_idx
    kept_sorted = valid & schg & (area <= area_limit)

    # quirky fill-left: segmented exclusive running max of endpoint xs,
    # include the endpoints at or below it, take the segment's minimum
    enc = w + 1
    incl_max = seg_cummax(torch.where(sep & valid, sxs, 0), seg, enc)
    prior = torch.zeros_like(incl_max)
    prior[:, 1:] = incl_max[:, :-1]
    prior = torch.where(starts, 0, prior)
    include = sep & valid & (sxs <= prior)
    contrib = torch.where(include, sxs, w)
    rev_seg = _rev(seg.amax(dim=1, keepdim=True) - seg)
    qleft_sorted = w - _rev(seg_cummax(_rev(w - contrib), rev_seg, enc))

    # back to pixel order (spos is a permutation): kept pixels, and the
    # roots with their fill-left (a root's index is its label)
    kept = torch.zeros_like(kept_sorted).scatter_(1, spos, kept_sorted)
    root = torch.zeros_like(starts).scatter_(1, spos, starts & kept_sorted)
    qleft = torch.zeros_like(qleft_sorted).scatter_(1, spos, qleft_sorted)

    # dense bbox fill [top, bottom) x [left, right) from the root's stats
    st = stats.reshape(b, 5, big).to(i64)
    top = st[:, 1].clamp(0, h)
    bottom = st[:, 3].clamp(0, h)
    right = st[:, 2].clamp(0, w)
    left = torch.minimum(qleft, right).clamp(0, w)
    u = root.to(i64)
    frame0 = torch.arange(b, device=dev, dtype=i64)[:, None] * (h + 1) * (w + 1)
    diff = torch.zeros(b * (h + 1) * (w + 1), dtype=i64, device=dev)
    for yy, xx, sign in ((top, left, 1), (top, right, -1),
                         (bottom, left, -1), (bottom, right, 1)):
        diff.scatter_add_(0, (frame0 + yy * (w + 1) + xx).reshape(-1),
                          (sign * u).reshape(-1))
    inside = diff.view(b, h + 1, w + 1).cumsum(dim=1).cumsum(dim=2)
    inside = inside[:, :h, :w] > 0
    return kept.view(b, h, w) | inside


def extract_batch(background: torch.Tensor, frames: torch.Tensor,
                  medians: torch.Tensor | None, positions: torch.Tensor,
                  area_divisor: int = 5,
                  compute_medians: bool = False) -> torch.Tensor:
    """``[B, H, W]`` uint8 foreground masks (1 = foreground, the frame
    votes where 0) of ``frames`` at ``positions`` ``[B, 2]`` int32 against
    the background ``[HB, WB]`` uint8.

    With ``compute_medians`` the medians are recomputed from the frames
    (K1's medians-only instantiation on the card), as they are a pure
    function of the frame
    (kpe.hpp:308-314); otherwise ``medians`` ``[B, H, W]`` uint8 are
    used.  Nothing here waits for the device.  Two spans with CUDA
    events on the frames' device split it: ``foreground.labels`` (the
    medians, the changed mask, K4's labels and stats) and
    ``foreground.masks`` (:func:`masks_from_stats_sorted`)."""
    _, h, w = frames.shape
    limit = (h * w) // area_divisor
    dev = frames.device
    with profiling.span("foreground.labels", device=dev):
        if compute_medians:
            # processed bounds depend only on the frame dims, not the grid
            layout = make_layout(w, h, 1, 1, 0)
            medians = kpe_ops.extract_medians(frames, layout)
        changed = ~equality_mask(background, frames, positions)
        labels, stats = kcc.label_stats_batch(medians,
                                              changed.to(torch.uint8))
    with profiling.span("foreground.masks", device=dev):
        return masks_from_stats_sorted(labels, stats, limit).to(torch.uint8)
