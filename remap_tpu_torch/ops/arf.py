"""The artifact filter (port of remap_tpu/ops/arf.py, arf.hpp).

1. **Pattern heatmaps** (arf.hpp:143-186): along each row (and each
   column), every 15-pixel window of consecutively valid (mask != 0)
   pixels is a pattern; its frequency over the canvas becomes the heat at
   the window's centre.  The JAX package sorts the uint32 key pair
   ``(k1, k2)`` with ``num_keys=2``; here one int64 key ``(k1 - 2**31) *
   2**32 + k2`` orders exactly as the unsigned pair, and the all-ones
   sentinel pair becomes the largest int64.  Tie order inside a run does
   not matter: every member gets the run's length.
2. **Combine** (arf.hpp:188-212): ``1.0 / sqrt((h + v) / 2)`` in float32,
   correctly rounded (not ``rsqrt``: ``heat > 0.25`` is decided exactly
   at a count sum of 32); count 0 gives +inf.
3. **Select** (arf.hpp:255-307): rare pixels (heat > 0.25) take the argmax
   of a separable float32 Gaussian blur of the vote histograms restricted
   to the colours present at the centre, others the plain argmax;
   processed rows ``[margin, H-margin)``, columns ``[margin, W-margin-1)``,
   colour 0 elsewhere.  Pixels whose top two blurred scores are too close
   for the float32 blur to decide are flagged ``unstable`` and re-picked
   on the host by the canonical routine (``spec.arf.rare_picks``), so the
   final picks are the canonical ones on every device.

Canvases are the port's channels-major ``[16, h, w]`` int32 (the logical
canvas, ``dots[:, :h, :w]`` of the padded device layout).  Plain tensor
code: the JAX package runs all of this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from remap_tpu_torch.spec import arf as spec_arf

_U32 = 0xFFFFFFFF
#: the key of the JAX sentinel pair (0xFFFFFFFF, 0xFFFFFFFF)
_SENT = (1 << 63) - 1


def _window_keys(image: torch.Tensor, mask: torch.Tensor, size: int):
    """(k1, k2, run_ok) of the ``size``-window ENDING at each position,
    along the last axis: nibbles 0..7 of the window (oldest pixel first) in
    k1, 8.. in k2 (int64 values of the uint32 words)."""
    h, w = image.shape
    img = image.to(torch.int64)
    valid = mask != 0
    k1 = torch.zeros((h, w), dtype=torch.int64, device=image.device)
    k2 = torch.zeros_like(k1)
    run_ok = torch.ones((h, w), dtype=torch.bool, device=image.device)
    for j in range(size):
        shift = size - 1 - j
        shifted = F.pad(img, (shift, 0))[:, :w]
        vshift = F.pad(valid, (shift, 0))[:, :w]
        if j < 8:
            k1 |= (shifted << (4 * j)) & _U32
        else:
            k2 |= (shifted << (4 * (j - 8))) & _U32
        run_ok &= vshift
    # windows must fit: x >= size - 1
    run_ok[:, :size - 1] = False
    return k1, k2, run_ok


def _heat_axis(image: torch.Tensor, mask: torch.Tensor,
               size: int) -> torch.Tensor:
    """Pattern-frequency heat along the last axis (int64 counts)."""
    h, w = image.shape
    n = h * w
    k1, k2, ok = _window_keys(image, mask, size)
    key = torch.where(ok, (k1 - (1 << 31)) * (1 << 32) + k2, _SENT)
    skey, spos = torch.sort(key.reshape(-1))
    iota = torch.arange(n, device=image.device)
    is_start = torch.ones_like(skey, dtype=torch.bool)
    is_start[1:] = skey[1:] != skey[:-1]
    start_pos = torch.where(is_start, iota, n)
    suffix_min = torch.cummin(start_pos.flip(0), dim=0).values.flip(0)
    next_start = torch.cat([suffix_min[1:], suffix_min.new_full((1,), n)])
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    run_len = next_start[run_start] - run_start
    counts = torch.where(skey != _SENT, run_len, 0)
    out = torch.zeros(n, dtype=torch.int64, device=image.device)
    out[spos] = counts
    # the window's centre: size // 2 positions before its end
    half = size // 2
    return F.pad(out.reshape(h, w), (0, half))[:, half:]


def heatmap(image: torch.Tensor, mask: torch.Tensor,
            size: int = 15) -> torch.Tensor:
    """Combined rare-pattern heat ``1/sqrt((h+v)/2)`` float32
    (arf.hpp:188-229) of an ``[H, W]`` blend image and mask."""
    if size > 16:
        raise ValueError("windows hold at most 16 pixels (two key words)")
    hor = _heat_axis(image, mask, size)
    ver = _heat_axis(image.T.contiguous(), mask.T.contiguous(), size).T
    s = (hor.to(torch.float32) + ver.to(torch.float32)) / 2.0
    return 1.0 / torch.sqrt(s)


class SelectResult(NamedTuple):
    image: torch.Tensor      # [H, W] uint8 picked colours
    #: [H, W] bool — rare-path pixels whose top-2 blurred scores are too
    #: close for the separable float32 blur to decide the canonical argmax
    unstable: torch.Tensor


#: the bound on the separable float32 blur's relative error against the
#: canonical routine (the JAX package's ``_BLUR_REL_ERR``, with its proof)
_BLUR_REL_ERR = 1e-5


def select(dots: torch.Tensor, heat: torch.Tensor, dev: float = 2.0,
           threshold: float = 0.25) -> SelectResult:
    """Conditional Gaussian-vote colour selection (arf.hpp:255-307) of a
    ``[16, H, W]`` canvas under an ``[H, W]`` heat.

    The blur is separable: a row pass over ``dx in [-margin, margin]``,
    then a column pass over ``dy in [-margin, margin)`` only (the
    reference's truncated window, arf.hpp:282-287), both as rolls summed
    in the JAX package's term order.  The rolls wrap only into the margin
    ring, which is not processed."""
    depth, h, w = dots.shape
    g1d = spec_arf.gauss_1d(dev)
    margin = g1d.shape[0] // 2
    dots_f = dots.to(torch.float32)
    rowpass = None
    for t in range(-margin, margin + 1):
        term = float(g1d[margin + t]) * torch.roll(dots_f, -t, dims=2)
        rowpass = term if rowpass is None else rowpass.add_(term)
    conv = None
    for t in range(-margin, margin):
        term = float(g1d[margin + t]) * torch.roll(rowpass, -t, dims=1)
        conv = term if conv is None else conv.add_(term)
    del rowpass, dots_f

    present = dots > 0
    scores = torch.where(present, conv, 0.0)
    del conv
    blurred_pick = torch.argmax(scores, dim=0).to(torch.uint8)
    plain_pick = torch.argmax(dots, dim=0).to(torch.uint8)
    rare = heat > threshold
    pick = torch.where(rare, blurred_pick, plain_pick)

    ys = torch.arange(h, device=dots.device)[:, None]
    xs = torch.arange(w, device=dots.device)[None, :]
    processed = ((ys >= margin) & (ys < h - margin)
                 & (xs >= margin) & (xs < w - margin - 1))
    # knife edges: top1 - top2 <= err * top1 (ties included); pixels with
    # no votes at all pick colour 0 deterministically and are not
    top2 = torch.topk(scores, 2, dim=0).values
    err = torch.tensor(_BLUR_REL_ERR, dtype=torch.float32, device=dots.device)
    unstable = (rare & processed & (top2[0] > 0)
                & (top2[0] - top2[1] <= err * top2[0]))
    return SelectResult(image=torch.where(processed, pick, 0).to(torch.uint8),
                        unstable=unstable)


def filter_fragment(dots: torch.Tensor, blend_image: torch.Tensor,
                    blend_mask: torch.Tensor, size: int = 15,
                    dev: float = 2.0, threshold: float = 0.25) -> np.ndarray:
    """arf::filter minus the final margin crop (arf.hpp:314-328): the
    device select, then the exact host re-pick of the flagged pixels."""
    res = filter_fragment_dispatch(dots, blend_image, blend_mask, size, dev,
                                   threshold)
    return filter_fragment_finalize(dots, res, dev)


def filter_fragment_dispatch(dots: torch.Tensor, blend_image: torch.Tensor,
                             blend_mask: torch.Tensor, size: int = 15,
                             dev: float = 2.0,
                             threshold: float = 0.25) -> SelectResult:
    """The device half of :func:`filter_fragment` (no fetch)."""
    return select(dots, heatmap(blend_image, blend_mask, size), dev,
                  threshold)


def _gather_windows(dots: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    size: int) -> torch.Tensor:
    """``[K, size-1, size, 16]`` blur windows of the ``[16, H, W]`` canvas
    at interior pixels (ys, xs): rows ``dy in [-margin, margin)`` (the
    truncated bottom row), columns ``dx in [-margin, margin]``."""
    margin = size // 2
    dy = torch.arange(-margin, margin, device=dots.device)
    dx = torch.arange(-margin, margin + 1, device=dots.device)
    wy = (ys[:, None] + dy)[:, :, None]
    wx = (xs[:, None] + dx)[:, None, :]
    return dots[:, wy, wx].permute(1, 2, 3, 0)


def filter_fragment_finalize(dots: torch.Tensor, res: SelectResult,
                             dev: float = 2.0) -> np.ndarray:
    """The host half: fetch the picks, and re-pick the flagged pixels with
    the canonical routine on their blur windows alone (only the windows
    leave the device, not the canvas)."""
    out = res.image.cpu().numpy()
    unstable = res.unstable.nonzero()
    if unstable.shape[0]:
        ys, xs = unstable[:, 0], unstable[:, 1]
        size = spec_arf.gauss_kernel(dev).shape[0]
        win = _gather_windows(dots, ys, xs, size).cpu().numpy()
        out = out.copy()
        out[ys.cpu().numpy(), xs.cpu().numpy()] = (
            spec_arf.rare_picks_from_windows(win.astype(np.uint16), dev))
    return out
