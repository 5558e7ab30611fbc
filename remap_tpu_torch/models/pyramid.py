"""pyramid model family: coarse-to-fine correlation for high-resolution
frames (port of remap_tpu/models/pyramid.py; BASELINE.json config 5,
640x480 captures).

The coarse level correlates frames decimated by stride subsampling
(palette codes cannot average) over a wide radius; the fine level rolls
each current frame by its own coarse estimate and rescores a small
window by direct comparison.  Each level is a span (``pyramid.coarse``,
``pyramid.fine``) with CUDA events on the frames' device, and each call
counts its pairs (``pyramid.pairs``) and the fine level's shifted
compares (``pyramid.fine_shifts``, pairs x (2 fine_radius + 1)^2).
"""

from __future__ import annotations

import torch

from remap_tpu_torch.ops import correlate
from remap_tpu_torch.utils import profiling


def shift_frames(frames: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x] = frames[b, (y - dy_b) mod H, (x - dx_b) mod W]``:
    each ``[H, W]`` frame rolled by its own ``offsets[b]`` = (dx, dy), as a
    gather with modular indices (``torch.roll`` has no per-sample
    shifts)."""
    b, h, w = frames.shape
    dev = frames.device
    off = offsets.to(torch.int64)
    ys = (torch.arange(h, device=dev)[None] - off[:, 1, None]) % h
    xs = (torch.arange(w, device=dev)[None] - off[:, 0, None]) % w
    bi = torch.arange(b, device=dev)[:, None, None]
    return frames[bi, ys[:, :, None], xs[:, None, :]]


def match_pyramid(prev: torch.Tensor, curr: torch.Tensor, factor: int = 4,
                  coarse_radius: int = 32, fine_radius: int | None = None):
    """Coarse-to-fine offsets of ``[B, H, W]`` uint8 frame pairs: returns
    (offset [B, 2] int32, ok [B] bool).  ``fine_radius`` defaults to
    ``factor + 1``: the coarse peak lands within ``factor / 2`` of the true
    offset's decimated value on coherent content, plus one for rounding."""
    if fine_radius is None:
        fine_radius = factor + 1
    dev = prev.device
    with profiling.span("pyramid.coarse", device=dev):
        coarse = correlate.match_xcorr(
            prev[:, ::factor, ::factor].contiguous(),
            curr[:, ::factor, ::factor].contiguous(),
            radius=coarse_radius, min_cover=0.15)
    with profiling.span("pyramid.fine", device=dev):
        base = coarse.offset * factor
        fine = correlate.match_xcorr(prev, shift_frames(curr, base),
                                     radius=fine_radius, min_cover=0.15,
                                     method="direct")
    pairs = prev.shape[0]
    profiling.count("pyramid.pairs", pairs)
    profiling.count("pyramid.fine_shifts", pairs * (2 * fine_radius + 1) ** 2)
    return base + fine.offset, coarse.ok & fine.ok


def make_matcher(cfg, factor: int = 4):
    def match(prev_frames, curr_frames):
        return match_pyramid(prev_frames, curr_frames, factor=factor)

    return match
