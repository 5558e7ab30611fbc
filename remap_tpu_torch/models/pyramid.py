"""pyramid model family: coarse-to-fine correlation for high-resolution
frames (port of remap_tpu/models/pyramid.py; BASELINE.json config 5,
640x480 captures).

The coarse level correlates frames decimated by stride subsampling
(palette codes cannot average) over a wide radius; the fine level counts
a small window directly, each current frame rolled by its own coarse
estimate (``ops.correlate.fine_counts``: one kernel on the card, which
reads the rolled frame in place).  Each level is a span
(``pyramid.coarse``, ``pyramid.fine``) with CUDA events on the frames'
device, and each call counts its pairs (``pyramid.pairs``).
"""

from __future__ import annotations

import torch

from remap_tpu_torch.ops import correlate
from remap_tpu_torch.utils import profiling

match_canvases = correlate.match_canvases_pyramid


def match_pyramid(prev: torch.Tensor, curr: torch.Tensor, factor: int = 4,
                  coarse_radius: int = 32, fine_radius: int | None = None):
    """Coarse-to-fine offsets of ``[B, H, W]`` uint8 frame pairs: returns
    (offset [B, 2] int32, ok [B] bool).  ``fine_radius`` defaults to
    ``factor + 1``: the coarse peak lands within ``factor / 2`` of the true
    offset's decimated value on coherent content, plus one for rounding."""
    if fine_radius is None:
        fine_radius = factor + 1
    pairs, h, w = prev.shape
    dev = prev.device
    with profiling.span("pyramid.coarse", device=dev):
        coarse = correlate.match_xcorr(
            prev[:, ::factor, ::factor].contiguous(),
            curr[:, ::factor, ::factor].contiguous(),
            radius=coarse_radius, min_cover=0.15)
    with profiling.span("pyramid.fine", device=dev):
        base = coarse.offset * factor
        fine = correlate.pick_peak(
            correlate.fine_counts(prev, curr, base, fine_radius), h, w,
            min_cover=0.15)
    profiling.count("pyramid.pairs", pairs)
    return base + fine.offset, coarse.ok & fine.ok


def make_matcher(cfg, factor: int = 4):
    def match(prev_frames, curr_frames):
        return match_pyramid(prev_frames, curr_frames, factor=factor)

    return match
