"""xcorr model family: FFT correlation alignment (``ops.correlate``;
port of remap_tpu/models/xcorr.py)."""

from __future__ import annotations

from remap_tpu_torch.ops import correlate

match_canvases = correlate.match_canvases


def make_matcher(cfg, radius: int = 48):
    def match(prev_frames, curr_frames):
        res = correlate.match_xcorr(prev_frames, curr_frames, radius=radius)
        return res.offset, res.ok

    return match
