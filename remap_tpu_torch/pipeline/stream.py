"""Streaming stitcher: the long-session serving interface (port of
remap_tpu/pipeline/stream.py).

Incremental form of ``pipeline.collect`` for continuous operation:
callers push frame batches; each batch runs the collect step (extract,
tables, match against the carried tables; under the correlation families
the frames themselves, against the carried last frame) at once, frames
land packed in the store (their device copies kept as its mirror, within
the ``frame_store`` budget), and ``finish()`` segments positions and
blits the fragments.  There is no escalation ladder here: ``overflow_frames``
counts the frames whose declaration is not provably exact, and
``needed_capacity`` is the running max per-region keypoint count for a
re-run.

Typical serving loop::

    stitcher = StreamingStitcher(cfg)
    for batch in frame_batches:          # [B, H, W] uint8
        offsets, matched = stitcher.push(batch)
    fragments = stitcher.finish()        # list of pipeline.state.Fragment
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.device import get_device
from remap_tpu_torch.pipeline import collect as collect_mod
from remap_tpu_torch.pipeline.state import (
    Fragment, FrameStore, pack_nibbles_batch,
)


class StreamingStitcher(collect_mod.BatchLoop):
    """Push ``[B, H, W]`` uint8 batches at ``cfg``'s screen size, then
    ``finish()``; runs on ``device``, CUDA unless the caller asks for the
    CPU.  It is collect's batch loop, each pushed batch drained at once."""

    def __init__(self, cfg: PipelineConfig, device=None):
        device = get_device(device)
        self.h, self.w = h, w = cfg.screen_height, cfg.screen_width
        self.layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                                  cfg.grid_overlap)
        super().__init__(self.layout, cfg, FrameStore(
            h, w, device_budget=collect_mod.store_budget(cfg, device),
            device=device), device, depth=1)
        self.frame_no = 0
        self.overflow_frames = 0
        #: frames where the vote-radius exactness bound tripped (only
        #: possible with cfg.vote_radius > 0); join limits held, so a
        #: re-run with vote_radius=0 alone recovers exact offsets
        self.range_overflow_frames = 0
        #: running max per-region keypoint count (capacity re-run hint)
        self.needed_capacity = 0

    def push(self, batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Process one [B, H, W] uint8 batch (B = cfg.frame_batch, except
        possibly the last); returns (offsets [B, 2], matched [B])."""
        n_real = len(batch)
        b = self.cfg.frame_batch
        if n_real < b:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], b - n_real, axis=0)])
        self.dispatch(self.frame_no, n_real,
                      pack_nibbles_batch(np.asarray(batch)), self.w)
        off, ok, tovf, jovf, rovf, kpn = self.drained[-1]
        self.needed_capacity = max(self.needed_capacity,
                                   int(kpn.max(initial=0)))
        # range overflow counts as overflow for the public counter: a
        # caller checking only overflow_frames never accepts inexact
        # offsets silently
        self.overflow_frames += int((tovf | jovf | rovf).sum())
        self.range_overflow_frames += int(rovf.sum())
        self.frame_no += n_real
        return off, ok

    def finish(self) -> List[Fragment]:
        segments = collect_mod.segment_positions(*self.results()[:2])
        return collect_mod.blit_pass(segments, self.store, self.cfg)
