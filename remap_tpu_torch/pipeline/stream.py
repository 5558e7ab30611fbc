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
from remap_tpu_torch.device import HostCopy, get_device, upload
from remap_tpu_torch.pipeline import collect as collect_mod
from remap_tpu_torch.pipeline.state import (
    Fragment, FrameStore, pack_nibbles_batch, unpack_nibbles_device,
)


class StreamingStitcher:
    """Push ``[B, H, W]`` uint8 batches at ``cfg``'s screen size, then
    ``finish()``; runs on ``device``, CUDA unless the caller asks for the
    CPU."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = get_device(device)
        h, w = cfg.screen_height, cfg.screen_width
        self.h, self.w = h, w
        self.layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                                  cfg.grid_overlap)
        self._step = collect_mod.make_collect_step(self.layout, cfg)
        self._carry = collect_mod._empty_carry(self.layout,
                                               cfg.region_capacity,
                                               self.device)
        self.store = FrameStore(
            h, w, device_budget=collect_mod._store_budget(cfg, self.device),
            device=self.device)
        self.frame_no = 0
        self._offsets: List[np.ndarray] = []
        self._matched: List[np.ndarray] = []
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
        packed = pack_nibbles_batch(np.asarray(batch))
        packed_dev = upload(packed, self.device)
        images = unpack_nibbles_device(packed_dev, self.w)
        median, scalars, self._carry = self._step(images, self._carry)
        medians = self.cfg.store_medians
        host = (HostCopy(scalars, median) if medians
                else HostCopy(scalars)).wait()
        off, ok, tovf, jovf, rovf, kpn = collect_mod.split_step_scalars(
            host[0][:n_real])
        self.needed_capacity = max(self.needed_capacity,
                                   int(kpn.max(initial=0)))
        off = off.copy()
        ok = ok.copy()
        if self.frame_no == 0:
            ok[0] = False
        off[~ok] = 0
        # range overflow counts as overflow for the public counter: a
        # caller checking only overflow_frames never accepts inexact
        # offsets silently
        ovf = tovf | jovf | rovf
        self.overflow_frames += int(ovf.sum())
        self.range_overflow_frames += int(rovf.sum())
        self.store.put_packed_batch(
            list(range(self.frame_no, self.frame_no + n_real)),
            packed[:n_real],
            host[1][:n_real] if medians else None,
            device_packed=packed_dev[:n_real],
            device_packed_medians=median[:n_real] if medians else None,
        )
        self.frame_no += n_real
        self._offsets.append(off)
        self._matched.append(ok)
        return off, ok

    def finish(self) -> List[Fragment]:
        if not self._offsets:
            return []
        offsets = np.concatenate(self._offsets)
        matched = np.concatenate(self._matched)
        segments = collect_mod.segment_positions(offsets, matched)
        return collect_mod.blit_pass(segments, self.store, self.cfg)
