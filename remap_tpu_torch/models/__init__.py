"""Model families: the alignment engines the pipeline runs on (port of
remap_tpu/models).

- ``grid_vote``  reference-parity keypoint voting (the default), built
  into the collect step, splice and the multi-clip step.
- ``xcorr``      dense FFT cross-correlation of the one-hot palette
  channels; robust on keypoint-poor content.
- ``pyramid``    coarse-to-fine correlation for high-resolution captures
  (BASELINE.json config 5: 640x480).

``get_matcher(name, cfg)`` returns a ``(prev_frames, curr_frames) ->
(offsets [B, 2] int32, ok [B] bool)`` batch matcher over ``[B, H, W]``
uint8 frames, on their device.
"""

from __future__ import annotations

from typing import Callable

from remap_tpu_torch.models import pyramid as pyramid_model
from remap_tpu_torch.models import xcorr as xcorr_model

FAMILIES = ("grid_vote", "xcorr", "pyramid")


def get_matcher(name: str, cfg) -> Callable:
    if name == "xcorr":
        return xcorr_model.make_matcher(cfg)
    if name == "pyramid":
        return pyramid_model.make_matcher(cfg)
    raise ValueError(
        f"unknown matcher family {name!r}; grid_vote is built into the "
        f"collect step, others: {FAMILIES}")
