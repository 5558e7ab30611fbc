"""Model families: the alignment engines the pipeline runs on (port of
remap_tpu/models), and the one module that chooses between them.

- ``grid_vote``  reference-parity keypoint voting (the default).
- ``xcorr``      dense FFT cross-correlation of the one-hot palette
  channels; robust on keypoint-poor content.
- ``pyramid``    coarse-to-fine correlation for high-resolution captures
  (BASELINE.json config 5: 640x480).

``family(cfg, layout)`` is ``cfg.matcher``'s family (``core.Family``):
collect, the multi-clip steps and splice align through it.
``get_matcher(name, cfg)`` is a correlation family's ``(prev_frames,
curr_frames) -> (offsets [B, 2] int32, ok [B] bool)`` batch matcher.
"""

from __future__ import annotations

from typing import Callable

from remap_tpu_torch.models import pyramid as pyramid_model
from remap_tpu_torch.models import xcorr as xcorr_model
from remap_tpu_torch.models.core import Family, rows  # noqa: F401
from remap_tpu_torch.models.grid_vote import GridVote

FAMILIES = ("grid_vote", "xcorr", "pyramid")

_FRAME_FAMILIES = {"xcorr": xcorr_model, "pyramid": pyramid_model}


def get_matcher(name: str, cfg) -> Callable:
    if name not in _FRAME_FAMILIES:
        raise ValueError(f"unknown matcher family {name!r}; frame matchers: "
                         f"{tuple(_FRAME_FAMILIES)}, families: {FAMILIES}")
    return _FRAME_FAMILIES[name].make_matcher(cfg)


def family(cfg, layout=None) -> Family:
    """``cfg.matcher``'s family on ``layout`` (splice's canvas matcher
    needs none); raises ``ValueError`` for an unknown name."""
    if cfg.matcher == "grid_vote":
        return GridVote(layout, cfg)
    return Family(layout, cfg, get_matcher(cfg.matcher, cfg),
                  _FRAME_FAMILIES[cfg.matcher].match_canvases)
