"""The alignment core the matcher families share (``models.family``)."""

from __future__ import annotations

import torch

from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import tables as table_ops


def rows(fn, *features):
    """``fn`` on each tensor of the features (a tensor, or a tuple of them
    such as ``RegionTables``), zipped across ``features``."""
    if isinstance(features[0], tuple):
        return type(features[0])(*map(fn, *features))
    return fn(*features)


class Family:
    """A matcher family on a grid layout under a config:

    - ``features(images [B, H, W], dense=None) -> (features, medians)``:
      what the family matches, and a call that launches the frames' K1
      medians for collect's store; ``keypoints`` says whether the
      features come from K1's dense extract, which a caller may give;
    - ``empty_carry(device)``: the features before the first frame;
    - ``match(prev, curr)``: (offset [B, 2] int32, ok [B] bool, ...) of
      paired features;
    - ``flags(res, curr)``: a match's exactness flags for the strict
      ladder, (table, join, range) [B] bool and kp_need [B] int32;
    - ``canvas_matcher``: splice's matcher of blended canvases.

    This base is the correlation families': the frames, matched by
    ``frame_matcher``, no flag raised, and K1's medians-only
    instantiation for the medians (the JAX package builds the tables it
    never reads).  Raises ``ValueError`` for an unknown table mode."""

    keypoints = False

    def __init__(self, layout, cfg, frame_matcher=None, canvas_matcher=None):
        table_ops.check_table_mode(cfg.table_mode)
        self.layout, self.cfg = layout, cfg
        self.frame_matcher, self.canvas_matcher = frame_matcher, canvas_matcher

    def features(self, images: torch.Tensor, dense=None):
        return images, lambda: kpe_ops.extract_medians(images, self.layout)

    def empty_carry(self, device) -> torch.Tensor:
        return torch.zeros((1, self.layout.height, self.layout.width),
                           dtype=torch.uint8, device=device)

    def match(self, prev: torch.Tensor, curr: torch.Tensor):
        return self.frame_matcher(prev, curr)

    def flags(self, res, curr):
        none = torch.zeros_like(res[1])
        return none, none, none, torch.zeros_like(res[1], dtype=torch.int32)

    def align(self, features, carry):
        """Each frame of a batch matched against the one before it, the
        ``carry`` (the previous batch's last features) before the first:
        (the match, the batch's last features, copied)."""
        prev = rows(lambda c, f: torch.cat([c, f[:-1]], dim=0), carry,
                    features)
        return (self.match(prev, features),
                rows(lambda f: f[-1:].clone(), features))
