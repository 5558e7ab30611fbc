"""grid_vote model family: reference-parity keypoint voting (kpm.hpp; the
default).  A batch's features are its region tables (K1's dense extract,
then K2), matched by ``ops.kpm.match_tables`` under the config's knobs."""

from __future__ import annotations

import torch

from remap_tpu_torch.models.core import Family
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import kpm as kpm_ops
from remap_tpu_torch.ops import tables as table_ops


def kp_need(tabs: table_ops.RegionTables) -> torch.Tensor:
    """[B] true per-frame keypoint maximum over regions (wcounts count the
    whole region, not the kept rows)."""
    return tabs.wcounts.sum(dim=-1).max(dim=-1).values


class GridVote(Family):
    keypoints = True

    def features(self, images: torch.Tensor, dense=None):
        """K1 (unless its output ``dense`` is given), then K2."""
        if dense is None:
            dense = kpe_ops.extract_dense(images, self.layout)
        return table_ops.build_tables(
            dense.weight, dense.codes, self.layout, self.cfg.region_capacity,
            self.cfg.table_mode), lambda: dense.median

    def empty_carry(self, device) -> table_ops.RegionTables:
        return table_ops.empty_tables(self.layout.region_count,
                                      self.cfg.region_capacity, device)

    def match(self, prev, curr) -> kpm_ops.MatchResult:
        cfg = self.cfg
        return kpm_ops.match_tables(
            prev, curr, self.layout,
            weight_switch=cfg.match.weight_switch,
            region_votes=cfg.match.region_votes,
            min_active_divisor=cfg.min_active_divisor,
            runner_up_divisor=cfg.runner_up_divisor,
            multiplicity=cfg.join_multiplicity,
            vote_radius=cfg.vote_radius,
        )

    def flags(self, res: kpm_ops.MatchResult, curr):
        return (curr.overflow.any(dim=-1), res.overflow, res.range_overflow,
                kp_need(curr))
