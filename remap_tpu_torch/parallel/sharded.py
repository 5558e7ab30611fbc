"""The streaming align+stitch step and the multi-clip pipeline step (port
of remap_tpu/parallel/sharded.py's ``make_streaming_step`` and
``make_pipeline_step``).

One batch of frames goes in, per-frame offsets come out, and the atlas
and matcher state stay on the device: extract -> region tables -> match
against the previous frame (the carried tables across batch edges) ->
segmented positions -> in-device re-anchor -> blit.  The step runs on the
device of its ``images``: on CUDA tensors extract, tables and blit are
the hand-written kernels; on CPU tensors their plain versions.

Nothing in ``step`` waits for the device: ``strayed`` and the flags come
back as device tensors, and the atlas shift runs on every step (a shift
by 0 is the identity) instead of branching on the host as the JAX
``lax.cond`` does.

The multi-clip step (:func:`make_pipeline_step`) takes ``[C, T, H, W]``
clips and returns per-clip offsets, flags, positions and a fixed stitch
window per clip, under any matcher family.  Its mesh-sharded form
(``make_sharded_step``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import GridLayout
from remap_tpu_torch.device import get_device
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import kpm as kpm_ops
from remap_tpu_torch.ops import tables as table_ops
from remap_tpu_torch.ops.kernels import blit as blit_ops


def segmented_positions(offsets: torch.Tensor,
                        matched: torch.Tensor) -> torch.Tensor:
    """Positions with reset-to-zero at fragment breaks (frc.hpp:109-115):
    ``[C, T, 2]`` offsets, ``[C, T]`` matched -> ``[C, T, 2]``.

    A break's own delta is 0, so the position is the running sum minus
    the running sum at the latest break (none before the first break)."""
    deltas = torch.where(matched[..., None], offsets, 0).to(torch.int64)
    run = torch.cumsum(deltas, dim=1)
    t = matched.shape[1]
    iota = torch.arange(t, device=matched.device)
    last = torch.cummax(torch.where(~matched, iota, -1), dim=1).values
    at_break = run.gather(1, last.clamp(min=0)[..., None].expand_as(run))
    pos = run - torch.where((last >= 0)[..., None], at_break, 0)
    return pos.to(torch.int32)


class StepResult(NamedTuple):
    """The multi-clip step's outputs, in the JAX package's layout."""

    offsets: torch.Tensor    # [C, T, 2] int32 offset vs the previous frame
    matched: torch.Tensor    # [C, T] bool
    positions: torch.Tensor  # [C, T, 2] int32 segmented cumsum of offsets
    atlas: torch.Tensor      # [C, AH, AW, 16] uint16 stitch window per clip


def match_pairs(prev, curr, layout: GridLayout, cfg: PipelineConfig):
    """``kpm.match_tables`` of the (prev, curr) tables under ``cfg``'s
    matcher knobs (the grid_vote matcher)."""
    return kpm_ops.match_tables(
        prev, curr, layout,
        weight_switch=cfg.match.weight_switch,
        region_votes=cfg.match.region_votes,
        min_active_divisor=cfg.min_active_divisor,
        runner_up_divisor=cfg.runner_up_divisor,
        multiplicity=cfg.join_multiplicity,
        vote_radius=cfg.vote_radius,
    )


def make_pipeline_step(layout: GridLayout, cfg: PipelineConfig,
                       atlas_pad: int = 64, device=None):
    """Build ``step(images [C, T, H, W] uint8) -> StepResult`` on
    ``device`` (CUDA unless the caller asks for the CPU).

    The alignment follows ``cfg.matcher``: grid_vote extracts (K1) and
    builds the tables (K2) once over the flattened ``C*T`` frames, then
    matches the pairs (t-1, t) inside each clip; the correlation families
    match those pairs' frames.  Positions are the segmented cumsum of the
    declared offsets, anchored ``atlas_pad`` into each clip's ``(H +
    2 pad) x (W + 2 pad)`` window and clamped to it, and every clip's
    frames are voted in one K3 launch into a canvas that stacks the clips'
    windows.  Frame 0 of each clip is unmatched.  Raises for a
    ``cfg.table_mode`` the port does not implement."""
    check_table_mode(cfg.table_mode)
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad
    dev = get_device(device)
    pair_match = (None if cfg.matcher == "grid_vote"
                  else models.get_matcher(cfg.matcher, cfg))
    limit = torch.tensor([aw - w, ah - h], dtype=torch.int32, device=dev)

    def step(images: torch.Tensor) -> StepResult:
        c, t = images.shape[:2]
        n = c * (t - 1)
        if pair_match is None:
            dense = kpe_ops.extract_dense(images.reshape(c * t, h, w),
                                          layout)
            tabs = table_ops.build_tables(dense.weight, dense.codes, layout,
                                          cfg.region_capacity)
            clips = [a.reshape((c, t) + a.shape[1:]) for a in tabs]
            prev = table_ops.RegionTables(*(
                a[:, :-1].reshape((n,) + a.shape[2:]) for a in clips))
            curr = table_ops.RegionTables(*(
                a[:, 1:].reshape((n,) + a.shape[2:]) for a in clips))
            res = match_pairs(prev, curr, layout, cfg)
            pair_offsets, pair_ok = res.offset, res.ok
        else:
            pair_offsets, pair_ok = pair_match(
                images[:, :-1].reshape(n, h, w),
                images[:, 1:].reshape(n, h, w))
        offsets = torch.cat([
            torch.zeros((c, 1, 2), dtype=torch.int32, device=dev),
            pair_offsets.reshape(c, t - 1, 2).to(torch.int32)], dim=1)
        matched = torch.cat([
            torch.zeros((c, 1), dtype=torch.bool, device=dev),
            pair_ok.reshape(c, t - 1)], dim=1)
        positions = segmented_positions(offsets, matched)
        anchored = torch.minimum(torch.clamp(positions + atlas_pad, min=0),
                                 limit)
        # the clips' windows stack vertically in one canvas: clip i's
        # frames land i * AH rows down, so one launch votes every clip
        rows = torch.arange(c, dtype=torch.int32, device=dev) * ah
        flat_pos = (anchored + torch.stack(
            [torch.zeros_like(rows), rows], dim=-1)[:, None]).reshape(-1, 2)
        dots = torch.zeros((blit_ops.DEPTH,)
                           + blit_ops.padded_dims(c * ah, aw),
                           dtype=torch.int32, device=dev)
        blit_ops.blit_frames_(images.reshape(c * t, h, w), flat_pos, dots,
                              box=(0, 0, aw, c * ah))
        atlas = dots[:, :c * ah, :aw].reshape(blit_ops.DEPTH, c, ah, aw)
        return StepResult(offsets=offsets, matched=matched,
                          positions=positions,
                          atlas=atlas.permute(1, 2, 3, 0).to(torch.uint16))

    return step


class StreamFlags(NamedTuple):
    """Per-frame, per-cause exactness flags (see the JAX ``StreamFlags``):
    ``table`` a region table hit its capacity, ``join`` the join's
    multiplicity truncated votes, ``range`` the vote radius could matter."""

    table: torch.Tensor  # [T] bool
    join: torch.Tensor   # [T] bool
    range: torch.Tensor  # [T] bool

    @property
    def combined(self) -> torch.Tensor:
        return self.table | self.join | self.range


class StreamState(NamedTuple):
    """Device-resident state carried across streaming batches."""

    dots: torch.Tensor      # [16, AH', AW'] int32 (uint16 values) atlas
    carry: table_ops.RegionTables  # tables of the previous batch's last frame
    position: torch.Tensor  # [2] int32 running position
    started: torch.Tensor   # [] bool — false before the first frame
    anchor: torch.Tensor    # [2] int32 stream coords of the atlas origin


def _shift_atlas(dots: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """out[c, y, x] = dots[c, y + dy, x + dx], zero-filled at the edges;
    ``delta`` = (dx, dy) stays on the device."""
    _, hh, ww = dots.shape
    dev = dots.device
    ys = torch.arange(hh, device=dev) + delta[1]
    xs = torch.arange(ww, device=dev) + delta[0]
    y_ok = (ys >= 0) & (ys < hh)
    x_ok = (xs >= 0) & (xs < ww)
    out = dots.index_select(1, ys.clamp(0, hh - 1))
    out = out.index_select(2, xs.clamp(0, ww - 1))
    return out * (y_ok[None, :, None] & x_ok[None, None, :])


#: table modes whose tables the port's topk ``build_tables`` gives: "auto"
#: resolves to topk off the TPU for the stream (remap_tpu/ops/tables.py
#: ``resolve_table_mode``), "pallas" is the TPU kernel of the same
#: selection, and "sort" is documented identical to topk
TOPK_TABLE_MODES = ("auto", "topk", "pallas", "sort")


def check_table_mode(mode: str) -> None:
    """Raise for a table mode whose tables the port does not build:
    ``NotImplementedError`` for "sort2" (its own chunk-quota overflow
    flag, remap_tpu/ops/tables.py), ``ValueError`` for an unknown mode."""
    if mode == "sort2":
        raise NotImplementedError(
            "table_mode='sort2' is not implemented in the port")
    if mode not in TOPK_TABLE_MODES:
        raise ValueError(f"unknown table_mode {mode!r}")


def make_streaming_step(layout: GridLayout, cfg: PipelineConfig,
                        atlas_pad: int = 128, device=None):
    """Build ``(init_state, step)``.

    ``init_state()`` makes the empty state on ``device``;
    ``step(images, state)`` takes a ``[T, H, W]`` uint8 batch on that
    device and returns ``(offsets [T, 2] int32, matched [T] bool,
    StreamFlags, strayed [] bool, new_state)``.  The stitch window follows
    the camera (re-anchoring in-device); ``strayed`` fires when one
    batch's position span exceeds the window itself.  Raises for a
    ``cfg.table_mode`` the port does not implement."""
    check_table_mode(cfg.table_mode)
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad
    dev = get_device(device)

    def init_state() -> StreamState:
        return StreamState(
            dots=torch.zeros((blit_ops.DEPTH,) + blit_ops.padded_dims(ah, aw),
                             dtype=torch.int32, device=dev),
            carry=table_ops.empty_tables(layout.region_count,
                                         cfg.region_capacity, dev),
            position=torch.zeros(2, dtype=torch.int32, device=dev),
            started=torch.zeros((), dtype=torch.bool, device=dev),
            anchor=torch.full((2,), -atlas_pad, dtype=torch.int32,
                              device=dev),
        )

    limit = torch.tensor([aw - w, ah - h], dtype=torch.int32, device=dev)

    def step(images: torch.Tensor, state: StreamState):
        t = images.shape[0]
        dense = kpe_ops.extract_dense(images, layout)
        tabs = table_ops.build_tables(dense.weight, dense.codes, layout,
                                      cfg.region_capacity)
        prev = table_ops.RegionTables(*(
            torch.cat([c, a[:-1]], dim=0) for c, a in zip(state.carry, tabs)
        ))
        res = match_pairs(prev, tabs, layout, cfg)
        # the very first frame of the stream never matches
        matched = res.ok & (state.started | (torch.arange(t, device=dev) > 0))
        offsets = torch.where(matched[:, None], res.offset, 0)
        flags = StreamFlags(table=tabs.overflow.any(dim=-1),
                            join=res.overflow, range=res.range_overflow)

        # positions: segmented cumsum with resets at breaks, seeded with
        # the carried running position before the batch's first break
        seg = segmented_positions(offsets[None], matched[None])[0]
        before_break = (torch.cumsum(~matched, dim=0) == 0)[:, None]
        pos = seg + torch.where(before_break, state.position[None], 0)

        # re-anchor the resident window under the batch's position span
        lo = pos.min(dim=0).values
        hi = pos.max(dim=0).values
        rel_lo = lo - state.anchor
        rel_hi = hi - state.anchor
        fits = hi - lo <= limit
        strayed = (~fits).any()
        out_of_window = (rel_lo < 0) | (rel_hi > limit)
        # center the span in the window on each violated axis
        centered = torch.div(rel_lo + rel_hi - limit, 2, rounding_mode="floor")
        delta = torch.where(out_of_window & fits, centered, 0)
        anchor = state.anchor + delta
        dots0 = _shift_atlas(state.dots, delta)
        anchored = torch.minimum(torch.clamp(pos - anchor, min=0), limit)

        # dots0 is the step's own fresh tensor (state.dots stays as it
        # was); anchored positions keep every frame in the logical window
        dots = blit_ops.blit_frames_(images, anchored, dots0,
                                     box=(0, 0, aw, ah))

        new_state = StreamState(
            dots=dots,
            carry=table_ops.RegionTables(*(a[-1:] for a in tabs)),
            position=pos[-1],
            started=torch.ones((), dtype=torch.bool, device=dev),
            anchor=anchor,
        )
        return offsets, matched, flags, strayed, new_state

    return init_state, step
