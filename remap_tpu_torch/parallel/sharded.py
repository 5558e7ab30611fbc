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
window per clip, under any matcher family.  :func:`make_sharded_step`
runs it over a ``('data', 'space')`` mesh (``parallel.mesh``): clips over
``data``, frame and atlas rows over ``space``, with the same outputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import GridLayout
from remap_tpu_torch.device import current, get_device, same_device, upload
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import tables as table_ops
from remap_tpu_torch.ops.kernels import blit as blit_ops
from remap_tpu_torch.parallel.mesh import Mesh, clip_sharding


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


def make_pipeline_step(layout: GridLayout, cfg: PipelineConfig,
                       atlas_pad: int = 64, device=None):
    """Build ``step(images [C, T, H, W] uint8) -> StepResult`` on
    ``device`` (CUDA unless the caller asks for the CPU).

    The alignment follows ``cfg.matcher`` (``models.family``): grid_vote
    extracts (K1) and builds the tables (K2) once over the flattened
    ``C*T`` frames, then matches the pairs (t-1, t) inside each clip; the
    correlation families match those pairs' frames.  Positions are the
    segmented cumsum of the declared offsets, anchored ``atlas_pad`` into
    each clip's ``(H + 2 pad) x (W + 2 pad)`` window and clamped to it,
    and every clip's frames are voted in one K3 launch into a canvas that
    stacks the clips' windows.  Frame 0 of each clip is unmatched.  Raises
    ``ValueError`` for an unknown ``cfg.table_mode``."""
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad
    get_device(device)   # raises without CUDA unless the CPU is named
    family = models.family(cfg, layout)

    def step(images: torch.Tensor) -> StepResult:
        offsets, matched, positions = _align(images, family)
        anchored = _anchor(positions, atlas_pad, aw - w, ah - h)
        return StepResult(offsets=offsets, matched=matched,
                          positions=positions,
                          atlas=_vote_windows(images, anchored, ah, aw))

    return step


def _anchor(positions: torch.Tensor, pad: int, x_max: int,
            y_max: int) -> torch.Tensor:
    """Positions ``pad`` into the stitch window, clamped to it: x to [0,
    x_max], y to [0, y_max] (no host-to-device copy, so nothing waits)."""
    return torch.stack([(positions[..., 0] + pad).clamp(0, x_max),
                        (positions[..., 1] + pad).clamp(0, y_max)], dim=-1)


def _align(images: torch.Tensor, family: models.Family, dense=None):
    """(offsets [C, T, 2] int32, matched [C, T] bool, positions [C, T, 2]
    int32) of ``[C, T, H, W]`` clips (features from K1's output ``dense``
    where given).  Frame 0 of each clip is unmatched."""
    c, t, h, w = images.shape
    n = c * (t - 1)
    features, _ = family.features(images.reshape(c * t, h, w), dense)
    clips = models.rows(lambda a: a.reshape((c, t) + a.shape[1:]), features)
    prev = models.rows(lambda a: a[:, :-1].reshape((n,) + a.shape[2:]), clips)
    curr = models.rows(lambda a: a[:, 1:].reshape((n,) + a.shape[2:]), clips)
    pair_offsets, pair_ok = family.match(prev, curr)[:2]
    dev = images.device
    offsets = torch.cat([
        torch.zeros((c, 1, 2), dtype=torch.int32, device=dev),
        pair_offsets.reshape(c, t - 1, 2).to(torch.int32)], dim=1)
    matched = torch.cat([
        torch.zeros((c, 1), dtype=torch.bool, device=dev),
        pair_ok.reshape(c, t - 1)], dim=1)
    return offsets, matched, segmented_positions(offsets, matched)


def _vote_windows(images: torch.Tensor, anchored: torch.Tensor, ah: int,
                  aw: int, rows: tuple[int, int] | None = None
                  ) -> torch.Tensor:
    """Every clip's frames voted into its ``AH x AW`` window at the
    anchored positions, in one K3 launch: ``[C, AH, AW, 16]`` uint16, or
    with ``rows`` = (lo, hi) the window rows [lo, hi) alone, ``[C, hi -
    lo, AW, 16]``.  The clips' windows (or bands) stack vertically in one
    canvas, clip i's ``i * band`` rows down; with a band each clip's
    frames keep to its own rows (a ``RowClip``)."""
    c, t, h, w = images.shape
    dev = images.device
    lo, hi = (0, ah) if rows is None else rows
    band = hi - lo
    shift = torch.arange(c, dtype=torch.int32, device=dev) * band - lo
    flat_pos = (anchored + torch.stack(
        [torch.zeros_like(shift), shift], dim=-1)[:, None]).reshape(-1, 2)
    dots = torch.zeros((blit_ops.DEPTH,) + blit_ops.padded_dims(c * band, aw),
                       dtype=torch.int32, device=dev)
    clip = (None if rows is None
            else blit_ops.RowClip(0, band, every=t, step=band))
    blit_ops.blit_frames_(images.reshape(c * t, h, w), flat_pos, dots,
                          box=(0, 0, aw, c * band), rows=clip)
    atlas = dots[:, :c * band, :aw].reshape(blit_ops.DEPTH, c, band, aw)
    return atlas.permute(1, 2, 3, 0).to(torch.uint16)


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


def make_streaming_step(layout: GridLayout, cfg: PipelineConfig,
                        atlas_pad: int = 128, device=None):
    """Build ``(init_state, step)``.

    ``init_state()`` makes the empty state on ``device``;
    ``step(images, state)`` takes a ``[T, H, W]`` uint8 batch on that
    device and returns ``(offsets [T, 2] int32, matched [T] bool,
    StreamFlags, strayed [] bool, new_state)``.  The stitch window follows
    the camera (re-anchoring in-device); ``strayed`` fires when one
    batch's position span exceeds the window itself.  It matches by
    grid_vote whatever ``cfg.matcher`` says, as the JAX package's step
    does.  Raises ``ValueError`` for an unknown ``cfg.table_mode``."""
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad
    dev = get_device(device)
    family = models.GridVote(layout, cfg)

    def init_state() -> StreamState:
        return StreamState(
            dots=torch.zeros((blit_ops.DEPTH,) + blit_ops.padded_dims(ah, aw),
                             dtype=torch.int32, device=dev),
            carry=family.empty_carry(dev),
            position=torch.zeros(2, dtype=torch.int32, device=dev),
            started=torch.zeros((), dtype=torch.bool, device=dev),
            anchor=torch.full((2,), -atlas_pad, dtype=torch.int32,
                              device=dev),
        )

    limit = torch.tensor([aw - w, ah - h], dtype=torch.int32, device=dev)

    def step(images: torch.Tensor, state: StreamState):
        t = images.shape[0]
        tabs, _ = family.features(images)
        res, carry = family.align(tabs, state.carry)
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
            carry=carry,
            position=pos[-1],
            started=torch.ones((), dtype=torch.bool, device=dev),
            anchor=anchor,
        )
        return offsets, matched, flags, strayed, new_state

    return init_state, step


# --------------------------------------------------------------------------
# the multi-clip step over a ('data', 'space') mesh


def row_bands(n: int, k: int, least: int = 1) -> list[tuple[int, int]]:
    """``[lo, hi)`` of ``k`` bands of ``n`` rows, ``ceil(n / k)`` rows each
    and the rest in the last (the split of a JAX ``NamedSharding``).
    Raises if a band would hold fewer than ``least`` rows."""
    size = -(-n // k)
    bands = [(min(i * size, n), min((i + 1) * size, n)) for i in range(k)]
    if any(hi - lo < least for lo, hi in bands):
        raise ValueError(f"{n} rows do not split into {k} bands of at least "
                         f"{least} rows")
    return bands


@dataclasses.dataclass
class PlacedBatch:
    """``[C, T, H, W]`` clips placed on a mesh: ``shards[d][s]`` holds the
    clips of data row ``d`` (``clips[d]``, global numbers) cut to the
    frame rows ``bands[s]``, on ``mesh.devices[d][s]``."""

    mesh: Mesh
    shape: tuple
    clips: list
    bands: list
    shards: list


def place_clips(images, mesh: Mesh, clip_base: int = 0) -> PlacedBatch:
    """Cut ``[C, T, H, W]`` uint8 clips (a tensor or a numpy array) by
    ``mesh.clip_sharding``: the clips split evenly over the ``data`` rows,
    the frame rows into ``space`` bands of at least ``HALO`` rows, each
    piece copied to its device.  ``clip_base`` numbers the first clip."""
    split = clip_sharding(mesh)
    cdim, rdim = split.dim_of("data"), split.dim_of("space")
    if images.ndim != 4 or images.dtype not in (torch.uint8, np.uint8):
        raise ValueError(f"expected [C, T, H, W] uint8 clips, got "
                         f"{tuple(images.shape)} {images.dtype}")
    c = images.shape[cdim]
    data, space = mesh.shape["data"], mesh.shape["space"]
    if c % data:
        raise ValueError(f"{c} clips do not split over {data} data rows")
    per = c // data
    bands = row_bands(images.shape[rdim], space, kpe_ops.HALO)
    shards = []
    for d in range(data):
        row = []
        for s, (lo, hi) in enumerate(bands):
            piece = images[d * per:(d + 1) * per, :, lo:hi]
            dev = mesh.devices[d][s]
            if isinstance(piece, np.ndarray):
                row.append(upload(np.ascontiguousarray(piece), dev))
            else:
                row.append(piece.contiguous().to(dev))
        shards.append(row)
    clips = [range(clip_base + d * per, clip_base + (d + 1) * per)
             for d in range(data)]
    return PlacedBatch(mesh=mesh, shape=tuple(images.shape), clips=clips,
                       bands=bands, shards=shards)


class DataShard(NamedTuple):
    """One data row's per-clip outputs (global clip numbers ``clips``),
    on the first device of its space group."""

    clips: range
    device: torch.device
    offsets: torch.Tensor    # [c, T, 2] int32
    matched: torch.Tensor    # [c, T] bool
    positions: torch.Tensor  # [c, T, 2] int32


class AtlasShard(NamedTuple):
    """One device's band of atlas rows for its data row's clips."""

    clips: range
    rows: range
    device: torch.device
    atlas: torch.Tensor      # [c, len(rows), AW, 16] uint16


class ShardedResult(NamedTuple):
    data: list    # DataShard per data row
    atlas: list   # AtlasShard per mesh device, row-major over the mesh


def make_sharded_step(mesh: Mesh, layout: GridLayout, cfg: PipelineConfig,
                      atlas_pad: int = 64):
    """Build ``step(images) -> ShardedResult``: :func:`make_pipeline_step`
    over a ``('data', 'space')`` mesh, with the JAX package's layout
    (``remap_tpu/parallel/sharded.py:389``): clips over ``data``, frame
    and atlas rows over ``space``.  ``images`` is this process's
    ``[C, T, H, W]`` uint8 clips, or their :func:`place_clips` /
    ``distributed.make_global_batch``.

    Each data row runs the step on its clips.  Its space group:

    - grid_vote: each device extracts (K1) its band of frame rows over
      the band plus ``HALO`` rows of each neighbour's band (the halo
      exchange), which gives the band's rows of the whole frames' K1;
    - its first device gathers K1's weights and codes (or, for the
      correlation families, the frame rows) and builds the tables (K2),
      matches and takes the positions (a region straddles band edges,
      so per-band tables would need a first-K merge; the families' FFTs
      are global), once: the host queues every device's work in turn,
      so a match repeated on each device would cost its dispatch once a
      device;
    - every device gathers the frame rows and the anchored positions
      and votes (K3) its band of atlas rows alone, a ``RowClip``
      dropping every vote outside it.

    The outputs equal ``make_pipeline_step``'s on the same clips
    (:func:`assemble` puts them together).  Raises for an unknown table
    mode, and where a shard's device or a copy fails: nothing drops back
    to the serial step."""
    h, w = layout.height, layout.width
    ah, aw = h + 2 * atlas_pad, w + 2 * atlas_pad
    family = models.family(cfg, layout)
    data, space = mesh.shape["data"], mesh.shape["space"]
    frame_bands = row_bands(h, space, kpe_ops.HALO)
    atlas_bands = row_bands(ah, space)

    def band_extract(bands, s: int, dev: torch.device):
        """K1 on band ``s`` plus its halo rows, cut to the band's rows:
        (weight, codes) ``[c*T, rows, W]``."""
        lo, hi = frame_bands[s]
        above = [bands[s - 1][:, :, -kpe_ops.HALO:].to(dev)] if s else []
        below = ([bands[s + 1][:, :, :kpe_ops.HALO].to(dev)]
                 if s < space - 1 else [])
        sub = torch.cat(above + [bands[s]] + below, dim=2)
        c, t, hs, _ = sub.shape
        top = lo - (kpe_ops.HALO if s else 0)
        dense = kpe_ops.extract_dense(sub.reshape(c * t, hs, w),
                                      kpe_ops.RowBand.of(layout, top, hs))
        k = lo - top
        return (dense.weight[:, k:k + hi - lo],
                dense.codes[:, k:k + hi - lo])

    def step(images) -> ShardedResult:
        batch = (images if isinstance(images, PlacedBatch)
                 else place_clips(images, mesh))
        if batch.mesh != mesh or tuple(batch.shape[2:]) != (h, w):
            raise ValueError(f"clips {batch.shape} placed on another mesh "
                             f"or not of {h}x{w} frames")
        data_shards, atlas_shards = [], []
        for d in range(data):
            group, bands = mesh.devices[d], batch.shards[d]
            parts = []
            if family.keypoints:
                for s in range(space):
                    with current(group[s]):
                        parts.append(band_extract(bands, s, group[s]))
            lead = group[0]
            with current(lead):
                frames = torch.cat([b.to(lead) for b in bands], dim=2)
                dense = None
                if parts:
                    dense = kpe_ops.DenseExtract(
                        median=None,
                        weight=torch.cat([p[0].to(lead) for p in parts],
                                         dim=1),
                        codes=torch.cat([p[1].to(lead) for p in parts],
                                        dim=1))
                offsets, matched, positions = _align(frames, family, dense)
                anchored = _anchor(positions, atlas_pad, aw - w, ah - h)
            data_shards.append(DataShard(batch.clips[d], lead, offsets,
                                         matched, positions))
            for s, (a0, a1) in enumerate(atlas_bands):
                dev = group[s]
                with current(dev):
                    if not same_device(frames.device, dev):
                        # a shard on another device gathers them there
                        frames = torch.cat([b.to(dev) for b in bands], dim=2)
                        anchored = anchored.to(dev)
                    atlas = _vote_windows(frames, anchored, ah, aw,
                                          rows=(a0, a1))
                atlas_shards.append(AtlasShard(batch.clips[d], range(a0, a1),
                                               dev, atlas))
        return ShardedResult(data=data_shards, atlas=atlas_shards)

    return step


def assemble(result: ShardedResult) -> StepResult:
    """A sharded step's outputs for this process's clips, put together on
    the host (CPU tensors) in ``make_pipeline_step``'s layout, the clips
    in order from this process's first."""
    data = sorted(result.data, key=lambda sh: sh.clips.start)
    base = data[0].clips.start
    n = data[-1].clips.stop - base
    ah = max(sh.rows.stop for sh in result.atlas)
    aw, depth = result.atlas[0].atlas.shape[2:]
    atlas = torch.zeros((n, ah, aw, depth), dtype=torch.uint16)
    for sh in result.atlas:
        atlas[sh.clips.start - base:sh.clips.stop - base,
              sh.rows.start:sh.rows.stop] = sh.atlas.cpu()
    return StepResult(
        offsets=torch.cat([sh.offsets.cpu() for sh in data]),
        matched=torch.cat([sh.matched.cpu() for sh in data]),
        positions=torch.cat([sh.positions.cpu() for sh in data]),
        atlas=atlas)
