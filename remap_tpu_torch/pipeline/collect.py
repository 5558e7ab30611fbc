"""The collect stage (port of remap_tpu/pipeline/collect.py, frc.hpp).

Two passes, as in the JAX package:

1. **Match pass** (:func:`match_pass`): frames stream through the device
   in batches of ``frame_batch``; one step extracts medians, weights and
   codes (K1), builds the region tables (K2) and matches every consecutive
   pair, carrying the previous batch's last tables across the boundary.
   Per-frame scalars come back stacked (``[B, 7]`` int32) through a
   non-blocking copy, ``collect_drain_depth`` batches behind the dispatch.
   Frames land packed in the store, their device copies kept as its
   mirror.  A feed with ``read_packed_batch`` (``io.frames``) serves its
   batches packed by the native reader, read one batch ahead on a worker
   thread, so nothing packs on the host.
2. **Blit pass** (:func:`blit_pass`): per fragment, the reference's canvas
   growth is replayed on the host and the stored frames are voted into a
   device canvas in chunks (K3, in place over each chunk's box).

:func:`collect` runs both with the strict escalation ladder between them:
a pass whose tables overflowed, whose join truncated or whose vote radius
could matter re-matches the flagged pairs (or replays the clip when most
are flagged) under escalated limits until every declaration is exact.
A replay reads its batches back from the store as packed rows
(:class:`StoreReplay`): from the device mirror when it holds them, else
uploaded from the host rows.
Under the correlation families (``cfg.matcher`` "xcorr" / "pyramid",
``models``) the match pass matches the frames themselves, carrying the
previous batch's last frame, and raises no escalation flag; its K1
launch is the medians-only instantiation, since no table is read there
(the JAX package also builds the tables it never reads).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import GridLayout, make_layout
from remap_tpu_torch.device import HostCopy, get_device, same_device, upload
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import tables as table_ops
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.parallel.sharded import match_pairs as _match
from remap_tpu_torch.pipeline.state import (
    Fragment, FrameRef, FrameStore, pack_nibbles_batch, pack_nibbles_device,
    simulate_growth, unpack_nibbles_device,
)
from remap_tpu_torch.utils import profiling

Segments = List[Tuple[List[int], List[Tuple[int, int]]]]

#: the largest table capacity the strict ladder escalates to
MAX_CAPACITY = 1 << 14


@dataclasses.dataclass(eq=False)
class CollectResult:
    fragments: List[Fragment]
    store: FrameStore
    #: offsets[t] is the declared offset of frame t vs t-1 (offsets[0] = 0).
    offsets: np.ndarray      # [N, 2] int32
    matched: np.ndarray      # [N] bool (matched[0] = False)
    overflow_frames: int


def _store_budget(cfg: PipelineConfig, device) -> int:
    """Device-mirror byte budget from ``cfg.frame_store``: "hbm" keeps
    whole sessions resident, "host" disables the mirrors, "auto" is "hbm"
    on CUDA and "host" on the CPU."""
    mode = cfg.frame_store
    if mode == "auto":
        mode = "hbm" if torch.device(device).type == "cuda" else "host"
    if mode == "hbm":
        return FrameStore.HBM_STORE_BUDGET
    if mode == "host":
        return 0
    return FrameStore.DEVICE_MIRROR_CAP


def _kp_need(tabs: table_ops.RegionTables) -> torch.Tensor:
    """[B] true per-frame keypoint maximum over regions (wcounts count the
    whole region, not the kept rows)."""
    return tabs.wcounts.sum(dim=-1).max(dim=-1).values


def _stack_scalars(offset, ok, tab_ovf, join_ovf, range_ovf, kp_need):
    """The per-frame scalars stacked into one ``[B, 7]`` int32 tensor, so
    a batch costs one fetch."""
    cols = [offset] + [c[:, None] for c in (ok, tab_ovf, join_ovf, range_ovf,
                                            kp_need)]
    return torch.cat([c.to(torch.int32) for c in cols], dim=1)


def make_collect_step(layout: GridLayout, cfg: PipelineConfig):
    """The pass-1 step for a fixed layout and config:
    ``step(images [B, H, W] uint8, carry) -> (packed medians [B, H,
    ceil(W/2)] uint8, scalars [B, 7] int32, new carry)``, on the device of
    ``images``.  The carry is (the previous batch's last tables, its last
    frame): the grid_vote matcher reads the tables, the correlation
    families the frame."""
    table_ops.check_table_mode(cfg.table_mode)
    frame_matcher = (None if cfg.matcher == "grid_vote"
                     else models.get_matcher(cfg.matcher, cfg))

    def step(images: torch.Tensor, carry):
        carry_tabs, carry_frame = carry
        new_frame = images[-1:].clone()
        if frame_matcher is not None:
            prev_frames = torch.cat([carry_frame, images[:-1]], dim=0)
            offset, ok = frame_matcher(prev_frames, images)
            none = torch.zeros_like(ok)
            scalars = _stack_scalars(offset, ok, none, none, none,
                                     torch.zeros_like(ok, dtype=torch.int32))
            median = kpe_ops.extract_medians(images, layout)
            return (pack_nibbles_device(median), scalars,
                    (carry_tabs, new_frame))
        dense = kpe_ops.extract_dense(images, layout)
        tabs = table_ops.build_tables(dense.weight, dense.codes, layout,
                                      cfg.region_capacity, cfg.table_mode)
        prev = table_ops.RegionTables(*(
            torch.cat([c, t[:-1]], dim=0) for c, t in zip(carry_tabs, tabs)))
        res = _match(prev, tabs, layout, cfg)
        # three separate escalation signals: table capacity (raise
        # capacity), join truncation (raise multiplicity), vote-radius
        # bound (count exactly); kp_need lets the ladder jump the
        # capacity in one step
        scalars = _stack_scalars(res.offset, res.ok,
                                 tabs.overflow.any(dim=-1), res.overflow,
                                 res.range_overflow, _kp_need(tabs))
        new_tabs = table_ops.RegionTables(*(t[-1:].clone() for t in tabs))
        return (pack_nibbles_device(dense.median), scalars,
                (new_tabs, new_frame))

    return step


def split_step_scalars(scalars: np.ndarray):
    """(offsets, ok, tab_ovf, join_ovf, range_ovf, kp_need) from the
    stacked [B, 7] int32 the collect step returns."""
    return (
        scalars[:, 0:2],
        scalars[:, 2] > 0,
        scalars[:, 3] > 0,
        scalars[:, 4] > 0,
        scalars[:, 5] > 0,
        scalars[:, 6],
    )


class StoreReplay:
    """A replay's frames, read back from the store the first pass filled:
    each batch is the stored packed rows on the device, gathered from the
    store's frame mirror when it holds them and uploaded from the host
    rows otherwise, so nothing is unpacked or packed again.
    :func:`match_pass` takes it in place of host frames."""

    def __init__(self, store: FrameStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def batch(self, start: int, b: int) -> Tuple[torch.Tensor, int]:
        """The packed frames from ``start``, padded to ``b`` rows by
        repeating the last (as host batches pad), and how many are
        real."""
        n_real = min(b, len(self) - start)
        numbers = (list(range(start, start + n_real))
                   + [start + n_real - 1] * (b - n_real))
        if self.store.mirrored >= start + n_real:
            profiling.count("collect.replay_mirror_frames", b)
            return self.store.device_packed_batch(numbers), n_real
        with profiling.span("collect.host_pack"):
            return self.store.device_packed_batch(numbers), n_real


def _empty_carry(layout: GridLayout, capacity: int, device):
    """The carry before the first frame: empty tables and a zero frame
    (frame 0's declaration is forced to no-match whatever they give)."""
    return (table_ops.empty_tables(layout.region_count, capacity, device),
            torch.zeros((1, layout.height, layout.width), dtype=torch.uint8,
                        device=device))


def match_pass(
    frames: Iterable[np.ndarray],
    layout: GridLayout,
    cfg: PipelineConfig,
    store: Optional[FrameStore] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           int]:
    """Pass 1 on ``device`` (CUDA unless the caller asks for the CPU):
    per-frame match offsets and flags, filling ``store`` when given.
    ``frames`` is an iterable of host frames, a feed with
    ``read_packed_batch`` or a :class:`StoreReplay` (a replay, with no
    ``store`` to fill).

    Returns (offsets, matched, table_flags, join_flags, range_flags,
    kp_need): the three per-frame escalation signals kept apart (table
    capacity or sort2-quota overflow of frame t's tables, join
    truncation and the vote-radius bound of the (t-1, t) declaration),
    and the clip's true maximum per-region keypoint count."""
    dev = get_device(device)
    step = make_collect_step(layout, cfg)
    b = cfg.frame_batch

    offsets: List[np.ndarray] = []
    matched: List[np.ndarray] = []
    tab_flags: List[np.ndarray] = []
    join_flags: List[np.ndarray] = []
    range_flags: List[np.ndarray] = []
    kp_need = 0
    carry = _empty_carry(layout, cfg.region_capacity, dev)
    pending: deque = deque()
    depth = max(1, cfg.collect_drain_depth)

    def drain(p) -> None:
        """Take one dispatched step's outputs, waiting for its copies
        alone."""
        nonlocal kp_need
        num, n_real, packed, packed_dev, median, fetched = p
        host = fetched.wait()
        off, ok, tovf, jovf, rovf, kpn = split_step_scalars(host[0][:n_real])
        offsets.append(off)
        matched.append(ok)
        tab_flags.append(tovf)
        join_flags.append(jovf)
        range_flags.append(rovf)
        kp_need = max(kp_need, int(kpn.max(initial=0)))
        if store is not None:
            store.put_packed_batch(
                list(range(num, num + n_real)),
                packed[:n_real],
                host[1][:n_real] if cfg.store_medians else None,
                device_packed=packed_dev[:n_real],
                device_packed_medians=(median[:n_real] if cfg.store_medians
                                       else None),
            )

    def dispatch(number, n_real, packed, width, packed_dev=None) -> None:
        """Run the step on one packed batch: frames cross packed (2
        px/byte) and unpack on the device; the device copy is donated to
        the store's mirror, so the blit and foreground passes never upload
        them again.  A batch already on the device (``packed_dev``)
        crosses nothing."""
        nonlocal carry
        if packed_dev is None:
            packed_dev = upload(packed, dev)
        median, scalars, carry = step(
            unpack_nibbles_device(packed_dev, width), carry)
        fetched = (HostCopy(scalars, median) if cfg.store_medians
                   else HostCopy(scalars))
        pending.append((number, n_real, packed, packed_dev, median, fetched))
        # keep up to `depth` batches in flight: batch n is drained after
        # batch n+depth is dispatched
        if len(pending) >= depth:
            drain(pending.popleft())

    replay = frames if isinstance(frames, StoreReplay) else None
    feed = frames if hasattr(frames, "read_packed_batch") else None
    it = None if feed is not None or replay is not None else iter(frames)
    # the feed reads batch n+1 on a worker thread (the native reader, off
    # the GIL) while the device computes batch n
    pool = ThreadPoolExecutor(max_workers=1) if feed is not None else None
    fut = pool.submit(feed.read_packed_batch, 0, b) if pool else None
    number = 0
    try:
        while True:
            packed_dev = None
            if replay is not None:
                # the stored packed rows, already on the device
                if number >= len(replay):
                    break
                packed_dev, n_real = replay.batch(number, b)
                packed, width = None, replay.store.width
            elif feed is not None:
                # packed by the native reader: nothing packs or unpacks on
                # the host
                with profiling.span("collect.feed_wait"):
                    packed = fut.result()
                n_real = len(packed)
                if n_real == 0:
                    break
                if n_real == b:
                    fut = pool.submit(feed.read_packed_batch,
                                      number + n_real, b)
                else:
                    packed = np.concatenate(
                        [packed, np.repeat(packed[-1:], b - n_real, axis=0)])
                width = layout.width
            else:
                with profiling.span("collect.host_pack"):
                    batch = list(itertools.islice(it, b))
                    if not batch:
                        break
                    n_real = len(batch)
                    stacked = np.stack(batch + [batch[-1]] * (b - n_real))
                    packed = pack_nibbles_batch(stacked)
                width = stacked.shape[-1]
            dispatch(number, n_real, packed, width, packed_dev)
            number += n_real
            if n_real < b:
                break
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    while pending:
        drain(pending.popleft())

    if not offsets:
        z = np.zeros((0,), bool)
        return np.zeros((0, 2), np.int32), z, z, z, z, 0
    off = np.concatenate(offsets)
    ok = np.concatenate(matched)
    # frame 0 never matches anything (frc.hpp:83-95)
    ok[0] = False
    off[0] = 0
    off[~ok] = 0
    return (
        off, ok,
        np.concatenate(tab_flags),
        np.concatenate(join_flags),
        np.concatenate(range_flags),
        kp_need,
    )


def make_pair_step(layout: GridLayout, cfg: PipelineConfig):
    """Re-match of arbitrary (prev, curr) frame pairs for the strict
    ladder: every (t-1, t) declaration depends on frames t-1 and t alone,
    so a retry recomputes exactly the flagged pairs.
    ``pair_step(prev [B, H, W], curr [B, H, W]) -> scalars [B, 7] int32``,
    laid out as the collect step's (tab flags either endpoint's, kp_need
    the larger).  It is the grid_vote matcher's: the correlation families
    raise no flag, so the ladder never re-matches their pairs."""
    table_ops.check_table_mode(cfg.table_mode)

    def tables(images):
        dense = kpe_ops.extract_dense(images, layout)
        return table_ops.build_tables(dense.weight, dense.codes, layout,
                                      cfg.region_capacity, cfg.table_mode)

    def pair_step(prev_images: torch.Tensor, curr_images: torch.Tensor):
        tp, tc = tables(prev_images), tables(curr_images)
        res = _match(tp, tc, layout, cfg)
        return _stack_scalars(
            res.offset, res.ok,
            tp.overflow.any(dim=-1) | tc.overflow.any(dim=-1),
            res.overflow, res.range_overflow,
            torch.maximum(_kp_need(tp), _kp_need(tc)))

    return pair_step


def repair_pairs(
    pair_idx: List[int],
    store: FrameStore,
    layout: GridLayout,
    cfg: PipelineConfig,
    offsets: np.ndarray,
    matched: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Re-match the pairs (t-1, t) for every t in ``pair_idx`` under
    ``cfg`` on the store's device, writing the new declarations into
    ``offsets``/``matched`` in place.  Frames come from the store's
    mirror when it holds them.  Returns per-pair (tab, join, range) flag
    arrays aligned with ``pair_idx`` and the pairs' true max per-region
    keypoint count."""
    step = make_pair_step(layout, cfg)
    b = cfg.frame_batch
    tabs = np.zeros(len(pair_idx), bool)
    joins = np.zeros(len(pair_idx), bool)
    ranges = np.zeros(len(pair_idx), bool)
    kp_need = 0
    for i in range(0, len(pair_idx), b):
        chunk = list(pair_idx[i:i + b])
        n_real = len(chunk)
        pad = chunk + [chunk[-1]] * (b - n_real)
        prev_imgs = unpack_nibbles_device(
            store.device_packed_batch([t - 1 for t in pad]), store.width)
        curr_imgs = unpack_nibbles_device(store.device_packed_batch(pad),
                                          store.width)
        scalars = step(prev_imgs, curr_imgs).cpu().numpy()[:n_real]
        off, ok, tab, jov, rov, kpn = split_step_scalars(scalars)
        for k, t in enumerate(chunk):
            matched[t] = ok[k]
            offsets[t] = off[k] if ok[k] else 0
        tabs[i:i + n_real] = tab
        joins[i:i + n_real] = jov
        ranges[i:i + n_real] = rov
        kp_need = max(kp_need, int(kpn.max(initial=0)))
    return tabs, joins, ranges, kp_need


def segment_positions(offsets: np.ndarray, matched: np.ndarray) -> Segments:
    """Fragment segmentation + per-frame positions (frc.hpp:109-115): a
    match failure starts a new fragment at (0, 0).  The first frame must
    be unmatched (it always is: nothing precedes it)."""
    segments: Segments = []
    pos = (0, 0)
    for t in range(len(offsets)):
        if not matched[t]:
            segments.append(([], []))
            pos = (0, 0)
        else:
            pos = (pos[0] + int(offsets[t, 0]), pos[1] + int(offsets[t, 1]))
        segments[-1][0].append(t)
        segments[-1][1].append(pos)
    return segments


def padded_chunk(store: FrameStore, numbers: List[int], b: int,
                 medians: bool = False, device=None) -> torch.Tensor:
    """The stored frames (or medians) ``numbers``, unpacked on the store's
    device (or on ``device``, uploaded from the host rows: the store's
    mirrors live on its own device) and padded with zero frames to
    ``b``."""
    if device is not None and not same_device(device, store.device):
        packed = upload(store.packed_medians_batch(numbers) if medians
                        else store.packed_images_batch(numbers),
                        torch.device(device))
    else:
        packed = (store.device_packed_medians_batch(numbers) if medians
                  else store.device_packed_batch(numbers))
    if len(numbers) < b:
        packed = torch.cat([packed, packed.new_zeros(
            (b - len(numbers),) + tuple(packed.shape[1:]))])
    return unpack_nibbles_device(packed, store.width)


def chunk_positions(positions, zero: Tuple[int, int], b: int,
                    device) -> torch.Tensor:
    """Canvas positions ``[b, 2]`` int32 of a chunk, padding frames at
    (0, 0)."""
    apos = np.array([(px - zero[0], py - zero[1]) for px, py in positions]
                    + [(0, 0)] * (b - len(positions)), np.int32)
    return upload(apos, torch.device(device))


def chunk_box(positions, zero: Tuple[int, int], h: int,
              w: int) -> Tuple[int, int, int, int]:
    """The canvas box ``(x_lo, y_lo, x_hi, y_hi)`` that a chunk's ``h x w``
    frames cover (the host bound that sizes K3's grid)."""
    return kblit.frames_box(np.subtract(positions, zero), h, w)


def blit_pass(segments: Segments, store: FrameStore,
              cfg: PipelineConfig) -> List[Fragment]:
    """Build each fragment's canvas with chunked in-place blits of its
    stored frames (K3 on the card, its plain version on the CPU) over the
    box each chunk covers.  The canvases stay on the store's device."""
    fh, fw = store.height, store.width
    b = cfg.frame_batch
    dev = store.device
    fragments: List[Fragment] = []
    for numbers, positions in segments:
        zero, (cw, ch) = simulate_growth(positions, fw, fh)
        dots = atlas_ops.empty_canvas(ch, cw, dev)
        for i in range(0, len(numbers), b):
            chunk = numbers[i:i + b]
            imgs = padded_chunk(store, chunk, len(chunk))
            apos = chunk_positions(positions[i:i + b], zero, len(chunk), dev)
            kblit.blit_frames_(imgs, apos, dots,
                               box=chunk_box(positions[i:i + b], zero, fh, fw))
        frag = Fragment(
            dots_dev=dots, shape=(ch, cw), zero=zero,
            frames=[FrameRef(number=no, position=p)
                    for no, p in zip(numbers, positions)],
            store=store,
        )
        frag.normalize()
        fragments.append(frag)
    return fragments


def _pair_flags(tabf: np.ndarray, joinf: np.ndarray, rangef: np.ndarray):
    """Per-PAIR flags: the (t-1, t) declaration is suspect if either
    endpoint's tables overflowed or the pair's join/radius bound tripped.
    Pair 0 is exempt: its declaration is forced to no-match
    (frc.hpp:83-95)."""
    ptab = tabf.copy()
    if len(ptab):
        ptab[1:] |= tabf[:-1]
        ptab[0] = joinf[0] = rangef[0] = False
    return ptab, joinf, rangef


def collect(
    frames: Iterable[np.ndarray],
    cfg: PipelineConfig,
    layout: Optional[GridLayout] = None,
    strict: bool = True,
    device=None,
) -> CollectResult:
    """Full collect stage on ``device`` (CUDA unless the caller asks for
    the CPU): returns normalized fragments (frc.hpp:74-80).

    With ``strict`` (default), a pass that hits table-capacity,
    join-multiplicity or vote-radius overflow re-runs with escalated
    limits until the results are provably exhaustive.  Capacity
    escalation jumps straight to the measured keypoint maximum; join
    escalation walks multiplicity 4x then dense; only flagged pairs
    re-match when they are a minority; ``overflow_frames`` counts the
    pairs left inexact when the ladder gives up."""
    dev = get_device(device)
    empty = CollectResult([], FrameStore(0, 0, device=dev),
                          np.zeros((0, 2), np.int32), np.zeros((0,), bool), 0)
    if hasattr(frames, "read_packed_batch"):
        # a feed (io.frames): the match pass reads its packed batches
        if len(frames) == 0:
            return empty
        h, w = frames.out_dims
        source = frames
    else:
        frames = iter(frames)
        first = next(frames, None)
        if first is None:
            return empty
        h, w = first.shape
        source = itertools.chain([first], frames)
    if layout is None:
        layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                             cfg.grid_overlap)
    store = FrameStore(h, w, device_budget=_store_budget(cfg, dev),
                       device=dev)

    with profiling.span("collect.pass", device=dev, rung=0,
                        capacity=cfg.region_capacity,
                        multiplicity=cfg.join_multiplicity, replay=False):
        offsets, matched, tabf, joinf, rangef, kp_need = match_pass(
            source, layout, cfg, store, dev)
    n = len(offsets)
    ptab, pjoin, prange = _pair_flags(tabf, joinf, rangef)

    ecfg = cfg
    rung = 0
    while strict and (ptab.any() or pjoin.any() or prange.any()):
        rung += 1
        # Escalate ONLY the limit that tripped, and re-match ONLY the
        # flagged pairs: the stability bounds prove every unflagged
        # declaration equals its exhaustive recomputation.
        if ptab.any():
            if ecfg.table_mode == "sort2":
                # sort2's chunk-quota flag is density-based: capacity can
                # never clear it, so switch to the quota-free topk
                # selection first, with everything else unchanged
                ecfg = dataclasses.replace(ecfg, table_mode="topk")
            elif ecfg.region_capacity >= MAX_CAPACITY:
                break  # give up: caller sees overflow_frames > 0
            else:
                # count-guided jump: go straight to the power of two that
                # holds the measured max per-region keypoint count
                new_cap = max(ecfg.region_capacity * 2, 256)
                while new_cap < min(kp_need, MAX_CAPACITY):
                    new_cap *= 2
                ecfg = dataclasses.replace(
                    ecfg,
                    region_capacity=min(new_cap, MAX_CAPACITY),
                    vote_radius=0,
                )
        elif pjoin.any():
            # 4x multiplicity, then the exhaustive dense join (0); the
            # table capacity stays put
            if ecfg.join_multiplicity == 0:
                break  # dense is exact; overflow here is impossible
            next_mult = 0 if ecfg.join_multiplicity >= 16 else (
                ecfg.join_multiplicity * 4
            )
            capacity = ecfg.region_capacity
            # bound the retry batch by the join working set (the JAX
            # package's ~2 GB sizing; the results do not depend on it)
            if next_mult == 0:
                per_frame = layout.region_count * capacity * capacity * 4
            else:
                per_frame = (
                    layout.region_count * 2 * capacity * 4 * next_mult * 8
                )
            batch = max(1, min(ecfg.frame_batch, (2 << 30) // per_frame))
            ecfg = dataclasses.replace(
                ecfg,
                join_multiplicity=next_mult,
                frame_batch=batch,
                vote_radius=0,   # escalated retries always count exactly
            )
        else:
            # only the vote-histogram radius tripped: retry with exact
            # full-range counting alone
            ecfg = dataclasses.replace(ecfg, vote_radius=0)
        pairs = np.flatnonzero(ptab | pjoin | prange).tolist()
        b = ecfg.frame_batch
        if len(pairs) > n // 2:
            # majority flagged: a full replay extracts each frame once
            # where pair repair extracts both endpoints per pair
            with profiling.span("collect.pass", device=dev, rung=rung,
                                capacity=ecfg.region_capacity,
                                multiplicity=ecfg.join_multiplicity,
                                replay=True):
                offsets, matched, tabf, joinf, rangef, kp_need = match_pass(
                    StoreReplay(store), layout, ecfg, None, dev)
                # K1 ran on every batch, the last one padded
                profiling.count("collect.rematched_frames", -(-n // b) * b)
            ptab, pjoin, prange = _pair_flags(tabf, joinf, rangef)
        else:
            with profiling.span("collect.repair", device=dev, rung=rung,
                                pairs=len(pairs),
                                capacity=ecfg.region_capacity):
                rtab, rjoin, rrange, kp_need = repair_pairs(
                    pairs, store, layout, ecfg, offsets, matched)
                # both endpoints of every padded chunk
                profiling.count("collect.rematched_frames",
                                2 * -(-len(pairs) // b) * b)
            ptab[:] = pjoin[:] = prange[:] = False
            ptab[pairs] = rtab
            pjoin[pairs] = rjoin
            prange[pairs] = rrange

    segments = segment_positions(offsets, matched)
    with profiling.span("collect.blit"):
        fragments = blit_pass(segments, store, cfg)
    return CollectResult(
        fragments=fragments,
        store=store,
        offsets=offsets,
        matched=matched,
        overflow_frames=int((ptab | pjoin | prange).sum()),
    )
