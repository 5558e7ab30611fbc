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
The step matches by ``cfg.matcher``'s family (``models.family``): the
correlation families match the frames themselves, carrying the previous
batch's last frame, and raise no escalation flag.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import GridLayout, make_layout
from remap_tpu_torch.device import HostCopy, get_device, same_device, upload
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops.kernels import blit as kblit
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


def store_budget(cfg: PipelineConfig, device) -> int:
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


def _stack_scalars(offset, ok, tab_ovf, join_ovf, range_ovf, kp_need):
    """The per-frame scalars stacked into one ``[B, 7]`` int32 tensor, so
    a batch costs one fetch."""
    cols = [offset] + [c[:, None] for c in (ok, tab_ovf, join_ovf, range_ovf,
                                            kp_need)]
    return torch.cat([c.to(torch.int32) for c in cols], dim=1)


def _untraced(name: str, device=None):
    return contextlib.nullcontext()


def _keep(median: torch.Tensor, scalars: torch.Tensor):
    return median, scalars


def make_collect_step(layout: GridLayout, cfg: PipelineConfig,
                      traced: bool = False):
    """The pass-1 step for a fixed layout and config:
    ``step(images [B, H, W] uint8, carry) -> (packed medians [B, H,
    ceil(W/2)] uint8, scalars [B, 7] int32, new carry)``, on the device of
    ``images``.  The carry is the previous batch's last features under
    ``cfg.matcher``'s family (``models.family``): grid_vote's tables, the
    correlation families' frame.  The three escalation signals stay apart
    (raise capacity, raise multiplicity, count exactly); each frame's
    kp_need lets the ladder choose the capacity its pairs need.
    ``step(images, carry, fetch)`` returns ``fetch(packed medians,
    scalars)`` in place of the pair, fetched inside the step's tail.

    With ``traced``, each phase is a span with CUDA events on the images'
    device: ``collect.features``, ``collect.match`` (the keypoint
    family's alone: the correlation families name their own levels, such
    as ``pyramid.coarse``, directly under the pass) and
    ``collect.scalars`` (the flags, the stacked scalars, the packed
    medians and ``fetch``)."""
    family = models.family(cfg, layout)
    span = profiling.span if traced else _untraced
    match_span = span if family.keypoints else _untraced

    def step(images: torch.Tensor, carry, fetch=_keep):
        dev = images.device
        with span("collect.features", device=dev):
            features, medians = family.features(images)
        with match_span("collect.match", device=dev):
            res, carry = family.align(features, carry)
        with span("collect.scalars", device=dev):
            scalars = _stack_scalars(*res[:2], *family.flags(res, features))
            return (*fetch(pack_nibbles_device(medians()), scalars), carry)

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

    def batch(self, start: int, b: int) -> Tuple[Callable, int]:
        """A call that gives the packed frames from ``start`` on the
        device, padded to ``b`` rows by repeating the last (as host
        batches pad), and how many are real.  The mirror's gather runs in
        the call (the batch loop makes it in its upload span); host rows
        are uploaded at once, under ``collect.host_pack``."""
        n_real = min(b, len(self) - start)
        numbers = (list(range(start, start + n_real))
                   + [start + n_real - 1] * (b - n_real))
        if self.store.mirrored >= start + n_real:
            return (lambda: self.store.device_packed_batch(numbers)), n_real
        with profiling.span("collect.host_pack"):
            rows = self.store.device_packed_batch(numbers)
        return (lambda: rows), n_real


class BatchLoop:
    """The match pass's per-batch dispatch, drain and store (also the
    streaming stitcher's): each batch runs the collect step on the carry,
    its scalars (and medians) come back through a non-blocking copy
    ``depth`` batches behind, and its frames land in ``store``, if any.
    With ``traced`` (the match pass), each batch's phases are spans: its
    upload (``collect.upload``), the step's (:func:`make_collect_step`)
    and its store (``collect.store``, on the host)."""

    def __init__(self, layout: GridLayout, cfg: PipelineConfig,
                 store: Optional[FrameStore], device, depth: int,
                 traced: bool = False):
        self.cfg, self.store, self.device = cfg, store, device
        self.depth = max(1, depth)
        self.span = profiling.span if traced else _untraced
        self.step = make_collect_step(layout, cfg, traced)
        self.carry = models.family(cfg, layout).empty_carry(device)
        self.pending: deque = deque()
        #: per drained batch: split_step_scalars of its real frames, frame
        #: 0 and every unmatched frame at offset 0
        self.drained = [split_step_scalars(np.zeros((0, 7), np.int32))]

    def dispatch(self, number: int, n_real: int, packed, width: int,
                 rows: Optional[Callable] = None) -> None:
        """Run the step on one packed batch: frames cross packed (2
        px/byte) and unpack on the device; the device copy is donated to
        the store's mirror, so the blit and foreground passes never upload
        them again.  A batch already on the device (``rows()`` gives it)
        crosses nothing."""
        with self.span("collect.upload", device=self.device):
            packed_dev = (upload(packed, self.device) if rows is None
                          else rows())
            images = unpack_nibbles_device(packed_dev, width)
        median, fetched, self.carry = self.step(images, self.carry,
                                                self._fetch)
        self.pending.append(
            (number, n_real, packed, packed_dev, median, fetched))
        # keep up to `depth` batches in flight: batch n is drained after
        # batch n+depth is dispatched
        if len(self.pending) >= self.depth:
            self.drain()

    def _fetch(self, median: torch.Tensor, scalars: torch.Tensor):
        return median, (HostCopy(scalars, median) if self.cfg.store_medians
                        else HostCopy(scalars))

    def drain(self) -> None:
        """Take the oldest dispatched batch's outputs, waiting for its
        copies alone."""
        num, n_real, packed, packed_dev, median, fetched = (
            self.pending.popleft())
        host = fetched.wait()
        off, ok, *flags = split_step_scalars(host[0][:n_real])
        if num == 0:
            ok[0] = False  # frame 0 never matches anything (frc.hpp:83-95)
        off[~ok] = 0
        self.drained.append((off, ok, *flags))
        if self.store is not None:
            medians = self.cfg.store_medians
            with self.span("collect.store"):
                self.store.put_packed_batch(
                    list(range(num, num + n_real)), packed[:n_real],
                    host[1][:n_real] if medians else None,
                    device_packed=packed_dev[:n_real],
                    device_packed_medians=(median[:n_real] if medians
                                           else None))

    def results(self):
        """Everything in flight drained: (offsets, matched, table_flags,
        join_flags, range_flags, kp_need) of every frame."""
        while self.pending:
            self.drain()
        return tuple(map(np.concatenate, zip(*self.drained)))


def match_pass(
    frames: Iterable[np.ndarray],
    layout: GridLayout,
    cfg: PipelineConfig,
    store: Optional[FrameStore] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """Pass 1 on ``device`` (CUDA unless the caller asks for the CPU):
    per-frame match offsets and flags, filling ``store`` when given.
    ``frames`` is an iterable of host frames, a feed with
    ``read_packed_batch`` or a :class:`StoreReplay` (a replay, with no
    ``store`` to fill).

    Returns (offsets, matched, table_flags, join_flags, range_flags,
    kp_need): the three per-frame escalation signals kept apart (table
    capacity or sort2-quota overflow of frame t's tables, join
    truncation and the vote-radius bound of the (t-1, t) declaration),
    and each frame's true maximum per-region keypoint count."""
    dev = get_device(device)
    loop = BatchLoop(layout, cfg, store, dev, cfg.collect_drain_depth,
                     traced=True)
    b = n_real = cfg.frame_batch
    replay = frames if isinstance(frames, StoreReplay) else None
    feed = frames if hasattr(frames, "read_packed_batch") else None
    it = None if feed is not None or replay is not None else iter(frames)
    # the feed reads batch n+1 on a worker thread (the native reader, off
    # the GIL) while the device computes batch n; its reads are spans of
    # the pass
    pool = ThreadPoolExecutor(max_workers=1) if feed is not None else None
    held = profiling.current()

    def read(start: int) -> np.ndarray:
        with profiling.adopt(held):
            return feed.read_packed_batch(start, b)

    fut = pool.submit(read, 0) if pool else None
    number = 0
    try:
        while n_real == b:  # a short batch is the last
            rows = None
            if replay is not None:
                # the stored packed rows, already on the device
                if number >= len(replay):
                    break
                rows, n_real = replay.batch(number, b)
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
                    fut = pool.submit(read, number + n_real)
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
            loop.dispatch(number, n_real, packed, width, rows)
            number += n_real
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    return loop.results()


def make_pair_step(layout: GridLayout, cfg: PipelineConfig):
    """Re-match of arbitrary (prev, curr) frame pairs for the strict
    ladder: every (t-1, t) declaration depends on frames t-1 and t alone,
    so a retry recomputes exactly the flagged pairs.
    ``pair_step(prev [B, H, W], curr [B, H, W]) -> scalars [B, 7] int32``,
    laid out as the collect step's (tab flags either endpoint's, kp_need
    the larger).  It is the grid_vote matcher's: the correlation families
    raise no flag, so the ladder never re-matches their pairs.  Each phase
    is a span with CUDA events on the frames' device: ``collect.features``
    (one for each side), ``collect.match`` and ``collect.scalars``."""
    family = models.GridVote(layout, cfg)
    kp_need = models.grid_vote.kp_need

    def pair_step(prev_images: torch.Tensor, curr_images: torch.Tensor):
        dev = prev_images.device
        with profiling.span("collect.features", device=dev):
            tp, _ = family.features(prev_images)
        with profiling.span("collect.features", device=dev):
            tc, _ = family.features(curr_images)
        with profiling.span("collect.match", device=dev):
            res = family.match(tp, tc)
        with profiling.span("collect.scalars", device=dev):
            return _stack_scalars(
                res.offset, res.ok,
                tp.overflow.any(dim=-1) | tc.overflow.any(dim=-1),
                res.overflow, res.range_overflow,
                torch.maximum(kp_need(tp), kp_need(tc)))

    return pair_step


def repair_pairs(
    pair_idx: List[int],
    store: FrameStore,
    layout: GridLayout,
    cfg: PipelineConfig,
    offsets: np.ndarray,
    matched: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Re-match the pairs (t-1, t) for every t in ``pair_idx`` under
    ``cfg`` on the store's device, in chunks of at most ``frame_batch``
    pairs, writing the new declarations into ``offsets``/``matched`` in
    place.  Frames come from the store's mirror when it holds them.
    Returns per-pair (tab, join, range) flag arrays aligned with
    ``pair_idx`` and each pair's true max per-region keypoint count (the
    larger of its endpoints')."""
    step = make_pair_step(layout, cfg)
    b = cfg.frame_batch
    rows = [np.zeros((0, 7), np.int32)]
    for i in range(0, len(pair_idx), b):
        chunk = list(pair_idx[i:i + b])
        with profiling.span("collect.upload", device=store.device):
            prev_imgs = unpack_nibbles_device(
                store.device_packed_batch([t - 1 for t in chunk]),
                store.width)
            curr_imgs = unpack_nibbles_device(
                store.device_packed_batch(chunk), store.width)
        rows.append(step(prev_imgs, curr_imgs).cpu().numpy())
    off, ok, tabs, joins, ranges, kpn = split_step_scalars(
        np.concatenate(rows))
    matched[pair_idx] = ok
    offsets[pair_idx] = np.where(ok[:, None], off, 0)
    return tabs, joins, ranges, kpn


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


def _pair_flags(tabf: np.ndarray, joinf: np.ndarray, rangef: np.ndarray,
                need: np.ndarray):
    """Per-PAIR flags and keypoint needs: the (t-1, t) declaration is
    suspect if either endpoint's tables overflowed or the pair's
    join/radius bound tripped, and it needs the larger of its endpoints'
    keypoint counts.  Pair 0 is exempt: its declaration is forced to
    no-match (frc.hpp:83-95)."""
    ptab, pneed = tabf.copy(), need.copy()
    if len(ptab):
        ptab[1:] |= tabf[:-1]
        pneed[1:] = np.maximum(need[1:], need[:-1])
        ptab[0] = joinf[0] = rangef[0] = False
    return ptab, joinf, rangef, pneed


def _count_flags(ptab: np.ndarray, pjoin: np.ndarray,
                 prange: np.ndarray) -> None:
    """Count, in the open span, the pairs each limit leaves flagged, each
    pair once under the first limit the ladder would take for it: table
    capacity, then join multiplicity, then vote radius.  The three
    counters add up to the flagged pairs, and are counted even at 0."""
    join = pjoin & ~ptab
    profiling.count("collect.table_flagged", int(ptab.sum()))
    profiling.count("collect.join_flagged", int(join.sum()))
    profiling.count("collect.range_flagged",
                    int((prange & ~ptab & ~join).sum()))


def _rung_capacity(current: int, need: np.ndarray, n: int) -> int:
    """The table capacity a capacity rung escalates to, from the flagged
    pairs' keypoint needs ``need`` in a clip of ``n`` frames: of the
    doublings of ``max(2 * current, 256)`` up to :data:`MAX_CAPACITY`
    (the last one capped there), the one with the least reckoned work.  A
    candidate counts its capacity for every frame the rung re-matches
    (the clip when it takes most pairs, both endpoints of each pair
    otherwise), and each pair it leaves to a later rung as two endpoints
    at the candidate that holds that pair's need.  Ties go to the larger
    capacity, which takes fewer rungs.  Uniform needs give the capacity
    that holds them all."""
    caps = [max(2 * current, 256)]
    while caps[-1] < MAX_CAPACITY:
        caps.append(caps[-1] * 2)
    caps = np.minimum(caps, MAX_CAPACITY)
    holds = caps[np.searchsorted(caps, np.minimum(need, MAX_CAPACITY))]

    def work(cap: int) -> int:
        taken = holds <= cap
        k = int(taken.sum())
        return ((n if k > n // 2 else 2 * k) * cap
                + 2 * int(holds[~taken].sum()))

    # min keeps the first of equal works: the largest, scanned first
    return min(reversed(caps.tolist()), key=work)


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
    escalation jumps to the capacity the flagged pairs' measured keypoint
    counts call for (:func:`_rung_capacity`), leaving the few that need
    more to a later rung; join escalation walks multiplicity 4x then
    dense; only flagged pairs re-match when they are a minority;
    ``overflow_frames`` counts the pairs left inexact when the ladder
    gives up."""
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
    store = FrameStore(h, w, device_budget=store_budget(cfg, dev),
                       device=dev)

    with profiling.span("collect.pass", device=dev, rung=0,
                        capacity=cfg.region_capacity,
                        multiplicity=cfg.join_multiplicity, replay=False):
        offsets, matched, *flags = match_pass(source, layout, cfg, store, dev)
        ptab, pjoin, prange, pneed = _pair_flags(*flags)
        _count_flags(ptab, pjoin, prange)
    n = len(offsets)

    ecfg = cfg
    rung = 0
    while strict and (ptab.any() or pjoin.any() or prange.any()):
        rung += 1
        # Escalate ONLY the limit that tripped, and re-match ONLY the
        # flagged pairs: the stability bounds prove every unflagged
        # declaration equals its exhaustive recomputation.
        pairs = np.flatnonzero(ptab | pjoin | prange)
        outliers = 0
        if ptab.any():
            limit = "capacity"
            if ecfg.table_mode == "sort2":
                # sort2's chunk-quota flag is density-based: capacity can
                # never clear it, so switch to the quota-free topk
                # selection first, with everything else unchanged
                ecfg = dataclasses.replace(ecfg, table_mode="topk")
            elif ecfg.region_capacity >= MAX_CAPACITY:
                break  # give up: caller sees overflow_frames > 0
            else:
                # count-guided jump to the capacity the flagged pairs'
                # measured keypoint counts call for; the pairs that need
                # more stay flagged for a later rung
                capacity = _rung_capacity(ecfg.region_capacity,
                                          pneed[pairs], n)
                left = np.minimum(pneed[pairs], MAX_CAPACITY) > capacity
                pairs, outliers = pairs[~left], int(left.sum())
                ecfg = dataclasses.replace(ecfg, region_capacity=capacity,
                                           vote_radius=0)
        elif pjoin.any():
            limit = "multiplicity"
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
            limit = "radius"
            ecfg = dataclasses.replace(ecfg, vote_radius=0)
        pairs = pairs.tolist()
        b = ecfg.frame_batch
        if len(pairs) > n // 2:
            # majority flagged: a full replay extracts each frame once
            # where pair repair extracts both endpoints per pair; the
            # outliers overflow the replay's tables, so it flags them again
            with profiling.span("collect.pass", device=dev, rung=rung,
                                capacity=ecfg.region_capacity,
                                multiplicity=ecfg.join_multiplicity,
                                replay=True, limit=limit):
                profiling.count("collect.capacity_outliers", outliers)
                offsets, matched, *flags = match_pass(
                    StoreReplay(store), layout, ecfg, None, dev)
                # K1 ran on every batch, the last one padded
                profiling.count("collect.rematched_frames", -(-n // b) * b)
                ptab, pjoin, prange, pneed = _pair_flags(*flags)
                _count_flags(ptab, pjoin, prange)
        else:
            with profiling.span("collect.repair", device=dev, rung=rung,
                                pairs=len(pairs),
                                capacity=ecfg.region_capacity,
                                multiplicity=ecfg.join_multiplicity,
                                limit=limit):
                profiling.count("collect.capacity_outliers", outliers)
                (ptab[pairs], pjoin[pairs], prange[pairs],
                 pneed[pairs]) = repair_pairs(pairs, store, layout, ecfg,
                                              offsets, matched)
                profiling.count("collect.rematched_frames", 2 * len(pairs))
                _count_flags(ptab, pjoin, prange)

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
