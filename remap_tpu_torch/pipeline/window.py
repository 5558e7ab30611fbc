"""Action-window scan stage (port of remap_tpu/pipeline/window.py; its
``WindowInfo`` is the spec's, ``spec/aws.py``, as in the JAX package).

Frames stream through the device in batches: one dispatch advances the
persistent equality heatmap over the whole batch and flags the frames that
changed it; the host labels only the changed states
(``ops.aws.best_contour_jit``: K4a on the card, then a fetch of six ints)
and runs the reference's growth/stagnation acceptance machine over the
per-frame scalars (aws.hpp:110-149):

- a changed (color-0) winning contour that grew resets stagnation and
  updates the tracked window,
- the window is accepted once ``area > screen/3``, bbox height > 2H/5 and
  width > 2W/3 (inclusive-coordinate differences),
- the scan stops after ``aws_stagnation_limit`` stagnant frames once a
  window is accepted.

Frames cross to the device packed (2 px/byte); a worker thread reads and
packs batch n+1 while the device scans batch n, and the host machine
drains one batch behind the dispatch, reading the change flags through a
non-blocking copy (``device.HostCopy``).  A feed with
``read_packed_batch`` (``io.frames.RawDirectoryFeed``) hands over its
batches packed by the native reader, so nothing packs on the host.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.device import HostCopy, get_device, upload
from remap_tpu_torch.ops import aws as aws_ops
from remap_tpu_torch.pipeline.state import (
    pack_nibbles_batch, unpack_nibbles_device,
)
from remap_tpu_torch.spec.aws import WindowInfo
from remap_tpu_torch.utils import profiling


def scan(frames: Iterable[np.ndarray], cfg: PipelineConfig,
         device=None) -> Optional[WindowInfo]:
    """The action window of ``frames`` (an iterable of ``[H, W]`` uint8,
    or a feed with ``read_packed_batch``), or None when no window is
    accepted.  Runs on ``device``: CUDA unless the caller asks for the
    CPU."""
    dev = get_device(device)
    feed = frames if hasattr(frames, "read_packed_batch") else None
    if feed is not None:
        if len(feed) == 0:
            return None
        h, w = feed.out_dims
        it = None
    else:
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return None
        h, w = first.shape
    robust = cfg.discovery == "robust"

    min_area = (w * h) // cfg.aws_min_area_divisor
    min_height = cfg.aws_min_height_num * h // cfg.aws_min_height_den
    min_width = cfg.aws_min_width_num * w // cfg.aws_min_width_den

    # parity: binary always-static heatmap; robust: per-pixel change
    # event counts (debounced, see config.discovery)
    if robust:
        carry = torch.zeros((h, w), dtype=torch.int32, device=dev)
    else:
        carry = torch.ones((h, w), dtype=torch.uint8, device=dev)
    b = cfg.frame_batch
    if feed is not None:
        prev = unpack_nibbles_device(
            upload(feed.read_packed_batch(0, 1), dev), w)[0]
    else:
        prev = torch.as_tensor(np.ascontiguousarray(first), device=dev)

    def produce():
        """(packed [b, h, ceil(w/2)] uint8, n_real) batches from frame 1,
        read and packed off the scan thread (the last batch padded with
        its last frame)."""
        if feed is not None:
            start = 1
            while True:
                packed = feed.read_packed_batch(start, b)
                n_real = packed.shape[0]
                if n_real == 0:
                    return
                if n_real < b:
                    packed = np.concatenate(
                        [packed, np.repeat(packed[-1:], b - n_real, axis=0)])
                yield packed, n_real
                start += n_real
        while True:
            batch = list(itertools.islice(it, b))
            if not batch:
                return
            n_real = len(batch)
            padded = batch + [batch[-1]] * (b - n_real)
            yield pack_nibbles_batch(np.stack(padded)), n_real

    result: Optional[Rect] = None
    area = 0
    stagnation = 0
    #: best-contour scalars of the latest labelled heatmap state
    last: Optional[np.ndarray] = None
    done = False

    def drain(heatmaps, changed: HostCopy, n_real) -> None:
        """Host acceptance machine over one scanned batch's flags."""
        nonlocal result, area, stagnation, last, done
        changed_np = changed.wait()[0][:n_real]
        for i in range(n_real):
            if stagnation > cfg.aws_stagnation_limit:
                done = True
                return
            if changed_np[i] or last is None:
                fn = (aws_ops.robust_best_contour_jit if robust
                      else aws_ops.best_contour_jit)
                with profiling.span("window.label"):
                    last = fn(heatmaps[i]).cpu().numpy()
            color, carea, cbbox = last[0], last[1], last[2:]
            if color == 0 and carea > area:
                stagnation = 0
                area = int(carea)
                if robust:
                    # true pixel bbox: no cdt::limits running-max quirk
                    window = Rect(left=int(cbbox[0]), top=int(cbbox[1]),
                                  right=int(cbbox[2]), bottom=int(cbbox[3]))
                    width_q = window.right - window.left
                else:
                    # cbbox[0] is the quirky enclosure lower_ (ops.aws:
                    # sentinel w = unset/SIZE_MAX); width wraps unsigned
                    # like the reference's (aws.hpp:110-139,
                    # cdt.hpp:192-195)
                    left_q = int(cbbox[0])
                    if left_q >= w:
                        left_q = 2**64 - 1
                    window = Rect(
                        left=left_q,
                        top=int(cbbox[1]),
                        right=int(cbbox[2]),
                        bottom=int(cbbox[3]),
                    )
                    width_q = (window.right - left_q) % 2**64
                if result is not None or (
                    area > min_area
                    and window.height > min_height
                    and width_q > min_width
                ):
                    result = window
            if result is not None:
                stagnation += 1

    pool = ThreadPoolExecutor(max_workers=1)
    # the reader's spans (a feed's ``feed.read``) are the scan's
    held = profiling.current()

    def read_next():
        with profiling.adopt(held):
            return next(gen, None)

    try:
        gen = produce()
        fut = pool.submit(read_next)
        pending: deque[Tuple] = deque()
        while not done:
            with profiling.span("window.feed_wait"):
                item = fut.result()
            if item is None:
                break
            fut = pool.submit(read_next)
            packed, n_real = item
            imgs = unpack_nibbles_device(upload(packed, dev), w)
            if robust:
                heatmaps, changed, carry = aws_ops.robust_scan_batch(
                    prev, imgs, carry, cfg.aws_change_tolerance)
            else:
                heatmaps, changed = aws_ops.scan_batch(prev, imgs, carry)
                carry = heatmaps[n_real - 1]
            prev = imgs[n_real - 1]
            pending.append((heatmaps, HostCopy(changed), n_real))
            # drain one batch BEHIND the dispatch: the device scans batch
            # n+1 while the host labels batch n
            if len(pending) > 1:
                drain(*pending.popleft())
        while not done and pending:
            drain(*pending.popleft())
    finally:
        # the reader thread may be blocked in next(); it ends on its own
        pool.shutdown(wait=False)

    if result is None:
        return None
    return WindowInfo(raw_bounds=result)
