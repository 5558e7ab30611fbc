"""The tail of the collect stage (port of remap_tpu/pipeline/collect.py:
``segment_positions``, ``blit_pass`` and their helpers).

Match results (per-frame offsets and matched flags, e.g. from the port's
streaming step) become fragments: segmentation at match failures, the
reference's canvas growth replayed on the host, then chunked blits of the
stored frames into each fragment's device canvas through K3.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.pipeline.state import (
    Fragment, FrameRef, FrameStore, simulate_growth, unpack_nibbles_device,
)

Segments = List[Tuple[List[int], List[Tuple[int, int]]]]


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
                 medians: bool = False) -> torch.Tensor:
    """The stored frames (or medians) ``numbers``, unpacked on the store's
    device and padded with zero frames to ``b``."""
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
    return torch.as_tensor(apos, device=device)


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
