"""The foreground filtering pass (port of remap_tpu/pipeline/foreground.py,
fdf.hpp).

Each fragment's canvas is blended into a background (``ops.atlas.blend``);
its stored frames come back in batches: foreground masks against the
background (``ops.fde.extract_batch``: K1 medians, K4 components), then a
masked vote blit (K3, in place) into a fresh canvas of the fragment's
dimensions (fdf.hpp:40-75).  Fragments run one after another on the
store's device, or, given more than one device and more than one
fragment, round-robin over the devices (``parallel.fragments``): every
fragment's background is blended on its device first, then each
fragment's chain is queued there, and nothing waits for a device.  The
filtered canvases stay on their devices.
"""

from __future__ import annotations

from typing import List

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.device import current
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops import fde as fde_ops
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.parallel import fragments as frag_par
from remap_tpu_torch.pipeline.collect import (
    chunk_box, chunk_positions, padded_chunk,
)
from remap_tpu_torch.pipeline.state import Fragment, FrameRef
from remap_tpu_torch.utils import profiling


def filter_fragments(fragments: List[Fragment], cfg: PipelineConfig,
                     devices=None) -> List[Fragment]:
    """The filtered fragments, in order: the same frames and positions,
    each canvas rebuilt from the frames' background pixels only.
    ``devices``: the devices of the round robin, if any
    (``parallel.fragments.round_robin``).  A fragment on a device other
    than its store's reads its frames from the store's host rows (the
    device mirrors live on the store's device)."""
    b = cfg.frame_batch
    if any(frag.store is None for frag in fragments):
        raise ValueError("fragment has no frame store")
    devs = None
    if frag_par.round_robin(fragments, devices):
        # the reference's parallel get_background (fdf.hpp:21-34)
        blends, devs = frag_par.blend_fragments(fragments, devices)
    results: List[Fragment] = []
    for fi, frag in enumerate(fragments):
        store = frag.store
        dev = store.device if devs is None else devs[fi]
        ch, cw = frag.shape
        with current(dev):
            if devs is None:
                background, _ = atlas_ops.blend(
                    frag.device_dots(dev)[:, :ch, :cw])
            else:
                background, _ = blends[fi]
            out = atlas_ops.empty_canvas(ch, cw, dev)
            nums = [r.number for r in frag.frames]
            poss = [r.position for r in frag.frames]
            recompute = not store.has_medians
            for i in range(0, len(nums), b):
                with profiling.span("foreground.batch"):
                    _filter_batch(store, nums[i:i + b], poss[i:i + b], frag,
                                  background, out, cfg, recompute, dev)
        results.append(Fragment(
            dots_dev=out, shape=(ch, cw), zero=frag.zero,
            frames=[FrameRef(number=n, position=p)
                    for n, p in zip(nums, poss)],
            store=store,
        ))
    return results


def _filter_batch(store, chunk, positions, frag: Fragment, background, out,
                  cfg: PipelineConfig, recompute: bool, dev) -> None:
    """One batch of a fragment's frames: their foreground masks against
    ``background`` (``ops.fde.extract_batch``'s spans), then their masked
    votes blitted into ``out`` (``foreground.blit``, with CUDA events on
    ``dev``)."""
    b = cfg.frame_batch
    n_real = len(chunk)
    imgs = padded_chunk(store, chunk, b, device=dev)
    meds = None if recompute else padded_chunk(
        store, chunk, b, medians=True, device=dev)
    apos = chunk_positions(positions, frag.zero, b, dev)
    fg = fde_ops.extract_batch(
        background, imgs, meds, apos,
        area_divisor=cfg.fde_area_divisor,
        compute_medians=recompute,
    )
    # the leading n_real frames (views): padding frames vote nowhere; a
    # pixel votes where its mask is 0 (fgm.hpp:71-97)
    with profiling.span("foreground.blit", device=dev):
        kblit.blit_frames_(
            imgs[:n_real], apos[:n_real], out, vote=fg[:n_real],
            vote_polarity="zero",
            box=chunk_box(positions, frag.zero, store.height, store.width))
