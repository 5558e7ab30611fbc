"""The foreground filtering pass (port of remap_tpu/pipeline/foreground.py,
fdf.hpp).

Each fragment's canvas is blended into a background (``ops.atlas.blend``);
its stored frames come back in batches: foreground masks against the
background (``ops.fde.extract_batch``: K1 medians, K4 components), then a
masked vote blit (K3, in place) into a fresh canvas of the fragment's
dimensions (fdf.hpp:40-75).  Fragments run one after another on the
store's device; the filtered canvases stay there.
"""

from __future__ import annotations

from typing import List

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops import fde as fde_ops
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.pipeline.collect import (
    chunk_box, chunk_positions, padded_chunk,
)
from remap_tpu_torch.pipeline.state import Fragment, FrameRef


def filter_fragments(fragments: List[Fragment],
                     cfg: PipelineConfig) -> List[Fragment]:
    """The filtered fragments, in order: the same frames and positions,
    each canvas rebuilt from the frames' background pixels only."""
    b = cfg.frame_batch
    results: List[Fragment] = []
    for frag in fragments:
        store = frag.store
        if store is None:
            raise ValueError("fragment has no frame store")
        dev = store.device
        ch, cw = frag.shape
        background, _ = atlas_ops.blend(frag.device_dots(dev)[:, :ch, :cw])
        out = atlas_ops.empty_canvas(ch, cw, dev)
        nums = [r.number for r in frag.frames]
        poss = [r.position for r in frag.frames]
        recompute = not store.has_medians
        for i in range(0, len(nums), b):
            chunk = nums[i:i + b]
            n_real = len(chunk)
            imgs = padded_chunk(store, chunk, b)
            meds = None if recompute else padded_chunk(store, chunk, b,
                                                       medians=True)
            apos = chunk_positions(poss[i:i + b], frag.zero, b, dev)
            fg = fde_ops.extract_batch(
                background, imgs, meds, apos,
                area_divisor=cfg.fde_area_divisor,
                compute_medians=recompute,
            )
            # the leading n_real frames (views): padding frames vote
            # nowhere; a pixel votes where its mask is 0 (fgm.hpp:71-97)
            kblit.blit_frames_(
                imgs[:n_real], apos[:n_real], out, vote=fg[:n_real],
                vote_polarity="zero",
                box=chunk_box(poss[i:i + b], frag.zero, store.height,
                              store.width))
        results.append(Fragment(
            dots_dev=out, shape=(ch, cw), zero=frag.zero,
            frames=[FrameRef(number=n, position=p)
                    for n, p in zip(nums, poss)],
            store=store,
        ))
    return results
