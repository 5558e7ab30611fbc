#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (remap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. build: compiles remap_tpu_torch/csrc/*.cu with nvcc (sm_90a), and
   native/feed.cpp and native/codec.cpp with their Makefile.
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, with exact equality (every output is an integer), timed
   with CUDA events beside the plain version (queued behind a spin
   kernel, so the host's launch cost does not show):
   extract (K1) and its medians-only instantiation at NES
   [256, 240, 256] and C64 [64, 312, 388], tables (K2) at NES / capacity
   640 on K1's output and on a dense plane that overflows, with its bound
   and share.
3. main path: the port's make_streaming_step at the JAX package's
   benchmark configuration (NES, batches of 256, capacity 640,
   multiplicity 1, vote radius 16, atlas pad 128) on utils.clips.make_clip
   frames, 12 chained steps recycling 4 batches, with any host sync
   inside a step raising.
   Every step must be flag-free and not strayed, the last must match
   100%, every kernel must have launched on every step, and every
   covered atlas pixel must hold one colour; the device operations of
   one step are counted (torch.profiler).
3b. blit kernel: K3 in place against its plain version, exact, onto
   votes near the uint16 wrap, every bin outside the frames' box left as
   it was: 256 NES frames at random positions with a vote_ok plane (both
   polarities), at the step's own positions for the first batch (no
   plane, as the step blits), and at those positions inside a 1992x3584
   fragment canvas [16, 2008, 3840] (no plane, and a foreground-mask
   plane read with polarity "zero").  Timed as the main path launches
   it (the step: no plane, the grid over its 496x512 window; the
   fragment: the mask plane, the grid over the frames' box, as
   filter_fragments blits), with the grid over the frames' own box
   logged beside, and beside the plain version and the library
   accumulation.
4. cpu: the first 4 batches again on CPU tensors (the plain versions);
   offsets, matched, flags, strayed, anchor, position and the atlas must
   equal the card's.
5. known path: a small utils.clips clip whose camera path is known;
   the card's offsets must equal the true camera deltas.
6. cc kernels: K4's labels (K4a) and labels + stats (K4c) against their
   plain versions, exact, timed beside them: NES [256, 240, 256] on K1's
   medians of the sprite clip and on iid 16-colour noise (the most
   roots), frames of exactly 2^16 pixels [64, 256, 256] and one row more
   [64, 257, 256], C64 [64, 312, 388] on values 0..2, gameplay [64, 272, 372] on tiles
   with noise, and [4, 1080, 1920] stripes, spiral, snake and a flat
   plane; then K4c's device time at NES by kernel (torch.profiler).
7. foreground path: utils.clips.make_clip frames with 8 solid 12x12 sprites
   moving +-2 px a frame, 4 batches of 256: the streaming step gives
   offsets -> collect.segment_positions -> collect.blit_pass ->
   foreground.filter_fragments, counts zeroed just before the chain and
   read just after, any host sync inside extract_batch raising.  Every
   batch must launch K1's medians-only instantiation, K4 (labels, then
   stats) and K3, every frame with a visible sprite
   must get a non-empty foreground mask, the filtered canvases must hold
   fewer pixels of conflicting colours than the unfiltered ones, and on
   the first 256 frames the card's canvases must equal the CPU's.
8. collect path: a 2048-frame session at PipelineConfig()'s defaults
   (C64 388x312, batches of 128, capacity 512, multiplicity 4, vote
   radius 0, frames resident on the card) from utils.clips.render_clip,
   with a static HUD and border, 3 sprites and one noise frame:
   window.scan -> crop -> collect() (the strict ladder, the blit pass),
   counts zeroed just before and read just after.  The crop must equal
   the CPU path's, offsets the camera's deltas, matched be False only at
   frame 0 and around the noise frame, overflow_frames 0, the fragments
   3, the first 256 cropped frames' collect equal on the CPU; the
   StreamingStitcher must give collect's first-pass offsets; a
   repetitive texture at join_multiplicity 1 must converge through the
   multiplicity rungs and the dense join to the camera's deltas.
   Printed: window frames/s and labelled states, the match pass's
   frames/s and device idle share, the blit pass's ms, the chain's wall
   frames/s, every rung's ms and peak memory; K1 (at the cropped width,
   not a multiple of 4), K2 (at every capacity the ladder used, and at
   the top one on a pair repair's 2 frames and on a 17-frame batch, each
   with its bound and share), K3 (as the blit pass launches it) and K4a
   (on a window heatmap) against their plain versions.
9. map build: the same session through the whole pipeline,
   pipeline.builder.build_from_frames (window -> crop -> collect -> splice
   -> foreground -> clean) at PipelineConfig(), with stage callbacks that
   synchronise the card, counts zeroed just before and read just after.
   Collect must give 3 fragments and splice 2: the world's frames 0-999
   and 1001-2047, whose records equal the camera path after one shift,
   and the noise frame alone; 2 maps, the world map's interior (the 6-px
   ring and one more right column excluded, where the canvas holds
   votes) equal to the session's world at 99% of its pixels or more,
   aligned by frame record 0; a 64-frame session around the noise frame
   (in batches of 64) built on the card and on the CPU with byte-equal
   maps, equal spliced canvases and frame records; io.png.write_map's
   files decoding (zlib alone) to palette.native_to_rgb of the maps;
   every kernel launched.
   Printed: each stage's ms, frames/s and peak memory, every batch of
   splice matches (pairs, multiplicity, K, slot or dense, ms, peak
   memory), every snippet's keypoints and capacity, and K2's share of
   one merge's device work
   (torch.profiler); K1 and K2 at the merged world canvas's snippet shape
   (1x1 layout, K2 at the count-sized capacity) against their plain
   versions.
10. cli: remap_tpu_torch.cli.main in this process, counts zeroed just
   before and read just after, on (1) that session written as numbered
   raw files at PipelineConfig()'s flags with --perf and
   --checkpoint-dir: maps byte-equal to phase 9's, PNGs decoding to
   them, the window scan and the first match pass served only by the
   native packed reader (every frame, in order; no NumPy packing, no
   plain read), every kernel launched; then --resume from "filtered"
   and, that deleted, from "collect", with raw feeds whose reads raise,
   to the same maps; (2) a worn platformer (utils.gameplay.play_session,
   1024 frames at 388x312, then utils.wear.worn) at the CLI's defaults:
   the world map's interior agreeing with the session's world at
   WORN_AGREEMENT or more, the JAX package's figure on the CPU
   (tools/worn_reference.py); (3) phase 9's 64-frame cut as RGB PNGs
   with --format png: the maps of the same frames as raw files.
   Printed: the CLI's stage seconds (PerfCallbacks) beside phase 9's,
   the first match pass's device idle share fed and in memory, the
   checkpoint seconds, both resumes' seconds, the PNG reader's ms a
   frame.
11. matcher families (``matcher_phase``): (a) the correlation ops on the
   card against the port on the CPU, all exact: collect() under xcorr on
   the collect phase's cropped session (counted: its launches are the
   xcorr collect path's; offsets the camera's, unmatched only at 0 and
   around the noise frame), match_xcorr on its first 128 cropped pairs
   at radius 48 (and the rounded windows; the FFT windows equal the
   direct counts on 2 pairs), match_pyramid at VGA (64 pairs, steps up
   to +-24 px, factor 4, coarse radius 32, fine radius 5; and its coarse
   windows), the fine level's count kernel (csrc/fine.cu) at 128 cropped
   VGA pairs against its plain version on the card, exact and timed
   beside it, match_canvases and match_canvases_pyramid on that collect's
   two world fragments (offset, count, overlap, ok; the offset the frame
   records give); each timed with CUDA events, with its peak memory.
   (b) parallel.sharded.make_pipeline_step on BASELINE config 3 (8 clips
   x 64 frames at 256x240 along known paths, capacity 768, layout 4x2
   overlap 16, atlas pad 64) under grid_vote, xcorr and pyramid: offsets
   the camera's deltas, every pair after frame 0 matched, every covered
   atlas pixel one colour, the first 2 clips equal on the CPU, grid_vote
   launching K1, K2 and K3 once a step and the correlation families K3
   alone, pyramid the fine-level kernel once a step besides; frames/s.
   (c) cli.main --matcher xcorr on phase 10's 2048 raw files at
   PipelineConfig()'s flags: offsets the camera's, unmatched only at 0
   and around the noise frame, splice joining the world
   fragments through match_canvases (one acceptance) and leaving the
   noise frame alone, 2 maps, the world map's interior >= 99% the world;
   the 64-frame cut's maps byte-equal with --cpu; its --perf stages
   beside phase 10's.  (d) BASELINE config 5: builder.build_from_frames
   under VGA with matcher "pyramid" on a 512-frame 640x480 session with
   a noise frame, with (c)'s gates through match_canvases_pyramid, the
   fine-level kernel launched once a batch, and a 16-frame cut
   byte-equal on the CPU; every stage's ms and peak.  A
   one-shot gate: the timed VGA pyramid build is the benchmark's
   ``vga_pyramid_break`` cell (``port_bench/``), 2048-frame sessions
   through the CLI's raw-dump feed.

12. multi-device (``multi_device_phase``): parallel.sharded.
   make_sharded_step on meshes that repeat the one card: BASELINE config
   3's 8 NES clips x 64 frames (phase 11's) at (data, space) = (4, 1),
   (2, 2) and (1, 4), and config 5's 2 VGA clips x 16 frames under
   grid_vote and pyramid at (2, 2) and (2, 4); each equal in every
   output to make_pipeline_step on the card, offsets the camera's, K1
   and K3 launched once a shard and K2 once a data row (K3 alone under
   pyramid, with the fine-level kernel once a data row), a cut equal on
   a CPU mesh of the same shape, its ms (on clips placed on the mesh)
   beside the unsharded step's; K1 on a band plus its halo rows and K3 into a band of atlas rows with its RowClip
   (every frame cut by the band's edges) against their plain versions at
   VGA space 2 and 4, K3's bound counting only the frame rows inside the
   band; the map cell's build with splice's first extraction, the
   foreground and the clean round-robined over [card, card], maps
   byte-equal to the serial build's, then two rounds of round robin,
   serial, serial, round robin timed; a 1-rank NCCL group (all_reduce; the sharded step through
   make_global_batch) and cli.main --distributed on the CLI cell's raw
   files, PNGs byte-equal to the serial build's; one
   utils.profiling.device_trace of a sharded step with its top device
   operations.
13. spec, motion and sort2 (``spec_motion_phase``): (a) the NumPy spec
   (remap_tpu_torch.spec, no JAX) as the oracle on this host:
   spec.pipeline.build against builder.build_from_frames on the card,
   counts zeroed just before the card's build and read just after, on
   the JAX package's end-to-end clip (tests/test_pipeline_e2e.py: 30
   frames of 72x96) and on a SPEC_CUT-frame cut of the collect phase's
   C64 session from its noise frame on at PipelineConfig(): the window
   crops, collect's frame records relative to each fragment's first
   frame (against spec.frc.collect's) and the maps byte for byte equal,
   2 collect fragments (the noise frame, the rest) and every kernel
   launched on the cut; the spec's seconds and the card build's ms
   printed.  (b) ops.motion.detect on
   consecutive frames of a platformer session (utils.gameplay,
   388x312), half 4, adjusted by the camera's step, and one pair
   adjusted past the window's clip: equal to the CPU in offset, moving
   and votes, moving contours on every pair but the clipped one, K4a
   launched once a detect; ms a detect, and K4a at [1, 312, 388] against
   its plain version.  (c) table_mode="sort2" (torch ops, no kernel):
   the streaming step at the bench configuration over 4 batches equal
   to the CPU's in every output, K1 and K3 launched once a step and K2
   never, its ms beside the topk step's; on iid noise (96x64, capacity
   512) region 6's chunk-quota flag set; on the clip's frames the sort2
   tables equal K2's wherever no chunk overflows.

The line before the last is a JSON object of the kernels: for each, its
launches on the main path that runs it, its largest difference from the
plain version, its time, the plain version's, its bound (the bytes it must
move, each input read once and each output written once, over the
H100's 3.35 TB/s; every kernel here is integer work below that line;
K2's: the weights, the codes of the keypoints its tables keep and of
each region's first pixel, and the tables, with the whole code plane's
bound logged beside it; K3's: the frames, its vote plane if any, and the
bins that take a vote read and written, as it updates the canvas in
place; the frames' box of 16 bins in and out and the old design's whole
canvas are logged beside it), share = bound / time, and library_ms: for
K3 (blit, blit_fragment and blit_collect, the same kernel on the
fragment canvas and in the blit pass) one index_put_(accumulate=True)
of the votes on precomputed bins, null for the others, since no single
PyTorch call computes them.  The collect path's entries (extract_collect,
tables_collect, blit_collect, cc_labels_window) carry its launches, and
the map build's (extract_splice, tables_splice: K1 and K2 at the snippet
shape) the splice stage's; the multi-clip step's (extract_multiclip,
tables_multiclip, blit_multiclip: K1 on its 512 flattened frames, K2 at
capacity 768, K3 into its stacked canvas) one grid_vote step's, and the
xcorr collect path's (extract_medians_xcorr, blit_xcorr) the launches
of collect() under xcorr, and the multi-device phase's
(extract_band_vga_s2/s4: K1 on a band of VGA frame rows plus its halo;
blit_band_vga_s2/s4: K3 into a band of atlas rows with a RowClip) one
VGA grid_vote sharded step's at that space, fine counts (the pyramid's
fine level) phase 11 (d)'s VGA map build's, and cc_labels_motion (K4a on
one [1, 312, 388] frame) phase 13's motion detects.  Launches count wrapper calls: a K2 call
launches two kernels, a count and a scan, and its time covers both.  The
last line is {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 240, 256            # NES
BATCH = 256
N_BATCHES = 4
STEPS = 12
CAPACITY = 640
ATLAS_PAD = 128
SPRITES = 8                # foreground clip: solid sprites per frame
SPRITE = 12
SESSION = 2048             # collect phase: frames of the C64 session
NOISE_AT = 1000            # its noise frame (a fragment break)
CPU_FRAMES = 256           # its frames repeated on the CPU
REPEAT = 256               # frames of the repetitive-texture clip
SHORT = 64                 # map phase: frames built on the card and the CPU
GAMEPLAY = 1024            # cli phase: frames of the platformer session
GAMEPLAY_SEED = 3          # its play_session seed, and the wear seed and
WEAR_SEED = 11             # speck area (in the action area) of the JAX
SPECK_REGION = (10, 276, 10, 376)   # package's wear differential
#: the worn session's world map against the world (world_agreement):
#: the JAX package's share on the CPU, 528,119 of 568,703 px
#: (tools/worn_reference.py), which the port's card run must reach.  The
#: map is exact left of column ~1000 and 3 px off right of it: both
#: packages register a stretch of the worn frames 3 px off the camera
WORN_AGREEMENT = 0.9286
PYRAMID_PAIRS = 64         # matcher phase: VGA frame pairs for match_pyramid
FINE_PAIRS = 128           # and cropped VGA pairs for the fine-level counts
VGA_CROPPED = (440, 624)   # a VGA frame less a 32-row HUD and 8-px border
MULTI_CLIPS = 8            # multi-clip step: BASELINE config 3's 8 clips
MULTI_T = 64               # of 64 NES frames each
VGA_SESSION = 512          # pyramid map build: frames of the VGA session
VGA_NOISE_AT = 256         # its noise frame
VGA_SHORT = 16             # its cut built on the card and the CPU
MESHES = ((4, 1), (2, 2), (1, 4))   # multi-device phase: bench_multiclip's
VGA_CLIPS, VGA_T = 2, 16   # (data, space) meshes; VGA clips x frames
VGA_SPACES = (2, 4)        # of the VGA sharded step, and its space widths
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SPIN_HZ = 2.0e9            # spin cycles a second, above the H100's clock


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls: CUDA events
    around the calls, queued behind a spin kernel that outlasts their
    enqueue, so the host's launch cost does not show (one warm-up call
    first).  A call that waits for the card (the plain versions) waits
    out the spin first and still counts its own host time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * SPIN_HZ) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(fn, reps: int = 10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, from a
    torch.profiler window over ``reps`` calls (empty when the profiler
    records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def max_abs_err(got, want) -> int:
    """Largest |got - want| over tuples of integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def bound_ms(inputs, outputs) -> float:
    """The least time the card could take to read every input tensor once
    and write every output once, in ms."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    return nbytes / HBM_BYTES_PER_S * 1e3


def tables_bound_ms(weight, t) -> float:
    """K2's least time, in ms: every weight byte read once; the codes of
    the keypoints the tables keep (min(count, K) a region) and of each
    region's first pixel (its canonical row) read once; the tables
    written once.  The code plane's other words are never needed."""
    kept = int(t.valid.sum()) + t.overflow.numel()
    nbytes = (weight.numel() * weight.element_size() + kept * 16
              + sum(x.numel() * x.element_size() for x in t))
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_entry(name, replaces, source, err, ms, plain, bound,
                 library=None) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"remap_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
            "share": bound / ms, "library_ms": library}


def require_equal(got, want, what: str) -> int:
    err = max_abs_err(got, want)
    if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel differs from the plain version "
                             f"(max abs err {err})")
    return err


def kernel_phase(dev, frames_np):
    """Each kernel vs its plain version on the card; returns per-kernel
    measurements (without launch counts)."""
    import torch

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import kpe, tables

    nes = make_layout(W, H, 4, 2, 16)
    images = torch.as_tensor(frames_np[:BATCH], device=dev)

    # K1 and its medians-only instantiation at NES (the main paths'
    # shape) and C64 (banded on the TPU)
    got = kpe.extract_dense(images, nes)
    want = kpe.extract_dense_plain(images, nes)
    err1 = require_equal(got, want, "extract NES")
    ms1 = time_ms(lambda: kpe.extract_dense(images, nes), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(images, nes), 3)
    bound1 = bound_ms((images,), got)
    err_m = require_equal((kpe.extract_medians(images, nes),),
                          (want.median,), "extract medians NES")
    ms_m = time_ms(lambda: kpe.extract_medians(images, nes), 20)
    plain_m = time_ms(lambda: kpe.extract_dense_plain(images, nes).median, 3)
    bound_m = bound_ms((images,), (want.median,))
    log(f"extract NES [{BATCH},{H},{W}]: full and medians-only equal "
        f"(exact, tolerance 0); full kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms, bound {bound1:.4f} ms; medians-only kernel "
        f"{ms_m:.4f} ms, plain {plain_m:.4f} ms, bound {bound_m:.4f} ms")

    c64 = make_layout(388, 312, 4, 2, 16)
    rng = np.random.default_rng(64)
    c64_images = torch.as_tensor(
        rng.integers(0, 16, (64, 312, 388), dtype=np.uint8), device=dev)
    want_c64 = kpe.extract_dense_plain(c64_images, c64)
    err1 = max(err1, require_equal(kpe.extract_dense(c64_images, c64),
                                   want_c64, "extract C64"))
    err_m = max(err_m, require_equal((kpe.extract_medians(c64_images, c64),),
                                     (want_c64.median,),
                                     "extract medians C64"))
    ms_c64 = time_ms(lambda: kpe.extract_dense(c64_images, c64), 20)
    plain_c64 = time_ms(lambda: kpe.extract_dense_plain(c64_images, c64), 3)
    ms_c64m = time_ms(lambda: kpe.extract_medians(c64_images, c64), 20)
    log(f"extract C64 [64,312,388]: full and medians-only equal (exact, "
        f"tolerance 0); full kernel {ms_c64:.4f} ms, plain "
        f"{plain_c64:.4f} ms, bound "
        f"{bound_ms((c64_images,), want_c64):.4f} ms; medians-only "
        f"kernel {ms_c64m:.4f} ms")

    # K2 on K1's output for the bench frames, and on a dense overflowing
    # plane
    dense = got
    got2 = tables.build_tables(dense.weight, dense.codes, nes, CAPACITY)
    err2 = require_equal(got2, tables.build_tables_plain(
        dense.weight, dense.codes, nes, CAPACITY), "tables bench frames")
    heavy = torch.as_tensor(
        rng.integers(1, 3, (BATCH, H, W), dtype=np.uint8), device=dev)
    heavy_codes = torch.as_tensor(
        rng.integers(-(1 << 31), 1 << 31, (BATCH, H, W, 4), dtype=np.int32),
        device=dev)
    got_h = tables.build_tables(heavy, heavy_codes, nes, CAPACITY)
    err2 = max(err2, require_equal(got_h, tables.build_tables_plain(
        heavy, heavy_codes, nes, CAPACITY), "tables dense plane"))
    if not bool(got_h.overflow.all()):
        raise AssertionError("the dense plane should overflow every region")
    ms2 = time_ms(lambda: tables.build_tables(dense.weight, dense.codes, nes,
                                              CAPACITY), 20)
    bound2 = tables_bound_ms(dense.weight, got2)
    plain2 = time_ms(lambda: tables.build_tables_plain(
        dense.weight, dense.codes, nes, CAPACITY), 3)
    log(f"tables NES cap {CAPACITY}: equal (exact, tolerance 0; dense "
        f"plane overflows); kernel {ms2:.4f} ms, plain {plain2:.4f} ms, "
        f"bound {bound2:.4f} ms, share {bound2 / ms2:.3f} (whole code plane "
        f"read {bound_ms((dense.weight, dense.codes), got2):.4f})")

    return [
        kernel_entry("extract", "remap_tpu/ops/pallas/extract.py:215",
                     "extract.cu", err1, ms1, plain1, bound1),
        kernel_entry("tables", "remap_tpu/ops/pallas/tables.py:189",
                     "tables.cu", err2, ms2, plain2, bound2),
    ], kernel_entry("extract_medians", "remap_tpu/ops/pallas/extract.py:215",
                    "extract.cu", err_m, ms_m, plain_m, bound_m)


def blit_library_and_bound(images, pos, canvas, vote=None,
                           polarity="nonzero", rows=None):
    """K3's yardsticks on one call: (library ms, bound ms, voted bins).
    The library time is the accumulation alone, given the bins (their
    computation excluded): one index_put_ with accumulate=True.  The
    bound is the function's bytes: the frames, the plane if any, and the
    bins that take a vote, read and written.  ``rows``: the call's
    RowClip (only the bins inside each frame's window vote, and only the
    frame and plane rows inside it need reading)."""
    import torch

    from remap_tpu_torch.ops.kernels import blit

    _, h, w = images.shape
    _, ahp, awp = canvas.shape
    dev = images.device
    p64 = pos.to(torch.int64)
    ys = p64[:, 1, None, None] + torch.arange(h, device=dev)[None, :, None]
    xs = p64[:, 0, None, None] + torch.arange(w, device=dev)[None, None, :]
    colour = images.to(torch.int64)
    ok = colour < blit.DEPTH
    if vote is not None:
        ok &= (vote != 0) if polarity == "nonzero" else (vote == 0)
    read = images.numel()
    if rows is not None:
        band = (torch.arange(len(images), device=dev) // rows.every
                * rows.step)[:, None, None]
        inside = ((ys >= rows.lo + band) & (ys >= 0)
                  & (ys < rows.hi + band) & (ys < ahp))   # [F, h, 1]
        ok &= inside
        read = int(inside.sum()) * w
    bins = (colour * (ahp * awp) + ys * awp + xs)[ok]
    ones = torch.ones_like(bins, dtype=torch.int32)
    flat = canvas.clone().view(-1)
    library = time_ms(lambda: flat.index_put_((bins,), ones,
                                              accumulate=True), 50)
    read *= 1 if vote is None else 2   # uint8 frames, and a uint8 plane
    voted = int(torch.unique(bins).numel())
    return library, (read + 2 * 4 * voted) / HBM_BYTES_PER_S * 1e3, voted


def blit_phase(dev, frames_np, offsets, matched):
    """K3 against its plain version on the card, exact, onto votes near
    the uint16 wrap, leaving every bin outside the frames' box as it was:
    256 NES frames at random positions with a vote_ok plane (both
    polarities), at the streaming step's own positions for the bench
    clip (no plane: the step's blit), and at the same positions inside a
    1992x3584 fragment canvas (no plane, and a mask plane as the
    foreground blits); then times and bounds, each as the main path
    launches it.  Returns the step's and the fragment's entries (without
    launch counts)."""
    import torch

    from remap_tpu_torch.ops.kernels import blit
    from remap_tpu_torch.parallel.sharded import segmented_positions

    images = torch.as_tensor(frames_np[:BATCH], device=dev)
    ah, aw = H + 2 * ATLAS_PAD, W + 2 * ATLAS_PAD
    rng = np.random.default_rng(33)
    gen = torch.Generator(device=dev).manual_seed(34)

    def check(what, pos_np, canvas_hw, vote=None, polarity="nonzero"):
        pos = torch.as_tensor(pos_np, device=dev)
        dots = torch.randint(65400, 65536, (blit.DEPTH,) + blit.padded_dims(
            *canvas_hw), generator=gen, dtype=torch.int32, device=dev)
        box = blit.frames_box(pos_np, H, W)
        got = dots.clone()
        blit.blit_frames_(images, pos, got, vote=vote,
                          vote_polarity=polarity, box=box)
        want = blit.blit_frames_plain_(images, pos, dots.clone(), vote=vote,
                                       vote_polarity=polarity)
        err = require_equal((got,), (want,), what)
        if not bool((got < dots).any()):
            raise AssertionError(f"{what}: no counter wrapped")
        x_lo, y_lo, x_hi, y_hi = box
        outside = torch.ones(dots.shape[1:], dtype=torch.bool, device=dev)
        outside[y_lo:y_hi, x_lo:x_hi] = False
        if not torch.equal(got[:, outside], dots[:, outside]):
            raise AssertionError(f"{what}: bins outside the box changed")
        return err, pos, box, dots

    def measure(what, pos, box, dots, caller_box, vote=None,
                polarity="nonzero"):
        """Kernel, plain and library times, in place on one canvas, the
        kernel's grid over ``caller_box`` (the box its caller on the main
        path passes) and, logged beside it, over the frames' own ``box``;
        and the bounds: the function's bytes (frames, the plane if any,
        and the bins that take a vote, in and out: bound_ms), beside the
        frames' box of 16 bins in and out, and the old design's whole
        canvas in and out with its flag plane."""
        canvas = dots.clone()

        def kernel(grid):
            return lambda: blit.blit_frames_(images, pos, canvas, vote=vote,
                                             vote_polarity=polarity,
                                             box=grid)

        ms = time_ms(kernel(caller_box), 50)
        tight_ms = time_ms(kernel(box), 50)
        plain = time_ms(lambda: blit.blit_frames_plain_(
            images, pos, canvas, vote=vote, vote_polarity=polarity), 3)
        library, bound, voted = blit_library_and_bound(images, pos, canvas,
                                                       vote, polarity)
        x_lo, y_lo, x_hi, y_hi = box
        read = images.numel() + (0 if vote is None else vote.numel())
        box_bound = (read + 2 * 4 * blit.DEPTH * (x_hi - x_lo) * (
            y_hi - y_lo)) / HBM_BYTES_PER_S * 1e3
        whole = (2 * images.numel() + 2 * dots.numel() * 4
                 ) / HBM_BYTES_PER_S * 1e3
        log(f"{what}: kernel {ms:.4f} ms (grid over the caller's box "
            f"{caller_box}; over the frames' box {box}: {tight_ms:.4f}), "
            f"plain {plain:.4f} ms, library index_put_(accumulate=True) on "
            f"precomputed bins (their computation excluded) {library:.4f} "
            f"ms; bound {bound:.4f} ms (frames"
            f"{'' if vote is None else ' + plane'} + the {voted} bins that "
            f"take a vote, in and out), frames' box "
            f"{x_hi - x_lo}x{y_hi - y_lo} x 16 bins in and out "
            f"{box_bound:.4f} ms, the old design's (frames + flags + whole "
            f"canvas {tuple(dots.shape)} in and out) {whole:.4f} ms")
        return ms, plain, bound, library

    pos_r = np.stack([rng.integers(0, aw - W + 1, BATCH),
                      rng.integers(0, ah - H + 1, BATCH)], -1).astype(np.int32)
    vote_ok = torch.as_tensor((rng.random((BATCH, H, W)) < 0.9)
                              .astype(np.uint8), device=dev)
    # a foreground-mask plane: 5% of the pixels masked (no vote)
    masks = torch.as_tensor((rng.random((BATCH, H, W)) < 0.05)
                            .astype(np.uint8), device=dev)
    err = max(check("blit random", pos_r, (ah, aw), vote=vote_ok)[0],
              check("blit random masks", pos_r, (ah, aw), vote=vote_ok,
                    polarity="zero")[0])
    seg = segmented_positions(torch.as_tensor(offsets)[None],
                              torch.as_tensor(matched)[None])[0].numpy()
    pos_s = np.clip(seg + ATLAS_PAD, 0, [aw - W, ah - H]).astype(np.int32)
    err_s, pos, box, dots = check("blit step", pos_s, (ah, aw))
    pos_f_np = pos_s + np.array([1664, 880], np.int32)
    err_f, pos_f, box_f, dots_f = check("blit fragment", pos_f_np,
                                        (1992, 3584))
    err_f = max(err_f, check("blit fragment masks", pos_f_np, (1992, 3584),
                             vote=masks, polarity="zero")[0])
    log(f"blit {BATCH} frames: random positions (vote_ok and masks), the "
        f"step's positions, and the step's positions in a 1992x3584 "
        f"fragment canvas {tuple(dots_f.shape)} (no plane, and masks): "
        "equal (exact, tolerance 0; counters wrap; bins outside the box "
        "unchanged)")
    # as the main path launches it: the step with its window as the box,
    # the foreground's masked blit with the chunk's own box
    step = measure(f"blit step positions into {tuple(dots.shape)}", pos, box,
                   dots, (0, 0, aw, ah))
    frag = measure(f"blit fragment {tuple(dots_f.shape)}, masks", pos_f,
                   box_f, dots_f, box_f, vote=masks, polarity="zero")
    log(f"blit fragment / step time, as the main path launches them: "
        f"{frag[0] / step[0]:.3f}")
    return (kernel_entry("blit", "remap_tpu/ops/pallas/blit.py:130",
                         "blit.cu", max(err, err_s), *step),
            kernel_entry("blit_fragment", "remap_tpu/ops/pallas/blit.py:130",
                         "blit.cu", err_f, *frag))


def kernels_per_step(step, batch, state) -> int:
    """Device kernels one streaming step launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch, state)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA")


def bench_config():
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core.regions import make_layout

    cfg = PipelineConfig(screen_width=W, screen_height=H,
                         region_capacity=CAPACITY, join_multiplicity=1,
                         frame_batch=BATCH, vote_radius=16)
    layout = make_layout(W, H, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    return cfg, layout


def host_outputs(out):
    offs, matched, flags, strayed, state = out
    return {
        "offsets": offs.cpu(), "matched": matched.cpu(),
        "table": flags.table.cpu(), "join": flags.join.cpu(),
        "range": flags.range.cpu(), "strayed": strayed.cpu(),
        "anchor": state.anchor.cpu(), "position": state.position.cpu(),
        "dots": state.dots.cpu(),
    }


def main_path_phase(dev, frames_np, counters):
    """The streaming step at the bench configuration on the card."""
    import torch

    from remap_tpu_torch.parallel.sharded import make_streaming_step

    cfg, layout = bench_config()
    init_state, step = make_streaming_step(layout, cfg, atlas_pad=ATLAS_PAD,
                                           device=dev)
    batches = [torch.as_tensor(b, device=dev)
               for b in np.split(frames_np, N_BATCHES)]

    # warm-up (allocator, lazy init); not part of the counted run
    step(batches[0], init_state())
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    state = init_state()
    outs, events, per_step = [], [], []
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")   # a host sync in step raises
    for i in range(STEPS):
        before = [c.launches for c in counters]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(batches[i % N_BATCHES], state)
        end.record()
        state = out[-1]
        per_step.append([c.launches - b for c, b in zip(counters, before)])
        events.append((start, end))
        outs.append(out)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]

    for i, out in enumerate(outs):
        offs, matched, flags, strayed, _ = out
        if bool(flags.combined.any()):
            raise AssertionError(f"step {i}: exactness flags set")
        if bool(strayed):
            raise AssertionError(f"step {i}: strayed")
        if per_step[i] != [1, 1, 1]:
            raise AssertionError(f"step {i}: kernel launches {per_step[i]}")
    if not bool(outs[-1][1].all()):
        raise AssertionError("final step matched "
                             f"{float(outs[-1][1].float().mean()):.2%}")
    # a static world stitched at the right offsets gives every covered
    # atlas pixel exactly one colour
    colours = (state.dots > 0).sum(dim=0)
    if int(colours.max()) != 1:
        raise AssertionError("atlas pixels with conflicting colours")

    step_ms = [s.elapsed_time(e) for s, e in events]
    n_kernels = kernels_per_step(step, batches[0], init_state())
    return {
        "first4": [host_outputs(o) for o in outs[:N_BATCHES]],
        "launches": launches,
        "step_ms_median": statistics.median(step_ms[1:]),
        "step_ms": step_ms,
        "wall_s": wall,
        "covered_px": int((colours > 0).sum()),
        "kernels_per_step": n_kernels,
    }


def cpu_phase(frames_np, card_first4):
    """The first 4 batches through the port on CPU tensors (plain path)
    must equal the card's results."""
    import torch

    from remap_tpu_torch.parallel.sharded import make_streaming_step

    cfg, layout = bench_config()
    init_state, step = make_streaming_step(layout, cfg, atlas_pad=ATLAS_PAD,
                                           device="cpu")
    state = init_state()
    for i, batch in enumerate(np.split(frames_np, N_BATCHES)):
        out = step(torch.as_tensor(batch), state)
        state = out[-1]
        got = host_outputs(out)
        for name, want in card_first4[i].items():
            if not torch.equal(got[name], want):
                raise AssertionError(f"batch {i}: {name} differs between "
                                     "the card and the CPU")


def known_path_phase(dev):
    """Offsets on a small clip with a known camera path."""
    import torch

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.parallel.sharded import make_streaming_step
    from remap_tpu_torch.utils import clips

    cfg = PipelineConfig(screen_width=96, screen_height=64,
                         region_capacity=512, join_multiplicity=1,
                         vote_radius=16, frame_batch=4)
    layout = make_layout(96, 64, 4, 2, 16)
    clip = clips.simple_clip(n_frames=16, frame_hw=(64, 96),
                               world_hw=(160, 224), seed=31)
    init_state, step = make_streaming_step(layout, cfg, atlas_pad=32,
                                           device=dev)
    state = init_state()
    offsets, matched = [], []
    for i in range(0, 16, 4):
        out = step(torch.as_tensor(np.stack(clip.frames[i:i + 4]),
                                   device=dev), state)
        state = out[-1]
        offsets += [tuple(o) for o in out[0].tolist()]
        matched += out[1].tolist()
    if not all(matched[1:]) or offsets[1:] != clip.offsets:
        raise AssertionError("offsets differ from the true camera path")


def sprite_clip(clean: np.ndarray, seed: int = 5) -> np.ndarray:
    """``clean`` frames with SPRITES solid SPRITE x SPRITE sprites painted
    in, each moving +-2 px a frame (utils/clips.py render_clip)."""
    rng = np.random.default_rng(seed)
    frames = clean.copy()
    lo, hi_x, hi_y = 8, W - 8 - SPRITE, H - 8 - SPRITE
    sprites = [[int(rng.integers(lo, hi_x)), int(rng.integers(lo, hi_y)),
                int(rng.integers(0, 16))] for _ in range(SPRITES)]
    for frame in frames:
        for s in sprites:
            x, y, colour = s
            frame[y:y + SPRITE, x:x + SPRITE] = colour
            s[0] = int(np.clip(x + rng.integers(-2, 3), lo, hi_x))
            s[1] = int(np.clip(y + rng.integers(-2, 3), lo, hi_y))
    return frames


def _spiral(h, w, step):
    img = np.zeros((h, w), np.uint8)
    img[::step, :] = 1
    for i, r in enumerate(range(0, h, step)):
        img[r, -2 if i % 2 == 0 else 1] = 0
    return img


def _snake(h, w):
    img = np.zeros((h, w), np.uint8)
    for i, r in enumerate(range(1, h - 2, 2)):
        img[r, 1:w - 1] = 1
        if r + 1 < h - 2:
            img[r + 1, (w - 2) if i % 2 == 0 else 1] = 1
    return img


def cc_kernel_phase(dev, sprite_frames):
    """K4 against its plain versions at the foreground path's shape and
    at the sizes the TPU kernel had to band; returns the two kernels'
    entries (without launch counts)."""
    import torch

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import cc, kpe
    from remap_tpu_torch.ops.kernels import cc as kcc

    rng = np.random.default_rng(40)
    nes = torch.as_tensor(sprite_frames[:BATCH], device=dev)
    tiles = np.kron(rng.integers(0, 16, (64, 272 // 8, 372 // 4 + 1)),
                    np.ones((1, 8, 4), np.int64))[:, :, :372]
    noise = rng.integers(0, 16, tiles.shape)
    gameplay = np.where(rng.random(tiles.shape) < 0.1, noise, tiles)
    stripes = np.tile(np.repeat(rng.integers(0, 4, 241), 8)[None, :1920],
                      (1080, 1))
    shapes = {
        "NES [256,240,256] medians": kpe.extract_medians(
            nes, make_layout(W, H, 1, 1, 0)),
        "NES [256,240,256] 16-colour noise": rng.integers(0, 16, (BATCH, H, W)),
        "2^16 px [64,256,256]": rng.integers(0, 2, (64, 256, 256)),
        "2^16+256 px [64,257,256]": rng.integers(0, 2, (64, 257, 256)),
        "C64 [64,312,388]": rng.integers(0, 3, (64, 312, 388)),
        "gameplay [64,272,372]": gameplay,
        "tall [4,1080,1920]": np.stack([
            _spiral(1080, 1920, 6), stripes, _snake(1080, 1920),
            np.zeros((1080, 1920))]),
    }
    err_l = err_s = 0
    times = {}
    for name, imgs in shapes.items():
        images = torch.as_tensor(imgs, device=dev).to(torch.uint8)
        changed = torch.as_tensor(
            (rng.random(tuple(images.shape)) < 0.05).astype(np.uint8),
            device=dev)
        err_l = max(err_l, require_equal(
            (kcc.label_components_batch(images),),
            (cc.label_components(images),), f"cc labels {name}"))
        err_s = max(err_s, require_equal(
            kcc.label_stats_batch(images, changed),
            cc.label_stats(images, changed), f"cc stats {name}"))
        ms_l = time_ms(lambda: kcc.label_components_batch(images), 20)
        plain_l = time_ms(lambda: cc.label_components(images), 3)
        ms_s = time_ms(lambda: kcc.label_stats_batch(images, changed), 20)
        plain_s = time_ms(lambda: cc.label_stats(images, changed), 3)
        labels, stats = cc.label_stats(images, changed)
        bound_l = bound_ms((images,), (labels,))
        bound_s = bound_ms((images, changed), (labels, stats))
        times[name] = (ms_l, plain_l, bound_l, ms_s, plain_s, bound_s)
        log(f"cc {name}: labels and stats equal (exact, "
            f"tolerance 0, border included); labels kernel {ms_l:.4f} ms, "
            f"plain {plain_l:.4f} ms, bound {bound_l:.4f} ms; labels + "
            f"stats kernel {ms_s:.4f} ms, plain {plain_s:.4f} ms, bound "
            f"{bound_s:.4f} ms")
    images = torch.as_tensor(shapes["NES [256,240,256] medians"], device=dev)
    changed = torch.as_tensor((rng.random(tuple(images.shape)) < 0.05)
                              .astype(np.uint8), device=dev)
    parts = device_breakdown(lambda: kcc.label_stats_batch(images, changed))
    log("cc NES medians labels + stats by kernel (torch.profiler, ms per "
        "call): " + (", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                     or "not measured"))
    ms_l, plain_l, bound_l, ms_s, plain_s, bound_s = times[
        "NES [256,240,256] medians"]
    return [
        kernel_entry("cc_labels", "remap_tpu/ops/pallas/cc.py:168", "cc.cu",
                     err_l, ms_l, plain_l, bound_l),
        kernel_entry("cc_stats", "remap_tpu/ops/pallas/cc.py:413", "cc.cu",
                     err_s, ms_s, plain_s, bound_s),
    ]


def conflicting_pixels(fragments) -> int:
    """Canvas pixels holding votes for more than one colour."""
    return sum(int(((f.dots_dev[:, :f.shape[0], :f.shape[1]] > 0).sum(0)
                    > 1).sum()) for f in fragments)


def foreground_chain(dev, frames_np, step_fn, init_state, cfg, traced):
    """Stream step -> segment_positions -> blit_pass -> filter_fragments
    over all frames, with ``traced`` standing in for extract_batch;
    returns (unfiltered, filtered fragments, store, offsets, matched,
    device ms of filter_fragments)."""
    import torch

    from remap_tpu_torch.ops import fde
    from remap_tpu_torch.pipeline import collect, foreground, state

    store = state.FrameStore(H, W, device=dev)
    st = init_state()
    offs, matched = [], []
    for i, batch in enumerate(np.split(frames_np, N_BATCHES)):
        imgs = torch.as_tensor(batch, device=dev)
        out = step_fn(imgs, st)
        st = out[-1]
        offs.append(out[0])
        matched.append(out[1])
        store.put_packed_batch(
            list(range(i * BATCH, (i + 1) * BATCH)),
            state.pack_nibbles_batch(batch),
            device_packed=state.pack_nibbles_device(imgs))
    offsets = torch.cat(offs).cpu().numpy()
    matched = torch.cat(matched).cpu().numpy()
    unfiltered = collect.blit_pass(
        collect.segment_positions(offsets, matched), store, cfg)
    real = fde.extract_batch
    fde.extract_batch = traced
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        filtered = foreground.filter_fragments(unfiltered, cfg)
        end.record()
    finally:
        fde.extract_batch = real
    end.synchronize()
    return (unfiltered, filtered, store, offsets, matched,
            start.elapsed_time(end))


def foreground_phase(dev, frames_np, clean_np, counters):
    """The foreground path at full width on the card; returns its
    measurements and launch counts."""
    import torch

    from remap_tpu_torch.ops import fde
    from remap_tpu_torch.parallel.sharded import make_streaming_step

    cfg, layout = bench_config()
    init_state, step = make_streaming_step(layout, cfg, atlas_pad=ATLAS_PAD,
                                           device=dev)
    real = fde.extract_batch
    calls = []

    def traced(*args, **kwargs):
        before = [c.launches for c in counters]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")   # a host sync raises
        try:
            start.record()
            fg = real(*args, **kwargs)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append((before, [c.launches for c in counters], start, end,
                      fg))
        return fg

    # warm-up (allocator, lazy init); not part of the counted run
    foreground_chain(dev, frames_np, step, init_state, cfg, real)
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    unfiltered, filtered, store, offsets, matched, pass_ms = (
        foreground_chain(dev, frames_np, step, init_state, cfg, traced))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]

    # every batch: K1's medians-only instantiation, K4's labels and its
    # stats inside extract_batch (and neither full K1 nor K2), then one
    # K3 blit
    names = ["extract", "tables", "blit", "extract_medians", "cc_labels",
             "cc_stats"]
    for i, (before, after, *_rest) in enumerate(calls):
        d = dict(zip(names, (a - b for a, b in zip(after, before))))
        if d != {"extract": 0, "tables": 0, "blit": 0, "extract_medians": 1,
                 "cc_labels": 1, "cc_stats": 1}:
            raise AssertionError(f"foreground batch {i}: launches {d}")
    k3 = names.index("blit")
    for i, (before, after, *_rest) in enumerate(calls):
        nxt = calls[i + 1][0] if i + 1 < len(calls) else launches
        if nxt[k3] - after[k3] != 1:
            raise AssertionError(f"foreground batch {i}: no K3 blit")

    # every frame with a visible sprite gets a non-empty mask
    numbers = []
    for frag in unfiltered:
        nums = [r.number for r in frag.frames]
        numbers += [nums[i:i + BATCH] for i in range(0, len(nums), BATCH)]
    visible = (frames_np != clean_np).reshape(len(frames_np), -1).any(1)
    for chunk, (*_rest, fg) in zip(numbers, calls):
        nonempty = fg[:len(chunk)].flatten(1).any(1).cpu().numpy()
        missed = [n for n, ok in zip(chunk, nonempty) if visible[n] and not ok]
        if missed:
            raise AssertionError(f"frames {missed[:8]} have a visible sprite "
                                 "but an empty foreground mask")
    before_px = conflicting_pixels(unfiltered)
    after_px = conflicting_pixels(filtered)
    if not after_px < before_px:
        raise AssertionError(f"filtering left {after_px} conflicting pixels "
                             f"of {before_px}")
    batch_ms = [s.elapsed_time(e) for _b, _a, s, e, _fg in calls]
    return {
        "launches": dict(zip(names, launches)),
        "batch_ms": batch_ms, "pass_ms": pass_ms, "batches": len(calls),
        "wall_s": wall, "fragments": len(filtered),
        "matched": float(matched.mean()),
        "conflicts": (before_px, after_px), "store": store,
        "offsets": offsets, "matched_flags": matched,
        "visible": int(visible.sum()),
    }


def foreground_cpu_phase(fg):
    """The first 256 frames through blit_pass and filter_fragments on the
    card and on CPU tensors (the plain versions): equal canvases."""
    from remap_tpu_torch.pipeline import collect, foreground, state

    cfg, _ = bench_config()
    segments = collect.segment_positions(fg["offsets"][:BATCH],
                                         fg["matched_flags"][:BATCH])
    numbers = list(range(BATCH))
    cpu_store = state.FrameStore(H, W, device="cpu")
    cpu_store.put_packed_batch(numbers,
                               fg["store"].packed_images_batch(numbers))
    outs = []
    for store in (fg["store"], cpu_store):
        frags = collect.blit_pass(segments, store, cfg)
        outs.append((frags, foreground.filter_fragments(frags, cfg)))
    (card_u, card_f), (cpu_u, cpu_f) = outs
    for a, b in zip(card_u + card_f, cpu_u + cpu_f):
        if a.shape != b.shape or not np.array_equal(a.dots, b.dots):
            raise AssertionError("foreground canvases differ between the "
                                 "card and the CPU")
    return len(card_f)


def sync(devs) -> None:
    """Wait for each CUDA device of ``devs`` (a device or a list)."""
    import torch

    for dev in devs if isinstance(devs, (list, tuple)) else [devs]:
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)


def session_clip(n: int = SESSION, seed: int = 12):
    """A session at PipelineConfig()'s C64 screen (388x312) from
    utils.clips.render_clip: a busy world under a +-3 px camera walk, 3
    moving 8x8 sprites, a static 16-row HUD and 4-px border, and the play
    area of frame NOISE_AT replaced by noise (a fragment break).  Returns
    (frames [n, 312, 388] uint8, camera path)."""
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.utils import clips

    cfg = PipelineConfig()
    h, w = cfg.screen_height, cfg.screen_width
    rng = np.random.default_rng(seed)
    world = clips.make_world(h + 400, w + 400, rng)
    path = clips.make_camera_path(n, world.shape, (h, w), rng, max_step=3)
    frames = np.stack(clips.render_clip(
        world, path, (h, w), rng=rng, n_sprites=3, sprite_size=8,
        hud_rows=16, border=4).frames)
    if n > NOISE_AT:
        frames[NOISE_AT, 16:-4, 4:-4] = rng.integers(
            0, 16, (h - 20, w - 8), dtype=np.uint8)
    return frames, path


def repetitive_clip(n: int, h: int, w: int, seed: int = 53):
    """Frames [n, h, w] of a flat world with a random 4x4 motif in each
    16x16 cell and 0.2% sprinkled pixels, whose columns from some point on
    repeat one motif; the camera pans right 3 px a frame, so the last
    third of the frames see regions of one repeated code (a join
    multiplicity of 1, 4 and 16 all truncate there).  Returns (frames,
    camera path)."""
    rng = np.random.default_rng(seed)
    path = [(8 + 3 * i, 40 + i % 4) for i in range(n)]
    wh, ww = h + 48, path[-1][0] + w + 8
    world = np.zeros((wh, ww), np.uint8)
    for cy in range(0, wh, 16):
        for cx in range(0, ww, 16):
            world[cy:cy + 4, cx:cx + 4] = rng.integers(
                0, 16, (4, 4))[:wh - cy, :ww - cx]
    start = path[int(0.7 * n)][0] + w - 160
    motif = np.zeros((16, 16), np.uint8)
    motif[:4, :4] = rng.integers(0, 16, (4, 4))
    world[:, start:] = np.tile(motif, (wh // 16 + 1, ww // 16 + 1))[
        :wh, :ww - start]
    ys, xs = np.nonzero(rng.random(world.shape) < 0.002)
    world[ys, xs] = rng.integers(0, 16, len(ys))
    return np.stack([world[y:y + h, x:x + w] for x, y in path]), path


@contextlib.contextmanager
def recorded_ladder(dev, rungs: list):
    """Record every pass of collect() in ``rungs``: kind (the match pass,
    a pair repair, the blit pass), the rung's capacity, multiplicity, vote
    radius and batch, the frames or pairs it took, the flags it left, the
    largest keypoint need it measured, the flagged pairs its capacity left
    to a later rung (the counter ``collect.capacity_outliers`` of its
    span), wall ms and peak device memory (MiB).  The first match pass's
    offsets and matched flags are kept."""
    from remap_tpu_torch.pipeline import collect
    from remap_tpu_torch.utils import profiling

    real = collect.match_pass, collect.repair_pairs, collect.blit_pass

    def timed(record, fn, *args):
        sync(dev)
        reset_peak(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(dev)
        record["ms"] = (time.perf_counter() - t0) * 1e3
        record["peak_mb"] = peak_mb(dev)
        rungs.append(record)
        return out

    def rung(kind, cfg, n):
        return {"kind": kind, "capacity": cfg.region_capacity,
                "multiplicity": cfg.join_multiplicity,
                "radius": cfg.vote_radius, "batch": cfg.frame_batch, "n": n}

    def match_pass(frames, layout, cfg, store=None, device=None):
        rec = rung("pass", cfg, 0)

        def counted():
            for frame in frames:
                rec["n"] += 1
                yield frame

        if isinstance(frames, collect.StoreReplay):
            # device batches: handed on as they are, counted by length
            rec["n"] = len(frames)
            source = frames
        else:
            source = counted()
        out = timed(rec, real[0], source, layout, cfg, store, device)
        rec["flags"] = tuple(int(f.sum()) for f in out[2:5])
        rec["kp_need"] = int(out[5].max(initial=0))
        if len(rungs) == 1:
            rec["offsets"], rec["matched"] = out[0].copy(), out[1].copy()
        return out

    def repair_pairs(pairs, store, layout, cfg, offsets, matched):
        rec = rung("repair", cfg, len(pairs))
        out = timed(rec, real[1], pairs, store, layout, cfg, offsets,
                    matched)
        rec["flags"] = tuple(int(f.sum()) for f in out[:3])
        rec["kp_need"] = int(out[3].max(initial=0))
        return out

    def blit_pass(segments, store, cfg):
        return timed({"kind": "blit", "n": sum(len(s[0]) for s in segments)},
                     real[2], segments, store, cfg)

    collect.match_pass, collect.repair_pairs, collect.blit_pass = (
        match_pass, repair_pairs, blit_pass)
    try:
        with profiling.span("smoke.ladder"):
            yield rungs
    finally:
        collect.match_pass, collect.repair_pairs, collect.blit_pass = real
    spans = [s for s in profiling.recorder("smoke.ladder")[-1].spans
             if s.name in ("collect.pass", "collect.repair")]
    for r, s in zip([r for r in rungs if r["kind"] != "blit"], spans):
        r["outliers"] = s.counts.get("collect.capacity_outliers", 0)


def describe(rungs: list) -> str:
    parts = []
    for r in rungs:
        if r["kind"] == "blit":
            parts.append(f"blit pass {r['n']} frames {r['ms']:.1f} ms")
            continue
        parts.append(
            f"{r['kind']} {r['n']} {'frames' if r['kind'] == 'pass' else 'pairs'}"
            f" at capacity {r['capacity']}, multiplicity {r['multiplicity']}"
            f"{' (dense)' if r['multiplicity'] == 0 else ''}, radius "
            f"{r['radius']}, batch {r['batch']}: flags (table, join, range) "
            f"{r['flags']}, keypoint need up to {r['kp_need']}, "
            f"{r.get('outliers', 0)} outliers left, {r['ms']:.1f} ms"
            + ("" if r["peak_mb"] is None
               else f", peak {r['peak_mb']:.0f} MiB allocated"))
    return "; ".join(parts)


def front_half(dev, frames, cfg, rungs):
    """window.scan -> crop -> collect() on ``dev``, as the map build runs
    them; returns (window, crop rect, cropped frames, collect result, a
    dict of wall times and counts)."""
    from remap_tpu_torch.pipeline import collect, window

    read = [0]

    def feed():
        for frame in frames:
            read[0] += 1
            yield frame

    sync(dev)
    t0 = time.perf_counter()
    info = window.scan(feed(), cfg, device=dev)
    sync(dev)
    t1 = time.perf_counter()
    if info is None:
        raise AssertionError("the window scan found no window")
    c = info.crop
    cropped = np.ascontiguousarray(frames[:, c.top:c.bottom, c.left:c.right])
    with recorded_ladder(dev, rungs):
        res = collect.collect(cropped, cfg, device=dev)
    sync(dev)
    t2 = time.perf_counter()
    return info, c, cropped, res, {"window_s": t1 - t0, "read": read[0],
                                   "chain_s": t2 - t0}


def check_session(res, path, what: str, noise_at: int = NOISE_AT) -> None:
    """Offsets equal the camera's deltas, matched is False only at frame 0
    and around the noise frame ``noise_at``, nothing left inexact, one
    fragment more than the breaks."""
    n = len(res.offsets)
    breaks = {0} | ({noise_at, noise_at + 1} if n > noise_at else set())
    unmatched = set(np.flatnonzero(~res.matched).tolist())
    if unmatched != breaks:
        raise AssertionError(f"{what}: unmatched frames "
                             f"{sorted(unmatched)[:10]}, expected "
                             f"{sorted(breaks)}")
    keep = np.array(sorted(set(range(1, n)) - breaks))
    deltas = np.diff(np.asarray(path[:n]), axis=0)
    if not np.array_equal(res.offsets[keep], deltas[keep - 1]):
        raise AssertionError(f"{what}: offsets differ from the camera path")
    if res.overflow_frames != 0:
        raise AssertionError(f"{what}: overflow_frames "
                             f"{res.overflow_frames}")
    if len(res.fragments) != len(breaks):
        raise AssertionError(f"{what}: {len(res.fragments)} fragments")


def same_collect(a, b, what: str) -> None:
    from remap_tpu_torch import convert

    a, b = convert.collect_result_to_numpy(a), convert.collect_result_to_numpy(b)
    if not (np.array_equal(a.offsets, b.offsets)
            and np.array_equal(a.matched, b.matched)
            and a.overflow_frames == b.overflow_frames
            and len(a.fragments) == len(b.fragments)):
        raise AssertionError(f"{what}: offsets, matched or fragments differ")
    for fa, fb in zip(a.fragments, b.fragments):
        if fa.frames != fb.frames or not np.array_equal(fa.dots, fb.dots):
            raise AssertionError(f"{what}: fragment canvases differ")


def one_batch_ms(dev, cropped, cfg) -> float:
    """One match-pass batch's device work on the first ``frame_batch``
    cropped frames (upload excluded: unpack, the collect step, the
    scalars' copy), timed alone behind a spin kernel."""
    import torch

    from remap_tpu_torch import models
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.pipeline import collect
    from remap_tpu_torch.pipeline.state import (pack_nibbles_batch,
                                                unpack_nibbles_device)

    h, w = cropped.shape[1:]
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    step = collect.make_collect_step(layout, cfg)
    carry = models.family(cfg, layout).empty_carry(dev)
    packed = torch.as_tensor(pack_nibbles_batch(cropped[:cfg.frame_batch]),
                             device=dev)

    def one_batch():
        return step(unpack_nibbles_device(packed, w), carry)

    return time_ms(one_batch, 10)


def match_pass_idle(dev, cropped, cfg, pass_ms: float, batches: int):
    """The match pass's device idle share two ways: :func:`one_batch_ms`
    times the batches over the pass's wall; and a torch.profiler window
    over a match pass of the first 1024 frames (device time of every
    kernel and copy over its wall, the profiler's own host cost
    included), and its device operations (kernels and copies) per
    batch."""
    from torch.profiler import ProfilerActivity, profile

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.pipeline import collect

    h, w = cropped.shape[1:]
    layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    batch_ms = one_batch_ms(dev, cropped, cfg)
    busy = batch_ms * batches / pass_ms
    frames = cropped[:1024]
    collect.match_pass(frames, layout, cfg, None, dev)
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect.match_pass(frames, layout, cfg, None, dev)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    ops = sum(e.count for e in device) / -(-len(frames) // cfg.frame_batch)
    return batch_ms, 1 - busy, device_ms, wall_ms, ops


def collect_kernels(dev, cropped, res, cfg, capacities, heat):
    """K1, K2, K3 and K4a against their plain versions at this path's
    shapes (K1 on a cropped batch, K2 on its output at every capacity the
    ladder used, K3 as the blit pass launches it into the first
    fragment's canvas, K4a on one window heatmap state); returns their
    entries (without launch counts)."""
    import torch

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import cc, kpe, tables
    from remap_tpu_torch.ops.kernels import blit, cc as kcc
    from remap_tpu_torch.pipeline import collect
    from remap_tpu_torch.pipeline.state import simulate_growth

    b = cfg.frame_batch
    fh, fw = cropped.shape[1:]
    layout = make_layout(fw, fh, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    images = torch.as_tensor(cropped[:b], device=dev)
    got = kpe.extract_dense(images, layout)
    err1 = require_equal(got, kpe.extract_dense_plain(images, layout),
                         f"extract cropped [{b},{fh},{fw}]")
    ms1 = time_ms(lambda: kpe.extract_dense(images, layout), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(images, layout), 3)
    bound1 = bound_ms((images,), got)
    log(f"extract cropped [{b},{fh},{fw}] (width % 4 = {fw % 4}): equal "
        f"(exact, tolerance 0); kernel {ms1:.4f} ms, plain {plain1:.4f} ms, "
        f"bound {bound1:.4f} ms")

    k2 = {}
    for cap in capacities:
        t = tables.build_tables(got.weight, got.codes, layout, cap)
        err = require_equal(t, tables.build_tables_plain(
            got.weight, got.codes, layout, cap), f"tables capacity {cap}")
        ms = time_ms(lambda: tables.build_tables(got.weight, got.codes,
                                                 layout, cap), 20)
        plain = time_ms(lambda: tables.build_tables_plain(
            got.weight, got.codes, layout, cap), 3)
        bound = tables_bound_ms(got.weight, t)
        k2[cap] = (err, ms, plain, bound)
        log(f"tables cropped [{b},{fh},{fw}] capacity {cap}: equal (exact, "
            f"tolerance 0; {int(t.overflow.sum())} of {t.overflow.numel()} "
            f"region tables overflow); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f} "
            f"(whole code plane read "
            f"{bound_ms((got.weight, got.codes), t):.4f})")
    # a pair repair's batch (2 frames) and a short one (17) at the top
    top = max(capacities)
    for n in (2, 17):
        wn, cn = got.weight[:n].contiguous(), got.codes[:n].contiguous()
        t = tables.build_tables(wn, cn, layout, top)
        require_equal(t, tables.build_tables_plain(wn, cn, layout, top),
                      f"tables cropped [{n},{fh},{fw}] capacity {top}")
        ms = time_ms(lambda: tables.build_tables(wn, cn, layout, top), 20)
        bound = tables_bound_ms(wn, t)
        log(f"tables cropped [{n},{fh},{fw}] capacity {top}: equal (exact, "
            f"tolerance 0); kernel {ms:.4f} ms, bound {bound:.4f} ms, share "
            f"{bound / ms:.3f}")

    # K3 as the blit pass launches it: the first chunk of the first
    # fragment at its canvas positions, the grid over the chunk's box
    numbers, positions = collect.segment_positions(res.offsets,
                                                   res.matched)[0]
    zero, (cw, ch) = simulate_growth(positions, fw, fh)
    n3 = min(b, len(numbers))
    frames3 = torch.as_tensor(cropped[numbers[:n3]], device=dev)
    pos = collect.chunk_positions(positions[:n3], zero, n3, dev)
    box = collect.chunk_box(positions[:n3], zero, fh, fw)
    gen = torch.Generator(device=dev).manual_seed(35)
    dots = torch.randint(65400, 65536, (blit.DEPTH,) + blit.padded_dims(
        ch, cw), generator=gen, dtype=torch.int32, device=dev)
    got3 = blit.blit_frames_(frames3, pos, dots.clone(), box=box)
    err3 = require_equal((got3,), (blit.blit_frames_plain_(
        frames3, pos, dots.clone()),), "blit pass chunk")
    canvas = dots.clone()
    ms3 = time_ms(lambda: blit.blit_frames_(frames3, pos, canvas, box=box),
                  50)
    plain3 = time_ms(lambda: blit.blit_frames_plain_(frames3, pos, canvas), 3)
    library3, bound3, voted = blit_library_and_bound(frames3, pos, canvas)
    log(f"blit pass chunk: {n3} cropped frames into the first fragment's "
        f"canvas {tuple(dots.shape)}, grid over the chunk's box {box}: equal "
        f"(exact, tolerance 0); kernel {ms3:.4f} ms, plain {plain3:.4f} ms, "
        f"library index_put_(accumulate=True) {library3:.4f} ms, bound "
        f"{bound3:.4f} ms (frames + {voted} voted bins in and out)")

    heat = heat[None].contiguous()
    err4 = require_equal((kcc.label_components_batch(heat),),
                         (cc.label_components(heat),), "cc labels heatmap")
    ms4 = time_ms(lambda: kcc.label_components_batch(heat), 50)
    plain4 = time_ms(lambda: cc.label_components(heat), 3)
    bound4 = bound_ms((heat,), (torch.empty_like(heat, dtype=torch.int32),))
    log(f"cc labels window heatmap {tuple(heat.shape)}: equal (exact, "
        f"tolerance 0); kernel {ms4:.4f} ms, plain {plain4:.4f} ms, bound "
        f"{bound4:.4f} ms")
    return {
        "extract": kernel_entry("extract_collect",
                                "remap_tpu/ops/pallas/extract.py:253",
                                "extract.cu", err1, ms1, plain1, bound1),
        "tables": kernel_entry("tables_collect",
                               "remap_tpu/ops/pallas/tables.py:189",
                               "tables.cu", max(e[0] for e in k2.values()),
                               *k2[top][1:]),
        "blit": kernel_entry("blit_collect", "remap_tpu/ops/pallas/blit.py:130",
                             "blit.cu", err3, ms3, plain3, bound3, library3),
        "cc_labels": kernel_entry("cc_labels_window",
                                  "remap_tpu/ops/pallas/cc.py:168", "cc.cu",
                                  err4, ms4, plain4, bound4),
    }


def reset_peak(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_mb(dev):
    """Peak device memory allocated since :func:`reset_peak`, in MiB (None
    off the card)."""
    import torch

    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**20


def dense_at_top(dev, cropped, path, cfg) -> None:
    """The dense rung at the ladder's top capacity on the session's first
    frame pair (its region pairs vote in chunks of rows): the camera's
    offset, its time and peak memory."""
    import torch

    from remap_tpu_torch import models
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import kpe, kpm, tables
    from remap_tpu_torch.pipeline import collect

    cap = collect.MAX_CAPACITY
    layout = make_layout(cropped.shape[2], cropped.shape[1], cfg.grid_width,
                         cfg.grid_height, cfg.grid_overlap)
    dense = kpe.extract_dense(torch.as_tensor(cropped[:2], device=dev),
                              layout)
    tabs = tables.build_tables(dense.weight, dense.codes, layout, cap)
    grid_vote = models.GridVote(layout,
                                dataclasses.replace(cfg, join_multiplicity=0))
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    top = grid_vote.match(tables.RegionTables(*(x[:1] for x in tabs)),
                          tables.RegionTables(*(x[1:] for x in tabs)))
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = peak_mb(dev)
    want = np.subtract(path[1], path[0]).tolist()
    if not bool(top.ok[0]) or top.offset[0].tolist() != want:
        raise AssertionError(f"dense at capacity {cap}: "
                             f"{top.offset[0].tolist()} for {want}")
    log(f"dense rung at capacity {cap}, one frame pair "
        f"({layout.region_count} region pairs of {cap}^2 slots, "
        f"{kpm.DENSE_SLOTS} slots a chunk): the camera's offset in "
        f"{ms:.1f} ms, peak "
        + ("not measured" if peak is None else f"{peak:.0f} MiB allocated"))


def collect_phase(dev, counters: dict, smi: str):
    """The front half of the map build at PipelineConfig()'s defaults on a
    2048-frame C64 session: window.scan -> crop -> collect() (the strict
    ladder, the blit pass), counts zeroed just before and read just after;
    the crop and the first 256 frames' collect against the CPU path, the
    StreamingStitcher against collect's first pass, a repetitive-texture
    run through the ladder's multiplicity rungs, and each kernel of the
    path against its plain version at the path's shapes.  Returns the
    kernels' entries with their launches."""
    import torch

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.ops import aws
    from remap_tpu_torch.pipeline import collect, stream, window
    from remap_tpu_torch.pipeline.state import (pack_nibbles_batch,
                                                pack_nibbles_device)

    cfg = PipelineConfig()
    frames, path = session_clip()
    log(f"collect phase: {len(frames)} frames "
        f"[{frames.shape[1]}x{frames.shape[2]}], noise frame {NOISE_AT}, at "
        f"PipelineConfig() (frame_batch {cfg.frame_batch}, capacity "
        f"{cfg.region_capacity}, multiplicity {cfg.join_multiplicity}, "
        f"vote radius {cfg.vote_radius}, frame_store {cfg.frame_store!r})")

    # warm-up on the card, and the CPU path on the same frames
    warm = window.scan(iter(frames), cfg, device=dev)
    t0 = time.perf_counter()
    cpu_info = window.scan(iter(frames), cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu_info is None or warm.crop != cpu_info.crop:
        raise AssertionError(f"window: card {warm}, CPU {cpu_info}")
    c = warm.crop
    head = np.ascontiguousarray(frames[:CPU_FRAMES, c.top:c.bottom,
                                       c.left:c.right])
    card_head = collect.collect(head, cfg, device=dev)
    t0 = time.perf_counter()
    cpu_head = collect.collect(head, cfg, device="cpu")
    cpu_s += time.perf_counter() - t0
    same_collect(card_head, cpu_head, f"collect of the first {CPU_FRAMES} "
                 "cropped frames, card vs CPU")
    log(f"collect cpu: the window {cpu_info.raw_bounds} (crop {c}) and "
        f"collect() of the first {CPU_FRAMES} cropped frames equal on CPU "
        f"tensors: offsets, matched, overflow_frames, fragment canvases "
        f"({cpu_s:.1f} s)")
    dev_packed = pack_nibbles_device(torch.as_tensor(head, device=dev))
    if not np.array_equal(dev_packed.cpu().numpy(), pack_nibbles_batch(head)):
        raise AssertionError("nibble packing at the cropped width differs")

    # the counted run
    rungs: list = []
    for k in counters.values():
        k.launches = 0
    info, crop, cropped, res, t = front_half(dev, frames, cfg, rungs)
    launches = {name: k.launches for name, k in counters.items()}
    if crop != c:
        raise AssertionError(f"crop {crop} differs from the warm-up's {c}")
    check_session(res, path, "collect")
    if not np.array_equal(res.offsets[:CPU_FRAMES], card_head.offsets):
        raise AssertionError("the first frames' offsets differ from the "
                             "short run's")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"collect phase: {name} never launched")
    n = len(cropped)
    first = rungs[0]
    blit_ms = sum(r["ms"] for r in rungs if r["kind"] == "blit")
    log(f"collect chain: window {info.raw_bounds}, crop {crop} -> "
        f"[{n},{cropped.shape[1]},{cropped.shape[2]}]; offsets equal the "
        f"camera deltas, unmatched only at 0, {NOISE_AT}, {NOISE_AT + 1}, "
        f"overflow_frames 0, {len(res.fragments)} fragments; launches "
        f"{launches}")
    log(f"collect ladder: {describe(rungs)}; "
        f"{sum(r.get('outliers', 0) for r in rungs)} capacity outliers")
    # the same ladder from a store with no device mirror: the replay
    # uploads the host's packed rows
    host_rungs: list = []
    with recorded_ladder(dev, host_rungs):
        host_res = collect.collect(
            cropped, dataclasses.replace(cfg, frame_store="host"), device=dev)
    replays = [r for r in host_rungs[1:] if r["kind"] == "pass"]
    if res.store.mirrored != n or host_res.store.mirrored != 0 or not replays:
        raise AssertionError(
            f"mirrored {res.store.mirrored} and {host_res.store.mirrored} "
            f"frames, {len(replays)} replays from the host store")
    same_collect(res, host_res, "collect from a host store against the mirror")
    log(f"collect from a host store (frame_store 'host'): offsets, matched, "
        f"overflow_frames and canvases equal the mirror's; "
        f"{describe(host_rungs)}")
    log(f"collect figures on {smi}: window {t['read']} frames read in "
        f"{t['window_s'] * 1e3:.1f} ms ({t['read'] / t['window_s']:.1f} "
        f"frames/s), {launches['cc_labels']} heatmap states labelled (one "
        f"K4a launch and one 6-int fetch each); first match pass "
        f"{first['ms']:.1f} ms ({n / first['ms'] * 1e3:.1f} frames/s); blit "
        f"pass {blit_ms:.1f} ms; whole chain {t['chain_s']:.3f} s "
        f"({n / t['chain_s']:.1f} frames/s of wall)")
    replay = [r for r in rungs if r["kind"] == "pass"][-1]
    ecfg = dataclasses.replace(cfg, region_capacity=replay["capacity"])
    for what, pcfg, rec in (("first", cfg, first),
                            ("replay", ecfg, replay)):
        batch_ms, idle, dev_ms, wall_ms, ops = match_pass_idle(
            dev, cropped, pcfg, rec["ms"], -(-n // cfg.frame_batch))
        log(f"match pass ({what}, capacity {pcfg.region_capacity}): one "
            f"batch's device work {batch_ms:.3f} ms, so idle {idle:.3f} of "
            f"its {rec['ms']:.1f} ms; under torch.profiler (1024 frames) "
            f"{dev_ms:.1f} device ms in {wall_ms:.1f} ms of wall (idle "
            f"{1 - dev_ms / wall_ms:.3f}), {ops:.0f} device operations a "
            "batch")

    # the streaming stitcher against collect's first pass
    scfg = dataclasses.replace(cfg, screen_width=cropped.shape[2],
                               screen_height=cropped.shape[1])
    stitcher = stream.StreamingStitcher(scfg, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    offs, oks = [], []
    for i in range(0, n, cfg.frame_batch):
        off, ok = stitcher.push(cropped[i:i + cfg.frame_batch])
        offs.append(off)
        oks.append(ok)
    push_s = time.perf_counter() - t0
    frags = stitcher.finish()
    sync(dev)
    stitch_s = time.perf_counter() - t0
    if not (np.array_equal(np.concatenate(offs), first["offsets"])
            and np.array_equal(np.concatenate(oks), first["matched"])):
        raise AssertionError("the stitcher's offsets differ from collect's "
                             "first pass")
    segments = collect.segment_positions(first["offsets"], first["matched"])
    if len(frags) != len(segments):
        raise AssertionError(f"stitcher: {len(frags)} fragments")
    log(f"stitcher: {n} frames pushed in {push_s * 1e3:.1f} ms "
        f"({n / push_s:.1f} frames/s), finish() in "
        f"{(stitch_s - push_s) * 1e3:.1f} ms, {len(frags)} fragments; offsets "
        f"and matched equal collect's first pass; overflow_frames "
        f"{stitcher.overflow_frames}, needed_capacity "
        f"{stitcher.needed_capacity}, on {smi}")

    # the repetitive texture through the ladder
    rep, rep_path = repetitive_clip(REPEAT, *cropped.shape[1:])
    rcfg = dataclasses.replace(cfg, join_multiplicity=1)
    rep_rungs: list = []
    with recorded_ladder(dev, rep_rungs):
        rep_res = collect.collect(rep, rcfg, device=dev)
    check_session(rep_res, rep_path, "repetitive collect")
    walked = {r["multiplicity"] for r in rep_rungs if r["kind"] != "blit"}
    if not {1, 4, 16, 0} <= walked:
        raise AssertionError(f"repetitive run walked multiplicities {walked}")
    repaired = sum(r["n"] for r in rep_rungs if r["kind"] == "repair")
    log(f"repetitive collect: {REPEAT} frames [{rep.shape[1]}x"
        f"{rep.shape[2]}], join_multiplicity 1, exact offsets, overflow 0; "
        f"{repaired} pairs repaired in all; {describe(rep_rungs)}; on {smi}")

    dense_at_top(dev, cropped, path, cfg)

    # each kernel of the path against its plain version at its shapes
    capacities = sorted({r["capacity"] for r in rungs + rep_rungs
                         if r["kind"] != "blit"})
    heatmaps, changed = aws.scan_batch(
        torch.as_tensor(frames[0], device=dev),
        torch.as_tensor(frames[1:1 + cfg.frame_batch], device=dev),
        torch.ones(frames.shape[1:], dtype=torch.uint8, device=dev))
    heat = heatmaps[int(torch.nonzero(changed)[-1])]
    entries = collect_kernels(dev, cropped, res, cfg, capacities, heat)
    for name, entry in entries.items():
        entry["launches"] = launches[name]
    return list(entries.values())


def session_world(seed: int = 12) -> np.ndarray:
    """The world :func:`session_clip` renders (its generator's first draw)."""
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.utils import clips

    cfg = PipelineConfig()
    return clips.make_world(cfg.screen_height + 400, cfg.screen_width + 400,
                            np.random.default_rng(seed))


@contextlib.contextmanager
def recorded_splice(dev, rungs: list, snippets: list):
    """Record every batch of pairs splice's cellular matcher votes on
    (pairs, multiplicity, table rows K, dense or slot, wall ms, peak
    device memory, overflowing pairs) in ``rungs`` and every snippet it
    extracts (canvas, bucketed canvas, keypoints, capacity) in
    ``snippets``.  Each batch is timed between two synchronisations."""
    from remap_tpu_torch.pipeline import splice

    real_match = splice.splice_ops.match_fragments
    real_finalize = splice._snippet_finalize

    def match(*args, **kwargs):
        sync(dev)
        before = peak_mb(dev)
        reset_peak(dev)
        t0 = time.perf_counter()
        res = real_match(*args, **kwargs)
        overflow = int(res.overflow.sum())
        ms = (time.perf_counter() - t0) * 1e3
        mult = kwargs["multiplicity"]
        pairs, k = args[0].shape[:2]
        rungs.append({"pairs": int(pairs), "multiplicity": mult,
                      "k": int(k), "form": "dense" if mult == 0 else "slot",
                      "ms": ms, "peak_mb": peak_mb(dev), "before_mb": before,
                      "overflow": overflow})
        return res

    def finalize(frag, pend, cfg):
        snip = real_finalize(frag, pend, cfg)
        image, _, weight, _, total = pend
        snippets.append({
            "canvas": frag.shape,
            "bucket": tuple(image.shape if weight is None
                            else weight.shape[1:]),
            "keypoints": None if total is None else int(total),
            "capacity": int(snip.codes.shape[0])})
        return snip

    splice.splice_ops.match_fragments = match
    splice._snippet_finalize = finalize
    try:
        yield
    finally:
        splice.splice_ops.match_fragments = real_match
        splice._snippet_finalize = real_finalize


def timed_build(dev, frames, cfg, counters: dict):
    """builder.build_from_frames on ``dev`` with stage callbacks that
    synchronise the card and record each stage's wall time, peak device
    memory, fragment count and kernel launches so far.  Returns (result,
    the spliced fragments, stage records, splice rungs, snippets)."""
    from remap_tpu_torch.pipeline import builder

    stages: list = []
    spliced: list = []
    rungs: list = []
    snippets: list = []

    class Clock(builder.Callbacks):
        def __init__(self):
            sync(dev)
            reset_peak(dev)
            self.t = time.perf_counter()

        def stage(self, name, count, frames_seen=0):
            sync(dev)
            now = time.perf_counter()
            # the matches reset the peak: their readings count too
            mine = [r for r in rungs if r.setdefault("stage", name) == name]
            peaks = [p for p in [peak_mb(dev)] + [
                r[k] for r in mine for k in ("before_mb", "peak_mb")]
                if p is not None]
            stages.append({
                "stage": name, "ms": (now - self.t) * 1e3, "count": count,
                "frames": frames_seen,
                "peak_mb": max(peaks) if peaks else None,
                "launches": {k: f.launches for k, f in counters.items()}})
            reset_peak(dev)
            self.t = time.perf_counter()

        def on_window(self, window):
            self.stage("window", int(window is not None))

        def on_collect(self, result):
            self.stage("collect", len(result.fragments), len(result.offsets))

        def on_splice(self, fragments):
            spliced.extend(fragments)
            self.stage("splice", len(fragments))

        def on_filter(self, fragments):
            self.stage("foreground", len(fragments),
                       sum(len(f.frames) for f in fragments))

        def on_clean(self, images):
            self.stage("clean", len(images))

    with recorded_splice(dev, rungs, snippets):
        res = builder.build_from_frames(frames, cfg, callbacks=Clock(),
                                        device=dev)
    sync(dev)
    return res, spliced, stages, rungs, snippets


def same_build(a, b, what: str) -> None:
    """Two builds' maps byte for byte, spliced canvases and frame
    records."""
    from remap_tpu_torch import convert

    (ra, sa), (rb, sb) = a, b
    if len(ra.maps) != len(rb.maps) or any(
            x.shape != y.shape or x.tobytes() != y.tobytes()
            for x, y in zip(ra.maps, rb.maps)):
        raise AssertionError(f"{what}: maps differ")
    if len(sa) != len(sb):
        raise AssertionError(f"{what}: {len(sa)} vs {len(sb)} spliced")
    for fa, fb in zip(sa, sb):
        fa, fb = convert.fragment_to_numpy(fa), convert.fragment_to_numpy(fb)
        if fa.frames != fb.frames or not np.array_equal(fa.dots, fb.dots):
            raise AssertionError(f"{what}: spliced fragments differ")


def world_agreement(res, world, path, crop, margins=None) -> tuple:
    """(agreeing pixels, compared pixels) of the world fragment's map
    against the session's world, aligned by frame record 0: the map's
    interior (the 6-px ring and one more right column excluded), where
    the filtered canvas holds votes and the world is in bounds.
    ``path[0]`` is the world position of frame 0's pixel (0, 0);
    ``margins`` gives a fragment's empty margins (the port's
    ``clean.margins_of_fragment`` by default)."""
    if margins is None:
        from remap_tpu_torch.pipeline import clean

        margins = clean.margins_of_fragment
    i = next(k for k, f in enumerate(res.fragments)
             if any(r.number == 0 for r in f.frames))
    frag, image = res.fragments[i], np.asarray(res.maps[i])
    left, top, _, _ = margins(frag)
    p0 = next(r.position for r in frag.frames if r.number == 0)
    covered = frag.dots.any(axis=2)[top:top + image.shape[0],
                                    left:left + image.shape[1]]
    my, mx = np.mgrid[6:image.shape[0] - 6, 6:image.shape[1] - 7]
    wy = my - (p0[1] - top) + path[0][1] + crop.top
    wx = mx - (p0[0] - left) + path[0][0] + crop.left
    inside = ((wy >= 0) & (wy < world.shape[0]) & (wx >= 0)
              & (wx < world.shape[1]) & covered[my, mx])
    agree = image[my, mx] == world[np.clip(wy, 0, world.shape[0] - 1),
                                   np.clip(wx, 0, world.shape[1] - 1)]
    return int((agree & inside).sum()), int(inside.sum())


def merge_device_share(dev, world_frag, noise_frag, cfg) -> tuple:
    """One merge's device work on the spliced world fragment (its snippet
    extraction and its match against the noise fragment's snippet) under
    torch.profiler: (device ms of every kernel, device ms of K2's
    kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from remap_tpu_torch.pipeline import splice

    def merge():
        head = splice._extract_snippet(world_frag, cfg)
        other = splice._extract_snippet(noise_frag, cfg)
        splice._match(head, other, cfg)

    merge()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        merge()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in device) / 1e3
    k2 = sum(e.self_device_time_total for e in device
             if "tables_" in e.key) / 1e3
    return total, k2


def splice_kernels(dev, world_frag, cfg, smi: str):
    """K1 and K2 at the largest snippet the build extracted (the merged
    world canvas): K1 on its blend padded to 256-multiples under the 1x1
    layout, K2 on the interior-masked weights at the count-sized capacity,
    each against its plain version, timed; returns their entries (without
    launch counts)."""
    import torch
    import torch.nn.functional as F

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import atlas, kpe, tables
    from remap_tpu_torch.pipeline import splice

    ch, cw = world_frag.shape
    image, _ = atlas.blend(world_frag.device_dots()[:, :ch, :cw])
    hb, wb = -(-ch // 256) * 256, -(-cw // 256) * 256
    images = F.pad(image, (0, wb - cw, 0, hb - ch))[None].contiguous()
    layout = make_layout(wb, hb, 1, 1, 0)
    got = kpe.extract_dense(images, layout)
    err1 = require_equal(got, kpe.extract_dense_plain(images, layout),
                         f"extract splice [1,{hb},{wb}]")
    ms1 = time_ms(lambda: kpe.extract_dense(images, layout), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(images, layout), 3)
    bound1 = bound_ms((images,), got)

    _, _, weight, codes, total = splice._snippet_dispatch(world_frag, cfg)
    if not torch.equal(codes, got.codes):
        raise AssertionError("the snippet's codes differ from K1's")
    total = int(total)
    cap = cfg.splice_capacity
    while cap < total:
        cap *= 4
    t = tables.build_tables(weight, codes, layout, cap)
    err2 = require_equal(t, tables.build_tables_plain(weight, codes, layout,
                                                      cap),
                         f"tables splice [1,{hb},{wb}] K={cap}")
    ms2 = time_ms(lambda: tables.build_tables(weight, codes, layout, cap), 20)
    plain2 = time_ms(lambda: tables.build_tables_plain(weight, codes, layout,
                                                       cap), 3)
    bound2 = tables_bound_ms(weight, t)
    log(f"extract splice [1,{hb},{wb}] (the merged canvas {ch}x{cw}, 1x1 "
        f"layout): equal (exact, tolerance 0); kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms, bound {bound1:.4f} ms, on {smi}")
    log(f"tables splice [1,{hb},{wb}], {total} keypoints, K={cap}: equal "
        f"(exact, tolerance 0); kernel {ms2:.4f} ms, plain {plain2:.4f} ms, "
        f"bound {bound2:.4f} ms, share {bound2 / ms2:.3f} (whole code plane "
        f"read {bound_ms((weight, codes), t):.4f}), on {smi}")
    return {
        "extract": kernel_entry("extract_splice",
                                "remap_tpu/ops/pallas/extract.py:253",
                                "extract.cu", err1, ms1, plain1, bound1),
        "tables": kernel_entry("tables_splice",
                               "remap_tpu/ops/pallas/tables.py:189",
                               "tables.cu", err2, ms2, plain2, bound2),
    }


def map_phase(dev, counters: dict, smi: str):
    """The whole map build at PipelineConfig()'s defaults on the collect
    phase's 2048-frame session: builder.build_from_frames with stage
    callbacks, counts zeroed just before and read just after.  Gates: 3
    collect fragments spliced to 2 (the world's frames 0-999 and 1001-2047
    on the camera path after one shift, the noise frame alone), 2 maps,
    the world map's interior at least 99% the world, a short session's
    build equal on the CPU, the PNGs decoding to the maps' colours, and
    K1 and K2 at the splice shapes equal to their plain versions.
    Returns the kernels' entries for the splice shapes."""
    import tempfile

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core import palette
    from remap_tpu_torch.io import png

    cfg = PipelineConfig()
    frames, path = session_clip()
    world = session_world()

    # the short session on the card (also the warm-up) and on the CPU
    lo = NOISE_AT - SHORT // 2
    short = frames[lo:lo + SHORT]
    # batches of SHORT frames: a batch pads to frame_batch, and the
    # results do not depend on it (tests/test_torch_collect.py)
    scfg = dataclasses.replace(cfg, frame_batch=SHORT)
    card, card_spliced = timed_build(dev, short, scfg, counters)[:2]
    t0 = time.perf_counter()
    cpu, cpu_spliced = timed_build("cpu", short, scfg, counters)[:2]
    cpu_s = time.perf_counter() - t0
    same_build((card, card_spliced), (cpu, cpu_spliced),
               f"the {SHORT}-frame session, card vs CPU")
    log(f"map cpu: the {SHORT}-frame session around the noise frame "
        f"(frames {lo}-{lo + SHORT - 1}, frame_batch {SHORT}) built on CPU "
        f"tensors: {len(cpu.maps)} maps {[m.shape for m in cpu.maps]} "
        f"byte-equal to the card's, spliced canvases and frame records "
        f"equal ({cpu_s:.1f} s on the host of {smi})")

    # the counted run
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    res, spliced, stages, rungs, snippets = timed_build(dev, frames, cfg,
                                                        counters)
    wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"map phase: {name} never launched")
    by = {s["stage"]: s for s in stages}
    if by["collect"]["count"] != 3 or by["splice"]["count"] != 2:
        raise AssertionError(f"map phase: {by['collect']['count']} collect "
                             f"and {by['splice']['count']} spliced fragments")
    world_frag = max(spliced, key=lambda f: len(f.frames))
    noise_frag = min(spliced, key=lambda f: len(f.frames))
    numbers = sorted(r.number for r in world_frag.frames)
    if (numbers != [n for n in range(len(frames)) if n != NOISE_AT]
            or [r.number for r in noise_frag.frames] != [NOISE_AT]):
        raise AssertionError("map phase: the spliced fragments hold the "
                             "wrong frames")
    shifts = {(r.position[0] - path[r.number][0],
               r.position[1] - path[r.number][1]) for r in world_frag.frames}
    if len(shifts) != 1:
        raise AssertionError(f"map phase: {len(shifts)} distinct shifts "
                             "between frame records and the camera path")
    if len(res.maps) != 2:
        raise AssertionError(f"map phase: {len(res.maps)} maps")
    agree, compared = world_agreement(res, world, path, res.window.crop)
    if agree < 0.99 * compared:
        raise AssertionError(f"map phase: the world map agrees with the "
                             f"world at {agree} of {compared} px")
    with tempfile.TemporaryDirectory() as tmp:
        for i, image in enumerate(res.maps):
            out = f"{tmp}/out{i}.png"
            png.write_map(out, image)
            if not np.array_equal(png.decode_png(out),
                                  palette.native_to_rgb(image)):
                raise AssertionError(f"map phase: out{i}.png does not "
                                     "decode to the map's colours")

    n = len(frames)
    log(f"map build: {n} frames [{frames.shape[1]}x{frames.shape[2]}] at "
        f"PipelineConfig(), window {res.window.raw_bounds}: collect 3 -> "
        f"splice 2 fragments (the world's {len(world_frag.frames)} frames on "
        f"the camera path after one shift {shifts.pop()}, frame {NOISE_AT} "
        f"alone); 2 maps {[m.shape for m in res.maps]}; the world map's "
        f"interior equals the world at {agree} of {compared} px "
        f"({agree / compared:.4%}); out0.png, out1.png decode to the maps' "
        f"colours; launches {launches}")
    prev = {k: 0 for k in counters}
    for s in stages:
        per_s = (f", {s['frames'] / s['ms'] * 1e3:.1f} frames/s"
                 if s["frames"] else "")
        peak = ("not measured" if s["peak_mb"] is None
                else f"{s['peak_mb']:.0f} MiB")
        delta = {k: v - prev[k] for k, v in s["launches"].items()
                 if v - prev[k]}
        prev = s["launches"]
        log(f"map stage {s['stage']}: {s['ms']:.1f} ms{per_s}, peak {peak} "
            f"allocated, launches {delta}, on {smi}")
    log(f"map build wall: {wall_s:.3f} s ({n / wall_s:.1f} frames/s of "
        f"wall) on {smi}")
    for s in snippets:
        log(f"splice snippet: canvas {s['canvas']}, bucket {s['bucket']}, "
            f"{s['keypoints']} keypoints, capacity {s['capacity']}, on {smi}")
    for r in rungs:
        log(f"splice batch: {r['pairs']} pairs at multiplicity "
            f"{r['multiplicity']} ({r['form']}), K={r['k']}, "
            f"{r['overflow']} overflowing, {r['ms']:.1f} ms, peak "
            + ("not measured" if r["peak_mb"] is None
               else f"{r['peak_mb']:.0f} MiB allocated") + f", on {smi}")

    total_ms, k2_ms = merge_device_share(dev, world_frag, noise_frag, cfg)
    log(f"one merge's device work (the world snippet's extraction and its "
        f"match against the noise snippet, torch.profiler): {total_ms:.3f} "
        f"ms, K2 {k2_ms:.3f} ms ({k2_ms / total_ms:.3f} of it), on {smi}")
    entries = splice_kernels(dev, world_frag, cfg, smi)
    splice_launches = {k: by["splice"]["launches"][k]
                       - by["collect"]["launches"][k] for k in counters}
    entries["extract"]["launches"] = splice_launches["extract"]
    entries["tables"]["launches"] = splice_launches["tables"]
    return list(entries.values()), res.maps, stages


def worn_session(gameplay, wear):
    """The cli phase's worn platformer: ``gameplay.play_session`` at the
    C64 screen (312x388), GAMEPLAY frames, through ``wear.worn`` (tears,
    specks in the action area, lag duplicates, drops).  Takes the modules,
    so the JAX package's originals make the same session
    (tools/worn_reference.py)."""
    session = gameplay.play_session(seed=GAMEPLAY_SEED, n_frames=GAMEPLAY,
                                    frame_hw=(312, 388))
    return wear.worn(session, seed=WEAR_SEED, speck_region=SPECK_REGION)


def session_origins(session) -> list:
    """The world position of each frame's pixel (0, 0): the camera less
    the action area's place in the frame (play_session's 8-px border)."""
    return [(x - 8, y - 8) for x, y in session.camera]


def write_raw(directory: str, frames) -> float:
    """Frames as numbered raw dumps (one byte a pixel); returns seconds."""
    t0 = time.perf_counter()
    os.makedirs(directory)
    for i, frame in enumerate(frames):
        np.ascontiguousarray(frame).tofile(os.path.join(directory, str(i)))
    return time.perf_counter() - t0


@contextlib.contextmanager
def cli_probe(dev):
    """Record what a CLI run's build does: its BuildResult; each window
    scan and match pass (wall ms between two synchronisations, whether a
    feed served it, the packed feed reads and the NumPy packings made
    meanwhile); every packed feed read (start, frames) and every plain
    frame read of a raw feed."""
    from remap_tpu_torch.io import frames as frames_io
    from remap_tpu_torch.pipeline import builder, collect, window

    feed_cls = frames_io.RawDirectoryFeed
    rec = {"builds": [], "scans": [], "passes": [], "packed": [],
           "reads": 0, "packs": 0}
    real = (builder.build, window.scan, collect.match_pass,
            feed_cls.read_packed_batch, feed_cls.read,
            window.pack_nibbles_batch, collect.pack_nibbles_batch)

    def build(*args, **kwargs):
        res = real[0](*args, **kwargs)
        rec["builds"].append(res)
        return res

    def stage(kind, fn, frames, *args):
        packs, reads = rec["packs"], len(rec["packed"])
        sync(dev)
        t0 = time.perf_counter()
        out = fn(frames, *args)
        sync(dev)
        rec[kind].append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "feed": hasattr(frames, "read_packed_batch"),
            "packs": rec["packs"] - packs,
            "packed": rec["packed"][reads:]})
        return out

    def read_packed_batch(self, start, count, native=True):
        out = real[3](self, start, count, native)
        rec["packed"].append((start, len(out), native))
        return out

    def read(self, index):
        rec["reads"] += 1
        return real[4](self, index)

    def packer(fn):
        def pack(imgs):
            rec["packs"] += 1
            return fn(imgs)
        return pack

    builder.build = build
    window.scan = lambda frames, *a, **k: stage(
        "scans", lambda f: real[1](f, *a, **k), frames)
    collect.match_pass = lambda frames, *a: stage("passes", real[2],
                                                  frames, *a)
    feed_cls.read_packed_batch = read_packed_batch
    feed_cls.read = read
    window.pack_nibbles_batch = packer(real[5])
    collect.pack_nibbles_batch = packer(real[6])
    try:
        yield rec
    finally:
        (builder.build, window.scan, collect.match_pass,
         feed_cls.read_packed_batch, feed_cls.read,
         window.pack_nibbles_batch, collect.pack_nibbles_batch) = real


@contextlib.contextmanager
def refusing_feeds():
    """Raw feeds whose reads raise (construction still lists the
    directory): a resume must not read a frame."""
    from remap_tpu_torch.io import frames as frames_io

    cls = frames_io.RawDirectoryFeed
    real = cls.read, cls.read_packed_batch, cls.__iter__

    def refuse(*args, **kwargs):
        raise AssertionError("a resume read the frame directory")

    cls.read = cls.read_packed_batch = cls.__iter__ = refuse
    try:
        yield
    finally:
        cls.read, cls.read_packed_batch, cls.__iter__ = real


def run_cli(argv: list) -> tuple:
    """``remap_tpu_torch.cli.main(argv)`` in this process (so the launch
    counts see it), its standard output captured: (exit code, output
    lines, wall seconds)."""
    import io

    from remap_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def written_maps(lines: list, maps, what: str) -> None:
    """The CLI's ``wrote`` lines name one PNG a map, each decoding to the
    map's colours."""
    from remap_tpu_torch.core import palette
    from remap_tpu_torch.io import png

    paths = [ln.split()[1] for ln in lines if ln.startswith("wrote ")]
    if len(paths) != len(maps):
        raise AssertionError(f"{what}: {len(paths)} PNGs for {len(maps)} "
                             "maps")
    for path, image in zip(paths, maps):
        if not np.array_equal(png.decode_png(path),
                              palette.native_to_rgb(image)):
            raise AssertionError(f"{what}: {path} does not decode to the "
                                 "map's colours")


def same_maps(got, want, what: str) -> None:
    if len(got) != len(want) or any(
            a.shape != b.shape or a.tobytes() != b.tobytes()
            for a, b in zip(got, want)):
        raise AssertionError(f"{what}: maps differ")


def served_in_order(reads: list, start: int, what: str) -> int:
    """Packed feed reads that follow each other from ``start`` with the
    native reader; returns the frames they served."""
    at = start
    for first, n, native in reads:
        if first != at or not native:
            raise AssertionError(f"{what}: packed read {first} (native "
                                 f"{native}) where frame {at} was due")
        at += n
    return at - start


def perf_lines(lines: list) -> str:
    return "; ".join(ln.strip() for ln in lines if ln.startswith("["))


def cli_phase(dev, counters: dict, smi: str, in_memory_maps,
              in_memory_stages) -> str:
    """The port's CLI (``remap_tpu_torch.cli.main``, in this process) on
    three inputs.  (1) The map phase's 2048-frame session as numbered raw
    files at PipelineConfig()'s flags with --perf and --checkpoint-dir,
    counts zeroed just before and read just after: the maps byte-equal to
    the map phase's in-memory build, the PNGs decoding to them, every
    batch of the window scan and the first match pass served by the
    native packed reader with no NumPy packing and no plain read, every
    kernel launched; then resumed from "filtered" and, that deleted,
    from "collect", with feeds whose reads raise, to the same maps.
    (2) A worn platformer session (utils.gameplay, utils.wear) at the
    CLI's defaults: the world map's interior agreeing with the session's
    world at WORN_AGREEMENT or more.  (3) The map phase's 64-frame cut as
    RGB PNGs (io.png) with --format png: the maps of the same frames as
    raw files.  Returns the session run's --perf stage lines."""
    import shutil
    import tempfile

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.io import frames as frames_io
    from remap_tpu_torch.io import png
    from remap_tpu_torch.pipeline import collect
    from remap_tpu_torch.pipeline.state import FrameStore
    from remap_tpu_torch.utils import gameplay, wear

    cfg = PipelineConfig()
    frames, _ = session_clip()
    n, b = len(frames), cfg.frame_batch
    # PipelineConfig()'s values where the CLI's defaults differ
    flags = ["--region-capacity", cfg.region_capacity, "--vote-radius",
             cfg.vote_radius]
    with tempfile.TemporaryDirectory() as tmp:
        raw, ckpt = f"{tmp}/session", f"{tmp}/ckpt"
        write_s = write_raw(raw, frames)
        argv = [raw, *flags, "--perf", "--checkpoint-dir", ckpt,
                "--out-prefix", f"{tmp}/out"]
        for k in counters.values():
            k.launches = 0
        with cli_probe(dev) as rec:
            rc, lines, wall_s = run_cli(argv)
        launches = {name: k.launches for name, k in counters.items()}
        if rc != 0:
            raise AssertionError(f"cli: exit code {rc}")
        res = rec["builds"][-1]
        same_maps(res.maps, in_memory_maps, "cli vs the in-memory build")
        written_maps(lines, res.maps, "cli")
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"cli phase: {name} never launched")
        scan, first = rec["scans"][0], rec["passes"][0]
        if not (scan["feed"] and first["feed"]) or rec["reads"] or (
                scan["packs"] + first["packs"]):
            raise AssertionError(
                f"cli: window fed {scan['feed']}, first pass fed "
                f"{first['feed']}, {rec['reads']} plain reads, "
                f"{scan['packs'] + first['packs']} NumPy packings")
        if scan["packed"][0][:2] != (0, 1):
            raise AssertionError("cli: the window's first read is not "
                                 "frame 0 alone")
        scanned = 1 + served_in_order(scan["packed"][1:], 1, "cli window")
        if served_in_order(first["packed"], 0, "cli match pass") != n:
            raise AssertionError("cli: the match pass's reads do not "
                                 f"serve all {n} frames")
        checkpoints = [ln for ln in lines if ln.startswith("[checkpoint")]
        if len(checkpoints) != 2:
            raise AssertionError(f"cli: checkpoint lines {checkpoints}")
        log(f"cli session: {n} raw files [{frames.shape[1]}x"
            f"{frames.shape[2]}] written in {write_s:.2f} s; cli.main at "
            f"PipelineConfig()'s flags with --perf --checkpoint-dir: rc 0 "
            f"in {wall_s:.3f} s ({n / wall_s:.1f} frames/s of wall), "
            f"{len(res.maps)} maps byte-equal to the map phase's in-memory "
            f"build, PNGs decode to them; the native packed reader served "
            f"the window's {scanned} frames in {len(scan['packed'])} reads "
            f"and the first match pass's {n} in {len(first['packed'])} "
            f"reads, no NumPy packing, no plain read; launches {launches} "
            f"(the in-memory build's {in_memory_stages[-1]['launches']}); "
            f"on {smi}")
        log(f"cli stages (PerfCallbacks: each stage's host seconds from "
            f"its span, its device seconds from the span's CUDA events): "
            f"{perf_lines(lines)}"
            f"; the in-memory build's (map phase, synchronised): "
            + ", ".join(f"{s['stage']} {s['ms'] / 1e3:.2f} s"
                        for s in in_memory_stages) + f"; on {smi}")
        # the first match pass's idle share, fed and in memory
        crop = res.window.crop
        cropped = np.ascontiguousarray(
            frames[:, crop.top:crop.bottom, crop.left:crop.right])
        batch_ms = one_batch_ms(dev, cropped, cfg)
        batches = -(-n // b)
        h, w = cropped.shape[1:]
        layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                             cfg.grid_overlap)
        store = FrameStore(h, w, device_budget=collect.store_budget(
            cfg, dev), device=dev)
        sync(dev)
        t0 = time.perf_counter()
        collect.match_pass(iter(cropped), layout, cfg, store, dev)
        sync(dev)
        mem_ms = (time.perf_counter() - t0) * 1e3
        log(f"cli first match pass: one batch's device work "
            f"{batch_ms:.3f} ms x {batches} batches; fed by the native "
            f"reader {first['ms']:.1f} ms (idle "
            f"{1 - batch_ms * batches / first['ms']:.3f}), in memory "
            f"(numpy packing on the main thread) {mem_ms:.1f} ms (idle "
            f"{1 - batch_ms * batches / mem_ms:.3f}); window scan fed "
            f"{scan['ms']:.1f} ms; checkpoints (on a worker thread): "
            f"{'; '.join(checkpoints)}; on {smi}")

        # resume twice, reading no frame
        for tag in ("filtered", "collect"):
            if tag == "collect":
                shutil.rmtree(f"{ckpt}/filtered")
            with refusing_feeds(), cli_probe(dev) as rrec:
                rc, rlines, rwall = run_cli(argv + ["--resume"])
            if rc != 0:
                raise AssertionError(f"cli resume from {tag}: exit {rc}")
            same_maps(rrec["builds"][-1].maps, res.maps,
                      f"cli resume from {tag}")
            written_maps(rlines, res.maps, f"cli resume from {tag}")
            log(f"cli resume from {tag}: rc 0 in {rwall:.3f} s, maps "
                f"byte-equal, no frame read; {perf_lines(rlines)}; on {smi}")

        # a worn platformer session at the CLI's defaults
        session = worn_session(gameplay, wear)
        write_raw(f"{tmp}/worn", session.frames)
        with cli_probe(dev) as wrec:
            rc, wlines, wwall = run_cli([f"{tmp}/worn", "--out-prefix",
                                         f"{tmp}/worn", "--perf"])
        if rc != 0:
            raise AssertionError(f"cli worn session: exit code {rc}")
        wres = wrec["builds"][-1]
        written_maps(wlines, wres.maps, "cli worn session")
        agree, compared = world_agreement(wres, session.world,
                                          session_origins(session),
                                          wres.window.crop)
        if agree < WORN_AGREEMENT * compared:
            raise AssertionError(f"cli worn session: the world map agrees "
                                 f"at {agree} of {compared} px")
        log(f"cli worn platformer: {len(session.frames)} frames (seed "
            f"{GAMEPLAY_SEED}, wear {WEAR_SEED}) at the CLI's defaults: rc "
            f"0 in {wwall:.3f} s, {len(wres.maps)} maps "
            f"{[m.shape for m in wres.maps]}, the world map's interior "
            f"equals the world at {agree} of {compared} px "
            f"({agree / compared:.4%}; gate {WORN_AGREEMENT:.4%}); "
            f"{perf_lines(wlines)}; on {smi}")

        # the 64-frame cut as PNG frames against the same frames as raw
        lo = NOISE_AT - SHORT // 2
        short = frames[lo:lo + SHORT]
        write_raw(f"{tmp}/short_raw", short)
        os.makedirs(f"{tmp}/short_png")
        for i, frame in enumerate(short):
            png.write_map(f"{tmp}/short_png/{i}.png", frame)
        feed = frames_io.PngDirectoryFeed(f"{tmp}/short_png")
        t0 = time.perf_counter()
        read = [feed.read(i) for i in range(len(feed))]
        read_ms = (time.perf_counter() - t0) * 1e3 / len(feed)
        if not np.array_equal(np.stack(read), short):
            raise AssertionError("cli png: the reader's frames differ")
        out = {}
        for kind, extra in (("raw", []), ("png", ["--format", "png"])):
            with cli_probe(dev) as prec:
                rc, plines, _ = run_cli([f"{tmp}/short_{kind}", *flags,
                                         *extra, "--out-prefix",
                                         f"{tmp}/short_{kind}_"])
            if rc != 0:
                raise AssertionError(f"cli {kind} cut: exit code {rc}")
            out[kind] = prec["builds"][-1].maps
            written_maps(plines, out[kind], f"cli {kind} cut")
        same_maps(out["png"], out["raw"], "cli png vs raw")
        log(f"cli png: {SHORT} RGB PNG frames (io.png.write_map) with "
            f"--format png: {len(out['png'])} maps byte-equal to the same "
            f"frames as raw files; the PNG reader {read_ms:.2f} ms a "
            f"{short.shape[2]}x{short.shape[1]} frame (host); on {smi}")
    return perf_lines(lines)


def timed(dev, fn):
    """(result, wall ms, peak MiB) of one call of ``fn`` on ``dev``, the
    card synchronised around it (the peak None off the card)."""
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3, peak_mb(dev)


def mib(peak) -> str:
    return "not measured" if peak is None else f"{peak:.0f} MiB"


def same_tensors(got, want, what: str) -> None:
    """Tuples of tensors equal element for element (card vs CPU); uint16
    atlases compare as int32 (the CPU has no uint16 compare)."""
    import torch

    def host(t):
        t = t.cpu()
        return t.to(torch.int32) if t.dtype == torch.uint16 else t

    for i, (g, w) in enumerate(zip(got, want)):
        g, w = host(g), host(w)
        if g.shape != w.shape or not bool((g == w).all()):
            raise AssertionError(f"{what}: output {i} differs")


def walk(n: int, start, rng, max_step: int, reach: int, limits):
    """A camera path of ``n`` (x, y) positions from ``start``, steps of up
    to ``max_step`` px, held within ``reach`` of the start and within
    ``limits`` (the largest x and y)."""
    x0, y0 = start
    path = [(x0, y0)]
    for _ in range(n - 1):
        x, y = np.add(path[-1], rng.integers(-max_step, max_step + 1, 2))
        path.append((int(np.clip(x, max(0, x0 - reach),
                                 min(limits[0], x0 + reach))),
                     int(np.clip(y, max(0, y0 - reach),
                                 min(limits[1], y0 + reach)))))
    return path


def canvas_pair(world_a, world_b, cfg, device):
    """The two fragments' correlation snippets, as splice matches them:
    (head image, head mask, other image, other mask) at the pad state's
    dims."""
    from remap_tpu_torch.pipeline import splice

    snippets = [splice._extract_snippet(f, cfg, device)
                for f in (world_a, world_b)]
    pad = splice._PadState()
    pad.update(snippets)
    return (pad.image(snippets[0]), pad.mask(snippets[0]),
            pad.image(snippets[1]), pad.mask(snippets[1]))


def record_shift(frag, path, crop) -> tuple:
    """The one (dx, dy) between a fragment's frame records and the
    cropped frames' world positions."""
    shifts = {(r.position[0] - path[r.number][0] - crop.left,
               r.position[1] - path[r.number][1] - crop.top)
              for r in frag.frames}
    if len(shifts) != 1:
        raise AssertionError(f"{len(shifts)} distinct record shifts")
    return shifts.pop()


def matcher_ops(dev, smi: str, counters: dict):
    """Phase 11 (a): the correlation ops on the card against the port on
    the CPU, exact: match_xcorr (and its rounded windows, and the direct
    counts on two pairs) on 128 cropped frames of the collect phase's
    session at radius 48; match_pyramid at VGA (64 pairs, steps up to
    +-24 px, factor 4, coarse radius 32, fine radius 5) with its coarse
    windows; match_canvases and match_canvases_pyramid on the session's
    two world fragments from collect() under xcorr, which is counted:
    its launches are the xcorr collect path's.  Returns (the xcorr
    collect's launches, its cropped frames, its result)."""
    import torch

    from remap_tpu_torch.config import VGA, PipelineConfig
    from remap_tpu_torch.models import pyramid
    from remap_tpu_torch.ops import correlate
    from remap_tpu_torch.pipeline import collect, window
    from remap_tpu_torch.utils import clips

    xcfg = dataclasses.replace(PipelineConfig(), matcher="xcorr")
    frames, path = session_clip()
    crop = window.scan(iter(frames), xcfg, device=dev).crop
    cropped = np.ascontiguousarray(frames[:, crop.top:crop.bottom,
                                          crop.left:crop.right])
    collect.collect(cropped[:256], xcfg, device=dev)   # warm-up
    for k in counters.values():
        k.launches = 0
    res, ms, peak = timed(dev, lambda: collect.collect(cropped, xcfg,
                                                       device=dev))
    launches = {name: k.launches for name, k in counters.items()}
    check_session(res, path, "xcorr collect")
    for name in ("extract_medians", "blit"):
        if launches[name] == 0:
            raise AssertionError(f"xcorr collect: {name} never launched")
    if launches["extract"] or launches["tables"]:
        raise AssertionError(f"xcorr collect launched {launches}")
    n = len(cropped)
    log(f"xcorr collect: {n} cropped frames [{cropped.shape[1]}x"
        f"{cropped.shape[2]}] at PipelineConfig() with matcher xcorr: "
        f"offsets equal the camera deltas, unmatched only at 0, {NOISE_AT}, "
        f"{NOISE_AT + 1}, {len(res.fragments)} fragments, in {ms:.1f} ms "
        f"({n / ms * 1e3:.1f} frames/s), peak {mib(peak)} allocated; "
        f"launches {launches}; on {smi}")

    # match_xcorr on 128 frame pairs at radius 48
    b = xcfg.frame_batch
    prev = torch.as_tensor(cropped[:b], device=dev)
    curr = torch.as_tensor(cropped[1:b + 1], device=dev)
    got, _, peak = timed(dev, lambda: correlate.match_xcorr(prev, curr))
    card_ms = time_ms(lambda: correlate.match_xcorr(prev, curr), 5)
    t0 = time.perf_counter()
    want = correlate.match_xcorr(prev.cpu(), curr.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same_tensors(got, want, "match_xcorr card vs CPU")
    win = correlate.correlation_scores(prev, curr, 48)
    same_tensors((win,), (correlate.correlation_scores(prev.cpu(), curr.cpu(),
                                                       48),),
                 "correlation windows card vs CPU")
    same_tensors((win[:2],), (correlate.correlation_scores_direct(
        prev[:2], curr[:2], 48),), "FFT windows vs direct counts")
    deltas = np.diff(np.asarray(path[:b + 1]), axis=0)
    if not (bool(got.ok.all())
            and np.array_equal(got.offset.cpu().numpy(), deltas)):
        raise AssertionError("match_xcorr: offsets differ from the camera")
    log(f"match_xcorr [{b},{cropped.shape[1]},{cropped.shape[2]}] radius "
        f"48 (FFT plane {correlate._pad_dim(cropped.shape[1], 48)}x"
        f"{correlate._pad_dim(cropped.shape[2], 48)}): card equals the CPU "
        f"(offsets, flags, peak counts, the rounded windows), the windows "
        f"equal the direct counts on 2 pairs, offsets the camera's; "
        f"{card_ms:.3f} ms on the card ({b / card_ms * 1e3:.1f} pairs/s), "
        f"peak {mib(peak)} allocated; CPU {cpu_ms:.1f} ms; on {smi}")

    # match_pyramid at VGA, steps up to +-24 px
    rng = np.random.default_rng(31)
    vh, vw = VGA.screen_height, VGA.screen_width
    world = clips.make_world(vh + 400, vw + 400, rng)
    vpath = clips.make_camera_path(PYRAMID_PAIRS + 1, world.shape, (vh, vw),
                                   rng, max_step=24)
    vframes = np.stack(clips.render_clip(world, vpath, (vh, vw)).frames)
    vprev = torch.as_tensor(vframes[:-1], device=dev)
    vcurr = torch.as_tensor(vframes[1:], device=dev)
    got, _, peak = timed(dev, lambda: pyramid.match_pyramid(vprev, vcurr))
    card_ms = time_ms(lambda: pyramid.match_pyramid(vprev, vcurr), 5)
    t0 = time.perf_counter()
    want = pyramid.match_pyramid(vprev.cpu(), vcurr.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same_tensors(got, want, "match_pyramid card vs CPU")
    same_tensors((correlate.correlation_scores(
        vprev[:, ::4, ::4].contiguous(), vcurr[:, ::4, ::4].contiguous(), 32),),
        (correlate.correlation_scores(vprev[:, ::4, ::4].cpu().contiguous(),
                                      vcurr[:, ::4, ::4].cpu().contiguous(),
                                      32),), "pyramid coarse windows")
    vdeltas = np.diff(np.asarray(vpath), axis=0)
    if not (bool(got[1].all())
            and np.array_equal(got[0].cpu().numpy(), vdeltas)):
        raise AssertionError("match_pyramid: offsets differ from the camera")
    log(f"match_pyramid [{PYRAMID_PAIRS},{vh},{vw}] factor 4, coarse radius "
        f"32, fine radius 5, steps up to {int(np.abs(vdeltas).max())} px: "
        f"card equals the CPU (offsets, flags, the coarse windows), offsets "
        f"the camera's, every pair accepted; {card_ms:.3f} ms on the card "
        f"({PYRAMID_PAIRS / card_ms * 1e3:.1f} pairs/s), peak {mib(peak)} "
        f"allocated; CPU {cpu_ms:.1f} ms; on {smi}")

    # the canvas matchers on the two world fragments
    world_a, _, world_b = res.fragments
    expect = tuple(np.subtract(record_shift(world_a, path, crop),
                               record_shift(world_b, path, crop)).tolist())
    planes = canvas_pair(world_a, world_b, xcfg, dev)
    cpu_planes = [p.cpu() for p in planes]
    for name, fn in (("match_canvases", correlate.match_canvases),
                     ("match_canvases_pyramid",
                      correlate.match_canvases_pyramid)):
        got, _, peak = timed(dev, lambda: fn(*planes))
        card_ms = time_ms(lambda: fn(*planes), 3)
        t0 = time.perf_counter()
        want = fn(*cpu_planes)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same_tensors(got, want, f"{name} card vs CPU")
        if not bool(got.ok) or tuple(got.offset.tolist()) != expect:
            raise AssertionError(f"{name}: {got.offset.tolist()} (ok "
                                 f"{bool(got.ok)}) for {expect}")
        log(f"{name}: the two world fragments' snippets "
            f"{tuple(planes[0].shape)} and {tuple(planes[2].shape)}: card "
            f"equals the CPU (offset, count, overlap, ok), offset {expect} "
            f"as the frame records give, {int(got.count)} of "
            f"{int(got.overlap)} px agree; {card_ms:.3f} ms on the card, "
            f"peak {mib(peak)} allocated; CPU {cpu_ms:.1f} ms; on {smi}")
    return launches, cropped, res


def multiclip_clips(seed: int = 41):
    """BASELINE config 3's batch: MULTI_CLIPS clips of MULTI_T frames at
    256x240 (utils.clips.render_clip over one make_world), each camera
    walking +-3 px a frame within 60 px of its start (inside the 64-px
    atlas pad).  Returns (clips [C, T, H, W] uint8, paths)."""
    from remap_tpu_torch.utils import clips

    rng = np.random.default_rng(seed)
    world = clips.make_world(H + 600, W + 600, rng)
    limits = (world.shape[1] - W, world.shape[0] - H)
    paths = [walk(MULTI_T, (int(rng.integers(60, limits[0] - 60)),
                            int(rng.integers(60, limits[1] - 60))),
                  rng, 3, 60, limits) for _ in range(MULTI_CLIPS)]
    frames = np.stack([np.stack(clips.render_clip(world, p, (H, W)).frames)
                       for p in paths])
    return frames, paths


def multiclip_kernels(dev, images, result, layout, cfg, pad: int) -> dict:
    """K1, K2 and K3 of the grid_vote multi-clip step against their plain
    versions at its shapes (K1 on the flattened C*T frames, K2 on its
    output at the step's capacity, K3 at the step's stacked positions into
    its stacked canvas); returns their entries (without launch counts)."""
    import torch

    from remap_tpu_torch.ops import kpe, tables
    from remap_tpu_torch.ops.kernels import blit

    c, t, h, w = images.shape
    flat = images.reshape(c * t, h, w)
    got = kpe.extract_dense(flat, layout)
    err1 = require_equal(got, kpe.extract_dense_plain(flat, layout),
                         "extract multi-clip")
    ms1 = time_ms(lambda: kpe.extract_dense(flat, layout), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(flat, layout), 3)
    bound1 = bound_ms((flat,), got)
    cap = cfg.region_capacity
    tabs = tables.build_tables(got.weight, got.codes, layout, cap)
    err2 = require_equal(tabs, tables.build_tables_plain(
        got.weight, got.codes, layout, cap), "tables multi-clip")
    ms2 = time_ms(lambda: tables.build_tables(got.weight, got.codes, layout,
                                              cap), 20)
    plain2 = time_ms(lambda: tables.build_tables_plain(
        got.weight, got.codes, layout, cap), 3)
    bound2 = tables_bound_ms(got.weight, tabs)
    ah, aw = h + 2 * pad, w + 2 * pad
    limit = torch.tensor([aw - w, ah - h], dtype=torch.int32, device=dev)
    anchored = torch.minimum(torch.clamp(result.positions + pad, min=0),
                             limit)
    rows = torch.arange(c, dtype=torch.int32, device=dev) * ah
    pos = (anchored + torch.stack([torch.zeros_like(rows), rows],
                                  dim=-1)[:, None]).reshape(-1, 2)
    canvas = torch.zeros((blit.DEPTH,) + blit.padded_dims(c * ah, aw),
                         dtype=torch.int32, device=dev)
    box = (0, 0, aw, c * ah)
    got3 = blit.blit_frames_(flat, pos, canvas.clone(), box=box)
    err3 = require_equal((got3,), (blit.blit_frames_plain_(
        flat, pos, canvas.clone()),), "blit multi-clip")
    ms3 = time_ms(lambda: blit.blit_frames_(flat, pos, canvas, box=box), 50)
    plain3 = time_ms(lambda: blit.blit_frames_plain_(flat, pos, canvas), 3)
    library3, bound3, voted = blit_library_and_bound(flat, pos, canvas)
    log(f"multi-clip kernels: extract [{c * t},{h},{w}] kernel {ms1:.4f} "
        f"ms, plain {plain1:.4f}, bound {bound1:.4f}; tables capacity {cap} "
        f"kernel {ms2:.4f} ms, plain {plain2:.4f}, bound {bound2:.4f}, "
        f"share {bound2 / ms2:.3f}; blit into {tuple(canvas.shape)} kernel "
        f"{ms3:.4f} ms, plain {plain3:.4f}, library index_put_ "
        f"{library3:.4f}, bound {bound3:.4f} ({voted} voted bins); all "
        f"equal (exact, tolerance 0)")
    return {
        "extract": kernel_entry("extract_multiclip",
                                "remap_tpu/ops/pallas/extract.py:215",
                                "extract.cu", err1, ms1, plain1, bound1),
        "tables": kernel_entry("tables_multiclip",
                               "remap_tpu/ops/pallas/tables.py:189",
                               "tables.cu", err2, ms2, plain2, bound2),
        "blit": kernel_entry("blit_multiclip",
                             "remap_tpu/ops/pallas/blit.py:130", "blit.cu",
                             err3, ms3, plain3, bound3, library3),
    }


def multiclip_phase(dev, smi: str, counters: dict):
    """Phase 11 (b): make_pipeline_step on BASELINE config 3 at the JAX
    benchmark's multi-clip configuration (8 clips x 64 frames at 256x240,
    capacity 768, layout 4x2 overlap 16, atlas pad 64) under the three
    families, counts zeroed just before each counted step and read just
    after: offsets equal the camera's deltas and every pair after frame 0
    matches, every covered atlas pixel holds one colour, the first 2
    clips equal on the CPU, and grid_vote launches K1, K2 and K3 once a
    step, the correlation families K3 alone, and pyramid the fine-level
    kernel once a step besides.  Returns the grid_vote step's kernel
    entries with their launches."""
    import torch

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops.kernels import correlate as kcorrelate
    from remap_tpu_torch.parallel import sharded

    clips_np, paths = multiclip_clips()
    c, t = clips_np.shape[:2]
    layout = make_layout(W, H, 4, 2, 16)
    images = torch.as_tensor(clips_np, device=dev)
    deltas = np.stack([np.diff(np.asarray(p), axis=0) for p in paths])
    entries = {}
    for family in ("grid_vote", "xcorr", "pyramid"):
        cfg = PipelineConfig(screen_width=W, screen_height=H,
                             region_capacity=768, frame_batch=t,
                             matcher=family)
        step = sharded.make_pipeline_step(layout, cfg, atlas_pad=64,
                                          device=dev)
        step(images)   # warm-up
        counted = dict(counters, fine=kcorrelate.fine_counts_cuda)
        for k in counted.values():
            k.launches = 0
        res, _, peak = timed(dev, lambda: step(images))
        launches = {name: k.launches for name, k in counted.items()}
        want = ({"extract": 1, "tables": 1, "blit": 1} if family ==
                "grid_vote" else {"extract": 0, "tables": 0, "blit": 1})
        want["fine"] = int(family == "pyramid")
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"multi-clip {family}: launches {launches}")
        matched = res.matched.cpu().numpy()
        if matched[:, 0].any() or not matched[:, 1:].all():
            raise AssertionError(f"multi-clip {family}: matched "
                                 f"{int(matched.sum())} of {c * t}")
        if not np.array_equal(res.offsets[:, 1:].cpu().numpy(), deltas):
            raise AssertionError(f"multi-clip {family}: offsets differ from "
                                 "the camera's deltas")
        colours = (res.atlas.to(torch.int32) > 0).sum(dim=-1)
        covered = int((colours > 0).sum())
        if int(colours.max()) > 1:
            raise AssertionError(f"multi-clip {family}: an atlas pixel holds "
                                 "two colours")
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            step(images)
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        t0 = time.perf_counter()
        cpu = sharded.make_pipeline_step(layout, cfg, atlas_pad=64,
                                         device="cpu")(images[:2].cpu())
        cpu_s = time.perf_counter() - t0
        same_tensors([x[:2] for x in res], cpu,
                     f"multi-clip {family}, first 2 clips card vs CPU")
        log(f"multi-clip {family}: {c} clips x {t} frames [{H}x{W}], "
            f"offsets the camera's, every pair after frame 0 matched, "
            f"{covered} atlas px each one colour, the first 2 clips equal "
            f"on the CPU ({cpu_s:.1f} s); launches {launches}; step "
            f"{step_ms:.3f} ms ({c * t / step_ms * 1e3:.1f} frames/s), "
            f"peak {mib(peak)} allocated; on {smi}")
        if family == "grid_vote":
            entries = multiclip_kernels(dev, images, res, layout, cfg, 64)
            for name, entry in entries.items():
                entry["launches"] = launches[name]
    return list(entries.values())


def xcorr_collect_kernels(dev, cropped, res, cfg, launches) -> list:
    """K1's medians-only instantiation and K3 against their plain versions
    as the xcorr collect path launches them (a batch of cropped frames;
    the blit pass's first chunk into the first fragment's canvas), with
    the path's launches."""
    import torch

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import kpe
    from remap_tpu_torch.ops.kernels import blit
    from remap_tpu_torch.pipeline import collect
    from remap_tpu_torch.pipeline.state import simulate_growth

    b = cfg.frame_batch
    fh, fw = cropped.shape[1:]
    layout = make_layout(fw, fh, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    images = torch.as_tensor(cropped[:b], device=dev)
    want = kpe.extract_dense_plain(images, layout).median
    err1 = require_equal((kpe.extract_medians(images, layout),), (want,),
                         "extract medians, xcorr collect")
    ms1 = time_ms(lambda: kpe.extract_medians(images, layout), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(images, layout).median,
                     3)
    bound1 = bound_ms((images,), (want,))
    numbers, positions = collect.segment_positions(res.offsets,
                                                   res.matched)[0]
    zero, (cw, ch) = simulate_growth(positions, fw, fh)
    n3 = min(b, len(numbers))
    frames3 = torch.as_tensor(cropped[numbers[:n3]], device=dev)
    pos = collect.chunk_positions(positions[:n3], zero, n3, dev)
    box = collect.chunk_box(positions[:n3], zero, fh, fw)
    canvas = torch.zeros((blit.DEPTH,) + blit.padded_dims(ch, cw),
                         dtype=torch.int32, device=dev)
    err3 = require_equal((blit.blit_frames_(frames3, pos, canvas.clone(),
                                            box=box),),
                         (blit.blit_frames_plain_(frames3, pos,
                                                  canvas.clone()),),
                         "blit, xcorr collect")
    ms3 = time_ms(lambda: blit.blit_frames_(frames3, pos, canvas, box=box),
                  50)
    plain3 = time_ms(lambda: blit.blit_frames_plain_(frames3, pos, canvas), 3)
    library3, bound3, _ = blit_library_and_bound(frames3, pos, canvas)
    log(f"xcorr collect kernels: medians-only extract [{b},{fh},{fw}] "
        f"kernel {ms1:.4f} ms, plain {plain1:.4f}, bound {bound1:.4f}; blit "
        f"pass chunk kernel {ms3:.4f} ms, plain {plain3:.4f}, library "
        f"{library3:.4f}, bound {bound3:.4f}; equal (exact, tolerance 0)")
    k1 = kernel_entry("extract_medians_xcorr",
                      "remap_tpu/ops/pallas/extract.py:253", "extract.cu",
                      err1, ms1, plain1, bound1)
    k3 = kernel_entry("blit_xcorr", "remap_tpu/ops/pallas/blit.py:130",
                      "blit.cu", err3, ms3, plain3, bound3, library3)
    k1["launches"] = launches["extract_medians"]
    k3["launches"] = launches["blit"]
    return [k1, k3]


class CanvasCalls:
    """Counts a family's canvas matcher's calls and acceptances while
    active (splice looks ``models.<family>.match_canvases`` up at each
    match, through ``models.family``)."""

    def __init__(self, family: str):
        import importlib

        self.module = importlib.import_module(
            f"remap_tpu_torch.models.{family}")
        self.name = "match_canvases"
        self.calls = self.accepted = 0

    def __enter__(self):
        real = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls += 1
            self.accepted += int(bool(out.ok))
            return out

        self.real = real
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_map(res, path, world, noise_at: int, n: int, what: str) -> tuple:
    """The map build's gates: collect's offsets the camera's (unmatched only
    at 0 and around the noise frame), splice leaving two fragments (the
    world's every other frame, the noise frame alone), 2 maps, the world
    map's interior at least 99% the world.  Returns (agree, compared)."""
    check_session(res.collect, path, f"{what} collect", noise_at)
    numbers = sorted(len(f.frames) for f in res.fragments)
    if numbers != [1, n - 1] or len(res.maps) != 2:
        raise AssertionError(f"{what}: fragments of {numbers} frames, "
                             f"{len(res.maps)} maps")
    noise = min(res.fragments, key=lambda f: len(f.frames))
    if [r.number for r in noise.frames] != [noise_at]:
        raise AssertionError(f"{what}: the noise fragment holds "
                             f"{[r.number for r in noise.frames]}")
    agree, compared = world_agreement(res, world, path, res.window.crop)
    if agree < 0.99 * compared:
        raise AssertionError(f"{what}: the world map agrees with the world "
                             f"at {agree} of {compared} px")
    return agree, compared


def xcorr_cli_phase(dev, smi: str, counters: dict, grid_perf: str) -> None:
    """Phase 11 (c): cli.main --matcher xcorr on the map phase's 2048-frame
    session as raw files at PipelineConfig()'s flags, counts zeroed just
    before and read just after: offsets the camera's wherever matched,
    unmatched only at frame 0 and around the noise frame, splice joining
    the two world fragments with match_canvases and leaving the noise
    frame alone (2 maps), the world map's interior at least 99% the
    world; the 64-frame cut's maps byte-equal on the card and the CPU."""
    import tempfile

    from remap_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    frames, path = session_clip()
    world = session_world()
    flags = ["--region-capacity", cfg.region_capacity, "--vote-radius",
             cfg.vote_radius, "--matcher", "xcorr"]
    with tempfile.TemporaryDirectory() as tmp:
        write_raw(f"{tmp}/session", frames)
        for k in counters.values():
            k.launches = 0
        with cli_probe(dev) as rec, CanvasCalls("xcorr") as calls:
            rc, lines, wall_s = run_cli([f"{tmp}/session", *flags, "--perf",
                                         "--out-prefix", f"{tmp}/out"])
        launches = {name: k.launches for name, k in counters.items()}
        if rc != 0:
            raise AssertionError(f"cli xcorr: exit code {rc}")
        res = rec["builds"][-1]
        written_maps(lines, res.maps, "cli xcorr")
        agree, compared = check_map(res, path, world, NOISE_AT, len(frames),
                                    "cli xcorr")
        if calls.accepted != 1:
            raise AssertionError(f"cli xcorr: {calls.calls} canvas matches, "
                                 f"{calls.accepted} accepted")
        n = len(frames)
        log(f"cli xcorr: {n} raw files, --matcher xcorr at PipelineConfig()'s"
            f" flags: rc 0 in {wall_s:.3f} s ({n / wall_s:.1f} frames/s of "
            f"wall); offsets the camera's, unmatched only at 0, {NOISE_AT}, "
            f"{NOISE_AT + 1}; splice: {calls.calls} match_canvases calls, "
            f"{calls.accepted} accepted, the world fragments joined, the "
            f"noise frame alone; 2 maps {[m.shape for m in res.maps]}, the "
            f"world map's interior equals the world at {agree} of {compared} "
            f"px ({agree / compared:.4%}); launches {launches}; on {smi}")
        log(f"cli xcorr stages: {perf_lines(lines)}; grid_vote (phase 10): "
            f"{grid_perf}; on {smi}")

        lo = NOISE_AT - SHORT // 2
        write_raw(f"{tmp}/short", frames[lo:lo + SHORT])
        maps = {}
        for where in ("card", "cpu"):
            extra = ["--cpu"] if where == "cpu" else []
            with cli_probe(dev) as srec:
                rc, slines, s_wall = run_cli(
                    [f"{tmp}/short", *flags, "--frame-batch", SHORT, *extra,
                     "--out-prefix", f"{tmp}/short_{where}_"])
            if rc != 0:
                raise AssertionError(f"cli xcorr {where} cut: exit code {rc}")
            maps[where] = srec["builds"][-1].maps
            written_maps(slines, maps[where], f"cli xcorr {where} cut")
        same_maps(maps["card"], maps["cpu"], "cli xcorr cut, card vs CPU")
        log(f"cli xcorr cut: {SHORT} frames around the noise frame, "
            f"--frame-batch {SHORT}: {len(maps['cpu'])} maps byte-equal on "
            f"the card and with --cpu (the CPU run {s_wall:.1f} s)")


def vga_session(n: int = VGA_SESSION, seed: int = 21):
    """A session at VGA (640x480) from utils.clips.render_clip: a busy
    world under a +-8 px camera walk, 3 moving 8x8 sprites, a 16-row HUD
    and 4-px border, and the play area of frame VGA_NOISE_AT noise.
    Returns (frames, camera path, world)."""
    from remap_tpu_torch.config import VGA
    from remap_tpu_torch.utils import clips

    h, w = VGA.screen_height, VGA.screen_width
    rng = np.random.default_rng(seed)
    world = clips.make_world(h + 400, w + 400, rng)
    path = clips.make_camera_path(n, world.shape, (h, w), rng, max_step=8)
    frames = np.stack(clips.render_clip(
        world, path, (h, w), rng=rng, n_sprites=3, sprite_size=8,
        hud_rows=16, border=4).frames)
    frames[VGA_NOISE_AT, 16:-4, 4:-4] = rng.integers(
        0, 16, (h - 20, w - 8), dtype=np.uint8)
    return frames, path, world


def pyramid_map_phase(dev, smi: str, counters: dict) -> int:
    """Phase 11 (d): BASELINE config 5's map build: builder.build_from_frames
    under VGA with matcher "pyramid" on a VGA_SESSION-frame 640x480
    session with a noise frame, counts zeroed just before and read just
    after, with (c)'s gates (splice through match_canvases_pyramid); a
    VGA_SHORT-frame cut around the noise frame byte-equal on the card and
    the CPU.  Returns the build's launches of the fine-level kernel (one
    a batch)."""
    from remap_tpu_torch.config import VGA
    from remap_tpu_torch.ops.kernels import correlate as kcorrelate

    cfg = dataclasses.replace(VGA, matcher="pyramid")
    frames, path, world = vga_session()
    lo = VGA_NOISE_AT - VGA_SHORT // 2
    scfg = dataclasses.replace(cfg, frame_batch=VGA_SHORT)
    short = frames[lo:lo + VGA_SHORT]
    card, card_spliced = timed_build(dev, short, scfg, counters)[:2]
    t0 = time.perf_counter()
    cpu, cpu_spliced = timed_build("cpu", short, scfg, counters)[:2]
    cpu_s = time.perf_counter() - t0
    same_build((card, card_spliced), (cpu, cpu_spliced),
               f"the {VGA_SHORT}-frame VGA cut, card vs CPU")
    for k in list(counters.values()) + [kcorrelate.fine_counts_cuda]:
        k.launches = 0
    with CanvasCalls("pyramid") as calls:
        t0 = time.perf_counter()
        res, _, stages = timed_build(dev, frames, cfg, counters)[:3]
        wall_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    agree, compared = check_map(res, path, world, VGA_NOISE_AT, len(frames),
                                "pyramid map")
    fine = kcorrelate.fine_counts_cuda.launches
    if fine != -(-len(frames) // cfg.frame_batch):
        raise AssertionError(f"pyramid map: the fine-level kernel launched "
                             f"{fine} times, not once a batch")
    if calls.accepted != 1:
        raise AssertionError(f"pyramid map: {calls.calls} canvas matches, "
                             f"{calls.accepted} accepted")
    n = len(frames)
    log(f"pyramid map build (VGA): {n} frames [{frames.shape[1]}x"
        f"{frames.shape[2]}], noise frame {VGA_NOISE_AT}: offsets the "
        f"camera's (steps up to 8 px), unmatched only at 0, {VGA_NOISE_AT}, "
        f"{VGA_NOISE_AT + 1}; splice {calls.calls} match_canvases_pyramid "
        f"calls, {calls.accepted} accepted; 2 maps "
        f"{[m.shape for m in res.maps]}, the world map's interior equals the "
        f"world at {agree} of {compared} px ({agree / compared:.4%}); wall "
        f"{wall_s:.3f} s ({n / wall_s:.1f} frames/s); launches {launches}, "
        f"the fine-level kernel {fine}; "
        f"the {VGA_SHORT}-frame cut's maps byte-equal on the CPU "
        f"({cpu_s:.1f} s); on {smi}")
    log("pyramid map stages: " + ", ".join(
        f"{s['stage']} {s['ms']:.1f} ms (peak {mib(s['peak_mb'])})"
        for s in stages) + f"; on {smi}")
    return fine


def fine_counts_kernel(dev, smi: str) -> dict:
    """Phase 11 (a): the pyramid's fine-level count kernel at FINE_PAIRS
    cropped VGA pairs (+-6 px camera steps, the coarse level's own offsets
    times 4, fine radius 5) against its plain version on the card (the
    direct counts of ``curr`` rolled by ``shift_frames``, which the fine
    level ran before the kernel), exact, one launch a call; both timed.
    Returns its kernel entry, without its launches (the map build's)."""
    import torch

    from remap_tpu_torch.ops import correlate
    from remap_tpu_torch.ops.kernels import correlate as kcorrelate
    from remap_tpu_torch.utils import clips

    h, w = VGA_CROPPED
    radius = 5
    rng = np.random.default_rng(37)
    world = clips.make_world(h + 400, w + 400, rng)
    path = clips.make_camera_path(FINE_PAIRS + 1, world.shape, (h, w), rng,
                                  max_step=6)
    frames = torch.as_tensor(np.stack(clips.render_clip(world, path,
                                                        (h, w)).frames),
                             device=dev)
    prev, curr = frames[:-1], frames[1:]
    base = correlate.match_xcorr(prev[:, ::4, ::4].contiguous(),
                                 curr[:, ::4, ::4].contiguous(), radius=32,
                                 min_cover=0.15).offset * 4

    def plain():
        return correlate.correlation_scores_direct(
            prev, correlate.shift_frames(curr, base), radius)

    before = kcorrelate.fine_counts_cuda.launches
    got = correlate.fine_counts(prev, curr, base, radius)
    if kcorrelate.fine_counts_cuda.launches != before + 1:
        raise AssertionError("fine_counts did not launch its kernel once")
    err = require_equal((got.int(),), (plain().int(),), "fine counts")
    ms = time_ms(lambda: kcorrelate.fine_counts_cuda(prev, curr, base,
                                                     radius), 20)
    plain_ms = time_ms(plain, 3)
    counts = kcorrelate.fine_counts_cuda(prev, curr, base, radius)
    bound = bound_ms((prev, curr, base), (counts,))
    compares = FINE_PAIRS * (2 * radius + 1) ** 2 * h * w
    log(f"fine counts [{FINE_PAIRS},{h},{w}] radius {radius}, coarse "
        f"offsets {int(base.abs().max())} px at most: the kernel equals the "
        f"plain version; {ms:.4f} ms (plain {plain_ms:.4f} ms, byte bound "
        f"{bound:.4f} ms), {compares:,} compares, "
        f"{compares / ms / 1e9:.2f} T compares/s; one launch a batch; "
        f"on {smi}")
    entry = kernel_entry(
        "fine counts", "none: the JAX package's fine pass is jnp.roll and "
        "slices (remap_tpu/ops/correlate.py correlation_scores_direct)",
        "fine.cu", err, ms, plain_ms, bound)
    entry.update(compares=compares, compares_per_s=compares / ms * 1e3)
    return entry


def matcher_phase(dev, counters: dict, smi: str, grid_perf: str) -> list:
    """Phase 11, the matcher families: (a) the correlation ops on the card
    against the CPU and the fine-level count kernel against its plain
    version, (b) the multi-clip step under the three families, (c) the
    CLI under --matcher xcorr, (d) the pyramid map build at VGA.  Returns
    the kernel entries of the multi-clip step, of the xcorr collect path
    and of the fine-level counts (its launches the pyramid map build's),
    with their launches."""
    from remap_tpu_torch.config import PipelineConfig

    launches, cropped, res = matcher_ops(dev, smi, counters)
    entries = xcorr_collect_kernels(
        dev, cropped, res, dataclasses.replace(PipelineConfig(),
                                               matcher="xcorr"), launches)
    fine = fine_counts_kernel(dev, smi)
    entries.append(fine)
    entries += multiclip_phase(dev, smi, counters)
    xcorr_cli_phase(dev, smi, counters, grid_perf)
    fine["launches"] = pyramid_map_phase(dev, smi, counters)
    return entries


def kernel_name(name: str) -> str:
    """A CUDA kernel's profiler name without its namespace noise, return
    type and arguments, cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0][:60]


def repeated_mesh(dev, data: int, space: int):
    """A (data, space) mesh whose every entry is ``dev``: its shards run
    one after another on the one card (or the CPU)."""
    from remap_tpu_torch.parallel import mesh

    return mesh.make_mesh(devices=[dev] * (data * space), space=space)


def host_ms(devs, fn, reps: int = 5) -> float:
    """Wall ms per call of ``fn`` over ``reps`` calls, the devices
    ``devs`` (one or a list) synchronised before and after (one warm-up
    call first)."""
    fn()
    sync(devs)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(devs)
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_case(dev, clips_np, deltas, layout, cfg, pad: int, data: int,
                 space: int, counters: dict, cut: int, smi: str, what: str,
                 devices=None):
    """make_sharded_step on a (data, space) mesh of ``devices`` (by
    default the card ``dev`` repeated), counts zeroed just before one
    step and read just after: every output equal to make_pipeline_step's
    on ``dev``, offsets the camera's deltas with every pair after frame 0
    matched, launches per step (K1 and K3 once a shard, K2 once a data
    row under grid_vote; K3 alone under a correlation family; the
    fine-level kernel once a data row under pyramid), and the first
    ``data`` clips' first ``cut`` frames equal on a CPU mesh of the same
    shape.  Its ms on clips placed on the mesh first, as the
    unsharded step's clips wait on its card, every device synchronised.
    Returns (the step's result, its launches, sharded ms, unsharded
    ms)."""
    import torch

    from remap_tpu_torch.ops.kernels import correlate as kcorrelate
    from remap_tpu_torch.parallel import mesh as tmesh
    from remap_tpu_torch.parallel import sharded

    images = torch.as_tensor(clips_np, device=dev)
    mesh = tmesh.make_mesh(devices=devices or [dev] * (data * space),
                           space=space)
    devs = sorted({str(d) for row in mesh.devices for d in row})
    step = sharded.make_sharded_step(mesh, layout, cfg, atlas_pad=pad)
    plain = sharded.make_pipeline_step(layout, cfg, atlas_pad=pad,
                                       device=dev)
    step(images)   # warm-up
    want = plain(images)
    counted = dict(counters, fine=kcorrelate.fine_counts_cuda)
    for k in counted.values():
        k.launches = 0
    res, _, peak = timed(dev, lambda: step(images))
    launches = {name: k.launches for name, k in counted.items()}
    grid = cfg.matcher == "grid_vote"
    expect = {"extract": data * space if grid else 0,
              "tables": data if grid else 0, "blit": data * space,
              "fine": data if cfg.matcher == "pyramid" else 0}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"{what}: launches {launches}, not {expect}")
    got = sharded.assemble(res)
    same_tensors(got, want, f"{what}: sharded vs make_pipeline_step")
    matched = got.matched.numpy()
    if matched[:, 0].any() or not matched[:, 1:].all() or not np.array_equal(
            got.offsets[:, 1:].numpy(), deltas):
        raise AssertionError(f"{what}: offsets or matched flags differ from "
                             "the camera's")
    placed = sharded.place_clips(images, mesh)
    sharded_ms = host_ms(devs, lambda: step(placed))
    plain_ms = host_ms(devs, lambda: plain(images))
    t0 = time.perf_counter()
    cut_np = clips_np[:data, :cut]
    card_cut = sharded.assemble(step(torch.as_tensor(cut_np, device=dev)))
    cpu_cut = sharded.assemble(sharded.make_sharded_step(
        repeated_mesh("cpu", data, space), layout, cfg, atlas_pad=pad)(cut_np))
    same_tensors(card_cut, cpu_cut, f"{what}: the {data}x{cut}-frame cut, "
                 "card vs CPU mesh")
    c, t, h, w = clips_np.shape
    log(f"{what}: {c} clips x {t} frames [{h}x{w}] on a ({data}, {space}) "
        f"mesh of {', '.join(devs)}{'' if devices else ' repeated'}: every "
        f"output equal to make_pipeline_step on {dev}, offsets the "
        f"camera's, launches "
        f"{launches}; step {sharded_ms:.3f} ms ({c * t / sharded_ms * 1e3:.1f}"
        f" frames/s) against the unsharded step's {plain_ms:.3f} ms; peak "
        f"{mib(peak)} allocated; a {data}x{cut}-frame cut equal on a CPU "
        f"mesh ({time.perf_counter() - t0:.1f} s); on {smi}")
    return res, launches, sharded_ms, plain_ms


def vga_clips(seed: int = 43):
    """BASELINE config 5's frames for the sharded step: VGA_CLIPS clips of
    VGA_T frames at 640x480 over one make_world, each camera walking +-3
    px a frame within 60 px of its start.  Returns (clips, deltas)."""
    from remap_tpu_torch.config import VGA
    from remap_tpu_torch.utils import clips

    h, w = VGA.screen_height, VGA.screen_width
    rng = np.random.default_rng(seed)
    world = clips.make_world(h + 300, w + 300, rng)
    limits = (world.shape[1] - w, world.shape[0] - h)
    paths = [walk(VGA_T, (int(rng.integers(60, limits[0] - 60)),
                          int(rng.integers(60, limits[1] - 60))),
                  rng, 3, 60, limits) for _ in range(VGA_CLIPS)]
    frames = np.stack([np.stack(clips.render_clip(world, p, (h, w)).frames)
                       for p in paths])
    return frames, np.stack([np.diff(np.asarray(p), axis=0) for p in paths])


def band_kernels(dev, clips_np, result, layout, pad: int, space: int,
                 launches: dict) -> list:
    """K1 on band 1 of ``space`` frame bands plus its halo rows, and K3
    into band 1 of the atlas rows with its RowClip (the band's edges cut
    through the frames), as the sharded step launches them, against
    their plain versions on the card; returns their entries."""
    import torch

    from remap_tpu_torch.ops import kpe
    from remap_tpu_torch.ops.kernels import blit
    from remap_tpu_torch.parallel import sharded

    c, t, h, w = clips_np.shape
    lo, hi = sharded.row_bands(h, space, kpe.HALO)[1]
    sub = torch.as_tensor(clips_np[:, :, lo - kpe.HALO:hi + kpe.HALO],
                          device=dev).reshape(c * t, -1, w).contiguous()
    band = kpe.RowBand.of(layout, lo - kpe.HALO, sub.shape[1])
    got = kpe.extract_dense(sub, band)
    err1 = require_equal(got, kpe.extract_dense_plain(sub, band),
                         f"extract band, space {space}")
    ms1 = time_ms(lambda: kpe.extract_dense(sub, band), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(sub, band), 3)
    bound1 = bound_ms((sub,), got)

    ah, aw = h + 2 * pad, w + 2 * pad
    a0, a1 = sharded.row_bands(ah, space)[1]
    rows = a1 - a0
    limit = torch.tensor([aw - w, ah - h], dtype=torch.int32, device=dev)
    positions = torch.cat([sh.positions for sh in result.data]).to(dev)
    anchored = torch.minimum(torch.clamp(positions + pad, min=0), limit)
    shift = torch.arange(c, dtype=torch.int32, device=dev) * rows - a0
    pos = (anchored + torch.stack([torch.zeros_like(shift), shift],
                                  dim=-1)[:, None]).reshape(-1, 2)
    ys = pos[:, 1].cpu().numpy() - np.repeat(np.arange(c) * rows, t)
    cut = int(((ys < 0) | (ys + h > rows)).sum())
    if cut == 0:
        raise AssertionError(f"blit band, space {space}: no frame crosses "
                             "the band's edges")
    clip = blit.RowClip(0, rows, every=t, step=rows)
    frames = torch.as_tensor(clips_np, device=dev).reshape(c * t, h, w)
    canvas = torch.randint(0, 1 << 16, (blit.DEPTH,)
                           + blit.padded_dims(c * rows, aw),
                           dtype=torch.int32, device=dev)
    box = (0, 0, aw, c * rows)
    got3 = blit.blit_frames_(frames, pos, canvas.clone(), box=box, rows=clip)
    err3 = require_equal((got3,), (blit.blit_frames_plain_(
        frames, pos, canvas.clone(), rows=clip),),
        f"blit band, space {space}")
    ms3 = time_ms(lambda: blit.blit_frames_(frames, pos, canvas, box=box,
                                            rows=clip), 50)
    plain3 = time_ms(lambda: blit.blit_frames_plain_(frames, pos, canvas,
                                                     rows=clip), 3)
    library3, bound3, voted = blit_library_and_bound(frames, pos, canvas,
                                                     rows=clip)
    log(f"band kernels, VGA space {space}: extract band rows [{lo},{hi}) "
        f"plus halo [{c * t},{sub.shape[1]},{w}] kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f}, bound {bound1:.4f}; blit into atlas rows [{a0},{a1})"
        f" [{tuple(canvas.shape)}], {cut} of {c * t} frames cut by the band's"
        f" edges, kernel {ms3:.4f} ms, plain {plain3:.4f}, library "
        f"index_put_ {library3:.4f}, bound {bound3:.4f} (the frame rows "
        f"inside the band, and {voted} voted bins in and out); both equal "
        f"(exact, tolerance 0)")
    entries = [
        kernel_entry(f"extract_band_vga_s{space}",
                     "remap_tpu/ops/pallas/extract.py:253", "extract.cu",
                     err1, ms1, plain1, bound1),
        kernel_entry(f"blit_band_vga_s{space}",
                     "remap_tpu/ops/pallas/blit.py:130", "blit.cu", err3,
                     ms3, plain3, bound3, library3)]
    entries[0]["launches"] = launches["extract"]
    entries[1]["launches"] = launches["blit"]
    return entries


@contextlib.contextmanager
def recorded_round_robins():
    """Yield a list that gains, for each round robin a stage takes (each
    call of parallel.fragments.fragment_devices), the devices it handed
    out."""
    from remap_tpu_torch.parallel import fragments

    taken = []
    real = fragments.fragment_devices

    def recorded(n, devices=None, device=None):
        out = real(n, devices, device)
        taken.append([str(d) for d in out])
        return out

    fragments.fragment_devices = recorded
    try:
        yield taken
    finally:
        fragments.fragment_devices = real


def round_robin_build(dev, counters: dict, maps, smi: str, devices=None,
                      rounds: int = 2) -> dict:
    """The map cell's session through builder.build_from_frames with its
    fragments round-robined over ``devices`` (by default [card, card]):
    splice's first extraction, the foreground, the clean; counts zeroed
    around the first such build: maps byte-equal to ``maps`` (the serial
    build's), the three round robins taken, every kernel launched.  Then
    ``rounds`` of round robin, serial, serial, round robin, each build
    timed on the host clock with every device synchronised (the serial
    build warm from ``maps``'s, the round robin from the first).
    Returns the maps' count, the placements and each build's ms."""
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.pipeline import builder

    devices = devices or [dev, dev]
    devs = sorted({str(d) for d in devices})
    frames, _ = session_clip()
    cfg = PipelineConfig()

    def build(over):
        sync(devs)
        t0 = time.perf_counter()
        res = builder.build_from_frames(frames, cfg, device=dev,
                                        devices=over)
        sync(devs)
        return res, (time.perf_counter() - t0) * 1e3

    for k in counters.values():
        k.launches = 0
    reset_peak(dev)
    with recorded_round_robins() as taken:
        res, _ = build(devices)
    peak = peak_mb(dev)
    launches = {name: k.launches for name, k in counters.items()}
    same_maps(res.maps, maps, "round-robin build vs the serial build")
    if len(taken) != 3 or 0 in launches.values():
        raise AssertionError(f"round-robin build: round robins {taken}, "
                             f"launches {launches}")
    ms = {"round_robin": [], "serial": []}
    for _ in range(rounds):
        for kind in ("round_robin", "serial", "serial", "round_robin"):
            ms[kind].append(build(devices if kind == "round_robin"
                                  else None)[1])
    log(f"round robins: the map cell's {len(frames)} frames with splice's "
        f"extraction, the foreground and the clean over "
        f"{[str(d) for d in devices]} (placed {taken}): {len(res.maps)} maps"
        f" byte-equal to the serial build's; peak {mib(peak)} on {dev}; "
        f"launches {launches}; {rounds} rounds of round robin, serial, "
        f"serial, round robin: round robin "
        + ", ".join(f"{t:.1f}" for t in ms["round_robin"])
        + " ms (median "
        f"{statistics.median(ms['round_robin']):.1f}), serial "
        + ", ".join(f"{t:.1f}" for t in ms["serial"])
        + f" ms (median {statistics.median(ms['serial']):.1f}); on {smi}")
    return {"maps": len(res.maps), "placed": taken,
            "round_robin_ms": ms["round_robin"], "serial_ms": ms["serial"]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_phase(dev, counters: dict, maps, smi: str) -> None:
    """A 1-rank NCCL group (one rank a GPU; the host has one card): an
    all_reduce on the card, the sharded step on this rank's clips through
    make_global_batch, then cli.main --distributed on the CLI cell's raw
    files joining its own group: maps byte-equal (PNG bytes too) to the
    serial build's (phases 9 and 10), every kernel launched, the group
    gone after."""
    import tempfile

    import torch
    import torch.distributed as dist

    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.device import same_device
    from remap_tpu_torch.io import png
    from remap_tpu_torch.parallel import distributed, sharded

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl" or not same_device(
                distributed.local_device(), dev):
            raise AssertionError(f"nccl: backend {dist.get_backend()}, "
                                 f"device {distributed.local_device()}")
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)
        clips_np, _ = multiclip_clips()
        local = clips_np[distributed.local_clip_slice(len(clips_np))]
        mesh = repeated_mesh(dev, 2, 2)
        cfg = PipelineConfig(screen_width=W, screen_height=H,
                             region_capacity=768, frame_batch=MULTI_T)
        layout = make_layout(W, H, 4, 2, 16)
        got = sharded.assemble(sharded.make_sharded_step(
            mesh, layout, cfg, atlas_pad=64)(
                distributed.make_global_batch(local, mesh)))
        want = sharded.make_pipeline_step(layout, cfg, atlas_pad=64,
                                          device=dev)(
            torch.as_tensor(clips_np, device=dev))
        same_tensors(got, want, "nccl rank 0: sharded step vs unsharded")
        if int(one.sum()) != 4:
            raise AssertionError("nccl: all_reduce over 1 rank changed it")
    finally:
        dist.destroy_process_group()
    cfg = PipelineConfig()
    frames, _ = session_clip()
    with tempfile.TemporaryDirectory() as tmp:
        write_raw(f"{tmp}/session", frames)
        argv = [f"{tmp}/session", "--region-capacity", cfg.region_capacity,
                "--vote-radius", cfg.vote_radius, "--distributed",
                "--coordinator", f"127.0.0.1:{free_port()}",
                "--num-processes", 1, "--process-id", 0, "--out-prefix",
                f"{tmp}/out"]
        for k in counters.values():
            k.launches = 0
        with cli_probe(dev) as rec:
            rc, lines, wall_s = run_cli(argv)
        launches = {name: k.launches for name, k in counters.items()}
        if rc != 0 or dist.is_initialized():
            raise AssertionError(f"cli --distributed: exit code {rc}, group "
                                 f"left {dist.is_initialized()}")
        same_maps(rec["builds"][-1].maps, maps, "cli --distributed")
        written_maps(lines, maps, "cli --distributed")
        for i, image in enumerate(maps, start=1):
            png.write_map(f"{tmp}/want{i}.png", image)
            if (open(f"{tmp}/out{i}.png", "rb").read()
                    != open(f"{tmp}/want{i}.png", "rb").read()):
                raise AssertionError(f"cli --distributed: out{i}.png's bytes"
                                     " differ")
        if 0 in launches.values():
            raise AssertionError(f"cli --distributed: launches {launches}")
    log(f"nccl: a 1-rank group (tcp://127.0.0.1), all_reduce on the card, "
        f"the sharded step through make_global_batch equal to the unsharded"
        f" step; cli.main --distributed on the {len(frames)} raw files: rc "
        f"0 in {wall_s:.3f} s, {len(maps)} PNGs byte-equal to the serial "
        f"build's maps, launches {launches}, the group destroyed; on {smi}")


def multi_device_phase(dev, counters: dict, maps, smi: str) -> list:
    """Phase 12, multi-device: the sharded step on meshes of the card
    repeated (bench_multiclip's clips at each of MESHES; VGA clips under
    grid_vote and pyramid at each of VGA_SPACES), K1 per band with its
    halo and K3's row clip against their plain versions, the fragment
    round robins of the map build, a 1-rank NCCL group with the CLI's
    --distributed, and one device_trace of a sharded step.  Returns the
    band kernels' entries."""
    import dataclasses as dc
    import tempfile

    import torch

    from remap_tpu_torch.config import VGA, PipelineConfig
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.parallel import sharded
    from remap_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    clips_np, paths = multiclip_clips()
    deltas = np.stack([np.diff(np.asarray(p), axis=0) for p in paths])
    cfg = PipelineConfig(screen_width=W, screen_height=H, region_capacity=768,
                         frame_batch=MULTI_T)
    layout = make_layout(W, H, 4, 2, 16)
    for data, space in MESHES:
        sharded_case(dev, clips_np, deltas, layout, cfg, 64, data, space,
                     counters, 8, smi, "sharded NES")

    vga_np, vga_deltas = vga_clips()
    vlayout = make_layout(VGA.screen_width, VGA.screen_height,
                          VGA.grid_width, VGA.grid_height, VGA.grid_overlap)
    entries = []
    for family in ("grid_vote", "pyramid"):
        vcfg = dc.replace(VGA, matcher=family, frame_batch=VGA_T)
        for space in VGA_SPACES:
            res, launches, _, _ = sharded_case(
                dev, vga_np, vga_deltas, vlayout, vcfg, 64, VGA_CLIPS, space,
                counters, 4, smi, f"sharded VGA {family}")
            if family == "grid_vote":
                entries += band_kernels(dev, vga_np, res, vlayout, 64, space,
                                        launches)

    round_robin_build(dev, counters, maps, smi)
    nccl_phase(dev, counters, maps, smi)

    step = sharded.make_sharded_step(repeated_mesh(dev, 1, 4), vlayout,
                                     dc.replace(VGA, frame_batch=VGA_T),
                                     atlas_pad=64)
    images = torch.as_tensor(vga_np, device=dev)
    step(images)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp) as trace:
            step(images)
        size = os.path.getsize(trace.path)
    top = trace.top(6)
    if not top:
        raise AssertionError("device_trace: no device operations recorded")
    log(f"device_trace of the VGA grid_vote sharded step at (1, 4): a "
        f"{size}-byte Chrome trace; top device operations (ms): "
        + "; ".join(f"{kernel_name(name)} {ms:.3f}" for name, ms in top)
        + f"; on {smi}")
    log(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


SPEC_CUT = 12              # spec phase: C64 frames from the noise frame on
MOTION_SEED = 3            # motion: the platformer session's seed and the
MOTION_PAIRS = range(50, 60)   # frames t of its pairs (t - 1, t)
MOTION_FAR = (90, -80)     # an adjustment past the window's clip (+-68)
E2E_CLIP = dict(n_frames=30, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
                hud_rows=8, border=4, max_step=4, n_sprites=1, sprite_size=5)


@contextlib.contextmanager
def recorded_spec(rec: dict):
    """While ``spec.pipeline.build`` runs, record its window
    (``spec.aws.scan``) and each fragment's frame records as
    ``spec.frc.collect`` leaves them: (number, position)."""
    from remap_tpu_torch.spec import aws, frc

    scan, collect = aws.scan, frc.collect

    def rec_scan(frames, *args, **kwargs):
        rec["window"] = scan(frames, *args, **kwargs)
        return rec["window"]

    def rec_collect(frames, layout):
        fragments = collect(frames, layout)
        rec["fragments"] = [[(r.number, r.position) for r in f.frames]
                            for f in fragments]
        return fragments

    aws.scan, frc.collect = rec_scan, rec_collect
    try:
        yield rec
    finally:
        aws.scan, frc.collect = scan, collect


def relative_records(fragments: list) -> list:
    """Each fragment's (number, position relative to its first frame)."""
    out = []
    for records in fragments:
        x0, y0 = records[0][1]
        out.append([(n, (x - x0, y - y0)) for n, (x, y) in records])
    return out


def card_vs_spec(dev, frames, cfg, counters: dict, what: str) -> dict:
    """The spec pipeline on the host and builder.build_from_frames on the
    card, counts zeroed just before the card's build and read just after:
    the windows' crops, collect's frame records relative to each
    fragment's first frame and the maps byte for byte must be equal."""
    from remap_tpu_torch.pipeline import builder
    from remap_tpu_torch.spec import pipeline as spipeline

    rec: dict = {}
    t0 = time.perf_counter()
    with recorded_spec(rec):
        want = spipeline.build(list(frames))
    spec_s = time.perf_counter() - t0

    collected = []

    class Records(builder.Callbacks):
        def on_collect(self, result):
            collected.extend([(r.number, r.position) for r in f.frames]
                             for f in result.fragments)

    for k in counters.values():
        k.launches = 0
    res, build_ms, peak = timed(dev, lambda: builder.build_from_frames(
        frames, cfg, callbacks=Records(), device=dev))
    launches = {name: k.launches for name, k in counters.items()}
    crops = [None if w is None else dataclasses.astuple(w.crop)
             for w in (rec["window"], res.window)]
    if crops[0] != crops[1]:
        raise AssertionError(f"{what}: window crop {crops[1]} on the card, "
                             f"{crops[0]} in the spec")
    if relative_records(collected) != relative_records(rec["fragments"]):
        raise AssertionError(f"{what}: collect's frame records differ from "
                             "spec.frc.collect's")
    if len(res.maps) != len(want) or any(
            a.shape != b.shape or a.tobytes() != b.tobytes()
            for a, b in zip(res.maps, want)):
        raise AssertionError(
            f"{what}: the card's maps {[m.shape for m in res.maps]} differ "
            f"from the spec's {[m.shape for m in want]}")
    return {"spec_s": spec_s, "build_ms": build_ms, "peak": peak,
            "launches": launches, "maps": [m.shape for m in want],
            "fragments": [len(f) for f in rec["fragments"]],
            "crop": crops[0]}


def spec_oracle(dev, counters: dict, smi: str) -> None:
    """Phase 13 (a): the card's map build against the NumPy spec
    (remap_tpu_torch.spec, no JAX) on the JAX package's end-to-end clip
    and on a SPEC_CUT-frame C64 cut of the collect phase's session that
    starts at its noise frame (a fragment of its own), at
    PipelineConfig()'s defaults.  The cut is sized by the spec's time on
    a loaded host: its artifact filter scans the whole fragment canvas
    (three steps of the frame wide once the camera has moved both ways),
    a cost that hardly shrinks with the frame count, and a cut whose two
    sweeps splice into one fragment costs the spec more than twice as
    much."""
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.utils import clips

    e2e = clips.simple_clip(**E2E_CLIP)
    cfg = PipelineConfig(screen_width=96, screen_height=72,
                         region_capacity=2048, splice_capacity=4096,
                         frame_batch=8)
    got = card_vs_spec(dev, np.stack(e2e.frames), cfg, counters,
                       "spec e2e clip")
    log(f"spec e2e clip: {len(e2e.frames)} frames [72x96], crop "
        f"{got['crop']}, collect fragments {got['fragments']}, maps "
        f"{got['maps']} byte-equal to spec.pipeline.build's; spec "
        f"{got['spec_s']:.1f} s on the host, the card's build "
        f"{got['build_ms']:.1f} ms (peak {mib(got['peak'])}), launches "
        f"{got['launches']}; on {smi}")

    frames, _ = session_clip(NOISE_AT + SPEC_CUT)
    cut = frames[NOISE_AT:]
    got = card_vs_spec(dev, cut, PipelineConfig(), counters, "spec C64 cut")
    if got["fragments"] != [1, SPEC_CUT - 1] or 0 in got["launches"].values():
        raise AssertionError(f"spec C64 cut: fragments {got['fragments']}, "
                             f"launches {got['launches']}")
    log(f"spec C64 cut: {len(cut)} frames [312x388] (session frames "
        f"{NOISE_AT}-{NOISE_AT + SPEC_CUT - 1}, the noise frame first) at "
        f"PipelineConfig(): crop {got['crop']} equal to "
        f"spec.aws.scan's, collect's frame records equal to spec.frc."
        f"collect's (fragments {got['fragments']}), maps {got['maps']} "
        f"byte-equal to spec.pipeline.build's; spec {got['spec_s']:.1f} s "
        f"on the host, the card's build {got['build_ms']:.1f} ms (peak "
        f"{mib(got['peak'])}), launches {got['launches']}; on {smi}")


def motion_phase(dev, smi: str) -> dict:
    """Phase 13 (b): ops.motion.detect on consecutive platformer frames at
    C64 (388x312), half 4, adjusted by the camera's step, and one pair
    adjusted past the clip; K4a counted from zero over the detects.  The
    card must equal the CPU exactly; K4a at [1, 312, 388] against its
    plain version.  Returns K4a's entry."""
    import torch

    from remap_tpu_torch.ops import cc, motion
    from remap_tpu_torch.ops.kernels import cc as kcc
    from remap_tpu_torch.utils import gameplay

    session = gameplay.play_session(seed=MOTION_SEED,
                                    n_frames=MOTION_PAIRS[-1] + 1,
                                    frame_hw=(312, 388))
    cases = []
    for t in MOTION_PAIRS:
        (x0, y0), (x1, y1) = session.camera[t - 1], session.camera[t]
        cases.append((session.frames[t - 1], session.frames[t],
                      (x1 - x0, y1 - y0)))
    cases.append((session.frames[-2], session.frames[-1], MOTION_FAR))
    pairs = [(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
              adj) for a, b, adj in cases]
    motion.detect(*pairs[0])   # warm-up, not counted
    torch.cuda.synchronize()

    kcc.label_components_cuda.launches = 0
    got = [motion.detect(*p) for p in pairs]
    torch.cuda.synchronize()
    launches = kcc.label_components_cuda.launches
    if launches != len(pairs):
        raise AssertionError(f"motion: K4a launched {launches} times for "
                             f"{len(pairs)} detects")
    moving = []
    for (a, b, adj), res in zip(cases, got):
        want = motion.detect(a, b, adj, device="cpu")
        for name, g, w in zip(res._fields, res, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"motion {adj}: {name} differs between "
                                     "the card and the CPU")
        moving.append(int(want.moving.sum()))
    if not all(moving[:-1]) or moving[-1]:
        raise AssertionError(f"motion: moving contours {moving}")
    detect_ms = [time_ms(lambda p=p: motion.detect(*p), 10) for p in pairs]
    host = host_ms(dev, lambda: motion.detect(*pairs[1]), 10)

    curr = pairs[1][1][None].contiguous()
    err = require_equal((kcc.label_components_cuda(curr),),
                        (cc.label_components(curr),), "cc labels motion")
    ms = time_ms(lambda: kcc.label_components_cuda(curr), 50)
    plain = time_ms(lambda: cc.label_components(curr), 3)
    bound = bound_ms((curr,), (torch.empty_like(curr, dtype=torch.int32),))
    log(f"motion: {len(pairs)} detects at [312x388], half 4 (adjustments "
        f"{[c[2] for c in cases]}): offset, moving and votes equal on the "
        f"CPU, moving contours {moving}; K4a launched once a detect "
        f"({launches}); detect {statistics.median(detect_ms):.3f} ms (CUDA "
        f"events, median; {min(detect_ms):.3f}-{max(detect_ms):.3f}), "
        f"{host:.3f} ms of host wall; K4a [1,312,388] {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bound:.5f} ms (5 B/px), share "
        f"{bound / ms:.4f}; on {smi}")
    entry = kernel_entry("cc_labels_motion", "remap_tpu/ops/pallas/cc.py:168",
                         "cc.cu", err, ms, plain, bound)
    entry["launches"] = launches
    return entry


def sort2_phase(dev, frames_np, smi: str) -> None:
    """Phase 13 (c): table_mode="sort2" (torch ops on the card).  The
    streaming step at the bench configuration over N_BATCHES batches,
    counts zeroed just before and read just after (K1 and K3 once a step,
    K2 never): every output equal to the CPU's.  Sort2 tables on iid
    noise set the chunk-quota flag (region 6); on the clip's frames they
    equal K2's tables wherever no chunk overflows."""
    import dataclasses as dc

    import torch

    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import kpe, tables
    from remap_tpu_torch.ops.kernels import blit, extract
    from remap_tpu_torch.ops.kernels import tables as ktables
    from remap_tpu_torch.parallel.sharded import make_streaming_step

    cfg, layout = bench_config()
    cfg = dc.replace(cfg, table_mode="sort2")
    wrappers = {"extract": extract.extract_dense_cuda,
                "tables": ktables.build_tables_cuda,
                "blit": blit.blit_frames_cuda}
    batches = np.split(frames_np, N_BATCHES)
    init, step = make_streaming_step(layout, cfg, atlas_pad=ATLAS_PAD,
                                     device=dev)
    g_batches = [torch.as_tensor(b, device=dev) for b in batches]
    step(g_batches[0], init())   # warm-up, not counted
    torch.cuda.synchronize()
    for k in wrappers.values():
        k.launches = 0
    state, outs = init(), []
    for b in g_batches:
        out = step(b, state)
        state = out[-1]
        outs.append(host_outputs(out))
    launches = {name: k.launches for name, k in wrappers.items()}
    if launches != {"extract": N_BATCHES, "tables": 0, "blit": N_BATCHES}:
        raise AssertionError(f"sort2 step: launches {launches}")
    c_init, c_step = make_streaming_step(layout, cfg, atlas_pad=ATLAS_PAD,
                                         device="cpu")
    state = c_init()
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        out = c_step(torch.as_tensor(b), state)
        state = out[-1]
        for name, want in host_outputs(out).items():
            if not torch.equal(outs[i][name], want):
                raise AssertionError(f"sort2 step batch {i}: {name} differs "
                                     "between the card and the CPU")
    cpu_s = time.perf_counter() - t0
    flagged = sum(int(o["table"].sum()) for o in outs)
    state = init()
    sort2_ms = host_ms(dev, lambda: step(g_batches[1], state), 10)
    t_init, t_step = make_streaming_step(
        layout, dc.replace(cfg, table_mode="topk"), atlas_pad=ATLAS_PAD,
        device=dev)
    t_state = t_init()
    topk_ms = host_ms(dev, lambda: t_step(g_batches[1], t_state), 10)

    small = make_layout(96, 64, 4, 2, 16)
    noise = torch.as_tensor(np.random.default_rng(32).integers(
        0, 16, (1, 64, 96), dtype=np.uint8), device=dev)
    dense = kpe.extract_dense(noise, small)
    t = tables.build_tables(dense.weight, dense.codes, small, 512, "sort2")
    count = int(t.wcounts[0, 6, 1:].sum())
    if not bool(t.overflow[0, 6]) or count > 512:
        raise AssertionError(f"sort2 on noise: overflow[0, 6] "
                             f"{bool(t.overflow[0, 6])} ({count} keypoints)")

    dense = kpe.extract_dense(g_batches[0], layout)
    s2 = tables.build_tables(dense.weight, dense.codes, layout, CAPACITY,
                             "sort2")
    k2 = tables.build_tables(dense.weight, dense.codes, layout, CAPACITY)
    keep = ~s2.overflow
    if not bool(keep.any()):
        raise AssertionError("sort2 on the clip: every region table flagged")
    for name, a, b in zip(s2._fields, s2, k2):
        if not torch.equal(a[keep], b[keep]):
            raise AssertionError(f"sort2 vs K2 on the clip: {name} differs "
                                 "where no chunk overflows")
    log(f"sort2: the streaming step at the bench configuration "
        f"(table_mode='sort2'), {N_BATCHES} batches of {BATCH}: every output "
        f"equal on the CPU ({cpu_s:.1f} s there), {flagged} frames flagged, "
        f"launches {launches}; step {sort2_ms:.3f} ms against topk's (K2) "
        f"{topk_ms:.3f} ms (host wall, synchronised, 10 steps); iid noise "
        f"96x64 capacity 512: overflow[0, 6] set by the chunk quota alone "
        f"({count} keypoints); the clip's {int(keep.sum())} of "
        f"{keep.numel()} region tables without a full chunk equal K2's; on "
        f"{smi}")


def spec_motion_phase(dev, counters: dict, frames_np, smi: str) -> list:
    """Phase 13: the spec oracle, motion and sort2.  Returns K4a's motion
    entry."""
    t_phase = time.perf_counter()
    spec_oracle(dev, counters, smi)
    entry = motion_phase(dev, smi)
    sort2_phase(dev, frames_np, smi)
    log(f"spec, motion and sort2 phase: {time.perf_counter() - t_phase:.1f} s")
    return [entry]


def build_counters() -> dict:
    """The kernel wrappers a map build launches, by name (each counts its
    launches in ``.launches``)."""
    from remap_tpu_torch.ops.kernels import blit, cc, extract, tables

    return {"extract": extract.extract_dense_cuda,
            "tables": tables.build_tables_cuda,
            "blit": blit.blit_frames_cuda,
            "cc_labels": cc.label_components_cuda,
            "extract_medians": extract.extract_medians_cuda,
            "cc_stats": cc.label_stats_cuda}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from remap_tpu_torch.io import native
    from remap_tpu_torch.ops import _build
    from remap_tpu_torch.ops.kernels import blit, cc, extract, tables
    from remap_tpu_torch.utils.clips import make_clip

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    path, seconds, nvcc_log = _build.build()
    _build.library()
    log(f"build: {path.name} in {seconds:.1f} s")
    t0 = time.perf_counter()
    for name in ("libremapfeed.so", "libremapcodec.so"):
        native.library(name)
    log(f"build: native/feed.cpp and native/codec.cpp by make in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    frames = make_clip(BATCH * N_BATCHES, H, W)
    kernels, medians_entry = kernel_phase(dev, frames)

    counters = [extract.extract_dense_cuda, tables.build_tables_cuda,
                blit.blit_frames_cuda]
    main = main_path_phase(dev, frames, counters)
    blit_entry, fragment_entry = blit_phase(
        dev, frames, main["first4"][0]["offsets"],
        main["first4"][0]["matched"])
    kernels.append(blit_entry)
    for k, n in zip(kernels, main["launches"]):
        k["launches"] = n
    fps = BATCH / (main["step_ms_median"] / 1000.0)
    log(f"main path: {STEPS} steps, all flag-free, none strayed, final "
        f"matched 100%, {main['covered_px']} atlas px each one colour; "
        f"launches (extract, tables, blit) = {main['launches']}")
    log(f"main path step: median {main['step_ms_median']:.3f} ms "
        f"({fps:.1f} frames/s); chain wall {main['wall_s']:.3f} s "
        f"({STEPS * BATCH / main['wall_s']:.1f} frames/s) on {smi}")
    log("step ms: " + ", ".join(f"{t:.3f}" for t in main["step_ms"]))
    log(f"device operations per step: {main['kernels_per_step']} "
        "(torch.profiler, one step)")

    t0 = time.perf_counter()
    cpu_phase(frames, main["first4"])
    log(f"cpu: first {N_BATCHES} batches equal on CPU tensors "
        f"({time.perf_counter() - t0:.1f} s)")

    known_path_phase(dev)
    log("known path: offsets equal the true camera deltas")

    sprites = sprite_clip(frames)
    cc_entries = cc_kernel_phase(dev, sprites)
    fg_counters = counters + [extract.extract_medians_cuda,
                              cc.label_components_cuda, cc.label_stats_cuda]
    fg = foreground_phase(dev, sprites, frames, fg_counters)
    for k in [medians_entry] + cc_entries:
        k["launches"] = fg["launches"][k["name"]]
    fragment_entry["launches"] = fg["launches"]["blit"]
    kernels += [medians_entry] + cc_entries + [fragment_entry]
    n_frames = BATCH * N_BATCHES
    total_ms = sum(fg["batch_ms"])
    log(f"foreground path: {n_frames} frames, matched "
        f"{fg['matched']:.2%}, {fg['fragments']} fragment(s); launches "
        f"{fg['launches']}; {fg['visible']} frames with a visible sprite, "
        "every one masked; conflicting canvas px "
        f"{fg['conflicts'][0]} -> {fg['conflicts'][1]}")
    pass_ms = fg["pass_ms"] / fg["batches"]
    log("foreground extract_batch ms per 256-frame batch: "
        + ", ".join(f"{t:.3f}" for t in fg["batch_ms"])
        + f" (median {statistics.median(fg['batch_ms']):.3f}; "
        f"{n_frames / (total_ms / 1000.0):.1f} frames/s); whole "
        f"filter_fragments {fg['pass_ms']:.3f} ms = {pass_ms:.3f} ms per "
        f"batch ({BATCH / (pass_ms / 1000.0):.1f} frames/s); chain wall "
        f"{fg['wall_s']:.3f} s (stream + blit pass + foreground, "
        f"{n_frames / fg['wall_s']:.1f} frames/s) on {smi}")
    t0 = time.perf_counter()
    n = foreground_cpu_phase(fg)
    log(f"foreground cpu: first {BATCH} frames, {n} fragment(s), canvases "
        f"equal on CPU tensors ({time.perf_counter() - t0:.1f} s)")

    kernels += collect_phase(dev, {
        "extract": extract.extract_dense_cuda,
        "tables": tables.build_tables_cuda,
        "blit": blit.blit_frames_cuda,
        "cc_labels": cc.label_components_cuda}, smi)

    map_counters = build_counters()
    entries, maps, stages = map_phase(dev, map_counters, smi)
    kernels += entries
    grid_perf = cli_phase(dev, map_counters, smi, maps, stages)
    kernels += matcher_phase(dev, map_counters, smi, grid_perf)
    kernels += multi_device_phase(dev, map_counters, maps, smi)
    kernels += spec_motion_phase(dev, map_counters, frames, smi)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
