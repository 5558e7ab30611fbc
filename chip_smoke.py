#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (remap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. build: compiles remap_tpu_torch/csrc/*.cu with nvcc (sm_90a).
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, with exact equality (every output is an integer), timed
   with CUDA events beside the plain version (queued behind a spin
   kernel, so the host's launch cost does not show):
   extract (K1) and its medians-only instantiation at NES
   [256, 240, 256] and C64 [64, 312, 388], tables (K2) at NES / capacity
   640 on K1's output and on a dense plane that overflows.
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

The line before the last is a JSON object of the kernels: for each, its
launches on the main path that runs it, its largest difference from the
plain version, its time, the plain version's, its bound (the bytes it must
move, each input read once and each output written once, over the
H100's 3.35 TB/s; every kernel here is integer work below that line;
K3's: the frames, its vote plane if any, and the bins that take a vote
read and written, as it updates the canvas in place; the frames' box of
16 bins in and out and the old design's whole canvas are logged beside
it), share = bound / time, and library_ms: for
K3 (blit, and blit_fragment, the same kernel on the fragment canvas) one
index_put_(accumulate=True) of the votes on precomputed bins, null for
the others, since no single PyTorch call computes them.  The last line
is {"ok": true,
"device": {...}}.  Without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
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
    bound2 = bound_ms((dense.weight, dense.codes), got2)
    plain2 = time_ms(lambda: tables.build_tables_plain(
        dense.weight, dense.codes, nes, CAPACITY), 3)
    log(f"tables NES cap {CAPACITY}: equal (exact, tolerance 0; dense "
        f"plane overflows); kernel {ms2:.4f} ms, plain {plain2:.4f} ms, "
        f"bound {bound2:.4f} ms")

    return [
        kernel_entry("extract", "remap_tpu/ops/pallas/extract.py:215",
                     "extract.cu", err1, ms1, plain1, bound1),
        kernel_entry("tables", "remap_tpu/ops/pallas/tables.py:189",
                     "tables.cu", err2, ms2, plain2, bound2),
    ], kernel_entry("extract_medians", "remap_tpu/ops/pallas/extract.py:215",
                    "extract.cu", err_m, ms_m, plain_m, bound_m)


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
        # the accumulation alone, given the bins (their computation is
        # excluded): one index_put_ with accumulate=True
        _, ahp, awp = dots.shape
        p64 = pos.to(torch.int64)
        ys = p64[:, 1, None, None] + torch.arange(H, device=dev)[None, :, None]
        xs = p64[:, 0, None, None] + torch.arange(W, device=dev)[None, None, :]
        colour = images.to(torch.int64)
        ok = colour < blit.DEPTH
        if vote is not None:
            ok &= (vote != 0) if polarity == "nonzero" else (vote == 0)
        bins = (colour * (ahp * awp) + ys * awp + xs)[ok]
        ones = torch.ones_like(bins, dtype=torch.int32)
        flat = canvas.view(-1)
        library = time_ms(lambda: flat.index_put_((bins,), ones,
                                                  accumulate=True), 50)
        x_lo, y_lo, x_hi, y_hi = box
        read = images.numel() + (0 if vote is None else vote.numel())
        voted = int(torch.unique(bins).numel())
        bound = (read + 2 * 4 * voted) / HBM_BYTES_PER_S * 1e3
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
