#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (remap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. build: compiles remap_tpu_torch/csrc/*.cu with nvcc (sm_90a).
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, with exact equality (every output is an integer), timed
   with CUDA events beside the plain version:
   extract (K1) at NES [256, 240, 256] and C64 [64, 312, 388], tables
   (K2) at NES / capacity 640 on K1's output and on a dense plane that
   overflows, blit (K3) at the streaming shapes onto votes near the
   uint16 wrap.
3. main path: the port's make_streaming_step at bench.py's
   configuration (NES, batches of 256, capacity 640, multiplicity 1,
   vote radius 16, atlas pad 128) on bench.make_clip frames, 12 chained
   steps recycling 4 batches, with any host sync inside a step raising.
   Every step must be flag-free and not strayed, the last must match
   100%, every kernel must have launched on every step, and every
   covered atlas pixel must hold one colour.
4. cpu: the first 4 batches again on CPU tensors (the plain versions);
   offsets, matched, flags, strayed, anchor, position and the atlas must
   equal the card's.
5. known path: a small utils.testing clip whose camera path is known;
   the card's offsets must equal the true camera deltas.
6. cc kernels: K4's labels (K4a) and labels + stats (K4c) against their
   plain versions, exact, timed beside them: NES [256, 240, 256] on K1's
   medians of the sprite clip, C64 [64, 312, 388] on values 0..2,
   gameplay [64, 272, 372] on tiles with noise, and [4, 1080, 1920]
   stripes, spiral, snake and a flat plane.
7. foreground path: bench.make_clip frames with 8 solid 12x12 sprites
   moving +-2 px a frame, 4 batches of 256: the streaming step gives
   offsets -> collect.segment_positions -> collect.blit_pass ->
   foreground.filter_fragments, counts zeroed just before the chain and
   read just after, any host sync inside extract_batch raising.  Every
   batch must launch K1, K4 and K3, every frame with a visible sprite
   must get a non-empty foreground mask, the filtered canvases must hold
   fewer pixels of conflicting colours than the unfiltered ones, and on
   the first 256 frames the card's canvases must equal the CPU's.

The line before the last is a JSON object of the kernels; the last line
is {"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero and prints no result.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls (CUDA events,
    one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over tuples of integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


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

    from remap_tpu.core.regions import make_layout
    from remap_tpu_torch.ops import kpe, tables
    from remap_tpu_torch.ops.kernels import blit

    nes = make_layout(W, H, 4, 2, 16)
    images = torch.as_tensor(frames_np[:BATCH], device=dev)

    # K1 at NES (the main path's shape) and C64 (banded on the TPU)
    got = kpe.extract_dense(images, nes)
    want = kpe.extract_dense_plain(images, nes)
    err1 = require_equal(got, want, "extract NES")
    ms1 = time_ms(lambda: kpe.extract_dense(images, nes), 20)
    plain1 = time_ms(lambda: kpe.extract_dense_plain(images, nes), 3)
    log(f"extract NES [{BATCH},{H},{W}]: equal (exact, tolerance 0); "
        f"kernel {ms1:.4f} ms, plain {plain1:.4f} ms")

    c64 = make_layout(388, 312, 4, 2, 16)
    rng = np.random.default_rng(64)
    c64_images = torch.as_tensor(
        rng.integers(0, 16, (64, 312, 388), dtype=np.uint8), device=dev)
    err1 = max(err1, require_equal(kpe.extract_dense(c64_images, c64),
                                   kpe.extract_dense_plain(c64_images, c64),
                                   "extract C64"))
    ms_c64 = time_ms(lambda: kpe.extract_dense(c64_images, c64), 20)
    plain_c64 = time_ms(lambda: kpe.extract_dense_plain(c64_images, c64), 3)
    log(f"extract C64 [64,312,388]: equal (exact, tolerance 0); "
        f"kernel {ms_c64:.4f} ms, plain {plain_c64:.4f} ms")

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
    plain2 = time_ms(lambda: tables.build_tables_plain(
        dense.weight, dense.codes, nes, CAPACITY), 3)
    log(f"tables NES cap {CAPACITY}: equal (exact, tolerance 0; dense "
        f"plane overflows); kernel {ms2:.4f} ms, plain {plain2:.4f} ms")

    # K3 at the streaming shapes, onto votes near the uint16 wrap
    ah, aw = H + 2 * ATLAS_PAD, W + 2 * ATLAS_PAD
    pos = torch.as_tensor(np.stack([
        rng.integers(0, aw - W + 1, BATCH), rng.integers(0, ah - H + 1, BATCH)
    ], -1).astype(np.int32), device=dev)
    vote_ok = torch.as_tensor(
        (rng.random((BATCH, H, W)) < 0.9).astype(np.uint8), device=dev)
    dots = torch.as_tensor(rng.integers(
        65400, 65536, (blit.DEPTH,) + blit.padded_dims(ah, aw)
    ).astype(np.int32), device=dev)
    got3 = blit.blit_frames(images, vote_ok, pos, ah, aw, dots=dots)
    err3 = require_equal((got3,), (blit.blit_frames_plain(
        images, vote_ok, pos, ah, aw, dots=dots),), "blit")
    if not bool((got3 < dots).any()):
        raise AssertionError("the blit test should wrap some counters")
    ms3 = time_ms(lambda: blit.blit_frames(images, vote_ok, pos, ah, aw,
                                           dots=dots), 20)
    plain3 = time_ms(lambda: blit.blit_frames_plain(images, vote_ok, pos, ah,
                                                    aw, dots=dots), 3)
    log(f"blit {BATCH} frames into [{ah},{aw}]: equal (exact, tolerance 0; "
        f"counters wrap); kernel {ms3:.4f} ms, plain {plain3:.4f} ms")

    return [
        {"name": "extract", "route": "cuda",
         "source": "remap_tpu_torch/csrc/extract.cu",
         "replaces": "remap_tpu/ops/pallas/extract.py:215",
         "max_abs_err": err1, "ms": ms1, "plain_ms": plain1},
        {"name": "tables", "route": "cuda",
         "source": "remap_tpu_torch/csrc/tables.cu",
         "replaces": "remap_tpu/ops/pallas/tables.py:189",
         "max_abs_err": err2, "ms": ms2, "plain_ms": plain2},
        {"name": "blit", "route": "cuda",
         "source": "remap_tpu_torch/csrc/blit.cu",
         "replaces": "remap_tpu/ops/pallas/blit.py:130",
         "max_abs_err": err3, "ms": ms3, "plain_ms": plain3},
    ]


def bench_config():
    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout

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
    return {
        "first4": [host_outputs(o) for o in outs[:N_BATCHES]],
        "launches": launches,
        "step_ms_median": statistics.median(step_ms[1:]),
        "step_ms": step_ms,
        "wall_s": wall,
        "covered_px": int((colours > 0).sum()),
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

    from remap_tpu.config import PipelineConfig
    from remap_tpu.core.regions import make_layout
    from remap_tpu.utils import testing
    from remap_tpu_torch.parallel.sharded import make_streaming_step

    cfg = PipelineConfig(screen_width=96, screen_height=64,
                         region_capacity=512, join_multiplicity=1,
                         vote_radius=16, frame_batch=4)
    layout = make_layout(96, 64, 4, 2, 16)
    clip = testing.simple_clip(n_frames=16, frame_hw=(64, 96),
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
    in, each moving +-2 px a frame (utils/testing.py render_clip)."""
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

    from remap_tpu.core.regions import make_layout
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
        "NES [256,240,256] medians": kpe.extract_dense(
            nes, make_layout(W, H, 1, 1, 0)).median,
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
        times[name] = (ms_l, plain_l, ms_s, plain_s)
        log(f"cc {name}: labels and stats equal (exact, tolerance 0, "
            f"border included); labels kernel {ms_l:.4f} ms, plain "
            f"{plain_l:.4f} ms; stats kernel {ms_s:.4f} ms, plain "
            f"{plain_s:.4f} ms")
    ms_l, plain_l, ms_s, plain_s = times["NES [256,240,256] medians"]
    return [
        {"name": "cc_labels", "route": "cuda",
         "source": "remap_tpu_torch/csrc/cc.cu",
         "replaces": "remap_tpu/ops/pallas/cc.py:168",
         "max_abs_err": err_l, "ms": ms_l, "plain_ms": plain_l},
        {"name": "cc_stats", "route": "cuda",
         "source": "remap_tpu_torch/csrc/cc.cu",
         "replaces": "remap_tpu/ops/pallas/cc.py:413",
         "max_abs_err": err_s, "ms": ms_s, "plain_ms": plain_s},
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

    # every batch: K1, K4a, K4c inside extract_batch, then one K3 blit
    names = ["extract", "tables", "blit", "cc_labels", "cc_stats"]
    k1, k3, k4a, k4c = (names.index(n) for n in
                        ("extract", "blit", "cc_labels", "cc_stats"))
    for i, (before, after, *_rest) in enumerate(calls):
        d = [a - b for a, b in zip(after, before)]
        if (d[k1], d[k4a], d[k4c]) != (1, 1, 1):
            raise AssertionError(f"foreground batch {i}: launches {d}")
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
    from bench import make_clip
    from remap_tpu_torch.ops import _build
    from remap_tpu_torch.ops.kernels import blit, cc, extract, tables

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
    kernels = kernel_phase(dev, frames)

    counters = [extract.extract_dense_cuda, tables.build_tables_cuda,
                blit.blit_frames_cuda]
    main = main_path_phase(dev, frames, counters)
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

    t0 = time.perf_counter()
    cpu_phase(frames, main["first4"])
    log(f"cpu: first {N_BATCHES} batches equal on CPU tensors "
        f"({time.perf_counter() - t0:.1f} s)")

    known_path_phase(dev)
    log("known path: offsets equal the true camera deltas")

    sprites = sprite_clip(frames)
    cc_entries = cc_kernel_phase(dev, sprites)
    fg_counters = counters + [cc.label_components_cuda, cc.label_stats_cuda]
    fg = foreground_phase(dev, sprites, frames, fg_counters)
    for k in cc_entries:
        k["launches"] = fg["launches"][k["name"]]
    kernels += cc_entries
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
