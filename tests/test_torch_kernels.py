"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, exact (every output is an integer).

Every test here needs a CUDA card and skips without one.  The module
imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX).  The plain versions
are held against the JAX package by the other tests/test_torch_*.py."""

import ctypes

import numpy as np
import pytest
import torch

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.utils import clips as testing
from remap_tpu_torch.ops import cc as tcc
from remap_tpu_torch.ops import correlate as tcorrelate
from remap_tpu_torch.ops import fde as tfde
from remap_tpu_torch.ops import kpe as tkpe
from remap_tpu_torch.ops import motion as tmotion
from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops import tables as ttab
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.ops.kernels import cc as kcc
from remap_tpu_torch.ops.kernels import correlate as kcorrelate
from remap_tpu_torch.ops.kernels import extract as kext
from remap_tpu_torch.ops.kernels import tables as ktab
from remap_tpu_torch.parallel import sharded as tsharded

from torch_parity import cuda_device, to_torch  # noqa: F401 (fixtures)

pytestmark = pytest.mark.cuda

NES = (240, 256)
C64 = (312, 388)
#: a VGA frame less the benchmark session's 32-row HUD and 8-px border
VGA_CROPPED = (440, 624)


def _random_frames(device, b, h, w, seed=7):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 16, (b, h, w), dtype=np.uint8),
                           device=device)


@pytest.mark.parametrize("hw", [NES, C64])
def test_extract_kernel_matches_plain(cuda_device, hw):
    """K1 equals the plain version at NES and at C64, the size the TPU
    kernel had to split into row bands."""
    h, w = hw
    layout = make_layout(w, h, 4, 2, 16)
    images = _random_frames(cuda_device, 8, h, w)
    before = kext.extract_dense_cuda.launches
    got = tkpe.extract_dense(images, layout)
    want = tkpe.extract_dense_plain(images, layout)
    torch.cuda.synchronize()
    assert kext.extract_dense_cuda.launches == before + 1
    for name in ("median", "weight", "codes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("hw", [NES, C64, (61, 37)])
def test_extract_medians_kernel_matches_full(cuda_device, hw):
    """K1's medians-only instantiation equals the full kernel's median
    and the plain version's, at NES, C64 and an odd size."""
    h, w = hw
    layout = make_layout(w, h, 4, 2, 16)
    images = _random_frames(cuda_device, 8, h, w, seed=9)
    before = kext.extract_medians_cuda.launches
    got = tkpe.extract_medians(images, layout)
    full = tkpe.extract_dense(images, layout).median
    want = tkpe.extract_dense_plain(images, layout).median
    torch.cuda.synchronize()
    assert kext.extract_medians_cuda.launches == before + 1
    assert torch.equal(got, full)
    assert torch.equal(got, want)


def _keypoints_at(rng, b, h, w, where, device):
    """A weight plane with keypoints (weight 1 or 2) at the flat pixel
    indices ``where`` of every frame, and random codes."""
    weight = np.zeros((b, h * w), np.uint8)
    weight[:, where] = rng.integers(1, 3, (b, len(where)))
    codes = rng.integers(-(1 << 31), 1 << 31, (b, h, w, 4), dtype=np.int32)
    return (torch.as_tensor(weight.reshape(b, h, w), device=device),
            torch.as_tensor(codes, device=device))


def _tiles(spans):
    """The kernel's tile count for a layout: those of its largest region."""
    flat = (ctypes.c_int32 * (4 * len(spans)))(*(v for s in spans for v in s))
    return _build.library().remap_tables_tiles(ctypes.addressof(flat),
                                               len(spans))


def _tables_case(case, device):
    """(weight, codes, layout, capacity) of a K2 case."""
    rng = np.random.default_rng(15)
    if case.startswith("nes"):       # K1's keypoints at NES, capacity 640
        h, w = NES
        layout = make_layout(w, h, 4, 2, 16)
        dense = tkpe.extract_dense(
            _random_frames(device, int(case[3:]), h, w), layout)
        return dense.weight, dense.codes, layout, 640
    if case.startswith("cropped"):   # the collect batch's cropped C64 frames
        frames, capacity = (int(v) for v in case[7:].split("_"))
        h, w = 289, 377
        world = testing.make_world(h + 64, w + 64, rng)
        ys, xs = rng.integers(0, 65, (2, frames))
        images = np.stack([world[y:y + h, x:x + w] for y, x in zip(ys, xs)])
        cfg = PipelineConfig()
        layout = make_layout(w, h, cfg.grid_width, cfg.grid_height,
                             cfg.grid_overlap)
        dense = tkpe.extract_dense(torch.as_tensor(images, device=device),
                                   layout)
        return dense.weight, dense.codes, layout, capacity
    if case == "small_regions":      # every region under one tile
        h, w = 64, 96
        layout = make_layout(w, h, 4, 2, 16)
        weight = (rng.random((4, h, w)) < 0.4) * rng.integers(1, 3, (4, h, w))
        codes = rng.integers(-(1 << 31), 1 << 31, (4, h, w, 4), dtype=np.int32)
        return (torch.as_tensor(weight.astype(np.uint8), device=device),
                torch.as_tensor(codes, device=device), layout, 300)
    if case == "tile_boundary":      # keypoint K the first tile's last
        h, w = 100, 96               # pixel, keypoint K + 1 the next's first
        layout = make_layout(w, h, 1, 1, 0)
        x_lo, x_hi, y_lo, y_hi = ttab.region_spans(layout)[0]
        rw, capacity = x_hi - x_lo, 300
        # csrc/tables.cu's tiling: a tile is 256 16-byte-aligned words, a
        # row of rw bytes spans (rw + 30) // 16 of them
        tile_words, per_row = 256, (rw + 30) // 16
        assert _tiles([(0, 1, 0, tile_words)]) == 1
        assert _tiles([(0, 1, 0, tile_words + 1)]) == 2
        assert _tiles([(x_lo, x_hi, y_lo, y_hi)]) == -(
            -(y_hi - y_lo) * per_row // tile_words)
        # the second tile starts at word k of region row `row`; rows of 96
        # bytes keep every frame's words at the same columns
        row, k = divmod(tile_words, per_row)
        start = (y_lo + row) * w + x_lo
        tile = row * rw + (start // 16 + k) * 16 - start
        assert 0 < tile - row * rw < rw
        ranks = np.sort(rng.choice(tile - 1, capacity - 1, replace=False))
        region_px = np.concatenate([ranks, [tile - 1, tile, tile + 7]])
        flat = (y_lo + region_px // rw) * w + x_lo + region_px % rw
        return (*_keypoints_at(rng, 2, h, w, flat, device), layout, capacity)
    if case == "count_is_capacity":  # frame 0 holds exactly K keypoints
        h, w = 200, 300
        layout = make_layout(w, h, 1, 1, 0)
        weight = (rng.random((2, h, w)) < 0.3) * rng.integers(1, 3, (2, h, w))
        codes = rng.integers(-(1 << 31), 1 << 31, (2, h, w, 4), dtype=np.int32)
        weight = torch.as_tensor(weight.astype(np.uint8), device=device)
        capacity = int((ttab.build_tables_plain(
            weight[:1], torch.as_tensor(codes[:1], device=device), layout,
            1).wcounts[0, 0, 1:]).sum())
        return weight, torch.as_tensor(codes, device=device), layout, capacity
    assert case == "dense"           # every pixel a keypoint: overflows
    h, w = NES
    weight = rng.integers(1, 3, (8, h, w), dtype=np.uint8)
    codes = rng.integers(-(1 << 31), 1 << 31, (8, h, w, 4), dtype=np.int32)
    return (torch.as_tensor(weight, device=device),
            torch.as_tensor(codes, device=device),
            make_layout(w, h, 4, 2, 16), 640)


@pytest.mark.parametrize("case", [
    "nes2", "nes8", "nes32", "cropped2_512", "cropped2_16384",
    "cropped17_512", "cropped17_16384", "small_regions", "tile_boundary",
    "count_is_capacity", "dense"])
def test_tables_kernel_matches_plain(cuda_device, case):
    """K2 equals the plain version on every row at the main path's shapes
    and at the tiling's edges: NES at capacity 640 on 2, 8 and 32 frames
    of K1's keypoints; cropped C64 [2 and 17, 289, 377] at 512 and 16384;
    regions under one tile; keypoint K on a tile's last pixel and K + 1 on
    the next tile's first; a region holding exactly K keypoints; a plane
    of keypoints that overflows every region."""
    weight, codes, layout, capacity = _tables_case(case, cuda_device)
    before = ktab.build_tables_cuda.launches
    got = ttab.RegionTables(*ktab.build_tables_cuda(
        weight, codes, ttab.region_spans(layout), capacity))
    want = ttab.build_tables_plain(weight, codes, layout, capacity)
    torch.cuda.synchronize()
    assert ktab.build_tables_cuda.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if case == "dense":
        assert bool(want.overflow.all())
    elif case == "tile_boundary":
        assert want.valid[:, 0].sum(1).tolist() == [capacity] * 2
        assert want.overflow.all() and (want.wcounts[:, 0, 1:].sum(1)
                                        == capacity + 2).all()
    elif case == "count_is_capacity":
        assert bool(want.valid[0].all()) and not bool(want.overflow[0].any())


def test_splice_shape_kernels_match_plain(cuda_device):
    """K1 on one [1, 1024, 1536] canvas under the 1x1 layout (a world
    image with an empty band, as splice pads a blended canvas), and K2 on
    its interior-masked weights at a capacity above the keypoint count
    (one region of ~1.2M pixels: hundreds of tiles)."""
    hb, wb = 1024, 1536
    rng = np.random.default_rng(19)
    world = testing.make_world(hb, wb, rng)
    world[900:, :] = 0
    world[:, 1300:] = 0
    images = torch.as_tensor(world[None], device=cuda_device)
    layout = make_layout(wb, hb, 1, 1, 0)
    got = tkpe.extract_dense(images, layout)
    want = tkpe.extract_dense_plain(images, layout)
    for name in ("median", "weight", "codes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    interior = torch.zeros((hb, wb), dtype=torch.uint8, device=cuda_device)
    interior[2:900 - 4, 2:1300 - 2] = 1
    weight = got.weight * interior
    total = int((weight > 0).sum())
    capacity = 2048
    while capacity < total:
        capacity *= 4
    before = ktab.build_tables_cuda.launches
    tabs = ttab.RegionTables(*ktab.build_tables_cuda(
        weight, got.codes, ttab.region_spans(layout), capacity))
    plain = ttab.build_tables_plain(weight, got.codes, layout, capacity)
    torch.cuda.synchronize()
    assert ktab.build_tables_cuda.launches == before + 1
    for a, b in zip(tabs, plain):
        assert torch.equal(a, b)
    assert int(tabs.valid.sum()) == total and not bool(tabs.overflow.any())


def _walk(rng, f, lo, hi):
    """``f`` clustered positions: a +-3 px walk (the bench clip's camera)
    from the middle of ``[lo, hi]`` per axis, clipped to it."""
    steps = rng.integers(-3, 4, (f, 2))
    steps[0] = 0
    mid = (np.asarray(lo) + np.asarray(hi)) // 2
    return np.clip(mid + np.cumsum(steps, 0), lo, hi).astype(np.int32)


def _blit_case(case, device):
    """(frames, vote plane or None, polarity, positions, dots) of a K3
    case; dots near the uint16 wrap."""
    rng = np.random.default_rng(3)
    f, (h, w), (ah, aw) = 256, NES, (496, 512)
    if case == "one_frame":
        f = 1
    elif case == "ragged":
        f = 37          # no multiple of the kernel's 8-frame unroll
    elif case == "chunks":
        f = 1500        # more than one 1024-frame pass per block
    elif case == "fragment":
        ah, aw = 1992, 3584
    ahp, awp = kblit.padded_dims(ah, aw)
    frames = _random_frames(device, f, h, w, seed=4)
    if case in ("random", "polarity_zero", "no_plane", "one_frame"):
        pos = np.stack([rng.integers(0, aw - w + 1, f),
                        rng.integers(0, ah - h + 1, f)], -1)
    elif case == "repeated":
        pos = np.repeat(_walk(rng, 8, (0, 0), (aw - w, ah - h)), 32, axis=0)
    elif case == "fragment":
        pos = _walk(rng, f, (0, 0), (awp - w, ahp - h))
    else:
        pos = _walk(rng, f, (0, 0), (aw - w, ah - h))
    ok = to_torch((rng.random((f, h, w)) < 0.9).astype(np.uint8), device)
    plane, polarity = ok, "nonzero"
    if case == "polarity_zero":
        polarity = "zero"
    elif case == "no_plane":
        plane = None
    gen = torch.Generator(device=device).manual_seed(5)
    dots = torch.randint(65400, 65536, (16, ahp, awp), generator=gen,
                         dtype=torch.int32, device=device)
    pos = to_torch(pos.astype(np.int32), device)
    return frames, plane, polarity, pos, dots


@pytest.mark.parametrize("case", ["random", "clustered", "polarity_zero",
                                  "no_plane", "one_frame", "ragged",
                                  "chunks", "repeated", "fragment"])
def test_blit_kernel_matches_plain(cuda_device, case):
    """K3 in place equals the plain in-place blit at the streaming shapes
    (NES frames into the 496x512 window) with random and clustered
    positions, for each vote polarity and no plane, for 1, 37 and 1500
    frames, repeated positions, and on a 1992x3584 fragment canvas
    ([16, 2008, 3840]); onto votes near the uint16 wrap, with the grid
    over the whole canvas and over the frames' box alike."""
    frames, plane, polarity, pos, dots = _blit_case(case, cuda_device)
    _, h, w = frames.shape
    want = kblit.blit_frames_plain_(frames, pos, dots.clone(), vote=plane,
                                    vote_polarity=polarity)
    box = kblit.frames_box(pos.cpu().numpy(), h, w)
    for hint in (None, box):
        before = kblit.blit_frames_cuda.launches
        got = dots.clone()
        torch.cuda.set_sync_debug_mode("error")   # no host sync
        try:
            kblit.blit_frames_(frames, pos, got, vote=plane,
                               vote_polarity=polarity, box=hint)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert kblit.blit_frames_cuda.launches == before + 1
        assert torch.equal(got, want), hint
    assert bool((want < dots).any())   # some counters wrapped


def test_blit_kernel_odd_widths_and_offsets(cuda_device):
    """K3's byte-wise path: frames 37 px wide, and frames whose storage
    starts at an odd address, equal the plain version."""
    rng = np.random.default_rng(6)
    f, h, w = 9, 20, 37
    raw = torch.as_tensor(rng.integers(0, 16, f * h * w + 1, dtype=np.uint8),
                          device=cuda_device)
    pos = to_torch(rng.integers(0, 60, (f, 2)).astype(np.int32), cuda_device)
    vote = to_torch((rng.random((f, h, w)) < 0.7).astype(np.uint8),
                    cuda_device)
    for frames in (raw[:-1].view(f, h, w), raw[1:].view(f, h, w)):
        dots = torch.zeros((16,) + kblit.padded_dims(90, 100),
                           dtype=torch.int32, device=cuda_device)
        want = kblit.blit_frames_plain_(frames, pos, dots.clone(), vote=vote)
        kblit.blit_frames_(frames, pos, dots, vote=vote)
        torch.cuda.synchronize()
        assert torch.equal(dots, want)


def test_blit_kernel_keeps_bits_outside_the_votes(cuda_device):
    """Bins that take no vote keep their bits, even values no vote add
    could leave; the functional form leaves its input as it was."""
    rng = np.random.default_rng(8)
    f, (h, w) = 16, NES
    frames = _random_frames(cuda_device, f, h, w, seed=9)
    pos = to_torch(_walk(rng, f, (0, 0), (256, 256)), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    dots = torch.randint(-(1 << 31), (1 << 31) - 1,
                         (16,) + kblit.padded_dims(496, 512), generator=gen,
                         dtype=torch.int32, device=cuda_device)
    start = dots.clone()
    got = kblit.blit_frames(frames, None, pos, 496, 512, dots=dots)
    want = kblit.blit_frames_plain_(frames, pos, start.clone())
    torch.cuda.synchronize()
    assert torch.equal(dots, start)
    assert torch.equal(got, want)


def test_stream_cuda_matches_cpu(cuda_device):
    """The card's streaming step (all three kernels) equals the CPU step
    (all plain versions) over a clip with a mid-batch break, each kernel
    launches once per step, and the step never waits for the card."""
    cfg = PipelineConfig(screen_width=96, screen_height=64,
                         region_capacity=512, frame_batch=4,
                         join_multiplicity=1, vote_radius=16)
    layout = make_layout(96, 64, 4, 2, 16)
    clip = testing.simple_clip(n_frames=12, frame_hw=(64, 96),
                               world_hw=(160, 224), seed=31)
    frames = np.stack(clip.frames)
    frames[6] = np.random.default_rng(32).integers(0, 16, (64, 96),
                                                   dtype=np.uint8)
    wrappers = (kext.extract_dense_cuda, ktab.build_tables_cuda,
                kblit.blit_frames_cuda)
    c_init, c_step = tsharded.make_streaming_step(layout, cfg, 16, "cpu")
    g_init, g_step = tsharded.make_streaming_step(layout, cfg, 16,
                                                  cuda_device)
    c_state, g_state = c_init(), g_init()
    for i in range(0, len(frames), 4):
        batch = frames[i:i + 4]
        before = [k.launches for k in wrappers]
        c_out = c_step(to_torch(batch), c_state)
        g_batch = to_torch(batch, cuda_device)
        torch.cuda.set_sync_debug_mode("error")   # no host sync in step
        try:
            g_out = g_step(g_batch, g_state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [k.launches - b for k, b in zip(wrappers, before)] == [1, 1, 1]
        c_state, g_state = c_out[-1], g_out[-1]
        for a, b in zip(c_out[:2], g_out[:2]):
            assert torch.equal(a, b.cpu())
        for name in ("dots", "position", "anchor"):
            assert torch.equal(getattr(c_state, name),
                               getattr(g_state, name).cpu()), name


def _cc_cases(rng):
    """Adversarial contents for the union-find labeller: iid noise of
    values 0..2 and of 16 colours, an all-equal plane, full-height
    stripes, a spiral of long bars, a 1-px snake; widths off multiples of
    32; frames past 2^16 pixels."""
    def spiral(h, w, step):
        img = np.zeros((h, w), np.uint8)
        img[::step, :] = 1
        for i, r in enumerate(range(0, h, step)):
            img[r, -2 if i % 2 == 0 else 1] = 0
        return img

    def snake(h, w):
        img = np.zeros((h, w), np.uint8)
        for i, r in enumerate(range(1, h - 2, 2)):
            img[r, 1:w - 1] = 1
            if r + 1 < h - 2:
                img[r + 1, (w - 2) if i % 2 == 0 else 1] = 1
        return img

    def stripes(h, w):
        cols = np.repeat(rng.integers(0, 4, w // 8 + 1).astype(np.uint8), 8)
        return np.tile(cols[None, :w], (h, 1))

    return {
        "noise": rng.integers(0, 3, (8, 272, 372), dtype=np.uint8),
        # iid 16-colour noise at NES: the most roots
        "nes_noise": rng.integers(0, 16, (8, 240, 256), dtype=np.uint8),
        # exactly 2^16 pixels, and one row more
        "px65536": rng.integers(0, 2, (3, 256, 256), dtype=np.uint8),
        "px65792": rng.integers(0, 2, (3, 257, 256), dtype=np.uint8),
        "c64": rng.integers(0, 3, (4, 312, 388), dtype=np.uint8),
        "tall": np.stack([spiral(1080, 1920, 6), stripes(1080, 1920),
                          snake(1080, 1920),
                          np.zeros((1080, 1920), np.uint8)]),
        "tiny": rng.integers(0, 2, (5, 4, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("case", ["noise", "nes_noise", "px65536",
                                  "px65792", "c64", "tall", "tiny"])
def test_cc_kernel_matches_plain(cuda_device, case):
    """K4 labels and stats equal the plain versions on every element,
    border included, and the kernel never waits for the card."""
    rng = np.random.default_rng(44)
    images = to_torch(_cc_cases(rng)[case], cuda_device)
    changed = to_torch((rng.random(images.shape) < 0.05).astype(np.uint8),
                       cuda_device)
    before = (kcc.label_components_cuda.launches,
              kcc.label_stats_cuda.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        labels = kcc.label_components_batch(images)
        got = kcc.label_stats_batch(images, changed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (kcc.label_components_cuda.launches,
            kcc.label_stats_cuda.launches) == (before[0] + 2, before[1] + 1)
    want = tcc.label_stats(images, changed)
    torch.cuda.synchronize()
    assert torch.equal(labels, want[0])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_foreground_cuda_matches_cpu(cuda_device):
    """extract_batch on the card (K1 medians-only, K4) equals the CPU plain
    path and never waits for the card."""
    rng = np.random.default_rng(45)
    h, w = 240, 256
    bg = rng.integers(0, 16, (h + 40, w + 40), dtype=np.uint8)
    pos = np.stack([rng.integers(0, 40, 16), rng.integers(0, 40, 16)],
                   -1).astype(np.int32)
    frames = np.stack([bg[y:y + h, x:x + w] for x, y in pos])
    for f in frames:
        y, x = rng.integers(8, h - 20, 2)
        f[y:y + 12, x:x + 12] = rng.integers(0, 16)
    args = [to_torch(a, cuda_device) for a in (bg, frames)]
    p_dev = to_torch(pos, cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tfde.extract_batch(args[0], args[1], None, p_dev,
                                 compute_medians=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = tfde.extract_batch(to_torch(bg), to_torch(frames), None,
                              to_torch(pos), compute_medians=True)
    assert torch.equal(got.cpu(), want)
    assert bool(want.any())


def test_motion_cuda_matches_cpu(cuda_device):
    """motion.detect on the card (its labels through K4a, one launch a
    detect) equals the CPU plain path at C64 on consecutive platformer
    frames, with the camera's step and with an adjustment past the
    window's clip."""
    from remap_tpu_torch.utils import gameplay

    session = gameplay.play_session(seed=3, n_frames=57, frame_hw=C64)
    for t, adjustment in ((54, None), (56, None), (56, (90, -80))):
        if adjustment is None:
            (x0, y0), (x1, y1) = session.camera[t - 1], session.camera[t]
            adjustment = (x1 - x0, y1 - y0)
        prev, curr = session.frames[t - 1], session.frames[t]
        before = kcc.label_components_cuda.launches
        got = tmotion.detect(to_torch(prev, cuda_device),
                             to_torch(curr, cuda_device), adjustment)
        assert kcc.label_components_cuda.launches == before + 1
        want = tmotion.detect(prev, curr, adjustment, device="cpu")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_sort2_tables_cuda_match_cpu(cuda_device):
    """table_mode="sort2" (torch ops, no kernel) gives the CPU's tables on
    the card, chunk-quota flags included, and never launches K2."""
    layout = make_layout(96, 64, 4, 2, 16)
    images = _random_frames(cuda_device, 4, 64, 96, seed=9)
    dense = tkpe.extract_dense(images, layout)
    before = ktab.build_tables_cuda.launches
    got = ttab.build_tables(dense.weight, dense.codes, layout, 512, "sort2")
    assert ktab.build_tables_cuda.launches == before
    want = ttab.build_tables(dense.weight.cpu(), dense.codes.cpu(), layout,
                             512, "sort2")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert bool(want.overflow.any())


def _fine_case(case, device):
    """(prev, curr, base) of a fine-level count case: world texture at
    +-6 px camera steps with coarse offsets in [-128, 128] (the first
    three 128, -128 and 0 each way); ``padded`` repeats its last pair, as
    collect pads a session's last batch."""
    b, (h, w) = {"vga128": (128, VGA_CROPPED), "one": (1, VGA_CROPPED),
                 "odd": (8, (45, 77)), "padded": (16, (61, 96))}[case]
    rng = np.random.default_rng(23)
    world = testing.make_world(h + 64, w + 64, rng)
    cams = rng.integers(6, 58, (b + 1, 2))
    cams[1:] = np.clip(cams[:-1] + rng.integers(-6, 7, (b, 2)), 0, 64)
    frames = np.stack([world[y:y + h, x:x + w] for x, y in cams])
    base = rng.integers(-128, 129, (b, 2)).astype(np.int32)
    base[:3] = [[128, -128], [-128, 128], [0, 0]][:b]
    prev, curr = frames[:-1], frames[1:]
    if case == "padded":
        prev, curr, base = (np.concatenate([a[:11], np.repeat(a[10:11], 5,
                                                                axis=0)])
                            for a in (prev, curr, base))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (prev, curr, base))


@pytest.mark.parametrize("case", ["vga128", "one", "odd", "padded"])
@pytest.mark.parametrize("radius", [1, 5, 7])
def test_fine_counts_kernel_matches_plain(cuda_device, radius, case):
    """The fine-level count kernel equals the plain version (the direct
    counts of ``curr`` rolled by ``shift_frames``) element for element:
    at the cropped VGA batch of 128 pairs, one pair, odd sizes and a
    padded batch, radii 1, 5 and 7, offsets at +-128 and 0; one launch a
    call, and ``fine_counts`` goes through it."""
    prev, curr, base = _fine_case(case, cuda_device)
    before = kcorrelate.fine_counts_cuda.launches
    got = kcorrelate.fine_counts_cuda(prev, curr, base, radius)
    want = tcorrelate.correlation_scores_direct(
        prev, tcorrelate.shift_frames(curr, base), radius)
    torch.cuda.synchronize()
    assert kcorrelate.fine_counts_cuda.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, want.to(torch.int32))
    entry = tcorrelate.fine_counts(prev, curr, base, radius)
    assert kcorrelate.fine_counts_cuda.launches == before + 2
    assert torch.equal(entry, want)


def test_fine_counts_kernel_wide_radius(cuda_device):
    """At radius 40 the halo tile and the 81x81 counts take more than the
    48 KB of shared memory a block gets by default: the launch asks for
    it, and the counts still equal the plain version's."""
    prev, curr, base = _fine_case("odd", cuda_device)
    got = kcorrelate.fine_counts_cuda(prev, curr, base, 40)
    want = tcorrelate.correlation_scores_direct(
        prev, tcorrelate.shift_frames(curr, base), 40)
    torch.cuda.synchronize()
    assert torch.equal(got, want.to(torch.int32))
