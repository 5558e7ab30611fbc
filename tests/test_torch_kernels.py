"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, exact (every output is an integer).

Every test here needs a CUDA card and skips without one.  The module
imports no JAX, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX).  The plain versions
are held against the JAX package by the other tests/test_torch_*.py."""

import numpy as np
import pytest
import torch

from remap_tpu.config import PipelineConfig
from remap_tpu.core.regions import make_layout
from remap_tpu.utils import testing
from remap_tpu_torch.ops import cc as tcc
from remap_tpu_torch.ops import fde as tfde
from remap_tpu_torch.ops import kpe as tkpe
from remap_tpu_torch.ops import tables as ttab
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.ops.kernels import cc as kcc
from remap_tpu_torch.ops.kernels import extract as kext
from remap_tpu_torch.ops.kernels import tables as ktab
from remap_tpu_torch.parallel import sharded as tsharded

from torch_parity import cuda_device, to_torch  # noqa: F401 (fixtures)

pytestmark = pytest.mark.cuda

NES = (240, 256)
C64 = (312, 388)


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


def test_tables_kernel_matches_plain(cuda_device):
    """K2 equals the plain version at NES, capacity 640, on extracted
    keypoints and on a dense plane that overflows."""
    h, w = NES
    capacity = 640
    layout = make_layout(w, h, 4, 2, 16)
    dense = tkpe.extract_dense(_random_frames(cuda_device, 8, h, w), layout)
    rng = np.random.default_rng(15)
    heavy = torch.as_tensor(rng.integers(1, 3, (8, h, w), dtype=np.uint8),
                            device=cuda_device)
    heavy_codes = torch.as_tensor(
        rng.integers(-(1 << 31), 1 << 31, (8, h, w, 4), dtype=np.int32),
        device=cuda_device)
    for wgt, cod in [(dense.weight, dense.codes), (heavy, heavy_codes)]:
        got = ttab.build_tables(wgt, cod, layout, capacity)
        want = ttab.build_tables_plain(wgt, cod, layout, capacity)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool(got.overflow.all())


def test_blit_kernel_matches_plain(cuda_device):
    """K3 equals the plain blit at the streaming shapes (256 NES frames
    into the 496x512 window), onto votes near the uint16 wrap."""
    rng = np.random.default_rng(3)
    f, (h, w), ah, aw = 256, NES, 496, 512
    frames = _random_frames(cuda_device, f, h, w, seed=4)
    ok = to_torch((rng.random((f, h, w)) < 0.9).astype(np.uint8), cuda_device)
    pos = to_torch(np.stack([rng.integers(0, aw - w + 1, f),
                             rng.integers(0, ah - h + 1, f)],
                            -1).astype(np.int32), cuda_device)
    dots = to_torch(rng.integers(65400, 65536, (16,) + kblit.padded_dims(
        ah, aw)).astype(np.int32), cuda_device)
    got = kblit.blit_frames(frames, ok, pos, ah, aw, dots=dots)
    want = kblit.blit_frames_plain(frames, ok, pos, ah, aw, dots=dots)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got < dots).any())   # some counters wrapped


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
    values 0..2, an all-equal plane, full-height stripes, a spiral of
    long bars, a 1-px snake; widths off multiples of 32; frames past
    2^16 pixels."""
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
        "c64": rng.integers(0, 3, (4, 312, 388), dtype=np.uint8),
        "tall": np.stack([spiral(1080, 1920, 6), stripes(1080, 1920),
                          snake(1080, 1920),
                          np.zeros((1080, 1920), np.uint8)]),
        "tiny": rng.integers(0, 2, (5, 4, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("case", ["noise", "c64", "tall", "tiny"])
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
    """extract_batch on the card (K1, K4) equals the CPU plain path and
    never waits for the card."""
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
