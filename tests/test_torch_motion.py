"""Port motion detector (remap_tpu_torch.ops.motion) vs the JAX package's
``remap_tpu.ops.motion``, exact (tolerance 0): edge flags, and
``detect``'s per-label offset, moving flag and votes, on the scenes of
tests/test_motion.py, seeded sprite scenes, gameplay frame pairs, every
window half-width and adjustments past the clip of +-(half + 64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.ops import cc as jcc
from remap_tpu.ops import motion as jmotion
from remap_tpu_torch.ops import motion as tmotion
from remap_tpu_torch.utils import gameplay

torch.set_num_threads(2)


def _scene(sprite_xy):
    """tests/test_motion.py's scene: a background, a 6x6 sprite, a static
    object."""
    img = np.zeros((40, 60), np.uint8)
    img[4:36, 4:56] = 1
    sx, sy = sprite_xy
    img[sy:sy + 6, sx:sx + 6] = 9
    img[20:26, 40:46] = 5
    return img


def _detect_both(prev, curr, adjustment, half):
    """The port on CPU tensors against JAX; returns the port's result."""
    want = jmotion.detect(jnp.asarray(prev), jnp.asarray(curr),
                          jnp.asarray(np.asarray(adjustment, np.int32)),
                          half=half)
    got = tmotion.detect(torch.as_tensor(prev), torch.as_tensor(curr),
                         adjustment, half=half)
    assert got.offset.dtype == torch.int32 and got.votes.dtype == torch.int32
    assert got.offset.shape == (curr.size, 2)
    for name in ("offset", "moving", "votes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got


def _scene_case(case):
    """(prev, curr, adjustment, half) of tests/test_motion.py's three
    scenes."""
    if case == "moving_sprite":
        return _scene((10, 10)), _scene((13, 12)), (0, 0), 4
    if case == "no_change":
        img = _scene((10, 10))
        return img, img.copy(), (0, 0), 3
    base = _scene((10, 10))
    return base, np.roll(base, (-3, -5), axis=(0, 1)), (5, 3), 3


@pytest.mark.parametrize("case", ["moving_sprite", "no_change",
                                  "adjustment"])
def test_detect_scenes_match_jax(case):
    prev, curr, adjustment, half = _scene_case(case)
    got = _detect_both(prev, curr, adjustment, half)
    labels = np.asarray(jcc.label_components(jnp.asarray(curr))).reshape(-1)
    if case == "moving_sprite":
        sprite = int(labels[14 * 60 + 15])
        assert bool(got.moving[sprite])
        assert got.offset[sprite].tolist() == [3, 2]
        assert not bool(got.moving[int(labels[22 * 60 + 42])])
    elif case == "no_change":
        assert not bool(got.moving.any())
    else:
        assert not bool(got.moving[int(labels[19 * 60 + 37])])


def _sprite_pair(rng, h=48, w=64, sprites=4):
    """A tiled background with ``sprites`` solid sprites, each moved by up
    to 3 px between the two frames, on a camera that moved by a random
    step."""
    tiles = rng.integers(0, 16, (h // 8 + 2, w // 8 + 2), dtype=np.uint8)
    world = np.kron(tiles, np.ones((8, 8), np.uint8))
    cam = rng.integers(-3, 4, 2)
    prev = world[8:8 + h, 8:8 + w].copy()
    curr = world[8 + cam[1]:8 + cam[1] + h, 8 + cam[0]:8 + cam[0] + w].copy()
    for _ in range(sprites):
        size = int(rng.integers(3, 8))
        x, y = rng.integers(4, w - 14), rng.integers(4, h - 14)
        dx, dy = rng.integers(-3, 4, 2)
        colour = int(rng.integers(0, 16))
        prev[y:y + size, x:x + size] = colour
        curr[y + dy:y + dy + size, x + dx:x + dx + size] = colour
    return prev, curr, (int(cam[0]), int(cam[1]))


@pytest.mark.parametrize("half", [2, 3, 4])
@pytest.mark.parametrize("seed", [1, 2])
def test_detect_sprite_scenes_match_jax(half, seed):
    """Seeded sprite scenes at each window half-width, with the camera's
    step as the adjustment, with none, and with one past the clip of
    +-(half + 64) on both axes (prev then reads the -1 pad alone)."""
    rng = np.random.default_rng(100 * half + seed)
    prev, curr, cam = _sprite_pair(rng)
    moved = _detect_both(prev, curr, cam, half)
    assert int(moved.votes.max()) > 0
    _detect_both(prev, curr, (0, 0), half)
    far = half + 64 + 7
    clipped = _detect_both(prev, curr, (far, -far), half)
    assert not bool(clipped.moving.any())


@pytest.mark.parametrize("seed", [3, 8])
def test_detect_gameplay_pairs_match_jax(seed):
    """Consecutive frames of a platformer session at 120x160 (scrolling
    tiles, animated enemies, a HUD), adjusted by the camera's step."""
    session = gameplay.play_session(seed=seed, n_frames=19,
                                    frame_hw=(120, 160))
    steps = []
    for t in range(14, len(session.frames)):
        (x0, y0), (x1, y1) = session.camera[t - 1], session.camera[t]
        steps.append((x1 - x0, y1 - y0))
        _detect_both(session.frames[t - 1], session.frames[t], steps[-1], 4)
    assert {(0, -2), (3, -2)} <= set(steps)   # the camera climbs and runs


def test_edge_flags_match_jax():
    rng = np.random.default_rng(9)
    for h, w in ((3, 3), (17, 23), (40, 60)):
        img = rng.integers(0, 4, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(
            tmotion.edge_flags(torch.as_tensor(img)).numpy(),
            np.asarray(jmotion.edge_flags(jnp.asarray(img))))


def test_detect_needs_cuda_unless_asked_for_cpu():
    """Arrays run on ``device``: CUDA when none is named, which raises
    without CUDA; the CPU only when named."""
    prev, curr, adjustment, half = _scene_case("moving_sprite")
    got = tmotion.detect(prev, curr, adjustment, half=half, device="cpu")
    assert got.moving.device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tmotion.detect(prev, curr, adjustment, half=half)
