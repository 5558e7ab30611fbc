"""Port foreground masks (remap_tpu_torch.ops.fde) vs the JAX package,
exact: ``extract_batch`` against both JAX routes (XLA, and the Pallas
stats kernel in interpret mode), and the port's one mask assembly against
every JAX assembly route on the same labels, including both tiers of the
JAX ``_ROOT_CAP`` escalation."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.ops import fde as jfde
from remap_tpu_torch.ops import cc as tcc
from remap_tpu_torch.ops import fde as tfde

from torch_parity import interpret_pallas, to_numpy, to_torch  # noqa: F401


def _sprite_frames(seed, n=6, h=40, w=56):
    """Frames cut from a background at random positions, with a small
    solid sprite painted into each (tests/test_pallas.py's fde case)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 16, (h + 20, w + 20), dtype=np.uint8)
    pos = np.stack([rng.integers(0, 20, n), rng.integers(0, 20, n)],
                   -1).astype(np.int32)
    frames = np.stack([bg[p[1]:p[1] + h, p[0]:p[0] + w].copy() for p in pos])
    for f in frames:
        y, x = rng.integers(5, h - 9), rng.integers(5, w - 9)
        f[y:y + 4, x:x + 4] = rng.integers(0, 16)
    return bg, frames, pos


def test_equality_mask_matches_jax():
    bg, frames, pos = _sprite_frames(3)
    pos[0] = (30, 25)      # past the edge: the start clamps as in JAX
    want = np.stack([np.asarray(jfde.equality_mask(
        jnp.asarray(bg), jnp.asarray(f), jnp.asarray(p)))
        for f, p in zip(frames, pos)])
    got = tfde.equality_mask(to_torch(bg), to_torch(frames), to_torch(pos))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_seg_cummax_matches_jax():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 9, (3, 50)).astype(np.int32)
    seg = np.sort(rng.integers(0, 7, (3, 50)), axis=1).astype(np.int32)
    want = np.asarray(jfde._seg_cummax(jnp.asarray(vals), jnp.asarray(seg), 9))
    got = tfde.seg_cummax(to_torch(vals), to_torch(seg), 9)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("compute_medians", [True, False])
def test_extract_batch_matches_jax_xla(compute_medians):
    bg, frames, pos = _sprite_frames(21)
    meds = None
    if not compute_medians:
        from remap_tpu.core.regions import make_layout
        from remap_tpu.ops import kpe as jkpe

        meds = np.asarray(jkpe.extract_dense(
            jnp.asarray(frames), make_layout(56, 40, 1, 1, 0)).median)
    want = jfde.extract_batch(
        jnp.asarray(bg), jnp.asarray(frames),
        None if meds is None else jnp.asarray(meds), jnp.asarray(pos),
        compute_medians=compute_medians, use_pallas=False)
    got = tfde.extract_batch(
        to_torch(bg), to_torch(frames),
        None if meds is None else to_torch(meds), to_torch(pos),
        compute_medians=compute_medians)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert to_numpy(got).any()


def test_extract_batch_matches_jax_pallas(interpret_pallas):
    """The JAX route through the Pallas stats kernel (K4c) and
    ``_masks_from_stats_sorted``."""
    from remap_tpu.ops.pallas import cc as pcc

    bg, frames, pos = _sprite_frames(22)
    assert pcc.supports_stats(40, 56)
    want = jfde.extract_batch(jnp.asarray(bg), jnp.asarray(frames), None,
                              jnp.asarray(pos), compute_medians=True,
                              use_pallas=True)
    got = tfde.extract_batch(to_torch(bg), to_torch(frames), None,
                             to_torch(pos), compute_medians=True)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _noise_batch(n_noise, n_plain=2, hw=96, seed=9):
    """Median-like planes: ``n_noise`` iid-noise frames (far more than
    ``_ROOT_CAP`` kept components each) and ``n_plain`` blocky ones."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 3, (n_noise, hw, hw)).astype(np.uint8)
    blocks = np.kron(rng.integers(0, 4, (n_plain, hw // 8, hw // 8)),
                     np.ones((1, 8, 8), np.int64)).astype(np.uint8)
    images = np.concatenate([noise, blocks])
    changed = rng.random(images.shape) < 0.6
    return images, changed


@pytest.mark.parametrize("n_noise", [1, 9], ids=["subset_tier", "full_tier"])
def test_masks_match_every_jax_route(n_noise):
    """One frame past ``_ROOT_CAP`` kept roots takes the JAX subset tier,
    more than ``_DENSE_FRAMES`` take the whole-batch dense tier; the port's
    dense fill equals both, and the labels-only and scatter routes."""
    images, changed = _noise_batch(n_noise)
    b, h, w = images.shape
    limit = h * w // 5
    labels, stats = tcc.label_stats(to_torch(images), to_torch(changed))
    got = to_numpy(tfde.masks_from_stats_sorted(labels, stats, limit))

    # the noise frames really do pass the cap
    roots = to_numpy(labels).reshape(b, -1) == np.arange(h * w)
    assert n_noise > jfde._DENSE_FRAMES or n_noise == 1
    assert (roots[:n_noise].sum(axis=1) > jfde._ROOT_CAP).all()

    lab_j, stats_j = jnp.asarray(to_numpy(labels)), jnp.asarray(
        to_numpy(stats))
    for route in (
        lambda: jfde._masks_from_stats_sorted(lab_j, stats_j, limit),
        lambda: jfde._masks_from_labels_sorted(lab_j, jnp.asarray(changed),
                                               limit),
        lambda: jfde._masks_from_stats(lab_j, stats_j, limit),
    ):
        np.testing.assert_array_equal(got, np.asarray(route()))
