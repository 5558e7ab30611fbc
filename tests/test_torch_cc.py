"""Port connected-component labels and stats (remap_tpu_torch.ops.cc, the
plain versions of the K4 kernel) vs the JAX package: the XLA labeller
``ops/cc.py::label_components`` and the Pallas kernels in interpret mode
(``label_components_batch``, ``label_components_banded``,
``label_stats_batch``), exact on every element, border included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu_torch.ops import cc as tcc
from remap_tpu_torch.ops.kernels import cc as kcc

from torch_parity import interpret_pallas, to_numpy, to_torch  # noqa: F401


def _spiral(h, w, step):
    """Horizontal bars joined at alternating ends: one long snake."""
    img = np.zeros((h, w), np.uint8)
    img[::step, :] = 1
    for i, r in enumerate(range(0, h, step)):
        img[r, -2 if i % 2 == 0 else 1] = 0
    return img


def _stripes(rng, h, w):
    """Full-height vertical stripes of random colour."""
    cols = np.repeat(rng.integers(0, 4, w // 8 + 1).astype(np.uint8), 8)
    return np.tile(cols[None, :w], (h, 1))


def _snake(h, w):
    """A 1-px-wide path through a field of another colour."""
    img = np.zeros((h, w), np.uint8)
    for i, r in enumerate(range(1, h - 2, 2)):
        img[r, 1:w - 1] = 1
        if r + 1 < h - 2:
            img[r + 1, (w - 2) if i % 2 == 0 else 1] = 1
    return img


def _cases():
    """The cases of tests/test_pallas.py's CC tests, plus the adversarial
    contents a union-find labeller has to survive."""
    rng = np.random.default_rng(11)
    blocks = np.kron(rng.integers(0, 4, (8, 10), np.uint8),
                     np.ones((6, 6), np.uint8))[:40, :56]
    return {
        "blocks": blocks,
        "noise3": rng.integers(0, 3, (40, 56)).astype(np.uint8),
        "zeros": np.zeros((40, 56), np.uint8),
        "spiral": _spiral(33, 48, 4),
        "stripes": _stripes(rng, 37, 45),
        "snake": _snake(30, 37),
        "tiny": rng.integers(0, 2, (4, 3)).astype(np.uint8),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_labels_match_xla(name):
    from remap_tpu.ops import cc

    img = CASES[name]
    want = np.asarray(cc.label_components(jnp.asarray(img)))
    got = kcc.label_components_batch(to_torch(img[None]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got)[0], want)


@pytest.mark.parametrize("name", ["blocks", "noise3", "spiral", "stripes"])
def test_labels_match_pallas(interpret_pallas, name):
    """The Pallas whole-frame kernel (K4a), in interpret mode."""
    from remap_tpu.ops.pallas import cc as pcc

    img = CASES[name]
    want = np.asarray(pcc.label_components_batch(jnp.asarray(img[None])))
    got = kcc.label_components_batch(to_torch(img[None]))
    np.testing.assert_array_equal(to_numpy(got), want)


def _banded_cases():
    """The cases of tests/test_pallas.py::test_cc_banded_matches_whole_frame,
    with their band heights."""
    rng = np.random.default_rng(13)
    return [
        (rng.integers(0, 3, (64, 96)).astype(np.uint8), 16),
        (_stripes(rng, 64, 96), 16),
        (_spiral(64, 96, 6), 16),
        (rng.integers(0, 3, (50, 96)).astype(np.uint8), 16),   # padding
        (np.kron(rng.integers(0, 4, (10, 12), np.uint8),
                 np.ones((6, 8), np.uint8))[:58, :96], 8),
    ]


@pytest.mark.parametrize("case", range(5))
def test_labels_match_pallas_banded(interpret_pallas, case):
    """The Pallas row-banded labeller (K4b) with small bands."""
    from remap_tpu.ops.pallas import cc as pcc

    img, band = _banded_cases()[case]
    want = np.asarray(pcc.label_components_banded(jnp.asarray(img[None]),
                                                  band_rows=band))
    got = kcc.label_components_batch(to_torch(img[None]))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("name", ["blocks", "noise3", "zeros"])
def test_stats_match_pallas(interpret_pallas, name):
    """K4c's labels and [B, 5, H, W] stats on the whole plane, border
    included, against the Pallas kernel."""
    from remap_tpu.ops.pallas import cc as pcc

    img = CASES[name]
    rng = np.random.default_rng(5)
    changed = rng.random((2,) + img.shape) < 0.05
    images = np.stack([img, np.flipud(img).copy()])
    w_lab, w_stats = pcc.label_stats_batch(jnp.asarray(images),
                                           jnp.asarray(changed))
    labels, stats = kcc.label_stats_batch(to_torch(images),
                                          to_torch(changed.astype(np.uint8)))
    np.testing.assert_array_equal(to_numpy(labels), np.asarray(w_lab))
    np.testing.assert_array_equal(to_numpy(stats), np.asarray(w_stats))
    big = img.size
    assert to_numpy(stats)[0, :, 0, 0].tolist() == list(
        tcc.border_stats(big))


def test_interior_mask_bottom_horizon_is_two_rows():
    m = tcc.interior_mask(6, 5, "cpu")
    assert m.sum() == 3 * 3
    assert not m[-2:].any() and not m[0].any()
    assert not m[:, 0].any() and not m[:, -1].any()


def test_cc_wrappers_reject_cpu_tensors():
    img = to_torch(CASES["tiny"][None])
    with pytest.raises(ValueError, match="CUDA"):
        kcc.label_components_cuda(img)
    with pytest.raises(ValueError, match="CUDA"):
        kcc.label_stats_cuda(img, img)
