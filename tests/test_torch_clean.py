"""Port artifact clean (remap_tpu_torch.ops.arf, pipeline.clean) vs the JAX
package, exact: the per-axis heat counts, the float32 heat (bit for bit
against the spec; JAX's decisions), the final picks of select + finalize (the knife-edge sets may differ,
the picks may not), the window gather, margins and ``clean()``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.ops import arf as jarf
from remap_tpu.pipeline import clean as jclean
from remap_tpu.pipeline import collect as jcollect
from remap_tpu.spec import arf as sarf
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.ops import arf as tarf
from remap_tpu_torch.ops import atlas as tatlas
from remap_tpu_torch.pipeline import clean as tclean

from torch_parity import jax_twin, to_numpy


def _image(kind: str):
    """(image, mask): tests/test_pipeline_e2e.py::test_arf_ops_match_spec's
    tiled image with a rare scratch and one hole, or a non-square world
    with holes and an empty band."""
    rng = np.random.default_rng(17)
    if kind == "tiled":
        tile = rng.integers(0, 16, size=(8, 8), dtype=np.uint8)
        image = np.tile(tile, (10, 12)).astype(np.uint8)
        image[40, 30:70] = (np.arange(40) * 7 % 16).astype(np.uint8)
        mask = np.ones_like(image)
        mask[3, 5] = 0
        return image, mask
    tile = rng.integers(0, 16, size=(6, 10), dtype=np.uint8)
    image = np.tile(tile, (9, 15))[:53, :147].astype(np.uint8)
    image[20:26, 60:90] = rng.integers(0, 16, size=(6, 30))
    mask = (rng.random(image.shape) > 0.01).astype(np.uint8)
    mask[:, 120:123] = 0
    image[mask == 0] = 0
    return image, mask


def _dots(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Votes whose blend is ``image``: 7 for the colour, 2 for its
    neighbour colour (so the blur has something to re-select)."""
    dots = np.zeros(image.shape + (16,), dtype=np.uint16)
    ys, xs = np.indices(image.shape)
    dots[ys, xs, image] = 7 * mask
    dots[ys, xs, (image.astype(int) + 1) % 16] += 2 * mask
    return dots


@pytest.mark.parametrize("kind", ["tiled", "holes"])
def test_heat_counts_and_heat_match_jax(kind):
    image, mask = _image(kind)
    ti, tm = torch.as_tensor(image), torch.as_tensor(mask)
    for axis in (1, 0):
        src = (image, mask) if axis == 1 else (image.T, mask.T)
        want = np.asarray(jarf._heat_axis(jnp.asarray(src[0]),
                                          jnp.asarray(src[1]), 15))
        got = tarf._heat_axis(torch.as_tensor(np.ascontiguousarray(src[0])),
                              torch.as_tensor(np.ascontiguousarray(src[1])),
                              15)
        np.testing.assert_array_equal(to_numpy(got), want.astype(np.int64))
        np.testing.assert_array_equal(
            want, sarf.heat_counts(image, mask, 15, axis).T
            if axis == 0 else sarf.heat_counts(image, mask, 15, axis))
    # the heat is the correctly rounded 1/sqrt of the spec, bit for bit;
    # XLA:CPU rewrites JAX's 1/sqrt into an rsqrt that is off by one ulp
    # on some counts, never across the 0.25 threshold
    got = to_numpy(tarf.heatmap(ti, tm))
    assert got.dtype == np.float32
    spec = sarf.combine(sarf.heat_counts(image, mask, 15, 1),
                        sarf.heat_counts(image, mask, 15, 0))
    np.testing.assert_array_equal(got.view(np.uint32), spec.view(np.uint32))
    want = np.asarray(jarf.heatmap(jnp.asarray(image), jnp.asarray(mask)))
    np.testing.assert_array_equal(got > 0.25, want > 0.25)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert np.isinf(got).any() and (got > 0.25).any() and (got <= 0.25).any()


def _final_picks_jax(dots, image, mask):
    return jarf.filter_fragment(jnp.asarray(dots), jnp.asarray(image),
                                jnp.asarray(mask))


def _port_canvas(dots: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(dots.transpose(2, 0, 1).astype(np.int32))


@pytest.mark.parametrize("kind", ["tiled", "holes", "ties"])
def test_select_and_finalize_match_jax(kind):
    """``ties``: every pixel votes equally for colours 3 and 5 and a grid
    of holes leaves no complete window, so every processed pixel is rare
    and a knife edge (equal blurred scores) that the host re-picks."""
    if kind == "ties":
        mask = np.ones((40, 61), np.uint8)
        mask[::9, :] = 0
        mask[:, ::9] = 0
        image = 3 * mask
        dots = np.zeros(mask.shape + (16,), np.uint16)
        dots[..., 3] = dots[..., 5] = 7 * mask
    else:
        image, mask = _image(kind)
        dots = _dots(image, mask)
    t_dots = _port_canvas(dots)
    t_image, t_mask = tatlas.blend(t_dots)
    np.testing.assert_array_equal(to_numpy(t_image), image * mask)
    res = tarf.filter_fragment_dispatch(t_dots, t_image, t_mask)
    got = tarf.filter_fragment_finalize(t_dots, res)
    want = _final_picks_jax(dots, image, mask)
    np.testing.assert_array_equal(got, want)
    heat = sarf.combine(sarf.heat_counts(image, mask, 15, 1),
                        sarf.heat_counts(image, mask, 15, 0))
    np.testing.assert_array_equal(got, sarf.select(dots, heat, 2.0))
    if kind == "ties":
        assert int(res.unstable.sum()) > 100


def test_window_gather_equals_full_canvas_repick():
    image, mask = _image("holes")
    dots = _dots(image, mask)
    rng = np.random.default_rng(3)
    ys = rng.integers(6, image.shape[0] - 6, 40)
    xs = rng.integers(6, image.shape[1] - 7, 40)
    win = tarf._gather_windows(_port_canvas(dots), torch.as_tensor(ys),
                               torch.as_tensor(xs), 13)
    got = sarf.rare_picks_from_windows(to_numpy(win).astype(np.uint16), 2.0)
    np.testing.assert_array_equal(got, sarf.rare_picks(dots, ys, xs, 2.0))


@pytest.mark.parametrize("kind", ["empty", "band", "full"])
def test_margins_match_jax(kind):
    dots = np.zeros((37, 53, 16), np.uint16)
    if kind == "band":
        dots[5:30, 9:40, 3] = 1
    elif kind == "full":
        dots[..., 0] = 2
    want = jclean.margins_of(dots)
    assert tclean.margins_of(dots) == want
    frag = convert.fragment_from_numpy(
        type("F", (), {"dots": dots, "zero": (0, 0), "frames": [],
                       "store": None})(), "cpu")
    assert tclean.margins_of_fragment(frag) == want
    frag.drop_device()
    assert tclean.margins_of_fragment(frag) == want


def test_clean_matches_jax_on_collected_fragments():
    """``clean()`` of JAX-collected fragments converted to the port."""
    cfg = PipelineConfig(screen_width=96, screen_height=64,
                         region_capacity=2048, frame_batch=8)
    a = testing.simple_clip(n_frames=8, frame_hw=(64, 96),
                            world_hw=(160, 224), seed=41)
    noise = np.random.default_rng(2).integers(0, 16, (64, 96), np.uint8)
    frames = a.frames + [noise] + a.frames[:4]
    col = jcollect.collect(frames, jax_twin(cfg))
    assert len(col.fragments) == 3
    want = jclean.clean(col.fragments, jax_twin(cfg))
    port = [convert.fragment_from_numpy(f, "cpu") for f in col.fragments]
    got = tclean.clean(port, cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, np.asarray(w))
