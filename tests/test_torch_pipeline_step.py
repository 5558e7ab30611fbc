"""The port's multi-clip pipeline step
(remap_tpu_torch.parallel.sharded.make_pipeline_step) vs the JAX
package's ``make_pipeline_step(..., use_pallas=False)``, exact, under
each matcher family: offsets, matched flags, positions and the per-clip
atlases, on clips with a noise break and camera paths that leave the
window (the clamp)."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from remap_tpu.parallel import sharded as jsharded
from remap_tpu.utils import testing
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.parallel import sharded as tsharded

from torch_parity import jax_twin, to_numpy

H, W = 64, 96
LAYOUT = make_layout(W, H, 4, 2, 16)
CFG = PipelineConfig(screen_width=W, screen_height=H, region_capacity=512,
                     frame_batch=4)
PAD = 8


def _clips(n_clips: int, t: int, seed: int) -> np.ndarray:
    """``[C, T, H, W]`` clips of one world along known paths; clip 1 has a
    noise frame at t = 2, and clip 0 drifts further than the pad."""
    rng = np.random.default_rng(seed)
    world = testing.make_world(200, 300, rng)
    clips = []
    for c in range(n_clips):
        x0, y0 = 20 + 40 * c, 30 + 10 * c
        step = (4, 3) if c == 0 else (-2, 1)
        path = [(x0 + step[0] * i, y0 + step[1] * i) for i in range(t)]
        frames = np.stack(testing.render_clip(world, path, (H, W)).frames)
        if c == 1:
            frames[2] = rng.integers(0, 16, (H, W), dtype=np.uint8)
        clips.append(frames)
    return np.stack(clips)


@pytest.mark.parametrize("family", ["grid_vote", "xcorr", "pyramid"])
def test_pipeline_step_matches_jax(family):
    images = _clips(3, 5, seed=23)
    cfg = dataclasses.replace(CFG, matcher=family)
    want = jax.jit(jsharded.make_pipeline_step(
        jax_twin(LAYOUT), jax_twin(cfg), atlas_pad=PAD,
        use_pallas=False))(images)
    step = tsharded.make_pipeline_step(LAYOUT, cfg, atlas_pad=PAD,
                                       device="cpu")
    got = step(torch.as_tensor(images))
    assert got.atlas.dtype == torch.uint16
    assert got.atlas.shape == (3, H + 2 * PAD, W + 2 * PAD, 16)
    for name in ("offsets", "matched", "positions", "atlas"):
        np.testing.assert_array_equal(
            to_numpy(getattr(got, name)).astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), err_msg=name)
    matched = to_numpy(got.matched)
    assert not matched[:, 0].any()
    if family != "pyramid":
        # the camera's deltas wherever the pair is real
        assert matched[0, 1:].all() and matched[2, 1:].all()
        assert not matched[1, 2:4].any()
        offs = to_numpy(got.offsets)
        assert (offs[0, 1:] == (4, 3)).all() and (offs[2, 1:] == (-2, 1)).all()


def test_pipeline_step_table_modes():
    """table_mode="sort2" gives JAX's outputs (clip 1's noise frame trips
    the chunk quota, so its tables differ from topk's); an unknown table
    mode or matcher raises."""
    images = _clips(3, 5, seed=23)
    cfg = dataclasses.replace(CFG, table_mode="sort2")
    want = jax.jit(jsharded.make_pipeline_step(
        jax_twin(LAYOUT), jax_twin(cfg), atlas_pad=PAD,
        use_pallas=False))(images)
    got = tsharded.make_pipeline_step(LAYOUT, cfg, atlas_pad=PAD,
                                      device="cpu")(torch.as_tensor(images))
    for name in ("offsets", "matched", "positions", "atlas"):
        np.testing.assert_array_equal(
            to_numpy(getattr(got, name)).astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), err_msg=name)
    with pytest.raises(ValueError, match="bogus"):
        tsharded.make_pipeline_step(
            LAYOUT, dataclasses.replace(CFG, table_mode="bogus"),
            device="cpu")
    with pytest.raises(ValueError, match="unknown matcher"):
        tsharded.make_pipeline_step(
            LAYOUT, dataclasses.replace(CFG, matcher="sift"), device="cpu")
