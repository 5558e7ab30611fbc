"""Port colour-vote blit (remap_tpu_torch.ops.kernels.blit) vs the JAX
Pallas blit run in interpret mode, the JAX scatter blit and a numpy
reference, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu_torch.ops import atlas as tatlas
from remap_tpu_torch.ops.kernels import blit as tblit
from remap_tpu_torch.pipeline import collect as tcollect

from torch_parity import (  # noqa: F401 (fixtures)
    interpret_pallas, to_numpy, to_torch,
)


def _inputs(seed, f=7, h=48, w=64, ah=80, aw=96):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 16, size=(f, h, w), dtype=np.uint8)
    pos = np.stack(
        [rng.integers(0, aw - w, f), rng.integers(0, ah - h, f)], -1
    ).astype(np.int32)
    ok = (rng.random((f, h, w)) < 0.8).astype(np.uint8)
    # incoming votes near the uint16 ceiling, so the adds wrap
    dots = rng.integers(65530, 65536, size=(16,) + tblit.padded_dims(ah, aw),
                        dtype=np.uint16)
    return frames, ok, pos, dots, ah, aw


def _numpy_blit(frames, vote_ok, pos, dots):
    """The vote add written out: one ``np.add.at`` per frame, then the
    uint16 wrap (fgm.hpp:12-15).  ``vote_ok`` None: every pixel votes."""
    out = dots.astype(np.int64)
    f, h, w = frames.shape
    for i in range(f):
        x, y = pos[i]
        ok = frames[i] < 16
        if vote_ok is not None:
            ok &= vote_ok[i] != 0
        yy, xx = np.nonzero(ok)
        np.add.at(out, (frames[i][ok].astype(np.int64), yy + y, xx + x), 1)
    return (out & 0xFFFF).astype(np.int32)


def test_padded_dims_match_jax():
    from remap_tpu.ops.pallas import blit as pblit

    for ah, aw in [(80, 96), (496, 512), (1, 1), (312, 388)]:
        assert tblit.padded_dims(ah, aw) == pblit.padded_dims(ah, aw)


@pytest.mark.parametrize("with_dots", [False, True])
def test_blit_plain_matches_pallas_interpret(interpret_pallas, with_dots):
    from remap_tpu.ops.pallas import blit as pblit

    frames, ok, pos, dots, ah, aw = _inputs(1)
    ref = pblit.blit_frames(
        jnp.asarray(frames), jnp.asarray(ok), jnp.asarray(pos), ah, aw,
        dots=jnp.asarray(dots) if with_dots else None,
    )
    got = tblit.blit_frames(
        to_torch(frames), to_torch(ok), to_torch(pos), ah, aw,
        dots=to_torch(dots) if with_dots else None,
    )
    np.testing.assert_array_equal(to_numpy(got, ref), np.asarray(ref))
    assert to_numpy(got).max() < 1 << 16


@pytest.mark.parametrize("polarity", ["nonzero", "zero", None])
def test_blit_in_place_matches_functional_and_pallas(interpret_pallas,
                                                     polarity):
    """The in-place plain blit equals the functional forms and the JAX
    Pallas blit (interpret mode) fed the equivalent vote_ok plane, for
    each vote polarity and for no plane; the functional form leaves its
    input as it was."""
    from remap_tpu.ops.pallas import blit as pblit

    frames, ok, pos, dots, ah, aw = _inputs(11)
    plane = None if polarity is None else ok
    vote_ok = {"nonzero": ok, "zero": (ok == 0).astype(np.uint8),
               None: np.ones_like(ok)}[polarity]
    ref = np.asarray(pblit.blit_frames(
        jnp.asarray(frames), jnp.asarray(vote_ok), jnp.asarray(pos), ah, aw,
        dots=jnp.asarray(dots)))
    kw = {} if polarity is None else {"vote_polarity": polarity}
    start = to_torch(dots)
    functional = tblit.blit_frames(
        to_torch(frames), None if plane is None else to_torch(plane),
        to_torch(pos), ah, aw, dots=start, **kw)
    assert torch.equal(start, to_torch(dots))      # input left as it was
    plain = tblit.blit_frames_plain(
        to_torch(frames), None if plane is None else to_torch(plane),
        to_torch(pos), ah, aw, dots=start, **kw)
    canvas = to_torch(dots)
    same = tblit.blit_frames_(
        to_torch(frames), to_torch(pos), canvas,
        vote=None if plane is None else to_torch(plane), **kw)
    assert same is canvas
    for got in (functional, plain, canvas):
        np.testing.assert_array_equal(to_numpy(got, ref), ref)
    assert (ref < dots).any()     # some counters wrapped


def test_blit_outside_box_untouched():
    """Bins outside the box the frames cover are bit-identical after the
    in-place blit, whatever they hold (even values no vote add could
    leave), and inside it only bins that took a vote change."""
    rng = np.random.default_rng(12)
    f, h, w = 5, 10, 14
    ahp, awp = tblit.padded_dims(60, 90)
    frames = rng.integers(0, 16, (f, h, w), dtype=np.uint8)
    pos = np.stack([rng.integers(20, 40, f), rng.integers(10, 30, f)],
                   -1).astype(np.int32)
    dots = rng.integers(-(1 << 31), 1 << 31, (16, ahp, awp), dtype=np.int64
                        ).astype(np.int32)
    canvas = to_torch(dots)
    tblit.blit_frames_(to_torch(frames), to_torch(pos), canvas,
                       box=tblit.frames_box(pos, h, w))
    got = to_numpy(canvas)
    x_lo, y_lo, x_hi, y_hi = tblit.frames_box(pos, h, w)
    inside = np.zeros((ahp, awp), bool)
    inside[y_lo:y_hi, x_lo:x_hi] = True
    np.testing.assert_array_equal(got[:, ~inside], dots[:, ~inside])
    voted = _numpy_blit(frames, None, pos, np.zeros_like(dots)) > 0
    np.testing.assert_array_equal(got[~voted], dots[~voted])
    assert (got[voted] != dots[voted]).all()


def test_blit_sliced_chunk_matches_validity_plane(interpret_pallas):
    """A chunk padded to F frames blitted with a validity plane (1 for
    the first n_real frames) equals the leading n_real frames sliced."""
    from remap_tpu.ops.pallas import blit as pblit

    frames, _, pos, dots, ah, aw = _inputs(13, f=8)
    n_real = 5
    validity = np.zeros_like(frames)
    validity[:n_real] = 1
    ref = np.asarray(pblit.blit_frames(
        jnp.asarray(frames), jnp.asarray(validity), jnp.asarray(pos), ah, aw,
        dots=jnp.asarray(dots)))
    imgs, apos = to_torch(frames), to_torch(pos)
    canvas = to_torch(dots)
    tblit.blit_frames_(imgs[:n_real], apos[:n_real], canvas)
    np.testing.assert_array_equal(to_numpy(canvas, ref), ref)


def test_masked_sliced_chunk_matches_padded_masks():
    """The foreground's chunk: masks of padding frames set to 1 (no vote)
    in the JAX scatter blit equals the port's in-place blit of the
    leading n_real frames and masks."""
    from remap_tpu.ops import atlas as jatlas

    rng = np.random.default_rng(14)
    f, n_real, h, w, ah, aw = 6, 4, 12, 16, 30, 40
    frames = rng.integers(0, 16, (f, h, w), dtype=np.uint8)
    masks = (rng.random((f, h, w)) < 0.3).astype(np.uint8)
    masks[n_real:] = 1
    pos = np.stack([rng.integers(0, aw - w, f), rng.integers(0, ah - h, f)],
                   -1).astype(np.int32)
    dots = rng.integers(65533, 65536, (ah, aw, 16)).astype(np.uint16)
    want = np.asarray(jatlas.blit_frames(
        jnp.asarray(frames), jnp.asarray(pos), ah, aw,
        masks=jnp.asarray(masks), dots=jnp.asarray(dots)))
    canvas = tatlas.from_host(dots, "cpu")
    tblit.blit_frames_(to_torch(frames)[:n_real], to_torch(pos)[:n_real],
                       canvas, vote=to_torch(masks)[:n_real],
                       vote_polarity="zero",
                       box=tblit.frames_box(pos[:n_real], h, w))
    np.testing.assert_array_equal(tatlas.to_host(canvas, ah, aw), want)


def test_blit_large_canvas_matches_jax():
    """8 frames of 24x32 at scattered positions in a 300x700 canvas."""
    from remap_tpu.ops import atlas as jatlas

    rng = np.random.default_rng(15)
    f, h, w, ah, aw = 8, 24, 32, 300, 700
    frames = rng.integers(0, 16, (f, h, w), dtype=np.uint8)
    masks = (rng.random((f, h, w)) < 0.2).astype(np.uint8)
    pos = np.stack([rng.integers(0, aw - w + 1, f),
                    rng.integers(0, ah - h + 1, f)], -1).astype(np.int32)
    want = np.asarray(jatlas.blit_frames(
        jnp.asarray(frames), jnp.asarray(pos), ah, aw,
        masks=jnp.asarray(masks)))
    got = tblit.blit_frames(to_torch(frames), to_torch(masks), to_torch(pos),
                            ah, aw, vote_polarity="zero")
    np.testing.assert_array_equal(tatlas.to_host(got, ah, aw), want)


def test_blit_frames_at_padded_edges():
    """Frames touching the physical canvas's right and bottom edges (and
    the origin) vote into the padding bins."""
    rng = np.random.default_rng(16)
    f, h, w = 4, 9, 13
    ahp, awp = tblit.padded_dims(20, 30)
    frames = rng.integers(0, 17, (f, h, w), dtype=np.uint8)  # 16: no vote
    pos = np.array([[awp - w, ahp - h], [awp - w, 0], [0, ahp - h], [0, 0]],
                   np.int32)
    dots = rng.integers(0, 1 << 16, (16, ahp, awp)).astype(np.int32)
    canvas = to_torch(dots)
    tblit.blit_frames_(to_torch(frames), to_torch(pos), canvas)
    np.testing.assert_array_equal(to_numpy(canvas),
                                  _numpy_blit(frames, None, pos, dots))
    assert to_numpy(canvas)[:, -1, -1].sum() > dots[:, -1, -1].sum() - 16


def test_blit_counters_wrap():
    """65,535 - 2 votes on one bin from 3 incoming wraps to 0."""
    frames = torch.full((5, 2, 4), 7, dtype=torch.uint8)
    pos = torch.zeros((5, 2), dtype=torch.int32)
    canvas = torch.zeros((16,) + tblit.padded_dims(4, 8), dtype=torch.int32)
    canvas[7] = 65531
    tblit.blit_frames_(frames, pos, canvas)
    assert int(canvas[7, 0, 0]) == 0
    assert int(canvas[7, 2, 0]) == 65531
    assert int(canvas.sum()) == 65531 * (canvas[7].numel() - 8)


def test_blit_plain_accumulates():
    frames = torch.full((2, 8, 16), 3, dtype=torch.uint8)
    ok = torch.ones((2, 8, 16), dtype=torch.uint8)
    pos = torch.zeros((2, 2), dtype=torch.int32)
    d1 = tblit.blit_frames(frames, ok, pos, 16, 32)
    d2 = tblit.blit_frames(frames, ok, pos, 16, 32, dots=d1)
    assert int(d2[3, 0, 0]) == 4
    assert int(d2.sum()) == 4 * 8 * 16


def test_blit_rejects_unknown_polarity():
    frames, ok, pos, dots, _, _ = _inputs(17)
    with pytest.raises(ValueError, match="vote_polarity"):
        tblit.blit_frames_(to_torch(frames), to_torch(pos), to_torch(dots),
                           vote=to_torch(ok), vote_polarity="one")


def test_blit_wrapper_rejects_cpu_tensors():
    frames, ok, pos, dots, _, _ = _inputs(2)
    with pytest.raises(ValueError, match="CUDA"):
        tblit.blit_frames_cuda(to_torch(frames), to_torch(pos),
                               to_torch(dots), vote=to_torch(ok))


def test_blit_pass_chunks_match_one_blit():
    """blit_pass's unpadded in-place chunks over their boxes equal one
    blit of every frame at once (the chunk size does not matter)."""
    from remap_tpu_torch.config import PipelineConfig
    from remap_tpu_torch.pipeline import state as tstate

    rng = np.random.default_rng(18)
    n, h, w = 11, 8, 10
    imgs = rng.integers(0, 16, (n, h, w), dtype=np.uint8)
    store = tstate.FrameStore(h, w, device="cpu")
    store.put_packed_batch(list(range(n)), tstate.pack_nibbles_batch(imgs))
    steps = rng.integers(-3, 4, (n, 2))
    steps[0] = 0
    matched = np.ones(n, bool)
    matched[0] = False
    segments = tcollect.segment_positions(steps, matched)
    (frag,) = tcollect.blit_pass(segments, store,
                                 PipelineConfig(frame_batch=4))
    positions = np.array([r.position for r in frag.frames])  # canvas
    ch, cw = frag.shape
    want = tblit.blit_frames(to_torch(imgs), None,
                             to_torch(positions.astype(np.int32)), ch, cw)
    assert torch.equal(frag.device_dots("cpu"), want)
