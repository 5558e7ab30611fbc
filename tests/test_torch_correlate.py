"""The correlation matchers (remap_tpu_torch.ops.correlate, models) vs the
JAX package's, exact: the rounded correlation windows (FFT and direct),
the pyramid's fine-level counts (``fine_counts``),
``match_xcorr``'s offsets, flags and peak counts, ``match_pyramid``,
``match_canvases`` and its pyramid on tests/test_splice_xcorr.py's
canvases and on periodic textures where the top-k's tie order decides,
and ``get_matcher``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu import models as jmodels
from remap_tpu.config import PipelineConfig as JPipelineConfig
from remap_tpu.models import pyramid as jpyramid
from remap_tpu.ops import correlate as jcorrelate
from remap_tpu.utils import testing
from remap_tpu_torch import models as tmodels
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.models import pyramid as tpyramid
from remap_tpu_torch.ops import correlate as tcorrelate

from torch_parity import to_numpy, to_torch


@pytest.fixture(scope="module")
def world():
    """tests/test_models.py's world."""
    return testing.make_world(400, 520, np.random.default_rng(71), tile=8)


def frames_at(world, cams, h, w):
    return np.stack([world[y:y + h, x:x + w] for x, y in cams])


def _pairs(world, h, w, shifts, seed):
    """Frame pairs of ``world`` at random cameras, curr shifted by each
    (dx, dy) in ``shifts``, with a few pixels of noise in curr."""
    rng = np.random.default_rng(seed)
    cams = [(int(rng.integers(40, 400 - w)), int(rng.integers(40, 330 - h)))
            for _ in shifts]
    prev = frames_at(world, cams, h, w)
    curr = frames_at(world, [(x + dx, y + dy) for (x, y), (dx, dy)
                             in zip(cams, shifts)], h, w)
    noise = rng.random(curr.shape) < 0.05
    curr = np.where(noise, rng.integers(0, 16, curr.shape), curr)
    return prev, curr.astype(np.uint8)


def _assert_xcorr_equal(got, want):
    np.testing.assert_array_equal(to_numpy(got.offset), np.asarray(want.offset))
    np.testing.assert_array_equal(to_numpy(got.ok), np.asarray(want.ok))
    np.testing.assert_array_equal(to_numpy(got.score),
                                  np.round(np.asarray(want.score)))


@pytest.mark.parametrize("radius,h,w", [(1, 37, 53), (3, 37, 53),
                                        (8, 64, 96), (16, 45, 77)])
def test_windows_match_jax_and_direct(world, radius, h, w):
    """The port's rounded FFT window equals JAX's rounded window and the
    port's direct counts, at odd sizes; the direct counts equal JAX's
    (held where JAX's eager loop of (2R+1)^2 rolls stays quick)."""
    prev, curr = _pairs(world, h, w, [(2, -1), (-radius, radius), (0, 0)],
                        seed=radius)
    tp, tc = to_torch(prev), to_torch(curr)
    got = tcorrelate.correlation_scores(tp, tc, radius)
    direct = tcorrelate.correlation_scores_direct(tp, tc, radius)
    want = np.asarray(jcorrelate.correlation_scores(
        jnp.asarray(prev), jnp.asarray(curr), radius))
    assert got.shape == (3, 2 * radius + 1, 2 * radius + 1)
    assert got.dtype == direct.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got), np.round(want))
    np.testing.assert_array_equal(to_numpy(got), to_numpy(direct))
    if radius <= 3:
        want_direct = np.asarray(jcorrelate.correlation_scores_direct(
            jnp.asarray(prev), jnp.asarray(curr), radius))
        np.testing.assert_array_equal(to_numpy(direct), want_direct)


@pytest.mark.parametrize("method", ["fft", "direct"])
def test_xcorr_recovers_shifts_as_jax(world, method):
    """tests/test_models.py::test_xcorr_recovers_shifts's frames, through
    ``match_xcorr`` and (for JAX's ``method="direct"``) ``pick_peak`` over
    the direct counts."""
    cams_prev = [(100, 100), (130, 90), (80, 120)]
    cams_curr = [(103, 98), (140, 100), (80, 120)]
    if method == "direct":
        cams_curr[1] = (126, 94)
    prev = frames_at(world, cams_prev, 96, 128)
    curr = frames_at(world, cams_curr, 96, 128)
    radius = 16 if method == "fft" else 4
    if method == "fft":
        got = tcorrelate.match_xcorr(to_torch(prev), to_torch(curr),
                                     radius=radius)
    else:
        got = tcorrelate.pick_peak(tcorrelate.correlation_scores_direct(
            to_torch(prev), to_torch(curr), radius), 96, 128)
    want = jcorrelate.match_xcorr(jnp.asarray(prev), jnp.asarray(curr),
                                  radius=radius, method=method)
    _assert_xcorr_equal(got, want)
    assert got.ok.all()
    assert [tuple(o) for o in got.offset.tolist()] == [
        (cx - px, cy - py) for (px, py), (cx, cy) in zip(cams_prev, cams_curr)]


def test_xcorr_rejects_unrelated_as_jax(world):
    """tests/test_models.py::test_xcorr_rejects_unrelated's frames, and a
    flat pair (every shift ties: the first maximum, accepted by neither
    package since the runner-up equals the peak)."""
    prev = frames_at(world, [(100, 100)], 96, 128)
    curr = np.random.default_rng(73).integers(0, 16, size=(1, 96, 128),
                                              dtype=np.uint8)
    flat = np.full((1, 96, 128), 5, np.uint8)
    for p, c in [(prev, curr), (flat, flat)]:
        got = tcorrelate.match_xcorr(to_torch(p), to_torch(c), radius=16)
        want = jcorrelate.match_xcorr(jnp.asarray(p), jnp.asarray(c),
                                      radius=16)
        _assert_xcorr_equal(got, want)
        assert not got.ok.any()


def test_xcorr_thresholds_in_float32():
    """The cover and ratio thresholds compare in float32 as JAX's: each
    threshold set a hair above the pair's own peak (or its ratio to the
    runner-up) in double precision, where float32 rounds it to the peak,
    and a hair below and above that."""
    rng = np.random.default_rng(5)
    h, w = 40, 50
    base = rng.integers(0, 16, size=(1, h, w), dtype=np.uint8)
    curr = base.copy()
    flat = curr.reshape(-1)
    idx = rng.permutation(h * w)[:1200]
    flat[idx] = (flat[idx] + 1 + rng.integers(0, 15, 1200)) % 16
    win = tcorrelate.correlation_scores_direct(to_torch(base),
                                               to_torch(curr), 4)[0]
    peak = float(win.max())
    runner = float(torch.sort(win.reshape(-1)).values[-2])
    cases = [dict(min_cover=(peak + d) / (h * w), min_ratio=1.0)
             for d in (-1e-3, 1e-6, 1e-3)]
    cases += [dict(min_cover=0.0, min_ratio=peak / runner + d)
              for d in (-1e-9, 1e-9, 1e-5)]
    oks = []
    for kw in cases:
        got = tcorrelate.match_xcorr(to_torch(base), to_torch(curr),
                                     radius=4, exclude=0, **kw)
        want = jcorrelate.match_xcorr(jnp.asarray(base), jnp.asarray(curr),
                                      radius=4, exclude=0, **kw)
        _assert_xcorr_equal(got, want)
        oks.append(bool(got.ok[0]))
    # float32 rounds the hair above the peak away, not the larger steps
    assert oks[:3] == [True, True, False]
    assert oks[3] and not oks[5]


def test_shift_frames_is_a_per_frame_roll():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 16, size=(4, 9, 13), dtype=np.uint8)
    offs = np.array([[3, -2], [-14, 20], [0, 0], [12, 9]], np.int32)
    got = to_numpy(tcorrelate.shift_frames(to_torch(frames), to_torch(offs)))
    want = np.stack([np.roll(f, (o[1], o[0]), axis=(0, 1))
                     for f, o in zip(frames, offs)])
    np.testing.assert_array_equal(got, want)


#: coarse offsets (dx, dy) that wrap both ways, up to +-128
FINE_BASES = np.array([[128, -128], [-128, 128], [-37, 61], [0, 0]], np.int32)


def _fine_frames(world, kind, h, w):
    """Four ``[h, w]`` frame pairs: world texture with noise, constant
    frames, or frames blank but for a one-pixel stripe along two borders
    (where the edge rule alone decides the counts)."""
    if kind == "texture":
        return _pairs(world, h, w, [(2, -1), (-5, 4), (0, 0), (7, 7)],
                      seed=h + w)
    if kind == "constant":
        frames = np.full((4, h, w), 9, np.uint8)
        return frames, frames.copy()
    frames = np.zeros((4, h, w), np.uint8)
    frames[:, :, 0] = 3
    frames[:, -1, :] = 12
    return frames, frames.copy()


@pytest.mark.parametrize("kind", ["texture", "constant", "stripe"])
@pytest.mark.parametrize("h,w", [(37, 53), (40, 64)])
@pytest.mark.parametrize("radius", [1, 5, 7])
def test_fine_counts_match_direct_and_jax(world, radius, h, w, kind):
    """``fine_counts`` on CPU tensors equals the direct counts of ``curr``
    rolled by ``shift_frames`` and the JAX package's fine pass (each
    frame ``jnp.roll``ed by its coarse offset, then ``method="direct"``),
    at odd and even sizes, with offsets that wrap both ways; constant
    frames count the overlap, (H - |dy|) (W - |dx|)."""
    prev, curr = _fine_frames(world, kind, h, w)
    tp, tc, tb = to_torch(prev), to_torch(curr), to_torch(FINE_BASES)
    got = tcorrelate.fine_counts(tp, tc, tb, radius)
    plain = tcorrelate.correlation_scores_direct(
        tp, tcorrelate.shift_frames(tc, tb), radius)
    rolled = jnp.stack([jnp.roll(jnp.asarray(c), (int(dy), int(dx)),
                                 axis=(0, 1))
                        for c, (dx, dy) in zip(curr, FINE_BASES)])
    want = np.asarray(jcorrelate.correlation_scores_direct(
        jnp.asarray(prev), rolled, radius))
    n = 2 * radius + 1
    assert got.shape == (4, n, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got), to_numpy(plain))
    np.testing.assert_array_equal(to_numpy(got), want)
    if kind == "constant":
        d = np.abs(np.arange(-radius, radius + 1))
        overlap = (h - d)[:, None] * (w - d)[None, :]
        np.testing.assert_array_equal(to_numpy(got),
                                      np.broadcast_to(overlap, (4, n, n)))


@pytest.mark.parametrize("case", ["large", "small"])
def test_pyramid_matches_jax(world, case):
    """tests/test_models.py::test_pyramid_recovers_large_shifts's frames
    (coarse radius 16, fine 7), and small steps at the family's own
    defaults (factor 4, coarse radius 32, fine radius 5) with a noise
    frame."""
    if case == "large":
        cams_prev = [(60, 60), (200, 150)]
        cams_curr = [(108, 97), (150, 180)]
        kw = dict(factor=4, coarse_radius=16, fine_radius=7)
        h, w = 192, 256
    else:
        cams_prev = [(60, 60), (100, 70), (40, 44)]
        cams_curr = [(63, 58), (90, 80), (41, 44)]
        kw = dict(factor=4)
        h, w = 120, 160
    prev = frames_at(world, cams_prev, h, w)
    curr = frames_at(world, cams_curr, h, w)
    if case == "small":
        curr[2] = np.random.default_rng(4).integers(0, 16, (h, w))
    got = tpyramid.match_pyramid(to_torch(prev), to_torch(curr), **kw)
    want = jpyramid.match_pyramid(jnp.asarray(prev), jnp.asarray(curr), **kw)
    np.testing.assert_array_equal(to_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))
    n_real = 2
    assert got[1][:n_real].all()
    assert [tuple(o) for o in got[0][:n_real].tolist()] == [
        (cx - px, cy - py) for (px, py), (cx, cy)
        in zip(cams_prev[:n_real], cams_curr[:n_real])]
    if case == "small":
        assert not bool(got[1][2])


# ---- canvases ----------------------------------------------------------------

def _bucket(a, mask=None):
    """tests/test_splice_xcorr.py's 128-bucketed canvas and mask."""
    h, w = a.shape
    hb, wb = -(-h // 128) * 128, -(-w // 128) * 128
    img = np.zeros((hb, wb), np.uint8)
    img[:h, :w] = a
    m = np.zeros((hb, wb), np.uint8)
    m[:h, :w] = 1 if mask is None else mask
    return img, m


def _canvases(case):
    """tests/test_splice_xcorr.py's canvas pairs, and periodic textures
    whose planes tie at every period."""
    if case == "convention":
        world = testing.make_world(200, 260, np.random.default_rng(5))
        return _bucket(world[10:110, 10:150]) + _bucket(world[40:150, 35:200])
    if case == "negative":
        world = testing.make_world(220, 260, np.random.default_rng(9))
        return _bucket(world[60:180, 70:220]) + _bucket(world[20:130, 20:160])
    if case == "unrelated":
        return (_bucket(testing.make_world(150, 180, np.random.default_rng(6)))
                + _bucket(testing.make_world(150, 180,
                                             np.random.default_rng(7))))
    if case == "masks":
        world = testing.make_world(200, 260, np.random.default_rng(8))
        a = world[10:110, 10:150].copy()
        mask_a = np.ones(a.shape, np.uint8)
        mask_a[:, :40] = 0
        a[:, :40] = 0
        return _bucket(a, mask_a) + _bucket(world[40:150, 35:200])
    if case == "pyramid":
        world = testing.make_world(260, 300, np.random.default_rng(11))
        return _bucket(world[10:140, 10:200]) + _bucket(world[50:230, 45:260])
    # a motif repeated every 6 px: every period ties on the FFT plane, so
    # the top-k's tie order picks the candidates
    motif = np.random.default_rng(13).integers(0, 16, (6, 6), dtype=np.uint8)
    world = np.tile(motif, (40, 50))
    if case == "periodic":
        return _bucket(world[3:100, 5:150]) + _bucket(world[20:120, 40:200])
    # the same with a hole in a's mask and a band of b masked off
    a = world[3:100, 5:150].copy()
    mask_a = np.ones(a.shape, np.uint8)
    mask_a[30:60, 20:70] = 0
    mask_b = np.ones((100, 160), np.uint8)
    mask_b[:, :13] = 0
    return _bucket(a, mask_a) + _bucket(world[20:120, 40:200], mask_b)


CANVAS_CASES = ["convention", "negative", "unrelated", "masks", "pyramid",
                "periodic", "periodic_masked"]


def _assert_canvas_equal(got, want):
    assert tuple(got.offset.tolist()) == tuple(
        int(v) for v in np.asarray(want.offset))
    assert int(got.count) == int(want.count)
    assert int(got.overlap) == int(want.overlap)
    assert bool(got.ok) == bool(want.ok)


@pytest.mark.parametrize("case", CANVAS_CASES)
def test_match_canvases_matches_jax(case):
    ia, ma, ib, mb = _canvases(case)
    got = tcorrelate.match_canvases(*map(to_torch, (ia, ma, ib, mb)))
    want = jcorrelate.match_canvases(ia, ma, ib, mb)
    _assert_canvas_equal(got, want)
    expect = {"convention": (25, 30), "negative": (-50, -40),
              "masks": (25, 30), "pyramid": (35, 40)}
    if case in expect:
        assert bool(got.ok) and tuple(got.offset.tolist()) == expect[case]
    if case == "unrelated":
        assert not bool(got.ok)


@pytest.mark.parametrize("case", CANVAS_CASES)
def test_match_canvases_pyramid_matches_jax(case):
    ia, ma, ib, mb = _canvases(case)
    got = tcorrelate.match_canvases_pyramid(*map(to_torch, (ia, ma, ib, mb)))
    want = jcorrelate.match_canvases_pyramid(ia, ma, ib, mb)
    _assert_canvas_equal(got, want)


def test_direct_rescore_matches_jax():
    """Exact counts at shifts that reach every edge of the grid."""
    ia, ma, ib, mb = _canvases("masks")
    cands = np.array([[0, 0], [25, 30], [-127, -127], [127, 127],
                      [-200, 5], [255, -3]], np.int32)
    got = tcorrelate._direct_rescore(*map(to_torch, (ia, ma, ib, mb, cands)))
    want = jcorrelate._direct_rescore(ia, ma, ib, mb, jnp.asarray(cands))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


# ---- families ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["xcorr", "pyramid"])
def test_get_matcher_matches_jax(world, name):
    cams_prev = [(100, 100), (130, 90)]
    cams_curr = [(103, 98), (118, 101)]
    prev = frames_at(world, cams_prev, 128, 160)
    curr = frames_at(world, cams_curr, 128, 160)
    got = tmodels.get_matcher(name, PipelineConfig())(to_torch(prev),
                                                      to_torch(curr))
    want = jmodels.get_matcher(name, JPipelineConfig())(jnp.asarray(prev),
                                                        jnp.asarray(curr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[1].all()
    assert tmodels.FAMILIES == jmodels.FAMILIES


def test_get_matcher_rejects_unknown():
    with pytest.raises(ValueError, match="unknown matcher"):
        tmodels.get_matcher("bogus", PipelineConfig())
