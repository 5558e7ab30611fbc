"""The port's foreground slice vs the JAX package, exact: the collect tail
(``segment_positions``, ``blit_pass``), ``filter_fragments`` on the
fragments of a JAX ``collect``, the canvas ops of ``ops.atlas``, the
device parts of ``pipeline.state`` and the fragment conversions."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.config import PipelineConfig
from remap_tpu.ops import atlas as jatlas
from remap_tpu.pipeline import state as jstate
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.ops import atlas as tatlas
from remap_tpu_torch.ops.kernels import blit as kblit
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.pipeline import foreground as tfg
from remap_tpu_torch.pipeline import state as tstate

from torch_parity import to_numpy, to_torch

CFG = PipelineConfig(screen_width=64, screen_height=48, frame_batch=4,
                     region_capacity=2048)


@functools.cache
def _collected(store_medians: bool):
    """JAX collect of a two-sprite clip with a noise frame (two
    fragments), and the JAX foreground pass over its fragments."""
    from remap_tpu.pipeline import collect as jcollect
    from remap_tpu.pipeline import foreground as jfg

    clip = testing.simple_clip(n_frames=10, frame_hw=(48, 64), seed=33,
                               n_sprites=2)
    frames = list(clip.frames)
    frames[6] = np.random.default_rng(34).integers(0, 16, (48, 64),
                                                   dtype=np.uint8)
    cfg = dataclasses.replace(CFG, store_medians=store_medians)
    col = jcollect.collect(iter(frames), cfg)
    return cfg, col, jfg.filter_fragments(col.fragments, cfg)


def _port_cfg(cfg):
    """The port's config with the fields of the JAX ``cfg``."""
    return convert.config_from_dict(dataclasses.asdict(cfg))


def _port_fragments(col):
    store = convert.store_from_numpy(col.store, "cpu")
    return [convert.fragment_from_numpy(f, "cpu", store=store)
            for f in col.fragments]


@pytest.mark.parametrize("store_medians", [False, True],
                         ids=["recomputed_medians", "stored_medians"])
def test_filter_fragments_matches_jax(store_medians):
    cfg, col, want = _collected(store_medians)
    assert len(col.fragments) >= 2
    got = tfg.filter_fragments(_port_fragments(col), _port_cfg(cfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.zero == w.zero
        assert [(r.number, r.position) for r in g.frames] == [
            (r.number, r.position) for r in w.frames]
        np.testing.assert_array_equal(g.dots, np.asarray(w.dots))
    # the filter took sprite votes out of the first fragment
    assert (np.asarray(want[0].dots) != np.asarray(
        col.fragments[0].dots)).any()


def test_blit_pass_matches_jax():
    from remap_tpu.pipeline import collect as jcollect

    cfg, col, _ = _collected(False)
    segs = tcollect.segment_positions(col.offsets, col.matched)
    assert segs == jcollect.segment_positions(col.offsets, col.matched)
    want = jcollect.blit_pass(segs, col.store, cfg, use_pallas=False)
    store = convert.store_from_numpy(col.store, "cpu")
    got = tcollect.blit_pass(segs, store, _port_cfg(cfg))
    assert len(got) == len(want) == len(segs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.zero == w.zero == (0, 0)
        assert [r.position for r in g.frames] == [r.position for r in w.frames]
        np.testing.assert_array_equal(g.dots, np.asarray(w.dots))


def test_fragment_round_trip():
    _, col, _ = _collected(False)
    frag = _port_fragments(col)[0]
    record = convert.fragment_to_numpy(frag)
    # the JAX Fragment built from the port's host record
    rows = record.store
    store = jstate.FrameStore(rows.height, rows.width, rows.device_budget)
    store.put_packed_batch(rows.numbers, rows.packed_images,
                           rows.packed_medians)
    back = jstate.Fragment(
        dots=record.dots, zero=record.zero, store=store,
        frames=[jstate.FrameRef(number=n, position=p)
                for n, p in record.frames])
    jf = col.fragments[0]
    np.testing.assert_array_equal(back.dots, np.asarray(jf.dots))
    assert back.zero == jf.zero and len(back.frames) == len(jf.frames)
    assert [(r.number, r.position) for r in back.frames] == [
        (r.number, r.position) for r in jf.frames]
    for n in (r.number for r in jf.frames):
        np.testing.assert_array_equal(back.store.image(n), jf.store.image(n))
    # the port's host copy comes from the device canvas once
    assert frag.dots is frag.dots
    frag.drop_device()
    assert frag.dots_dev is None
    np.testing.assert_array_equal(tatlas.to_host(frag.device_dots("cpu"),
                                                 *frag.shape), frag.dots)


def test_blend_first_maximum_wins():
    rng = np.random.default_rng(1)
    dots = rng.integers(0, 4, (5, 7, 16)).astype(np.uint16)
    dots[0, 0] = 0
    dots[1, 1, [3, 9]] = 50      # a tie: the first colour wins
    want_img, want_mask = jatlas.blend(jnp.asarray(dots))
    img, mask = tatlas.blend(to_torch(dots.transpose(2, 0, 1)))
    np.testing.assert_array_equal(to_numpy(img), np.asarray(want_img))
    np.testing.assert_array_equal(to_numpy(mask), np.asarray(want_mask))
    assert int(img[1, 1]) == 3 and int(mask[0, 0]) == 0


@pytest.mark.parametrize("fill", ["empty", "votes"])
def test_margins_match_jax(fill):
    dots = np.zeros((9, 11, 16), np.uint16)
    if fill == "votes":
        dots[2:5, 3:8, 4] = 1
    want = np.asarray(jatlas.margins(jnp.asarray(dots)))
    got = tatlas.margins(to_torch(dots.transpose(2, 0, 1)))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_add_fragment_matches_jax():
    rng = np.random.default_rng(2)
    dots = rng.integers(65500, 65536, (12, 14, 16)).astype(np.uint16)
    other = rng.integers(0, 60, (5, 6, 16)).astype(np.uint16)
    for pos in [(3, 4), (10, 9)]:       # the second start clamps
        want = np.asarray(jatlas.add_fragment(
            jnp.asarray(dots), jnp.asarray(other),
            jnp.asarray(pos, jnp.int32)))
        got = tatlas.add_fragment(to_torch(dots.transpose(2, 0, 1)),
                                  to_torch(other.transpose(2, 0, 1)),
                                  torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(
            to_numpy(got).transpose(1, 2, 0).astype(np.uint16), want)


def test_masked_blit_matches_jax_near_wrap():
    """Masked votes (vote where mask == 0) onto counters near 2**16."""
    rng = np.random.default_rng(6)
    f, h, w, ah, aw = 5, 12, 16, 20, 30
    frames = rng.integers(0, 16, (f, h, w), dtype=np.uint8)
    masks = (rng.random((f, h, w)) < 0.3).astype(np.uint8)
    pos = np.stack([rng.integers(0, aw - w, f), rng.integers(0, ah - h, f)],
                   -1).astype(np.int32)
    dots = rng.integers(65533, 65536, (ah, aw, 16)).astype(np.uint16)
    want = np.asarray(jatlas.blit_frames(
        jnp.asarray(frames), jnp.asarray(pos), ah, aw,
        masks=jnp.asarray(masks), dots=jnp.asarray(dots)))
    got = kblit.blit_frames(to_torch(frames), to_torch(masks), to_torch(pos),
                            ah, aw, dots=tatlas.from_host(dots, "cpu"),
                            vote_polarity="zero")
    np.testing.assert_array_equal(tatlas.to_host(got, ah, aw), want)
    assert (want < dots).any()      # some counters wrapped


@pytest.mark.parametrize("width", [7, 8])
def test_nibbles_device_match_host(width):
    rng = np.random.default_rng(width)
    imgs = rng.integers(0, 16, (3, 5, width), dtype=np.uint8)
    packed = tstate.pack_nibbles_device(to_torch(imgs))
    np.testing.assert_array_equal(to_numpy(packed),
                                  jstate.pack_nibbles_batch(imgs))
    np.testing.assert_array_equal(
        to_numpy(tstate.unpack_nibbles_device(packed, width)), imgs)


def test_frame_store_mirror():
    """Donated device rows serve gathers while contiguous from frame 0;
    replacing a mirrored row drops the mirror (the host copy wins)."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 16, (6, 10, 12), dtype=np.uint8)
    packed = jstate.pack_nibbles_batch(imgs)
    store = tstate.FrameStore(10, 12, device="cpu")
    for lo in (0, 3):
        rows = list(range(lo, lo + 3))
        store.put_packed_batch(rows, packed[lo:lo + 3],
                               device_packed=to_torch(packed[lo:lo + 3]))
    assert store.mirrored == 6
    np.testing.assert_array_equal(
        to_numpy(store.device_packed_batch([4, 1, 5])), packed[[4, 1, 5]])
    store.put(2, imgs[0], imgs[0])
    assert not store.mirror_enabled
    np.testing.assert_array_equal(
        to_numpy(store.device_packed_batch([2])), packed[[0]])
    zero = tstate.FrameStore(10, 12, device_budget=0, device="cpu")
    zero.put_packed_batch([0], packed[:1], device_packed=to_torch(packed[:1]))
    assert not zero.mirror_enabled
