"""The port's copy of the NumPy spec (remap_tpu_torch.spec) vs the JAX
package's (remap_tpu.spec), exact (tolerance 0), each module on the same
seeded inputs; and the port's spec pipeline against the port's own map
build on the JAX end-to-end test's clip."""

import dataclasses

import numpy as np
import pytest

from remap_tpu.core.regions import make_layout as jmake_layout
from remap_tpu.spec import aws as jaws
from remap_tpu.spec import cte as jcte
from remap_tpu.spec import fde as jfde
from remap_tpu.spec import fdf as jfdf
from remap_tpu.spec import fgs as jfgs
from remap_tpu.spec import frc as jfrc
from remap_tpu.spec import kpe as jkpe
from remap_tpu.spec import kpm as jkpm
from remap_tpu.spec import pipeline as jpipeline
from remap_tpu.utils import testing
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.spec import aws as taws
from remap_tpu_torch.spec import cte as tcte
from remap_tpu_torch.spec import fde as tfde
from remap_tpu_torch.spec import fdf as tfdf
from remap_tpu_torch.spec import fgs as tfgs
from remap_tpu_torch.spec import frc as tfrc
from remap_tpu_torch.spec import kpe as tkpe
from remap_tpu_torch.spec import kpm as tkpm
from remap_tpu_torch.spec import pipeline as tpipeline


def _contours(res):
    return res.labels, [(c.id, c.color, c.area, dataclasses.astuple(c.bbox),
                         c.label, c.fill_left) for c in res.contours]


def _regions(regions):
    return [(r.points, r.counts) for r in regions]


def _extraction(res):
    return (res.median, res.weight,
            [(k.x, k.y, k.weight, k.code) for k in res.keypoints],
            _regions(res.regions))


def _fragment(frag):
    return (frag.dots, frag.zero, frag.step,
            [(r.number, r.position, r.image, r.median) for r in frag.frames])


def _assert_same(got, want, path="result"):
    """Deep equality of nested tuples, lists, dicts and arrays."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k}]")
    else:
        assert got == want, path


def _teleport_frames():
    """tests/test_spec_pipeline.py's splice clip: one world, two
    overlapping sweeps, a noise frame (a fragment break) between them,
    and two moving sprites on the second sweep."""
    rng = np.random.default_rng(11)
    world = testing.make_world(160, 224, rng)
    clip_a = testing.render_clip(world, [(20 + i, 30) for i in range(6)],
                                 (64, 96))
    clip_b = testing.render_clip(world, [(40 + i, 34) for i in range(6)],
                                 (64, 96), rng=rng, n_sprites=2,
                                 sprite_size=6)
    noise = rng.integers(0, 16, size=(64, 96), dtype=np.uint8)
    return clip_a.frames + [noise] + clip_b.frames


@pytest.fixture(scope="module")
def collected():
    """Both packages' ``frc.collect`` of the teleport clip."""
    frames = _teleport_frames()
    h, w = frames[0].shape
    return (frames,
            tfrc.collect(frames, make_layout(w, h, tfrc.GRID_W, tfrc.GRID_H,
                                             tfrc.OVERLAP)),
            jfrc.collect(frames, jmake_layout(w, h, jfrc.GRID_W, jfrc.GRID_H,
                                              jfrc.OVERLAP)))


@pytest.mark.parametrize("seed,colours", [(1, 2), (2, 4), (3, 16)])
def test_spec_cte_matches_jax(seed, colours):
    """Contour outlines (labels, ids, colours, areas, bboxes and the quirky
    fill lefts) with and without a predicate mask, and the foreground
    extraction built on them."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, colours, (23, 31), dtype=np.uint8)
    img[5:12, 4:20] = 0
    pred = rng.random((23, 31)) < 0.5
    _assert_same(_contours(tcte.extract(img)), _contours(jcte.extract(img)))
    _assert_same(_contours(tcte.extract(img, pred)),
                 _contours(jcte.extract(img, pred)))
    background = rng.integers(0, colours, (40, 50), dtype=np.uint8)
    background[9:32, 7:38] = np.where(pred, img, 0)
    got, kept = tfde.extract(background, img, img, (7, 9))
    want, wkept = jfde.extract(background, img, img, (7, 9))
    _assert_same(_contours(got), _contours(want))
    assert [c.label for c in kept] == [c.label for c in wkept]
    _assert_same(tfde.foreground_mask(got, kept, img.shape),
                 jfde.foreground_mask(want, wkept, img.shape))


def test_spec_kpe_and_kpm_match_jax():
    """Keypoint extraction on a clip's frames, the frame matcher on each
    consecutive pair (and on the noise break) and the cellular fragment
    matcher on two whole frames."""
    frames = _teleport_frames()[4:9]
    h, w = frames[0].shape
    tl, jl = make_layout(w, h, 4, 2, 16), jmake_layout(w, h, 4, 2, 16)
    got = [tkpe.extract(f, tl) for f in frames]
    want = [jkpe.extract(f, jl) for f in frames]
    for g, wt in zip(got, want):
        _assert_same(_extraction(g), _extraction(wt))
    declared = []
    for t in range(1, len(frames)):
        off = tkpm.match_frames(got[t - 1].regions, got[t].regions, 10)
        assert off == jkpm.match_frames(want[t - 1].regions, want[t].regions,
                                        10)
        declared.append(off)
    assert declared[0] is not None and None in declared
    one, jone = make_layout(w, h, 1, 1, 0), jmake_layout(w, h, 1, 1, 0)
    a, b = frames[0], frames[-1]
    mask = np.ones((h, w), np.uint8)
    assert tkpm.match_fragments(
        tkpe.extract(a, one).regions[0], mask,
        tkpe.extract(b, one).regions[0], mask, (24, 16)) == \
        jkpm.match_fragments(jkpe.extract(a, jone).regions[0], mask,
                             jkpe.extract(b, jone).regions[0], mask, (24, 16))


def test_spec_aws_scan_matches_jax():
    """The action-window scan on a clip with a HUD and a border: the same
    window, a ``WindowInfo`` of the port's own."""
    clip = testing.simple_clip(n_frames=40, frame_hw=(72, 96),
                               world_hw=(200, 260), seed=7, hud_rows=8,
                               border=4, max_step=4)
    got = taws.scan(iter(clip.frames))
    want = jaws.scan(iter(clip.frames))
    assert isinstance(got, taws.WindowInfo)
    assert dataclasses.astuple(got.raw_bounds) == \
        dataclasses.astuple(want.raw_bounds) == (4, 8, 91, 67)
    assert dataclasses.astuple(got.crop) == dataclasses.astuple(want.crop)
    assert taws.scan(iter([])) is None and jaws.scan(iter([])) is None


def test_spec_frc_collect_matches_jax(collected):
    """frc.collect across the teleport: three fragments (sweep A, the noise
    frame, sweep B) with equal canvases, origins and frame records."""
    _, got, want = collected
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same(_fragment(g), _fragment(w))


def test_spec_fgs_and_fdf_match_jax(collected):
    """fgs.splice rejoins the two sweeps; fdf.filter_fragments scrubs the
    sprites: equal fragments at each stage."""
    frames, got, want = collected
    got, want = tfgs.splice(got), jfgs.splice(want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same(_fragment(g), _fragment(w))
    got = tfdf.filter_fragments(got, frames[0].shape)
    want = jfdf.filter_fragments(want, frames[0].shape)
    for g, w in zip(got, want):
        _assert_same(_fragment(g), _fragment(w))


#: tests/test_pipeline_e2e.py's configuration and clip
E2E_CFG = PipelineConfig(screen_width=96, screen_height=72,
                         region_capacity=2048, splice_capacity=4096,
                         frame_batch=8)


def test_spec_pipeline_matches_jax_and_the_port_build():
    """The port's spec pipeline equals the JAX package's spec pipeline and
    the port's own map build (``builder.build_from_frames`` on the CPU)
    byte for byte on the JAX end-to-end test's clip."""
    clip = testing.simple_clip(n_frames=30, frame_hw=(72, 96),
                               world_hw=(200, 260), seed=7, hud_rows=8,
                               border=4, max_step=4, n_sprites=1,
                               sprite_size=5)
    got = tpipeline.build(clip.frames)
    want = jpipeline.build(clip.frames)
    assert len(got) == len(want) == 1
    _assert_same(got, want)
    built = builder.build_from_frames(clip.frames, E2E_CFG, device="cpu")
    _assert_same(list(built.maps), got)
    assert dataclasses.astuple(built.window.raw_bounds) == \
        dataclasses.astuple(taws.scan(iter(clip.frames)).raw_bounds)
