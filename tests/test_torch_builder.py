"""Port map builder (remap_tpu_torch.pipeline.builder) vs the JAX package's:
the maps byte for byte, the window, the spliced and filtered fragments
and the order of the stage callbacks; checkpoints and natively cropping
feeds against the plain build."""

import dataclasses

import numpy as np
import pytest

from remap_tpu.pipeline import builder as jbuilder
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.pipeline import builder as tbuilder

from torch_parity import jax_twin

#: tests/test_pipeline_e2e.py's setup
CFG = PipelineConfig(screen_width=96, screen_height=72, region_capacity=2048,
                     splice_capacity=4096, frame_batch=8)


def _e2e_clip():
    return testing.simple_clip(
        n_frames=30, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4, n_sprites=1, sprite_size=5,
    ).frames


def _splice_clip():
    """test_splice_merges_like_spec's frames under an 8-row HUD: two
    clips of one world split by a noise frame."""
    rng = np.random.default_rng(11)
    world = testing.make_world(160, 224, rng)
    clips = [testing.render_clip(world, [(x0 + i, y0) for i in range(8)],
                                 (72, 96), hud_rows=8, border=4).frames
             for x0, y0 in ((20, 30), (40, 34))]
    noise = rng.integers(0, 16, size=(72, 96), dtype=np.uint8)
    noise[:8] = clips[0][0][:8]
    noise[:, :4] = clips[0][0][:, :4]
    noise[:, -4:] = clips[0][0][:, -4:]
    noise[-4:] = clips[0][0][-4:]
    return clips[0] + [noise] + clips[1]


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.calls = []

        def on_window(self, window):
            self.calls.append("window")

        def on_collect(self, result):
            self.calls.append(f"collect {len(result.fragments)}")

        def on_splice(self, fragments):
            self.calls.append(f"splice {len(fragments)}")

        def on_filter(self, fragments):
            self.calls.append(f"filter {len(fragments)}")

        def on_clean(self, images):
            self.calls.append(f"clean {len(images)}")

    return Recorder()


@pytest.mark.parametrize("clip", ["e2e", "splice"])
def test_build_from_frames_matches_jax(clip):
    frames = _e2e_clip() if clip == "e2e" else _splice_clip()
    jcb, tcb = _recorder(jbuilder.Callbacks), _recorder(tbuilder.Callbacks)
    want = jbuilder.build_from_frames(frames, jax_twin(CFG), callbacks=jcb)
    got = tbuilder.build_from_frames(frames, CFG, callbacks=tcb,
                                     device="cpu")
    assert tcb.calls == jcb.calls
    assert convert.window_to_numpy(got.window) == convert.window_to_numpy(
        want.window)
    assert len(got.maps) == len(want.maps) >= 1
    for g, w in zip(got.maps, want.maps):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert g.tobytes() == np.asarray(w).tobytes()
    for g, w in zip(got.fragments, want.fragments):
        g, w = convert.fragment_to_numpy(g), convert.fragment_to_numpy(w)
        assert g.frames == w.frames
        np.testing.assert_array_equal(g.dots, w.dots)
    if clip == "splice":
        assert jcb.calls[1:3] == ["collect 3", "splice 2"]


def test_static_clip_gives_no_maps():
    frames = [np.full((48, 64), 3, np.uint8)] * 10
    res = tbuilder.build_from_frames(frames, CFG, device="cpu")
    assert res.maps == [] and res.window is None and res.collect is None


@pytest.mark.parametrize("kwargs", [{"checkpoint_dir": "ckpt"},
                                    {"resume": True}])
def test_checkpoints_are_not_ported(kwargs, tmp_path):
    """Stage checkpoints run now: a build that saves them, or asks to
    resume with no directory, gives the plain build's maps (resume itself
    is tested in tests/test_torch_io.py)."""
    frames = _e2e_clip()
    if "checkpoint_dir" in kwargs:
        kwargs = {"checkpoint_dir": str(tmp_path / kwargs["checkpoint_dir"])}
    got = tbuilder.build_from_frames(frames, CFG, device="cpu", **kwargs)
    want = tbuilder.build_from_frames(frames, CFG, device="cpu")
    assert [m.tobytes() for m in got.maps] == [m.tobytes() for m in want.maps]
    if "checkpoint_dir" in kwargs:
        for tag in ("collect", "filtered"):
            assert (tmp_path / "ckpt" / tag / "meta.json").exists()


def test_native_crop_feeds_are_not_ported():
    """A feed that crops natively (``with_crop``) is re-fed through it
    with the window's crop, to the maps of plain frames."""
    frames = _e2e_clip()
    crops = []

    class Feed(list):
        def with_crop(self, rect):
            crops.append(rect)
            return [f[rect.top:rect.bottom, rect.left:rect.right]
                    for f in self]

    got = tbuilder.build(lambda: Feed(frames), CFG, device="cpu")
    want = tbuilder.build_from_frames(frames, CFG, device="cpu")
    assert crops == [want.window.crop]
    assert [m.tobytes() for m in got.maps] == [m.tobytes() for m in want.maps]


def test_perf_callbacks_print_every_stage(capsys):
    frames = _e2e_clip()
    tbuilder.build_from_frames(frames, dataclasses.replace(CFG),
                               callbacks=tbuilder.PerfCallbacks(),
                               device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] + "]" for ln in lines] == [
        "[aws]", "[frc]", "[fgs]", "[fdf]", "[arf]"]
    assert "fps" in lines[1] and "fps" in lines[3]
