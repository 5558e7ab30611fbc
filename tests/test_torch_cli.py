"""The port's CLI (remap_tpu_torch.cli) in the process on the CPU against
the JAX package's: the maps of tests/test_cli.py's clip equal JAX's
``builder.build`` and the JAX CLI's files pixel for pixel (the JAX CLI
writes through Pillow where it is installed, so PNG bytes may differ),
and so do those of the three gameplay genres and a worn session at
160x120; resume through the CLI, PNG input, and every exit code."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from remap_tpu import cli as jcli
from remap_tpu.config import PipelineConfig as JPipelineConfig
from remap_tpu.core import palette as jpalette
from remap_tpu.io import frames as jframes
from remap_tpu.pipeline import builder as jbuilder
from remap_tpu.utils import testing
from remap_tpu_torch import cli
from remap_tpu_torch.core import palette as tpalette
from remap_tpu_torch.io import png

from torch_parity import build_jax_native

build_jax_native()

ROOT = Path(__file__).resolve().parent.parent
#: tests/test_cli.py's flags for its clip
FLAGS = ["--width", "96", "--height", "72", "--frame-batch", "8",
         "--region-capacity", "2048"]


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    clip = testing.simple_clip(
        n_frames=24, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4,
    )
    for i, f in enumerate(clip.frames):
        f.tofile(d / str(i))
    return d


@pytest.fixture(scope="module")
def jax_maps(clip_dir):
    """JAX's builder on JAX's feed at the JAX CLI's configuration for
    FLAGS."""
    cfg = JPipelineConfig(screen_width=96, screen_height=72, frame_batch=8,
                          region_capacity=2048, vote_radius=16,
                          splice_capacity=2048)
    feed = jframes.RawDirectoryFeed(str(clip_dir), 96, 72)
    return [np.asarray(m) for m in jbuilder.build(lambda: feed, cfg).maps]


def _run(capsys, *args):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _maps_written(prefix, stdout):
    paths = [line.split()[1] for line in stdout.splitlines()
             if line.startswith("wrote ")]
    assert paths == [f"{prefix}{i}.png" for i in range(1, len(paths) + 1)]
    return [png.decode_png(p) for p in paths]


def test_cli_maps_equal_jax(clip_dir, jax_maps, tmp_path, capsys):
    prefix = str(tmp_path / "map")
    rc, out, err = _run(capsys, clip_dir, "--cpu", *FLAGS, "--out-prefix",
                        prefix)
    assert rc == 0, err
    got = _maps_written(prefix, out)
    assert len(got) == len(jax_maps) >= 1
    for g, m in zip(got, jax_maps):
        np.testing.assert_array_equal(g, jpalette.native_to_rgb(m))
        assert f"({m.shape[1]}x{m.shape[0]})" in out
    # the JAX CLI's own files, pixel for pixel
    jprefix = str(tmp_path / "jmap")
    assert jcli.main([str(clip_dir), "--cpu", *FLAGS, "--out-prefix",
                      jprefix]) == 0
    for i, g in enumerate(got, start=1):
        np.testing.assert_array_equal(png.decode_png(f"{jprefix}{i}.png"), g)


GENRE_HW = (120, 160)


def _genre_session(genre):
    from remap_tpu.utils import gameplay, wear

    args = dict(n_frames=60, frame_hw=GENRE_HW, hud_rows=16, border=8)
    if genre == "topdown":
        return gameplay.play_topdown_session(seed=2, **args)
    if genre == "shmup":
        return gameplay.play_shmup_session(seed=1, **args)
    session = gameplay.play_session(seed=5, **args)
    if genre == "worn":
        session = wear.worn(session, seed=11, speck_region=(10, 90, 10, 150))
    return session


@pytest.mark.parametrize("genre", ["platformer", "topdown", "shmup", "worn"])
def test_cli_gameplay_sessions_equal_jax(genre, tmp_path, capsys):
    """The three gameplay genres and a worn session, as raw dumps: the
    port's CLI writes JAX's maps."""
    h, w = GENRE_HW
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(_genre_session(genre).frames):
        f.tofile(frames_dir / str(i))
    flags = ["--width", w, "--height", h, "--frame-batch", 16]
    prefix = str(tmp_path / "map")
    rc, out, err = _run(capsys, frames_dir, "--cpu", *flags, "--out-prefix",
                        prefix)
    assert rc == 0, err
    cfg = JPipelineConfig(screen_width=w, screen_height=h, frame_batch=16,
                          region_capacity=768, vote_radius=16,
                          splice_capacity=2048)
    feed = jframes.RawDirectoryFeed(str(frames_dir), w, h)
    want = jbuilder.build(lambda: feed, cfg).maps
    got = _maps_written(prefix, out)
    assert len(got) == len(want) >= 1
    for g, m in zip(got, want):
        np.testing.assert_array_equal(g, jpalette.native_to_rgb(
            np.asarray(m)))


@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_cli_matcher_families_equal_jax(family, clip_dir, tmp_path, capsys):
    """``--matcher xcorr|pyramid``: the port's CLI writes the maps of JAX's
    ``builder.build`` under the family and the JAX CLI's files."""
    prefix = str(tmp_path / "map")
    rc, out, err = _run(capsys, clip_dir, "--cpu", *FLAGS, "--matcher",
                        family, "--out-prefix", prefix)
    assert rc == 0, err
    cfg = JPipelineConfig(screen_width=96, screen_height=72, frame_batch=8,
                          region_capacity=2048, vote_radius=16,
                          splice_capacity=2048, matcher=family)
    feed = jframes.RawDirectoryFeed(str(clip_dir), 96, 72)
    want = jbuilder.build(lambda: feed, cfg).maps
    got = _maps_written(prefix, out)
    assert len(got) == len(want) >= 1
    for g, m in zip(got, want):
        np.testing.assert_array_equal(g, jpalette.native_to_rgb(
            np.asarray(m)))
    jprefix = str(tmp_path / "jmap")
    assert jcli.main([str(clip_dir), "--cpu", *FLAGS, "--matcher", family,
                      "--out-prefix", jprefix]) == 0
    for i, g in enumerate(got, start=1):
        np.testing.assert_array_equal(png.decode_png(f"{jprefix}{i}.png"), g)


def test_cli_checkpoints_and_resume(clip_dir, jax_maps, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    prefix = str(tmp_path / "map")
    args = [clip_dir, "--cpu", *FLAGS, "--checkpoint-dir", ckpt,
            "--out-prefix", prefix, "--perf"]
    rc, out, err = _run(capsys, *args)
    assert rc == 0, err
    stages = [ln.split("]")[0] + "]" for ln in out.splitlines()
              if ln.startswith("[")]
    assert sorted(stages) == sorted(["[aws]", "[frc]", "[fgs]", "[fdf]",
                                     "[arf]", "[checkpoint collect]",
                                     "[checkpoint filtered]"])
    for resumed in ("filtered", "collect"):
        if resumed == "collect":
            for f in (ckpt / "filtered").iterdir():
                f.unlink()
            (ckpt / "filtered").rmdir()
        rc, out, err = _run(capsys, *args, "--resume")
        assert rc == 0, err
        for g, m in zip(_maps_written(prefix, out), jax_maps):
            np.testing.assert_array_equal(g, jpalette.native_to_rgb(m))


def test_cli_png_frames_equal_raw(clip_dir, tmp_path, capsys):
    png_dir = tmp_path / "png"
    png_dir.mkdir()
    for f in clip_dir.iterdir():
        img = np.fromfile(f, dtype=np.uint8).reshape(72, 96)
        png.write_map(str(png_dir / f"{f.name}.png"), img)
    raw_prefix, png_prefix = str(tmp_path / "raw"), str(tmp_path / "png")
    rc, raw_out, err = _run(capsys, clip_dir, "--cpu", *FLAGS,
                            "--out-prefix", raw_prefix)
    assert rc == 0, err
    rc, png_out, err = _run(capsys, png_dir, "--cpu", "--format", "png",
                            *FLAGS[4:], "--out-prefix", png_prefix)
    assert rc == 0, err
    raw, from_png = (_maps_written(raw_prefix, raw_out),
                     _maps_written(png_prefix, png_out))
    assert len(raw) == len(from_png) >= 1
    for a, b in zip(raw, from_png):
        np.testing.assert_array_equal(a, b)


def test_cli_custom_palette(clip_dir, tmp_path, capsys):
    """--palette re-derives the tables and the PNG colours, as the JAX
    CLI's (tests/test_cli.py)."""
    prefix = str(tmp_path / "ega")
    try:
        rc, out, err = _run(capsys, clip_dir, "--cpu", *FLAGS, "--palette",
                            "ega", "--out-prefix", prefix)
        ega = {tuple(c) for c in tpalette.NATIVE_TO_RGB.tolist()}
    finally:
        tpalette.set_palette("c64")
    assert rc == 0, err
    colors = {tuple(c) for c in _maps_written(prefix, out)[0].reshape(-1, 3)}
    assert colors <= ega
    assert not colors <= {tuple(c) for c in tpalette.NATIVE_TO_RGB.tolist()}


@pytest.mark.parametrize("case", ["no_frames", "missing_dir", "palette",
                                  "distributed", "coordinator", "xcorr",
                                  "pyramid", "no_window"])
def test_cli_exit_codes(case, tmp_path, capsys):
    static = tmp_path / "static"
    static.mkdir()
    for i in range(10):
        np.full((72, 96), 3, np.uint8).tofile(static / str(i))
    args, code, message = {
        "no_frames": ([tmp_path / "static" / ".." / "empty"], 1,
                      "no frames"),
        "missing_dir": (["/definitely/not/a/dir"], 1, "cannot read frames"),
        "palette": ([static, "--palette", "nope"], 1, "unknown palette"),
        "distributed": ([static, "--distributed"], 1, "not ported"),
        "coordinator": ([static, "--coordinator", "h:1"], 1, "not ported"),
        "xcorr": ([static, *FLAGS, "--matcher", "xcorr"], 2,
                  "no action window found"),
        "pyramid": ([static, *FLAGS, "--matcher", "pyramid"], 2,
                    "no action window found"),
        "no_window": ([static, *FLAGS], 2, "no action window found"),
    }[case]
    (tmp_path / "empty").mkdir()
    rc, out, err = _run(capsys, *args, "--cpu")
    assert rc == code
    assert message in err
    assert "wrote" not in out
    if case in ("xcorr", "pyramid"):
        # the JAX CLI's exit on the same static frames
        assert jcli.main([str(a) for a in args] + ["--cpu"]) == 2


def test_cli_needs_cuda_unless_asked_for_cpu(clip_dir, capsys):
    """Without --cpu the CLI runs on the card: with none it exits 1, in
    the process and as ``python -m remap_tpu_torch.cli``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run(capsys, clip_dir, *FLAGS)
    assert rc == 1 and "CUDA" in err and "wrote" not in out
    proc = subprocess.run(
        [sys.executable, "-m", "remap_tpu_torch.cli", str(clip_dir), *FLAGS],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1 and "CUDA" in proc.stderr
