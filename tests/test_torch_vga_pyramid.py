"""The ``vga_pyramid`` configuration of the port's benchmark: the port's
``match_pyramid`` against the plain rule of ``port_bench/reference/
pyramid.py``, the ``vga_pyramid_break`` cell cut to a CPU size through
its ``pyramid_build`` driver (``correct``, and a wrong pair seen), the
pyramid's spans and counters in a build, their readers, and the cell's
files and metrics as the harness finds them."""

import ast
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from port_bench import harness, traffic
from port_bench.drivers import pyramid_build
from port_bench.reference import pyramid as ref_pyramid
from port_bench.tests import small
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.models import pyramid
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.utils import clips, profiling

torch.set_num_threads(2)

CELL = "vga_pyramid_break"
READERS = ["pyramid_coarse_ms.map", "pyramid_fine_ms.map"]


def _session_pairs(h, w, seed):
    """(prev, curr) ``[B, h', w']`` uint8: the cropped frames of a
    ``traffic.render`` session with a noise frame at 10, then a frame
    of one colour twice (the last two pairs)."""
    hud, border = 8, 4
    s = traffic.render(24, h, w, seed, path_seed=12, margin=200, max_step=6,
                       sprites=2, sprite_size=5, hud_rows=hud,
                       border=border, noise_at=10)
    frames = s.frames[:, hud + 1:h - border - 2, border + 1:w - border - 2]
    flat = np.full((2,) + frames.shape[1:], 3, np.uint8)
    t = torch.as_tensor(np.concatenate([frames, flat]))
    return t[:-1], t[1:], np.asarray(s.path)


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 7])
@pytest.mark.parametrize("h,w", [(120, 160), (96, 128)])
def test_match_pyramid_equals_the_reference(h, w, seed):
    prev, curr, path = _session_pairs(h, w, seed)
    got_off, got_ok = pyramid.match_pyramid(prev, curr)
    want_off, want_ok = ref_pyramid.match(prev, curr)
    np.testing.assert_array_equal(got_off.numpy(), want_off.numpy())
    np.testing.assert_array_equal(got_ok.numpy(), want_ok.numpy())
    # the rule rejects the pairs around the noise frame, the pair into
    # the flat frame and the flat pair, and finds the camera elsewhere
    n = len(path) - 1
    assert (~want_ok).nonzero().flatten().tolist() == [9, 10, n, n + 1]
    steps = path[1:] - path[:-1]
    ok = want_ok[:n].numpy()
    np.testing.assert_array_equal(want_off[:n].numpy()[ok], steps[ok])


@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """The cell at ``port_bench/tests/small.py``'s CPU size after its
    window: (driver, limits)."""
    _, _, config, workload = small.cell(CELL)
    drv = pyramid_build.Driver(config, workload["traffic"], 2 ** 31 + 11,
                               "cpu", str(tmp_path_factory.mktemp("vga")),
                               False)
    drv.setup()
    drv.window(0.5)
    return drv, workload["limits"]


def _correct(checks, limits):
    """The harness's rule (``harness.run_cell``)."""
    return set(checks) == set(limits) and all(
        checks[k] <= limits[k] for k in limits)


def test_cell_reads_correct(windowed):
    drv, limits = windowed
    checks = drv.check()
    assert "pairs_wrong" in limits
    assert _correct(checks, limits), checks
    assert drv.failed_builds == 0
    # the break: both pairs around the noise frame unmatched
    noise = drv.session.noise_at
    matched = drv.builds[-1]["matched"]
    assert not matched[noise] and not matched[noise + 1]
    assert matched[1:noise].all() and matched[noise + 2:].all()


@pytest.mark.parametrize("fault", ["offset", "flag"])
def test_cell_sees_a_wrong_pair(windowed, fault):
    drv, limits = windowed
    last = drv.builds[-1]
    kept = copy.deepcopy(last)
    try:
        i = 3
        if fault == "offset":
            last["offsets"][i, 0] += 1
        else:
            last["matched"][i] = not last["matched"][i]
        checks = drv.check()
    finally:
        drv.builds[-1] = kept
    assert checks["pairs_wrong"] == 1
    assert not _correct(checks, limits)
    assert drv.failed_builds >= 1


@pytest.fixture
def fresh(monkeypatch):
    """An empty store in place of the process's, recording on."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def test_build_records_the_pyramid_levels(fresh):
    n_frames, batch = 24, 8
    frames = clips.simple_clip(
        n_frames=n_frames, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4, n_sprites=1, sprite_size=5).frames
    cfg = PipelineConfig(screen_width=96, screen_height=72,
                         region_capacity=2048, splice_capacity=4096,
                         frame_batch=batch, matcher="pyramid")
    for _ in range(2):
        builder.build_from_frames(frames, cfg, device="cpu")
    record = profiling.recorder()[-1]
    spans = record.spans
    passes = [s for s in spans if s.name == "collect.pass"]
    assert [s.attrs["rung"] for s in passes] == [0]
    batches = -(-n_frames // batch)
    for name in ("pyramid.coarse", "pyramid.fine"):
        levels = [s for s in spans if s.name == name]
        assert len(levels) == batches, name
        assert {s.parent for s in levels} == {passes[0].id}
        assert all(s.events is None for s in levels)   # the CPU
    # every batch's pairs, the first against the empty carry and the
    # last padded: one a frame when the batch divides the clip
    pairs = batches * batch
    assert record.counters["pyramid.pairs"] == pairs == n_frames
    assert passes[0].counts["pyramid.pairs"] == pairs
    # the pyramid names its own match: the pass holds no collect.match
    assert {s.parent for s in spans if s.name in (
        "collect.upload", "collect.features", "collect.scalars")} == {
            passes[0].id}
    assert not any(s.name == "collect.match" for s in spans)
    # no CUDA events on the CPU: nothing to read
    for name in READERS:
        assert harness.reader(name)({"builds": 1}) is None


def test_readers_take_device_ms_under_the_first_pass(fresh, monkeypatch):
    """The readers sum each window build's spans under ``collect.pass``
    (and only those) and average over the builds."""
    ms = {}

    def device_ms(span):
        return ms.get(span.id)

    monkeypatch.setattr(profiling.Span, "device_ms", device_ms)
    sums = []
    for build in range(3):
        with profiling.span("build"):
            with profiling.span("collect.pass", rung=0):
                for i in range(2):
                    for name in ("pyramid.coarse", "pyramid.fine"):
                        with profiling.span(name) as s:
                            ms[s.id] = 10.0 * build + i + (
                                0.5 if name == "pyramid.fine" else 0.0)
            with profiling.span("splice"):
                with profiling.span("pyramid.coarse") as s:
                    ms[s.id] = 1000.0
        sums.append((20.0 * build + 1, 20.0 * build + 2))
    coarse, fine = (harness.reader(n) for n in READERS)
    # the window: the builds before the last (the profiled one)
    assert coarse({"builds": 2}) == pytest.approx((sums[0][0] + sums[1][0])
                                                  / 2)
    assert fine({"builds": 1}) == pytest.approx(sums[1][1])
    assert coarse({"builds": 3}) is None         # too few roots
    # a build in which one span has no events reads None
    ms.pop(next(s.id for s in profiling.recorder()[1].spans
                if s.name == "pyramid.fine"))
    assert fine({"builds": 2}) is None
    assert coarse({"builds": 2}) is not None


def test_harness_finds_the_cell():
    root = small.ROOT
    bench, entry, config, workload = harness.cell_files(root, CELL)
    assert entry["config"] == "vga_pyramid" and entry["chips"] == 1
    assert workload["driver"] == "pyramid_build"
    assert workload["traffic"]["noise_at"] == 1000
    pipeline = dict(config["pipeline"])
    assert (pipeline.pop("screen_width"), pipeline.pop("screen_height"),
            pipeline.pop("matcher")) == (640, 480, "pyramid")
    default = dataclasses.asdict(PipelineConfig())
    assert pipeline == {k: default[k] for k in pipeline}
    assert set(config["pipeline"]) == set(harness.load_json(os.path.join(
        root, "port_bench", "configs", "c64_session.json"))["pipeline"])
    e2e = [m["name"] for m in harness.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["map_fps", "setup_s"]
    per_layer = {m["name"]
                 for m in harness.metrics_of(bench, CELL, "per_layer")}
    assert per_layer == {
        "window_ms.map", "collect_ms.map", "splice_ms.map",
        "foreground_ms.map", "clean_ms.map", "idle_share.map",
        "peak_gib.map", "first_pass_ms.map", "batch_prep_ms.map",
        "drain_wait_ms.map", "splice_match_ms.map", "splice_matches.map",
        "splice_merges.map", "feed_read_ms.map", "feed_frames.map",
        "foreground_labels_ms.map", "foreground_masks_ms.map",
        "foreground_blit_ms.map"} | set(READERS)
    for name in READERS:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert (entry["layer"], entry["moves"], entry["workloads"]) == (
            "collect", "map_fps", [CELL])
        assert callable(harness.reader(name))


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(harness.HERE, "reference", "pyramid.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert {n.split(".")[0] for n in names} == {"__future__", "typing",
                                               "torch"}
