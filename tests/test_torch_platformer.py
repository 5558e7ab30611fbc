"""The ``c64_platformer`` configuration of the port's benchmark: a C64
side-scroller's tile-built world rebuilt at the CLI's own defaults
(``port_bench/platformer.py``).  At a CPU size (160x120, 96 frames in
batches of 16, a 40-column level): the recipe against the gameplay
simulator it copies, the camera path fixed by ``path_seed``, the
bottom-bar crop rule against the spec's window scan, the map build
against the JAX package's and the plain reference's votes (one fragment,
offsets at the camera's deltas), collect's join rung and its flag
counters, the configuration against the CLI's no-flag settings, the
``c64_platformer_scroll`` cell through its driver, and the two new
readers."""

import copy

import numpy as np
import pytest
import torch

from port_bench import harness, platformer
from port_bench.drivers import platformer_build
from port_bench.reference import bottom_bar
from port_bench.reference import maps as ref
from port_bench.tests import small
from remap_tpu.pipeline import builder as jbuilder
from remap_tpu_torch import cli, convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.spec import aws
from remap_tpu_torch.utils import gameplay, profiling

from torch_parity import jax_twin

torch.set_num_threads(2)

CELL = "c64_platformer_scroll"
READERS = ["join_flagged_pairs.map", "join_rungs_ms.map"]
SEED = 2 ** 31 + 23
FLAGS = ("collect.table_flagged", "collect.join_flagged",
         "collect.range_flagged")


def _cut(frames=96):
    """(benchmark, cell, configuration, workload) of the cell at a CPU
    size: 160x120 frames in batches of 16 at the CLI's other defaults,
    ``frames`` frames of a 40-column level (16 rows: ``play_session``'s
    rule, the play area's tile rows and 11)."""
    bench, entry, config, workload = harness.cell_files(small.ROOT, CELL)
    config = copy.deepcopy(config)
    config["pipeline"].update(screen_width=160, screen_height=120,
                              frame_batch=16)
    config["session"].update(frames=frames, level_cols=40, level_rows=16)
    return bench, entry, config, workload


def _cfg(config) -> PipelineConfig:
    return PipelineConfig(**config["pipeline"])


def _crop(config):
    s, p = config["session"], config["pipeline"]
    return bottom_bar.expected_crop(p["screen_height"], p["screen_width"],
                                    s["bar_rows"], s["border"])


# ---- the recipe -----------------------------------------------------------

def test_recipe_copies_the_simulator():
    """The tiles, the level, the inputs, the sprites and the font are the
    gameplay simulator's, draw for draw."""
    for make_a, make_b, args in (
            (platformer.make_tileset, gameplay.make_tileset, ()),
            (platformer.make_level, gameplay.make_level, (60, 16)),
            (platformer._policy, gameplay._policy, (300,))):
        a = make_a(np.random.default_rng(9), *args)
        b = make_b(np.random.default_rng(9), *args)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert platformer.SOLID == tuple(sorted(gameplay.SOLID))
    for a, b in ((platformer.PLAYER_FRAMES, gameplay.PLAYER_FRAMES),
                 (platformer.ENEMY_FRAMES, gameplay.ENEMY_FRAMES)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert platformer._FONT == gameplay._FONT
    # the simulator's status bar below its play area, but for the
    # score's digits (columns 60-107), which the seeds draw
    s = platformer.render(24, 312, 388, SEED, 5, 40, 28, 24, 8, 3)
    sim = np.asarray(gameplay.play_session(
        seed=1, n_frames=24, frame_hw=(312, 388), level_cols=40).frames)
    for cols in (slice(0, 60), slice(108, 388)):
        np.testing.assert_array_equal(s.frames[:, -24:, cols],
                                      sim[:, -24:, cols])
    x0, y0, x1, y1 = platformer.action_window(312, 388, 24, 8)
    chrome = s.frames[:, :-24].copy()
    chrome[:, y0:y1, x0:x1] = 14
    assert (chrome == 14).all()


def test_camera_path_is_the_path_seeds():
    _, _, config, _ = _cut()
    s = platformer.make(config, SEED)
    assert s.frames.shape == (96, 120, 160) and s.noise_at is None
    steps = np.diff(np.asarray(s.path), axis=0)
    assert set(steps[:, 0].tolist()) <= {0, 1, 2, 3}
    assert np.abs(steps[:, 1]).max() <= 2
    assert steps[:, 0].sum() > 0
    other = platformer.make(config, SEED + 1)
    assert other.path == s.path
    assert not np.array_equal(other.frames, s.frames)
    np.testing.assert_array_equal(platformer.make(config, SEED).frames,
                                  s.frames)
    moved = copy.deepcopy(config)
    moved["session"]["path_seed"] += 1
    assert platformer.make(moved, SEED).path != s.path
    with pytest.raises(ValueError):
        platformer.make({**config, "session": {**config["session"],
                                               "recipe": "render"}}, SEED)


def test_bottom_bar_crop_is_the_spec_window():
    _, _, config, _ = _cut(frames=48)
    s = platformer.make(config, SEED)
    c = aws.scan(iter(s.frames)).crop
    assert (c.left, c.top, c.right, c.bottom) == _crop(config)


# ---- the map build --------------------------------------------------------

class _Spliced(builder.Callbacks):
    def on_splice(self, fragments):
        self.spliced = fragments


@pytest.fixture(scope="module")
def built():
    """The cut through ``builder.build_from_frames`` on the CPU:
    (configuration, session, spliced fragments, result, its record)."""
    _, _, config, _ = _cut()
    s = platformer.make(config, SEED)
    rec = profiling.Recorder()
    real = profiling._RECORDER
    profiling._RECORDER = rec
    try:
        cb = _Spliced()
        res = builder.build_from_frames(list(s.frames), _cfg(config),
                                        callbacks=cb, device="cpu")
    finally:
        profiling._RECORDER = real
    return config, s, cb.spliced, res, rec.records("build")[-1]


def test_build_gives_one_fragment_at_the_cameras_deltas(built):
    config, s, spliced, res, _ = built
    w = res.window.crop
    assert (w.left, w.top, w.right, w.bottom) == _crop(config)
    want_off, want_matched = ref.expected_motion(s.path, None)
    np.testing.assert_array_equal(res.collect.matched, want_matched)
    np.testing.assert_array_equal(res.collect.offsets[1:], want_off[1:])
    assert res.collect.overflow_frames == 0
    assert len(res.collect.fragments) == len(spliced) == len(res.maps) == 1
    left, top, right, bottom = _crop(config)
    cropped = torch.as_tensor(np.ascontiguousarray(
        s.frames[:, top:bottom, left:right]))
    [frag] = spliced
    nums = [r.number for r in frag.frames]
    assert nums == list(range(len(s.frames)))
    pos = np.array([r.position for r in frag.frames]).reshape(-1, 2)
    assert len({tuple(p) for p in pos - np.asarray(s.path)}) == 1
    want = ref.vote_canvas(cropped, pos - np.asarray(frag.zero), frag.shape)
    got = torch.as_tensor(np.asarray(frag.dots, np.int64)).permute(2, 0, 1)
    assert torch.equal(got, want)


def test_build_equals_jax(built):
    config, s, _, res, _ = built
    want = jbuilder.build_from_frames(list(s.frames), jax_twin(_cfg(config)))
    assert convert.window_to_numpy(res.window) == convert.window_to_numpy(
        want.window)
    np.testing.assert_array_equal(res.collect.offsets,
                                  np.asarray(want.collect.offsets))
    np.testing.assert_array_equal(res.collect.matched,
                                  np.asarray(want.collect.matched))
    assert len(res.maps) == len(want.maps) == 1
    for g, w in zip(res.maps, want.maps):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_join_rung_and_its_flag_counters(built):
    """The first pass at multiplicity 4 flags the pairs whose tile codes
    repeat past it; the rung that takes them is a join rung, and the
    three counters of each pass add up to the pairs it left flagged."""
    config, s, _, _, record = built
    passes = [sp for sp in record.spans
              if sp.name in ("collect.pass", "collect.repair")]
    first, rungs = passes[0], passes[1:]
    assert first.attrs["rung"] == 0 and "limit" not in first.attrs
    assert first.counts["collect.join_flagged"] > 0
    assert rungs and all(sp.attrs["limit"] == "multiplicity"
                         and sp.attrs["multiplicity"] == 16 for sp in rungs)
    assert all(set(FLAGS) <= set(sp.counts) for sp in passes)
    assert sum(rungs[-1].counts[k] for k in FLAGS) == 0
    assert record.counters["collect.join_flagged"] == (
        first.counts["collect.join_flagged"])
    # the pairs the first pass flags, worked out from its own flags
    cfg = _cfg(config)
    left, top, right, bottom = _crop(config)
    cropped = s.frames[:, top:bottom, left:right]
    layout = make_layout(right - left, bottom - top, cfg.grid_width,
                         cfg.grid_height, cfg.grid_overlap)
    _, _, *flags = tcollect.match_pass(iter(cropped), layout, cfg,
                                       device=torch.device("cpu"))
    ptab, pjoin, prange, _ = tcollect._pair_flags(*flags)
    assert sum(first.counts[k] for k in FLAGS) == int(
        (ptab | pjoin | prange).sum())
    assert first.counts["collect.table_flagged"] == int(ptab.sum())


def test_pipeline_block_is_the_clis_no_flag_settings(tmp_path):
    _, _, config, _ = harness.cell_files(small.ROOT, CELL)
    args = cli.make_parser().parse_args([str(tmp_path)])
    assert PipelineConfig(**config["pipeline"]) == cli.pipeline_config(args)
    p = config["pipeline"]
    assert (p["region_capacity"], p["vote_radius"]) == (768, 16)
    assert (p["screen_width"], p["screen_height"]) == (388, 312)


# ---- the cell's driver ----------------------------------------------------

@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """The cell at the CPU size after its window: (driver, limits)."""
    _, _, config, workload = _cut()
    drv = platformer_build.Driver(config, workload["traffic"], SEED, "cpu",
                                  str(tmp_path_factory.mktemp("plat")),
                                  False)
    drv.setup()
    drv.window(0.0)
    return drv, workload["limits"]


def _correct(checks, limits):
    """The harness's rule (``harness.run_cell``)."""
    return set(checks) == set(limits) and all(
        checks[k] <= limits[k] for k in limits)


def test_cell_reads_correct(windowed):
    drv, limits = windowed
    checks = drv.check()
    assert _correct(checks, limits), checks
    assert drv.failed_builds == 0


@pytest.mark.parametrize("fault", ["crop", "offset", "split"])
def test_cell_sees_a_fault(windowed, fault):
    drv, limits = windowed
    kept_build, kept_spliced = copy.deepcopy(drv.builds[-1]), drv.spliced
    last = drv.builds[-1]
    try:
        if fault == "crop":
            # the rule for a bar at the top, which this capture lacks
            h, w = drv.session.frames.shape[1:]
            last["crop"] = ref.expected_crop(h, w, 24, 8)
        elif fault == "offset":
            last["offsets"][40] += (3, 0)
        else:
            halves = [copy.copy(drv.spliced[0]) for _ in range(2)]
            halves[0].frames = halves[0].frames[:48]
            halves[1].frames = halves[1].frames[48:]
            drv.spliced = halves
        checks = drv.check()
    finally:
        drv.builds[-1], drv.spliced = kept_build, kept_spliced
    wrong = {"crop": "crop_wrong", "offset": "offsets_wrong",
             "split": "fragments_wrong"}[fault]
    assert checks[wrong] >= 1
    assert not _correct(checks, limits)
    assert drv.failed_builds >= 1


def test_traced_run_reads_the_ladder_metrics(tmp_path):
    """A traced run's per-layer metrics, read as ``harness.run_cell``
    reads them."""
    bench, _, config, workload = _cut(frames=48)
    drv = platformer_build.Driver(config, workload["traffic"], SEED, "cpu",
                                  str(tmp_path), True)
    drv.setup()
    drv.window(0.0)
    drv.profile()
    assert _correct(drv.check(), workload["limits"])
    m = {}
    for metric in harness.metrics_of(bench, CELL, "per_layer"):
        value = harness.reader(metric["name"])(drv.observations)
        if value is not None:
            m[metric["name"]] = value
    assert m["join_flagged_pairs.map"] > 0
    assert m["rematched_frames.map"] == 48
    assert m["rungs_ms.map"] > 0
    assert m["collect_dispatch_ms.map"] > 0 and m["feed_read_ms.map"] > 0
    # no CUDA events on the CPU: no device time to read
    assert "join_rungs_ms.map" not in m and "idle_share.map" not in m
    assert not {"collect_features_ms.map", "collect_match_ms.map",
                "foreground_blit_ms.map"} & set(m)


# ---- the readers ----------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch):
    """An empty store in place of the process's, recording on."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _builds(instrumented: bool, join: int):
    """Three ``build`` roots of a first pass that flags ``join`` pairs at
    the join, then a join rung (10 ms on the device) and a capacity rung,
    by a version with this change's counters and ``limit`` or without."""
    for _ in range(3):
        with profiling.span("build"):
            with profiling.span("collect"):
                with profiling.span("collect.pass", rung=0):
                    if instrumented:
                        for name, n in zip(FLAGS, (1, join, 0)):
                            profiling.count(name, n)
                rungs = (("collect.pass", "multiplicity"),
                         ("collect.repair", "capacity"))
                for i, (name, limit) in enumerate(rungs, start=1):
                    attrs = {"limit": limit} if instrumented else {}
                    with profiling.span(name, rung=i, **attrs):
                        if instrumented:
                            for flag in FLAGS:
                                profiling.count(flag, 5)


@pytest.mark.parametrize("instrumented", [True, False])
def test_readers_without_the_instrumentation_read_none(fresh, monkeypatch,
                                                       instrumented):
    monkeypatch.setattr(profiling.Span, "device_ms", lambda s: 10.0)
    _builds(instrumented, join=7)
    got = {n: harness.reader(n)({"builds": 2}) for n in READERS}
    if instrumented:
        # the first pass's count alone, and the join rung's device ms
        assert got["join_flagged_pairs.map"] == 7
        assert got["join_rungs_ms.map"] == pytest.approx(10.0)
    else:
        assert got == {n: None for n in READERS}
    assert all(harness.reader(n)({"builds": 3}) is None for n in READERS)


def test_readers_read_zero_where_nothing_trips(fresh, monkeypatch):
    monkeypatch.setattr(profiling.Span, "device_ms", lambda s: 10.0)
    for _ in range(2):
        with profiling.span("build"):
            with profiling.span("collect.pass", rung=0):
                for name in FLAGS:
                    profiling.count(name, 0)
            with profiling.span("collect.pass", rung=1, limit="capacity"):
                pass
    assert harness.reader("join_flagged_pairs.map")({"builds": 1}) == 0
    assert harness.reader("join_rungs_ms.map")({"builds": 1}) == 0


# ---- the harness ----------------------------------------------------------

def test_harness_finds_the_cell():
    bench, entry, config, workload = harness.cell_files(small.ROOT, CELL)
    assert (entry["config"], entry["chips"]) == ("c64_platformer", 1)
    assert workload["driver"] == "platformer_build"
    assert workload["traffic"]["noise_at"] is None
    assert set(workload["limits"]) == {
        "crop_wrong", "offsets_wrong", "fragments_wrong",
        "splice_bins_wrong", "foreground_bins_wrong", "map_px_wrong"}
    assert not any(workload["limits"].values())
    s = config["session"]
    assert (s["recipe"], s["frames"], s["level_cols"], s["bar_rows"],
            s["border"], s["enemies"]) == ("platformer", 2048, 448, 24, 8, 3)
    # play_session's rows: the play area's tile rows and 11
    assert s["level_rows"] == (312 - 24 - 2 * 8) // platformer.TILE + 11
    e2e = [m["name"] for m in harness.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["map_fps", "setup_s"]
    per_layer = {m["name"]
                 for m in harness.metrics_of(bench, CELL, "per_layer")}
    assert per_layer == {
        "window_ms.map", "collect_ms.map", "splice_ms.map",
        "foreground_ms.map", "clean_ms.map", "idle_share.map",
        "peak_gib.map", "first_pass_ms.map", "rungs_ms.map",
        "rematched_frames.map", "batch_prep_ms.map", "drain_wait_ms.map",
        "feed_read_ms.map", "feed_frames.map", "collect_dispatch_ms.map",
        "collect_features_ms.map", "collect_match_ms.map",
        "foreground_labels_ms.map", "foreground_masks_ms.map",
        "foreground_blit_ms.map"} | set(READERS)
    for name, cells in (
            ("join_flagged_pairs.map",
             [CELL, "c64_map_break", "c64_map_clean"]),
            ("join_rungs_ms.map", [CELL])):
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "ladder", "map_fps", cells)
        assert callable(harness.reader(name))
