"""The ``c64_areas`` configuration of the port's benchmark: sessions that
move through doors between scrolling areas and revisit each
(``port_bench/areas.py``).  At a CPU size: the map build gives one
fragment and one map an area, its spliced canvases equal the plain
reference's votes and the JAX package's splice; splice's counters and
spans; the ``c64_areas_revisit`` cell through its ``areas_build`` driver
(``correct``, and a fragment holding two areas seen); the new readers;
and the cell's files and metrics as the harness finds them."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from port_bench import areas, harness, traffic
from port_bench.drivers import areas_build
from port_bench.reference import maps as ref
from port_bench.tests import small
from remap_tpu.pipeline import collect as jcollect
from remap_tpu.pipeline import splice as jsplice
from remap_tpu_torch import convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.pipeline import splice as tsplice
from remap_tpu_torch.utils import profiling

from torch_parity import jax_twin

torch.set_num_threads(2)

CELL = "c64_areas_revisit"
READERS = ["splice_matches.map", "splice_merges.map", "splice_need_ms.map",
           "splice_vote_ms.map", "splice_extract_ms.map",
           "splice_batches.map"]
SEED = 2 ** 31 + 11


def _cut(areas_=2, visits=4, visit_frames=12):
    """(benchmark, cell, configuration, workload) of the cell at a CPU
    size: 96x72 frames in batches of 8, as ``port_bench/tests/small.py``
    cuts the C64 cells, ``visits`` visits of ``visit_frames`` frames over
    ``areas_`` areas."""
    bench, entry, config, workload = harness.cell_files(small.ROOT, CELL)
    config = copy.deepcopy(config)
    config["pipeline"].update(screen_width=96, screen_height=72,
                              frame_batch=8, region_capacity=2048,
                              splice_capacity=4096)
    config["session"].update(areas=areas_, visits=visits,
                             visit_frames=visit_frames,
                             frames=visits * visit_frames, world_margin=200,
                             hud_rows=8, border=4, sprites=2, sprite_size=5)
    return bench, entry, config, workload


def _cfg(config) -> PipelineConfig:
    return PipelineConfig(**config["pipeline"])


def _cropped(config, session) -> np.ndarray:
    s = config["session"]
    n, h, w = session.frames.shape
    left, top, right, bottom = ref.expected_crop(h, w, s["hud_rows"],
                                                 s["border"])
    return np.ascontiguousarray(session.frames[:, top:bottom, left:right])


# ---- the recipe -----------------------------------------------------------

def test_session_visits_the_areas_through_their_doors():
    _, _, config, _ = _cut(areas_=3, visits=6, visit_frames=5)
    s = areas.make(config, SEED)
    assert s.frames.shape == (30, 72, 96) and s.noise_at is None
    assert s.starts == [0, 5, 10, 15, 20, 25]
    assert s.area.tolist() == [v % 3 for v in range(6) for _ in range(5)]
    path = np.asarray(s.path)
    # each visit enters at its area's door, the same spot every time
    doors = {a: {tuple(path[t]) for t in s.starts if s.area[t] == a}
             for a in range(3)}
    assert all(len(d) == 1 for d in doors.values())
    # the areas lie apart in the frame they share
    wh, ww = 72 + 200, 96 + 200
    for a in range(3):
        xs = path[s.area == a, 0]
        assert xs.min() >= a * (ww + 96) and xs.max() + 96 <= (
            a * (ww + 96) + ww)
        assert path[s.area == a, 1].max() + 72 <= wh
    # steps within a visit are at most max_step
    steps = np.abs(np.diff(path, axis=0))
    inside = np.ones(len(path) - 1, bool)
    inside[[t - 1 for t in s.starts[1:]]] = False
    assert steps[inside].max() <= config["session"]["max_step"]
    # the seed draws the worlds, not the walk
    other = areas.make(config, SEED + 1)
    assert other.path == s.path
    assert not np.array_equal(other.frames, s.frames)
    np.testing.assert_array_equal(areas.make(config, SEED).frames, s.frames)
    with pytest.raises(ValueError):
        areas.make({**config, "session": {**config["session"],
                                          "frames": 31}}, SEED)


# ---- the map build --------------------------------------------------------

class _Spliced(builder.Callbacks):
    def on_splice(self, fragments):
        self.spliced = fragments


@pytest.fixture(scope="module")
def built():
    """2 areas x 2 visits each through ``builder.build`` on the CPU:
    (configuration, session, spliced fragments, result, last record)."""
    _, _, config, _ = _cut()
    s = areas.make(config, SEED)
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


def test_build_gives_one_fragment_and_map_an_area(built):
    config, s, spliced, res, _ = built
    assert np.flatnonzero(~res.collect.matched).tolist() == s.starts
    assert len(res.collect.fragments) == 4
    assert len(spliced) == 2 and len(res.maps) == 2
    cropped = torch.as_tensor(_cropped(config, s))
    path = np.asarray(s.path)
    for frag in spliced:
        nums = [r.number for r in frag.frames]
        assert sorted(nums) == np.flatnonzero(
            s.area == s.area[nums[0]]).tolist()
        pos = np.array([r.position for r in frag.frames]).reshape(-1, 2)
        assert len({tuple(p) for p in pos - path[nums]}) == 1
        want = ref.vote_canvas(cropped[nums], pos - np.asarray(frag.zero),
                               frag.shape)
        got = torch.as_tensor(np.asarray(frag.dots, np.int64)).permute(
            2, 0, 1)
        assert torch.equal(got, want)


def test_splice_counts_and_spans(built):
    config, _, _, _, record = built
    c = record.counters
    # 6 first-round pairs, then the merged snippet against the 2 left and
    # the next against the 1 left; only the two same-area pairs accepted
    assert (c["splice.fragments"], c["splice.merges"]) == (4, 2)
    assert (c["splice.matches"], c["splice.rejects"]) == (9, 7)
    # the need is the join's own, so no join overflows its multiplicity
    assert c.get("splice.retries", 0) == 0
    assert c.get("splice.jumps", 0) == 0
    # each round in chunks of the join-slot budget's pairs (the snippets
    # hold fewer keypoints than the capacity 4096), one vote a chunk
    cfg = _cfg(config)
    step = tsplice._batch_pairs(cfg.join_multiplicity, cfg.splice_capacity)
    assert step == tsplice.JOIN_SLOTS // (4 * 2 * 4096)
    assert c["splice.batches"] == sum(-(-n // step) for n in (6, 2, 1)) == 3
    spans = [s for s in record.spans if s.name == "splice.match"]
    assert sum(s.attrs["pairs"] for s in spans) == c["splice.matches"]
    assert [s.attrs["multiplicity"] for s in spans] == [4, 4, 4]
    matches = {s.id for s in spans}
    for name in ("splice.need", "splice.vote"):
        found = [s for s in record.spans if s.name == name]
        assert len(found) == c["splice.batches"], name
        assert {s.parent for s in found} <= matches
        assert all(s.events is None for s in found)    # the CPU


def test_splice_equals_jax(built):
    """The same cropped frames through each package's collect and
    splice: the fragments equal, canvases, origins and records."""
    config, s, spliced, _, _ = built
    frames = list(_cropped(config, s))
    cfg = _cfg(config)
    jcol = jcollect.collect(frames, jax_twin(cfg))
    tcol = tcollect.collect(frames, cfg, device="cpu")
    assert len(jcol.fragments) == len(tcol.fragments) == 4
    want = jsplice.splice(jcol.fragments, jax_twin(cfg))
    got = tsplice.splice(tcol.fragments, cfg)
    assert len(got) == len(want) == 2
    for g, w, b in zip(got, want, spliced):
        g, w, b = (convert.fragment_to_numpy(f) for f in (g, w, b))
        assert g.zero == w.zero == b.zero
        assert g.frames == w.frames == b.frames
        np.testing.assert_array_equal(g.dots, w.dots)
        np.testing.assert_array_equal(b.dots, w.dots)


# ---- the cell's driver ----------------------------------------------------

@pytest.fixture(scope="module")
def windowed(tmp_path_factory):
    """The cell at the CPU size after its window: (driver, limits)."""
    _, _, config, workload = _cut()
    drv = areas_build.Driver(config, workload["traffic"], SEED, "cpu",
                             str(tmp_path_factory.mktemp("areas")), False)
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
    assert _correct(checks, limits), checks
    assert drv.failed_builds == 0
    assert all(len(b["maps"]) == 2 for b in drv.builds)


def test_cell_sees_two_areas_in_one_fragment(windowed):
    drv, limits = windowed
    first, second = drv.spliced
    kept = drv.spliced
    try:
        joined = tsplice.merge_fragments(first, second, (0, 0),
                                         (96, 72))
        drv.spliced = [joined]
        checks = drv.check()
    finally:
        drv.spliced = kept
    # one fragment fewer, and the other area's frames in it
    assert checks["fragments_wrong"] >= 1 + len(second.frames)
    assert not _correct(checks, limits)
    assert drv.failed_builds >= 1


def test_cell_sees_a_door_matched(windowed):
    drv, limits = windowed
    last = drv.builds[-1]
    door = drv.session.starts[2]
    kept = copy.deepcopy(last)
    try:
        last["matched"][door] = True
        checks = drv.check()
    finally:
        drv.builds[-1] = kept
    assert checks["offsets_wrong"] == 1
    assert not _correct(checks, limits)


def test_traced_run_reads_the_splice_metrics(tmp_path):
    """A traced run's per-layer metrics, read as ``harness.run_cell``
    reads them (which refuses a process that loaded JAX, as this one
    has)."""
    bench, _, config, workload = _cut()
    drv = areas_build.Driver(config, workload["traffic"], SEED, "cpu",
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
    assert (m["splice_matches.map"], m["splice_merges.map"]) == (9, 2)
    assert m["splice_batches.map"] == 3
    assert m["splice_need_ms.map"] > 0 and m["splice_extract_ms.map"] > 0
    assert m["splice_match_ms.map"] > m["splice_need_ms.map"]
    assert m["rematched_frames.map"] == 0
    assert m["feed_read_ms.map"] > 0 and m["collect_dispatch_ms.map"] > 0
    # collect reads every frame, the window scan at least the first
    assert m["feed_frames.map"] > config["session"]["frames"]
    # no CUDA events on the CPU: no device time to read
    assert "splice_vote_ms.map" not in m and "idle_share.map" not in m
    assert not {"collect_features_ms.map", "collect_match_ms.map",
                "foreground_labels_ms.map"} & set(m)


# ---- the readers ----------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch):
    """An empty store in place of the process's, recording on."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _builds(instrumented: bool, merges: int):
    """Three ``build`` roots of a splice with one match (10 ms of vote on
    the device, one batch) and ``merges`` merges, by a version with the
    splice spans and counters or without them."""
    for _ in range(3):
        with profiling.span("build"):
            with profiling.span("splice"):
                if instrumented:
                    profiling.count("splice.fragments", 3)
                with profiling.span("splice.extract"):
                    pass
                with profiling.span("splice.match"):
                    profiling.count("splice.matches")
                    if instrumented:
                        with profiling.span("splice.need"):
                            pass
                        with profiling.span("splice.vote"):
                            profiling.count("splice.batches")
                if instrumented:
                    for _ in range(merges):
                        profiling.count("splice.merges")


@pytest.mark.parametrize("instrumented", [True, False])
def test_readers_without_the_instrumentation_read_none(fresh, monkeypatch,
                                                       instrumented):
    monkeypatch.setattr(profiling.Span, "device_ms", lambda s: 10.0)
    _builds(instrumented, merges=0)
    got = {n: harness.reader(n)({"builds": 2}) for n in READERS}
    # counts every version records
    assert got["splice_matches.map"] == 1
    assert got["splice_extract_ms.map"] >= 0
    if instrumented:
        # a build that merges nothing reads 0, not None
        assert got["splice_merges.map"] == 0
        assert got["splice_need_ms.map"] >= 0
        assert got["splice_vote_ms.map"] == pytest.approx(10.0)
        assert got["splice_batches.map"] == 1
    else:
        for name in ("splice_merges.map", "splice_need_ms.map",
                     "splice_vote_ms.map", "splice_batches.map"):
            assert got[name] is None, name
    assert all(harness.reader(n)({"builds": 3}) is None for n in READERS)


# ---- the harness ----------------------------------------------------------

def test_harness_finds_the_cell():
    bench, entry, config, workload = harness.cell_files(small.ROOT, CELL)
    assert (entry["config"], entry["chips"]) == ("c64_areas", 1)
    assert workload["driver"] == "areas_build"
    assert set(workload["limits"]) == {
        "crop_wrong", "offsets_wrong", "fragments_wrong",
        "splice_bins_wrong", "foreground_bins_wrong", "map_px_wrong"}
    assert not any(workload["limits"].values())
    session = harness.cell_files(small.ROOT, "c64_map_break")[2]
    assert config["pipeline"] == session["pipeline"]
    s = config["session"]
    assert (s["recipe"], s["areas"], s["visits"], s["visit_frames"],
            s["frames"]) == ("areas", 4, 16, 128, 2048)
    for key in ("world_margin", "max_step", "path_seed", "sprites",
                "sprite_size", "hud_rows", "border"):
        assert s[key] == session["session"][key], key
    defaults = dataclasses.asdict(PipelineConfig())
    assert all(defaults[k] == v for k, v in config["pipeline"].items()
               if k not in ("screen_width", "screen_height"))
    e2e = [m["name"] for m in harness.metrics_of(bench, CELL, "end_to_end")]
    assert e2e == ["map_fps", "setup_s"]
    per_layer = {m["name"]
                 for m in harness.metrics_of(bench, CELL, "per_layer")}
    assert per_layer == {
        "window_ms.map", "collect_ms.map", "splice_ms.map",
        "foreground_ms.map", "clean_ms.map", "idle_share.map",
        "peak_gib.map", "first_pass_ms.map", "rungs_ms.map",
        "rematched_frames.map", "batch_prep_ms.map", "drain_wait_ms.map",
        "splice_match_ms.map", "feed_read_ms.map", "feed_frames.map",
        "collect_dispatch_ms.map", "collect_features_ms.map",
        "collect_match_ms.map", "foreground_labels_ms.map",
        "foreground_masks_ms.map", "foreground_blit_ms.map"} | set(READERS)
    for name in READERS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert (m["layer"], m["moves"]) == ("splice", "map_fps")
        want = [CELL, "c64_map_break"]
        if name in ("splice_matches.map", "splice_merges.map"):
            want.append("vga_pyramid_break")
        assert m["workloads"] == want
        assert callable(harness.reader(name))
    # the session is its own recipe: the generator of the other cells
    # does not know it
    with pytest.raises(ValueError):
        traffic.make(config, {}, 1)
