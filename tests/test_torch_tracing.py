"""The port's spans and counters (remap_tpu_torch.utils.profiling) in the
map build: the stage spans under one ``build`` root, collect's rung spans
and ``collect.rematched_frames``, maps unchanged with recording off, the
host ranges under a profiler and only there, the bounded
store, and the benchmark's readers of them (``port_bench/metrics``)."""

import dataclasses

import numpy as np
import pytest
import torch

from port_bench import harness
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.utils import clips, profiling

CFG = PipelineConfig(screen_width=96, screen_height=72, region_capacity=2048,
                     splice_capacity=4096, frame_batch=8)
STAGES = ["window", "collect", "splice", "foreground", "clean"]
READERS = ["first_pass_ms.map", "rungs_ms.map", "rematched_frames.map",
           "batch_prep_ms.map", "drain_wait_ms.map", "splice_match_ms.map"]


def _clip(n_frames=24):
    return clips.simple_clip(
        n_frames=n_frames, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4, n_sprites=1, sprite_size=5).frames


def _break_clip():
    """Two walks over one world split by a noise frame (HUD and border
    kept), so collect gives two fragments and splice matches them."""
    rng = np.random.default_rng(11)
    world = clips.make_world(160, 224, rng)
    parts = [clips.render_clip(world, [(x0 + i, y0) for i in range(8)],
                               (72, 96), hud_rows=8, border=4).frames
             for x0, y0 in ((20, 30), (40, 34))]
    noise = rng.integers(0, 16, size=(72, 96), dtype=np.uint8)
    first = parts[0][0]
    noise[:8], noise[-4:] = first[:8], first[-4:]
    noise[:, :4], noise[:, -4:] = first[:, :4], first[:, -4:]
    return parts[0] + [noise] + parts[1]


@pytest.fixture
def fresh(monkeypatch):
    """An empty store in place of the process's, recording on."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _build(frames, cfg=CFG, **kwargs):
    return builder.build_from_frames(frames, cfg, device="cpu", **kwargs)


def test_build_records_its_stages_under_one_root(fresh):
    frames = _clip()
    _build(frames)
    records = profiling.recorder()
    assert len(records) == 1
    spans = records[0].spans
    root = records[0].root
    assert root.name == "build" and root.parent is None
    assert root.attrs == {"frames": len(frames)}
    stages = [s for s in spans if s.parent == root.id]
    assert [s.name for s in stages] == STAGES
    assert all(s.root == root.id for s in spans)
    # in order, inside the root, each closed before the next opened
    assert root.start <= stages[0].start
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    assert stages[-1].end <= root.end
    # every span hangs under an open span of the same build
    ids = {s.id: s for s in spans}
    for s in spans[1:]:
        parent = ids[s.parent]
        assert parent.start <= s.start and s.end <= parent.end
    by_id = {s.id: s.name for s in spans}
    for name, parent in (("collect.pass", "collect"),
                         ("collect.host_pack", "collect.pass"),
                         ("collect.blit", "collect"),
                         ("window.label", "window"),
                         ("foreground.batch", "foreground")):
        got = {by_id[s.parent] for s in spans if s.name == name}
        assert got == {parent}, name
    totals = records[0].totals()
    assert set(STAGES) <= set(totals)
    assert records[0].counters["window.labels"] == sum(
        s.name == "window.label" for s in spans)
    # the CPU launches no kernel; the wrappers' counts are read, not kept
    assert records[0].counters["launches.extract_dense_cuda"] == 0


def test_ladder_rung_counts_its_frames(fresh):
    frames = _clip()
    # capacity 16 overflows every frame's tables: the ladder replays
    cfg = dataclasses.replace(CFG, region_capacity=16)
    _build(frames, cfg)
    record = profiling.recorder()[-1]
    passes = [s for s in record.spans if s.name == "collect.pass"]
    assert [s.attrs["rung"] for s in passes][:2] == [0, 1]
    assert passes[0].attrs["capacity"] == 16 and not passes[0].attrs[
        "replay"]
    b = CFG.frame_batch
    want = 0
    for s in record.spans:
        if s.name == "collect.pass" and s.attrs["rung"] >= 1:
            assert s.attrs["replay"] and s.attrs["capacity"] > 16
            n = -(-len(frames) // b) * b
        elif s.name == "collect.repair":
            n = 2 * s.attrs["pairs"]
        else:
            continue
        assert s.counts["collect.rematched_frames"] == n
        want += n
    assert want > 0
    assert record.counters["collect.rematched_frames"] == want


def test_maps_equal_with_recording_off(fresh):
    frames = _break_clip()
    on = _build(frames)
    assert len(profiling.recorder()) == 1
    was = profiling.set_recording(False)
    try:
        off = _build(frames)
    finally:
        profiling.set_recording(was)
    assert was
    assert len(profiling.recorder()) == 1
    assert not fresh.records("png.write") and len(on.maps) >= 1
    assert [m.tobytes() for m in on.maps] == [m.tobytes() for m in off.maps]
    assert [(f.shape, [r.position for r in f.frames])
            for f in on.fragments] == [
        (f.shape, [r.position for r in f.frames]) for f in off.fragments]


@pytest.mark.parametrize("profiler", [True, False])
def test_profiler_ranges_only_under_a_profiler(fresh, monkeypatch, profiler):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    frames = _clip(16)
    if profiler:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _build(frames)
        spans = [e for e in prof.events() if e.name in set(entered)]
        assert {"build", "collect.pass", "collect.host_pack"} | set(
            STAGES) <= {e.name for e in spans}
        # host ranges of function scope (0), not user scope, for which
        # Kineto adds a range on the card's timeline
        assert {e.scope for e in spans} == {0}
        assert {e.device_type.name for e in spans} == {"CPU"}
    else:
        _build(frames)
        assert entered == []
    assert len(profiling.recorder()) == 1


def test_store_drops_the_oldest_builds(fresh):
    for i in range(profiling.MAX_ROOTS + 5):
        with profiling.span("build", n=i):
            with profiling.span("collect", device="cpu"):
                profiling.count("k", 2)
    with profiling.span("png.write"):
        pass
    records = profiling.recorder()
    assert len(records) == profiling.MAX_ROOTS
    assert [r.root.attrs["n"] for r in records] == list(
        range(5, profiling.MAX_ROOTS + 5))
    assert all(r.counters["k"] == 2 and len(r.spans) == 2 for r in records)
    assert len(profiling.recorder("png.write")) == 1
    assert profiling.last("collect") is None     # no root open
    profiling.count("k")                         # no span open: dropped
    assert all(r.counters["k"] == 2 for r in profiling.recorder())


@pytest.fixture(scope="module")
def three_builds():
    """A store holding three CPU builds of the break clip past its
    capacity: the ladder replays and splice matches two fragments."""
    rec = profiling.Recorder()
    real = profiling._RECORDER
    profiling._RECORDER = rec
    try:
        cfg = dataclasses.replace(CFG, region_capacity=16)
        for _ in range(3):
            _build(_break_clip(), cfg)
    finally:
        profiling._RECORDER = real
    return rec


def _want(name, record):
    totals = record.totals()
    return {
        "first_pass_ms.map": sum(s.host_ms for s in record.spans
                                 if s.name == "collect.pass"
                                 and s.attrs["rung"] == 0),
        "rungs_ms.map": sum(s.host_ms for s in record.spans
                            if s.name in ("collect.pass", "collect.repair")
                            and s.attrs["rung"] >= 1),
        "rematched_frames.map": record.counters.get(
            "collect.rematched_frames", 0),
        "batch_prep_ms.map": totals.get("collect.feed_wait", 0.0)
        + totals.get("collect.host_pack", 0.0),
        "drain_wait_ms.map": totals.get("drain.wait", 0.0),
        "splice_match_ms.map": totals.get("splice.match", 0.0),
    }[name]


@pytest.mark.parametrize("name", READERS)
def test_reader_takes_the_window_builds(name, three_builds, monkeypatch):
    read = harness.reader(name)
    monkeypatch.setattr(profiling, "_RECORDER", three_builds)
    records = profiling.recorder()
    assert len(records) == 3
    # one window build: the one before the last (the profiled build)
    got = read({"builds": 1})
    assert isinstance(got, float) and got == pytest.approx(
        _want(name, records[1]))
    if name != "drain_wait_ms.map":     # the CPU's drains do not wait
        assert got > 0
    both = read({"builds": 2})
    assert both == pytest.approx(
        (_want(name, records[0]) + _want(name, records[1])) / 2)
    assert read({"builds": 3}) is None          # too few roots
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    assert read({"builds": 1}) is None
    assert read({}) is None
