"""The port's spans and counters (remap_tpu_torch.utils.profiling) in the
map build: the stage spans under one ``build`` root, collect's rung spans
and ``collect.rematched_frames``, the phases of each collect and
foreground batch, the frame reader's worker spans in the build that asked
for them, maps unchanged with recording off, the host ranges under a
profiler and only there, the bounded store, and the benchmark's readers
of them (``port_bench/metrics``)."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from port_bench import harness
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.io import frames as frames_io
from remap_tpu_torch.pipeline import builder
from remap_tpu_torch.utils import clips, profiling

CFG = PipelineConfig(screen_width=96, screen_height=72, region_capacity=2048,
                     splice_capacity=4096, frame_batch=8)
STAGES = ["window", "collect", "splice", "foreground", "clean"]
READERS = ["first_pass_ms.map", "rungs_ms.map", "rematched_frames.map",
           "batch_prep_ms.map", "drain_wait_ms.map", "splice_match_ms.map",
           "feed_read_ms.map", "feed_frames.map", "collect_dispatch_ms.map"]
#: the phases of a collect batch, and the rungs that hold them
PHASES = ["collect.upload", "collect.features", "collect.match",
          "collect.scalars"]
RUNGS = ("collect.pass", "collect.repair")
#: the phases of a foreground batch
FG_PHASES = ["foreground.labels", "foreground.masks", "foreground.blit"]


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


def _raw_feed(frames, directory):
    """A raw feed (the native packed reader's) over ``frames`` written as
    numbered dumps into ``directory``."""
    for i, frame in enumerate(frames):
        frame.tofile(os.path.join(directory, str(i)))
    h, w = frames[0].shape
    return frames_io.RawDirectoryFeed(str(directory), w, h)


def _build_feed(feed, cfg=CFG):
    return builder.build(lambda: feed, cfg, device="cpu")


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
                         ("collect.store", "collect.pass"),
                         ("collect.blit", "collect"),
                         ("window.label", "window"),
                         ("window.feed_wait", "window"),
                         ("foreground.batch", "foreground"),
                         *((p, "collect.pass") for p in PHASES),
                         *((p, "foreground.batch") for p in FG_PHASES)):
        got = {by_id[s.parent] for s in spans if s.name == name}
        assert got == {parent}, name
    totals = records[0].totals()
    assert set(STAGES) <= set(totals)
    # every changed heatmap state labelled, the first always
    assert sum(s.name == "window.label" for s in spans) >= 1
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


def _children(record, parent):
    return [s for s in record.spans if s.parent == parent.id]


def test_collect_and_foreground_batches_hold_their_phases(fresh):
    """Each batch of collect's passes (the first and the replay) holds one
    span of each phase, a batch of the pair repair one with two feature
    calls (one a side), and the first pass stores each batch; each
    foreground batch holds its labels, masks and blit.  None of them is
    a root of its own."""
    frames = _break_clip()
    # capacity 16: a replay, then a repair of the pairs left over
    _build(frames, dataclasses.replace(CFG, region_capacity=16))
    [record] = profiling.recorder()
    b = CFG.frame_batch
    rungs = [s for s in record.spans if s.name in RUNGS]
    assert [s.name for s in rungs] == [
        "collect.pass", "collect.pass", "collect.repair"]
    for rung in rungs:
        got = [s.name for s in _children(record, rung) if s.name in PHASES]
        if rung.name == "collect.pass":
            want = PHASES * -(-len(frames) // b)
        else:
            want = ["collect.upload", "collect.features", "collect.features",
                    "collect.match", "collect.scalars"] * -(
                        -rung.attrs["pairs"] // b)
        assert got == want, rung.attrs
    stores = [s for s in record.spans if s.name == "collect.store"]
    assert {s.parent for s in stores} == {rungs[0].id}
    assert len(stores) == -(-len(frames) // b)
    batches = [s for s in record.spans if s.name == "foreground.batch"]
    assert batches
    for batch in batches:
        assert [s.name for s in _children(record, batch)] == FG_PHASES
    for name in PHASES + FG_PHASES + ["collect.store"]:
        assert not profiling.recorder(name), name


def test_reader_spans_join_the_build_that_asked(fresh, tmp_path,
                                                monkeypatch):
    """A build over a raw feed records each read of the native reader,
    on the readers' worker threads too, as ``feed.read`` under the
    ``window`` or ``collect.pass`` span that asked for it, in the build's
    record and not as roots of their own; their ``feed.frames`` add up to
    the frames read.  The window's waits on its reader are
    ``window.feed_wait``."""
    frames = _break_clip()
    feed = _raw_feed(frames, tmp_path)
    read = []
    real = frames_io.RawDirectoryFeed._read_packed_batch

    def counted(self, start, count, native):
        out = real(self, start, count, native)
        read.append((threading.get_ident(), len(out)))
        return out

    monkeypatch.setattr(frames_io.RawDirectoryFeed, "_read_packed_batch",
                        counted)
    _build_feed(feed)
    [record] = profiling.recorder()
    by_id = {s.id: s for s in record.spans}
    reads = [s for s in record.spans if s.name == "feed.read"]
    assert len(reads) == len(read)
    assert {by_id[s.parent].name for s in reads} == {"window",
                                                     "collect.pass"}
    assert all(s.root == record.root.id for s in reads)
    assert not profiling.recorder("feed.read")
    assert sum(s.counts["feed.frames"] for s in reads) == (
        record.counters["feed.frames"]) == sum(n for _, n in read)
    # collect's first pass reads every frame once, on its worker
    assert sum(s.counts["feed.frames"] for s in reads
               if by_id[s.parent].name == "collect.pass") == len(frames)
    assert {t for t, _ in read} - {threading.get_ident()}
    waits = [s for s in record.spans if s.name == "window.feed_wait"]
    assert waits and {by_id[s.parent].name for s in waits} == {"window"}
    assert {by_id[s.parent].name for s in record.spans
            if s.name == "collect.feed_wait"} == {"collect.pass"}


def test_adopted_spans_and_counts_lose_nothing(fresh):
    """Threads that adopt one open span open spans and count under it
    while the main thread counts the same counter, switching threads as
    often as the interpreter allows: every span lands in the record and
    no count is lost."""
    threads_n, each = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.span("build"):
            with profiling.span("collect.pass", rung=0) as held_span:
                held = profiling.current()

                def work():
                    with profiling.adopt(held):
                        for _ in range(each):
                            with profiling.span("feed.read"):
                                profiling.count("feed.frames")

                threads = [threading.Thread(target=work)
                           for _ in range(threads_n)]
                for t in threads:
                    t.start()
                for _ in range(each):
                    profiling.count("feed.frames")
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    [record] = profiling.recorder()
    reads = [s for s in record.spans if s.name == "feed.read"]
    assert len(reads) == threads_n * each
    assert {s.parent for s in reads} == {held_span.id}
    assert record.counters["feed.frames"] == (threads_n + 1) * each
    assert held_span.counts["feed.frames"] == each
    assert not profiling.recorder("feed.read")


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


@pytest.mark.parametrize("profiler", [True, False, "all_threads"])
def test_profiler_ranges_only_under_a_profiler(fresh, monkeypatch, tmp_path,
                                               profiler):
    """Each span is a host range under a profiler and only there.  A
    profiler of every thread also holds the reader's worker ranges, on a
    thread of their own (one of the main thread alone need not)."""
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    frames = _clip(16)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    if profiler == "all_threads":
        feed = _raw_feed(frames, tmp_path)
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        with torch.profiler.profile(activities=cpu,
                                    experimental_config=config) as prof:
            _build_feed(feed)
        spans = [e for e in prof.events() if e.name in set(entered)]
        main = {e.thread for e in spans if e.name == "build"}
        reads = [e for e in spans if e.name == "feed.read"]
        assert {e.thread for e in reads} - main
        assert {"window.feed_wait", "collect.feed_wait"} <= {
            e.name for e in spans}
        assert {e.scope for e in spans} == {0}
        # the worker's spans land in the build's record all the same
        assert sum(s.name == "feed.read"
                   for s in profiling.recorder()[-1].spans) >= len(reads)
    elif profiler:
        with torch.profiler.profile(activities=cpu) as prof:
            _build(frames)
        spans = [e for e in prof.events() if e.name in set(entered)]
        assert {"build", "collect.pass", "collect.host_pack",
                "collect.store", "window.feed_wait"} | set(
            STAGES + PHASES + FG_PHASES) <= {e.name for e in spans}
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
def three_builds(tmp_path_factory):
    """A store holding three CPU builds of the break clip past its
    capacity, read off a raw feed: the ladder replays and repairs, and
    splice matches two fragments."""
    rec = profiling.Recorder()
    real = profiling._RECORDER
    profiling._RECORDER = rec
    try:
        cfg = dataclasses.replace(CFG, region_capacity=16)
        feed = _raw_feed(_break_clip(), tmp_path_factory.mktemp("frames"))
        for _ in range(3):
            _build_feed(feed, cfg)
    finally:
        profiling._RECORDER = real
    return rec


def _want(name, record):
    totals = record.totals()
    rungs = {s.id for s in record.spans if s.name in RUNGS}
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
        "feed_read_ms.map": totals["feed.read"],
        "feed_frames.map": record.counters["feed.frames"],
        "collect_dispatch_ms.map": sum(
            s.host_ms for s in record.spans
            if s.name in PHASES and s.parent in rungs),
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


#: the device readers, with the spans they read and their parents
DEVICE_READERS = {
    "collect_features_ms.map": ("collect.features", RUNGS),
    "collect_match_ms.map": ("collect.match", RUNGS),
    "foreground_labels_ms.map": ("foreground.labels", ("foreground.batch",)),
    "foreground_masks_ms.map": ("foreground.masks", ("foreground.batch",)),
    "foreground_blit_ms.map": ("foreground.blit", ("foreground.batch",)),
}


@pytest.mark.parametrize("name", sorted(DEVICE_READERS))
def test_device_reader_sums_the_events_of_its_spans(name, three_builds,
                                                    monkeypatch):
    """A device reader sums each window build's spans under their
    parents (and only there) between their events and averages over the
    builds; the CPU's spans, with no events, read None."""
    read = harness.reader(name)
    monkeypatch.setattr(profiling, "_RECORDER", three_builds)
    assert read({"builds": 1}) is None
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    span, parents = DEVICE_READERS[name]
    ms = {}
    monkeypatch.setattr(profiling.Span, "device_ms",
                        lambda s: ms.get(s.id))
    sums = []
    for build in range(3):
        total = 0.0
        with profiling.span("build"):
            for k, parent in enumerate(parents):
                with profiling.span(parent):
                    for i in range(2):
                        with profiling.span(span) as s:
                            ms[s.id] = 10.0 * build + 2 * k + i + 0.5
                            total += ms[s.id]
            with profiling.span("splice"):
                with profiling.span(span) as s:
                    ms[s.id] = 1000.0
        sums.append(total)
    assert read({"builds": 2}) == pytest.approx((sums[0] + sums[1]) / 2)
    assert read({"builds": 1}) == pytest.approx(sums[1])
    assert read({"builds": 3}) is None          # too few roots
    # a build in which one span has no events reads None
    ms.pop(next(s.id for s in profiling.recorder()[0].spans
                if s.name == span))
    assert read({"builds": 2}) is None
    assert read({"builds": 1}) is not None


@pytest.mark.parametrize("name", ["feed_read_ms.map", "feed_frames.map",
                                  "collect_dispatch_ms.map",
                                  *sorted(DEVICE_READERS)])
def test_reader_reads_none_without_its_spans(name, fresh):
    """Builds by a version without the batch phases, the reader's spans
    and its counter read None, not 0."""
    for _ in range(3):
        with profiling.span("build"):
            with profiling.span("window"):
                with profiling.span("window.label"):
                    pass
            with profiling.span("collect"):
                with profiling.span("collect.pass", rung=0):
                    with profiling.span("collect.feed_wait"):
                        pass
                    profiling.count("collect.table_flagged", 0)
            with profiling.span("foreground"):
                with profiling.span("foreground.batch"):
                    pass
    assert harness.reader(name)({"builds": 2}) is None
