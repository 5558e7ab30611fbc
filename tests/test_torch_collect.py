"""Port collect stage (remap_tpu_torch.pipeline.collect, pipeline.stream)
vs the JAX package, exact: per-frame offsets and matched flags,
``overflow_frames``, and every fragment's canvas, frame records and
stored frames (compared through ``convert``)."""

import dataclasses

import numpy as np
import pytest
import torch

from remap_tpu.pipeline import collect as jcollect
from remap_tpu.pipeline import stream as jstream
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch import models as tmodels
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.ops import kpe as tkpe
from remap_tpu_torch.parallel import sharded as tsharded
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.pipeline import state as tstate
from remap_tpu_torch.pipeline import stream as tstream
from remap_tpu_torch.pipeline.state import Fragment
from remap_tpu_torch.utils import profiling

from torch_parity import jax_twin

#: tests/test_collect.py's setup
CFG = PipelineConfig(screen_width=96, screen_height=64, region_capacity=2048,
                     frame_batch=8)


def _assert_host_equal(got, want):
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.matched, want.matched)
    assert got.overflow_frames == want.overflow_frames
    assert len(got.fragments) == len(want.fragments)
    for g, w in zip(got.fragments, want.fragments):
        assert g.zero == w.zero == (0, 0)
        assert g.frames == w.frames
        np.testing.assert_array_equal(g.dots, w.dots)
    if got.fragments:
        gs, ws = got.fragments[0].store, want.fragments[0].store
        assert gs.numbers == ws.numbers
        np.testing.assert_array_equal(gs.packed_images, ws.packed_images)


def _collect_both(frames, cfg, **port_kwargs):
    want = jcollect.collect(frames, jax_twin(cfg))
    got = tcollect.collect(frames, cfg, device="cpu", **port_kwargs)
    _assert_host_equal(convert.collect_result_to_numpy(got),
                       convert.collect_result_to_numpy(want))
    return got


def test_single_fragment_clip():
    clip = testing.simple_clip(n_frames=20, frame_hw=(64, 96),
                               world_hw=(160, 224), seed=41)
    got = _collect_both(clip.frames, CFG)
    assert [tuple(o) for o in got.offsets[1:]] == clip.offsets
    assert len(got.fragments) == 1 and got.overflow_frames == 0


def _break_frames():
    clip_a = testing.simple_clip(n_frames=7, seed=43)
    rng = np.random.default_rng(44)
    noise = rng.integers(0, 16, size=(64, 96), dtype=np.uint8)
    clip_b = testing.simple_clip(n_frames=6, seed=45)
    return clip_a.frames + [noise] + clip_b.frames


def test_fragment_breaks():
    got = _collect_both(_break_frames(), CFG)
    assert len(got.fragments) == 3
    assert np.flatnonzero(~got.matched).tolist() == [0, 7, 8]


@pytest.mark.parametrize("batch,depth", [(4, 1), (5, 2), (13, 8)])
def test_batch_and_drain_depth_invariance(batch, depth):
    """The port's results do not depend on the batch size or on how many
    batches are in flight: each equals the JAX run at frame_batch 8."""
    frames = _break_frames()
    want = convert.collect_result_to_numpy(jcollect.collect(
        frames, jax_twin(CFG)))
    cfg = dataclasses.replace(CFG, frame_batch=batch,
                              collect_drain_depth=depth)
    got = tcollect.collect(frames, cfg, device="cpu")
    _assert_host_equal(convert.collect_result_to_numpy(got), want)


@pytest.fixture()
def ladder(monkeypatch):
    """Records (kind, capacity, multiplicity, vote radius, frame batch,
    number of pairs, the pairs) for each pass the port's strict ladder
    runs."""
    calls = []
    real_pass, real_repair = tcollect.match_pass, tcollect.repair_pairs

    def counting_pass(frames, layout, cfg, store=None, device=None):
        calls.append(("pass", cfg.region_capacity, cfg.join_multiplicity,
                      cfg.vote_radius, cfg.frame_batch, None, None))
        return real_pass(frames, layout, cfg, store, device)

    def counting_repair(pairs, store, layout, cfg, offsets, matched):
        calls.append(("repair", cfg.region_capacity, cfg.join_multiplicity,
                      cfg.vote_radius, cfg.frame_batch, len(pairs),
                      list(pairs)))
        return real_repair(pairs, store, layout, cfg, offsets, matched)

    monkeypatch.setattr(tcollect, "match_pass", counting_pass)
    monkeypatch.setattr(tcollect, "repair_pairs", counting_repair)
    return calls


def _repetitive_frames():
    """tests/test_collect.py::test_strict_retry_on_repetitive_texture's
    clip: a 6x6 tile with 2% distinct pixels."""
    rng = np.random.default_rng(53)
    tile = rng.integers(0, 16, size=(6, 6), dtype=np.uint8)
    world = np.tile(tile, (30, 40)).astype(np.uint8)
    ys, xs = np.nonzero(rng.random(world.shape) < 0.02)
    world[ys, xs] = rng.integers(0, 16, size=len(ys)).astype(np.uint8)
    return [world[y:y + 64, x:x + 96]
            for x, y in [(20, 20), (22, 21), (25, 23), (24, 26)]]


def test_strict_retry_on_repetitive_texture(ladder):
    cfg = dataclasses.replace(CFG, region_capacity=512, join_multiplicity=1,
                              frame_batch=4)
    got = _collect_both(_repetitive_frames(), cfg)
    assert got.overflow_frames == 0
    # the ladder raised the multiplicity at least once, counting exactly
    assert ladder[0][2] == 1
    assert any(c[2] != 1 and c[3] == 0 for c in ladder[1:]), ladder


def _stripe_path_frames():
    """A camera path that reaches a repetitive stripe in its last frames,
    and the tight limits under which some of its pairs flag."""
    rng = np.random.default_rng(31)
    world = testing.make_world(180, 400, rng)
    tile = rng.integers(0, 16, size=(4, 4), dtype=np.uint8)
    world[:, 130:160] = np.tile(tile, (45, 8))[:, :30]
    path = [(10 + 3 * i, 30 + (i % 3)) for i in range(12)]
    tight = dataclasses.replace(CFG, region_capacity=512,
                                join_multiplicity=1, frame_batch=4,
                                vote_radius=4)
    return [world[y:y + 64, x:x + 96] for x, y in path], tight, rng


def test_incremental_repair_matches_exhaustive(ladder):
    """The strict loop re-matches only the flagged pairs (a repetitive
    stripe the camera reaches in its last frames): the result equals the
    JAX package's and a run with exhaustive limits from the start (the
    dense join, exact counting)."""
    frames, tight, _ = _stripe_path_frames()
    got = _collect_both(frames, tight)
    assert got.overflow_frames == 0
    repairs = [c for c in ladder if c[0] == "repair"]
    assert repairs and all(c[5] < len(frames) // 2 for c in repairs), ladder

    exhaustive = dataclasses.replace(tight, join_multiplicity=0,
                                     vote_radius=0)
    ref = tcollect.collect(frames, exhaustive, device="cpu")
    _assert_host_equal(convert.collect_result_to_numpy(got),
                       convert.collect_result_to_numpy(ref))


def test_capacity_escalation_jumps_to_measured_count(ladder):
    """Dense noise far above a tiny capacity: one retry, straight to a
    power of two that holds the measured maximum, as the JAX ladder."""
    rng = np.random.default_rng(77)
    world = rng.integers(0, 16, size=(180, 240), dtype=np.uint8)
    path = [(20 + 2 * i, 30 + (i % 3)) for i in range(8)]
    frames = [world[y:y + 64, x:x + 96] for x, y in path]
    tiny = dataclasses.replace(CFG, region_capacity=128, frame_batch=8)
    got = _collect_both(frames, tiny)
    assert got.overflow_frames == 0
    caps = [c[1] for c in ladder]
    assert caps[0] == 128 and len(caps) == 2 and caps[1] >= 1024, ladder


@pytest.mark.parametrize("clip", ["break", "uniform"])
def test_capacity_rung_takes_what_its_pairs_need(clip, ladder, recorded):
    """A capacity rung escalates to the capacity its flagged pairs need,
    not to the densest frame's.  ``_break_frames`` needs at most 385
    keypoints a region in its ordinary frames and 1,216 in its noise
    frame (7): from capacity 128 the clip replays at 512 and only the
    noise frame's two pairs are repaired, at 2048, leaving two outliers
    to the repair.  Its first seven frames alone (uniform needs) replay
    once at 512 with no outlier.  The result equals the JAX package's
    collect and an exhaustive run (the dense join, exact counting, at the
    clip's largest need: no table cut, no flag raised)."""
    frames = _break_frames() if clip == "break" else _break_frames()[:7]
    cfg = dataclasses.replace(CFG, region_capacity=128)
    got, record = recorded(frames, cfg)
    rungs = [(c[0], c[1], c[6]) for c in ladder]
    want_rungs = [("pass", 128, None), ("pass", 512, None)]
    if clip == "break":
        want_rungs.append(("repair", 2048, [7, 8]))
    assert rungs == want_rungs
    assert record.counters["collect.capacity_outliers"] == (
        2 if clip == "break" else 0)
    assert record.counters["collect.rematched_frames"] == (
        16 + 4 if clip == "break" else 8)
    assert got.overflow_frames == 0
    got = convert.collect_result_to_numpy(got)
    _assert_host_equal(got, convert.collect_result_to_numpy(
        jcollect.collect(frames, jax_twin(cfg))))
    layout = make_layout(96, 64, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    tables, _ = tmodels.GridVote(layout, cfg).features(
        torch.from_numpy(np.stack(frames)))
    need = int(tmodels.grid_vote.kp_need(tables).max())
    assert need == (1216 if clip == "break" else 365)
    exhaustive = dataclasses.replace(cfg, region_capacity=need,
                                     join_multiplicity=0, vote_radius=0)
    ref = tcollect.collect(frames, exhaustive, strict=False, device="cpu")
    assert ref.overflow_frames == 0
    _assert_host_equal(got, convert.collect_result_to_numpy(ref))


FLAGS = ("collect.table_flagged", "collect.join_flagged",
         "collect.range_flagged")


@pytest.mark.parametrize("limit", ["capacity", "multiplicity"])
def test_rung_spans_name_the_limit_that_tripped(limit, recorded):
    """Each rung's span records the limit whose branch the ladder took,
    a repair its multiplicity too, and every pass and repair counts the
    pairs each limit left flagged, each pair once: ``_break_frames`` at
    capacity 128 walks the capacity rungs (a replay at 512, then the
    noise frame's two pairs at 2048), the stripe's tight limits the join
    rungs (one pair repaired at multiplicity 4, then at 16)."""
    if limit == "capacity":
        frames = _break_frames()
        cfg = dataclasses.replace(CFG, region_capacity=128)
        want = [("collect.pass", None, 4, (13, 0, 0)),
                ("collect.pass", "capacity", 4, (2, 0, 0)),
                ("collect.repair", "capacity", 4, (0, 0, 0))]
    else:
        frames, cfg, _ = _stripe_path_frames()
        want = [("collect.pass", None, 1, (0, 1, 0)),
                ("collect.repair", "multiplicity", 4, (0, 1, 0)),
                ("collect.repair", "multiplicity", 16, (0, 0, 0))]
    got, record = recorded(frames, cfg)
    assert got.overflow_frames == 0
    spans = [s for s in record.spans
             if s.name in ("collect.pass", "collect.repair")]
    assert [(s.name, s.attrs.get("limit"), s.attrs["multiplicity"],
             tuple(s.counts[k] for k in FLAGS)) for s in spans] == want
    assert [s.attrs["rung"] for s in spans] == [0, 1, 2]
    for k, n in zip(FLAGS, np.sum([w[3] for w in want], axis=0)):
        assert record.counters[k] == n


@pytest.mark.parametrize("current,needs,n,want", [
    # c64_map_break: 2,045 flagged pairs need 3,349-3,528, the noise
    # frame's two 11,197; the replay at 4096, then the two at 16384
    (512, [3528] * 2045 + [11197] * 2, 2048, 4096),
    (4096, [11197] * 2, 2048, 16384),
    # c64_map_clean: uniform needs, one replay that holds them all
    (512, [3528] * 2047, 2048, 4096),
    # a lone pair: repaired at once at the capacity that holds it
    (128, [1216], 14, 2048),
    # needs past the largest capacity count as held by it: left to a
    # later rung, then taken there (where they give up)
    (4096, [3000] * 10 + [40000] * 2, 12, 8192),
    (8192, [40000] * 2, 12, 16384),
    # a capacity that is no power of two doubles to MAX_CAPACITY
    (3000, [7000] * 9, 10, 12000),
])
def test_rung_capacity_reckons_the_work(current, needs, n, want):
    assert tcollect._rung_capacity(current, np.array(needs, np.int32),
                                   n) == want


@pytest.mark.parametrize("batch", [2, 8])
def test_repair_chunk_smaller_than_its_batch_matches_a_padded_one(batch):
    """``repair_pairs`` sizes its last chunk to the pairs left: three
    pairs (the noise frame's two and an ordinary one, every table
    overflowing at capacity 128) give what the pair step gives them in
    a batch padded to ``frame_batch`` with copies of the last pair:
    offsets, matched flags, the three flags and each pair's need."""
    frames = _break_frames()
    cfg = dataclasses.replace(CFG, region_capacity=128, frame_batch=batch)
    res = tcollect.collect(frames, cfg, strict=False, device="cpu")
    layout = make_layout(96, 64, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    pairs = [3, 7, 8]
    offsets, matched = res.offsets.copy(), res.matched.copy()
    flags = tcollect.repair_pairs(pairs, res.store, layout, cfg, offsets,
                                  matched)

    imgs = torch.from_numpy(np.stack(frames))
    step = tcollect.make_pair_step(layout, cfg)
    rows = []
    for i in range(0, len(pairs), batch):
        chunk = pairs[i:i + batch]
        pad = chunk + [chunk[-1]] * (batch - len(chunk))
        rows.append(step(imgs[[t - 1 for t in pad]],
                         imgs[pad]).numpy()[:len(chunk)])
    off, ok, *want = tcollect.split_step_scalars(np.concatenate(rows))
    assert want[0].all() and want[3].max() == 1216
    np.testing.assert_array_equal(matched[pairs], ok)
    np.testing.assert_array_equal(offsets[pairs],
                                  np.where(ok[:, None], off, 0))
    for g, w in zip(flags, want):
        np.testing.assert_array_equal(g, w)


def test_stitcher_matches_jax():
    """StreamingStitcher push by push (a short last batch included) and
    its fragments, against the JAX stitcher."""
    frames = np.stack(_break_frames())
    cfg = dataclasses.replace(CFG, frame_batch=4)
    want = jstream.StreamingStitcher(jax_twin(cfg))
    got = tstream.StreamingStitcher(cfg, device="cpu")
    for i in range(0, len(frames), 4):
        w_off, w_ok = want.push(frames[i:i + 4])
        g_off, g_ok = got.push(frames[i:i + 4])
        np.testing.assert_array_equal(g_off, w_off)
        np.testing.assert_array_equal(g_ok, w_ok)
    for name in ("frame_no", "overflow_frames", "range_overflow_frames",
                 "needed_capacity"):
        assert getattr(got, name) == getattr(want, name), name
    g_frags, w_frags = got.finish(), want.finish()
    assert len(g_frags) == len(w_frags) == 3
    for g, w in zip(g_frags, w_frags):
        g, w = convert.fragment_to_numpy(g), convert.fragment_to_numpy(w)
        assert g.frames == w.frames
        np.testing.assert_array_equal(g.dots, w.dots)


def test_grid_vote_core_is_one_through_every_step():
    """grid_vote's alignment core (``models.grid_vote``) gives one answer
    through every step that runs it: on the stripe clip with a noise
    frame spliced in (a table overflow, a join truncation and a break),
    the collect step batch by batch with its carry, the ladder's pair
    step on every (t-1, t), the streaming step and the multi-clip step
    give the JAX collect pass's offsets, matches and flags."""
    frames, cfg, rng = _stripe_path_frames()
    frames.insert(5, rng.integers(0, 16, size=(64, 96), dtype=np.uint8))
    n, b = len(frames), cfg.frame_batch
    layout = make_layout(96, 64, cfg.grid_width, cfg.grid_height,
                         cfg.grid_overlap)
    off, ok, tab, join, rng_, kp = jcollect.match_pass(
        frames, jax_twin(layout), jax_twin(cfg))
    assert tab.any() and join.any() and not ok[1:].all()
    imgs = torch.from_numpy(np.stack(frames))

    step = tcollect.make_collect_step(layout, cfg)
    carry = tmodels.family(cfg, layout).empty_carry("cpu")
    rows = []
    for i in range(0, n, b):
        batch = imgs[i:i + b]
        batch = torch.cat([batch, batch[-1:].expand(b - len(batch), -1, -1)])
        median, scalars, carry = step(batch, carry)
        assert torch.equal(median, tstate.pack_nibbles_device(
            tkpe.extract_medians(batch, layout)))
        rows.append(scalars[:min(b, n - i)].numpy())
    c_off, c_ok, c_tab, c_join, c_rng, c_kp = tcollect.split_step_scalars(
        np.concatenate(rows))
    c_ok[0] = False
    np.testing.assert_array_equal(np.where(c_ok[:, None], c_off, 0), off)
    for got, want in ((c_ok, ok), (c_tab, tab), (c_join, join),
                      (c_rng, rng_)):
        np.testing.assert_array_equal(got, want)
    assert c_kp.max() == kp

    pair = tcollect.make_pair_step(layout, cfg)(imgs[:-1], imgs[1:]).numpy()
    p_off, p_ok, p_tab, p_join, p_rng, _ = tcollect.split_step_scalars(pair)
    np.testing.assert_array_equal(np.where(p_ok[:, None], p_off, 0), off[1:])
    np.testing.assert_array_equal(p_ok, ok[1:])
    np.testing.assert_array_equal(p_tab, tab[1:] | tab[:-1])
    np.testing.assert_array_equal(p_join, join[1:])
    np.testing.assert_array_equal(p_rng, rng_[1:])

    init, sstep = tsharded.make_streaming_step(layout, cfg, device="cpu")
    state, got = init(), []
    for i in range(0, n, b):
        s_off, s_ok, flags, _, state = sstep(imgs[i:i + b], state)
        got.append((s_off, s_ok, flags.table, flags.join, flags.range))
    for k, want in enumerate((off, ok, tab, join, rng_)):
        np.testing.assert_array_equal(
            torch.cat([g[k] for g in got]).numpy(), want)

    res = tsharded.make_pipeline_step(layout, cfg, device="cpu")(imgs[None])
    np.testing.assert_array_equal(res.matched[0].numpy(), ok)
    np.testing.assert_array_equal(
        np.where(ok[:, None], res.offsets[0].numpy(), 0), off)


def test_collect_edges():
    """An empty clip gives an empty result; table mode sort2 runs as JAX
    runs it (no chunk overflows on these frames); an unknown table mode
    raises."""
    res = tcollect.collect(iter([]), CFG, device="cpu")
    assert res.fragments == [] and res.offsets.shape == (0, 2)
    frames = _break_frames()[:3]
    got = _collect_both(frames, dataclasses.replace(CFG, table_mode="sort2"))
    assert got.matched[1:].all() and got.overflow_frames == 0
    with pytest.raises(ValueError, match="bogus"):
        tcollect.collect(frames, dataclasses.replace(CFG, table_mode="bogus"),
                         device="cpu")


def _stripe_frames():
    """tests/test_collect.py's sort2 escalation clip: a dense stripe band
    packs far more than SORT2_QUOTA keypoints into a 512-px chunk."""
    rng = np.random.default_rng(11)
    world = rng.integers(0, 16, size=(128, 160), dtype=np.uint8)
    frames = []
    for x, y in [(10, 10), (12, 11), (15, 13), (14, 16)]:
        f = world[y:y + 64, x:x + 96].copy()
        f[8:20] = np.tile(np.array([[1, 9], [9, 1]], np.uint8), (6, 48))
        frames.append(f)
    return frames


@pytest.mark.parametrize("clip,strict", [
    ("stripes", True), ("stripes", False), ("break", True)])
def test_collect_sort2_matches_jax(clip, strict):
    """collect() under table_mode="sort2" equals JAX's: the strict ladder
    meets the chunk-quota flag and switches to the topk tables (JAX's
    ``collect.py:625`` rung), and without the ladder the quota-cut tables
    decide the declarations in both packages alike."""
    frames = _stripe_frames() if clip == "stripes" else _break_frames()
    cfg = dataclasses.replace(CFG, table_mode="sort2", frame_batch=4)
    want = jcollect.collect(frames, jax_twin(cfg), strict=strict)
    got = tcollect.collect(frames, cfg, strict=strict, device="cpu")
    _assert_host_equal(convert.collect_result_to_numpy(got),
                       convert.collect_result_to_numpy(want))
    if strict:
        assert got.overflow_frames == 0
        topk = tcollect.collect(frames, dataclasses.replace(
            cfg, table_mode="topk"), device="cpu")
        np.testing.assert_array_equal(got.offsets, topk.offsets)
        np.testing.assert_array_equal(got.matched, topk.matched)
    else:
        assert got.overflow_frames > 0


# ---- the correlation families ------------------------------------------------

@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_collect_families_match_jax(family):
    """collect() under each correlation family on a clip with a noise
    break, and tests/test_models.py's xcorr clip: offsets, flags and
    canvases equal JAX's; the family raises no escalation flag."""
    cfg = dataclasses.replace(CFG, matcher=family)
    got = _collect_both(_break_frames(), cfg)
    assert np.flatnonzero(~got.matched).tolist() == [0, 7, 8]
    assert len(got.fragments) == 3 and got.overflow_frames == 0
    clip = testing.simple_clip(n_frames=12, frame_hw=(64, 96),
                               world_hw=(160, 224), seed=41)
    got = _collect_both(clip.frames, cfg)
    assert [tuple(o) for o in got.offsets[1:]] == clip.offsets
    assert len(got.fragments) == 1


@pytest.mark.parametrize("batch", [3, 5])
def test_collect_xcorr_carries_the_frame_across_batches(batch, ladder):
    """The last frame carried across batch edges: the offsets at every
    batch size equal the JAX run at frame_batch 8, and the ladder never
    runs a second pass."""
    frames = _break_frames()
    want = convert.collect_result_to_numpy(jcollect.collect(
        frames, jax_twin(dataclasses.replace(CFG, matcher="xcorr"))))
    cfg = dataclasses.replace(CFG, matcher="xcorr", frame_batch=batch)
    got = tcollect.collect(frames, cfg, device="cpu")
    _assert_host_equal(convert.collect_result_to_numpy(got), want)
    assert [c[0] for c in ladder] == ["pass"]


@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_stitcher_families_match_jax(family):
    """StreamingStitcher under each correlation family, push by push with
    a short last batch, and its fragments, against the JAX stitcher."""
    frames = np.stack(_break_frames())
    cfg = dataclasses.replace(CFG, frame_batch=4, matcher=family)
    want = jstream.StreamingStitcher(jax_twin(cfg))
    got = tstream.StreamingStitcher(cfg, device="cpu")
    for i in range(0, len(frames), 4):
        w_off, w_ok = want.push(frames[i:i + 4])
        g_off, g_ok = got.push(frames[i:i + 4])
        np.testing.assert_array_equal(g_off, w_off)
        np.testing.assert_array_equal(g_ok, w_ok)
    for name in ("frame_no", "overflow_frames", "range_overflow_frames",
                 "needed_capacity"):
        assert getattr(got, name) == getattr(want, name), name
    g_frags, w_frags = got.finish(), want.finish()
    assert len(g_frags) == len(w_frags) == 3
    for g, w in zip(g_frags, w_frags):
        g, w = convert.fragment_to_numpy(g), convert.fragment_to_numpy(w)
        assert g.frames == w.frames
        np.testing.assert_array_equal(g.dots, w.dots)


def test_store_budget_auto_by_device():
    assert tcollect.store_budget(CFG, "cpu") == 0
    assert tcollect.store_budget(CFG, "cuda") == tcollect.FrameStore.HBM_STORE_BUDGET
    hbm = dataclasses.replace(CFG, frame_store="hbm")
    assert tcollect.store_budget(hbm, "cpu") == tcollect.FrameStore.HBM_STORE_BUDGET


def test_fragment_host_dots_are_read_only():
    """The lazily materialised host canvas cannot be written in place
    (that would leave the device canvas stale); assigning a new canvas
    still works and drops the device one."""
    got = tcollect.collect(_break_frames()[:4], CFG, device="cpu")
    frag = got.fragments[0]
    dots = frag.dots
    with pytest.raises(ValueError, match="read-only"):
        dots[0, 0, 0] = 1
    fresh = np.zeros_like(dots)
    frag.dots = fresh
    assert frag.dots_dev is None and frag.dots is fresh
    frag.dots[0, 0, 0] = 1
    host = Fragment(dots=np.zeros((3, 4, 16), np.uint16))
    host.dots[0, 0, 0] = 2     # a host canvas given by the caller stays so


@pytest.mark.parametrize("entry", ["collect", "StreamingStitcher"])
def test_collect_entry_points_need_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "collect":
            tcollect.collect(_break_frames()[:2], CFG)
        else:
            tstream.StreamingStitcher(CFG)


@pytest.fixture()
def recorded(monkeypatch):
    """Collect's spans and counters under one ``build`` root, in a store
    of their own."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)

    def run(frames, cfg):
        with profiling.span("build"):
            res = tcollect.collect(frames, cfg, device="cpu")
        return res, rec.records("build")[-1]

    return run


def _replay_clip(n_frames, width):
    return testing.simple_clip(n_frames=n_frames, frame_hw=(64, width),
                               world_hw=(160, 224), seed=61).frames


def _replays(record):
    return [s for s in record.spans
            if s.name == "collect.pass" and s.attrs["rung"] >= 1]


#: capacity 16 overflows every frame's tables, so the ladder replays all
REPLAY_CFG = dataclasses.replace(CFG, region_capacity=16)


@pytest.mark.parametrize("n_frames,width", [(16, 96), (13, 95)])
def test_replay_reads_the_device_mirror(n_frames, width, recorded):
    """A store whose mirror holds every frame ("hbm", on the CPU here)
    feeds the full replay from the mirror: no host pack under the
    replay, every batch gathered in its upload span, the short last one
    padded; results equal the host path's ("host", one host pack a
    replay batch) and the JAX package's, whole batches or a short last
    one at an odd width."""
    frames = _replay_clip(n_frames, width)
    got = {}
    for store in ("hbm", "host"):
        cfg = dataclasses.replace(REPLAY_CFG, screen_width=width,
                                  frame_store=store)
        res, record = recorded(frames, cfg)
        replays = _replays(record)
        assert replays and all(s.attrs["replay"] for s in replays)
        by_id = {s.id: s for s in record.spans}
        packs = [s for s in record.spans if s.name == "collect.host_pack"
                 and by_id[s.parent].attrs["rung"] >= 1]
        batches = -(-n_frames // cfg.frame_batch)
        padded = batches * cfg.frame_batch
        for s in replays:
            uploads = [u for u in record.spans
                       if u.name == "collect.upload" and u.parent == s.id]
            assert len(uploads) == batches
        if store == "hbm":
            assert res.store.mirrored == n_frames
            assert not packs
        else:
            assert len(packs) == batches * len(replays)
        assert record.counters["collect.rematched_frames"] == (
            padded * len(replays))
        got[store] = convert.collect_result_to_numpy(res)
    want = convert.collect_result_to_numpy(jcollect.collect(
        frames, jax_twin(dataclasses.replace(REPLAY_CFG,
                                             screen_width=width))))
    _assert_host_equal(got["hbm"], got["host"])
    _assert_host_equal(got["host"], want)


@pytest.mark.parametrize("dropped_by", ["gap", "budget"])
def test_replay_without_a_mirror_packs_on_the_host(dropped_by, recorded,
                                                   monkeypatch):
    """A mirror dropped during the first pass (a donation that does not
    continue from frame 0, or a budget that holds one batch) leaves the
    replay the host's packed rows, uploaded under ``collect.host_pack``,
    with the same results as a whole mirror."""
    frames = _replay_clip(13, 95)
    cfg = dataclasses.replace(REPLAY_CFG, screen_width=95, frame_store="hbm")
    whole, _ = recorded(frames, cfg)
    if dropped_by == "gap":
        real_put = tstate.FrameStore.put_packed_batch
        calls = []

        def put(self, numbers, packed, medians=None, device_packed=None,
                device_packed_medians=None):
            # the first batch donates no device rows, so the next
            # donation does not continue from frame 0 and the mirror drops
            calls.append(numbers)
            return real_put(self, numbers, packed, medians,
                            None if len(calls) == 1 else device_packed,
                            device_packed_medians)

        monkeypatch.setattr(tstate.FrameStore, "put_packed_batch", put)
    else:
        per_frame = 64 * -(-95 // 2)
        monkeypatch.setattr(tstate.FrameStore, "HBM_STORE_BUDGET",
                            per_frame * cfg.frame_batch)
    res, record = recorded(frames, cfg)
    assert not res.store.mirror_enabled and res.store.mirrored == 0
    by_id = {s.id: s for s in record.spans}
    assert any(s.name == "collect.host_pack"
               and by_id[s.parent].attrs["rung"] >= 1 for s in record.spans)
    _assert_host_equal(convert.collect_result_to_numpy(res),
                       convert.collect_result_to_numpy(whole))
