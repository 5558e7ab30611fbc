"""Port splice stage (remap_tpu_torch.ops.splice, pipeline.splice) vs the
JAX package, exact: the slot join's splice outputs, the cellular matcher
in its slot and dense forms, the bucketed snippet tables, the need read
from the join's code sort, the multiplicities ``_match`` walks, canvas
merges and whole ``splice()`` runs (fragments compared through
``convert``)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.core.regions import make_layout as jmake_layout
from remap_tpu.ops import kpe as jkpe
from remap_tpu.ops import kpm as jkpm
from remap_tpu.ops import splice as jsplice_ops
from remap_tpu.ops import tables as jtab
from remap_tpu.pipeline import collect as jcollect
from remap_tpu.pipeline import splice as jsplice
from remap_tpu.pipeline import state as jstate
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.ops import kpe as tkpe
from remap_tpu_torch.ops import kpm as tkpm
from remap_tpu_torch.ops import splice as tsplice_ops
from remap_tpu_torch.ops import tables as ttab
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.pipeline import splice as tsplice
from remap_tpu_torch.utils import profiling

from torch_parity import jax_twin, to_numpy, to_torch

#: tests/test_pipeline_e2e.py::test_splice_merges_like_spec's setup
CFG = PipelineConfig(screen_width=96, screen_height=64, region_capacity=2048,
                     splice_capacity=4096, frame_batch=8)


# ---- the slot join's splice outputs ----------------------------------------

def _repeated_tables(seed: int, k: int = 96, pool: int = 0):
    """Two tables of ``k`` rows whose codes repeat (2-9 distinct values a
    word, or rows drawn from ``pool`` distinct quadruples), positions in
    [0, 3000), 80% valid (tests/test_ops_splice.py)."""
    rng = np.random.default_rng(seed)
    reps = rng.integers(2, 10)
    codes = rng.integers(1, reps + 2, size=(2, k, 4)).astype(np.uint32)
    if pool:
        rows = rng.integers(0, 1 << 32, size=(pool, 4), dtype=np.uint64)
        codes = rows[rng.integers(0, pool, size=(2, k))].astype(np.uint32)
    pos = rng.integers(0, 3000, size=(2, k, 2)).astype(np.int32)
    valid = rng.random((2, k)) < 0.8
    return codes, pos, valid


@pytest.mark.parametrize("mult", [1, 2, 4, 8])
def test_join_slots_scan_matches_jax(mult):
    codes, pos, valid = _repeated_tables(77 + mult, pool=12)
    want = jkpm._join_slots_scan(
        jnp.asarray(codes[0]), jnp.asarray(pos[0]), jnp.asarray(valid[0]),
        jnp.asarray(codes[1]), jnp.asarray(pos[1]), jnp.asarray(valid[1]),
        mult)
    got = tkpm._join_slots(
        to_torch(codes[0])[None], to_torch(pos[0])[None],
        to_torch(valid[0])[None], to_torch(codes[1])[None],
        to_torch(pos[1])[None], to_torch(valid[1])[None], mult,
        coord_limit=8192, curr=True)
    dx, dy, pair, n_missed, rows_missed, cx, cy, needed = (
        to_numpy(t[0]) for t in got)
    wdx, wdy, wpair = (np.asarray(t) for t in want[:3])
    np.testing.assert_array_equal(pair, wpair)
    # slots without a pair hold no partner: compare where a pair is
    np.testing.assert_array_equal(dx[pair], wdx[wpair])
    np.testing.assert_array_equal(dy[pair], wdy[wpair])
    assert int(n_missed) == int(want[3])
    assert int(rows_missed) == int(want[4])
    np.testing.assert_array_equal(cx, np.asarray(want[5]))
    np.testing.assert_array_equal(cy, np.asarray(want[6]))
    assert int(needed) == int(want[7])
    assert int(needed) > 4 and (mult > 4 or int(n_missed) > 0)


def test_join_dense_curr_outputs_match_jax():
    codes, pos, valid = _repeated_tables(5, pool=12)
    want = jkpm._join_dense(
        jnp.asarray(codes[0]), jnp.asarray(pos[0]), jnp.asarray(valid[0]),
        jnp.asarray(codes[1]), jnp.asarray(pos[1]), jnp.asarray(valid[1]))
    got = tkpm._join_dense(
        to_torch(codes[0])[None], to_torch(pos[0])[None],
        to_torch(valid[0])[None], to_torch(codes[1])[None],
        to_torch(pos[1])[None], to_torch(valid[1])[None], curr=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g[0]), np.asarray(w))


# ---- the cellular matcher ---------------------------------------------------

def _snippet_tables(image, capacity=4096):
    """JAX whole-image tables of ``image`` (tests/test_ops_splice.py)."""
    h, w = image.shape
    layout = jmake_layout(w, h, 1, 1, 0)
    dense = jkpe.extract_dense(jnp.asarray(image[None]), layout)
    tabs = jtab.extract_tables(dense.weight, dense.codes, layout, capacity)
    return (np.asarray(tabs.codes[0, 0]), np.asarray(tabs.pos[0, 0]),
            np.asarray(tabs.valid[0, 0]))


def _mask_bucket(mask):
    h, w = mask.shape
    mb = np.zeros((-(-h // 128) * 128, -(-w // 128) * 128), np.uint8)
    mb[:h, :w] = mask
    return mb


def _setup(kind: str):
    """(image a, mask a, image b, mask b) of tests/test_ops_splice.py."""
    if kind == "disjoint":
        a = testing.make_world(120, 160, np.random.default_rng(6))[10:90,
                                                                   10:130]
        b = testing.make_world(120, 160, np.random.default_rng(7))[10:90,
                                                                   10:130]
        return a, np.ones(a.shape, np.uint8), b, np.ones(b.shape, np.uint8)
    if kind == "stamps":
        rng = np.random.default_rng(21)
        world = np.zeros((220, 280), np.uint8)
        stamp = rng.integers(0, 16, size=(13, 13), dtype=np.uint8)
        for y in range(5, 200, 22):
            for x in range(5, 260, 22):
                world[y:y + 13, x:x + 13] = stamp
        a, b = world[10:130, 10:180], world[50:180, 45:260]
        return a, np.ones(a.shape, np.uint8), b, np.ones(b.shape, np.uint8)
    seed = 5 if kind == "overlap" else 8
    world = testing.make_world(200, 260, np.random.default_rng(seed))
    a = world[10:110, 10:150].copy()
    b = world[40:150, 35:200].copy()
    ma = np.ones(a.shape, np.uint8)
    if kind == "partial":
        ma[:, :40] = 0   # the left band of a is empty
        a[:, :40] = 0
    return a, ma, b, np.ones(b.shape, np.uint8)


def _pair(kind: str, swap: bool = False):
    """(tables of a, tables of b, a's mask bucket, a's dims, b's dims) of
    a :func:`_setup` pair, ``swap``ped: b's tables and mask first."""
    a, ma, b, mb = _setup(kind)
    if swap:
        a, ma, b, mb = b, mb, a, ma
    # the smallest power of two that holds both tables (stamps overflow
    # at any capacity here: both sides get the same truncated tables)
    cap = 2048 if kind in ("disjoint", "stamps") else 4096
    return (_snippet_tables(a, cap), _snippet_tables(b, cap), _mask_bucket(ma),
            (a.shape[1], a.shape[0]), (b.shape[1], b.shape[0]))


#: a batch's rows: every kind both ways round, so the rows differ in
#: heads, masks, dims and needs (stamps' codes repeat: its need passes
#: multiplicity 1 and 16 beside rows whose need does not)
_ROWS = [(kind, swap) for kind in ("stamps", "overlap", "partial",
                                   "disjoint") for swap in (False, True)]


def _batch_rows(n: int):
    """``n`` rows of :data:`_ROWS` in turn, at one capacity (2048: the
    larger tables cut there, alike on both sides) and one mask bucket, as
    splice's pad state gives them."""
    rows = []
    for i in range(n):
        ta, tb, mask, da, db = _pair(*_ROWS[i % len(_ROWS)])
        rows.append([tuple(t[:2048] for t in ta),
                     tuple(t[:2048] for t in tb), mask, da, db])
    hb = max(r[2].shape[0] for r in rows)
    wb = max(r[2].shape[1] for r in rows)
    for r in rows:
        m = np.zeros((hb, wb), np.uint8)
        m[:r[2].shape[0], :r[2].shape[1]] = r[2]
        r[2] = m
    return rows


def _batched_args(rows):
    """The port's batched arguments of ``rows`` (tables, mask, dims)."""
    tabs = [to_torch(np.stack([r[0][i] if i < 3 else r[1][i - 3]
                               for r in rows])) for i in range(6)]
    return (*tabs, to_torch(np.stack([r[2] for r in rows])),
            torch.tensor([r[3] for r in rows]),
            torch.tensor([r[4] for r in rows]))


_FIELDS = ("offset", "count", "ok", "overflow", "needed_multiplicity")
_MULTS = {"slot1": 1, "slot16": 16, "dense": 0}


@pytest.mark.parametrize(
    "kind,mult",
    [(k, m) for k in ("overlap", "disjoint", "partial", "stamps", "batch3")
     for m in _MULTS] + [("batch17", "slot1"), ("batch17", "slot16")],
    ids=lambda v: v)
def test_match_fragments_matches_jax(kind, mult):
    """One pair (a batch of one) against the JAX package; a batch of 3 or
    17 pairs that differ in heads, masks, dims and needs, each row equal
    to its own one-pair call and to the JAX package's."""
    mult = _MULTS[mult]
    if not kind.startswith("batch"):
        rows = [list(_pair(kind))]
    else:
        rows = _batch_rows(int(kind[5:]))
    got = tsplice_ops.match_fragments(*_batched_args(rows),
                                      multiplicity=mult)
    assert got.ok.shape == (len(rows),) and got.offset.shape == (len(rows), 2)
    jax_of = {}
    for i, (ta, tb, mask, da, db) in enumerate(rows):
        key = i % len(_ROWS)
        if key not in jax_of:
            jax_of[key] = jsplice_ops.match_fragments(
                *(jnp.asarray(t) for t in ta + tb), jnp.asarray(mask),
                jnp.asarray(np.array(da, np.int32)),
                jnp.asarray(np.array(db, np.int32)), multiplicity=mult)
        one = tsplice_ops.match_fragments(*_batched_args([rows[i]]),
                                          multiplicity=mult)
        for name in _FIELDS:
            row = to_numpy(getattr(got, name)[i])
            np.testing.assert_array_equal(
                row, to_numpy(getattr(one, name)[0]), err_msg=name)
            np.testing.assert_array_equal(
                row, np.asarray(getattr(jax_of[key], name)), err_msg=name)
    if kind == "overlap" and mult != 1:
        assert bool(got.ok[0]) and got.offset[0].tolist() == [25, 30]
    if kind.startswith("batch") and mult:
        # rows that overflow their join beside rows that do not
        assert 0 < int(got.overflow.sum()) < len(rows)


# ---- snippets ---------------------------------------------------------------

def _fragment_dots(ch: int, cw: int, seed: int = 31) -> np.ndarray:
    """A clean canvas of awkward dims (blend == the world) with an empty
    band at the top (tests/test_ops_splice.py)."""
    world = testing.make_world(ch, cw, np.random.default_rng(seed))
    dots = np.zeros((ch, cw, 16), np.uint16)
    ys, xs = np.indices((ch, cw))
    dots[ys, xs, world] = 3
    dots[:7, :, :] = 0
    return dots


def test_bucketed_snippet_equals_exact_canvas_and_jax():
    ch, cw = 187, 309
    dots = _fragment_dots(ch, cw)
    cfg = dataclasses.replace(CFG, screen_width=cw, screen_height=ch)
    jfrag = jstate.Fragment(dots=dots, zero=(0, 0), frames=[], store=None)
    snip = tsplice._extract_snippet(convert.fragment_from_numpy(jfrag, "cpu"),
                                    cfg)
    want = jsplice._extract_snippet(jfrag, jax_twin(cfg))

    # the exact canvas through the port's plain extraction and tables
    image = torch.as_tensor(dots.argmax(axis=2).astype(np.uint8))[None]
    layout = make_layout(cw, ch, 1, 1, 0)
    dense = tkpe.extract_dense(image, layout)
    total = int((dense.weight > 0).sum())
    cap = cfg.splice_capacity
    while cap < total:
        cap *= 4
    exact = ttab.build_tables(dense.weight, dense.codes, layout, cap)

    valid = to_numpy(snip.valid)
    assert snip.codes.shape[0] == cap == want.codes.shape[0]
    assert valid.sum() == total
    np.testing.assert_array_equal(valid, to_numpy(exact.valid[0, 0]))
    np.testing.assert_array_equal(valid, want.valid)
    for name in ("codes", "pos"):
        got = to_numpy(getattr(snip, name), getattr(want, name))
        np.testing.assert_array_equal(
            got[valid], to_numpy(getattr(exact, name)[0, 0],
                                 getattr(want, name))[valid])
        np.testing.assert_array_equal(got[valid],
                                      getattr(want, name)[valid])
    np.testing.assert_array_equal(to_numpy(snip.mask_bucket),
                                  want.mask_bucket)
    assert snip.dims == want.dims == (cw, ch)


@pytest.mark.parametrize("trial,n", [(t, 1) for t in range(4)]
                         + [(4, 3), (5, 17)],
                         ids=[str(t) for t in range(4)] + ["n3", "n17"])
def test_needed_multiplicity_matches_jax(trial, n):
    """The need read from the join's code sort equals the JAX package's
    host estimate and the slot join's own ``needed_m``: one pair, and
    each row of a batch of 3 or 17 pairs of different tables."""
    pairs = [_repeated_tables(90 + trial + i) for i in range(n)]

    class T:
        pass

    want = []
    for codes, _, valid in pairs:
        jh, jo = T(), T()
        jh.codes, jh.valid = codes[0], valid[0]
        jo.codes, jo.valid = codes[1], valid[1]
        want.append(jsplice._needed_multiplicity(jh, jo))
    tabs = [to_torch(np.stack([p[j][i] for p in pairs]))
            for i in range(2) for j in range(3)]
    tables = tsplice_ops.sort_tables(*tabs)
    assert tables.need.shape == (n,)
    assert tsplice._needed_multiplicity(tables) == want
    join = tkpm._join_slots(*tabs, 4, coord_limit=8192, curr=True)
    assert join[7].tolist() == want
    for i in range(n):
        one = tsplice_ops.sort_tables(*(t[i:i + 1] for t in tabs))
        for got, row in zip(tables.rows, one.rows):
            assert torch.equal(got[i], row[0])
    if n > 1:
        assert len(set(want)) > 1


@pytest.mark.parametrize("at", ["under", "need", "dense"])
def test_match_fragments_takes_sorted_rows(at):
    """``match_fragments`` on rows sorted by ``sort_tables`` equals its own
    sort: a multiplicity under the need (overflow), at it, and dense."""
    a, ma, b, _ = _setup("stamps")
    ta, tb = _snippet_tables(a, 2048), _snippet_tables(b, 2048)
    tabs = [to_torch(t)[None] for t in ta + tb]
    tables = tsplice_ops.sort_tables(*tabs)
    need = int(tables.need[0])
    assert need > 1
    m = {"under": 1, "need": need, "dense": 0}[at]
    args = (*tabs, to_torch(_mask_bucket(ma))[None],
            torch.tensor([[a.shape[1], a.shape[0]]]),
            torch.tensor([[b.shape[1], b.shape[0]]]))
    want = tsplice_ops.match_fragments(*args, multiplicity=m)
    got = tsplice_ops.match_fragments(*args, multiplicity=m,
                                      rows=tables.rows)
    for name in _FIELDS:
        np.testing.assert_array_equal(
            to_numpy(getattr(got, name)), to_numpy(getattr(want, name)),
            err_msg=name)
    assert bool(got.overflow[0]) == (at == "under")
    if m:
        assert int(got.needed_multiplicity[0]) == need


def _both_snippets(a, ma, b, mb, cfg):
    """JAX and port snippets of two canvases whose blends are ``a``/``b``
    under masks ``ma``/``mb``."""
    out = []
    for img, mask in ((a, ma), (b, mb)):
        dots = np.zeros(img.shape + (16,), np.uint16)
        ys, xs = np.indices(img.shape)
        dots[ys, xs, img] = 2 * mask
        jfrag = jstate.Fragment(dots=dots, zero=(0, 0), frames=[],
                                store=None)
        out.append((jsplice._extract_snippet(jfrag, jax_twin(cfg)),
                    tsplice._extract_snippet(
                        convert.fragment_from_numpy(jfrag, "cpu"), cfg)))
    return out


@pytest.mark.parametrize("case", ["plain", "jump", "retry"])
def test_match_walks_jax_multiplicities(case, monkeypatch):
    """The multiplicities ``_match`` runs the matcher at, recorded on both
    sides: the default, the jump to the measured need, and (with the need
    forced to 0) the overflow retry at the join's own measure."""
    a, ma, b, mb = _setup("overlap" if case == "plain" else "stamps")
    cfg = dataclasses.replace(CFG, join_multiplicity=1)
    (jh, th), (jo, to) = _both_snippets(a, ma, b, mb, cfg)
    walked = {"jax": [], "port": []}

    def recorder(mod, key):
        real = mod.match_fragments

        def rec(*args, **kwargs):
            walked[key].append(kwargs["multiplicity"])
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, "match_fragments", rec)

    recorder(jsplice.splice_ops, "jax")
    recorder(tsplice.splice_ops, "port")
    if case == "retry":
        monkeypatch.setattr(jsplice, "_needed_multiplicity", lambda h, o: 0)
        monkeypatch.setattr(tsplice, "_needed_multiplicity",
                            lambda t: [0] * len(t.need))
    want = jsplice._match(jh, jo, jax_twin(cfg))
    builds = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", builds)
    with profiling.span("build"):
        got = tsplice._match(th, to, cfg)
    assert got == want
    assert walked["port"] == walked["jax"]
    assert len(walked["port"]) == (2 if case == "retry" else 1)
    # every vote a batch of its own, the retry's too
    c = builds.records("build")[-1].counters
    assert c["splice.batches"] == len(walked["port"])
    assert c.get("splice.retries", 0) == len(walked["port"]) - 1
    if case != "plain":
        assert walked["port"][-1] > 1


def test_match_pairs_batches_equal_one_pair_matches(monkeypatch):
    """A round of 15 pairs of six snippets at multiplicity 1 in chunks of
    4 pairs: the stamps pairs' needs jump into sub-batches of their own
    beside pairs that do not, and every pair's vote equals its one-pair
    ``_match`` and the JAX package's ``_match`` at the same pad state;
    one code sort a chunk, one vote a sub-batch, no retry."""
    cfg = dataclasses.replace(CFG, join_multiplicity=1)
    snippets = []
    for kind in ("overlap", "stamps", "disjoint"):
        snippets += _both_snippets(*_setup(kind), cfg)
    jpad, tpad = jsplice._PadState(), tsplice._PadState()
    jpad.update([j for j, _ in snippets])
    tpad.update([t for _, t in snippets])
    monkeypatch.setattr(tsplice, "JOIN_SLOTS", 4 * 2 * tpad.cap)
    assert tsplice._batch_pairs(1, tpad.cap) == 4
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    want = [jsplice._match(snippets[i][0], snippets[j][0], jax_twin(cfg),
                           jpad) for i, j in pairs]
    one = [tsplice._match(snippets[i][1], snippets[j][1], cfg, tpad)
           for i, j in pairs]

    votes = []
    real = tsplice.splice_ops.match_fragments

    def rec(*args, **kwargs):
        votes.append((args[0].shape[0], kwargs["multiplicity"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tsplice.splice_ops, "match_fragments", rec)
    recorder = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", recorder)
    with profiling.span("build"):
        got = tsplice._match_pairs(
            [(snippets[i][1], snippets[j][1]) for i, j in pairs], cfg, tpad)
    assert got == one == want
    assert any(v is not None for v in got)
    record = recorder.records("build")[-1]
    c = record.counters
    spans = [s for s in record.spans if s.name == "splice.match"]
    assert [s.attrs["pairs"] for s in spans] == [4, 4, 4, 3]
    assert c["splice.matches"] == 15 and c.get("splice.retries", 0) == 0
    assert 0 < c["splice.jumps"] < 15
    assert c["splice.batches"] == len(votes) > len(spans)
    assert sum(n for n, _ in votes) == 15
    assert {m for _, m in votes} > {1}
    assert len([s for s in record.spans if s.name == "splice.need"]) == 4


# ---- merges -----------------------------------------------------------------

def _merge_pair(seed: int):
    """Two JAX fragments with canvases near the uint16 wrap."""
    rng = np.random.default_rng(seed)
    frags = []
    for h, w, n in ((64, 96, 3), (70, 90, 2)):
        dots = rng.integers(65500, 65536, size=(h, w, 16)).astype(np.uint16)
        dots[rng.random((h, w)) < 0.3] = 0
        frames = [jstate.FrameRef(i, (3 * i, i)) for i in range(n)]
        frags.append(jstate.Fragment(dots=dots, zero=(0, 0), frames=frames,
                                     store=None))
    return frags


@pytest.mark.parametrize("offset", [(-30, 0), (40, 0), (0, -20), (0, 25),
                                    (-130, -90), (10, 5)],
                         ids=["left", "right", "top", "bottom", "far",
                              "inside"])
def test_merge_fragments_matches_jax(offset):
    jl, jr = _merge_pair(abs(sum(offset)) + 200)
    want = jsplice.merge_fragments(jl, jr, offset, (96, 64))
    got = tsplice.merge_fragments(convert.fragment_from_numpy(jl, "cpu"),
                                  convert.fragment_from_numpy(jr, "cpu"),
                                  offset, (96, 64))
    g, w = convert.fragment_to_numpy(got), convert.fragment_to_numpy(want)
    assert g.zero == w.zero == (0, 0)
    assert g.frames == w.frames
    np.testing.assert_array_equal(g.dots, w.dots)
    # the add wrapped somewhere
    assert (g.dots < np.asarray(jl.dots).max()).any()


def test_merge_canvas_misfit_raises():
    """A block that does not fit the grown canvas raises instead of being
    clamped into place (as ``lax.dynamic_update_slice`` would)."""
    left = torch.zeros((16, 64, 64), dtype=torch.int32)
    right = torch.ones((16, 32, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        tsplice._merge_canvas(left, (64, 64), right, (32, 32), (0, 0, 0, 0),
                              (40, 0))
    with pytest.raises(ValueError, match="does not fit"):
        tsplice._merge_canvas(left, (64, 64), right, (32, 32), (0, 0, 0, 0),
                              (-1, 0))
    out, shape = tsplice._merge_canvas(left, (64, 64), right, (32, 32),
                                       (0, 0, 0, 16), (40, 0))
    assert shape == (64, 80) and int(out[:, :32, 40:72].min()) == 1


# ---- splice() ----------------------------------------------------------------

def _world_clips(paths, noise_between: bool, seed: int = 11):
    rng = np.random.default_rng(seed)
    world = testing.make_world(160, 224, rng)
    frames = []
    for i, path in enumerate(paths):
        if i and noise_between:
            frames.append(rng.integers(0, 16, size=(64, 96), dtype=np.uint8))
        frames += testing.render_clip(world, path, (64, 96)).frames
    return frames


def _splice_both(frames, expect_in: int, expect_out: int, cfg=CFG):
    jcol = jcollect.collect(frames, jax_twin(cfg))
    tcol = tcollect.collect(frames, cfg, device="cpu")
    assert len(jcol.fragments) == len(tcol.fragments) == expect_in
    want = jsplice.splice(jcol.fragments, jax_twin(cfg))
    got = tsplice.splice(tcol.fragments, cfg)
    assert len(got) == len(want) == expect_out
    for g, w in zip(got, want):
        g, w = convert.fragment_to_numpy(g), convert.fragment_to_numpy(w)
        assert g.zero == w.zero
        assert g.frames == w.frames
        np.testing.assert_array_equal(g.dots, w.dots)
    return got


def test_splice_two_worlds_and_noise_match_jax():
    """tests/test_pipeline_e2e.py::test_splice_merges_like_spec's frames:
    3 collect fragments, the two world ones merge, the noise frame stays."""
    frames = _world_clips([[(20 + i, 30) for i in range(8)],
                           [(40 + i, 34) for i in range(8)]], True)
    got = _splice_both(frames, 3, 2)
    assert sorted(len(f.frames) for f in got) == [1, 16]


def test_splice_four_worlds_match_jax():
    """4 overlapping world fragments split by 3 noise frames: the greedy
    loop merges in vote order, re-extracts and re-matches the merged
    snippet at the front, so its order and ties are exercised."""
    paths = [[(20 + i, 30) for i in range(6)],
             [(40 + i, 34) for i in range(6)],
             [(30 + i, 50) for i in range(6)],
             [(60 + i, 40) for i in range(6)]]
    got = _splice_both(_world_clips(paths, True, seed=12), 7, 4)
    assert sorted(len(f.frames) for f in got) == [1, 1, 1, 24]


def test_splice_empty_and_other_matchers():
    for matcher in ("grid_vote", "xcorr", "pyramid"):
        assert tsplice.splice([], dataclasses.replace(CFG,
                                                      matcher=matcher)) == []


# ---- the correlation families -------------------------------------------------

@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_splice_families_match_jax(family):
    """Collect and splice under each correlation family on the two-world
    session with a noise frame: the world fragments merge, the noise
    frame stays, canvases and records equal JAX's."""
    frames = _world_clips([[(20 + i, 30) for i in range(8)],
                           [(40 + i, 34) for i in range(8)]], True)
    got = _splice_both(frames, 3, 2, dataclasses.replace(CFG,
                                                         matcher=family))
    assert sorted(len(f.frames) for f in got) == [1, 16]


@pytest.mark.parametrize("family", ["xcorr", "pyramid"])
def test_splice_family_fragments_match_jax(family):
    """tests/test_splice_xcorr.py::test_splice_family_end_to_end's two
    hand-blitted fragments (no store): one merged fragment, equal to
    JAX's, and the correlation snippets' bucketed images and masks equal
    JAX's."""
    world = testing.make_world(300, 340, np.random.default_rng(12))
    fh, fw = 96, 128

    def frag(x0, y0, n, dx):
        dots = np.zeros((fh, fw + (n - 1) * dx, 16), np.uint16)
        frames = []
        for i in range(n):
            f = world[y0:y0 + fh, x0 + i * dx:x0 + i * dx + fw]
            dots[:, i * dx:i * dx + fw] += (
                f[..., None] == np.arange(16, dtype=np.uint8))
            frames.append(jstate.FrameRef(i, (x0 + i * dx, y0)))
        return jstate.Fragment(dots=dots, zero=(x0, y0), frames=frames,
                               store=None)

    cfg = dataclasses.replace(PipelineConfig(screen_width=fw,
                                             screen_height=fh),
                              matcher=family)
    jfrags = [frag(10, 30, 3, 16), frag(10 + 2 * 16 + 24, 30, 3, 16)]
    tfrags = [convert.fragment_from_numpy(f, "cpu") for f in jfrags]
    for jf, tf in zip(jfrags, tfrags):
        want = jsplice._extract_snippet(jf, jax_twin(cfg))
        got = tsplice._extract_snippet(tf, cfg)
        assert got.dims == want.dims
        np.testing.assert_array_equal(to_numpy(got.image_bucket),
                                      want.image_bucket)
        np.testing.assert_array_equal(to_numpy(got.mask_bucket),
                                      want.mask_bucket)
    want = jsplice.splice(jfrags, jax_twin(cfg), frame_dims=(fw, fh))
    got = tsplice.splice(tfrags, cfg, frame_dims=(fw, fh))
    assert len(got) == len(want) == 1
    g, w = convert.fragment_to_numpy(got[0]), convert.fragment_to_numpy(
        want[0])
    assert g.zero == w.zero and g.frames == w.frames
    np.testing.assert_array_equal(g.dots, w.dots)
    xs = sorted(fr.position[0] for fr in got[0].frames)
    assert [x - xs[0] for x in xs] == [0, 16, 32, 56, 72, 88]
