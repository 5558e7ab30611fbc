"""Port frame feeds, PNG reader, RLE codec and checkpoints
(remap_tpu_torch.io) vs the JAX package's, exact; the feed branches of
the window scan, collect and the builder, and resume from checkpoints
written by either package."""

import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from remap_tpu.core import palette as jpalette
from remap_tpu.core.geometry import Rect as JRect
from remap_tpu.io import checkpoint as jcheckpoint
from remap_tpu.io import codec as jcodec
from remap_tpu.io import frames as jframes
from remap_tpu.pipeline import builder as jbuilder
from remap_tpu.pipeline import collect as jcollect
from remap_tpu.pipeline import window as jwindow
from remap_tpu.spec import nic as jnic
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core import palette as tpalette
from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.io import checkpoint as tcheckpoint
from remap_tpu_torch.io import codec as tcodec
from remap_tpu_torch.io import frames as tframes
from remap_tpu_torch.io import native
from remap_tpu_torch.io import png as tpng
from remap_tpu_torch.pipeline import builder as tbuilder
from remap_tpu_torch.pipeline import collect as tcollect
from remap_tpu_torch.pipeline import window as twindow
from remap_tpu_torch.spec import nic as tnic

from torch_parity import build_jax_native, jax_twin

build_jax_native()

H, W = 31, 45
#: tests/test_pipeline_e2e.py's setup
CFG = PipelineConfig(screen_width=96, screen_height=72, region_capacity=2048,
                     splice_capacity=4096, frame_batch=8)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Seeded raw frames at an odd width under names whose text order is
    not their numeric order, one short file and bytes over 15."""
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 16, size=(12, H, W), dtype=np.uint8)
    imgs[4, 5, 7] = 0xA7
    imgs[9] = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    for i in range(12):
        (d / f"frame{i}.raw").write_bytes(imgs[i].tobytes())
    (d / "frame12.raw").write_bytes(b"xx")
    return d


def _feeds(d, crop=None):
    jcrop = None if crop is None else JRect(**dataclasses.asdict(crop))
    return (tframes.RawDirectoryFeed(str(d), W, H, crop),
            jframes.RawDirectoryFeed(str(d), W, H, jcrop))


CROPS = [None, Rect(left=3, top=2, right=36, bottom=19),
         Rect(left=0, top=0, right=W, bottom=H)]


@pytest.mark.parametrize("crop", CROPS, ids=["full", "crop", "whole"])
def test_raw_feed_matches_jax(raw_dir, crop):
    port, jax_ = _feeds(raw_dir, crop)
    assert port.files == jax_.files
    assert [os.path.basename(f) for f in port.files[:3]] == [
        "frame0.raw", "frame1.raw", "frame2.raw"]
    assert len(port) == len(jax_) == 13
    assert port.out_dims == jax_.out_dims
    for g, w in zip(port, jax_):
        np.testing.assert_array_equal(g, w)
    assert not port.read(12).any()         # short file -> blank
    assert port.read(9).max() <= 15         # bytes over 15 masked
    full = tframes.RawDirectoryFeed(str(raw_dir), W, H)
    if crop is not None:
        np.testing.assert_array_equal(
            full.with_crop(crop).read(4),
            full.read(4)[crop.top:crop.bottom, crop.left:crop.right])


@pytest.mark.parametrize("crop", CROPS, ids=["full", "crop", "whole"])
@pytest.mark.parametrize("start,count", [(0, 13), (1, 4), (9, 8), (13, 4),
                                         (5, 1)])
def test_read_packed_batch_native_plain_and_jax(raw_dir, crop, start, count):
    port, jax_ = _feeds(raw_dir, crop)
    got = port.read_packed_batch(start, count)
    plain = port.read_packed_batch(start, count, native=False)
    want = jax_.read_packed_batch(start, count)
    ch, cw = port.out_dims
    assert got.shape == (max(0, min(count, 13 - start)), ch, (cw + 1) // 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


def test_native_feed_without_its_library_raises(raw_dir, tmp_path,
                                                monkeypatch):
    """A broken native build raises instead of quietly taking the NumPy
    path; the plain packer runs only when asked for."""
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "Makefile").write_text("all:\n\tfalse\nlibremapfeed.so:\n"
                                     "\t@echo no compiler here >&2; false\n"
                                     "libremapcodec.so:\n\tfalse\n")
    monkeypatch.setattr(native, "SOURCE_DIR", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        feed = tframes.RawDirectoryFeed(str(raw_dir), W, H)
        with pytest.raises(RuntimeError, match="no compiler here"):
            feed.read_packed_batch(0, 2)
        with pytest.raises(RuntimeError, match="libremapcodec"):
            tcodec.compress(np.zeros((4, 4), np.uint8))
        np.testing.assert_array_equal(
            feed.read_packed_batch(0, 2, native=False),
            jframes.RawDirectoryFeed(str(raw_dir), W, H).read_packed_batch(
                0, 2))
        img = np.arange(16, dtype=np.uint8).reshape(4, 4)
        assert tcodec.compress(img, native=False) == jnic.compress(img)
        monkeypatch.setattr(native, "SOURCE_DIR", tmp_path / "missing")
        native.library.cache_clear()
        with pytest.raises(RuntimeError, match="native sources not found"):
            feed.read_packed_batch(0, 2)
    finally:
        native.library.cache_clear()


def _rle_frames():
    rng = np.random.default_rng(3)
    out = []
    for k in range(5):
        vals = rng.integers(0, 16, size=400, dtype=np.uint8)
        reps = rng.integers(1, 20 + 10 * k, size=400)
        out.append(np.repeat(vals, reps)[:48 * 52].reshape(48, 52))
    out.append(rng.integers(0, 16, size=(48, 52), dtype=np.uint8))
    out.append(np.full((48, 52), 7, np.uint8))
    return out


def test_codec_matches_jax_and_spec():
    for img in _rle_frames():
        pack = tcodec.compress(img)
        assert pack == jcodec.compress(img) == tnic.compress(img) \
            == jnic.compress(img)
        assert tcodec.compress(img, native=False) == pack
        for native_ in (True, False):
            np.testing.assert_array_equal(
                tcodec.decompress(pack, 52, 48, native=native_), img)


def test_spec_nic_copy_equals_jax_on_damage():
    """The port's spec and native decoders raise ValueError where JAX's
    do, on truncated and corrupt packs."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 16, size=400, dtype=np.uint8)
    reps = rng.integers(1, 40, size=400)
    img = np.repeat(vals, reps)[:64 * 50].reshape(50, 64)
    pack = jnic.compress(img)
    damaged = [pack[:cut] for cut in range(0, len(pack), 7)] + [
        pack + bytes([0x35]),
        bytes([0x40 | (2 << 4) | 1, 0xFF, 0xFF]) + pack]
    for blob in damaged:
        for dec in (lambda b: tcodec.decompress(b, 64, 50),
                    lambda b: tcodec.decompress(b, 64, 50, native=False),
                    lambda b: jcodec.decompress(b, 64, 50)):
            with pytest.raises(ValueError):
                dec(blob)
    rng = np.random.default_rng(5)
    for _ in range(100):
        blob = rng.integers(0, 256, size=int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes()
        outs = []
        for dec in (tcodec.decompress, jcodec.decompress):
            try:
                outs.append(dec(blob, 64, 50))
            except ValueError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------- PNG input

def _pillow_png(path, mode, rng, h=13, w=21):
    Image = pytest.importorskip("PIL.Image")
    if mode.startswith("P"):
        n = int(mode[1:])
        img = Image.fromarray(rng.integers(0, n, (h, w), dtype=np.uint8),
                              mode="P")
        # native colours in a shuffled order, then random ones
        pal = rng.integers(0, 256, (max(n, 16), 3))
        pal[:16] = jpalette.NATIVE_TO_RGB[rng.permutation(16)]
        img.putpalette(pal[:n].reshape(-1).tolist())
    else:
        c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
        shape = (h, w, c) if c > 1 else (h, w)
        # smooth rows, so the writer picks every scanline filter
        arr = np.cumsum(rng.integers(0, 40, shape), axis=1).astype(np.uint8)
        img = Image.fromarray(arr, mode=mode)
    img.save(path)


@pytest.mark.parametrize("mode", ["P16", "P256", "P4", "RGB", "RGBA", "L"])
def test_png_feed_matches_jax_on_pillow_files(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(len(mode) * 7 + ord(mode[-1]))
    for i in (0, 2, 10):
        _pillow_png(str(tmp_path / f"{i}.png"), mode, rng)
    port = tframes.PngDirectoryFeed(str(tmp_path))
    jax_ = jframes.PngDirectoryFeed(str(tmp_path))
    assert port.files == jax_.files
    for g, w in zip(port, jax_):
        np.testing.assert_array_equal(g, w)
    for f in port.files:
        np.testing.assert_array_equal(
            tpng.decode_png(f), np.asarray(Image.open(f).convert("RGB")))
    crop = Rect(left=2, top=1, right=17, bottom=12)
    jcrop = JRect(**dataclasses.asdict(crop))
    np.testing.assert_array_equal(port.with_crop(crop).read(1),
                                  jax_.with_crop(jcrop).read(1))


def test_png_feed_reads_its_own_writer(tmp_path):
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 16, (3, 17, 23), dtype=np.uint8)
    for i, f in enumerate(frames):
        tpng.write_map(str(tmp_path / f"{i}.png"), f)
    port = tframes.PngDirectoryFeed(str(tmp_path))
    jax_ = jframes.PngDirectoryFeed(str(tmp_path))
    for g, w, f in zip(port, jax_, frames):
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(w, f)
    np.testing.assert_array_equal(tframes.rgb_to_native(
        tpalette.native_to_rgb(frames[0])), jframes.rgb_to_native(
        jpalette.native_to_rgb(frames[0])))


@pytest.mark.parametrize("colours", [16, 300, 1 << 24])
def test_rgb_to_native_matches_jax(colours):
    """Nearest native colour, each distinct colour mapped once, equal to
    JAX's per-pixel distances (ties to the first)."""
    rng = np.random.default_rng(colours)
    table = rng.integers(0, 256, (min(colours, 4096), 3), dtype=np.uint8)
    table[:16] = jpalette.NATIVE_TO_RGB
    rgb = table[rng.integers(0, len(table), (37, 53))]
    np.testing.assert_array_equal(tframes.rgb_to_native(rgb),
                                  jframes.rgb_to_native(rgb))


def _png_bytes(w, h, depth, ctype, interlace, raw):
    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype,interlace,what", [
    (16, 2, 0, "bit depth 16"), (4, 0, 0, "bit depth 4"),
    (8, 2, 1, "interlace"), (8, 5, 0, "colour type 5"),
    (8, 3, 0, "PLTE")])
def test_png_reader_names_what_it_does_not_read(tmp_path, depth, ctype,
                                                interlace, what):
    path = tmp_path / "0.png"
    path.write_bytes(_png_bytes(4, 2, depth, ctype, interlace,
                                bytes(2 * (1 + 4 * 6))))
    with pytest.raises(ValueError, match=what):
        tpng.read_png(str(path))


def test_png_reader_rejects_damage(tmp_path):
    good = _png_bytes(4, 2, 8, 2, 0, bytes(2 * 13))
    path = tmp_path / "0.png"
    path.write_bytes(good[:-20] + bytes([good[-20] ^ 1]) + good[-19:])
    with pytest.raises(ValueError, match="damaged"):
        tpng.read_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.read_png(str(path))


def test_batches_match_jax(raw_dir):
    port, jax_ = _feeds(raw_dir)
    got = list(tframes.batches(port, 5))
    want = list(jframes.batches(jax_, 5))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def collected():
    """One small collect result from each package (stored medians)."""
    clip = testing.simple_clip(n_frames=6, frame_hw=(64, 96), seed=51)
    cfg = PipelineConfig(screen_width=96, screen_height=64,
                         region_capacity=2048, frame_batch=4,
                         store_medians=True)
    return (tcollect.collect(clip.frames, cfg, device="cpu"),
            jcollect.collect(clip.frames, jax_twin(cfg)))


def _same_fragments(got, want, store=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.zero == w.zero
        assert [(r.number, tuple(r.position)) for r in g.frames] == [
            (r.number, tuple(r.position)) for r in w.frames]
        np.testing.assert_array_equal(np.asarray(g.dots),
                                      np.asarray(w.dots))
        assert (g.store is None) == (not store)
    if store and got:
        gs, ws = got[0].store, want[0].store
        assert (gs.height, gs.width) == (ws.height, ws.width)
        assert sorted(gs._images) == sorted(ws._images)
        for k in ws._images:
            np.testing.assert_array_equal(gs._images[k], ws._images[k])
            np.testing.assert_array_equal(gs._medians[k], ws._medians[k])


@pytest.mark.parametrize("include_store", [True, False])
def test_port_checkpoint_loads_in_jax(tmp_path, collected, include_store):
    port, _ = collected
    tcheckpoint.save(str(tmp_path), "collect", port.fragments, include_store)
    assert os.path.exists(tmp_path / "collect" / "store.npz") == include_store
    _same_fragments(jcheckpoint.load(str(tmp_path), "collect"),
                    port.fragments, include_store)
    _same_fragments(tcheckpoint.load(str(tmp_path), "collect", "cpu"),
                    port.fragments, include_store)


@pytest.mark.parametrize("include_store", [True, False])
def test_jax_checkpoint_loads_in_port(tmp_path, collected, include_store):
    _, jax_ = collected
    jcheckpoint.save(str(tmp_path), "collect", jax_.fragments, include_store)
    got = tcheckpoint.load(str(tmp_path), "collect", "cpu")
    _same_fragments(got, jax_.fragments, include_store)
    if include_store:
        assert got[0].store.device == torch.device("cpu")


def test_threaded_save_equals_synchronous(tmp_path, collected):
    """The builder's worker-thread save writes the same arrays as a save
    made on the caller's thread, though the fragments change after the
    snapshot."""
    port, _ = collected
    tcheckpoint.save(str(tmp_path / "sync"), "collect", port.fragments)
    pending = tbuilder._save_checkpoint(tbuilder.Callbacks(),
                                        str(tmp_path / "thread"), "collect",
                                        port.fragments)
    saved = [(r.number, r.position) for r in port.fragments[0].frames]
    for r in port.fragments[0].frames:   # later stages may move records
        r.position = (r.position[0] + 5, r.position[1])
    pending.result()
    for r, (_, p) in zip(port.fragments[0].frames, saved):
        r.position = p
    names = sorted(os.listdir(tmp_path / "sync" / "collect"))
    assert names == sorted(os.listdir(tmp_path / "thread" / "collect"))
    for name in names:
        a, b = (tmp_path / k / "collect" / name for k in ("sync", "thread"))
        if name.endswith(".json"):
            assert a.read_text() == b.read_text()
            continue
        da, db = np.load(a), np.load(b)
        assert sorted(da.files) == sorted(db.files)
        for key in da.files:
            np.testing.assert_array_equal(da[key], db[key])


# ---------------------------------------------- the feed through the stages

@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    clip = testing.simple_clip(
        n_frames=30, frame_hw=(72, 96), world_hw=(200, 260), seed=7,
        hud_rows=8, border=4, max_step=4, n_sprites=1, sprite_size=5)
    for i, f in enumerate(clip.frames):
        f.tofile(d / str(i))
    return d, clip.frames


def _clip_feeds(clip_dir, crop=None):
    d, _ = clip_dir
    jcrop = None if crop is None else JRect(**dataclasses.asdict(crop))
    return (tframes.RawDirectoryFeed(str(d), 96, 72, crop),
            jframes.RawDirectoryFeed(str(d), 96, 72, jcrop))


class _Counted(tframes.RawDirectoryFeed):
    """A raw feed that records its packed reads and refuses plain ones."""

    def __init__(self, *args):
        super().__init__(*args)
        self.packed = []

    def read(self, index):
        raise AssertionError("a frame was read and packed on the host")

    def with_crop(self, crop):
        feed = _Counted.__new__(_Counted)
        feed.__dict__.update(self.__dict__, crop=crop)
        return feed

    def read_packed_batch(self, start, count, native=True):
        assert native
        self.packed.append((start, count))
        return super().read_packed_batch(start, count)


@pytest.mark.parametrize("batch", [8, 7])
def test_window_scan_from_feed(clip_dir, batch, tmp_path):
    cfg = dataclasses.replace(CFG, frame_batch=batch)
    feed = _Counted(str(clip_dir[0]), 96, 72)
    got = twindow.scan(feed, cfg, device="cpu")
    assert feed.packed[0] == (0, 1) and feed.packed[1] == (1, batch)
    assert got == twindow.scan(iter(clip_dir[1]), cfg, device="cpu")
    want = jwindow.scan(_clip_feeds(clip_dir)[1], jax_twin(cfg))
    assert convert.window_to_numpy(got) == convert.window_to_numpy(want)
    empty = tframes.RawDirectoryFeed(str(tmp_path), 96, 72)
    assert twindow.scan(empty, cfg, device="cpu") is None


@pytest.mark.parametrize("batch", [8, 7])
def test_collect_from_feed(clip_dir, batch, tmp_path):
    cfg = dataclasses.replace(CFG, frame_batch=batch)
    crop = Rect(left=5, top=5, right=91, bottom=63)
    feed = _Counted(str(clip_dir[0]), 96, 72).with_crop(crop)
    got = tcollect.collect(feed, cfg, device="cpu")
    assert [s for s, _ in feed.packed] == list(range(0, 30, batch))
    frames = [f[5:63, 5:91] for f in clip_dir[1]]
    ref = tcollect.collect(frames, cfg, device="cpu")
    want = jcollect.collect(_clip_feeds(clip_dir, crop)[1], jax_twin(cfg))
    g = convert.collect_result_to_numpy(got)
    for other in (convert.collect_result_to_numpy(ref),
                  convert.collect_result_to_numpy(want)):
        np.testing.assert_array_equal(g.offsets, other.offsets)
        np.testing.assert_array_equal(g.matched, other.matched)
        assert g.overflow_frames == other.overflow_frames
        for a, b in zip(g.fragments, other.fragments):
            assert a.frames == b.frames
            np.testing.assert_array_equal(a.dots, b.dots)
        assert g.fragments[0].store.numbers == other.fragments[0].store.numbers
        np.testing.assert_array_equal(g.fragments[0].store.packed_images,
                                      other.fragments[0].store.packed_images)
    empty = tframes.RawDirectoryFeed(str(tmp_path), 96, 72)
    res = tcollect.collect(empty, cfg, device="cpu")
    assert res.fragments == [] and res.offsets.shape == (0, 2)


@pytest.fixture(scope="module")
def jax_build(clip_dir):
    """JAX's builder on JAX's feed of the clip, with checkpoints."""
    import tempfile

    ckpt = tempfile.mkdtemp()
    res = jbuilder.build(lambda: _clip_feeds(clip_dir)[1], jax_twin(CFG),
                         checkpoint_dir=ckpt)
    yield res, ckpt
    shutil.rmtree(ckpt)


def _same_maps(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.tobytes() == np.asarray(w).tobytes()
        assert g.shape == np.asarray(w).shape


def test_build_from_feed_matches_jax(clip_dir, jax_build, tmp_path):
    want, _ = jax_build
    got = tbuilder.build(lambda: _clip_feeds(clip_dir)[0], CFG,
                         device="cpu", checkpoint_dir=str(tmp_path))
    _same_maps(got.maps, want.maps)
    assert convert.window_to_numpy(got.window) == convert.window_to_numpy(
        want.window)
    for tag in ("collect", "filtered"):
        assert (tmp_path / tag / "meta.json").exists()


def test_build_composes_the_feeds_own_crop(clip_dir):
    """A feed made with its own crop: the window crop composes with it,
    as JAX's builder does (test_pipeline_e2e.py)."""
    crop = Rect(left=2, top=1, right=94, bottom=71)
    tfeed, jfeed = _clip_feeds(clip_dir, crop)
    got = tbuilder.build(lambda: tfeed, CFG, device="cpu")
    want = jbuilder.build(lambda: jfeed, jax_twin(CFG))
    _same_maps(got.maps, want.maps)
    assert convert.window_to_numpy(got.window) == convert.window_to_numpy(
        want.window)


def _untouched():
    raise AssertionError("frame source read during resume")


def test_resume_from_port_checkpoints(clip_dir, jax_build, tmp_path):
    want, _ = jax_build
    tbuilder.build(lambda: _clip_feeds(clip_dir)[0], CFG, device="cpu",
                   checkpoint_dir=str(tmp_path))
    r1 = tbuilder.build(_untouched, CFG, device="cpu",
                        checkpoint_dir=str(tmp_path), resume=True)
    _same_maps(r1.maps, want.maps)
    assert r1.window is None and r1.collect is None
    shutil.rmtree(tmp_path / "filtered")
    r2 = tbuilder.build(_untouched, CFG, device="cpu",
                        checkpoint_dir=str(tmp_path), resume=True)
    _same_maps(r2.maps, want.maps)
    assert (tmp_path / "filtered" / "meta.json").exists()
    # JAX resumes the port's collect checkpoint to the same maps
    shutil.rmtree(tmp_path / "filtered")
    r3 = jbuilder.build(_untouched, jax_twin(CFG),
                        checkpoint_dir=str(tmp_path), resume=True)
    _same_maps([np.asarray(m) for m in r3.maps], want.maps)


def test_resume_from_jax_checkpoints(jax_build, tmp_path):
    want, ckpt = jax_build
    shutil.copytree(ckpt, tmp_path / "ck")
    d = str(tmp_path / "ck")
    r1 = tbuilder.build(_untouched, CFG, device="cpu", checkpoint_dir=d,
                        resume=True)
    _same_maps(r1.maps, want.maps)
    shutil.rmtree(tmp_path / "ck" / "filtered")
    r2 = tbuilder.build(_untouched, CFG, device="cpu", checkpoint_dir=d,
                        resume=True)
    _same_maps(r2.maps, want.maps)


def test_resume_without_checkpoint_runs_in_full(clip_dir, jax_build,
                                                tmp_path):
    want, _ = jax_build
    got = tbuilder.build(lambda: _clip_feeds(clip_dir)[0], CFG,
                         device="cpu", checkpoint_dir=str(tmp_path / "new"),
                         resume=True)
    _same_maps(got.maps, want.maps)


def test_checkpoint_callbacks(clip_dir, tmp_path):
    seen = []

    class Record(tbuilder.Callbacks):
        def on_checkpoint(self, tag, seconds):
            seen.append((tag, seconds >= 0))

    tbuilder.build(lambda: _clip_feeds(clip_dir)[0], CFG, device="cpu",
                   callbacks=Record(), checkpoint_dir=str(tmp_path))
    assert seen == [("collect", True), ("filtered", True)]
