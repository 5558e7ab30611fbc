"""The port's own copies of the JAX package's JAX-free modules, held equal
to the originals: config, grid layout, palette tables, nibble packers,
the frame store's host rows and mirror rules, canvas growth, and the clip
makers."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import bench
from remap_tpu import config as jconfig
from remap_tpu.core import palette as jpalette
from remap_tpu.core import regions as jregions
from remap_tpu.pipeline import state as jstate
from remap_tpu.utils import testing
from remap_tpu_torch import config as tconfig
from remap_tpu_torch import convert
from remap_tpu_torch.core import palette as tpalette
from remap_tpu_torch.core import regions as tregions
from remap_tpu_torch.pipeline import state as tstate
from remap_tpu_torch.utils import clips

from torch_parity import to_numpy, to_torch


def _defaults(cls) -> dict:
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["MatchConfig", "PipelineConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jax_cls, port_cls = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(port_cls)] == [
        f.name for f in dataclasses.fields(jax_cls)]
    want = _defaults(jax_cls)
    got = _defaults(port_cls)
    if name == "PipelineConfig":
        assert dataclasses.asdict(got.pop("match")) == dataclasses.asdict(
            want.pop("match"))
    assert got == want


@pytest.mark.parametrize("cfg", [
    jconfig.PipelineConfig(),
    jconfig.NES,
    jconfig.PipelineConfig(screen_width=64, screen_height=48, frame_batch=4,
                           region_capacity=2048, store_medians=True,
                           match=jconfig.MatchConfig(weight_switch=7,
                                                     region_votes=2),
                           splice_cell=(9, 11), table_mode="topk"),
], ids=["default", "nes", "custom"])
def test_config_from_dict_round_trips(cfg):
    port = convert.config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port, tconfig.PipelineConfig)
    assert isinstance(port.match, tconfig.MatchConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.screen_dims == cfg.screen_dims
    assert port.region_count == cfg.region_count
    assert port.kernel_half == cfg.kernel_half
    assert convert.config_from_dict(dataclasses.asdict(port)) == port


@pytest.mark.parametrize("name", ["NES", "SNES", "C64", "VGA"])
def test_config_presets_match_jax(name):
    got, want = getattr(tconfig, name), getattr(jconfig, name)
    assert isinstance(got, tconfig.PipelineConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


#: the sizes the repo runs (NES, C64, gameplay, the test clips, VGA) and
#: the layout arguments the port's tests and chip_smoke.py use
@pytest.mark.parametrize("size", [(256, 240), (388, 312), (372, 272),
                                  (96, 64), (640, 480), (64, 48), (56, 40),
                                  (160, 60), (61, 37)])
@pytest.mark.parametrize("grid", [(4, 2, 16), (1, 1, 0), (2, 2, 8)])
def test_make_layout_matches_jax(size, grid):
    w, h = size
    want = jregions.make_layout(w, h, *grid)
    got = tregions.make_layout(w, h, *grid)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.x_proc, got.y_proc, got.region_count) == (
        want.x_proc, want.y_proc, want.region_count)
    for xs in range(got.grid_w):
        for ys in range(got.grid_h):
            assert got.region_span(xs, ys) == want.region_span(xs, ys)
            assert got.region_index(xs, ys) == want.region_index(xs, ys)


_TABLES = ("NATIVE_TO_BLEND", "NATIVE_TO_RGB", "NATIVE_INTENSITY",
           "ORDERED_TO_NATIVE", "NATIVE_TO_ORDERED")


def _assert_palettes_equal():
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(tpalette, name),
                                      getattr(jpalette, name), err_msg=name)


@pytest.fixture()
def restore_palettes():
    yield
    jpalette.set_palette("c64", _clear_caches=False)
    tpalette.set_palette("c64")


def test_palette_tables_match_jax_by_default():
    _assert_palettes_equal()
    assert sorted(tpalette.PRESETS) == sorted(jpalette.PRESETS)
    for name in tpalette.PRESETS:
        np.testing.assert_array_equal(tpalette.PRESETS[name],
                                      jpalette.PRESETS[name])


@pytest.mark.parametrize("palette", ["zx", "ega", "words", "rgb"])
def test_set_palette_matches_jax(restore_palettes, palette):
    rng = np.random.default_rng(16)
    blend = {
        "zx": "zx", "ega": "ega",
        "words": rng.integers(0, 1 << 24, 16).astype(np.uint32),
        "rgb": rng.integers(0, 256, (16, 3)).astype(np.uint8),
    }[palette]
    jpalette.set_palette(blend, _clear_caches=False)
    tpalette.set_palette(blend)
    _assert_palettes_equal()


def test_port_palette_is_its_own(restore_palettes):
    """Setting the JAX package's palette leaves the port's unchanged."""
    before = tpalette.NATIVE_TO_ORDERED.copy()
    jpalette.set_palette("zx", _clear_caches=False)
    np.testing.assert_array_equal(tpalette.NATIVE_TO_ORDERED, before)
    assert not np.array_equal(jpalette.NATIVE_TO_ORDERED, before)


@pytest.mark.parametrize("palette", ["c64", "zx"])
def test_palette_functions_match_jax(restore_palettes, palette):
    jpalette.set_palette(palette, _clear_caches=False)
    tpalette.set_palette(palette)
    image = np.random.default_rng(4).integers(0, 16, (9, 13), dtype=np.uint8)
    for name in ("native_to_rgb", "native_to_ordered", "ordered_to_native"):
        got = getattr(tpalette, name)(image)
        np.testing.assert_array_equal(got, getattr(jpalette, name)(image),
                                      err_msg=name)
        assert got.dtype == np.uint8


def test_load_palette_file_matches_jax(tmp_path):
    path = tmp_path / "pal.txt"
    words = np.random.default_rng(8).integers(0, 1 << 24, 16)
    path.write_text("; a palette\n" + "".join(
        f"#{w:06X} // colour {i}\n" if i % 2 else f"{w:06x}\n"
        for i, w in enumerate(words)))
    np.testing.assert_array_equal(tpalette.load_palette_file(str(path)),
                                  jpalette.load_palette_file(str(path)))
    path.write_text("ffffff\n")
    with pytest.raises(ValueError, match="16 colors"):
        tpalette.load_palette_file(str(path))


def _arf_case():
    rng = np.random.default_rng(23)
    tile = rng.integers(0, 16, size=(5, 7), dtype=np.uint8)
    image = np.tile(tile, (8, 7))[:37, :45].astype(np.uint8)
    image[15:19, 10:30] = rng.integers(0, 16, (4, 20))
    mask = (rng.random(image.shape) > 0.02).astype(np.uint8)
    dots = rng.integers(0, 4, image.shape + (16,)).astype(np.uint16)
    dots[mask == 0] = 0
    return image * mask, mask, dots


def test_spec_arf_copy_matches_jax():
    from remap_tpu.spec import arf as jspec
    from remap_tpu_torch.spec import arf as tspec

    image, mask, dots = _arf_case()
    for axis in (0, 1):
        np.testing.assert_array_equal(tspec.heat_counts(image, mask, 15, axis),
                                      jspec.heat_counts(image, mask, 15, axis))
    h = jspec.heat_counts(image, mask, 15, 1)
    v = jspec.heat_counts(image, mask, 15, 0)
    np.testing.assert_array_equal(tspec.combine(h, v), jspec.combine(h, v))
    for dev in (1.0, 2.0, 2.5):
        np.testing.assert_array_equal(tspec.gauss_kernel(dev),
                                      jspec.gauss_kernel(dev))
        np.testing.assert_array_equal(tspec.gauss_1d(dev), jspec.gauss_1d(dev))
    ys, xs = np.nonzero(np.ones((37 - 12, 45 - 13), bool))
    ys, xs = ys + 6, xs + 6
    np.testing.assert_array_equal(tspec.rare_picks(dots, ys, xs, 2.0),
                                  jspec.rare_picks(dots, ys, xs, 2.0))
    heat = jspec.combine(h, v)
    np.testing.assert_array_equal(tspec.select(dots, heat, 2.0),
                                  jspec.select(dots, heat, 2.0))
    np.testing.assert_array_equal(
        tspec.filter_fragment(dots, image, mask),
        jspec.filter_fragment(dots, image, mask))


def test_png_writers_match_jax(tmp_path):
    """The port's writer gives the bytes of the JAX package's zlib writer
    (whether or not Pillow is installed), and ``write_map`` writes
    ``native_to_rgb`` of the map (decoded with zlib alone)."""
    import struct
    import zlib

    from remap_tpu.io import png as jpng
    from remap_tpu_torch.io import png as tpng

    image = np.random.default_rng(6).integers(0, 16, (11, 17), np.uint8)
    rgb = tpalette.native_to_rgb(image)
    tpng.write_png(str(tmp_path / "t.png"), rgb)
    jpng._write_png_zlib(str(tmp_path / "j.png"), rgb)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()

    tpng.write_map(str(tmp_path / "m.png"), image)
    data = (tmp_path / "m.png").read_bytes()
    assert data == (tmp_path / "t.png").read_bytes()
    width, height = struct.unpack(">II", data[16:24])
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(height, 1 + 3 * width)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(height, width, 3), rgb)


def test_set_palette_rejects_bad_input():
    with pytest.raises(ValueError, match="preset"):
        tpalette.set_palette("amiga")
    with pytest.raises(ValueError, match="16 blend words"):
        tpalette.set_palette(np.zeros(15, np.uint32))


@pytest.mark.parametrize("width", [1, 7, 9, 12])
def test_nibble_packers_match_jax(width):
    rng = np.random.default_rng(width)
    imgs = rng.integers(0, 16, (3, 5, width), dtype=np.uint8)
    np.testing.assert_array_equal(tstate.pack_nibbles_batch(imgs),
                                  jstate.pack_nibbles_batch(imgs))
    np.testing.assert_array_equal(tstate.pack_nibbles(imgs[0]),
                                  jstate.pack_nibbles(imgs[0]))
    packed = jstate.pack_nibbles(imgs[1])
    np.testing.assert_array_equal(tstate.unpack_nibbles(packed, width),
                                  jstate.unpack_nibbles(packed, width))
    np.testing.assert_array_equal(tstate.unpack_nibbles(packed, width),
                                  imgs[1])


def _store_pair(budget=None):
    return (jstate.FrameStore(10, 12, budget),
            tstate.FrameStore(10, 12, budget, device="cpu"))


def _assert_stores_agree(jax_store, port_store, numbers):
    np.testing.assert_array_equal(port_store.packed_images_batch(numbers),
                                  jax_store.packed_images_batch(numbers))
    np.testing.assert_array_equal(
        to_numpy(port_store.device_packed_batch(numbers)),
        np.asarray(jax_store.device_packed_batch(numbers)))
    assert port_store.mirrored == jax_store._dev_count
    assert port_store.mirror_enabled == (jax_store._dev_parts is not None)
    assert len(port_store) == len(jax_store)
    assert port_store.nbytes == jax_store.nbytes


def test_frame_store_matches_jax_mirror_rules():
    """The cases of tests/test_torch_foreground.py::test_frame_store_mirror
    on both stores: contiguous donations from frame 0 are mirrored,
    replacing a mirrored row drops the mirror, a zero budget never holds
    one."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 16, (6, 10, 12), dtype=np.uint8)
    packed = jstate.pack_nibbles_batch(imgs)
    jax_store, port_store = _store_pair()
    for lo in (0, 3):
        rows = list(range(lo, lo + 3))
        jax_store.put_packed_batch(rows, packed[lo:lo + 3],
                                   device_packed=jnp.asarray(packed[lo:lo + 3]))
        port_store.put_packed_batch(rows, packed[lo:lo + 3],
                                    device_packed=to_torch(packed[lo:lo + 3]))
    _assert_stores_agree(jax_store, port_store, [4, 1, 5])
    assert port_store.mirrored == 6
    for store in (jax_store, port_store):
        store.put(2, imgs[0], imgs[0])
    _assert_stores_agree(jax_store, port_store, [2])
    assert not port_store.mirror_enabled
    np.testing.assert_array_equal(port_store.median(2),
                                  jax_store.median(2))

    jax_zero, port_zero = _store_pair(budget=0)
    jax_zero.put_packed_batch([0], packed[:1],
                              device_packed=jnp.asarray(packed[:1]))
    port_zero.put_packed_batch([0], packed[:1],
                               device_packed=to_torch(packed[:1]))
    _assert_stores_agree(jax_zero, port_zero, [0])
    assert not port_zero.mirror_enabled


def test_frame_store_gap_disables_mirror_as_jax():
    """A donation that does not continue from the mirrored frames drops
    the mirror, in both stores; host rows stay authoritative."""
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 16, (6, 10, 12), dtype=np.uint8)
    packed = jstate.pack_nibbles_batch(imgs)
    jax_store, port_store = _store_pair()
    for rows in ([0, 1], [3, 4]):
        jax_store.put_packed_batch(rows, packed[rows],
                                   device_packed=jnp.asarray(packed[rows]))
        port_store.put_packed_batch(rows, packed[rows],
                                    device_packed=to_torch(packed[rows]))
    _assert_stores_agree(jax_store, port_store, [0, 1, 3, 4])
    assert not port_store.mirror_enabled
    jax_store.put_batch([5], imgs[5:6], imgs[5:6])
    port_store.put_batch([5], imgs[5:6], imgs[5:6])
    assert port_store.has_medians and jax_store.has_medians
    np.testing.assert_array_equal(port_store.medians_batch([5]),
                                  jax_store.medians_batch([5]))
    np.testing.assert_array_equal(port_store.images_batch([0, 5]),
                                  jax_store.images_batch([0, 5]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_growth_matches_jax(seed):
    rng = np.random.default_rng(seed)
    positions = [tuple(int(v) for v in p)
                 for p in rng.integers(-300, 300, (40, 2))]
    assert tstate.simulate_growth(positions, 256, 240) == \
        jstate.simulate_growth(positions, 256, 240)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_clip_matches_bench(seed):
    np.testing.assert_array_equal(clips.make_clip(8, 48, 64, seed=seed),
                                  bench.make_clip(8, 48, 64, seed=seed))


@pytest.mark.parametrize("kwargs", [
    {},
    {"n_sprites": 2, "sprite_size": 5, "hud_rows": 6, "border": 3},
    {"n_sprites": 1, "hud_bottom_rows": 4},
], ids=["plain", "sprites_hud_border", "bottom_hud"])
def test_clips_match_testing(kwargs):
    want = testing.simple_clip(n_frames=6, frame_hw=(40, 56),
                               world_hw=(90, 120), seed=31, **kwargs)
    got = clips.simple_clip(n_frames=6, frame_hw=(40, 56),
                            world_hw=(90, 120), seed=31, **kwargs)
    np.testing.assert_array_equal(np.stack(got.frames), np.stack(want.frames))
    assert got.positions == want.positions
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.world, want.world)

    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    worlds = [m.make_world(50, 70, r) for m, r in zip((clips, testing), rngs)]
    np.testing.assert_array_equal(*worlds)
    paths = [m.make_camera_path(9, (50, 70), (20, 30), r, max_step=2)
             for m, r in zip((clips, testing), rngs)]
    assert paths[0] == paths[1]


def test_rect_and_window_info_match_jax():
    """The port's ``Rect`` and ``WindowInfo`` (with its crop) against the
    JAX package's, field for field, on random rectangles."""
    from remap_tpu.core import geometry as jgeometry
    from remap_tpu.spec import aws as jaws
    from remap_tpu_torch.core import geometry as tgeometry
    from remap_tpu_torch.pipeline import window as twindow

    assert [f.name for f in dataclasses.fields(tgeometry.Rect)] == [
        f.name for f in dataclasses.fields(jgeometry.Rect)]
    assert [f.name for f in dataclasses.fields(twindow.WindowInfo)] == [
        f.name for f in dataclasses.fields(jaws.WindowInfo)]
    rng = np.random.default_rng(12)
    for ltrb in rng.integers(-20, 60, (20, 4)).tolist():
        got, want = tgeometry.Rect(*ltrb), jgeometry.Rect(*ltrb)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (got.width, got.height, got.area) == (want.width, want.height,
                                                     want.area)
        x, y = rng.integers(-20, 60, 2).tolist()
        assert got.contains(x, y) == want.contains(x, y)
        assert dataclasses.astuple(twindow.WindowInfo(got).crop) == \
            dataclasses.astuple(jaws.WindowInfo(want).crop)


def test_overlap_spans_match_jax():
    """``overlap_spans`` (kpm.hpp:302-315's ``get_limits``) against the
    JAX package's on every sign of the shift and extents that do and do
    not overlap."""
    from remap_tpu.core import geometry as jgeometry
    from remap_tpu_torch.core import geometry as tgeometry

    for delta in range(-12, 13):
        for previous, current in ((8, 8), (5, 9), (9, 5), (1, 12)):
            assert tgeometry.overlap_spans(delta, previous, current) == \
                jgeometry.overlap_spans(delta, previous, current)


def _same_session(got, want):
    assert len(got.frames) == len(want.frames)
    np.testing.assert_array_equal(np.stack(got.frames), np.stack(want.frames))
    assert got.camera == want.camera
    np.testing.assert_array_equal(got.world, want.world)


@pytest.mark.parametrize("genre,kwargs", [
    ("play_session", {}),
    ("play_session", {"dialog_every": 20, "dialog_frames": 6,
                      "hud_pos": "top"}),
    ("play_topdown_session", {}),
    ("play_shmup_session", {"hold_every": 20, "hold_frames": 5}),
], ids=["platformer", "platformer_dialog", "topdown", "shmup"])
def test_gameplay_copy_matches_jax(genre, kwargs):
    from remap_tpu.utils import gameplay as jgameplay
    from remap_tpu_torch.utils import gameplay as tgameplay

    args = dict(seed=4, n_frames=40, frame_hw=(120, 160), **kwargs)
    _same_session(getattr(tgameplay, genre)(**args),
                  getattr(jgameplay, genre)(**args))


@pytest.mark.parametrize("kwargs", [
    {}, {"specks": 30, "speck_region": (8, 90, 8, 152), "tear_prob": 0.3,
         "dup_prob": 0.2, "drop_prob": 0.2}], ids=["default", "heavy"])
def test_wear_copy_matches_jax(kwargs):
    from remap_tpu.utils import gameplay as jgameplay
    from remap_tpu.utils import wear as jwear
    from remap_tpu_torch.utils import gameplay as tgameplay
    from remap_tpu_torch.utils import wear as twear

    args = dict(seed=5, n_frames=40, frame_hw=(120, 160))
    got = twear.worn(tgameplay.play_session(**args), 9, **kwargs)
    want = jwear.worn(jgameplay.play_session(**args), 9, **kwargs)
    assert isinstance(got, tgameplay.Session)
    _same_session(got, want)


@pytest.mark.parametrize("module", [
    "core/geometry.py", "spec/arf.py", "spec/aws.py", "spec/cte.py",
    "spec/fde.py", "spec/fdf.py", "spec/fgm.py", "spec/fgs.py",
    "spec/frc.py", "spec/kpe.py", "spec/kpm.py", "spec/nic.py",
    "spec/pipeline.py", "utils/gameplay.py", "utils/wear.py"])
def test_copied_sources_differ_only_in_their_docstrings(module):
    """The port's copies of the JAX-free modules are the originals' code
    line for line: only the module docstring and the port's own import
    paths differ."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def body(package):
        tree = ast.parse((root / package / module).read_text())
        tree.body = tree.body[1:]   # the module docstring
        return ast.dump(tree).replace("remap_tpu_torch.", "remap_tpu.")

    assert body("remap_tpu_torch") == body("remap_tpu")


def test_spec_nic_copy_matches_jax():
    from remap_tpu.spec import nic as jnic
    from remap_tpu_torch.spec import nic as tnic

    rng = np.random.default_rng(13)
    for size in (1, 7, 300, 40000):
        vals = rng.integers(0, 16, size=size, dtype=np.uint8)
        img = np.repeat(vals, rng.integers(1, 9, size=size))[None, :]
        pack = tnic.compress(img)
        assert pack == jnic.compress(img)
        np.testing.assert_array_equal(
            tnic.decompress(pack, img.shape[1], 1),
            jnic.decompress(pack, img.shape[1], 1))
