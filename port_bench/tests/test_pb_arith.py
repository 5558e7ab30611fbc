"""The yardstick's arithmetic against hand counts, and the reference's
restatements against the port's own specification (a witness here; the
reference itself imports nothing of the port)."""

import numpy as np
import pytest
import torch

from port_bench import readers, roofline, stats, trace, traffic
from port_bench.reference import clean as ref_clean
from port_bench.reference import foreground as ref_fg
from port_bench.reference import frozen
from port_bench.reference import keypoints as ref_kp
from port_bench.reference import maps as ref_maps


def test_extract_bytes_are_19_a_pixel():
    assert roofline.extract_bytes((256, 240, 256)) == 256 * 240 * 256 * 19


def test_tables_bytes_hand_count():
    # 100 weight bytes; 3 regions holding 2, 9 and 4 keypoints at K = 4:
    # 2 + 4 + 4 kept codes and 3 region-first codes of 16 bytes in; 3
    # regions of 4 entries of 25 bytes and 13 bytes of counts out
    counts = torch.tensor([[2, 9, 4]])
    assert roofline.tables_bytes(100, counts, 4) == (
        100 + (10 + 3) * 16 + 3 * (4 * 25 + 13))


@pytest.mark.parametrize("capacity", [16, 640])
def test_tables_bytes_equal_the_ports_tables(capacity):
    """The count from shapes and the reference's keypoints equals the
    bytes of the port's own weights and tables (a witness)."""
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import kpe as kpe_ops
    from remap_tpu_torch.ops import tables as table_ops

    s = traffic.cyclic(8, 64, 96, 4, path_seed=0, margin=60, max_step=3)
    frames = torch.as_tensor(s.frames)
    layout = make_layout(96, 64, 4, 2, 16)
    dense = kpe_ops.extract_dense(frames, layout)
    tabs = table_ops.build_tables(dense.weight, dense.codes, layout,
                                  capacity)
    want = roofline.CODE_BYTES * (int(tabs.valid.sum())
                                  + tabs.overflow.numel()) + (
        dense.weight.numel()
        + sum(t.numel() * t.element_size() for t in tabs))
    spans = ref_kp.region_spans(96, 64, 4, 2, 16)
    counts = ref_kp.region_counts(ref_kp.keypoints(frames), spans)
    assert roofline.tables_bytes(frames.numel(), counts, capacity) == want


@pytest.mark.parametrize("size", [(64, 96, 4, 2, 16), (72, 100, 3, 3, 8)])
def test_keypoints_and_regions_equal_the_spec(size):
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.ops import tables as table_ops
    from remap_tpu_torch.spec import kpe

    h, w, gw, gh, ov = size
    layout = make_layout(w, h, gw, gh, ov)
    spans = ref_kp.region_spans(w, h, gw, gh, ov)
    assert spans == table_ops.region_spans(layout)
    s = traffic.render(3, h, w, 8, path_seed=8, margin=40, max_step=2,
                       sprites=1, sprite_size=5, hud_rows=4, border=2,
                       noise_at=None)
    points = ref_kp.keypoints(torch.as_tensor(s.frames))
    counts = ref_kp.region_counts(points, spans)
    for i, frame in enumerate(s.frames):
        res = kpe.extract(frame, layout)
        assert np.array_equal(points[i].numpy(), res.weight > 0)
        assert counts[i].tolist() == [r.total for r in res.regions]


def test_blit_bytes_hand_count():
    # two 1x2 frames, the second one pixel right: colours [1, 2] at x 0-1
    # and [2, 3] at x 1-2 -> bins (1,0,0), (2,0,1) twice, (3,0,2)
    frames = torch.tensor([[[1, 2]], [[2, 3]]], dtype=torch.uint8)
    pos = np.array([[10, 5], [11, 5]])
    assert roofline.voted_bins(frames, pos) == 3
    assert roofline.blit_bytes(frames, pos) == 4 + 2 * 4 * 3


def test_share_is_percent_of_bandwidth():
    assert roofline.share(roofline.HBM_BYTES_PER_S, 1.0) == pytest.approx(
        100.0)
    assert roofline.share(roofline.HBM_BYTES_PER_S / 4, 0.5) == \
        pytest.approx(50.0)


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.nearest_rank(values, 95) == 95
    assert stats.nearest_rank([3.0], 95) == 3.0
    assert stats.nearest_rank(values[::-1], 50) == 50


def test_union_counts_overlaps_once():
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert trace.union_seconds([]) == 0.0
    assert trace.gaps([(0, 1), (0.5, 2), (3, 4)], 0, 5) == [(2, 3), (4, 5)]


def test_idle_share_reader():
    assert readers.idle_share(
        {"profile": {"busy_s": 0.25, "window_s": 1.0}}) == 75.0
    # nothing ran on a device: no share, never 0
    assert readers.idle_share(
        {"profile": {"busy_s": 0.0, "window_s": 1.0}}) is None


def test_roofline_reader_absent_kernel_reads_nothing():
    obs = {"profile": {"steps": 4, "kernels": {}, "bytes_per_step": {
        "extract": 1.0}}}
    assert readers.roofline_share(obs, "extract", "extract_kernel") is None


def small_canvas(seed, frames=30, h=24, w=32):
    """Votes of a small render session at its true positions."""
    s = traffic.render(frames, h, w, seed, path_seed=seed, margin=20, max_step=2,
                       sprites=1, sprite_size=4, hud_rows=0, border=0,
                       noise_at=None)
    p = np.asarray(s.path)
    pos = p - p.min(axis=0)
    shape = (int(pos[:, 1].max()) + h, int(pos[:, 0].max()) + w)
    return s, pos, ref_maps.vote_canvas(torch.as_tensor(s.frames), pos,
                                        shape)


@pytest.mark.parametrize("seed", [1, 2])
def test_clean_equals_the_spec(seed):
    from remap_tpu_torch.spec import arf
    from remap_tpu_torch.spec.fgm import Fragment

    _, _, canvas = small_canvas(seed)
    dots = canvas.permute(1, 2, 0).numpy().astype(np.uint16)
    frag = Fragment(dots=dots, zero=(0, 0), step=(1, 1), frames=[])
    image, mask = frag.blend()
    want = frag.crop_margins(arf.filter_fragment(dots, image, mask))
    got = ref_clean.clean_canvas(canvas)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_foreground_mask_equals_the_spec(seed):
    from remap_tpu_torch.core.regions import make_layout
    from remap_tpu_torch.spec import fde, kpe

    s, pos, canvas = small_canvas(seed)
    background = ref_maps.blend(canvas)
    frames = torch.as_tensor(s.frames)
    medians = ref_fg.median3(frames)
    got = ref_fg.foreground_masks(torch.as_tensor(background), frames,
                                  torch.as_tensor(pos))
    assert got.any() and not got.all()
    for i, frame in enumerate(s.frames):
        median = kpe.extract(frame, make_layout(32, 24, 1, 1, 0)).median
        assert np.array_equal(medians[i].numpy(), median)
        res, kept = fde.extract(background, frame, median, tuple(pos[i]))
        want = fde.foreground_mask(res, kept, frame.shape)
        assert np.array_equal(got[i].numpy().astype(np.uint8), want)


def test_filtered_canvas_equals_the_spec():
    """The votes of the frames' background pixels equal the spec's
    foreground filter of the fragment."""
    from remap_tpu_torch.spec import fdf
    from remap_tpu_torch.spec.fgm import Fragment, FrameRecord

    s, pos, canvas = small_canvas(5)
    dots = canvas.permute(1, 2, 0).numpy().astype(np.uint16)
    frames = torch.as_tensor(s.frames)
    medians = ref_fg.median3(frames).numpy()
    frag = Fragment(dots=dots, zero=(0, 0), step=(1, 1), frames=[
        FrameRecord(i, tuple(int(v) for v in p), s.frames[i], medians[i])
        for i, p in enumerate(pos)])
    [want] = fdf.filter_fragments([frag], s.frames.shape[1:])
    got = ref_fg.filtered_canvas(frames, pos, canvas.shape[1:],
                                 torch.as_tensor(ref_maps.blend(canvas)))
    assert got.sum() < canvas.sum()
    assert np.array_equal(got.permute(1, 2, 0).numpy(), want.dots)


def test_expected_crop_is_the_spec_window():
    from remap_tpu_torch.spec import aws

    s = traffic.render(24, 72, 96, 5, path_seed=5, margin=200, max_step=3, sprites=2,
                       sprite_size=5, hud_rows=8, border=4, noise_at=None)
    c = aws.scan(iter(s.frames)).crop
    assert (c.left, c.top, c.right, c.bottom) == ref_maps.expected_crop(
        72, 96, 8, 4)


def test_palette_ranks_equal_the_ports():
    from remap_tpu_torch.core import palette

    assert np.array_equal(frozen.ORDERED_TO_NATIVE,
                          palette.ORDERED_TO_NATIVE)
    assert np.array_equal(frozen.NATIVE_TO_ORDERED,
                          palette.NATIVE_TO_ORDERED)
