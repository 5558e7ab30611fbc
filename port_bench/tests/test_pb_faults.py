"""The timed path broken underneath a run: ``correct`` must come out
false.  One test a fault the cell can have (a single card has no
exchange between chips to leave out)."""

import numpy as np
import pytest

from port_bench.tests import small


def altered_offsets(monkeypatch):
    """An answer altered where it is produced: collect's offset of one
    frame."""
    from remap_tpu_torch.pipeline import collect

    real = collect.collect

    def collect_(*args, **kwargs):
        res = real(*args, **kwargs)
        res.offsets = np.array(res.offsets)
        res.offsets[5] += 1
        return res

    monkeypatch.setattr(collect, "collect", collect_)


def altered_map(monkeypatch):
    """An answer altered where it is produced: one pixel of a map."""
    from remap_tpu_torch.pipeline import builder

    real = builder.clean_stage.clean

    def clean(*args, **kwargs):
        maps = [m.copy() for m in real(*args, **kwargs)]
        maps[0][maps[0].shape[0] // 2, maps[0].shape[1] // 2] ^= 1
        return maps

    monkeypatch.setattr(builder.clean_stage, "clean", clean)


def half_the_frames(monkeypatch):
    """Half of the frames left out of collect."""
    from remap_tpu_torch.pipeline import collect

    real = collect.collect

    def collect_(frames, *args, **kwargs):
        frames = list(frames)
        return real(frames[:len(frames) // 2], *args, **kwargs)

    monkeypatch.setattr(collect, "collect", collect_)


def unfiltered(monkeypatch):
    """A stage that returns its state unchanged: the foreground gives
    back the spliced fragments as they came."""
    from remap_tpu_torch.pipeline import builder

    monkeypatch.setattr(builder.fg_stage, "filter_fragments",
                        lambda fragments, *a, **k: fragments)


def foreground_blit(kind):
    """The foreground's masks right, its masked blit wrong: the vote's
    polarity flipped, or each frame voting through its neighbour's
    mask."""
    def patch(monkeypatch):
        from remap_tpu_torch.ops.kernels import blit

        real = blit.blit_frames_

        def blit_frames_(frames, positions, dots, *, vote=None,
                         vote_polarity="nonzero", **kwargs):
            if vote is not None and vote_polarity == "zero":
                if kind == "polarity":
                    vote_polarity = "nonzero"
                else:
                    vote = vote.roll(1, 0)
            return real(frames, positions, dots, vote=vote,
                        vote_polarity=vote_polarity, **kwargs)

        monkeypatch.setattr(blit, "blit_frames_", blit_frames_)
    patch.__name__ = f"foreground_blit_{kind}"
    return patch


@pytest.mark.parametrize("fault", [
    altered_offsets, altered_map, half_the_frames, unfiltered,
    foreground_blit("polarity"), foreground_blit("shifted_masks")],
    ids=lambda f: f.__name__)
def test_map_build_fault_is_caught(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    result = small.run("c64_map_break", tmp_path)
    assert not result["correct"], result["checks"]
    if fault.__name__.startswith(("foreground", "unfiltered")):
        # the spliced canvases are right; the filtered ones are not
        checks = result["checks"]
        assert checks["splice_bins_wrong"]["value"] == 0, checks
        assert checks["foreground_bins_wrong"]["value"] > 0, checks


def stream_fault(kind):
    def patch(monkeypatch):
        from remap_tpu_torch.parallel import sharded

        real = sharded.make_streaming_step

        def make(*args, **kwargs):
            init, step = real(*args, **kwargs)

            def broken(images, state):
                if kind == "half":
                    return step(images[:len(images) // 2], state)
                offs, matched, flags, strayed, new = step(images, state)
                if kind == "unchanged":
                    return offs, matched, flags, strayed, state
                offs = offs.clone()
                offs[-1, 0] += 1
                return offs, matched, flags, strayed, new

            return init, broken

        monkeypatch.setattr(sharded, "make_streaming_step", make)
    return patch


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_stream_fault_is_caught(kind, monkeypatch, tmp_path):
    stream_fault(kind)(monkeypatch)
    result = small.run("nes_stream_ingest", tmp_path)
    assert not result["correct"], result["checks"]
