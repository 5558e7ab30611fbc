"""The CLI path on the card (``cuda`` marker; each test skips without a
CUDA device): the native feed's packed batches unpacked on the card, and
the CLI on a small clip directory on CUDA against ``--cpu``.  This file
imports no JAX, so it runs on the card's host:

    python -m pytest --noconftest -m cuda tests/test_torch_card_io.py
"""

import numpy as np
import pytest
import torch

from remap_tpu_torch import cli
from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.io import frames, png
from remap_tpu_torch.pipeline.state import unpack_nibbles_device
from remap_tpu_torch.utils import clips

from torch_parity import cuda_device  # noqa: F401 (fixture)

#: tests/test_cli.py's flags for its clip
FLAGS = ["--width", "96", "--height", "72", "--frame-batch", "8",
         "--region-capacity", "2048"]


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    clip = clips.simple_clip(n_frames=24, frame_hw=(72, 96),
                             world_hw=(200, 260), seed=7, hud_rows=8,
                             border=4, max_step=4)
    for i, f in enumerate(clip.frames):
        f.tofile(d / str(i))
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("crop", [None, Rect(left=3, top=2, right=88,
                                             bottom=61)])
def test_feed_batches_unpack_on_the_card(clip_dir, crop, cuda_device):
    feed = frames.RawDirectoryFeed(str(clip_dir), 96, 72, crop)
    packed = torch.as_tensor(feed.read_packed_batch(0, len(feed)),
                             device=cuda_device)
    got = unpack_nibbles_device(packed, feed.out_dims[1]).cpu().numpy()
    np.testing.assert_array_equal(got, np.stack(list(feed)))


@pytest.mark.cuda
def test_cli_on_the_card_equals_cpu(clip_dir, tmp_path, capsys,
                                    cuda_device):
    maps = {}
    for where in ("cuda", "cpu"):
        prefix = str(tmp_path / where)
        rc = cli.main([str(clip_dir), *FLAGS, "--out-prefix", prefix]
                      + (["--cpu"] if where == "cpu" else []))
        out = capsys.readouterr().out
        assert rc == 0
        maps[where] = [png.decode_png(ln.split()[1])
                       for ln in out.splitlines() if ln.startswith("wrote ")]
    assert len(maps["cuda"]) == len(maps["cpu"]) >= 1
    for a, b in zip(maps["cuda"], maps["cpu"]):
        np.testing.assert_array_equal(a, b)
