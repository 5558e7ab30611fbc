"""Port streaming step (remap_tpu_torch.parallel.sharded) vs the JAX
package's ``make_streaming_step(use_pallas=False)``, exact, batch by batch:
outputs, flags and the carried state."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.parallel import sharded as jsharded
from remap_tpu.utils import testing
from remap_tpu_torch import convert
from remap_tpu_torch.parallel import sharded as tsharded

from torch_parity import (  # noqa: F401 (fixtures)
    CFG, LAYOUT, assert_tables_equal, to_numpy, to_torch,
)

#: the bench's matcher knobs (multiplicity 1, vote radius 16) on the
#: small streaming setup of tests/test_parallel.py
STREAM_CFG = dataclasses.replace(CFG, join_multiplicity=1, vote_radius=16)
PAD = 16
BATCH = 4


@functools.cache
def _jax_step():
    """One jitted JAX step for the whole file (compiles once)."""
    init, step = jsharded.make_streaming_step(LAYOUT, STREAM_CFG,
                                              atlas_pad=PAD, use_pallas=False)
    return init, jax.jit(step)


def _port_step(device="cpu"):
    return tsharded.make_streaming_step(LAYOUT, STREAM_CFG, atlas_pad=PAD,
                                        device=device)


def _assert_state_equal(port_state, jax_state):
    got = convert.stream_state_to_numpy(port_state)
    want = jax.tree.map(np.asarray, jax_state)
    for name in ("dots", "position", "started", "anchor"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    # JAX's CPU tables are topk tables: compare their valid rows
    assert_tables_equal(port_state.carry, want.carry, full=False,
                        msg="carry")


def _assert_step_equal(port_out, jax_out):
    offs, matched, flags, strayed, state = port_out
    j_offs, j_matched, j_flags, j_strayed, j_state = jax_out
    np.testing.assert_array_equal(to_numpy(offs), np.asarray(j_offs))
    np.testing.assert_array_equal(to_numpy(matched), np.asarray(j_matched))
    for name in ("table", "join", "range"):
        np.testing.assert_array_equal(to_numpy(getattr(flags, name)),
                                      np.asarray(getattr(j_flags, name)),
                                      err_msg=name)
    assert bool(strayed) == bool(np.asarray(j_strayed))
    _assert_state_equal(state, j_state)


def _run_both(frames, port_state=None, jax_state=None):
    """Step both implementations over ``frames`` in batches of 4;
    returns the per-step JAX outputs and the two final states."""
    j_init, j_step = _jax_step()
    t_init, t_step = _port_step()
    port_state = t_init() if port_state is None else port_state
    jax_state = j_init() if jax_state is None else jax_state
    outs = []
    for i in range(0, len(frames), BATCH):
        batch = np.ascontiguousarray(frames[i:i + BATCH])
        j_out = j_step(jnp.asarray(batch), jax_state)
        t_out = t_step(to_torch(batch), port_state)
        _assert_step_equal(t_out, j_out)
        jax_state, port_state = j_out[-1], t_out[-1]
        outs.append(j_out)
    return outs, port_state, jax_state


def _drift_frames():
    """The re-anchor pattern of tests/test_parallel.py: a 69-px rightward
    drift, far past the 16-px pad."""
    rng = np.random.default_rng(7)
    world = testing.make_world(160, 224, rng)
    path = [(8 + 3 * i, 40) for i in range(24)]
    return np.stack(testing.render_clip(world, path, (64, 96)).frames)


def _break_frames():
    """A scrolling clip with a noise frame in the middle of batch 2."""
    clip = testing.simple_clip(n_frames=12, frame_hw=(64, 96),
                               world_hw=(160, 224), seed=31)
    frames = np.stack(clip.frames)
    rng = np.random.default_rng(32)
    frames[6] = rng.integers(0, 16, (64, 96), dtype=np.uint8)
    return frames


def _strayed_frames():
    """The window-overflow pattern of tests/test_parallel.py: long drift
    plus a mid-batch break resetting to (0, 0)."""
    rng = np.random.default_rng(8)
    world = testing.make_world(160, 224, rng)
    path = [(8 + 3 * i, 40) for i in range(21)]
    frames = list(testing.render_clip(world, path, (64, 96)).frames)
    frames.append(rng.integers(0, 16, (64, 96), dtype=np.uint8))
    frames.append(frames[-1].copy())
    frames.append(frames[-1].copy())
    return np.stack(frames)


def test_segmented_positions():
    offs = torch.tensor([[[0, 0], [1, 2], [3, -1], [0, 0], [2, 2]]],
                        dtype=torch.int32)
    matched = torch.tensor([[False, True, True, False, True]])
    pos = tsharded.segmented_positions(offs, matched)[0]
    assert pos.tolist() == [[0, 0], [1, 2], [4, 1], [0, 0], [2, 2]]
    # no break: the running sum from the batch start
    pos = tsharded.segmented_positions(offs, torch.ones_like(matched))[0]
    assert pos.tolist() == [[0, 0], [1, 2], [4, 1], [4, 1], [6, 3]]


def test_stream_matches_jax_reanchor():
    outs, port_state, _ = _run_both(_drift_frames())
    # the window moved under the camera
    assert int(port_state.anchor[0]) > -PAD
    assert not any(bool(np.asarray(o[3])) for o in outs)


def test_stream_matches_jax_break():
    outs, _, _ = _run_both(_break_frames())
    matched = np.concatenate([np.asarray(o[1]) for o in outs])
    assert not matched[6] and matched[1:6].all()


def test_stream_matches_jax_strayed():
    outs, _, _ = _run_both(_strayed_frames())
    strayed = [bool(np.asarray(o[3])) for o in outs]
    assert not any(strayed[:-1]) and strayed[-1]


def test_stream_handover_from_jax():
    """Two batches in JAX, the state carried into the port, two more
    batches in both: equal outputs and state."""
    frames = _drift_frames()[:16]
    j_init, j_step = _jax_step()
    jax_state = j_init()
    for i in range(0, 8, BATCH):
        jax_state = j_step(jnp.asarray(frames[i:i + BATCH]), jax_state)[-1]
    handed = jax.tree.map(np.asarray, jax_state)
    port_state = convert.stream_state_from_numpy(handed, "cpu")
    _assert_state_equal(port_state, jax_state)
    _run_both(frames[8:], port_state=port_state, jax_state=jax_state)


@pytest.mark.parametrize("mode", ["auto", "topk", "pallas", "sort",
                                  "sort2", "bogus"])
def test_stream_table_modes(mode):
    """auto, topk, pallas and sort select the topk tables the port
    builds; sort2 (its own chunk-quota overflow flag) and unknown modes
    raise instead of running as topk."""
    cfg = dataclasses.replace(STREAM_CFG, table_mode=mode)
    build = functools.partial(tsharded.make_streaming_step, LAYOUT, cfg,
                              atlas_pad=PAD, device="cpu")
    if mode in tsharded.TOPK_TABLE_MODES:
        init, step = build()
        offsets = step(to_torch(_break_frames()[:BATCH]), init())[0]
        assert offsets.shape == (BATCH, 2)
    else:
        err = NotImplementedError if mode == "sort2" else ValueError
        with pytest.raises(err, match=mode):
            build()


def test_port_imports_no_jax():
    """The port's package, its streaming step and its foreground stage
    never import JAX."""
    code = (
        "import sys, remap_tpu_torch, remap_tpu_torch.parallel.sharded, "
        "remap_tpu_torch.pipeline.foreground, remap_tpu_torch.convert; "
        "assert 'jax' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith('jax'))"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
