"""Port streaming step (remap_tpu_torch.parallel.sharded) vs the JAX
package's ``make_streaming_step(use_pallas=False)``, exact, batch by batch:
outputs, flags and the carried state."""

import ast
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
    CFG, LAYOUT, assert_tables_equal, jax_twin, to_numpy, to_torch,
)

#: the bench's matcher knobs (multiplicity 1, vote radius 16) on the
#: small streaming setup of tests/test_parallel.py
STREAM_CFG = dataclasses.replace(CFG, join_multiplicity=1, vote_radius=16)
PAD = 16
BATCH = 4


@functools.cache
def _jax_step():
    """One jitted JAX step for the whole file (compiles once)."""
    init, step = jsharded.make_streaming_step(
        jax_twin(LAYOUT), jax_twin(STREAM_CFG), atlas_pad=PAD,
        use_pallas=False)
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
    """auto, topk, pallas and sort select the topk tables; sort2 builds
    its own, whose chunk-quota flag fires on the noise frame (region 6 of
    frame 6): every output and the carried tables equal JAX's sort2 step
    batch by batch.  An unknown mode raises instead of running as
    topk."""
    cfg = dataclasses.replace(STREAM_CFG, table_mode=mode)
    build = functools.partial(tsharded.make_streaming_step, LAYOUT, cfg,
                              atlas_pad=PAD, device="cpu")
    if mode == "bogus":
        with pytest.raises(ValueError, match=mode):
            build()
        return
    init, step = build()
    frames = _break_frames()[:8]
    state = init()
    if mode != "sort2":
        offsets = step(to_torch(frames[:BATCH]), state)[0]
        assert offsets.shape == (BATCH, 2)
        return
    j_init, j_step = jsharded.make_streaming_step(
        jax_twin(LAYOUT), jax_twin(cfg), atlas_pad=PAD, use_pallas=False)
    j_step, j_state = jax.jit(j_step), j_init()
    for i in range(0, len(frames), BATCH):
        batch = frames[i:i + BATCH]
        j_out = j_step(jnp.asarray(batch), j_state)
        t_out = step(to_torch(batch), state)
        _assert_step_equal(t_out, j_out)
        assert_tables_equal(t_out[-1].carry, j_out[-1].carry, full=True,
                            msg="sort2 carry")
        j_state, state = j_out[-1], t_out[-1]
        if i:
            assert bool(t_out[2].table[6 - i])


def _port_modules() -> list:
    """Every module of the port's package, as an import name."""
    root = Path(__file__).resolve().parent.parent
    names = []
    for path in sorted((root / "remap_tpu_torch").rglob("*.py")):
        parts = list(path.relative_to(root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_port_modules_include_the_map_build():
    """The guards below cover the back half of the map build too."""
    names = set(_port_modules())
    assert {"remap_tpu_torch.ops.splice", "remap_tpu_torch.ops.arf",
            "remap_tpu_torch.spec.arf", "remap_tpu_torch.pipeline.splice",
            "remap_tpu_torch.pipeline.clean",
            "remap_tpu_torch.pipeline.builder",
            "remap_tpu_torch.io.png"} <= names


def test_port_modules_include_the_cli_slice():
    """The guards below cover the CLI, the feeds, the codec, the
    checkpoints and the session simulators too."""
    names = set(_port_modules())
    assert {"remap_tpu_torch.cli", "remap_tpu_torch.io.frames",
            "remap_tpu_torch.io.codec", "remap_tpu_torch.io.checkpoint",
            "remap_tpu_torch.io.native", "remap_tpu_torch.spec.nic",
            "remap_tpu_torch.utils.gameplay",
            "remap_tpu_torch.utils.wear"} <= names


def test_port_modules_include_the_matcher_slice():
    """The guards below cover the correlation matchers and their
    families too."""
    names = set(_port_modules())
    assert {"remap_tpu_torch.ops.correlate", "remap_tpu_torch.models",
            "remap_tpu_torch.models.xcorr",
            "remap_tpu_torch.models.pyramid",
            "remap_tpu_torch.models.grid_vote"} <= names


def _family_choices(tree: ast.AST) -> list:
    """Line numbers of every comparison of a ``.matcher`` attribute with a
    family name (or a tuple of them)."""
    from remap_tpu_torch.models import FAMILIES

    def names(node):
        if isinstance(node, ast.Constant):
            return {node.value}
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return set().union(*map(names, node.elts))
        return set()

    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + node.comparators
            if (any(isinstance(n, ast.Attribute) and n.attr == "matcher"
                    for n in sides)
                    and any(names(n) & set(FAMILIES) for n in sides)):
                lines.append(node.lineno)
    return lines


def test_matcher_families_live_in_models():
    """Only ``models/`` chooses between the matcher families: no other
    module of the port (the CLI's choices and the config's docs aside;
    ``spec/`` is the JAX package's copied spec) compares ``.matcher`` with
    a family name, and no module of ``pipeline/`` imports the multi-device
    layer's ``parallel.sharded``."""
    pkg = Path(__file__).resolve().parent.parent / "remap_tpu_torch"
    assert _family_choices(ast.parse('if cfg.matcher != "grid_vote": pass'))
    assert _family_choices(ast.parse('x = c.matcher in ("xcorr", "pyramid")'))
    found = {}
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg).as_posix()
        if rel.startswith(("models/", "spec/")) or rel in ("cli.py",
                                                           "config.py"):
            continue
        lines = _family_choices(ast.parse(path.read_text()))
        if lines:
            found[rel] = lines
    assert not found, found
    sharded = "remap_tpu_torch.parallel.sharded"
    for path in sorted((pkg / "pipeline").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                full = [f"{node.module}.{a.name}" for a in node.names]
                full.append(node.module or "")
            elif isinstance(node, ast.Import):
                full = [a.name for a in node.names]
            else:
                continue
            assert not any(n.startswith(sharded) for n in full), (
                path.name, node.lineno)


def test_port_modules_include_the_multi_device_slice():
    """The guards below cover the mesh, the sharded step's process layer,
    the fragment round robins and the profiling helpers too."""
    names = set(_port_modules())
    assert {"remap_tpu_torch.parallel.mesh",
            "remap_tpu_torch.parallel.distributed",
            "remap_tpu_torch.parallel.fragments",
            "remap_tpu_torch.parallel.sharded",
            "remap_tpu_torch.utils.profiling"} <= names


def test_port_modules_include_the_spec_and_motion():
    """The guards below cover the NumPy spec's copies and the motion
    detector too."""
    names = set(_port_modules())
    assert {f"remap_tpu_torch.spec.{m}" for m in (
        "aws", "cte", "fde", "fdf", "fgm", "fgs", "frc", "kpe", "kpm",
        "pipeline")} | {"remap_tpu_torch.ops.motion"} <= names


def test_port_imports_no_jax():
    """Importing every module of the port brings in neither JAX, nor any
    module of the JAX package (``remap_tpu`` and its submodules), nor
    Pillow (the card's host has none)."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'remap_tpu' or "
        "m.startswith('remap_tpu.') or m == 'PIL' or "
        "m.startswith('PIL.'))\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def _imported_roots(path: Path) -> set:
    """Top-level names of every import in a Python file (module-level or
    inside functions), by its syntax tree."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module)
    return roots


def _port_sources() -> list:
    root = Path(__file__).resolve().parent.parent
    return sorted((root / "remap_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_port_sources_import_nothing_of_jax(path):
    """No file of the port, nor chip_smoke.py, imports ``jax``, the JAX
    package (``remap_tpu``, not ``remap_tpu_torch``), ``bench`` or
    Pillow."""
    bad = sorted(
        name for name in _imported_roots(path)
        if name.split(".")[0] in ("jax", "remap_tpu", "bench", "PIL"))
    assert not bad, bad


def test_get_device_without_cuda_raises():
    """With no device named, the port takes CUDA, and raises where there
    is none instead of running on the CPU."""
    from remap_tpu_torch.device import get_device

    if torch.cuda.is_available():
        assert get_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def _entry_point(name):
    from remap_tpu_torch.pipeline import state

    if name == "make_streaming_step":
        return lambda: tsharded.make_streaming_step(LAYOUT, STREAM_CFG)
    if name == "make_pipeline_step":
        return lambda: tsharded.make_pipeline_step(LAYOUT, STREAM_CFG)
    if name == "FrameStore":
        return lambda: state.FrameStore(8, 8)
    if name == "Fragment.device_dots":
        frag = state.Fragment(dots=np.zeros((4, 5, 16), np.uint16))
        return frag.device_dots
    if name in ("splice", "clean"):
        from remap_tpu_torch.pipeline import clean, splice

        frag = state.Fragment(dots=np.zeros((40, 50, 16), np.uint16))
        fn = splice.splice if name == "splice" else clean.clean
        extra = ((50, 40),) if name == "splice" else ()
        return lambda: fn([frag], STREAM_CFG, *extra)
    if name == "build_from_frames":
        from remap_tpu_torch.pipeline import builder

        return lambda: builder.build_from_frames(
            [np.zeros((40, 50), np.uint8)] * 3, STREAM_CFG)
    if name == "make_mesh":
        from remap_tpu_torch.parallel import mesh

        return lambda: mesh.make_mesh(space=1)
    if name == "distributed.initialize":
        from remap_tpu_torch.parallel import distributed

        return lambda: distributed.initialize("127.0.0.1:1", 1, 0)
    if name == "fragment_devices":
        from remap_tpu_torch.parallel import fragments

        return lambda: fragments.fragment_devices(2)
    if name == "stream_state_from_numpy":
        init, _ = tsharded.make_streaming_step(LAYOUT, STREAM_CFG,
                                               atlas_pad=PAD, device="cpu")
        handed = convert.stream_state_to_numpy(init())
        return lambda: convert.stream_state_from_numpy(handed)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["make_streaming_step", "make_pipeline_step",
                                  "FrameStore",
                                  "Fragment.device_dots",
                                  "stream_state_from_numpy", "splice",
                                  "clean", "build_from_frames",
                                  "make_mesh", "distributed.initialize",
                                  "fragment_devices"])
def test_entry_points_need_cuda_unless_asked_for_cpu(name):
    """The port's entry points run on the card unless the caller names the
    CPU: without CUDA and with no device given, each raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_point(name)()


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
