"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The same numpy inputs go through the JAX package (on the CPU) and through
``remap_tpu_torch``; every quantity compared is an integer, so every
comparison is exact (tolerance 0).  Tests that need a CUDA card take the
``cuda_device`` fixture, which skips without one, and carry the ``cuda``
marker.  This module imports no JAX, so the JAX-free kernel tests
(tests/test_torch_kernels.py) also run where JAX is not installed.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import GridLayout, make_layout

torch.set_num_threads(1)

#: the small streaming setup of tests/test_parallel.py
CFG = PipelineConfig(
    screen_width=96, screen_height=64, region_capacity=512, frame_batch=4
)
LAYOUT = make_layout(96, 64, 4, 2, 16)


#: the repo's native sources, Makefile and the JAX package's libraries
NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
NATIVE_LIBS = ("libremapfeed.so", "libremapcodec.so")


def build_jax_native() -> None:
    """Make sure the JAX package's native libraries exist whole in
    ``native/`` before any test runs.

    The JAX loader (remap_tpu/io/frames.py, io/codec.py) runs ``make -C
    native`` when a library is missing and loads it as soon as the file
    exists, so two test processes that start together can load a library
    the other is still linking.  Here, under an exclusive lock on a file
    in ``native/``, a missing library is built with ``native/Makefile`` in
    a temporary directory and moved into place with ``os.replace``
    (atomic), so the loader finds whole files and never runs ``make``.
    Test modules call this while they are imported: every test process
    imports them before it runs a test.  A failed build raises with
    make's output."""
    with open(NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if all((NATIVE_DIR / name).exists() for name in NATIVE_LIBS):
            return
        with tempfile.TemporaryDirectory(dir=NATIVE_DIR,
                                         prefix=".build-") as tmp:
            for src in [NATIVE_DIR / "Makefile", *NATIVE_DIR.glob("*.cpp")]:
                shutil.copyfile(src, Path(tmp) / src.name)
            proc = subprocess.run(["make", "-C", tmp, *NATIVE_LIBS],
                                  capture_output=True, text=True,
                                  check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building native/ failed (make rc {proc.returncode}):"
                    f"\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            for name in NATIVE_LIBS:
                os.replace(Path(tmp) / name, NATIVE_DIR / name)


def jax_twin(obj):
    """The JAX package's ``PipelineConfig`` or ``GridLayout`` with the
    fields of the port's ``obj``."""
    if isinstance(obj, GridLayout):
        from remap_tpu.core import regions

        return regions.make_layout(obj.width, obj.height, obj.grid_w,
                                   obj.grid_h, obj.overlap, obj.kernel_half)
    if isinstance(obj, PipelineConfig):
        from remap_tpu import config

        fields = dataclasses.asdict(obj)
        fields["match"] = config.MatchConfig(**fields["match"])
        return config.PipelineConfig(**fields)
    raise TypeError(f"no JAX twin for {type(obj).__name__}")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run Pallas kernels in interpret mode (as tests/test_pallas.py)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> torch tensor; uint32 becomes int32 bits."""
    a = np.array(a)   # a writable copy (JAX hands out read-only views)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def to_numpy(t: torch.Tensor, like=None) -> np.ndarray:
    """torch tensor -> numpy; with ``like`` (an array), the same dtype
    (int32 bits back to uint32, the int32 atlas back to uint16)."""
    a = t.detach().cpu().numpy()
    if like is not None:
        dtype = np.asarray(like).dtype
        if dtype == np.uint32:
            a = a.view(np.uint32)
        else:
            a = a.astype(dtype)
    return a


def assert_tables_equal(port, ref, full: bool, msg: str = "") -> None:
    """Port RegionTables vs JAX RegionTables: valid rows, valid, wcounts
    and overflow always; every row when ``full``."""
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(to_numpy(port.valid), valid, err_msg=msg)
    np.testing.assert_array_equal(to_numpy(port.wcounts),
                                  np.asarray(ref.wcounts), err_msg=msg)
    np.testing.assert_array_equal(to_numpy(port.overflow),
                                  np.asarray(ref.overflow), err_msg=msg)
    for name in ("codes", "pos"):
        got = to_numpy(getattr(port, name), getattr(ref, name))
        want = np.asarray(getattr(ref, name))
        if full:
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {name}")
        else:
            np.testing.assert_array_equal(got[valid], want[valid],
                                          err_msg=f"{msg} {name}")
