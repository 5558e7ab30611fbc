"""Build and load the repo's native host libraries (``native/``).

``native/feed.cpp`` (the threaded packed frame reader) and
``native/codec.cpp`` (the reference-format RLE codec) are built at first
use by ``native/Makefile``: its sources are copied into the port's
``build/native/`` directory (listed in ``.gitignore``) and ``make`` runs
there, under a file lock, so processes that start together build once
and never load a half-written library.  A failed build or load raises
with ``make``'s output: the port never takes the NumPy path in its
place.  The NumPy versions (``spec.nic``, the feed's packer) are reached
only by asking for them (``native=False``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
#: the repo's native sources and Makefile
SOURCE_DIR = PACKAGE_DIR.parent / "native"
BUILD_DIR = PACKAGE_DIR / "build" / "native"


def _stage_sources(src: Path, dst: Path) -> None:
    """Copy the Makefile and C++ sources into ``dst`` where they differ
    (a copy is newer than the library built from the old one, so make
    rebuilds it)."""
    names = ["Makefile"] + sorted(p.name for p in src.glob("*.cpp"))
    for name in names:
        have = dst / name
        want = (src / name).read_bytes()
        if not have.exists() or have.read_bytes() != want:
            shutil.copyfile(src / name, have)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The native library ``name`` (``libremapfeed.so`` or
    ``libremapcodec.so``), built by ``make`` from ``SOURCE_DIR`` into
    ``BUILD_DIR`` if it is missing or older than its source.  Raises
    ``RuntimeError`` when the sources are missing or the build or load
    fails."""
    src = Path(SOURCE_DIR)
    if not (src / "Makefile").exists():
        raise RuntimeError(f"native sources not found: no {src}/Makefile")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _stage_sources(src, BUILD_DIR)
        proc = subprocess.run(["make", "-C", str(BUILD_DIR), name],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building native/{name} failed (make rc {proc.returncode})"
                f":\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        try:
            return ctypes.CDLL(str(BUILD_DIR / name))
        except OSError as e:
            raise RuntimeError(f"loading {BUILD_DIR / name} failed: {e}") \
                from e
