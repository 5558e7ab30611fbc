"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled, at first use, into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds rather than the minutes ``torch.utils.cpp_extension`` needs).
One ``nvcc`` per source runs at the same time, then one links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <objs>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libremap_kernels-<hash>.so <objs>/*.o

(``<objs>`` is a scratch directory under ``build/``, removed after.)

(``-Xptxas -v``: each kernel's registers, shared memory and spills, kept
in the ``.log`` beside the library.)

The library lands in the package's ``build/`` directory (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
kernel is never served from a stale build.  Each C entry point takes
device pointers, sizes and the stream, launches without synchronising,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64

#: argtypes of each C entry point (pointers and the stream as c_void_p,
#: so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # images, B, H, W, nat_to_ord, ord_to_nat, x_lo, x_hi, y_lo, y_hi,
    # median, weight, codes, stream
    "remap_extract": [_P, _I, _I, _I, _U64, _U64, _I, _I, _I, _I,
                      _P, _P, _P, _P],
    # images, B, H, W, nat_to_ord, ord_to_nat, x_lo, x_hi, y_lo, y_hi,
    # median, stream
    "remap_extract_medians": [_P, _I, _I, _I, _U64, _U64, _I, _I, _I, _I,
                              _P, _P],
    # spans (host int32[R*4]), R -> C, the tiles of the largest region
    "remap_tables_tiles": [_P, _I],
    # weight, codes, B, H, W, spans (host int32[R*4]), R, K, counts
    # (scratch int32[B*R*C*4]), out_codes, out_pos, out_valid,
    # out_wcounts, out_overflow, stream
    "remap_tables": [_P, _P, _I, _I, _I, _P, _I, _I, _P,
                     _P, _P, _P, _P, _P, _P],
    # frames, vote (null for none), polarity, pos, F, H, W, dots (in
    # place), AH, AW, x_lo, y_lo, x_hi, y_hi, clip_lo, clip_hi,
    # clip_every, clip_step, stream
    "remap_blit": [_P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _P],
    # images, B, H, W, labels, slots (null for labels alone), stream
    "remap_cc_labels": [_P, _I, _I, _I, _P, _P, _P],
    # labels, changed, B, H, W, slots, stats, stream
    "remap_cc_stats": [_P, _P, _I, _I, _I, _P, _P, _P],
    # prev, curr, base, B, H, W, radius, counts, stream
    "remap_fine_counts": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"libremap_kernels-{_digest()}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at the same time; their output, or raise with it
    if one failed.  No process outlives the call."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log = "".join(logs)
    failed = [f"{' '.join(c)} ({p.returncode})"
              for c, p in zip(cmds, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
    return log


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless an up-to-date build exists.

    Returns (library path, seconds spent compiling, nvcc's output)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return out, 0.0, log
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.objs"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    objs = [obj_dir / f"{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources(), objs)])
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *(str(o) for o in objs)]])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, out)   # atomic: a concurrent build never sees a torn file
    return out, seconds, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.remap_error_string.argtypes = [ctypes.c_int]
    lib.remap_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().remap_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
