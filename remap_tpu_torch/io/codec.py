"""Frame codec: the reference-format 4-bit RLE (port of
remap_tpu/io/codec.py, nic.hpp:8-166).

The reference keeps every frame in RAM as custom 4-bit RLE; the port's
store packs two pixels per byte (``pipeline.state``), and this codec
serves byte-compatible interchange.  ``compress``/``decompress`` run the
repo's C++ codec (``native/codec.cpp``, built at first use by
``io.native``); ``native=False`` runs the NumPy spec (``spec.nic``), its
plain version.  A failed build raises instead of falling back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from remap_tpu_torch.io import native as _native
from remap_tpu_torch.spec import nic as _spec_nic

_U8P = ctypes.POINTER(ctypes.c_uint8)

#: the native decoder's malformed-stream sentinel (SIZE_MAX)
_BAD = ctypes.c_size_t(-1).value


def _lib() -> ctypes.CDLL:
    lib = _native.library("libremapcodec.so")
    lib.rle_compress.restype = ctypes.c_size_t
    lib.rle_compress.argtypes = [_U8P, ctypes.c_size_t, _U8P]
    lib.rle_decompress.restype = ctypes.c_size_t
    lib.rle_decompress.argtypes = [_U8P, ctypes.c_size_t, _U8P,
                                   ctypes.c_size_t]
    return lib


def compress(image: np.ndarray, native: bool = True) -> bytes:
    """4-bit RLE, byte-exact with the reference format (nic.hpp:8-105)."""
    if not native:
        return _spec_nic.compress(image)
    flat = np.ascontiguousarray(image, dtype=np.uint8).reshape(-1)
    # worst case: every other pixel distinct -> < n bytes + opcodes
    out = np.empty(flat.size + flat.size // 32 + 16, np.uint8)
    n = _lib().rle_compress(flat.ctypes.data_as(_U8P), flat.size,
                            out.ctypes.data_as(_U8P))
    return out[:n].tobytes()


def decompress(pack: bytes, width: int, height: int,
               native: bool = True) -> np.ndarray:
    """Strict full-frame decode: raises ValueError on truncated or corrupt
    packs instead of inheriting the reference decoder's out-of-bounds
    reads and writes (nic.hpp:107-166 trusts the stream)."""
    if not native:
        return _spec_nic.decompress(pack, width, height)
    src = np.frombuffer(pack, np.uint8)
    out = np.zeros(width * height, np.uint8)
    n = _lib().rle_decompress(src.ctypes.data_as(_U8P), src.size,
                              out.ctypes.data_as(_U8P), out.size)
    if n != out.size:
        got = 0 if n == _BAD else n
        raise ValueError(f"corrupt or truncated RLE pack: decoded {got} of "
                         f"{out.size} pixels")
    return out.reshape(height, width)
