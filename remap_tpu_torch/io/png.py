"""PNG output of palette-mapped maps (the port's copy of
remap_tpu/io/png.py, pngu.hpp's role).

The reference writes RGB8 PNGs via libpng (pngu.hpp:18-105, write-only).
Here: one self-contained zlib encoder (RGB8, no interlace, filter 0), the
JAX package's fallback writer byte for byte.  The port takes it on every
host, so a map's file does not depend on whether an imaging package is
installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from remap_tpu_torch.core import palette


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> PNG file."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h)
    )  # filter 0 per scanline
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_map(path: str, image: np.ndarray) -> None:
    """Palette-map a native-code image and write it (main.cpp:255-259)."""
    write_png(path, palette.native_to_rgb(image))
