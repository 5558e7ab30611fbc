"""PNG output of palette-mapped maps and PNG input of frames (the port's
copy of remap_tpu/io/png.py, pngu.hpp's role, plus a reader).

The reference writes RGB8 PNGs via libpng (pngu.hpp:18-105, write-only).
Here: one self-contained zlib encoder (RGB8, no interlace, filter 0), the
JAX package's fallback writer byte for byte.  The port takes it on every
host, so a map's file does not depend on whether an imaging package is
installed.

The reader (:func:`read_png`, :func:`decode_png`) uses zlib alone, as the
card's host has no imaging package: non-interlaced images of colour type
0 (grey) and 2 (RGB) at 8 bits, 3 (palette, with ``PLTE``) at 1, 2, 4 or
8 bits, and 4 (grey + alpha) and 6 (RGBA) at 8 bits, with every scanline
filter.  Anything else (16-bit samples, grey below 8 bits, Adam7
interlace) raises ``ValueError`` naming what it does not read.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from remap_tpu_torch.core import palette

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: samples a pixel per colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_map(path: str, image: np.ndarray) -> None:
    """Palette-map a native-code image and write it (main.cpp:255-259)."""
    write_png(path, palette.native_to_rgb(image))


def _unfilter_serial(kind: int, line: bytes, up: np.ndarray,
                     bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) filters, which need each byte's
    reconstructed left neighbour: a byte-serial loop over Python ints."""
    out = bytearray(len(line))
    prev = up.tobytes()
    for x in range(len(line)):
        a = out[x - bpp] if x >= bpp else 0
        b = prev[x]
        if kind == 3:
            p = (a + b) >> 1
        else:
            c = prev[x - bpp] if x >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (line[x] + p) & 255
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each scanline's filter: ``raw`` [h, 1 + stride] (filter byte,
    then the line) -> [h, stride] uint8.  None and Up run whole rows; Sub
    is a cumulative sum mod 256 over each of the ``bpp`` byte lanes."""
    out = np.zeros((h, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:
            pad = -stride % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            row = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:
            row = line + up
        elif kind in (3, 4):
            row = _unfilter_serial(kind, line.tobytes(), up, bpp)
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter {kind}")
        out[y] = row
        up = out[y]
    return out


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[h, stride] bytes of ``depth``-bit samples (1, 2 or 4), high bits
    first -> [h, width] uint8."""
    if depth == 8:
        return rows
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :width]


def read_png(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A PNG's samples and palette: ``([H, W] indices, [n, 3] uint8)``
    for a palette image (colour type 3), else ``([H, W, C] uint8,
    None)`` with C = 1 (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA).
    Raises ``ValueError`` for forms it does not read and for damaged
    files (bad signature, chunk CRC, missing IHDR, PLTE or IDAT)."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    i, idat, header, plte = 8, [], None, None
    while i + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        crc = data[i + 8 + n:i + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: chunk {tag!r} is damaged")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        i += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not a PNG colour "
                         "type")
    if interlace != 0:
        raise ValueError(f"{path}: interlace method {interlace} (Adam7) is "
                         "not read")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: bit depth {depth} at colour type {ctype} "
                         "is not read (8 bits, or 1/2/4-bit palettes)")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + stride):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, not "
                         f"{h * (1 + stride)}")
    rows = _unfilter(raw.reshape(h, 1 + stride), h, stride,
                     max(1, channels * depth // 8))
    if ctype == 3:
        return _unpack_bits(rows, depth, w), plte
    return rows.reshape(h, w, channels), None


def decode_png(path: str) -> np.ndarray:
    """A PNG as ``[H, W, 3]`` uint8 RGB: grey replicated, alpha dropped,
    palette indices looked up (an index past the palette reads black)."""
    pixels, pal = read_png(path)
    if pal is not None:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(pal)] = pal[:256]
        return lut[pixels]
    if pixels.shape[2] in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])
