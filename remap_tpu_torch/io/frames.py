"""Frame feeds: raw captures and PNG directories (port of
remap_tpu/io/frames.py).

The reference reads a directory of raw frame dumps, one byte per pixel of
4-bit palette indices, numerically named files sorted by ``stoi``,
optionally cropped to the action window (nil.hpp:13-32, main.cpp:16-52,
204-213).  :class:`RawDirectoryFeed` keeps that contract;
:class:`PngDirectoryFeed` also takes palette, grey and RGB(A) PNG frames,
mapped to the nearest palette colour, through the port's own zlib reader
(``io.png``).

A feed is a plain iterator of ``[H, W]`` uint8 frames.  A raw feed also
crops natively (``with_crop``) and serves packed batches
(``read_packed_batch``: the repo's threaded reader ``native/feed.cpp``,
which reads, crops, masks and packs two pixels a byte off the GIL); the
window scan and the collect pass take that branch, so frames reach the
device packed without any NumPy packing on the main thread.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from remap_tpu_torch.core import palette
from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.io import native as _native
from remap_tpu_torch.io import png as _png
from remap_tpu_torch.pipeline.state import pack_nibbles_batch
from remap_tpu_torch.utils import profiling

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _feed_lib() -> ctypes.CDLL:
    lib = _native.library("libremapfeed.so")
    lib.feed_read_packed_batch.restype = ctypes.c_int
    lib.feed_read_packed_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t] + [ctypes.c_int] * 7 + [_U8P]
    return lib


def _numeric_sort(names: Sequence[str]) -> List[str]:
    """Sort by the leading integer in the file name (main.cpp:210-212)."""

    def key(name: str) -> int:
        m = re.search(r"\d+", os.path.basename(name))
        if m is None:
            raise ValueError(f"frame file has no numeric name: {name}")
        return int(m.group())

    return sorted(names, key=key)


def _cropped(img: np.ndarray, crop: Optional[Rect]) -> np.ndarray:
    if crop is None:
        return img
    return img[crop.top:crop.bottom, crop.left:crop.right]


class RawDirectoryFeed:
    """Raw one-byte-per-pixel frames of fixed screen dimensions."""

    def __init__(self, directory: str, width: int, height: int,
                 crop: Optional[Rect] = None):
        self.directory = directory
        self.width = width
        self.height = height
        self.crop = crop
        self.files = _numeric_sort(
            os.path.join(directory, f) for f in os.listdir(directory))

    def __len__(self) -> int:
        return len(self.files)

    def read(self, index: int) -> np.ndarray:
        data = np.fromfile(self.files[index], dtype=np.uint8)
        if data.size < self.width * self.height:
            # unreadable or short files give a blank frame (nil.hpp:20-22)
            img = np.zeros((self.height, self.width), np.uint8)
        else:
            # mask to the 4-bit contract: an out-of-range byte of a damaged
            # dump would otherwise corrupt its neighbour through the nibble
            # packing (nic.hpp:8-105 packs unmasked); the identity on every
            # in-contract input
            img = data[:self.width * self.height].reshape(
                self.height, self.width) & 0x0F
        return _cropped(img, self.crop)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self.files)):
            yield self.read(i)

    def with_crop(self, crop: Rect) -> "RawDirectoryFeed":
        feed = RawDirectoryFeed.__new__(RawDirectoryFeed)
        feed.directory = self.directory
        feed.width = self.width
        feed.height = self.height
        feed.crop = crop
        feed.files = self.files
        return feed

    @property
    def out_dims(self) -> Tuple[int, int]:
        """(height, width) of the frames it gives (after the crop)."""
        if self.crop is not None:
            return self.crop.height, self.crop.width
        return self.height, self.width

    def read_packed_batch(self, start: int, count: int,
                          native: bool = True) -> np.ndarray:
        """Frames ``[start, start + count)`` cropped and packed two pixels
        a byte: ``[n, ch, ceil(cw / 2)]`` uint8 (n = the frames that exist),
        equal to ``pack_nibbles_batch`` of the ``read()`` images.  Read by
        the native threaded reader (``native/feed.cpp``), or, with
        ``native=False``, by ``read()`` and the NumPy packer.  Each read is
        a span, ``feed.read``, on the thread that reads, and counts its
        frames (``feed.frames``)."""
        with profiling.span("feed.read"):
            out = self._read_packed_batch(start, count, native)
            profiling.count("feed.frames", len(out))
        return out

    def _read_packed_batch(self, start: int, count: int,
                           native: bool) -> np.ndarray:
        ch, cw = self.out_dims
        paths = self.files[start:start + count]
        if not paths:
            return np.zeros((0, ch, (cw + 1) // 2), np.uint8)
        if not native:
            return pack_nibbles_batch(
                np.stack([self.read(start + i) for i in range(len(paths))]))
        left, top = ((self.crop.left, self.crop.top) if self.crop is not None
                     else (0, 0))
        encoded = [p.encode() for p in paths]
        stride = max(len(e) for e in encoded) + 1
        names = np.zeros((len(paths), stride), np.uint8)
        for i, e in enumerate(encoded):
            names[i, :len(e)] = np.frombuffer(e, np.uint8)
        out = np.empty((len(paths), ch, (cw + 1) // 2), np.uint8)
        rc = _feed_lib().feed_read_packed_batch(
            names.ctypes.data_as(ctypes.c_char_p), stride, len(paths),
            self.width, self.height, left, top, cw, ch,
            out.ctypes.data_as(_U8P))
        if rc != 0:
            raise ValueError(f"native feed refused crop {self.crop} of "
                             f"{self.width}x{self.height} frames (rc {rc})")
        return out


class PngDirectoryFeed:
    """PNG frames mapped to the 16-colour palette (nearest RGB)."""

    def __init__(self, directory: str, crop: Optional[Rect] = None):
        self.directory = directory
        self.crop = crop
        self.files = _numeric_sort(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith(".png"))

    def __len__(self) -> int:
        return len(self.files)

    def read(self, index: int) -> np.ndarray:
        pixels, pal, depth = _png.read_png(self.files[index])
        if pal is not None:
            # palette fast path: each palette entry mapped to its nearest
            # native colour once (exact when the palette is the native one,
            # in any order), then indexed
            out = _palette_lut(pal)[pixels]
        else:
            # every other form as the JAX feed's img.convert("RGB")
            out = rgb_to_native(_png.to_rgb(pixels, None, depth))
        return _cropped(out, self.crop)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self.files)):
            yield self.read(i)

    def with_crop(self, crop: Rect) -> "PngDirectoryFeed":
        feed = PngDirectoryFeed.__new__(PngDirectoryFeed)
        feed.directory = self.directory
        feed.crop = crop
        feed.files = self.files
        return feed


def _palette_lut(pal: np.ndarray) -> np.ndarray:
    """[256] uint8 LUT: PNG palette code -> nearest native colour (codes
    past the palette read black, as the JAX package's LUT does)."""
    arr = np.zeros((256, 3), np.uint8)
    arr[:min(len(pal), 256)] = pal[:256]
    return rgb_to_native(arr[None, :, :])[0]


def rgb_to_native(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> nearest palette index (squared distance, the
    first of equal distances winning).  Each distinct colour is mapped
    once: a frame holds few of them."""
    pal = palette.NATIVE_TO_RGB.astype(np.int32)  # [16, 3]
    px = rgb.reshape(-1, 3).astype(np.int32)
    keys, inverse = np.unique((px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2],
                              return_inverse=True)
    colours = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], axis=-1)
    d = ((colours[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    return d.argmin(-1).astype(np.uint8)[inverse].reshape(rgb.shape[:2])


def batches(feed, batch: int) -> Iterator[Tuple[List[int], np.ndarray]]:
    """(frame numbers, [B, H, W]) chunks from any frame iterator."""
    nums: List[int] = []
    imgs: List[np.ndarray] = []
    for i, img in enumerate(feed):
        nums.append(i)
        imgs.append(img)
        if len(imgs) == batch:
            yield nums, np.stack(imgs)
            nums, imgs = [], []
    if imgs:
        yield nums, np.stack(imgs)
