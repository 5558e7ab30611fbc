"""Spec: artifact filtering (arf.hpp) -- the port's copy of
remap_tpu/spec/arf.py; tests/test_torch_core.py holds the two equal.

Rare (non-repeating) pixel patterns are detected by a pattern-frequency
heatmap and replaced by Gaussian-weighted histogram voting:

1. Per direction (rows / columns): slide a ``size``-pixel window along each
   line; runs restart after any empty (mask==0) pixel (arf.hpp:160-183).
   Every complete window increments a global per-direction counter for its
   exact pixel sequence, and the window's *center* pixel is tagged with that
   pattern; the heat value is the pattern's final total count
   (arf.hpp:143-186: positions store a pointer into the counter map,
   dereferenced after counting).  Untagged pixels have count 0.
2. Combine: ``1 / sqrt((h + v) / 2)`` in float32 (arf.hpp:188-212; count 0
   gives +inf).  Values **> 0.25** mark rare patterns (count sum < 32).
3. Select: for interior pixels (``margin = gauss_size // 2`` …
   ``arf.hpp:274-303``; the **last processed column of each row is skipped**
   — the row loop runs ``width - size`` pixels, a reference quirk): rare
   pixels take the argmax over a Gaussian blur of the dot histograms
   restricted to colors present at the center; others take the plain
   argmax.  Unprocessed pixels output color 0.
4. The result is cropped by the fragment's empty margins (arf.hpp:320-327).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def heat_counts(
    image: np.ndarray, mask: np.ndarray, size: int, axis: int
) -> np.ndarray:
    """Per-direction pattern-frequency map (arf.hpp:143-186).

    axis=1: windows slide along rows; axis=0: along columns.
    """
    if axis == 0:
        return heat_counts(image.T, mask.T, size, axis=1).T

    h, w = image.shape
    counts: Dict[Tuple[int, ...], int] = {}
    centers = np.full((h, w), -1, dtype=np.int64)  # pattern id per center
    patterns: Dict[Tuple[int, ...], int] = {}
    pat_list = []

    half = size // 2
    for y in range(h):
        run = 0
        for x in range(w):
            if mask[y, x] == 0:
                run = 0
                continue
            run += 1
            if run >= size:
                pat = tuple(int(v) for v in image[y, x - size + 1 : x + 1])
                counts[pat] = counts.get(pat, 0) + 1
                pid = patterns.setdefault(pat, len(patterns))
                if pid == len(pat_list):
                    pat_list.append(pat)
                centers[y, x - half] = pid

    out = np.zeros((h, w), dtype=np.uint32)
    if pat_list:
        totals = np.array([counts[p] for p in pat_list], dtype=np.uint32)
        tagged = centers >= 0
        out[tagged] = totals[centers[tagged]]
    return out


def combine(h: np.ndarray, v: np.ndarray) -> np.ndarray:
    """1/sqrt((h+v)/2) in float32 (arf.hpp:188-212, exact-sqrt path)."""
    s = (h.astype(np.float32) + v.astype(np.float32)) / np.float32(2.0)
    with np.errstate(divide="ignore"):
        return (np.float32(1.0) / np.sqrt(s)).astype(np.float32)


def gauss_kernel(dev: float) -> np.ndarray:
    """size = ceil(6*dev)|1; unnormalised Gaussian (arf.hpp:231-253).

    The reference computes each weight as ``a * powf(e_f32, -(dy*dy +
    dx*dx) / d)`` in float32, where ``e_f32`` is the float32 rounding of
    e (std::numbers::e_v<float>) — NOT ``expf``.  Emulated bit-exactly
    by a correctly-rounded float64 pow of the same f32 operands, rounded
    to f32, then the f32 multiply by ``a`` (verified weight-for-weight
    against the compiled reference binary's kernel, round 3)."""
    size = int(math.ceil(6.0 * dev)) | 1
    half = size // 2
    d = np.float32(2.0 * dev * dev)
    a = np.float32(1.0) / (np.float32(math.pi) * d)
    e32 = np.float32(math.e)
    ys = (np.arange(size, dtype=np.float32) - np.float32(half))[:, None]
    xs = (np.arange(size, dtype=np.float32) - np.float32(half))[None, :]
    expo = (-(ys * ys + xs * xs) / d).astype(np.float32)
    p = np.power(np.float64(e32), expo.astype(np.float64)).astype(np.float32)
    return (a * p).astype(np.float32)


def gauss_1d(dev: float) -> np.ndarray:
    """Separable 1-D factor g with g[dy]*g[dx] == gauss_kernel(dev)[dy,dx]
    in real arithmetic (float32 weights; the f32 kernel entries differ
    from the outer product by a few ulp — the device's stability bound
    covers that gap, see ops.arf)."""
    kernel = gauss_kernel(dev)
    margin = kernel.shape[0] // 2
    return (kernel[margin, :] / np.sqrt(kernel[margin, margin])).astype(
        np.float32
    )


def rare_picks(
    dots: np.ndarray, ys: np.ndarray, xs: np.ndarray, dev: float
) -> np.ndarray:
    """THE canonical rare-path selection for interior pixels (ys, xs) —
    the reference binary's blur, replicated bit-exactly.

    **Truncated-window quirk** (found by the round-3 fuzz e2e
    differential): the reference's blur row loop runs ``inner`` from
    ``outer - vstride - margin`` while ``inner < outer + vstride -
    margin`` stepping a row each time (arf.hpp:282-287) — that bound
    admits only ``2*margin`` rows, so the window is size x (size-1):
    the BOTTOM kernel row (dy = +margin) is never accumulated, and the
    kernel's last row of weights goes unused.

    Arithmetic: float32 products/accumulations in the reference's exact
    order (kernel row-major, colors innermost => per-color sequential
    sum over window positions), restricted to colors present at the
    center; first-max argmax (std::max_element).  Vectorized over the
    pixel axis only, which preserves each pixel's summation order.
    This exact routine is what the device's stability bound certifies
    against and what the host re-selection runs
    (ops.arf.canonical_rare_picks delegates here)."""
    kernel = gauss_kernel(dev)
    size = kernel.shape[0]
    margin = size // 2
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    if len(ys) == 0:
        return np.empty(0, np.uint8)
    dy = np.arange(-margin, margin)          # size-1 rows: bottom dropped
    dx = np.arange(-margin, margin + 1)
    wy = (ys[:, None] + dy)[:, :, None]
    wx = (xs[:, None] + dx)[:, None, :]
    win = dots[wy, wx]                       # [K, S-1, S, 16]
    return rare_picks_from_windows(win, dev)


def rare_picks_from_windows(win: np.ndarray, dev: float) -> np.ndarray:
    """:func:`rare_picks` on pre-gathered [K, S-1, S, 16] dot windows
    (rows dy in [-margin, margin), cols dx in [-margin, margin]) — the
    window slicing is the only part that needs the full canvas, so the
    device path gathers windows at the flagged pixels instead of
    downloading the whole dot atlas (ops.arf.filter_fragment_finalize).
    Arithmetic identical to :func:`rare_picks` (the reference binary's
    f32 order)."""
    kernel = gauss_kernel(dev)
    size = kernel.shape[0]
    margin = size // 2
    assert win.shape[1:3] == (size - 1, size), win.shape
    center = win[:, margin, margin, :]       # dy=0, dx=0
    present = center > 0                     # [K, 16]
    winf = win.astype(np.float32)
    temp = np.zeros((win.shape[0], 16), np.float32)
    for r in range(size - 1):
        for c in range(size):
            temp += winf[:, r, c, :] * kernel[r, c]
    temp = np.where(present, temp, np.float32(0.0))
    return temp.argmax(axis=1).astype(np.uint8)


def select(
    dots: np.ndarray,
    heat: np.ndarray,
    dev: float,
    threshold: float = 0.25,
) -> np.ndarray:
    """Conditional Gaussian-vote color selection (arf.hpp:255-307).

    CANONICAL rare-path arithmetic: :func:`rare_picks` — the reference
    binary's f32 truncated-window blur replicated bit-exactly (kernel
    bits, summation order, size x (size-1) window; see its docstring) —
    the single definition every backend reproduces (the device computes
    a separable f32 variant and defers provably-undecidable knife-edge
    pixels to this routine, ops.arf.canonical_rare_picks).  The heat
    gate stays on the exact-sqrt path: the reference's own heat mixes
    rsqrt-approx SIMD lanes with exact-sqrt scalar tails
    (arf.hpp:203-209), but both sides of that inconsistency make the
    identical >0.25 decisions for every integer count sum (the gate is
    h+v < 32; measured rsqrt(16) = 0.24994 < 0.25 on this hardware), so
    exact sqrt is decision-equivalent, not a divergence."""
    size = gauss_1d(dev).shape[0]
    margin = size // 2

    h, w = dots.shape[:2]
    out = np.zeros((h, w), dtype=np.uint8)
    yi, xi = np.indices((h, w))
    processed = (
        (yi >= margin) & (yi < h - margin)
        & (xi >= margin) & (xi < w - margin - 1)  # last column skipped
    )
    rare = processed & (heat > threshold)
    out[processed] = dots.argmax(axis=2)[processed].astype(np.uint8)
    ys, xs = np.nonzero(rare)
    out[ys, xs] = rare_picks(dots, ys, xs, dev)
    return out


def filter_fragment(
    dots: np.ndarray,
    blend_image: np.ndarray,
    blend_mask: np.ndarray,
    size: int = 15,
    dev: float = 2.0,
) -> np.ndarray:
    """arf::filter minus the final margin crop (arf.hpp:314-328)."""
    hmap = heat_counts(blend_image, blend_mask, size, axis=1)
    vmap = heat_counts(blend_image, blend_mask, size, axis=0)
    heat = combine(hmap, vmap)
    return select(dots, heat, dev)
