"""The artifact clean of one fragment canvas, restated in plain NumPy and
PyTorch (arf.hpp:143-328 of the reference, as the port's spec states it
in ``spec/arf.py``), fast enough to run over a whole session's canvas.

The heat counts every complete ``size``-pixel window of the blended image
in each direction by its exact pixel sequence (15 colours of 4 bits make
one 60-bit key); a pixel is rare when ``1 / sqrt((h + v) / 2)`` in
float32 is above the threshold.  Rare interior pixels take the argmax of
a float32 Gaussian vote blur over the ``size-1 x size`` truncated window
(the kernel's bottom row unused), summed product by product in the
reference's order (kernel row-major), over the colours present at the
centre; the others take the plain argmax; the first of equal maxima
wins.  The result is cropped by the canvas's empty margins.  Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gauss_kernel(dev: float) -> np.ndarray:
    """size = ceil(6*dev)|1; ``a * powf(e_f32, -(dy*dy + dx*dx) / d)`` in
    float32 (arf.hpp:231-253)."""
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


def heat_counts(image: np.ndarray, mask: np.ndarray, size: int,
                axis: int) -> np.ndarray:
    """[H, W] uint32: each complete window's centre gets the number of
    windows in that direction with its pixel sequence; 0 elsewhere.  A
    window is complete when all its pixels are non-empty."""
    if axis == 0:
        return heat_counts(image.T, mask.T, size, 1).T
    h, w = image.shape
    out = np.zeros((h, w), np.uint32)
    if w < size:
        return out
    n = w - size + 1
    key = np.zeros((h, n), np.int64)
    empty = np.zeros((h, n), np.int32)
    gap = (mask == 0).astype(np.int32)
    for k in range(size):
        key = (key << 4) | image[:, k:k + n].astype(np.int64)
        empty += gap[:, k:k + n]
    full = empty == 0
    if not full.any():
        return out
    _, inverse, counts = np.unique(key[full], return_inverse=True,
                                   return_counts=True)
    ys, xs = np.nonzero(full)
    out[ys, xs + size // 2] = counts[inverse.ravel()].astype(np.uint32)
    return out


def rare_mask(image: np.ndarray, mask: np.ndarray, size: int,
              threshold: float) -> np.ndarray:
    hm = heat_counts(image, mask, size, 1)
    vm = heat_counts(image, mask, size, 0)
    s = (hm.astype(np.float32) + vm.astype(np.float32)) / np.float32(2.0)
    with np.errstate(divide="ignore"):
        heat = (np.float32(1.0) / np.sqrt(s)).astype(np.float32)
    return heat > threshold


def clean_canvas(dots: torch.Tensor, size: int = 15, dev: float = 2.0,
                 threshold: float = 0.25,
                 dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The map of one ``[16, H, W]`` vote canvas (integer tensor, on any
    device): blend, heat, select, margin crop.  ``dtype`` is the blur's
    arithmetic (float32 as the reference states it)."""
    dots = dots.to(torch.int64)
    _, h, w = dots.shape
    image_t = torch.argmax(dots, dim=0)
    mask_t = dots.amax(dim=0) > 0
    image = (image_t * mask_t).to(torch.uint8).cpu().numpy()
    mask = mask_t.to(torch.uint8).cpu().numpy()
    rare = rare_mask(image, mask, size, threshold)

    kernel = gauss_kernel(dev)
    m = kernel.shape[0] // 2
    out = np.zeros((h, w), np.uint8)
    ph, pw = h - 2 * m, w - 2 * m - 1    # the last column is skipped
    if ph > 0 and pw > 0:
        inner = dots[:, m:m + ph, m:m + pw]
        plain = torch.argmax(inner, dim=0)
        f = dots.to(dtype)
        temp = torch.zeros((16, ph, pw), dtype=dtype, device=dots.device)
        for r in range(kernel.shape[0] - 1):
            for c in range(kernel.shape[1]):
                temp = temp + f[:, r:r + ph, c:c + pw] * float(kernel[r, c])
        temp = torch.where(inner > 0, temp, torch.zeros((), dtype=dtype,
                                                        device=dots.device))
        picked = torch.argmax(temp, dim=0)
        rare_t = torch.as_tensor(rare[m:m + ph, m:m + pw],
                                 device=dots.device)
        out[m:m + ph, m:m + pw] = torch.where(
            rare_t, picked, plain).to(torch.uint8).cpu().numpy()

    cols = np.nonzero(mask.any(axis=0))[0]
    rows = np.nonzero(mask.any(axis=1))[0]
    if len(cols) == 0:
        return out[h:, w:]
    return out[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
