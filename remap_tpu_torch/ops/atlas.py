"""Fragment canvases of 16-bin colour votes (port of remap_tpu/ops/atlas.py).

On the device a canvas is K3's channels-major padded layout: ``[16, AH',
AW']`` int32 holding uint16 values, the logical canvas at ``[:, :h, :w]``
(``kernels.blit.padded_dims``).  The JAX layout ``[h, w, 16]`` uint16
exists only at the host boundary (:func:`to_host`, :func:`from_host`).
Vote counts wrap at 2**16 as the reference's ``++uint16`` does
(fgm.hpp:12-15).
"""

from __future__ import annotations

import numpy as np
import torch

from remap_tpu_torch.ops.kernels import blit as kblit

DEPTH = kblit.DEPTH


def empty_canvas(h: int, w: int, device) -> torch.Tensor:
    """A zero canvas for a logical ``h x w`` fragment."""
    return torch.zeros((DEPTH,) + kblit.padded_dims(h, w), dtype=torch.int32,
                       device=device)


def from_host(dots: np.ndarray, device) -> torch.Tensor:
    """``[h, w, 16]`` uint16 numpy canvas -> the padded device canvas."""
    h, w, depth = dots.shape
    if depth != DEPTH or dots.dtype != np.uint16:
        raise TypeError(f"expected a [h, w, {DEPTH}] uint16 canvas, got "
                        f"{dots.shape} {dots.dtype}")
    out = empty_canvas(h, w, device)
    out[:, :h, :w] = torch.as_tensor(
        np.ascontiguousarray(dots.transpose(2, 0, 1)).astype(np.int32),
        device=device)
    return out


def to_host(dots: torch.Tensor, h: int, w: int) -> np.ndarray:
    """Padded device canvas -> the logical canvas in the JAX layout,
    ``[h, w, 16]`` uint16 numpy (collect.py ``_crop_transpose_jit``)."""
    return dots[:, :h, :w].permute(1, 2, 0).cpu().numpy().astype(np.uint16)


def blend(dots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[16, H, W]`` votes -> (image, mask) ``[H, W]`` uint8: the colour
    with the most votes, the first of equal maxima winning as
    ``std::max_element`` does (fgm.hpp:115-135) — ``torch.argmax``
    returns the first maximal index — and mask = any votes."""
    image = torch.argmax(dots, dim=0).to(torch.uint8)
    mask = (dots.amax(dim=0) > 0).to(torch.uint8)
    return image * mask, mask


def add_fragment(dots: torch.Tensor, other: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Histogram-add the ``[16, h, w]`` canvas ``other`` into ``dots`` at
    ``pos`` (x, y) (fgm.hpp:99-113), wrapping at 2**16.  The start is
    clamped so the block fits, as ``lax.dynamic_slice`` clamps it; ``pos``
    may stay on the device."""
    _, hh, ww = dots.shape
    _, h, w = other.shape
    dev = dots.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int64)
    y0 = pos[1].clamp(0, hh - h)
    x0 = pos[0].clamp(0, ww - w)
    ys = (y0 + torch.arange(h, device=dev))[:, None]
    xs = (x0 + torch.arange(w, device=dev))[None, :]
    out = dots.clone()
    out[:, ys, xs] = (dots[:, ys, xs] + other) & 0xFFFF
    return out


def margins(dots: torch.Tensor) -> torch.Tensor:
    """[left, top, right, bottom] counts of empty columns and rows around
    the ``[16, H, W]`` canvas's votes (fgm.hpp:145-153); an empty canvas
    gives ``[W, H, W, H]`` as the reference does.  Pass the logical canvas
    (``dots[:, :h, :w]``): the padding is empty."""
    _, h, w = dots.shape
    nonempty = dots.amax(dim=0) > 0
    cols = nonempty.any(dim=0)
    rows = nonempty.any(dim=1)
    first_col = torch.argmax(cols.to(torch.uint8))
    last_col = w - 1 - torch.argmax(cols.flip(0).to(torch.uint8))
    first_row = torch.argmax(rows.to(torch.uint8))
    last_row = h - 1 - torch.argmax(rows.flip(0).to(torch.uint8))
    res = torch.stack([first_col, first_row, w - 1 - last_col,
                       h - 1 - last_row]).to(torch.int32)
    empty = torch.tensor([w, h, w, h], dtype=torch.int32, device=dots.device)
    return torch.where(cols.any(), res, empty)
