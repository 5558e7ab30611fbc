"""The pyramid matcher's rule on frame pairs, restated from its
description (coarse-to-fine correlation of 4-bit palette frames) in
plain PyTorch.  Imports nothing of the program.

For a pair (prev, curr) of ``[H, W]`` frames and a shift d = (dx, dy),
the agreement count is

    S[d] = #{x : x and x + d inside the frame, curr(x) == prev(x + d)},

an integer.  A level picks, over the shifts of ``[-R, R]^2``, the first
maximum of S in row-major order (dy, then dx), and accepts it where it
covers ``MIN_COVER`` of the frame and beats the best count outside its
``EXCLUDE`` neighbourhood by ``MIN_RATIO``; both thresholds are float32
(``MIN_COVER * H * W`` worked out in double and rounded to float32,
the runner-up's count times float32 ``MIN_RATIO`` in float32).

1. Coarse: both frames decimated by keeping every ``FACTOR``-th row and
   column (palette codes cannot be averaged), picked over
   ``[-COARSE_RADIUS, COARSE_RADIUS]^2``.
2. Fine: curr rolled circularly by ``FACTOR`` times the coarse offset,
   ``rolled[y, x] = curr[(y - dy) mod H, (x - dx) mod W]``, then picked
   at full resolution over ``[-FINE_RADIUS, FINE_RADIUS]^2``.
3. The pair's offset is ``FACTOR`` * coarse + fine, matched where both
   levels accept.

Departures from the program's formulation (``models/pyramid.py`` over
``ops/correlate.py``), none of which changes a count:

- the coarse level counts every shift directly, by slicing both frames
  to the overlap, where the program correlates one-hot channels by FFT
  on a zero-padded plane and rounds the result to the integers; the
  counts are exact, so the two must agree to the integer;
- the fine level slices ``prev`` to the overlap rather than rolling it
  and cutting the compare;
- the roll of step 2 is ``torch.roll`` of each group of pairs that share
  a coarse offset, where the program gathers every pair with its own
  modular indices;
- the first maximum is found as the number of entries before the first
  one equal to the maximum;
- pairs go through in blocks of at most ``ELEMENTS`` compared pixels a
  shift, so that a session's pairs fit on one card.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

FACTOR = 4
COARSE_RADIUS = 32
FINE_RADIUS = FACTOR + 1
MIN_COVER = 0.15
MIN_RATIO = 1.10
EXCLUDE = 2
#: pixels compared at once, one shift of a block of pairs
ELEMENTS = 1 << 27


def _blocks(n: int, pixels: int) -> Iterator[slice]:
    step = max(1, ELEMENTS // max(1, pixels))
    for i in range(0, n, step):
        yield slice(i, min(n, i + step))


def agreement_counts(prev: torch.Tensor, curr: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """``[B, 2R+1, 2R+1]`` int64: ``[b, dy + R, dx + R]`` is S[d] of pair
    b of ``[B, H, W]`` frames."""
    b, h, w = prev.shape
    rows = []
    for dy in range(-radius, radius + 1):
        y0, y1 = max(0, -dy), min(h, h - dy)
        cols = []
        for dx in range(-radius, radius + 1):
            x0, x1 = max(0, -dx), min(w, w - dx)
            if y0 >= y1 or x0 >= x1:
                cols.append(torch.zeros(b, dtype=torch.int64,
                                        device=prev.device))
                continue
            same = (curr[:, y0:y1, x0:x1]
                    == prev[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx])
            cols.append(same.sum(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


def pick(counts: torch.Tensor, h: int, w: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offset ``[B, 2]`` int64 (dx, dy), accepted ``[B]`` bool) of a
    level's counts over a ``[h, w]`` frame."""
    b, n, _ = counts.shape
    r = n // 2
    flat = counts.reshape(b, -1)
    top = flat.max(dim=1, keepdim=True).values
    first = ((flat == top).cumsum(dim=1) == 0).sum(dim=1)
    py, px = first // n, first % n
    ys = torch.arange(n, device=counts.device).view(1, n, 1)
    xs = torch.arange(n, device=counts.device).view(1, 1, n)
    near = (((ys - py.view(b, 1, 1)).abs() <= EXCLUDE)
            & ((xs - px.view(b, 1, 1)).abs() <= EXCLUDE))
    runner = torch.where(near, -1, counts).reshape(b, -1).max(dim=1).values
    peak = top[:, 0].to(torch.float32)
    cover = torch.tensor(MIN_COVER * h * w, dtype=torch.float32)
    ratio = torch.tensor(MIN_RATIO, dtype=torch.float32)
    ok = (peak >= cover.to(peak.device)) & (
        peak >= runner.to(torch.float32) * ratio.to(peak.device))
    return torch.stack([px - r, py - r], dim=1), ok


def _roll_each(frames: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(frames)
    for off in torch.unique(offsets, dim=0).tolist():
        rows = (offsets == torch.tensor(off, device=offsets.device)).all(
            dim=1)
        out[rows] = torch.roll(frames[rows], shifts=(off[1], off[0]),
                               dims=(1, 2))
    return out


def match(prev: torch.Tensor, curr: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offset ``[B, 2]`` int64 (dx, dy), matched ``[B]`` bool) of the
    ``[B, H, W]`` uint8 frame pairs."""
    b, h, w = prev.shape
    small_prev = prev[:, ::FACTOR, ::FACTOR]
    small_curr = curr[:, ::FACTOR, ::FACTOR]
    sh, sw = small_prev.shape[1:]
    coarse, coarse_ok = [], []
    for s in _blocks(b, sh * sw):
        off, ok = pick(agreement_counts(small_prev[s], small_curr[s],
                                        COARSE_RADIUS), sh, sw)
        coarse.append(off)
        coarse_ok.append(ok)
    base = torch.cat(coarse) * FACTOR
    fine, fine_ok = [], []
    for s in _blocks(b, h * w):
        rolled = _roll_each(curr[s], base[s])
        off, ok = pick(agreement_counts(prev[s], rolled, FINE_RADIUS), h, w)
        fine.append(off)
        fine_ok.append(ok)
    return base + torch.cat(fine), torch.cat(coarse_ok) & torch.cat(fine_ok)
