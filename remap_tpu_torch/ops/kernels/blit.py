"""The colour-vote blit into a channels-major ``[16, AH', AW']`` atlas
(port of remap_tpu/ops/pallas/blit.py).

:func:`blit_frames_` adds the votes into the caller's canvas in place: the
CUDA kernel ``csrc/blit.cu`` on CUDA tensors, :func:`blit_frames_plain_`
on CPU tensors.  Only the bins that receive a vote change; everything
outside the frames' box is neither read nor written.  :func:`blit_frames`
is the functional form the JAX package has (a copy, then the in-place
add).  The atlas is uint16 in the JAX package; here it is int32 holding
values in [0, 2**16), and every add wraps modulo 2**16 as the reference's
vote counters do (fgm.hpp:12-15).  The physical dims keep the JAX
package's padding (``padded_dims``), so a converted atlas has the same
shape on both sides.

A frame pixel votes for its colour (colours >= 16 never vote) where the
optional ``vote`` plane ``[F, H, W]`` uint8 allows it: with
``vote_polarity="nonzero"`` where the plane is != 0 (a ``vote_ok`` plane),
with ``"zero"`` where it is == 0 (foreground masks); with no plane every
pixel votes.
"""

from __future__ import annotations

import numpy as np
import torch

from remap_tpu_torch.device import uses_kernels
from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops.kernels import check_input, stream_handle

DEPTH = 16
SUB = 8      # the JAX package's sublane alignment
LANE = 128   # the JAX package's lane alignment

#: vote-plane polarity -> the kernel's code (0 is "no plane")
POLARITIES = {"nonzero": 1, "zero": 2}


def padded_dims(atlas_h: int, atlas_w: int) -> tuple[int, int]:
    """Physical atlas dims (logical atlas at [:h, :w]), as
    remap_tpu/ops/pallas/blit.py::padded_dims."""
    ah = ((atlas_h + 2 * SUB + SUB - 1) // SUB) * SUB
    aw = ((atlas_w + 2 * LANE + LANE - 1) // LANE) * LANE
    return ah, aw


def frames_box(positions, h: int, w: int) -> tuple[int, int, int, int]:
    """``(x_lo, y_lo, x_hi, y_hi)``, the box that ``h x w`` frames at the
    host positions ``[F, 2]`` (x, y) cover."""
    pos = np.asarray(positions).reshape(-1, 2)
    if not len(pos):
        return 0, 0, 0, 0
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    return int(lo[0]), int(lo[1]), int(hi[0]) + w, int(hi[1]) + h


def _check_polarity(vote_polarity: str) -> None:
    if vote_polarity not in POLARITIES:
        raise ValueError(f"vote_polarity must be one of {sorted(POLARITIES)},"
                         f" got {vote_polarity!r}")


def blit_frames_plain_(frames: torch.Tensor, positions: torch.Tensor,
                       dots: torch.Tensor, *, vote: torch.Tensor | None = None,
                       vote_polarity: str = "nonzero") -> torch.Tensor:
    """The plain in-place blit: one integer ``index_put_`` (accumulate) of
    every voting pixel into its (colour, y, x) bin of ``dots``, then the
    uint16 wrap of the bins it touched — the same sums as the JAX scan of
    dynamic-update-slices (parallel/sharded.py:363-375)."""
    _check_polarity(vote_polarity)
    _, h, w = frames.shape
    _, ahp, awp = dots.shape
    dev = frames.device
    pos = positions.to(torch.int64)
    ys = pos[:, 1, None, None] + torch.arange(h, device=dev)[None, :, None]
    xs = pos[:, 0, None, None] + torch.arange(w, device=dev)[None, None, :]
    colour = frames.to(torch.int64)
    ok = colour < DEPTH
    if vote is not None:
        ok &= (vote != 0) if vote_polarity == "nonzero" else (vote == 0)
    bins = (colour * (ahp * awp) + ys * awp + xs)[ok]
    flat = dots.view(-1)
    flat.index_put_((bins,), torch.ones_like(bins, dtype=dots.dtype),
                    accumulate=True)
    flat[bins] = flat[bins] & 0xFFFF
    return dots


def blit_frames_cuda(frames: torch.Tensor, positions: torch.Tensor,
                     dots: torch.Tensor, *, vote: torch.Tensor | None = None,
                     vote_polarity: str = "nonzero",
                     box=None) -> torch.Tensor:
    """The CUDA blit kernel, in place on ``dots``.  ``box`` (x_lo, y_lo,
    x_hi, y_hi), known on the host, must hold every frame's rectangle;
    the grid spans it (the whole canvas without one), and its blocks that
    no frame meets exit at once.  Positions must keep every frame inside
    the physical atlas."""
    _check_polarity(vote_polarity)
    f, h, w = frames.shape
    dev = frames.device
    check_input(frames, "frames", torch.uint8, (f, h, w))
    if vote is not None:
        check_input(vote, "vote", torch.uint8, (f, h, w))
    check_input(positions, "positions", torch.int32, (f, 2))
    check_input(dots, "dots", torch.int32, (DEPTH, None, None))
    if not f < 1 << 16:
        raise ValueError(f"at most {(1 << 16) - 1} frames per call, got {f}")
    _, ahp, awp = dots.shape
    if awp % 4 or dots.data_ptr() % 16:
        raise ValueError("dots: the width must be a multiple of 4 and the "
                         "storage 16-byte aligned")
    x_lo, y_lo, x_hi, y_hi = (0, 0, awp, ahp) if box is None else map(int,
                                                                      box)
    x_lo, y_lo = max(x_lo, 0), max(y_lo, 0)
    x_hi, y_hi = min(x_hi, awp), min(y_hi, ahp)
    if f == 0 or x_hi <= x_lo or y_hi <= y_lo:
        return dots   # nothing lands: no launch
    rc = _build.library().remap_blit(
        frames.data_ptr(), 0 if vote is None else vote.data_ptr(),
        0 if vote is None else POLARITIES[vote_polarity],
        positions.data_ptr(), f, h, w, dots.data_ptr(), ahp, awp,
        x_lo, y_lo, x_hi, y_hi, stream_handle(dev),
    )
    _build.check(rc, "blit")
    blit_frames_cuda.launches += 1
    return dots


blit_frames_cuda.launches = 0


def blit_frames_(frames: torch.Tensor, positions: torch.Tensor,
                 dots: torch.Tensor, *, vote: torch.Tensor | None = None,
                 vote_polarity: str = "nonzero", box=None) -> torch.Tensor:
    """frames [F, H, W] uint8 at positions [F, 2] int32 (x, y) in-bounds,
    voted into dots [16, AH', AW'] int32 in place (returned): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors.  ``vote``
    and ``vote_polarity`` as in the module note; ``box`` an optional host
    bound of the frames' rectangles that sizes the kernel's grid."""
    if uses_kernels(frames):
        return blit_frames_cuda(frames, positions, dots, vote=vote,
                                vote_polarity=vote_polarity, box=box)
    return blit_frames_plain_(frames, positions, dots, vote=vote,
                              vote_polarity=vote_polarity)


def _fresh(dots, atlas_h, atlas_w, device):
    if dots is None:
        return torch.zeros((DEPTH,) + padded_dims(atlas_h, atlas_w),
                           dtype=torch.int32, device=device)
    return dots.clone()


def blit_frames_plain(frames: torch.Tensor, vote_ok: torch.Tensor | None,
                      positions: torch.Tensor, atlas_h: int, atlas_w: int,
                      dots: torch.Tensor | None = None, *,
                      vote_polarity: str = "nonzero") -> torch.Tensor:
    """The plain blit's functional form: a new atlas, ``dots`` (or zeros)
    plus the votes."""
    out = _fresh(dots, atlas_h, atlas_w, frames.device)
    return blit_frames_plain_(frames, positions, out, vote=vote_ok,
                              vote_polarity=vote_polarity)


def blit_frames(frames: torch.Tensor, vote_ok: torch.Tensor | None,
                positions: torch.Tensor, atlas_h: int, atlas_w: int,
                dots: torch.Tensor | None = None, *,
                vote_polarity: str = "nonzero") -> torch.Tensor:
    """The JAX package's signature: frames [F, H, W] uint8, vote_ok [F, H,
    W] uint8 (1 where the pixel votes; None: every pixel), positions [F,
    2] int32 (x, y) in-bounds, dots [16, AH', AW'] int32 -> the new [16,
    AH', AW'] atlas (``dots`` is left as it was)."""
    out = _fresh(dots, atlas_h, atlas_w, frames.device)
    return blit_frames_(frames, positions, out, vote=vote_ok,
                        vote_polarity=vote_polarity)
