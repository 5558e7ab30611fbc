"""Dense 2D cross-correlation alignment scoring (port of
remap_tpu/ops/correlate.py): the xcorr and pyramid families' matchers.

The count-of-agreement score

    S[d] = #{x : curr(x) == prev(x + d)}

over all shifts |d| <= R comes from one FFT correlation of the 16 one-hot
palette channels (``torch.fft``, as the JAX package leaves its FFTs to
XLA: no hand-written kernel).  The counts are integers far below 2**24,
and the float32 FFT lands within a small fraction of them, so the port
rounds every FFT surface to the integers before it picks anything.  The
JAX package picks its frame-matcher peak, and runs its dominance test, on
the unrounded surface, where the FFT's round-off (which differs between
XLA, pocketfft and cuFFT) would decide exact ties; on the rounded surface
the first maximum in row-major order wins on every device.  Where JAX's
own pick rests on that noise, the case is recorded in ROADMAP.md (queue
3) as found against JAX.

Canvas matching (splice) picks 8 candidates from the rounded FFT planes,
larger score first and the lower flat index first on ties (``lax.top_k``'s
order, here a top-k of distinct composite keys), and rescores them by
direct masked comparison, which is exact.

The pyramid's fine level (:func:`fine_counts`) counts its small window
directly, with each ``curr`` rolled by its coarse offset: on CUDA tensors
one hand-written kernel (``csrc/fine.cu``) counts every shift of a batch
from one read of both frames, with no rolled copy.

All thresholds are float32 as in the JAX package: ``min_cover * h * w``
is a Python float compared in float32, and the ratio tests multiply by a
float32 ratio (PyTorch, like JAX's weak typing, casts a Python scalar to
the tensor's float32; as kernel arguments, they cost no copy to the
device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from remap_tpu_torch.device import uses_kernels
from remap_tpu_torch.ops.kernels import correlate as kcorrelate

#: the one-hot channels (4-bit palette codes)
CHANNELS = 16
#: elements of one gathered block of candidate shifts in ``_direct_rescore``
_RESCORE_ELEMENTS = 1 << 25


class XCorrResult(NamedTuple):
    offset: torch.Tensor   # [B, 2] int32 (dx, dy)
    ok: torch.Tensor       # [B] bool
    score: torch.Tensor    # [B] float32 peak agreement count (an integer)


class CanvasMatch(NamedTuple):
    offset: torch.Tensor   # [2] int32 (dx, dy): other's origin in head coords
    count: torch.Tensor    # [] int32 agreement pixels at the peak
    overlap: torch.Tensor  # [] int32 overlap pixels at the peak
    ok: torch.Tensor       # [] bool


def _pad_dim(n: int, r: int) -> int:
    """The padded FFT size >= n + 2r, a multiple of 128 (the JAX
    package's size: the surface is cut from the same plane)."""
    return ((n + 2 * r + 127) // 128) * 128


def _fft_dim(n: int) -> int:
    return ((n + 127) // 128) * 128


def _correlate(pairs, shape) -> torch.Tensor:
    """sum over ``pairs`` of the circular cross-correlation
    ``irfft2(rfft2(a) * conj(rfft2(b)))`` on a zero-padded ``shape`` plane,
    rounded to the integers.  ``pairs`` yields (a, b) float32 planes, one
    channel at a time, so only one channel's spectra are live; the
    spectral products add before the one inverse transform."""
    acc = None
    for a, b in pairs:
        prod = torch.fft.rfft2(a, s=shape) * torch.fft.rfft2(b, s=shape).conj()
        acc = prod if acc is None else acc.add_(prod)
    return torch.round(torch.fft.irfft2(acc, s=shape))


def correlation_scores(prev: torch.Tensor, curr: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """``[B, 2R+1, 2R+1]`` float32 agreement counts for shifts in
    ``[-R, R]^2``: ``score[dy + R, dx + R] = #{x : curr(x) == prev(x +
    d)}``, from the FFT rounded to the integers."""
    _, h, w = prev.shape
    shape = (_pad_dim(h, radius), _pad_dim(w, radius))
    corr = _correlate((((prev == c).float(), (curr == c).float())
                       for c in range(CHANNELS)), shape)
    # corr[d mod (ph, pw)] = sum_x prev(x + d) curr(x): roll the window so
    # that index 0 is d = -R
    n = 2 * radius + 1
    return torch.roll(corr, (radius, radius), dims=(1, 2))[:, :n, :n]


def correlation_scores_direct(prev: torch.Tensor, curr: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """The same counts by (2R+1)^2 shifted compares (the pyramid's fine
    pass), exact: ``prev`` rolled by ``-d`` and compared where ``x + d``
    lies inside the frame, with the JAX package's slices."""
    _, h, w = prev.shape
    rows = []
    for dy in range(-radius, radius + 1):
        cols = []
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(prev, (-dy, -dx), dims=(1, 2))
            eq = shifted == curr
            y0, y1 = max(0, -dy), h - max(0, dy)
            x0, x1 = max(0, -dx), w - max(0, dx)
            cols.append(eq[:, y0:y1, x0:x1].sum(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2).to(torch.float32)


def shift_frames(frames: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x] = frames[b, (y - dy_b) mod H, (x - dx_b) mod W]``:
    each ``[H, W]`` frame rolled by its own ``offsets[b]`` = (dx, dy), as a
    gather with modular indices (``torch.roll`` has no per-sample
    shifts)."""
    b, h, w = frames.shape
    dev = frames.device
    off = offsets.to(torch.int64)
    ys = (torch.arange(h, device=dev)[None] - off[:, 1, None]) % h
    xs = (torch.arange(w, device=dev)[None] - off[:, 0, None]) % w
    bi = torch.arange(b, device=dev)[:, None, None]
    return frames[bi, ys[:, :, None], xs[:, None, :]]


def fine_counts(prev: torch.Tensor, curr: torch.Tensor, base: torch.Tensor,
                radius: int) -> torch.Tensor:
    """The pyramid's fine level: ``[B, 2R+1, 2R+1]`` float32 direct counts
    of each ``[B, H, W]`` uint8 pair with ``curr`` rolled by its own
    ``base[b]`` = (dx, dy) (int32), i.e. ``correlation_scores_direct(prev,
    shift_frames(curr, base), radius)``, which CPU tensors get.  On CUDA
    tensors the kernel ``ops.kernels.correlate.fine_counts_cuda`` counts
    the same integers from one read of both frames, reading ``curr`` at
    its rolled coordinates."""
    if uses_kernels(prev):
        return kcorrelate.fine_counts_cuda(prev, curr, base, radius).float()
    return correlation_scores_direct(prev, shift_frames(curr, base), radius)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (int64)."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    top = x.amax(dim=-1, keepdim=True)
    return torch.where(x == top, iota, n).amin(dim=-1)


def pick_peak(win: torch.Tensor, h: int, w: int, min_ratio: float = 1.10,
              min_cover: float = 0.20, exclude: int = 2) -> XCorrResult:
    """Peak pick + dominance acceptance over ``[B, 2R+1, 2R+1]`` windows
    of counts of ``[H, W]`` frame pairs: the first maximum of each window,
    accepted where it covers ``min_cover`` of the frame and beats the best
    score outside its ``exclude`` neighbourhood by ``min_ratio``."""
    b, n = win.shape[0], win.shape[-1]
    radius = n // 2
    dev = win.device
    flat = win.reshape(b, -1)
    peak_idx = _first_argmax(flat)
    peak = flat.gather(1, peak_idx[:, None])[:, 0]
    py = peak_idx // n
    px = peak_idx % n

    ys = torch.arange(n, device=dev)[None, :, None]
    xs = torch.arange(n, device=dev)[None, None, :]
    near = (((ys - py[:, None, None]).abs() <= exclude)
            & ((xs - px[:, None, None]).abs() <= exclude))
    runner = torch.where(near, -torch.inf, win).amax(dim=(1, 2))

    offset = torch.stack([px - radius, py - radius], dim=-1).to(torch.int32)
    ok = (peak >= min_cover * h * w) & (peak >= runner * min_ratio)
    return XCorrResult(offset=offset, ok=ok, score=peak)


def match_xcorr(prev: torch.Tensor, curr: torch.Tensor, radius: int = 48,
                min_ratio: float = 1.10, min_cover: float = 0.20,
                exclude: int = 2) -> XCorrResult:
    """:func:`pick_peak` over the rounded FFT correlation window of each
    ``[B, H, W]`` uint8 frame pair.  (The JAX package's ``method="direct"``
    is :func:`pick_peak` over :func:`correlation_scores_direct` here.)"""
    _, h, w = prev.shape
    return pick_peak(correlation_scores(prev, curr, radius), h, w, min_ratio,
                     min_cover, exclude)


def _canvas_planes(a_img, a_mask, b_img, b_mask, ny: int, nx: int):
    """(agreement, overlap) full-plane correlation surfaces of the two
    masked canvases zero-padded onto a common ``[ny, nx]`` plane, rounded:
    agreement[d] counts the pixels where both masks are on and the codes
    are equal when ``b``'s pixel at c meets ``a``'s at c + d; overlap[d]
    the mask intersection alone."""
    shape = (ny, nx)
    a_on, b_on = a_mask != 0, b_mask != 0
    agreement = _correlate(((((a_img == c) & a_on).float(),
                             ((b_img == c) & b_on).float())
                            for c in range(CHANNELS)), shape)
    overlap = _correlate([(a_on.float(), b_on.float())], shape)
    return agreement, overlap


def _direct_rescore(a_img, a_mask, b_img, b_mask, cands):
    """Exact ``(agreement, overlap)`` int32 counts ``[K]`` for the
    candidate shifts ``cands`` ``[K, 2]`` (dx, dy).

    Both canvases sit on a common ``[HA+HB, WA+WB]`` grid, and candidate d
    compares ``a`` rolled by ``-d`` against ``b`` (the JAX package's
    ``jnp.roll``, whose wrap-around never meets ``b``'s footprint for a
    valid shift).  Only ``b``'s footprint can count, so each candidate
    gathers the rolled ``a`` over it alone, in blocks of candidates of at
    most ``_RESCORE_ELEMENTS`` pixels.  ``a_img * a_mask`` stays uint8."""
    ha, wa = a_img.shape
    hb, wb = b_img.shape
    gh, gw = ha + hb, wa + wb
    dev = a_img.device
    pa = torch.zeros((gh, gw), dtype=torch.uint8, device=dev)
    pa[:ha, :wa] = a_img * a_mask
    pam = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
    pam[:ha, :wa] = a_mask != 0
    pb = b_img * b_mask
    pbm = b_mask != 0
    cands = cands.to(torch.int64)
    ys = (torch.arange(hb, device=dev)[None] + cands[:, 1, None]) % gh
    xs = (torch.arange(wb, device=dev)[None] + cands[:, 0, None]) % gw
    step = max(1, _RESCORE_ELEMENTS // max(1, hb * wb))
    agrs, ovls = [], []
    for i in range(0, cands.shape[0], step):
        yi = ys[i:i + step, :, None]
        xi = xs[i:i + step, None, :]
        both = pam[yi, xi] & pbm
        agrs.append(((pa[yi, xi] == pb) & both).sum(dim=(1, 2),
                                                    dtype=torch.int32))
        ovls.append(both.sum(dim=(1, 2), dtype=torch.int32))
    return torch.cat(agrs), torch.cat(ovls)


def _accept(agrs, ovls, cands, min_overlap: int, ratio: float) -> CanvasMatch:
    """The first candidate of most agreement among those with at least
    ``min_overlap`` covered pixels, accepted where agreement >= ratio *
    overlap (float32)."""
    best = _first_argmax(torch.where(ovls >= min_overlap, agrs, -1))
    peak_agr, peak_ovl = agrs[best], ovls[best]
    ok = (peak_ovl >= min_overlap) & (
        peak_agr.float() >= peak_ovl.float() * ratio)
    return CanvasMatch(offset=cands[best].to(torch.int32), count=peak_agr,
                       overlap=peak_ovl, ok=ok)


def match_canvases(a_img: torch.Tensor, a_mask: torch.Tensor,
                   b_img: torch.Tensor, b_mask: torch.Tensor,
                   min_overlap: int = 1024,
                   ratio: float = 0.85) -> CanvasMatch:
    """Masked-agreement alignment of two fragment canvases of any sizes
    (``[HA, WA]`` and ``[HB, WB]`` uint8 codes and masks), the correlation
    families' splice matcher: the 8 best offsets of the rounded FFT plane
    among those with ``min_overlap`` covered pixels are rescored exactly,
    the peak maximises agreement, and acceptance needs agreement >= ratio
    * overlap there."""
    ha, wa = a_img.shape
    hb, wb = b_img.shape
    ny, nx = _fft_dim(ha + hb), _fft_dim(wa + wb)
    agr, ovl = _canvas_planes(a_img, a_mask, b_img, b_mask, ny, nx)
    score = torch.where(ovl >= min_overlap, agr, -1.0).reshape(-1)
    # lax.top_k's order: larger score first, the lower flat index first on
    # ties; distinct int64 keys make the top-k's order unique
    size = ny * nx
    iota = torch.arange(size, device=score.device)
    key = (score.to(torch.int64) + 1) * size + (size - 1 - iota)
    flat_idx = torch.topk(key, 8).indices
    iy, ix = flat_idx // nx, flat_idx % nx
    # index -> signed shift: d in [-(len_b - 1), len_a - 1]
    dx = ((ix + wb - 1) % nx) - (wb - 1)
    dy = ((iy + hb - 1) % ny) - (hb - 1)
    cands = torch.stack([dx, dy], dim=-1)
    agrs, ovls = _direct_rescore(a_img, a_mask, b_img, b_mask, cands)
    return _accept(agrs, ovls, cands, min_overlap, ratio)


def match_canvases_pyramid(a_img: torch.Tensor, a_mask: torch.Tensor,
                           b_img: torch.Tensor, b_mask: torch.Tensor,
                           factor: int = 4, min_overlap: int = 1024,
                           ratio: float = 0.85) -> CanvasMatch:
    """Coarse-to-fine canvas alignment: :func:`match_canvases` on both
    canvases decimated by ``factor`` (stride subsampling: palette codes
    cannot average), then the (2(factor+2)+1)^2 full-resolution offsets
    around the upscaled coarse peak rescored exactly."""
    coarse = match_canvases(
        a_img[::factor, ::factor], a_mask[::factor, ::factor],
        b_img[::factor, ::factor], b_mask[::factor, ::factor],
        min_overlap=max(1, min_overlap // (factor * factor)), ratio=ratio)
    r = factor + 2
    dev = a_img.device
    steps = torch.arange(-r, r + 1, device=dev)
    ddy, ddx = torch.meshgrid(steps, steps, indexing="ij")
    cands = (coarse.offset.to(torch.int64) * factor
             + torch.stack([ddx.reshape(-1), ddy.reshape(-1)], dim=-1))
    agrs, ovls = _direct_rescore(a_img, a_mask, b_img, b_mask, cands)
    return _accept(agrs, ovls, cands, min_overlap, ratio)
