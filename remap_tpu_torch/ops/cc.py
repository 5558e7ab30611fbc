"""Connected-component labelling, plain PyTorch (port of
remap_tpu/ops/cc.py ``label_components``, and of the contract of the
Pallas ``label_stats_batch``).

Components are equal-valued and 4-connected inside the interior: rows
``1..H-3`` and columns ``1..W-2`` (the bottom horizon is two rows,
cte.hpp:155-165).  An interior pixel's label is the flat index of its
component's row-major-first pixel; a border pixel's label is ``H*W``.

These are the plain versions of the CUDA kernel ``csrc/cc.cu``
(``ops.kernels.cc``), which the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import torch


def interior_mask(h: int, w: int, device) -> torch.Tensor:
    """[H, W] bool, True inside the horizon frame."""
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[1:h - 2, 1:w - 1] = True
    return m


def _run_min(labels: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Min of ``labels`` over each run of the flattened last axis; a run
    begins wherever ``starts`` is set."""
    run = torch.cumsum(starts.reshape(-1), 0) - 1
    flat = labels.reshape(-1)
    mins = torch.full_like(flat, torch.iinfo(flat.dtype).max)
    mins.scatter_reduce_(0, run, flat, "amin")
    return mins[run].view_as(labels)


def _run_starts(img: torch.Tensor) -> torch.Tensor:
    """True where a pixel's value differs from its left neighbour's, and
    at the start of every row."""
    starts = torch.ones_like(img, dtype=torch.bool)
    starts[..., 1:] = img[..., 1:] != img[..., :-1]
    return starts


def label_components(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W] integer images -> [B, H, W] int32 labels.

    Alternating row-run and column-run minimum passes with a pointer jump
    (``label <- label[label]``) between them, until nothing changes.
    Labels only decrease and stay inside their component, so the fixpoint
    is every component's minimum flat index: its row-major-first pixel.
    The loop tests for the fixpoint on the host each round."""
    b, h, w = images.shape
    big = h * w
    dev = images.device
    interior = interior_mask(h, w, dev)
    # border pixels take a value no image holds, so no run crosses them
    img = torch.where(interior, images.to(torch.int64), -1)
    iota = torch.arange(big, dtype=torch.int64, device=dev).view(h, w)
    labels = torch.where(interior, iota, big).expand(b, h, w).contiguous()
    row_starts = _run_starts(img)
    col_starts = _run_starts(img.transpose(1, 2).contiguous())
    while True:
        nxt = _run_min(labels, row_starts)
        nxt = _run_min(nxt.transpose(1, 2).contiguous(), col_starts)
        nxt = nxt.transpose(1, 2).reshape(b, big)
        jumped = nxt.gather(1, nxt.clamp(max=big - 1))
        nxt = torch.where(nxt == big, big, jumped).view(b, h, w)
        if torch.equal(nxt, labels):
            return labels.to(torch.int32)
        labels = nxt


def border_stats(big: int) -> tuple[int, int, int, int, int]:
    """The stats of a border pixel, (minx, miny, maxx, maxy, changed): the
    JAX kernel seeds the border with ``H*W`` and propagates the max
    planes negated (ops/pallas/cc.py ``_cc_core``, ``_cc_maxs_kernel``)."""
    return (big, big, -big, -big, -big)


def label_stats(images: torch.Tensor, changed: torch.Tensor):
    """[B, H, W] images + [B, H, W] changed flags -> (labels [B, H, W]
    int32, stats [B, 5, H, W] int32): each interior pixel gets its
    component's (minx, miny, maxx, maxy, max of changed); border pixels
    get :func:`border_stats`."""
    b, h, w = images.shape
    big = h * w
    dev = images.device
    labels = label_components(images)
    flat = labels.reshape(b, big).to(torch.int64)
    inside = flat < big
    root = flat.clamp(max=big - 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    chg = changed.reshape(b, big).to(torch.int64)
    planes = []
    for vals, how in ((xs, "amin"), (ys, "amin"), (xs, "amax"),
                      (ys, "amax"), (chg, "amax")):
        vals = vals.reshape(-1, big).expand(b, big)
        slots = torch.zeros((b, big), dtype=torch.int64, device=dev)
        slots.scatter_reduce_(1, root, vals, how, include_self=False)
        planes.append(slots.gather(1, root))
    stats = torch.stack(planes, dim=1)
    border = torch.tensor(border_stats(big), dtype=torch.int64, device=dev)
    stats = torch.where(inside[:, None], stats, border[None, :, None])
    return labels, stats.view(b, 5, h, w).to(torch.int32)
