"""Fixed-capacity per-region keypoint tables (port of remap_tpu/ops/tables.py).

Each grid region's keypoints (``weight > 0``) are selected in row-major
order into a table of ``capacity`` rows: the topk semantics of
``remap_tpu.ops.tables.build_tables``.  Rows past the keypoint count take
the canonical values of the TPU table kernel (ops/pallas/tables.py): the
code of the region's first pixel and position ``(x_lo, y_lo)``.

``build_tables`` runs the CUDA kernel (``ops.kernels.tables``) on CUDA
tensors and :func:`build_tables_plain` on CPU tensors.  Table mode "sort2"
(``remap_tpu/ops/tables.py:102 _region_table_sort2``, XLA code in the JAX
package, no TPU kernel) is torch ops on either device: the same rows while
no 512-px chunk holds more than ``SORT2_QUOTA`` keypoints, and an overflow
flag where one does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from remap_tpu_torch.core.regions import GridLayout
from remap_tpu_torch.device import uses_kernels
from remap_tpu_torch.ops.kernels import tables as ktab


class RegionTables(NamedTuple):
    codes: torch.Tensor     # [B, R, K, 4] int32 bit patterns of uint32 words
    pos: torch.Tensor       # [B, R, K, 2] int32 — (x, y) frame coords
    valid: torch.Tensor     # [B, R, K] bool
    wcounts: torch.Tensor   # [B, R, 3] int32 — full counts per weight (0,1,2)
    overflow: torch.Tensor  # [B, R] bool


def empty_tables(regions: int, capacity: int, device) -> RegionTables:
    """All-zero tables of one frame, ``[1, regions, capacity, ...]``: the
    carry before the first frame (it has no keypoints, so it matches
    nothing)."""
    r, k = regions, capacity
    return RegionTables(
        codes=torch.zeros((1, r, k, 4), dtype=torch.int32, device=device),
        pos=torch.zeros((1, r, k, 2), dtype=torch.int32, device=device),
        valid=torch.zeros((1, r, k), dtype=torch.bool, device=device),
        wcounts=torch.zeros((1, r, 3), dtype=torch.int32, device=device),
        overflow=torch.zeros((1, r), dtype=torch.bool, device=device),
    )


def region_spans(layout: GridLayout) -> list[tuple[int, int, int, int]]:
    """(x_lo, x_hi, y_lo, y_hi) per region, in index order
    ``xs * grid_h + ys`` (kpr.hpp:68-91), cut to the frame as the JAX
    package's slices cut them (a narrow layout's third column band can
    reach past the frame's right edge)."""
    spans = []
    for xs in range(layout.grid_w):
        for ys in range(layout.grid_h):
            x_lo, x_hi, y_lo, y_hi = layout.region_span(xs, ys)
            spans.append((x_lo, min(x_hi, layout.width),
                          y_lo, min(y_hi, layout.height)))
    return spans


def _region_table(weight, codes, span, capacity):
    """One region's table over a batch: a scatter of each keypoint to its
    row-major rank (ranks at or past ``capacity`` land in a dropped row)."""
    x_lo, x_hi, y_lo, y_hi = span
    b = weight.shape[0]
    rw = x_hi - x_lo
    wflat = weight[:, y_lo:y_hi, x_lo:x_hi].reshape(b, -1)
    cflat = codes[:, y_lo:y_hi, x_lo:x_hi].reshape(b, -1, 4)
    n = wflat.shape[1]
    dev = weight.device

    flags = wflat > 0
    rank = torch.cumsum(flags, dim=1) - flags.long()
    dest = torch.where(flags & (rank < capacity), rank, capacity)   # [B, n]

    first_code = codes[:, y_lo, x_lo]                               # [B, 4]
    out_codes = first_code[:, None, :].repeat(1, capacity + 1, 1)
    out_codes.scatter_(1, dest[..., None].expand(b, n, 4), cflat)

    i = torch.arange(n, device=dev, dtype=torch.int32)
    pix = torch.stack([x_lo + i % rw, y_lo + i // rw], dim=-1)      # [n, 2]
    out_pos = torch.tensor([x_lo, y_lo], dtype=torch.int32, device=dev)
    out_pos = out_pos.repeat(b, capacity + 1, 1)
    out_pos.scatter_(1, dest[..., None].expand(b, n, 2),
                     pix[None].expand(b, n, 2))

    w1 = (wflat == 1).sum(dim=1, dtype=torch.int32)
    w2 = (wflat == 2).sum(dim=1, dtype=torch.int32)
    total = w1 + w2
    slot = torch.arange(capacity, device=dev)
    valid = slot[None, :] < total[:, None]
    wcounts = torch.stack([torch.zeros_like(w1), w1, w2], dim=-1)
    return (out_codes[:, :capacity], out_pos[:, :capacity], valid, wcounts,
            total > capacity)


def _stack_regions(region_table, weight, codes, layout: GridLayout,
                   capacity: int) -> RegionTables:
    """``region_table`` of every region, stacked on axis 1."""
    per_region = [region_table(weight, codes, span, capacity)
                  for span in region_spans(layout)]
    return RegionTables(*(torch.stack(parts, dim=1)
                          for parts in zip(*per_region)))


def build_tables_plain(weight: torch.Tensor, codes: torch.Tensor,
                       layout: GridLayout, capacity: int) -> RegionTables:
    """The plain PyTorch table build; regions stack on axis 1."""
    return _stack_regions(_region_table, weight, codes, layout, capacity)


#: "sort2" level-1 chunk length and per-chunk keep quota.  A chunk with
#: more than QUOTA keypoints trips the table overflow flag.
SORT2_CHUNK = 512
SORT2_QUOTA = 128

#: every table mode: "auto", "pallas" (the TPU kernel's selection, here
#: the CUDA one's) and "sort" give the topk tables, "sort2" its own
TABLE_MODES = ("auto", "topk", "pallas", "sort", "sort2")


def _region_table_sort2(weight, codes, span, capacity):
    """One region's "sort2" table over a batch: the first ``SORT2_QUOTA``
    keypoints of each 512-px chunk by their local index (level 1), then
    the first ``capacity`` of those by their region index (level 2).
    The level-1 keys (uint16 in JAX, sentinel 0x7FFF) and the level-2 keys
    (uint32, sentinel 1 << 30) ride in int32.  Valid keys are distinct and
    only sentinels tie, so any sort gives JAX's sorted values."""
    x_lo, x_hi, y_lo, y_hi = span
    b = weight.shape[0]
    rw = x_hi - x_lo
    wflat = weight[:, y_lo:y_hi, x_lo:x_hi].reshape(b, -1)
    cflat = codes[:, y_lo:y_hi, x_lo:x_hi].reshape(b, -1, 4)
    n = wflat.shape[1]
    dev = weight.device
    s = SORT2_CHUNK
    flags = F.pad(wflat > 0, (0, (-n) % s)).reshape(b, -1, s)
    nch = flags.shape[1]

    local = torch.arange(s, dtype=torch.int32, device=dev)
    kept = torch.where(flags, local, 0x7FFF).sort(dim=2).values
    kept = kept[:, :, :SORT2_QUOTA]
    sent = 1 << 30
    base = torch.arange(nch, dtype=torch.int32, device=dev)[None, :, None]
    glob = torch.where(kept < 0x7FFF, base * s + kept, sent).reshape(b, -1)
    if glob.shape[1] < capacity:   # tiny regions: pad up to the table
        glob = F.pad(glob, (0, capacity - glob.shape[1]), value=sent)
    skey = glob.sort(dim=1).values[:, :capacity]

    valid = skey < sent
    sel = torch.where(valid, skey, 0).long()
    out_codes = torch.gather(cflat, 1, sel[..., None].expand(b, capacity, 4))
    out_pos = torch.stack([sel % rw + x_lo, sel // rw + y_lo],
                          dim=-1).to(torch.int32)
    w1 = (wflat == 1).sum(dim=1, dtype=torch.int32)
    w2 = (wflat == 2).sum(dim=1, dtype=torch.int32)
    wcounts = torch.stack([torch.zeros_like(w1), w1, w2], dim=-1)
    chunk_ovf = (flags.sum(dim=-1) > SORT2_QUOTA).any(dim=-1)
    return (out_codes, out_pos, valid, wcounts,
            (w1 + w2 > capacity) | chunk_ovf)


def build_tables_sort2(weight: torch.Tensor, codes: torch.Tensor,
                       layout: GridLayout, capacity: int) -> RegionTables:
    """The "sort2" table build (torch ops on the tensors' device); regions
    stack on axis 1.  Invalid rows hold the region's first pixel's code
    and position, as the topk tables' do."""
    return _stack_regions(_region_table_sort2, weight, codes, layout,
                          capacity)


def check_table_mode(mode: str) -> None:
    """Raise ``ValueError`` for a table mode that is not one of
    :data:`TABLE_MODES`."""
    if mode not in TABLE_MODES:
        raise ValueError(f"unknown table_mode {mode!r}")


def build_tables(weight: torch.Tensor, codes: torch.Tensor,
                 layout: GridLayout, capacity: int,
                 mode: str = "topk") -> RegionTables:
    """weight [B, H, W] uint8, codes [B, H, W, 4] int32 -> RegionTables:
    for ``mode`` "sort2" :func:`build_tables_sort2`, for the others the
    CUDA kernel on CUDA tensors and the plain version on CPU tensors."""
    check_table_mode(mode)
    if mode == "sort2":
        return build_tables_sort2(weight, codes, layout, capacity)
    if uses_kernels(weight):
        return RegionTables(*ktab.build_tables_cuda(
            weight, codes, region_spans(layout), capacity))
    return build_tables_plain(weight, codes, layout, capacity)
