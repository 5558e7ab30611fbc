"""Wrapper of the region-table kernel ``csrc/tables.cu`` (replaces the
Pallas kernel remap_tpu/ops/pallas/tables.py::build_tables_pallas).  Its
plain version is ``remap_tpu_torch.ops.tables.build_tables_plain``.

One design for every shape: tiles of 16-byte-aligned words of a region's
rows (up to 4096 pixels) in each frame, in two launches: a block a tile
counts its keypoints, then a block a tile ranks, gathers and writes them
with its share of the table fill.  The tile is the kernel's constant; the
scratch of tile counts is sized by ``remap_tables_tiles``.  ``launches``
counts calls: a call launches two kernels."""

from __future__ import annotations

import ctypes

import torch

from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops.kernels import check_input, stream_handle

#: regions a layout may have (the kernel takes the spans by value)
MAX_REGIONS = 64


def build_tables_cuda(weight: torch.Tensor, codes: torch.Tensor,
                      spans: list[tuple[int, int, int, int]], capacity: int):
    """weight [B, H, W] uint8, codes [B, H, W, 4] int32 (CUDA), region
    spans (x_lo, x_hi, y_lo, y_hi) -> (codes [B, R, K, 4] int32,
    pos [B, R, K, 2] int32, valid [B, R, K] bool, wcounts [B, R, 3] int32,
    overflow [B, R] bool)."""
    b, h, w = weight.shape
    r, k = len(spans), capacity
    check_input(weight, "weight", torch.uint8, (None, None, None))
    check_input(codes, "codes", torch.int32, (b, h, w, 4))
    if codes.device != weight.device:
        raise ValueError("weight and codes must share a device")
    if not 0 < r <= MAX_REGIONS or k <= 0:
        raise ValueError(f"need 1..{MAX_REGIONS} regions and capacity > 0")
    if h > 0xFFFF or w > 0xFFFF:
        raise ValueError(f"a {w}x{h} frame: positions are packed in 16 bits")
    for x_lo, x_hi, y_lo, y_hi in spans:
        if not (0 <= x_lo < x_hi <= w and 0 <= y_lo < y_hi <= h):
            raise ValueError(f"region span {(x_lo, x_hi, y_lo, y_hi)} "
                             f"outside the {w}x{h} frame")
    dev = weight.device
    out_codes = torch.empty((b, r, k, 4), dtype=torch.int32, device=dev)
    out_pos = torch.empty((b, r, k, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((b, r, k), dtype=torch.bool, device=dev)
    wcounts = torch.empty((b, r, 3), dtype=torch.int32, device=dev)
    overflow = torch.empty((b, r), dtype=torch.bool, device=dev)
    if b == 0:
        return out_codes, out_pos, valid, wcounts, overflow
    lib = _build.library()
    flat_spans = (ctypes.c_int32 * (4 * r))(*(v for s in spans for v in s))
    n_tiles = lib.remap_tables_tiles(ctypes.addressof(flat_spans), r)
    counts = torch.empty((b, r, n_tiles, 4), dtype=torch.int32, device=dev)
    rc = lib.remap_tables(
        weight.data_ptr(), codes.data_ptr(), b, h, w,
        ctypes.addressof(flat_spans), r, k, counts.data_ptr(),
        out_codes.data_ptr(), out_pos.data_ptr(), valid.data_ptr(),
        wcounts.data_ptr(), overflow.data_ptr(), stream_handle(dev))
    _build.check(rc, "tables")
    build_tables_cuda.launches += 1
    return out_codes, out_pos, valid, wcounts, overflow


build_tables_cuda.launches = 0
