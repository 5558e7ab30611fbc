"""Wrapper of the region-table kernel ``csrc/tables.cu`` (replaces the
Pallas kernel remap_tpu/ops/pallas/tables.py::build_tables_pallas).  Its
plain version is ``remap_tpu_torch.ops.tables.build_tables_plain``.

Two routes, one result: a block per (frame, region) where those fill the
card, and the chunked route (a block per ``CHUNK`` pixels of a region, a
count launch then a scatter launch) where they do not, as for splice's
single whole-canvas region and a pair repair's few frames.  On an H100
the chunked route is 1.07-1.29x slower on full batches (NES, 256 frames;
C64, 128) and 2.5x faster on 2 frames, 106x on splice's one region
(chip_smoke.py).  ``launches`` counts calls: a chunked call launches two
kernels."""

from __future__ import annotations

import ctypes

import torch

from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops.kernels import check_input, stream_handle

#: regions a layout may have (the kernel takes the spans by value)
MAX_REGIONS = 64
#: pixels of a region each block of the chunked route takes
CHUNK = 4096
#: (frames x regions) below which the chunked route runs: fewer blocks
#: than the H100 SXM's 132 SMs leave the one-block route's card idle
CHUNKED_BELOW = 132


def build_tables_cuda(weight: torch.Tensor, codes: torch.Tensor,
                      spans: list[tuple[int, int, int, int]], capacity: int):
    """weight [B, H, W] uint8, codes [B, H, W, 4] int32 (CUDA), region
    spans (x_lo, x_hi, y_lo, y_hi) -> (codes [B, R, K, 4] int32,
    pos [B, R, K, 2] int32, valid [B, R, K] bool, wcounts [B, R, 3] int32,
    overflow [B, R] bool).  The chunked route runs when
    B * R < ``CHUNKED_BELOW``."""
    b, h, w = weight.shape
    r, k = len(spans), capacity
    check_input(weight, "weight", torch.uint8, (None, None, None))
    check_input(codes, "codes", torch.int32, (b, h, w, 4))
    if codes.device != weight.device:
        raise ValueError("weight and codes must share a device")
    if not 0 < r <= MAX_REGIONS or k <= 0:
        raise ValueError(f"need 1..{MAX_REGIONS} regions and capacity > 0")
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
    flat_spans = (ctypes.c_int32 * (4 * r))(*(v for s in spans for v in s))
    outs = (out_codes.data_ptr(), out_pos.data_ptr(), valid.data_ptr(),
            wcounts.data_ptr(), overflow.data_ptr(), stream_handle(dev))
    if b * r < CHUNKED_BELOW:
        most = max((x_hi - x_lo) * (y_hi - y_lo)
                   for x_lo, x_hi, y_lo, y_hi in spans)
        n_chunks = -(-most // CHUNK)
        counts = torch.empty((b, r, n_chunks, 2), dtype=torch.int32,
                             device=dev)
        rc = _build.library().remap_tables_chunked(
            weight.data_ptr(), codes.data_ptr(), b, h, w,
            ctypes.addressof(flat_spans), r, k, CHUNK, n_chunks,
            counts.data_ptr(), *outs)
    else:
        rc = _build.library().remap_tables(
            weight.data_ptr(), codes.data_ptr(), b, h, w,
            ctypes.addressof(flat_spans), r, k, *outs)
    _build.check(rc, "tables")
    build_tables_cuda.launches += 1
    return out_codes, out_pos, valid, wcounts, overflow


build_tables_cuda.launches = 0
