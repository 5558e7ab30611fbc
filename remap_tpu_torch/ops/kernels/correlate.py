"""Wrapper of the fine-level count kernel ``csrc/fine.cu``: the pyramid
matcher's shifted agreement counts with the coarse roll folded into the
reads of ``curr``.  It replaces no TPU kernel (the JAX package's fine
pass is ``jnp.roll`` and slices); its plain version is
``remap_tpu_torch.ops.correlate.fine_counts`` on CPU tensors."""

from __future__ import annotations

import torch

from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops.kernels import check_input, stream_handle


def fine_counts_cuda(prev: torch.Tensor, curr: torch.Tensor,
                     base: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, H, W] uint8 CUDA frame pairs and their coarse offsets ``base``
    [B, 2] int32 (dx, dy) -> [B, 2R+1, 2R+1] int32 counts:
    ``[b, dy+R, dx+R]`` counts the pixels (y, x) with (y+dy, x+dx) inside
    the frame where ``prev[b, y+dy, x+dx] == curr[b, (y-by) mod H,
    (x-bx) mod W]``."""
    check_input(prev, "prev", torch.uint8, (None, None, None))
    b, h, w = prev.shape
    check_input(curr, "curr", torch.uint8, (b, h, w))
    check_input(base, "base", torch.int32, (b, 2))
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    n = 2 * radius + 1
    counts = torch.empty((b, n, n), dtype=torch.int32, device=prev.device)
    if b == 0:
        return counts
    rc = _build.library().remap_fine_counts(
        prev.data_ptr(), curr.data_ptr(), base.data_ptr(), b, h, w, radius,
        counts.data_ptr(), stream_handle(prev.device))
    _build.check(rc, "fine counts")
    fine_counts_cuda.launches += 1
    return counts


fine_counts_cuda.launches = 0
