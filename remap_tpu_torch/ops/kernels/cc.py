"""Connected-component labels and stats (port of remap_tpu/ops/pallas/cc.py:
``label_components_batch``, ``label_components_banded`` and
``label_stats_batch``).

``label_components_batch`` and ``label_stats_batch`` run the CUDA kernel
``csrc/cc.cu`` on CUDA tensors and the plain versions
(``remap_tpu_torch.ops.cc``) on CPU tensors.  The kernel has no frame-size
ceiling, so the banded TPU entry point needs no counterpart of its own.
"""

from __future__ import annotations

import torch

from remap_tpu_torch.device import uses_kernels
from remap_tpu_torch.ops import _build
from remap_tpu_torch.ops import cc as plain
from remap_tpu_torch.ops.kernels import check_input, stream_handle


def _check_frames(images: torch.Tensor) -> None:
    check_input(images, "images", torch.uint8, (None, None, None))
    _, h, w = images.shape
    if h * w >= 1 << 31:
        raise ValueError(f"frames of {h}x{w} pixels overflow int32 indices")


def label_components_cuda(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 CUDA images -> [B, H, W] int32 labels (K4a)."""
    _check_frames(images)
    b, h, w = images.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=images.device)
    rc = _build.library().remap_cc_labels(
        images.data_ptr(), b, h, w, labels.data_ptr(),
        stream_handle(images.device))
    _build.check(rc, "cc labels")
    label_components_cuda.launches += 1
    return labels


label_components_cuda.launches = 0


def label_stats_cuda(images: torch.Tensor, changed: torch.Tensor):
    """[B, H, W] uint8 CUDA images and changed flags -> (labels
    [B, H, W] int32, stats [B, 5, H, W] int32): K4a's labels, then the
    stats pass over them (K4c)."""
    _check_frames(images)
    b, h, w = images.shape
    check_input(changed, "changed", torch.uint8, (b, h, w))
    labels = label_components_cuda(images)
    dev = images.device
    slots = torch.empty((5, b * h * w), dtype=torch.int32, device=dev)
    stats = torch.empty((b, 5, h, w), dtype=torch.int32, device=dev)
    rc = _build.library().remap_cc_stats(
        labels.data_ptr(), changed.data_ptr(), b, h, w, slots.data_ptr(),
        stats.data_ptr(), stream_handle(dev))
    _build.check(rc, "cc stats")
    label_stats_cuda.launches += 1
    return labels, stats


label_stats_cuda.launches = 0


def label_components_batch(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W] images -> [B, H, W] int32 labels: each interior pixel
    gets the flat index of its component's row-major-first pixel, border
    pixels ``H*W``.  The CUDA kernel on CUDA tensors (uint8 only), the
    plain version on CPU tensors."""
    if uses_kernels(images):
        return label_components_cuda(images)
    return plain.label_components(images)


def label_stats_batch(images: torch.Tensor, changed: torch.Tensor):
    """[B, H, W] images + [B, H, W] changed -> (labels, stats [B, 5, H, W]
    int32 = per-pixel component (minx, miny, maxx, maxy, has_changed),
    ``plain.border_stats`` on the border).  The CUDA kernel on CUDA
    tensors (uint8 only), the plain version on CPU tensors."""
    if uses_kernels(images):
        return label_stats_cuda(images, changed)
    return plain.label_stats(images, changed)
