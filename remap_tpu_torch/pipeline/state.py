"""Pipeline state containers on the device (port of the device parts of
remap_tpu/pipeline/state.py).

The host side is the JAX package's, which imports only numpy:
``FrameRef``, ``pack_nibbles[_batch]``, ``unpack_nibbles`` and
``simulate_growth`` are used as they are, and :class:`FrameStore`
subclasses the JAX store, keeping its host rows and its mirror rules
(budget, contiguity from frame 0, invalidation) and replacing only the
methods that touch the device.  :class:`Fragment` holds its canvas in the
port's device layout (``ops.atlas``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from remap_tpu.pipeline import state as host_state
from remap_tpu.pipeline.state import (  # noqa: F401 (re-exported)
    FrameRef, pack_nibbles, pack_nibbles_batch, simulate_growth,
    unpack_nibbles,
)
from remap_tpu_torch.device import get_device
from remap_tpu_torch.ops import atlas as atlas_ops


def unpack_nibbles_device(packed: torch.Tensor, width: int) -> torch.Tensor:
    """``[..., Wp]`` uint8 packed 2 px/byte -> ``[..., width]`` uint8."""
    out = torch.stack([packed >> 4, packed & 0x0F], dim=-1)
    return out.reshape(*packed.shape[:-1], -1)[..., :width].contiguous()


def pack_nibbles_device(imgs: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` uint8 (values < 16) -> ``[..., ceil(W/2)]`` uint8, as
    ``pack_nibbles_batch``."""
    if imgs.shape[-1] % 2:
        imgs = F.pad(imgs, (0, 1))
    return (imgs[..., 0::2] << 4) | imgs[..., 1::2]


class FrameStore(host_state.FrameStore):
    """The JAX ``FrameStore`` with torch device mirrors on ``device``.

    Donated rows (``put_packed_batch(..., device_packed=...)``) are torch
    tensors on the store's device; gathers and uploads land there too."""

    def __init__(self, height: int, width: int, device_budget=None,
                 device=None):
        super().__init__(height, width, device_budget)
        self.device = get_device(device)

    def _gather(self, parts, stack, numbers):
        if stack is None:
            stack = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        index = torch.as_tensor(np.asarray(numbers, np.int64),
                                device=stack.device)
        return stack, stack[index]

    def _device_rows(self, numbers, parts_name, stack_name, count_name,
                     host_rows):
        parts = getattr(self, parts_name)
        count = getattr(self, count_name)
        if parts and all(0 <= n < count for n in numbers):
            stack, rows = self._gather(parts, getattr(self, stack_name),
                                       numbers)
            setattr(self, stack_name, stack)
            setattr(self, parts_name, [stack])
            return rows
        return torch.as_tensor(host_rows(numbers), device=self.device)

    def device_packed_batch(self, numbers: List[int]) -> torch.Tensor:
        """``[B, H, ceil(W/2)]`` uint8 on the store's device for
        ``numbers``: gathered from the mirror when it holds them all,
        uploaded from the host rows otherwise."""
        return self._device_rows(numbers, "_dev_parts", "_dev_stack",
                                 "_dev_count", self.packed_images_batch)

    def device_packed_medians_batch(self, numbers: List[int]) -> torch.Tensor:
        """Packed medians for ``numbers``, as :meth:`device_packed_batch`."""
        return self._device_rows(numbers, "_dev_parts_m", "_dev_stack_m",
                                 "_dev_count_m", self.packed_medians_batch)


class Fragment:
    """A stitched fragment: vote canvas + frame records (see the JAX
    ``Fragment``).

    ``dots_dev`` is the padded channels-major device canvas
    (``ops.atlas``) and ``shape`` the logical ``(h, w)``; ``.dots``
    materialises the JAX layout ``[h, w, 16]`` uint16 on the host, once.
    Assigning ``.dots`` drops the device canvas (the host copy is
    authoritative, as in the JAX class)."""

    def __init__(
        self,
        dots: Optional[np.ndarray] = None,       # [h, w, 16] uint16
        zero: Tuple[int, int] = (0, 0),
        frames: Optional[List[FrameRef]] = None,
        store: Optional[FrameStore] = None,
        dots_dev: Optional[torch.Tensor] = None,  # [16, AH', AW'] int32
        shape: Optional[Tuple[int, int]] = None,  # logical (h, w) of dots_dev
    ):
        if dots is not None:
            shape = dots.shape[:2]
        elif dots_dev is None or shape is None:
            raise ValueError("a Fragment needs dots, or dots_dev and shape")
        self._dots = dots
        self._shape = (int(shape[0]), int(shape[1]))
        self.dots_dev = dots_dev
        self.zero = zero
        self.frames = frames if frames is not None else []
        self.store = store

    @property
    def dots(self) -> np.ndarray:
        if self._dots is None:
            self._dots = atlas_ops.to_host(self.dots_dev, *self._shape)
        return self._dots

    @dots.setter
    def dots(self, value: np.ndarray) -> None:
        self._dots = value
        self._shape = value.shape[:2]
        self.dots_dev = None

    def device_dots(self, device=None) -> torch.Tensor:
        """The padded device canvas (uploaded from the host copy, and
        kept, when there is none)."""
        if self.dots_dev is None:
            self.dots_dev = atlas_ops.from_host(self._dots, get_device(device))
        return self.dots_dev

    def drop_device(self) -> None:
        """Release the device canvas (materialises the host copy first)."""
        if self.dots_dev is not None:
            _ = self.dots
            self.dots_dev = None

    def normalize(self) -> None:
        zx, zy = self.zero
        for f in self.frames:
            f.position = (f.position[0] - zx, f.position[1] - zy)
        self.zero = (0, 0)

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape
