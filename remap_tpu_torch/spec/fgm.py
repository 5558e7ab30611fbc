"""Spec: fragment atlas (fgm.hpp).

The port's copy of remap_tpu/spec/fgm.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

A fragment is a growing canvas of per-pixel 16-bin color-vote histograms
("dots", uint16 with wrap-around, fgm.hpp:12-15), an origin ``zero`` mapping
blit positions to canvas indices, and the list of blitted frame records.

Canvas growth happens in multiples of ``step`` (the frame dimensions for
collector fragments, frc.hpp:124-126; fgm.hpp:190-233).  Growth granularity
is observable: the blended image's size feeds the splicer's keypoint
extraction, whose processed bounds depend on H/W — so the spec replicates
the exact growth arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from remap_tpu_torch.core.geometry import Rect

DEPTH = 16  # fgm.hpp:12


@dataclasses.dataclass(eq=False)
class FrameRecord:
    number: int
    position: Tuple[int, int]           # (x, y)
    image: Optional[np.ndarray] = None  # stored frame (native codes)
    median: Optional[np.ndarray] = None


@dataclasses.dataclass(eq=False)
class Fragment:
    dots: np.ndarray                    # [H, W, 16] uint16
    zero: Tuple[int, int]               # canvas origin in position space
    step: Tuple[int, int]               # (w, h) growth granularity
    frames: List[FrameRecord]

    @classmethod
    def create(cls, width: int, height: int) -> "Fragment":
        """frc-style fragment: initial canvas = step = frame dims
        (fgm.hpp:49-52)."""
        return cls(
            dots=np.zeros((height, width, DEPTH), dtype=np.uint16),
            zero=(0, 0),
            step=(width, height),
            frames=[],
        )

    @classmethod
    def create_fixed(
        cls, width: int, height: int, zero: Tuple[int, int]
    ) -> "Fragment":
        """fdf-style fragment: fixed dims, step 1 (fgm.hpp:64-69)."""
        return cls(
            dots=np.zeros((height, width, DEPTH), dtype=np.uint16),
            zero=zero,
            step=(1, 1),
            frames=[],
        )

    # -- growth (fgm.hpp:190-233) ---------------------------------------
    def _ensure(self, pos: Tuple[int, int], w: int, h: int) -> None:
        def round_step(change: int, step: int) -> int:
            rest = change % step
            return change - rest + (step if rest else 0)

        zx, zy = self.zero
        hcur, wcur = self.dots.shape[:2]
        grow_l = grow_t = grow_r = grow_b = 0
        if pos[0] < zx:
            grow_l = round_step(zx - pos[0], self.step[0])
        if pos[0] + w > zx + wcur:
            grow_r = round_step(pos[0] + w - (zx + wcur), self.step[0])
        if pos[1] < zy:
            grow_t = round_step(zy - pos[1], self.step[1])
        if pos[1] + h > zy + hcur:
            grow_b = round_step(pos[1] + h - (zy + hcur), self.step[1])
        if grow_l or grow_t or grow_r or grow_b:
            self.dots = np.pad(
                self.dots, ((grow_t, grow_b), (grow_l, grow_r), (0, 0))
            )
        self.zero = (zx - grow_l, zy - grow_t)

    # -- blits (fgm.hpp:71-113) -----------------------------------------
    def blit_frame(
        self,
        pos: Tuple[int, int],
        image: np.ndarray,
        number: int,
        mask: Optional[np.ndarray] = None,
        store: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        """Vote each pixel's color; with ``mask`` given, only where mask==0
        (fgm.hpp:71-97).  ``store`` attaches (image, median) to the record."""
        h, w = image.shape
        self._ensure(pos, w, h)
        ax, ay = pos[0] - self.zero[0], pos[1] - self.zero[1]
        view = self.dots[ay : ay + h, ax : ax + w]
        onehot = (
            image[:, :, None] == np.arange(DEPTH, dtype=image.dtype)
        ).astype(np.uint16)
        if mask is not None:
            onehot = onehot * (mask[:, :, None] == 0)
        np.add(view, onehot, out=view)  # uint16 wrap like the C++ ++
        rec = FrameRecord(number=number, position=pos)
        if store is not None:
            rec.image, rec.median = store
        self.frames.append(rec)

    def blit_fragment(self, pos: Tuple[int, int], other: "Fragment") -> None:
        """Histogram-add another fragment at ``pos`` (fgm.hpp:99-113)."""
        h, w = other.dots.shape[:2]
        self._ensure(pos, w, h)
        ax, ay = pos[0] - self.zero[0], pos[1] - self.zero[1]
        view = self.dots[ay : ay + h, ax : ax + w]
        np.add(view, other.dots, out=view)
        for f in other.frames:
            self.frames.append(
                FrameRecord(
                    number=f.number,
                    position=(
                        f.position[0] - other.zero[0] + pos[0],
                        f.position[1] - other.zero[1] + pos[1],
                    ),
                    image=f.image,
                    median=f.median,
                )
            )

    # -- observers (fgm.hpp:115-153) ------------------------------------
    def blend(self) -> Tuple[np.ndarray, np.ndarray]:
        """(image, mask): per-pixel argmax color; mask = any votes
        (fgm.hpp:115-135; first-max wins like std::max_element)."""
        image = self.dots.argmax(axis=2).astype(np.uint8)
        mask = (self.dots.max(axis=2) > 0).astype(np.uint8)
        image = image * mask  # pixels with no votes stay color 0
        return image, mask

    def normalize(self) -> None:
        for f in self.frames:
            f.position = (
                f.position[0] - self.zero[0],
                f.position[1] - self.zero[1],
            )
        self.zero = (0, 0)

    def margins(self) -> Rect:
        """Empty-margin counts on each side (fgm.hpp:145-153, 235-295)."""
        h, w = self.dots.shape[:2]
        nonempty = self.dots.any(axis=2)
        if not nonempty.any():
            return Rect(left=w, top=h, right=w, bottom=h)
        cols = np.nonzero(nonempty.any(axis=0))[0]
        rows = np.nonzero(nonempty.any(axis=1))[0]
        return Rect(
            left=int(cols[0]),
            top=int(rows[0]),
            right=int(w - 1 - cols[-1]),
            bottom=int(h - 1 - rows[-1]),
        )

    def crop_margins(self, image: np.ndarray) -> np.ndarray:
        """mrl::matrix::crop with this fragment's margins
        (arf.hpp:320-327, mrl.hpp:113-129)."""
        m = self.margins()
        h, w = image.shape[:2]
        return image[m.top : h - m.bottom, m.left : w - m.right]
