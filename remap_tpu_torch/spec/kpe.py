"""Spec: keypoint + median extraction (kpe.hpp).

The port's copy of remap_tpu/spec/kpe.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

For every processed pixel (bounds below) over the luminance-*ordered* image:

- ``p3`` = "median" of the 3x3 neighbourhood, ``p5`` = of the 5x5, where the
  median of a histogram is the **largest ordered value v such that the count
  of pixels >= v reaches half** — half = 4 for 3x3 and 12 for 5x5
  (kpe.hpp:326-340: scan from bin 15 down, return first bin where the
  running total >= half; kpe.hpp:313/317 pass half = 4 and 12).
- The median image output is ``p3`` mapped back to native codes
  (kpe.hpp:312-314); unprocessed pixels stay 0.
- A pixel is a *keypoint* iff ``p1 != p3`` and ``p3 != p5`` where ``p1`` is
  the center's ordered value; its weight is 2 if additionally ``p1 != p5``,
  else 1 (kpe.hpp:308-324).
- A keypoint's descriptor *code* is the raw 5x5 patch of **native** codes
  (25 nibbles) plus the weight nibble (kpe.hpp:342-379 packs these into 13
  bytes; equality of codes == equality of (patch, weight), which is all that
  matters downstream, kpr.hpp:29-38/121-124).

Processed bounds (see core.regions module doc for the derivation):
``x in [kh, W-kh)``, ``y in [kh, H-kh-2)``.

Keypoints are routed into grid regions; a keypoint in an overlap band joins
every section containing it (kpe.hpp:149-306).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from remap_tpu_torch.core import palette
from remap_tpu_torch.core.regions import GridLayout

KERNEL = 5
KH = KERNEL // 2
HALF3 = 4   # kpe.hpp:313
HALF5 = 12  # kpe.hpp:317


def median_from_top(hist: np.ndarray, half: int) -> int:
    """Largest bin v with sum(hist[v:]) >= half, else 0 (kpe.hpp:326-340)."""
    total = 0
    for v in range(15, -1, -1):
        total += int(hist[v])
        if total >= half:
            return v
    return 0


def pack_code(patch: np.ndarray, weight: int) -> Tuple[int, int, int, int]:
    """Canonical packed code: 25 native nibbles + weight nibble -> 4 uint32.

    Nibble k of the row-major 5x5 patch goes to word k//8 at bit 4*(k%8);
    the weight nibble is nibble 25.  This differs from the reference's
    even/odd byte interleave (kpe.hpp:342-379) but preserves the only
    observable property: two codes are equal iff patch and weight are equal.
    """
    flat = patch.reshape(-1)
    words = [0, 0, 0, 0]
    for k in range(25):
        words[k // 8] |= int(flat[k]) << (4 * (k % 8))
    words[3] |= weight << 4
    return tuple(words)  # type: ignore[return-value]


@dataclasses.dataclass(eq=False)
class Keypoint:
    x: int
    y: int
    weight: int
    code: Tuple[int, int, int, int]


@dataclasses.dataclass(eq=False)
class RegionPoints:
    """One grid region's keypoint store (kpr.hpp:93-156)."""

    #: code -> list of (x, y) in insertion order.
    points: Dict[Tuple[int, int, int, int], List[Tuple[int, int]]]
    #: counts[w] = number of keypoints with weight w (w in {1, 2}).
    counts: List[int]

    @property
    def active(self) -> bool:
        return any(self.counts)

    @property
    def total(self) -> int:
        return sum(self.counts)


@dataclasses.dataclass(eq=False)
class ExtractResult:
    median: np.ndarray            # [H, W] uint8 native codes
    weight: np.ndarray            # [H, W] uint8 in {0, 1, 2}
    keypoints: List[Keypoint]     # row-major discovery order
    regions: List[RegionPoints]   # layout.region_count entries


def extract(image: np.ndarray, layout: GridLayout) -> ExtractResult:
    """Reference kpe::extractor::extract (kpe.hpp:92-108) in NumPy."""
    h, w = image.shape
    assert (w, h) == (layout.width, layout.height)

    ordered = palette.native_to_ordered(image)
    median = np.zeros((h, w), dtype=np.uint8)
    weight = np.zeros((h, w), dtype=np.uint8)

    # 16-bin histograms of the ordered image over 3x3 and 5x5 windows.
    onehot = (ordered[:, :, None] == np.arange(16, dtype=np.uint8)).astype(
        np.int32
    )

    def box(o: np.ndarray, k: int) -> np.ndarray:
        c = np.cumsum(np.cumsum(o, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
        return (
            c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
        )  # [H-k+1, W-k+1, 16]

    hist3 = box(onehot, 3)  # window top-left at (y, x) covers rows y..y+2
    hist5 = box(onehot, 5)

    x_lo, x_hi = layout.x_proc
    y_lo, y_hi = layout.y_proc

    keypoints: List[Keypoint] = []
    regions = [
        RegionPoints(points={}, counts=[0, 0, 0])
        for _ in range(layout.region_count)
    ]

    # cum-from-top counts: cnt_ge[v] = # of window pixels with value >= v.
    cge3 = np.cumsum(hist3[:, :, ::-1], axis=2)[:, :, ::-1]
    cge5 = np.cumsum(hist5[:, :, ::-1], axis=2)[:, :, ::-1]
    # median = largest v with cnt_ge[v] >= half (0 if none, kpe.hpp:326-340).
    vals = np.arange(16, dtype=np.int32)

    def med(cge: np.ndarray, half: int) -> np.ndarray:
        ok = cge >= half
        return np.where(ok.any(axis=2), (ok * vals).argmax(axis=2) + 0, 0)

    # hist3 centered at (y, x) lives at index (y-1, x-1); hist5 at (y-2, x-2)
    p3_all = med(cge3, HALF3)
    p5_all = med(cge5, HALF5)

    for y in range(y_lo, y_hi):
        for x in range(x_lo, x_hi):
            p1 = int(ordered[y, x])
            p3 = int(p3_all[y - 1, x - 1])
            median[y, x] = palette.ORDERED_TO_NATIVE[p3]
            if p1 != p3:
                p5 = int(p5_all[y - 2, x - 2])
                if p3 != p5:
                    wgt = 2 if p1 != p5 else 1
                    weight[y, x] = wgt
                    patch = image[y - KH : y + KH + 1, x - KH : x + KH + 1]
                    code = pack_code(patch, wgt)
                    kp = Keypoint(x=x, y=y, weight=wgt, code=code)
                    keypoints.append(kp)
                    for xs in layout.sections_of_x(x):
                        for ys in layout.sections_of_y(y):
                            reg = regions[layout.region_index(xs, ys)]
                            reg.points.setdefault(code, []).append((x, y))
                            reg.counts[wgt] += 1

    return ExtractResult(
        median=median, weight=weight, keypoints=keypoints, regions=regions
    )
