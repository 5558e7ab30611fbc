"""The palette's luminance ranks, frozen: the order in which the
reference's medians and keypoints compare colours.

Copied from ``core/palette.py`` of the port, with the imports cut, so
that the benchmark's yardstick does not move when the program does.  It
imports nothing of the program.  The C++ lines cited are the reference's
(kataklinger/remap).
"""

from __future__ import annotations

import numpy as np

#: 0x00RRGGBB words, C64 palette (cpl.hpp:77-92)
NATIVE_TO_BLEND = np.array(
    [0x00000000, 0x00FFFFFF, 0x0068372B, 0x0070A4B2,
     0x006F3D86, 0x00588D43, 0x00352879, 0x00B8C76F,
     0x006F4F25, 0x00433900, 0x009A6759, 0x00444444,
     0x006C6C6C, 0x009AD284, 0x006C5EB5, 0x00959595], dtype=np.uint32)


def _ranks(blend: np.ndarray):
    """(ordered->native, native->ordered): the ascending-intensity
    permutation over channel-swapped bytes, ties by native code
    (cpl.hpp:164-205)."""
    r = (blend >> 16).astype(np.uint8).astype(np.float32)
    g = (blend >> 8).astype(np.uint8).astype(np.float32)
    b = blend.astype(np.uint8).astype(np.float32)
    intensity = (np.float32(0.3) * b + np.float32(0.59) * g
                 + np.float32(0.11) * r) / np.float32(255.0)
    o2n = np.argsort(intensity, kind="stable").astype(np.uint8)
    n2o = np.empty(16, np.uint8)
    n2o[o2n] = np.arange(16, dtype=np.uint8)
    return o2n, n2o


ORDERED_TO_NATIVE, NATIVE_TO_ORDERED = _ranks(NATIVE_TO_BLEND)
