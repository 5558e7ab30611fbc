"""Palette tables: native 4-bit codes <-> RGB <-> luminance-ordered values
(the port's copy of remap_tpu/core/palette.py; tests/test_torch_core.py
holds the tables equal to it, by default and after ``set_palette``).

The pipeline operates on "native" 4-bit palette indices.  Median filtering
needs a *total order by luminance*, so native codes are remapped to
"ordered values" (rank by intensity) before histogramming, and back after
(cpl.hpp:163-226).  RGB output uses the hardcoded 16-entry C64 palette
(cpl.hpp:77-92).

**Channel-swap quirk**: the reference's ordering intensity is ``0.3*B +
0.59*G + 0.11*R`` — luma-like coefficients applied to *swapped* channels
(``blend_to_pack`` returns the blend word's bytes positionally as (blue,
green, red), cpl.hpp:99-114, and ``pack_to_intensity`` binds them to
parameters named (red, green, blue), cpl.hpp:116-120).  The rank table
below reproduces the compiled binary's exactly.

The tables are module attributes: the port reads them at every call (K1's
wrapper packs them into its launch arguments), so :func:`set_palette`
takes effect on the next call.  The port keeps its own active palette:
setting one in ``remap_tpu.core.palette`` does not change it.
"""

from __future__ import annotations

import numpy as np

#: 0x00RRGGBB words, C64 palette (cpl.hpp:77-92).
NATIVE_TO_BLEND = np.array(
    [
        0x00000000, 0x00FFFFFF, 0x0068372B, 0x0070A4B2,
        0x006F3D86, 0x00588D43, 0x00352879, 0x00B8C76F,
        0x006F4F25, 0x00433900, 0x009A6759, 0x00444444,
        0x006C6C6C, 0x009AD284, 0x006C5EB5, 0x00959595,
    ],
    dtype=np.uint32,
)


def _intensity(rgb: np.ndarray) -> np.ndarray:
    """The reference's ordering intensity in [0,1], float32: ``0.3*B +
    0.59*G + 0.11*R`` over *channel-swapped* bytes (module docstring)."""
    r = rgb[:, 0].astype(np.float32)
    g = rgb[:, 1].astype(np.float32)
    b = rgb[:, 2].astype(np.float32)
    return (
        np.float32(0.3) * b + np.float32(0.59) * g + np.float32(0.11) * r
    ) / np.float32(255.0)


def _derive(blend: np.ndarray):
    """All tables from 16 blend words: ([16,3] RGB, intensity,
    ordered->native, native->ordered).

    ordered->native is the ascending-intensity permutation
    (cpl.hpp:164-182); a STABLE sort ranks intensity ties by native code
    order.  native->ordered is the inverse permutation
    (cpl.hpp:187-205)."""
    rgb = np.stack(
        [
            (blend >> 16).astype(np.uint8),
            (blend >> 8).astype(np.uint8),
            blend.astype(np.uint8),
        ],
        axis=1,
    )
    intensity = _intensity(rgb)
    ordered_to_native = np.argsort(intensity, kind="stable").astype(np.uint8)
    native_to_ordered_t = np.empty(16, dtype=np.uint8)
    native_to_ordered_t[ordered_to_native] = np.arange(16, dtype=np.uint8)
    return rgb, intensity, ordered_to_native, native_to_ordered_t


#: [16, 3] uint8 (R, G, B); per-code intensity; the two rank permutations.
(NATIVE_TO_RGB, NATIVE_INTENSITY,
 ORDERED_TO_NATIVE, NATIVE_TO_ORDERED) = _derive(NATIVE_TO_BLEND)

#: Built-in presets: name -> 16 x 0x00RRGGBB.
PRESETS = {
    "c64": NATIVE_TO_BLEND.copy(),
    # ZX Spectrum: 8 basic + 8 bright (colors 8/0 both black, an
    # intensity TIE, resolved by native-code order)
    "zx": np.array(
        [
            0x00000000, 0x000000D7, 0x00D70000, 0x00D700D7,
            0x0000D700, 0x0000D7D7, 0x00D7D700, 0x00D7D7D7,
            0x00000000, 0x000000FF, 0x00FF0000, 0x00FF00FF,
            0x0000FF00, 0x0000FFFF, 0x00FFFF00, 0x00FFFFFF,
        ],
        dtype=np.uint32,
    ),
    # the canonical CGA/EGA 16-color text palette
    "ega": np.array(
        [
            0x00000000, 0x000000AA, 0x0000AA00, 0x0000AAAA,
            0x00AA0000, 0x00AA00AA, 0x00AA5500, 0x00AAAAAA,
            0x00555555, 0x005555FF, 0x0055FF55, 0x0055FFFF,
            0x00FF5555, 0x00FF55FF, 0x00FFFF55, 0x00FFFFFF,
        ],
        dtype=np.uint32,
    ),
}


def set_palette(blend) -> None:
    """Install a 16-entry palette as the port's active one.

    ``blend``: a preset name (``'c64'``/``'zx'``/``'ega'``), an array of
    16 ``0x00RRGGBB`` words, or a [16, 3] uint8 RGB array.  Affects the
    luminance-order tables (and with them medians and keypoints)."""
    global NATIVE_TO_BLEND, NATIVE_TO_RGB, NATIVE_INTENSITY
    global ORDERED_TO_NATIVE, NATIVE_TO_ORDERED
    if isinstance(blend, str):
        try:
            blend = PRESETS[blend]
        except KeyError:
            raise ValueError(
                f"unknown palette preset {blend!r}; "
                f"have {sorted(PRESETS)}"
            ) from None
    blend = np.asarray(blend)
    if blend.shape == (16, 3):
        blend = (
            (blend[:, 0].astype(np.uint32) << 16)
            | (blend[:, 1].astype(np.uint32) << 8)
            | blend[:, 2].astype(np.uint32)
        )
    if blend.shape != (16,):
        raise ValueError(
            f"palette must be 16 blend words or [16, 3] RGB, "
            f"got shape {blend.shape}"
        )
    blend = blend.astype(np.uint32)
    NATIVE_TO_BLEND = blend
    (NATIVE_TO_RGB, NATIVE_INTENSITY,
     ORDERED_TO_NATIVE, NATIVE_TO_ORDERED) = _derive(blend)


def load_palette_file(path: str) -> np.ndarray:
    """Read a palette file: 16 ``RRGGBB`` hex colors (optionally
    ``#``-prefixed), one per line; ``;`` or ``//`` comments allowed."""
    words = []
    with open(path) as f:
        for line in f:
            line = line.split(";")[0].split("//")[0].strip()
            if not line:
                continue
            words.append(int(line.lstrip("#"), 16) & 0x00FFFFFF)
    if len(words) != 16:
        raise ValueError(f"{path}: expected 16 colors, got {len(words)}")
    return np.array(words, dtype=np.uint32)


def native_to_ordered(image: np.ndarray) -> np.ndarray:
    """Remap native codes to luminance ranks (cpl.hpp:211-213)."""
    return NATIVE_TO_ORDERED[image]


def ordered_to_native(image: np.ndarray) -> np.ndarray:
    """Remap luminance ranks back to native codes (cpl.hpp:215-217)."""
    return ORDERED_TO_NATIVE[image]


def native_to_rgb(image: np.ndarray) -> np.ndarray:
    """[H, W] native codes -> [H, W, 3] uint8 RGB (main.cpp:255-259)."""
    return NATIVE_TO_RGB[image]
