"""The benchmark's one generator of frames: a session from a seed and a
traffic mix's parameters, with the camera path it was rendered along.

The world, the camera walk and the sprites follow the recipes of the
port's synthetic clips (``utils/clips.py``: ``make_world``,
``make_camera_path``, ``render_clip``, ``make_clip``), copied here so the
inputs do not move when the program does.  Two recipes:

- ``render``: a busy tiled world under a random walk of ``max_step``
  pixels a frame, moving solid sprites, a static HUD and border, and
  optionally one frame whose play area is noise (a scene cut).
- ``cyclic``: a tiled world with light noise under a palindromic walk,
  so that a clip played over and over never jumps.

The camera walk comes from the configuration's ``path_seed``, so every
run seed gives the same sizes (the same canvas, the same spans of the
stitch window); the seed draws the world, the sprites and the noise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Session:
    frames: np.ndarray                  # [N, H, W] uint8, values < 16
    path: List[Tuple[int, int]]         # camera (x, y) in the world
    noise_at: Optional[int]             # the frame that is noise, if any


def make_world(height: int, width: int, rng: np.random.Generator,
               tile: int = 4, colors: int = 16) -> np.ndarray:
    th, tw = height // tile + 1, width // tile + 1
    base = rng.integers(0, colors, size=(th, tw), dtype=np.uint8)
    base = np.kron(base, np.ones((tile, tile), dtype=np.uint8))[:height,
                                                                 :width]
    detail = rng.integers(0, colors, size=(height, width), dtype=np.uint8)
    mask = rng.random((height, width)) < 0.25
    return np.where(mask, detail, base).astype(np.uint8)


def make_camera_path(n: int, world_hw, frame_hw, rng: np.random.Generator,
                     max_step: int) -> List[Tuple[int, int]]:
    wh, ww = world_hw
    fh, fw = frame_hw
    x, y = (ww - fw) // 2, (wh - fh) // 2
    path = [(x, y)]
    for _ in range(n - 1):
        x = int(np.clip(x + rng.integers(-max_step, max_step + 1), 0,
                        ww - fw))
        y = int(np.clip(y + rng.integers(-max_step, max_step + 1), 0,
                        wh - fh))
        path.append((x, y))
    return path


def render(n: int, h: int, w: int, seed: int, path_seed: int, margin: int,
           max_step: int, sprites: int, sprite_size: int, hud_rows: int,
           border: int, noise_at: Optional[int]) -> Session:
    """A session rendered along a random camera walk over a world
    ``margin`` pixels larger than the screen each way."""
    rng = np.random.default_rng(seed)
    world = make_world(h + margin, w + margin, rng)
    path = make_camera_path(n, world.shape, (h, w),
                            np.random.default_rng(path_seed), max_step)
    state = []
    for _ in range(sprites):
        color = int(rng.integers(0, 16))
        sx = int(rng.integers(0, w - sprite_size))
        sy = int(rng.integers(hud_rows + border, h - border - sprite_size))
        state.append([sx, sy, color])
    hud = rng.integers(0, 16, size=(hud_rows, w), dtype=np.uint8)
    frames = np.empty((n, h, w), np.uint8)
    for i, (x, y) in enumerate(path):
        frame = frames[i]
        frame[:] = world[y:y + h, x:x + w]
        for s in state:
            sx, sy, color = s
            frame[sy:sy + sprite_size, sx:sx + sprite_size] = color
            s[0] = int(np.clip(sx + rng.integers(-2, 3), 0, w - sprite_size))
            s[1] = int(np.clip(sy + rng.integers(-2, 3), hud_rows + border,
                               h - border - sprite_size))
    if hud_rows:
        frames[:, :hud_rows] = hud
    if border:
        frames[:, :border] = 5
        frames[:, -border:] = 5
        frames[:, :, :border] = 5
        frames[:, :, -border:] = 5
    if noise_at is not None:
        frames[noise_at, hud_rows:h - border, border:w - border] = (
            rng.integers(0, 16, (h - hud_rows - border, w - 2 * border),
                         dtype=np.uint8))
    return Session(frames=frames, path=path, noise_at=noise_at)


def cyclic(n: int, h: int, w: int, seed: int, path_seed: int, margin: int,
           max_step: int) -> Session:
    """A clip of ``n`` (even) frames whose walk is a palindrome: frame
    n-1 is one ordinary step from frame 0."""
    rng = np.random.default_rng(seed)
    wh, ww = h + margin, w + margin
    tile = 8
    base = rng.integers(0, 16, size=(wh // tile + 1, ww // tile + 1),
                        dtype=np.uint8)
    base = np.kron(base, np.ones((tile, tile), np.uint8))[:wh, :ww]
    detail = rng.integers(0, 16, size=(wh, ww), dtype=np.uint8)
    world = np.where(rng.random((wh, ww)) < 0.10, detail, base).astype(
        np.uint8)
    if n % 2:
        raise ValueError("a cyclic clip needs an even number of frames")
    half = n // 2
    walk = np.random.default_rng(path_seed)
    xs, ys = [margin // 2], [margin // 2]
    for _ in range(half):
        step = walk.integers(-max_step, max_step + 1, size=2)
        xs.append(int(np.clip(xs[-1] + step[0], 0, ww - w)))
        ys.append(int(np.clip(ys[-1] + step[1], 0, wh - h)))
    xs = xs[:half + 1] + xs[half - 1:0:-1]
    ys = ys[:half + 1] + ys[half - 1:0:-1]
    frames = np.empty((n, h, w), np.uint8)
    for t in range(n):
        frames[t] = world[ys[t]:ys[t] + h, xs[t]:xs[t] + w]
    return Session(frames=frames, path=list(zip(xs, ys)), noise_at=None)


def make(config: dict, traffic: dict, seed: int) -> Session:
    """The session of a configuration's ``session`` block under a
    traffic mix (``recipe`` and its parameters)."""
    s = config["session"]
    h, w = config["pipeline"]["screen_height"], config["pipeline"][
        "screen_width"]
    if s["recipe"] == "render":
        return render(s["frames"], h, w, seed, s["path_seed"],
                      s["world_margin"], s["max_step"], s["sprites"],
                      s["sprite_size"],
                      s["hud_rows"], s["border"], traffic.get("noise_at"))
    if s["recipe"] == "cyclic":
        return cyclic(s["frames"], h, w, seed, s["path_seed"],
                      s["world_margin"], s["max_step"])
    raise ValueError(f"unknown session recipe {s['recipe']!r}")
