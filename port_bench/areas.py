"""The ``areas`` session recipe: a player who walks through doors between
several scrolling areas and comes back to each, as in room-and-corridor
games.

- Each of ``areas`` worlds is drawn like ``traffic.make_world``, the
  session's ``world_margin`` larger than the screen each way.  The areas
  lie side by side in one coordinate frame, a screen's width apart, so
  no two overlap.
- ``visits`` visits of ``visit_frames`` frames each take the areas in
  turn (0, 1, ..., areas - 1, 0, 1, ...).  A visit enters at its area's
  door, the same spot on every visit: the area's centre, where
  ``traffic.make_camera_path`` starts its walk.  From there it walks up
  to ``max_step`` pixels a frame, drawn from ``(path_seed, visit)``.
- A door is an instant cut: a visit's first frame follows the last frame
  of the visit before, with no blank or fade frame.
- Sprites, the HUD and the border are drawn as ``traffic.render`` draws
  them, over the whole session.  No frame is noise.

As in ``traffic``, the walk does not depend on the run's seed, which
draws the worlds, the sprites and the HUD.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from port_bench import traffic


@dataclasses.dataclass
class Session(traffic.Session):
    area: np.ndarray                    # [N] int: the area of each frame
    starts: List[int]                   # each visit's first frame


def render(areas: int, visits: int, visit_frames: int, h: int, w: int,
           seed: int, path_seed: int, margin: int, max_step: int,
           sprites: int, sprite_size: int, hud_rows: int,
           border: int) -> Session:
    """The session; ``path`` is the camera's (x, y) in the frame the
    areas share."""
    rng = np.random.default_rng(seed)
    worlds = [traffic.make_world(h + margin, w + margin, rng)
              for _ in range(areas)]
    wh, ww = worlds[0].shape
    pitch = ww + w
    path, area, starts = [], [], []
    for v in range(visits):
        a = v % areas
        starts.append(len(path))
        walk = traffic.make_camera_path(
            visit_frames, (wh, ww), (h, w),
            np.random.default_rng([path_seed, v]), max_step)
        path += [(a * pitch + x, y) for x, y in walk]
        area += [a] * visit_frames
    state = []
    for _ in range(sprites):
        color = int(rng.integers(0, 16))
        sx = int(rng.integers(0, w - sprite_size))
        sy = int(rng.integers(hud_rows + border, h - border - sprite_size))
        state.append([sx, sy, color])
    hud = rng.integers(0, 16, size=(hud_rows, w), dtype=np.uint8)
    frames = np.empty((len(path), h, w), np.uint8)
    for i, ((x, y), a) in enumerate(zip(path, area)):
        frame = frames[i]
        x -= a * pitch
        frame[:] = worlds[a][y:y + h, x:x + w]
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
    return Session(frames=frames, path=path, noise_at=None,
                   area=np.asarray(area), starts=starts)


def make(config: dict, seed: int) -> Session:
    """The session of a configuration whose ``session`` block has the
    ``areas`` recipe."""
    s = config["session"]
    p = config["pipeline"]
    if s["recipe"] != "areas":
        raise ValueError(f"not an areas session: {s['recipe']!r}")
    if s["frames"] != s["visits"] * s["visit_frames"]:
        raise ValueError("frames must be visits x visit_frames")
    return render(s["areas"], s["visits"], s["visit_frames"],
                  p["screen_height"], p["screen_width"], seed,
                  s["path_seed"], s["world_margin"], s["max_step"],
                  s["sprites"], s["sprite_size"], s["hud_rows"],
                  s["border"])
