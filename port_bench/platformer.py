"""The ``platformer`` session recipe: a C64-style side-scroller played by a
seeded player, as an emulator dump records it.

A copy of the port's gameplay simulator's platformer
(``utils/gameplay.py`` ``play_session``: its tileset, level, sprites,
font, player inputs, physics and dead-zone camera), kept here so the
benchmark's inputs do not move when the program does.

- The world is built from 16-px tiles that repeat exactly: sky with a
  dither grain, stars, clouds, bricks, turf, dirt, rocks, blocks, pipes,
  bushes and fences, laid out along ``level_cols`` columns of rolling
  hills, pipes and floating platforms.
- The player walks, idles, backtracks and jumps under gravity; a
  dead-zone camera follows, at most 3 px a frame in x and 2 in y.
- 3 enemies patrol the ground with a 2-frame walk; the player has a
  2-frame walk too.
- A ``bar_rows``-row status bar below the play area shows the score
  (a new draw every 7 frames) and a timer that counts down every 2
  frames until frame 800; a ``border``-px chrome frames the play area.
  No frame is noise.

Unlike ``play_session``, two seeds draw it.  The level layout and the
player's inputs come from the configuration's ``path_seed``, so every
run seed gives the same camera path and the same canvas; the tileset's
pixels, the enemies' starting points and the score's draws come from
the run's seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from port_bench import traffic

TILE = 16
#: the last frame on which the timer still changes (it counts down from
#: 400 every 2 frames and stops at 0)
TIMER_FRAMES = 800


def _speckle(t: np.ndarray, rng: np.random.Generator, color: int) -> None:
    """One isolated speck a row at column (5 r + phase) mod 16: every row
    and column of the tile changes under any scroll, and no median moves,
    so the grain adds no keypoints."""
    phase = int(rng.integers(0, TILE))
    for r in range(TILE):
        t[r, (5 * r + phase) % TILE] = color


def _tile_sky(rng):
    t = np.full((TILE, TILE), 6, np.uint8)
    _speckle(t, rng, 14)
    return t


def _tile_sky_star(rng):
    t = _tile_sky(rng)
    ys, xs = rng.integers(1, TILE - 1, 4), rng.integers(1, TILE - 1, 4)
    t[ys, xs] = 1
    t[ys[0], (xs[0] + 1) % TILE] = 3
    return t


def _tile_cloud(rng):
    t = _tile_sky(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    blob = ((yy - 8) ** 2 / 9.0 + (xx - 8) ** 2 / 25.0) < 4.0
    t[blob] = 1
    t[blob & (yy > 9)] = 15
    return t


def _tile_brick(rng):
    t = np.full((TILE, TILE), 8, np.uint8)
    t[::4, :] = 9
    for r in range(4):
        t[r * 4:r * 4 + 4, (r % 2) * 4::8] = 9
    t[0, :] = 7
    weather = rng.random((TILE, TILE)) < 0.10
    weather[t != 8] = False
    t[weather] = 2
    return t


def _tile_ground(rng):
    t = np.full((TILE, TILE), 9, np.uint8)
    t[0:2, :] = 5
    speck = rng.random((4, TILE)) < 0.18
    speck[0:2] = False
    t[:4][speck] = 2
    return t


def _tile_dirt(rng):
    t = np.full((TILE, TILE), 9, np.uint8)
    _speckle(t, rng, 2)
    return t


def _tile_rock(rng):
    t = np.full((TILE, TILE), 9, np.uint8)
    y, x = int(rng.integers(3, TILE - 6)), int(rng.integers(3, TILE - 6))
    t[y:y + 3, x:x + 4] = 15
    t[y, x] = 1
    return t


def _tile_block(rng):
    t = np.full((TILE, TILE), 7, np.uint8)
    t[[0, -1], :] = 9
    t[:, [0, -1]] = 9
    t[4:12, 4:12] = 8
    t[7:9, 7:9] = 1
    return t


def _tile_pipe(rng):
    t = np.full((TILE, TILE), 5, np.uint8)
    t[:, [0, 1, -2, -1]] = 13
    t[:, [4, 11]] = 3
    t[rng.integers(2, TILE - 2, 3), rng.integers(5, 11, 3)] = 13
    return t


def _tile_bush(rng):
    t = _tile_sky(rng)
    yy, xx = np.mgrid[0:TILE, 0:TILE]
    blob = ((yy - 12) ** 2 / 16.0 + (xx - 8) ** 2 / 30.0) < 3.0
    t[blob] = 5
    t[blob & ((xx + yy) % 5 == 0)] = 13
    return t


def _tile_fence(rng):
    t = _tile_sky(rng)
    t[6:, 2::5] = 9
    t[8, :] = 9
    t[12, :] = 9
    return t


def make_tileset(rng: np.random.Generator) -> np.ndarray:
    """``[12, 16, 16]`` uint8; tile 0 is the sky."""
    makers = [_tile_sky, _tile_sky_star, _tile_cloud, _tile_brick,
              _tile_ground, _tile_block, _tile_pipe, _tile_bush,
              _tile_fence, _tile_dirt, _tile_rock, _tile_rock]
    return np.stack([m(rng) for m in makers])


(SKY, SKY_STAR, CLOUD, BRICK, GROUND, BLOCK, PIPE, BUSH, FENCE, DIRT,
 ROCK_A, ROCK_B) = range(12)
SOLID = (BRICK, GROUND, BLOCK, PIPE, DIRT, ROCK_A, ROCK_B)


def make_level(rng: np.random.Generator, cols: int, rows: int
               ) -> np.ndarray:
    """``[rows, cols]`` tile indices: sky decorations, rolling hills of
    turf over dirt and rocks, pipes, and floating platforms."""
    lvl = np.zeros((rows, cols), np.int64)
    for c in range(cols):
        for r in range(rows - 8):
            p = rng.random()
            if p < 0.035:
                lvl[r, c] = CLOUD
            elif p < 0.14:
                lvl[r, c] = SKY_STAR
    ground = rows - 4
    ground_at = np.full(cols, rows - 4, np.int64)
    c = 0
    while c < cols:
        run = int(rng.integers(3, 9))
        step = int(rng.integers(-1, 2))
        ground = int(np.clip(ground + step, rows - 12, rows - 2))
        for cc in range(c, min(c + run, cols)):
            ground_at[cc] = ground
            lvl[ground, cc] = GROUND
            for rr in range(ground + 1, rows):
                p = rng.random()
                lvl[rr, cc] = (ROCK_A if p < 0.03 else ROCK_B if p < 0.06
                               else DIRT)
            p = rng.random()
            if p < 0.10 and ground - 1 >= 0:
                lvl[ground - 1, cc] = BUSH
            elif p < 0.18 and ground - 1 >= 0:
                lvl[ground - 1, cc] = FENCE
        if rng.random() < 0.25 and c + run < cols - 2:
            h = int(rng.integers(1, 3))
            lvl[ground - h:ground, min(c + run - 2, cols - 1)] = PIPE
        c += run
    for _ in range(cols // 6):
        pc = int(rng.integers(2, cols - 6))
        pr = int(ground_at[pc] - rng.integers(3, 6))
        ln = int(rng.integers(2, 5))
        kind = BRICK if rng.random() < 0.6 else BLOCK
        lvl[pr, pc:pc + ln] = kind
        if rng.random() < 0.3:
            lvl[pr, pc + ln // 2] = BLOCK
    return lvl


def render_world(level: np.ndarray, tiles: np.ndarray) -> np.ndarray:
    rows, cols = level.shape
    return tiles[level].transpose(0, 2, 1, 3).reshape(rows * TILE,
                                                      cols * TILE)


_T = 255    # transparent

PLAYER_FRAMES = [np.array(rows, np.uint8) for rows in (
    [[_T, _T, 2, 2, 2, 2, _T, _T],
     [_T, 2, 2, 2, 2, 2, 2, _T],
     [_T, 10, 10, 1, 10, 1, _T, _T],
     [_T, 10, 10, 10, 10, 10, _T, _T],
     [_T, _T, 2, 2, 2, _T, _T, _T],
     [_T, 2, 2, 2, 2, 2, _T, _T],
     [_T, 9, 9, _T, 9, 9, _T, _T],
     [_T, 9, _T, _T, _T, 9, _T, _T]],
    [[_T, _T, 2, 2, 2, 2, _T, _T],
     [_T, 2, 2, 2, 2, 2, 2, _T],
     [_T, 10, 10, 1, 10, 1, _T, _T],
     [_T, 10, 10, 10, 10, 10, _T, _T],
     [_T, _T, 2, 2, 2, _T, _T, _T],
     [_T, 2, 2, 2, 2, 2, _T, _T],
     [_T, 9, 9, 9, 9, _T, _T, _T],
     [_T, _T, 9, _T, 9, _T, _T, _T]])]

ENEMY_FRAMES = [np.array(rows, np.uint8) for rows in (
    [[_T, _T, 4, 4, 4, 4, _T, _T],
     [_T, 4, 4, 4, 4, 4, 4, _T],
     [4, 1, 4, 4, 4, 4, 1, 4],
     [4, 4, 4, 4, 4, 4, 4, 4],
     [_T, 0, 0, _T, _T, 0, 0, _T]],
    [[_T, _T, 4, 4, 4, 4, _T, _T],
     [_T, 4, 4, 4, 4, 4, 4, _T],
     [4, 1, 4, 4, 4, 4, 1, 4],
     [4, 4, 4, 4, 4, 4, 4, 4],
     [_T, _T, 0, 0, 0, 0, _T, _T]])]


def _draw_sprite(frame: np.ndarray, spr: np.ndarray, x: int, y: int) -> None:
    h, w = spr.shape
    fh, fw = frame.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, fw), min(y + h, fh)
    if x1 <= x0 or y1 <= y0:
        return
    cut = spr[y0 - y:y1 - y, x0 - x:x1 - x]
    region = frame[y0:y1, x0:x1]
    frame[y0:y1, x0:x1] = np.where(cut == _T, region, cut)


_FONT = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    "S": ["011", "100", "010", "001", "110"],
    "C": ["011", "100", "100", "100", "011"],
    "O": ["111", "101", "101", "101", "111"],
    "R": ["110", "101", "110", "101", "101"],
    "E": ["111", "100", "110", "100", "111"],
    "T": ["111", "010", "010", "010", "010"],
    "I": ["111", "010", "010", "010", "111"],
    "M": ["101", "111", "111", "101", "101"],
    " ": ["000", "000", "000", "000", "000"],
}


def _draw_text(frame: np.ndarray, text: str, x: int, y: int, color: int,
               scale: int = 2) -> None:
    for ch in text:
        for r, row in enumerate(_FONT.get(ch, _FONT[" "])):
            for c, bit in enumerate(row):
                if bit == "1":
                    frame[y + r * scale:y + (r + 1) * scale,
                          x + c * scale:x + (c + 1) * scale] = color
        x += 4 * scale


def _policy(rng: np.random.Generator, n: int) -> List[Tuple[int, bool]]:
    """(walk direction, jump pressed) a frame, in runs of one direction."""
    out: List[Tuple[int, bool]] = []
    while len(out) < n:
        kind = rng.random()
        if kind < 0.75:
            d, run = 1, int(rng.integers(14, 40))
        elif kind < 0.90:
            d, run = 0, int(rng.integers(8, 24))
        else:
            d, run = -1, int(rng.integers(6, 14))
        for _ in range(run):
            out.append((d, rng.random() < 0.06))
    return out[:n]


def action_window(h: int, w: int, bar_rows: int, border: int
                  ) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), exclusive, of the play area inside the border
    and above the status bar."""
    return border, border, w - border, h - bar_rows - border


def render(n: int, h: int, w: int, seed: int, path_seed: int,
           level_cols: int, level_rows: int, bar_rows: int, border: int,
           enemies: int) -> traffic.Session:
    """The session; ``path`` is the camera's (x, y) in the world, the
    play area's top left."""
    prng = np.random.default_rng(path_seed)
    rng = np.random.default_rng(seed)
    ax0, ay0, ax1, ay1 = action_window(h, w, bar_rows, border)
    ah, aw = ay1 - ay0, ax1 - ax0
    level = make_level(prng, level_cols, level_rows)
    inputs = _policy(prng, n)
    world = render_world(level, make_tileset(rng))
    solid = np.kron(np.isin(level, SOLID), np.ones((TILE, TILE), bool))
    wh, ww = world.shape

    foes = []
    for _ in range(enemies):
        ex = float(rng.integers(TILE * 8, ww - TILE * 8))
        reach = float(rng.integers(TILE * 2, TILE * 6))
        foes.append({"x": ex, "x0": ex - reach, "x1": ex + reach,
                     "dir": 1.0 if rng.random() < 0.5 else -1.0})

    def feet_floor(x: float, y: float) -> float:
        """The lowest free top of an 8x8 sprite standing on solid."""
        col = solid[:, int(np.clip(x + 4, 0, ww - 1))]
        yi = int(np.clip(y + 8, 0, wh - 1))
        below = np.flatnonzero(col[yi:])
        return float(yi + below[0] - 8) if len(below) else float(wh - 8)

    px, vx, vy, on_ground = TILE * 3.0, 0.0, 0.0, False
    py = feet_floor(px, 0.0)
    cam_x = float(np.clip(px - aw // 2, 0, ww - aw))
    cam_y = float(np.clip(py - ah // 2, 0, wh - ah))
    frames = np.empty((n, h, w), np.uint8)
    path: List[Tuple[int, int]] = []
    score = 0
    for t in range(n):
        d, jump = inputs[t]
        vx = 0.82 * vx + 0.60 * d
        if jump and on_ground:
            vy, on_ground = -5.2, False
        vy = min(vy + 0.45, 6.0)
        px = float(np.clip(px + vx, 0, ww - 9))
        floor = feet_floor(px, py)
        py = py + vy
        if py >= floor:
            py, vy, on_ground = floor, 0.0, True
        # the dead-zone camera moves only when the player leaves the middle
        dz = aw // 12
        tgt = px - aw / 2
        if px - cam_x < aw / 2 - dz:
            cam_x = max(cam_x - min(3.0, cam_x - tgt), 0.0)
        elif px - cam_x > aw / 2 + dz:
            cam_x = min(cam_x + min(3.0, tgt - cam_x), ww - aw)
        ty = py - ah / 2
        if abs(ty - cam_y) > TILE // 2:
            cam_y = float(np.clip(cam_y + np.clip(ty - cam_y, -2.0, 2.0),
                                  0, wh - ah))
        cx, cy = int(round(cam_x)), int(round(cam_y))
        for e in foes:
            e["x"] += e["dir"] * 0.8
            if e["x"] <= e["x0"] or e["x"] >= e["x1"]:
                e["dir"] *= -1.0
        if t % 7 == 0:
            score += int(rng.integers(0, 25))

        frame = frames[t]
        frame[:] = 14                           # the chrome
        view = world[cy:cy + ah, cx:cx + aw].copy()
        for e in foes:
            ey = feet_floor(e["x"], 0.0) + 3
            _draw_sprite(view, ENEMY_FRAMES[(t // 6) % 2], int(e["x"]) - cx,
                         int(ey) - cy)
        phase = (t // 4) % 2 if abs(vx) > 0.2 else (t // 10) % 2
        _draw_sprite(view, PLAYER_FRAMES[phase], int(px) - cx, int(py) - cy)
        frame[ay0:ay1, ax0:ax1] = view
        hy = h - bar_rows
        frame[hy:] = 0
        _draw_text(frame, "SCORE", 12, hy + 4, 1)
        _draw_text(frame, f"{score % 1000000:06d}", 60, hy + 4, 7)
        _draw_text(frame, "TIME", w - 120, hy + 4, 1)
        _draw_text(frame, f"{max(0, 400 - t // 2):03d}", w - 76, hy + 4, 7)
        path.append((cx, cy))
    return traffic.Session(frames=frames, path=path, noise_at=None)


def make(config: dict, seed: int) -> traffic.Session:
    """The session of a configuration whose ``session`` block has the
    ``platformer`` recipe."""
    s = config["session"]
    p = config["pipeline"]
    if s["recipe"] != "platformer":
        raise ValueError(f"not a platformer session: {s['recipe']!r}")
    return render(s["frames"], p["screen_height"], p["screen_width"], seed,
                  s["path_seed"], s["level_cols"], s["level_rows"],
                  s["bar_rows"], s["border"], s["enemies"])
