"""Capture-wear models: what real emulator dumps do to clean video (the
port's copy of remap_tpu/utils/wear.py, over the port's
``utils.gameplay``; tests/test_torch_core.py holds the two equal).

The reference's input domain is directories of raw frame dumps captured
from running games (main.cpp:16-52).  Real captures are not the clean
renders the gameplay simulator produces — a non-vsynced grabber TEARS
frames across a scanline (top rows from the new frame, bottom rows
still showing the previous one), the capture loop LAGS (the same frame
is written twice) and SKIPS (a frame is never written, doubling the
apparent camera step), and transient glitches flip isolated pixels
(SPECKS).  This module applies those artifacts deterministically to a
simulated :class:`~remap_tpu_torch.utils.gameplay.Session`, so the compiled
-reference differential can run both pipelines on content with
capture-realistic damage — the last distance ROADMAP.md names between
the synthetic battery and real dumps.

Every transform keeps ``session.camera`` aligned with ``session.frames``
(duplicating, deleting, or keeping entries in step), so the world
-ground-truth agreement checks stay meaningful on worn clips.

Why each artifact is a *pipeline* stressor, not just noise:

- **tears** put two camera offsets inside one frame: the per-region
  Borda vote (kpm.hpp:172-211) must declare the majority half's offset
  while the minority half's keypoints vote coherently against it — the
  same adversary shape as the dialog-box interlude, but split along a
  raster line and gone one frame later.
- **lag duplicates** force exact (0,0) declarations with *zero* pixel
  differences — the degenerate best-case the flip-screen genre only
  approximates (its sprites still animate).
- **drops** double (or, back-to-back, triple) the inter-frame camera
  delta mid-clip — probing the match-range boundary rather than the
  comfortable interior.
- **specks** perturb every 4x4 code window they touch (kpe.hpp), shift
  a handful of keypoints per frame, put one-frame foreground pixels in
  front of fdf, and feed the artifact filter exactly the rare-pattern
  input it exists for (arf.hpp:50-307).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from remap_tpu_torch.utils.gameplay import Session


def _clone(session: Session, frames, camera) -> Session:
    return dataclasses.replace(
        session, frames=list(frames), camera=list(camera)
    )


def with_lag(
    session: Session, rng: np.random.Generator, dup_prob: float = 0.06
) -> Session:
    """Capture lag: frames written twice (byte-identical duplicates)."""
    frames, camera = [], []
    for f, c in zip(session.frames, session.camera):
        frames.append(f)
        camera.append(c)
        if rng.random() < dup_prob:
            frames.append(f.copy())
            camera.append(c)
    return _clone(session, frames, camera)


def with_drops(
    session: Session, rng: np.random.Generator, drop_prob: float = 0.06
) -> Session:
    """Capture skips: frames never written.  The first and last frames
    are kept so the session's extent (and the window probe's first
    frame) survive."""
    keep = rng.random(len(session.frames)) >= drop_prob
    keep[0] = keep[-1] = True
    frames = [f for f, k in zip(session.frames, keep) if k]
    camera = [c for c, k in zip(session.camera, keep) if k]
    return _clone(session, frames, camera)


def with_tears(
    session: Session,
    rng: np.random.Generator,
    tear_prob: float = 0.05,
    band: tuple[float, float] = (0.25, 0.75),
) -> Session:
    """Non-vsynced tearing: at a torn index i, the raster has refreshed
    rows above the tear line with frame i's content while rows below
    still show frame i-1 (scan-out progresses top to bottom).  The
    camera entry stays frame i's — the majority half for mid-frame
    splits, and the half the *next* clean frame re-anchors against."""
    frames = [f.copy() for f in session.frames]
    h = frames[0].shape[0]
    lo, hi = int(h * band[0]), int(h * band[1])
    if hi <= lo:  # degenerate band (tiny frames): no row to tear at
        return _clone(session, frames, session.camera)
    for i in range(1, len(frames)):
        if rng.random() < tear_prob:
            split = int(rng.integers(lo, hi))
            frames[i][split:] = session.frames[i - 1][split:]
    return _clone(session, frames, session.camera)


def with_specks(
    session: Session,
    rng: np.random.Generator,
    per_frame: int = 12,
    n_colors: int = 16,
    region: tuple | None = None,
) -> Session:
    """Transient glitches: ``per_frame`` isolated pixels per frame flip
    to a random palette index, one frame only.

    ``region`` is an optional (top, bottom, left, right) half-open box
    confining the glitches — typically the action area.  Specks on the
    static chrome (border/HUD) during window discovery permanently
    defeat the reference's aws stage (every glitch re-marks the change
    heatmap, the best-contour bounds never stagnate, no window is ever
    accepted, and the whole run emits NOTHING — replicated bit-exactly
    by our pipeline, pinned in tests/differential/test_ref_wear.py), so
    wear batteries that want maps out keep specks inside the window."""
    if region is None:
        h, w = session.frames[0].shape
        region = (0, h, 0, w)
    top, bottom, left, right = region
    frames = []
    for f in session.frames:
        g = f.copy()
        ys = rng.integers(top, bottom, per_frame)
        xs = rng.integers(left, right, per_frame)
        g[ys, xs] = rng.integers(0, n_colors, per_frame).astype(g.dtype)
        frames.append(g)
    return _clone(session, frames, session.camera)


def worn(
    session: Session,
    seed: int,
    *,
    specks: int = 12,
    speck_region: tuple | None = None,
    tear_prob: float = 0.05,
    dup_prob: float = 0.06,
    drop_prob: float = 0.06,
) -> Session:
    """The combined capture-wear model, applied in capture order:
    tears happen at scan-out, specks on the stored dump, and the
    lag/drop cadence reorders what gets written at all.  See
    :func:`with_specks` for why ``speck_region`` should usually be the
    action area."""
    rng = np.random.default_rng(seed)
    s = with_tears(session, rng, tear_prob)
    s = with_specks(s, rng, specks, region=speck_region)
    s = with_lag(s, rng, dup_prob)
    s = with_drops(s, rng, drop_prob)
    return s
