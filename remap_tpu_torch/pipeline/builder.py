"""The map builder: the five-stage orchestrator (port of
remap_tpu/pipeline/builder.py, mpb.hpp:28-41).

``build()`` = window scan -> cropped re-feed -> collect -> splice ->
foreground filter -> artifact clean -> native-code map images, on one
device, except that splice's first extraction, the foreground and the
clean round-robin their fragments when the caller gives several
devices.  Every stage boundary hands its full intermediate state to the
callbacks object (mpb.hpp:44-77), and can checkpoint fragments to disk
(``io.checkpoint``, the reference's unused ful.hpp made real) for a
later ``resume``.  A feed that crops natively (``io.frames``) is re-fed
cropped, so collect reads its packed batches straight off the native
reader.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.geometry import Rect
from remap_tpu_torch.device import get_device
from remap_tpu_torch.io import checkpoint
from remap_tpu_torch.pipeline import clean as clean_stage
from remap_tpu_torch.pipeline import collect as collect_stage
from remap_tpu_torch.pipeline import foreground as fg_stage
from remap_tpu_torch.pipeline import splice as splice_stage
from remap_tpu_torch.pipeline import window as window_stage
from remap_tpu_torch.pipeline.state import Fragment
from remap_tpu_torch.spec.aws import WindowInfo


class Callbacks:
    """Per-stage observation hooks (default: no-ops), the reference's
    callbacks seam: every stage hands back its full intermediate state
    (mpb.hpp:44-77)."""

    def on_window(self, window: Optional[WindowInfo]) -> None: ...

    def on_collect(self, result: collect_stage.CollectResult) -> None: ...

    def on_splice(self, fragments: List[Fragment]) -> None: ...

    def on_filter(self, fragments: List[Fragment]) -> None: ...

    def on_clean(self, images: List[np.ndarray]) -> None: ...

    def on_checkpoint(self, tag: str, seconds: float) -> None:
        """After a stage checkpoint is written (tag "collect" or
        "filtered"), from the thread that wrote it: the save's seconds,
        which overlap the following stages."""
        ...


class PerfCallbacks(Callbacks):
    """Per-stage wall-clock seconds and frames per second, printed, in the
    spirit of the reference's perf_counter prints (main.cpp:54-110).  The
    stages queue device work without waiting, so a stage's time includes
    whatever of the previous stage's work was still running."""

    def __init__(self) -> None:
        self._last = time.perf_counter()

    def _stage(self, name: str, frames: int) -> None:
        now = time.perf_counter()
        dt = max(now - self._last, 1e-9)
        fps = f"{frames / dt:8.1f} fps" if frames else " " * 12
        print(f"[{name}] {dt:6.2f} s  {fps}")
        self._last = now

    def on_window(self, window) -> None:
        self._stage("aws", 0)

    def on_collect(self, result) -> None:
        self._stage("frc", len(result.offsets))

    def on_splice(self, fragments) -> None:
        self._stage("fgs", 0)

    def on_filter(self, fragments) -> None:
        self._stage("fdf", sum(len(f.frames) for f in fragments))

    def on_clean(self, images) -> None:
        self._stage("arf", 0)

    def on_checkpoint(self, tag, seconds) -> None:
        # written on a worker thread beside the stages: not a stage's time
        print(f"[checkpoint {tag}] {seconds:6.2f} s")


@dataclasses.dataclass
class BuildResult:
    maps: List[np.ndarray]
    window: Optional[WindowInfo]
    fragments: List[Fragment]
    collect: Optional[collect_stage.CollectResult]


def _save_checkpoint(cb: Callbacks, checkpoint_dir: Optional[str], tag: str,
                     fragments: List[Fragment],
                     include_store: bool = True) -> Optional[Future]:
    """Checkpoint ``fragments`` under ``checkpoint_dir``: the snapshot
    (device canvases queued for copying, numbers, positions) is taken here
    at the stage boundary, and the compression and writes run on a worker
    thread while the next stages run.  Returns the write's future (its
    ``result()`` re-raises a failed write), or None without a
    directory."""
    if not checkpoint_dir:
        return None
    snap = checkpoint.snapshot(fragments, include_store)

    def work():
        t0 = time.perf_counter()
        checkpoint.write(checkpoint_dir, tag, snap)
        cb.on_checkpoint(tag, time.perf_counter() - t0)

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(work)
    pool.shutdown(wait=False)
    return future


def _checkpoint_stage(checkpoint_dir: str) -> Optional[str]:
    """The latest resumable stage saved under ``checkpoint_dir``, if any."""
    for tag in ("filtered", "collect"):
        if os.path.exists(os.path.join(checkpoint_dir, tag, "meta.json")):
            return tag
    return None


def _join(future: Optional[Future]) -> None:
    if future is not None:
        future.result()


def _finish(filtered: List[Fragment], cfg: PipelineConfig, cb: Callbacks,
            dev, devices, window, col,
            pending: Optional[Future]) -> BuildResult:
    """The artifact clean, after the ``filtered`` checkpoint (if any) has
    been queued; waits for the checkpoint before returning."""
    maps = clean_stage.clean(filtered, cfg, device=dev, devices=devices)
    cb.on_clean(maps)
    _join(pending)
    return BuildResult(maps=maps, window=window, fragments=filtered,
                       collect=col)


def _feed_crop(probe, crop: Rect) -> Rect:
    """The window's crop composed with the feed's own: the window scan saw
    the feed's already-cropped frames, so the crop is offset by the feed's
    crop origin rather than replacing it."""
    base = getattr(probe, "crop", None)
    if base is None:
        return crop
    return Rect(left=base.left + crop.left, top=base.top + crop.top,
                right=base.left + crop.right, bottom=base.top + crop.bottom)


def build(
    frames_factory: Callable[[], Iterable[np.ndarray]],
    cfg: PipelineConfig,
    callbacks: Optional[Callbacks] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    devices: Optional[Sequence] = None,
) -> BuildResult:
    """The maps of the frames ``frames_factory()`` yields, on ``device``
    (CUDA unless the caller asks for the CPU).  ``frames_factory()`` must
    yield the frame stream anew on each call: the reference re-feeds the
    frames after the window scan (mpb.hpp:32).

    With ``checkpoint_dir``, the fragments after collect ("collect", with
    the frame store) and after the foreground filter ("filtered", without
    it) are saved there.  With ``resume`` too, the build restarts from the
    latest saved stage: "filtered" runs the artifact clean alone,
    "collect" skips the window scan and collect (and saves "filtered"
    again); neither reads a frame.  With no checkpoint there, it runs in
    full.

    Splice's initial extraction, the foreground and the clean round-robin
    their fragments over ``devices`` when it holds more than one
    (``parallel.fragments.round_robin``); by default everything runs on
    ``device``."""
    cb = callbacks or Callbacks()
    dev = get_device(device)

    stage = _checkpoint_stage(checkpoint_dir) if (
        resume and checkpoint_dir) else None
    if stage == "filtered":
        filtered = checkpoint.load(checkpoint_dir, "filtered", device=dev)
        cb.on_filter(filtered)
        return _finish(filtered, cfg, cb, dev, devices, None, None, None)
    if stage == "collect":
        frags = checkpoint.load(checkpoint_dir, "collect", device=dev)
        spliced = splice_stage.splice(frags, cfg, device=dev, devices=devices)
        cb.on_splice(spliced)
        filtered = fg_stage.filter_fragments(spliced, cfg, devices)
        cb.on_filter(filtered)
        pending = _save_checkpoint(cb, checkpoint_dir, "filtered", filtered,
                                   include_store=False)
        return _finish(filtered, cfg, cb, dev, devices, None, None, pending)

    window = window_stage.scan(frames_factory(), cfg, device=dev)
    cb.on_window(window)
    if window is None:
        return BuildResult(maps=[], window=None, fragments=[], collect=None)

    crop = window.crop
    probe = frames_factory()
    if hasattr(probe, "with_crop"):
        # a feed re-crops natively, so collect reads packed batches off
        # its native reader
        source = probe.with_crop(_feed_crop(probe, crop))
    else:
        def cropped(src=probe):
            for f in src:
                yield f[crop.top:crop.bottom, crop.left:crop.right]

        source = cropped()

    col = collect_stage.collect(source, cfg, device=dev)
    cb.on_collect(col)
    pending = _save_checkpoint(cb, checkpoint_dir, "collect", col.fragments)

    spliced = splice_stage.splice(col.fragments, cfg, device=dev,
                                  devices=devices)
    cb.on_splice(spliced)

    filtered = fg_stage.filter_fragments(spliced, cfg, devices)
    cb.on_filter(filtered)
    _join(pending)
    # the store is not saved again: the clean reads the canvases alone,
    # and the collect checkpoint holds the frames
    pending = _save_checkpoint(cb, checkpoint_dir, "filtered", filtered,
                               include_store=False)
    return _finish(filtered, cfg, cb, dev, devices, window, col, pending)


def build_from_frames(frames: Sequence[np.ndarray], cfg: PipelineConfig,
                      **kwargs) -> BuildResult:
    return build(lambda: iter(frames), cfg, **kwargs)
