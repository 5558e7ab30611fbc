"""The map builder: the five-stage orchestrator (port of
remap_tpu/pipeline/builder.py, mpb.hpp:28-41).

``build()`` = window scan -> cropped re-feed -> collect -> splice ->
foreground filter -> artifact clean -> native-code map images, all on one
device.  Every stage boundary hands its full intermediate state to the
callbacks object (mpb.hpp:44-77).  Not ported yet: stage checkpoints
(``checkpoint_dir``, ``resume``) and feeds that crop natively (an object
with ``with_crop``); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.device import get_device
from remap_tpu_torch.pipeline import clean as clean_stage
from remap_tpu_torch.pipeline import collect as collect_stage
from remap_tpu_torch.pipeline import foreground as fg_stage
from remap_tpu_torch.pipeline import splice as splice_stage
from remap_tpu_torch.pipeline import window as window_stage
from remap_tpu_torch.pipeline.state import Fragment
from remap_tpu_torch.pipeline.window import WindowInfo


class Callbacks:
    """Per-stage observation hooks (default: no-ops), the reference's
    callbacks seam: every stage hands back its full intermediate state
    (mpb.hpp:44-77)."""

    def on_window(self, window: Optional[WindowInfo]) -> None: ...

    def on_collect(self, result: collect_stage.CollectResult) -> None: ...

    def on_splice(self, fragments: List[Fragment]) -> None: ...

    def on_filter(self, fragments: List[Fragment]) -> None: ...

    def on_clean(self, images: List[np.ndarray]) -> None: ...


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


@dataclasses.dataclass
class BuildResult:
    maps: List[np.ndarray]
    window: Optional[WindowInfo]
    fragments: List[Fragment]
    collect: Optional[collect_stage.CollectResult]


def build(
    frames_factory: Callable[[], Iterable[np.ndarray]],
    cfg: PipelineConfig,
    callbacks: Optional[Callbacks] = None,
    device=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> BuildResult:
    """The maps of the frames ``frames_factory()`` yields, on ``device``
    (CUDA unless the caller asks for the CPU).  ``frames_factory()`` must
    yield the frame stream anew on each call: the reference re-feeds the
    frames after the window scan (mpb.hpp:32)."""
    if checkpoint_dir or resume:
        raise NotImplementedError("stage checkpoints are not ported yet")
    cb = callbacks or Callbacks()
    dev = get_device(device)

    window = window_stage.scan(frames_factory(), cfg, device=dev)
    cb.on_window(window)
    if window is None:
        return BuildResult(maps=[], window=None, fragments=[], collect=None)

    crop = window.crop
    probe = frames_factory()
    if hasattr(probe, "with_crop"):
        raise NotImplementedError("feeds that crop natively are not ported "
                                  "yet")

    def cropped(src=probe):
        for f in src:
            yield f[crop.top:crop.bottom, crop.left:crop.right]

    col = collect_stage.collect(cropped(), cfg, device=dev)
    cb.on_collect(col)

    spliced = splice_stage.splice(col.fragments, cfg, device=dev)
    cb.on_splice(spliced)

    filtered = fg_stage.filter_fragments(spliced, cfg)
    cb.on_filter(filtered)

    maps = clean_stage.clean(filtered, cfg, device=dev)
    cb.on_clean(maps)
    return BuildResult(maps=maps, window=window, fragments=filtered,
                       collect=col)


def build_from_frames(frames: Sequence[np.ndarray], cfg: PipelineConfig,
                      **kwargs) -> BuildResult:
    return build(lambda: iter(frames), cfg, **kwargs)
