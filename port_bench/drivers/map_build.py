"""Entry driver: the CLI's map build, one build at a time (a closed loop).

Set-up renders the session from the seed, writes it as numbered raw
dumps into the run's scratch directory, and makes one warm build.  Each
build of the window is the body of the CLI's run: a
``io.frames.RawDirectoryFeed`` over the dumps (the native packed reader
serves the window scan and collect), ``pipeline.builder.build``, and
``io.png.write_map`` for each map.

Traced runs add, around the program's calls: stage callbacks that wait
for the card at each stage boundary; collect's match passes and pair
repairs wrapped the same way (the ladder); the card's peak memory per
build; and, after the window, one build under ``torch.profiler``.

Every build keeps its maps, offsets and matched flags; the last keeps its
spliced and filtered fragments, for the check after the window.

Observations of a traced run (``Driver.observations``): ``builds``;
``stage_s``, seconds a build of each of ``window``, ``collect``,
``splice``, ``foreground``, ``clean`` and ``ladder``; ``peak_bytes``,
the most device memory a build allocated; ``profile``, the profiled
build (``trace.profiled``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import traffic as traffic_mod
from port_bench import trace as trace_mod
from port_bench.reference import clean as ref_clean
from port_bench.reference import foreground as ref_fg
from port_bench.reference import maps as ref


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    """One cell's map builds: ``setup()``, ``window(seconds)``, then
    ``check()``; ``observations`` holds what the traced run saw."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 workdir: str, trace: bool):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.workdir = workdir
        self.trace = trace
        self.builds: List[dict] = []
        self.observations: Dict[str, object] = {}
        self.setup_marks: List[tuple] = []

    # -- set-up -------------------------------------------------------

    def _mark(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_marks.append((name, now - since))
        return now

    def setup(self) -> None:
        t = time.perf_counter()
        from remap_tpu_torch.config import PipelineConfig
        from remap_tpu_torch.io import frames as frames_io

        t = self._mark("imports", t)
        self.session = traffic_mod.make(self.config, self.traffic, self.seed)
        t = self._mark("session", t)
        n, h, w = self.session.frames.shape
        frames_dir = os.path.join(self.workdir, "frames")
        os.makedirs(frames_dir)
        for i, frame in enumerate(self.session.frames):
            frame.tofile(os.path.join(frames_dir, str(i)))
        self.maps_dir = os.path.join(self.workdir, "maps")
        os.makedirs(self.maps_dir)
        self.cfg = PipelineConfig(**self.config["pipeline"])
        self.feed = frames_io.RawDirectoryFeed(frames_dir, w, h)
        t = self._mark("dumps", t)
        self._build(self._keeper())     # warm: every shape of the cell
        _sync(self.dev)
        self._mark("warm build", t)
        self.builds.clear()

    def close(self) -> None:
        pass

    # -- the build ----------------------------------------------------

    def _keeper(self, clock: Optional[dict] = None):
        """Callbacks that keep the last build's spliced and filtered
        fragments (dropped when the next build starts) and, with
        ``clock``, wait for the card at each stage and time it."""
        from remap_tpu_torch.pipeline import builder

        drv = self

        class Keeper(builder.Callbacks):
            def __init__(self):
                drv.spliced = drv.filtered = None
                self.t = time.perf_counter()

            def _stage(self, name):
                if clock is None:
                    return
                _sync(drv.dev)
                now = time.perf_counter()
                clock.setdefault(name, []).append(now - self.t)
                self.t = now

            def on_window(self, window):
                self._stage("window")

            def on_collect(self, result):
                self._stage("collect")

            def on_splice(self, fragments):
                drv.spliced = fragments
                self._stage("splice")

            def on_filter(self, fragments):
                drv.filtered = fragments
                self._stage("foreground")

            def on_clean(self, images):
                self._stage("clean")

        return Keeper()

    def _build(self, callbacks) -> dict:
        from remap_tpu_torch.io import png
        from remap_tpu_torch.pipeline import builder

        res = builder.build(lambda: self.feed, self.cfg, callbacks=callbacks,
                            device=self.dev)
        for i, image in enumerate(res.maps, start=1):
            png.write_map(os.path.join(self.maps_dir, f"out{i}.png"), image)
        crop = res.window.crop if res.window is not None else None
        return {"maps": res.maps,
                "crop": None if crop is None else (
                    crop.left, crop.top, crop.right, crop.bottom),
                "offsets": None if res.collect is None
                else np.array(res.collect.offsets),
                "matched": None if res.collect is None
                else np.array(res.collect.matched)}

    # -- the window ---------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Builds started until ``seconds`` have passed, each to its PNGs.
        Returns the end-to-end metrics."""
        n = len(self.session.frames)
        clock: Optional[dict] = {} if self.trace else None
        peaks: List[int] = []
        ladder = contextlib.nullcontext() if not self.trace else \
            self._ladder(clock)
        start = time.perf_counter()
        with ladder:
            while not self.builds or time.perf_counter() - start < seconds:
                if self.trace:
                    self.run_peak = max(getattr(self, "run_peak", 0),
                                        torch.cuda.max_memory_allocated(
                                            self.dev)
                                        if self.dev.type == "cuda" else 0)
                    if self.dev.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(self.dev)
                t0 = time.perf_counter()
                self.builds.append(self._build(self._keeper(clock)))
                self.builds[-1]["seconds"] = time.perf_counter() - t0
                if self.trace and self.dev.type == "cuda":
                    peaks.append(torch.cuda.max_memory_allocated(self.dev))
        elapsed = time.perf_counter() - start
        self.window_builds = len(self.builds)
        if self.trace:
            self.observations.update(
                {"builds": len(self.builds), "stage_s": clock,
                 "peak_bytes": max(peaks) if peaks else None})
        return {"map_fps": len(self.builds) * n / elapsed,
                "builds": len(self.builds), "window_s": elapsed}

    def notes(self) -> List[str]:
        return ["setup seconds " + " ".join(
            f"{k} {v:.3f}" for k, v in self.setup_marks),
            "build seconds " + " ".join(
            f"{b['seconds']:.4f}" for b in self.builds if "seconds" in b)]

    @contextlib.contextmanager
    def _ladder(self, clock: dict):
        """Collect's rungs beyond each build's first match pass (the
        replays at a larger capacity, and the pair repairs), each timed
        between two waits for the card, summed per build in
        ``clock['ladder']``."""
        from remap_tpu_torch.pipeline import collect

        real = collect.match_pass, collect.repair_pairs
        dev = self.dev
        seen = {"passes": 0}
        clock["ladder"] = []

        def timed(fn, *args):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(dev)
            return out, time.perf_counter() - t0

        def match_pass(frames, layout, cfg, store=None, device=None):
            if seen["passes"] == 0:
                seen["passes"] = 1
                return real[0](frames, layout, cfg, store, device)
            out, dt = timed(real[0], frames, layout, cfg, store, device)
            clock["ladder"][-1] += dt
            return out

        def repair_pairs(*args):
            out, dt = timed(real[1], *args)
            clock["ladder"][-1] += dt
            return out

        real_collect = collect.collect

        def collect_(*args, **kwargs):
            seen["passes"] = 0
            clock["ladder"].append(0.0)
            return real_collect(*args, **kwargs)

        # the builder calls collect.collect through the module
        collect.match_pass, collect.repair_pairs, collect.collect = (
            match_pass, repair_pairs, collect_)
        try:
            yield
        finally:
            collect.match_pass, collect.repair_pairs = real
            collect.collect = real_collect

    def profile(self) -> None:
        """One more build under the profiler (traced runs): the device's
        busy time, the window, and the breakdown."""
        res, prof_obs = trace_mod.profiled(
            lambda: self._build(self._keeper()), self.dev)
        self.builds.append(res)
        self.observations["profile"] = prof_obs

    # -- the check ----------------------------------------------------

    def check(self, bits: int = 16) -> Dict[str, int]:
        """Each number compared, with limit 0: the window's builds against
        what the session implies.  ``bits`` narrows the reference's vote
        counters (the control)."""
        s = self.session
        n, h, w = s.frames.shape
        sess = self.config["session"]
        left, top, right, bottom = ref.expected_crop(
            h, w, sess["hud_rows"], sess["border"])
        want_off, want_matched = ref.expected_motion(s.path, s.noise_at)
        bad_builds = [False] * len(self.builds)
        out = {"crop_wrong": 0, "offsets_wrong": 0}
        for i, b in enumerate(self.builds):
            crop_bad = int(b["crop"] != (left, top, right, bottom))
            if b["offsets"] is None or len(b["offsets"]) != n:
                off_bad = n
            else:
                bad = b["matched"] != want_matched
                bad |= want_matched & np.any(b["offsets"] != want_off, axis=1)
                off_bad = int(bad.sum())
            out["crop_wrong"] += crop_bad
            out["offsets_wrong"] += off_bad
            bad_builds[i] = bool(crop_bad or off_bad)

        cropped = torch.as_tensor(
            np.ascontiguousarray(s.frames[:, top:bottom, left:right]),
            device=self.dev)
        out["fragments_wrong"], spliced = self._check_spliced(cropped, bits)
        out["splice_bins_wrong"] = canvases_differ(
            [self._dots(frag) for frag, _ in spliced],
            [want for _, want in spliced])
        # the foreground of every frame of the last build's fragments, from
        # the reference's own spliced canvases
        filtered = [self._filtered_reference(cropped, frag, want, bits)
                    for frag, want in spliced]
        out["foreground_bins_wrong"] = canvases_differ(
            [self._dots(frag) for frag in self.filtered or []], filtered)
        # the maps of the reference's filtered canvases; every build of the
        # window must give them
        want_maps = [ref_clean.clean_canvas(
            want, size=self.cfg.artifact_filter_size,
            dev=self.cfg.artifact_filter_dev,
            threshold=self.cfg.artifact_heat_threshold)
            for want in filtered]
        out["map_px_wrong"] = 0
        for i, b in enumerate(self.builds):
            px = ref.maps_differ(b["maps"], want_maps)
            out["map_px_wrong"] += px
            bad_builds[i] |= px > 0
        last_bad = (out["fragments_wrong"] or out["splice_bins_wrong"]
                    or out["foreground_bins_wrong"])
        bad_builds[-1] |= bool(last_bad)
        self.failed_builds = sum(bad_builds)
        return out

    def _dots(self, frag) -> torch.Tensor:
        """A fragment's ``[16, h, w]`` votes, int64, on the run's device."""
        h, w = frag.shape
        if frag.dots_dev is None:
            return torch.as_tensor(np.asarray(frag.dots, np.int64),
                                   device=self.dev).permute(2, 0, 1)
        return frag.dots_dev[:, :h, :w].to(self.dev, torch.int64)

    @staticmethod
    def _canvas_positions(frag) -> np.ndarray:
        pos = np.array([r.position for r in frag.frames], np.int64)
        return pos.reshape(-1, 2) - np.asarray(frag.zero, np.int64)

    def _check_spliced(self, cropped, bits):
        """(records wrong, [(program fragment, reference canvas)]): each
        spliced fragment must hold one stretch of frames between breaks,
        or several stretches joined, at positions that follow the camera
        (one shift per fragment); its canvas must equal the votes of its
        frames at their positions."""
        path = np.asarray(self.session.path, np.int64)
        wrong = 0
        seen = set()
        spliced = []
        for frag in self.spliced or []:
            nums = [r.number for r in frag.frames]
            seen.update(nums)
            if not nums:
                wrong += 1
                continue
            pos = np.array([r.position for r in frag.frames], np.int64)
            shift = pos[0] - path[nums[0]]
            wrong += int(np.any(pos - path[nums] != shift, axis=1).sum())
            want = ref.vote_canvas(cropped[nums],
                                   self._canvas_positions(frag), frag.shape,
                                   bits=bits)
            spliced.append((frag, want))
        n = len(self.session.frames)
        wrong += n - len(seen & set(range(n)))
        # a break splits the session; splice joins the stretches of one
        # world again, and leaves the noise frame alone
        noise = self.session.noise_at
        want_frags = 1 if noise is None else 2
        wrong += abs(len(self.spliced or []) - want_frags)
        if noise is not None and not any(
                [r.number for r in f.frames] == [noise]
                for f in self.spliced or []):
            wrong += 1
        return wrong, spliced

    def _filtered_reference(self, cropped, frag, canvas, bits):
        """The reference's filtered canvas of a spliced fragment: its
        frames' votes where their foreground masks against the blend of
        the reference's spliced ``canvas`` are 0."""
        background = torch.as_tensor(ref.blend(canvas), device=self.dev)
        nums = [r.number for r in frag.frames]
        return ref_fg.filtered_canvas(
            cropped[nums], self._canvas_positions(frag), frag.shape,
            background, self.cfg.fde_area_divisor, bits=bits)


def canvases_differ(got: List[torch.Tensor],
                    want: List[torch.Tensor]) -> int:
    """Bins by which two lists of canvases differ: every bin of the
    larger where two shapes differ, and every bin of a canvas that the
    other list lacks."""
    n = sum(max(g.numel(), w.numel()) if g.shape != w.shape
            else int((g != w).sum()) for g, w in zip(got, want))
    return n + sum(c.numel() for c in got[len(want):] + want[len(got):])
