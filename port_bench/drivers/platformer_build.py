"""Entry driver: the CLI's map build of a ``platformer`` session
(``port_bench/platformer.py``), one build at a time (a closed loop),
checked against the camera path the session was played along.

Everything of ``map_build``'s driver (the raw dumps, the window of
builds, the traced run, the stage clocks and the PNGs), with the session
made by the ``platformer`` recipe, and a check that knows the status bar
below the play area.  Every number it compares has the limit 0:

- ``crop_wrong``: the crop of every build against
  ``reference/bottom_bar.py``'s rule;
- ``offsets_wrong``: every frame's offset and matched flag against the
  camera path, every frame but frame 0 matched;
- ``fragments_wrong``: the last build's spliced fragments: one, holding
  every frame at one shift against the camera (``map_build``'s rule for
  a session with no noise frame);
- ``splice_bins_wrong``, ``foreground_bins_wrong`` and ``map_px_wrong``:
  as ``map_build``'s, against ``port_bench/reference/``.

Observations of a traced run (``Driver.observations``): those of
``map_build``.  The program's spans and counters of the window's builds
(among them collect's rung spans with their ``limit`` and the counters
``collect.table_flagged``, ``collect.join_flagged`` and
``collect.range_flagged``) are read through ``port_bench/spans.py``.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from port_bench import platformer
from port_bench.drivers import map_build
from port_bench.reference import bottom_bar
from port_bench.reference import clean as ref_clean
from port_bench.reference import maps as ref


class Driver(map_build.Driver):
    """``map_build.Driver`` on a ``platformer`` session."""

    def setup(self) -> None:
        t = time.perf_counter()
        from remap_tpu_torch.config import PipelineConfig
        from remap_tpu_torch.io import frames as frames_io

        t = self._mark("imports", t)
        self.session = platformer.make(self.config, self.seed)
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
        map_build._sync(self.dev)
        self._mark("warm build", t)
        self.builds.clear()

    def check(self, bits: int = 16) -> Dict[str, int]:
        """Each number compared, with limit 0.  ``bits`` narrows the
        reference's vote counters (the control)."""
        s = self.session
        n, h, w = s.frames.shape
        sess = self.config["session"]
        crop = bottom_bar.expected_crop(h, w, sess["bar_rows"],
                                        sess["border"])
        left, top, right, bottom = crop
        want_off, want_matched = ref.expected_motion(s.path, None)
        bad_builds = [False] * len(self.builds)
        out = {"crop_wrong": 0, "offsets_wrong": 0}
        for i, b in enumerate(self.builds):
            crop_bad = int(b["crop"] != crop)
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
        out["splice_bins_wrong"] = map_build.canvases_differ(
            [self._dots(frag) for frag, _ in spliced],
            [want for _, want in spliced])
        filtered = [self._filtered_reference(cropped, frag, want, bits)
                    for frag, want in spliced]
        out["foreground_bins_wrong"] = map_build.canvases_differ(
            [self._dots(frag) for frag in self.filtered or []], filtered)
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
