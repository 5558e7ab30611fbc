"""Entry driver: the CLI's map build under the pyramid matcher, one build
at a time (a closed loop), checked against the pyramid's own rule.

Everything of ``map_build``'s driver (set-up, the window of builds, the
traced run, and every number its check compares), and one more number:
``pairs_wrong``, the pairs of the last build whose offset or matched
flag differs from ``reference/pyramid.py``'s rule on the same cropped
frames (the last build's crop of the session), on the run's device.  A
pair's offset counts only where both sides match it, as collect
declares an unmatched pair's offset 0.

Observations of a traced run (``Driver.observations``): those of
``map_build``: ``builds``; ``stage_s``, seconds a build of each of
``window``, ``collect``, ``splice``, ``foreground``, ``clean`` and
``ladder``; ``peak_bytes``, the most device memory a build allocated;
``profile``, the profiled build (``trace.profiled``).  The program's
spans of the window's builds (among them ``pyramid.coarse`` and
``pyramid.fine`` under ``collect.pass``) are read through
``port_bench/spans.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.drivers import map_build
from port_bench.reference import pyramid as ref_pyramid


class Driver(map_build.Driver):
    """``map_build.Driver`` whose check also holds the last build's pairs
    to the pyramid's rule."""

    def check(self, bits: int = 16) -> Dict[str, int]:
        out = super().check(bits)
        out["pairs_wrong"] = self._pairs_wrong()
        if out["pairs_wrong"]:
            # the pairs are the last build's
            self.failed_builds = max(self.failed_builds, 1)
        return out

    def _pairs_wrong(self) -> int:
        frames = self.session.frames
        n = len(frames)
        last = self.builds[-1]
        if (last["crop"] is None or last["offsets"] is None
                or len(last["offsets"]) != n):
            return n - 1
        left, top, right, bottom = last["crop"]
        cropped = torch.as_tensor(
            np.ascontiguousarray(frames[:, top:bottom, left:right]),
            device=self.dev)
        want_off, want_ok = ref_pyramid.match(cropped[:-1], cropped[1:])
        want_off, want_ok = want_off.cpu().numpy(), want_ok.cpu().numpy()
        got_off = np.asarray(last["offsets"][1:], np.int64)
        got_ok = np.asarray(last["matched"][1:], bool)
        bad = got_ok != want_ok
        bad |= got_ok & want_ok & np.any(got_off != want_off, axis=1)
        return int(bad.sum())
