"""feed_frames.map: mean frames a build that the native frame reader
returned, to the window scan and to collect's first pass (the program's
counter ``feed.frames``; traced runs).  None where a build has no such
counter."""

from port_bench.layer_spans import counter


def read(obs):
    return counter(obs, "feed.frames")
