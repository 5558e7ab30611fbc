"""foreground_masks_ms.map: mean device ms a build in the foreground
batches' masks (the masks assembled from K4's labels and stats: the
int64 sort and scans; the program's ``foreground.masks`` spans directly
under ``foreground.batch``, each timed between its CUDA events; traced
runs).  An event pair's time includes the stream's gaps between them, so
a stretch that the host paces reads near its host time.  None where a
build has no such span, or one without events (the CPU)."""

from port_bench.device_spans import device_ms_under


def read(obs):
    return device_ms_under(obs, "foreground.masks", "foreground.batch")
