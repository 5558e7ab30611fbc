"""pyramid_fine_ms.map: mean device ms a build in the pyramid matcher's
fine level during collect's match passes (the program's ``pyramid.fine``
spans under ``collect.pass``, timed by their CUDA events; traced
runs)."""

from port_bench.device_spans import device_ms_under


def read(obs):
    return device_ms_under(obs, "pyramid.fine", "collect.pass")
