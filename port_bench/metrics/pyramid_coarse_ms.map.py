"""pyramid_coarse_ms.map: mean device ms a build in the pyramid matcher's
coarse level during collect's match passes (the program's
``pyramid.coarse`` spans under ``collect.pass``, timed by their CUDA
events; traced runs)."""

from port_bench.device_spans import device_ms_under


def read(obs):
    return device_ms_under(obs, "pyramid.coarse", "collect.pass")
