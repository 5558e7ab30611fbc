"""splice_vote_ms.map: mean device ms a build in the cellular matcher's
calls of splice's matches (the program's ``splice.vote`` spans under
``splice.match``, timed by their CUDA events; traced runs)."""

from port_bench.device_spans import device_ms_under


def read(obs):
    return device_ms_under(obs, "splice.vote", "splice.match")
