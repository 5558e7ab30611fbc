"""clean_ms.map: the clean stage's mean ms a build, from stage callbacks
that wait for the card at each boundary (traced runs)."""

from port_bench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "clean")
