"""ladder_ms.map: mean ms a build in collect's rungs beyond its first
match pass (replays at a larger capacity and pair repairs), each timed
between two waits for the card (traced runs)."""

from port_bench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "ladder")
