"""idle_share.stream: percent of the profiled steps' window in which the
card ran no kernel, copy or set."""

from port_bench.readers import idle_share


def read(obs):
    return idle_share(obs)
