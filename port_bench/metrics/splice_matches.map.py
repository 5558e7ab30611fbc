"""splice_matches.map: mean matches a build of splice's fragment pairs,
first round and re-matches of merged snippets alike (the program's
counter ``splice.matches``; traced runs)."""

from port_bench.spans import counter


def read(obs):
    return counter(obs, "splice.matches")
