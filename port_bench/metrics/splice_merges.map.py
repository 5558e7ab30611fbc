"""splice_merges.map: mean merges a build in splice's greedy loop (the
program's counter ``splice.merges``; traced runs).  None for a version
that does not count splice's fragments (``splice.fragments``)."""

from port_bench.recorded import counter


def read(obs):
    return counter(obs, "splice.merges", "splice.fragments")
