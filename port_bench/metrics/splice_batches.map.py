"""splice_batches.map: mean batched cellular votes a build of splice's
grid_vote matches, each a batch of a round's fragment pairs (the
program's counter ``splice.batches``; traced runs).  Over
``splice_matches.map`` it gives the mean pairs a batch.  None where no
build of the window counts it (a version that votes one pair a call)."""

from port_bench.recorded import counter


def read(obs):
    return counter(obs, "splice.batches", "splice.batches")
