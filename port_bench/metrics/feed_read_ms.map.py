"""feed_read_ms.map: mean host ms a build in the native frame reader's
batch reads, the window scan's and collect's first pass's alike (the
program's ``feed.read`` spans, timed on the thread that read, the
reader's worker or the main thread; traced runs).  None where a build
records no such span."""

from port_bench.layer_spans import host_ms


def read(obs):
    return host_ms(obs, ("feed.read",))
