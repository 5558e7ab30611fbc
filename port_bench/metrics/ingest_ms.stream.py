"""ingest_ms.stream: median ms between CUDA events queued just before a
batch's upload and just after its unpack on the card, over the traced
window."""

from port_bench.readers import median_ms


def read(obs):
    return median_ms(obs, "ingest_ms")
