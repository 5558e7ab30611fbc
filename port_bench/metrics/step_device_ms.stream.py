"""step_device_ms.stream: median ms between CUDA events queued just
before and just after each step() call of the traced window."""

from port_bench.readers import median_ms


def read(obs):
    return median_ms(obs, "step_device_ms")
