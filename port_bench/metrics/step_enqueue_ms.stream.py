"""step_enqueue_ms.stream: the host's mean ms inside a step() call over
the traced window (the total over all steps, over the steps)."""


def read(obs):
    times = obs.get("enqueue_s")
    return 1e3 * sum(times) / len(times) if times else None
