"""peak_gib.map: the most device memory a build of the traced window
allocated, in GiB (torch.cuda.max_memory_allocated)."""


def read(obs):
    peak = obs.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
