"""Helpers the per-layer readers (``metrics/<name>.py``) share.  Each
takes the driver's observations and returns a number, or None where the
run observed nothing to read."""

from __future__ import annotations

import statistics
from typing import Optional

from port_bench import roofline


def stage_ms(obs: dict, stage: str) -> Optional[float]:
    """A stage's mean milliseconds a build over the traced window: its
    total over all builds (so the host clock spans many stages) over the
    builds."""
    times = (obs.get("stage_s") or {}).get(stage)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)


def idle_share(obs: dict) -> Optional[float]:
    prof = obs.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def kernel_seconds(obs: dict, *names: str) -> Optional[float]:
    """Device seconds a step of the kernels whose names contain any of
    ``names``, in the profiled steps."""
    prof = obs.get("profile")
    if not prof or not prof.get("steps"):
        return None
    total = sum(s for k, (_, s) in prof["kernels"].items()
                if any(n in k for n in names))
    return total / prof["steps"] if total > 0 else None


def roofline_share(obs: dict, kernel: str, *names: str) -> Optional[float]:
    seconds = kernel_seconds(obs, *names)
    if seconds is None:
        return None
    return roofline.share(obs["profile"]["bytes_per_step"][kernel], seconds)


def median_ms(obs: dict, key: str) -> Optional[float]:
    values = obs.get(key)
    return statistics.median(values) if values else None
