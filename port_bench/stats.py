"""Order statistics of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(len(ordered) * q / 100) - 1)]

