"""Device milliseconds of the program's spans, from the CUDA events a
span given a device records at each end (``Span.device_ms``), through
``port_bench/spans.py``'s window of builds."""

from __future__ import annotations

from typing import Optional

from port_bench.spans import mean_per_build


def device_ms_under(obs: dict, name: str, parent: str) -> Optional[float]:
    """Mean device ms a build of the spans ``name`` opened directly under
    a span ``parent``; None where a build has no such span, or one of
    them has no events (the CPU, or a version without the spans)."""
    missing = []

    def total(record):
        under = {s.id for s in record.spans if s.name == parent}
        ms = [s.device_ms() for s in record.spans
              if s.name == name and s.parent in under]
        if not ms or None in ms:
            missing.append(record)
            return 0.0
        return sum(ms)

    mean = mean_per_build(obs, total)
    return None if missing else mean
