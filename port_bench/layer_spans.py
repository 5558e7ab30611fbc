"""Sums a build of the program's spans and counters for the readers of
single layers, through ``port_bench/spans.py``'s window of builds.  Each
returns None where a build of the window has none of what it reads (a
version without those spans or counters)."""

from __future__ import annotations

from typing import Optional, Sequence

from port_bench.spans import mean_per_build


def _under(record, names: Sequence[str], parents: Optional[Sequence[str]]):
    """The spans named ``names`` of a build, opened directly under a span
    named in ``parents`` (anywhere when ``parents`` is None)."""
    if parents is None:
        return [s for s in record.spans if s.name in names]
    ids = {s.id for s in record.spans if s.name in parents}
    return [s for s in record.spans if s.name in names and s.parent in ids]


def host_ms(obs: dict, names: Sequence[str],
            parents: Optional[Sequence[str]] = None) -> Optional[float]:
    """Mean host ms a build of the spans ``names`` under ``parents``."""
    missing = []

    def total(record):
        found = _under(record, names, parents)
        if not found:
            missing.append(record)
        return sum(s.host_ms for s in found)

    mean = mean_per_build(obs, total)
    return None if missing else mean


def device_ms(obs: dict, name: str,
              parents: Sequence[str]) -> Optional[float]:
    """Mean device ms a build of the spans ``name`` under ``parents``,
    each timed between its CUDA events; None also where one of them has
    no events (the CPU)."""
    missing = []

    def total(record):
        ms = [s.device_ms() for s in _under(record, (name,), parents)]
        if not ms or None in ms:
            missing.append(record)
            return 0.0
        return sum(ms)

    mean = mean_per_build(obs, total)
    return None if missing else mean


def counter(obs: dict, name: str) -> Optional[float]:
    """Mean count a build of the program's counter ``name``."""
    missing = []

    def total(record):
        if name not in record.counters:
            missing.append(record)
            return 0
        return record.counters[name]

    mean = mean_per_build(obs, total)
    return None if missing else mean
