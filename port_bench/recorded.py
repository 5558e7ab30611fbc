"""Readers of spans and counters that a version of the program may not
record at all.  ``port_bench/spans.py`` reads a span or counter a build
lacks as 0; these read None instead where no build of the window
records the ``marker`` (a span name or a counter the version records in
every build that runs the layer), so that a version without the
instrumentation reports nothing rather than a zero."""

from __future__ import annotations

from typing import Optional

from port_bench import spans


def _marked(obs: dict, marker: str) -> bool:
    records = spans.window_builds(obs)
    return bool(records) and any(
        marker in r.counters or any(s.name == marker for s in r.spans)
        for r in records)


def span_ms(obs: dict, name: str) -> Optional[float]:
    """Mean host ms a build in the spans ``name``, or None where no build
    of the window has one."""
    return spans.span_ms(obs, name) if _marked(obs, name) else None


def counter(obs: dict, name: str, marker: str) -> Optional[float]:
    """Mean count a build of the counter ``name`` (0 in a build that
    counts none), or None where no build of the window records
    ``marker``."""
    return spans.counter(obs, name) if _marked(obs, marker) else None
