"""Spans and counters of the map build, throughput counters and device
tracing (port of remap_tpu/utils/profiling.py).

The reference's only observability is a wall-clock fps counter printed
every N callback invocations (main.cpp:54-110); :class:`PerfCounter`
gives the same step/total-average readout as the JAX package's.
:func:`device_trace` takes ``jax.profiler``'s place: a ``torch.profiler``
window that records the CPU side and, where CUDA is present, the card's
kernels, and writes a Chrome trace into ``log_dir``.

:func:`span` records a named stretch of the program on the host clock:
its start and end, its parent (the span open around it in the same
thread, or the one the thread adopted), the root it belongs to (a ``build`` for the map build's spans)
and its attributes; :func:`count` adds to a counter of the open span and
of its root.  Spans are stamped at stage, rung and batch boundaries,
never per frame or pixel.  A worker thread adopts the span that asked
for its work (:func:`current`, :func:`adopt`).  A span given a CUDA ``device`` also records
a CUDA event at each end, read only when :meth:`Span.device_ms` asks;
nothing else waits for the card.  While a ``torch.profiler`` runs, each
span is also a host range on its timeline, so the trace names what the
host was doing between the card's kernels.  The range is a
function-scope record (``_RecordFunctionFast``), not
``torch.profiler.record_function``'s user scope: for a user-scope range
Kineto adds a ``gpu_user_annotation`` on the card's timeline that spans
the range's kernels, which a trace would count as device activity.
Closed roots
stay in memory, the last :data:`MAX_ROOTS` of each name with everything
under them; :func:`recorder` returns them.  Recording is on unless
:func:`set_recording` turns it off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


class PerfCounter:
    """Step/total fps sampling (main.cpp:54-110 semantics)."""

    def __init__(self, name: str, sample_size: int = 100):
        self.name = name
        self.sample_size = sample_size
        self.total = 0
        self.sample = 0
        self.begin: Optional[float] = None
        self.last: Optional[float] = None

    def count(self, n: int = 1) -> None:
        if self.begin is None:
            self.begin = self.last = time.perf_counter()
        self.total += n
        self.sample += n
        if self.sample >= self.sample_size:
            self.report()

    def report(self) -> None:
        if self.begin is None or self.total == 0:
            return
        now = time.perf_counter()
        step_dt = max(now - (self.last or now), 1e-9)
        total_dt = max(now - self.begin, 1e-9)
        print(
            f"[{self.name} # {self.total:5d}] "
            f"step avg: {self.sample / step_dt:7.1f} fps; "
            f"total avg: {self.total / total_dt:7.1f} fps; "
            f"total: {total_dt:6.1f} s"
        )
        self.sample = 0
        self.last = now


class Trace:
    """One :func:`device_trace` window: ``path`` is its Chrome trace (set
    when the window closes), ``profile`` the ``torch.profiler`` object."""

    def __init__(self, log_dir: str, prof: profile):
        self.log_dir = log_dir
        self.profile = prof
        self.path: Optional[str] = None

    def top(self, n: int = 10, kind: str = "CUDA") -> List[Tuple[str, float]]:
        """The ``n`` operations with the most self time on ``kind``
        ("CUDA" kernels, or "CPU" operators), as (name, total ms), most
        first."""
        rows = []
        for e in self.profile.key_averages():
            if kind == "CUDA" and e.device_type.name == "CUDA":
                ms = e.device_time_total / 1e3
            elif kind == "CPU" and e.device_type.name == "CPU":
                ms = e.self_cpu_time_total / 1e3
            else:
                continue
            rows.append((e.key, ms))
        return sorted(rows, key=lambda r: -r[1])[:n]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace around a block; yields a :class:`Trace`
    and writes ``trace-<pid>-<ns>.json`` (Chrome trace format, for
    chrome://tracing or Perfetto) into ``log_dir`` (made if missing; by
    default ``remap_tpu_torch_trace`` in the temporary directory).  The
    card's kernels are recorded when CUDA is present."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "remap_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trace = Trace(log_dir, prof)
        yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace.path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(trace.path)


#: closed roots kept of each root name (``build``, ``png.write``, ...);
#: older ones, their spans and their CUDA events are dropped
MAX_ROOTS = 256

#: the kernel wrappers whose ``launches`` a build's counters read, by
#: module under ``remap_tpu_torch.ops.kernels``
_KERNELS = (("extract", "extract_dense_cuda"),
            ("extract", "extract_medians_cuda"),
            ("tables", "build_tables_cuda"),
            ("blit", "blit_frames_cuda"),
            ("cc", "label_components_cuda"),
            ("cc", "label_stats_cuda"),
            ("correlate", "fine_counts_cuda"))


def _launches() -> Dict[str, int]:
    out = {}
    for module, fn in _KERNELS:
        mod = importlib.import_module(f"remap_tpu_torch.ops.kernels.{module}")
        out[f"launches.{fn}"] = getattr(mod, fn).launches
    return out


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded stretch: ``start`` and ``end`` on ``time.perf_counter``
    (``end`` None while open), the ids of its parent (None for a root)
    and of its root, its attributes and its own counters."""

    id: int
    name: str
    parent: Optional[int]
    root: int
    attrs: dict
    start: float = 0.0
    end: Optional[float] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: (start, end) ``torch.cuda.Event``s, for a span given a CUDA device
    events: Optional[tuple] = None
    #: the CUDA stream the events are recorded on
    stream: object = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end is None else 1e3 * (self.end - self.start)

    def device_ms(self) -> Optional[float]:
        """Milliseconds of the card's stream between the span's two
        events, waiting for the end event; None without events."""
        if self.events is None or self.end is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _NullSpan:
    """What :func:`span` yields while recording is off."""

    def set(self, **attrs) -> None:
        pass


@dataclasses.dataclass(eq=False)
class Record:
    """A closed root: its spans (the root first, then every span under it
    in the order they opened) and its counters (those of :func:`count`
    under it and, for a ``build``, the kernel wrappers' launches while it
    ran)."""

    spans: List[Span]
    counters: Dict[str, int]

    @property
    def root(self) -> Span:
        return self.spans[0]

    def totals(self) -> Dict[str, float]:
        """Host milliseconds by span name, summed."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.host_ms
        return out


class Recorder:
    """The spans of every thread: each thread's stack of open spans, and
    the last :data:`MAX_ROOTS` closed roots of each name."""

    def __init__(self):
        self.enabled = True
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._roots: Dict[str, deque] = {}
        # a worker thread's spans join a record that another thread
        # appends to and counts in
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, attrs: dict, device=None) -> Span:
        stack = self._stack()
        sid = next(self._ids)
        if stack:
            parent, record = stack[-1]
            s = Span(sid, name, parent.id, parent.root, attrs)
            with self._lock:
                record.spans.append(s)
        else:
            s = Span(sid, name, None, sid, attrs)
            record = Record([s], _launches() if name == "build" else {})
        stack.append((s, record))
        s.start = time.perf_counter()
        if device is not None and torch.device(device).type == "cuda":
            s.stream = torch.cuda.current_stream(torch.device(device))
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record(s.stream)
        return s

    def close(self, s: Span) -> None:
        if s.events is not None:
            s.events[1].record(s.stream)
        s.end = time.perf_counter()
        stack = self._stack()
        _, record = stack.pop()
        if stack:
            return
        if s.name == "build":
            # the wrappers' cumulative counts, as deltas over the build
            for k, v in _launches().items():
                record.counters[k] = v - record.counters[k]
        with self._lock:
            roots = self._roots.get(s.name)
            if roots is None:
                roots = self._roots[s.name] = deque(maxlen=MAX_ROOTS)
            roots.append(record)

    def count(self, name: str, n: int = 1) -> None:
        stack = self._stack()
        if not stack:
            return
        s, record = stack[-1]
        with self._lock:
            s.counts[name] = s.counts.get(name, 0) + n
            record.counters[name] = record.counters.get(name, 0) + n

    def current(self) -> Optional[tuple]:
        stack = self._stack()
        return stack[-1] if stack else None

    def last(self, name: str) -> Optional[Span]:
        stack = self._stack()
        if not stack:
            return None
        for s in reversed(stack[0][1].spans):
            if s.name == name and s.end is not None:
                return s
        return None

    def records(self, name: str) -> List[Record]:
        return list(self._roots.get(name, ()))


_RECORDER = Recorder()
_NULL = _NullSpan()


@contextlib.contextmanager
def span(name: str, device=None, **attrs):
    """Record the block as a span named ``name`` with ``attrs``; yields the
    :class:`Span` (its ``set`` adds attributes).  With a CUDA ``device``
    the span also records an event on that device's current stream at
    each end."""
    rec = _RECORDER
    if not rec.enabled:
        yield _NULL
        return
    s = rec.open(name, attrs, device)
    try:
        # the module's flag is rebound while a profiler runs: read it here
        if torch.autograd.profiler._is_profiler_enabled:
            with torch._C._profiler._RecordFunctionFast(name):
                yield s
        else:
            yield s
    finally:
        rec.close(s)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open span and of its root;
    nothing while no span is open or recording is off."""
    if _RECORDER.enabled:
        _RECORDER.count(name, n)


def current() -> Optional[tuple]:
    """The innermost span open in this thread, with its root's record,
    for :func:`adopt` in another thread; None while no span is open or
    recording is off."""
    return _RECORDER.current() if _RECORDER.enabled else None


@contextlib.contextmanager
def adopt(held: Optional[tuple]):
    """Spans opened in this thread inside the block are children of
    ``held`` (what :func:`current` gave in the thread that asked for the
    work) and land in its root's record, not in roots of their own.
    ``held`` is not closed here, and may close first: a worker's span can
    outlast the span that asked for it.  With ``held`` None the block
    records as it would without."""
    if held is None:
        yield
        return
    stack = _RECORDER._stack()
    stack.append(held)
    try:
        yield
    finally:
        stack.pop()


def last(name: str) -> Optional[Span]:
    """The latest closed span ``name`` under this thread's open root, or
    None."""
    return _RECORDER.last(name)


def recorder(name: str = "build") -> List[Record]:
    """The closed roots named ``name``, oldest first (at most
    :data:`MAX_ROOTS`)."""
    return _RECORDER.records(name)


def set_recording(on: bool) -> bool:
    """Turn recording on or off; returns whether it was on.  Spans open
    when it turns off are still closed and kept."""
    was = _RECORDER.enabled
    _RECORDER.enabled = bool(on)
    return was

