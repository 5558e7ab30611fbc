"""A ``torch.profiler`` window, reduced to what the metrics read.

``profiled(fn, device)`` runs ``fn`` once between two waits for the card
under the profiler and returns its result and a dict:

- ``window_s``: the window's length on the host clock;
- ``busy_s``: the union of the device's activity (kernels, copies,
  sets) in the window, each interval counted once;
- ``kernels``: ``{name: (launches, device seconds)}``;
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest gaps between device activity, each
  named by the innermost host operation running at its middle.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end), overlaps once."""
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    cursor = lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def short_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0][:80]


def profiled(fn: Callable, device) -> tuple:
    dev = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    return result, reduce(prof.events(), window_s)


def reduce(events, window_s: float) -> dict:
    device, host = [], []
    kernels: Dict[str, List[float]] = {}
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            device.append((start, end))
            k = kernels.setdefault(short_name(e.name), [0, 0.0])
            k[0] += 1
            k[1] += end - start
        else:
            host.append((start, end, e.name))
    busy = union_seconds(device)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    idle = []
    if device and host:
        lo = min(a for a, _, _ in host)
        hi = max(b for _, b, _ in host)
        longest = sorted(gaps(device, lo, hi), key=lambda g: g[0] - g[1])
        for a, b in longest[:10]:
            mid = (a + b) / 2
            inner = [(hb - ha, name) for ha, hb, name in host
                     if ha <= mid <= hb]
            idle.append([min(inner)[1] if inner else "host", b - a])
    return {"window_s": window_s, "busy_s": busy,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[k, v[1]] for k, v in top],
            "idle_gaps": idle}
