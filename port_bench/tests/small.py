"""Cells cut to a size a CPU test run holds, and one run of them."""

from __future__ import annotations

import copy
import glob
import os
import time

import torch

from port_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

torch.set_num_threads(2)


def bench() -> dict:
    """``BENCHMARK.json`` with the entries of each dormant cell added to
    its lists: ``dormant/<cell>.json`` holds those of a cell whose files
    are kept, and tested here, though ``BENCHMARK.json`` does not name
    it."""
    out = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for path in sorted(glob.glob(os.path.join(harness.HERE, "dormant",
                                              "*.json"))):
        for key, entries in harness.load_json(path).items():
            out[key] = out[key] + entries
    return out


def cell(name: str, frames: int = 40, margin: int = 200):
    """(benchmark, cell, configuration, workload) of ``name`` at a small
    size: 96x72 C64 frames in batches of 8, or 96x64 NES frames."""
    benchmark, entry, config, workload = harness.cell_files(ROOT, name,
                                                         bench())
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    if config["session"]["recipe"] == "render":
        config["pipeline"].update(screen_width=96, screen_height=72,
                                  frame_batch=8, region_capacity=2048,
                                  splice_capacity=4096)
        config["session"].update(frames=frames, world_margin=margin,
                                 hud_rows=8, border=4, sprites=2,
                                 sprite_size=5)
        if workload["traffic"].get("noise_at") is not None:
            workload["traffic"]["noise_at"] = frames // 2
    else:
        config["pipeline"].update(screen_width=96, screen_height=64,
                                  frame_batch=8, region_capacity=512)
        config["atlas_pad"] = 32
        config["session"].update(frames=32, world_margin=100)
    return benchmark, entry, config, workload


def run(name: str, tmp_path, seed: int = 5, seconds: float = 0.5,
        trace: bool = False, **size):
    benchmark, entry, config, workload = cell(name, **size)
    options = {"profile_steps": 4} if workload["driver"] == "stream_step" \
        else {}
    return harness.run_cell(benchmark, entry, config, workload, seed,
                            seconds, trace, "cpu", time.perf_counter(),
                            str(tmp_path), **options)[0]
