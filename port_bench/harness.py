"""One run of one cell: find its files by name, set up, measure, check,
and print the result line.

``BENCHMARK.json`` at the checkout's root names the cell's configuration
and the metrics it reports.  The rest is found by name under
``port_bench/``:

- ``configs/<config>.json``: the deployment (the pipeline's settings and
  the session's sizes), as the ``file`` of the configuration says;
- ``workloads/<cell>.json``: the entry driver (``drivers/<driver>.py``),
  the traffic mix's parameters and the limit of each number compared;
- ``metrics/<name>.py``: each per-layer metric's reader, ``read(obs)``,
  which returns a number or None from what the traced run observed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules a run may not hold: JAX, the JAX package and its
#: benchmarks, compared by the whole name before the first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "remap_tpu", "bench", "chip_smoke",
             "benchmarks")


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: str, name: str, bench: dict = None):
    """(benchmark, cell entry, configuration, workload file) of ``name``,
    a cell of ``bench`` (by default the root's ``BENCHMARK.json``)."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    workload = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    return bench, cell, config, workload


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class PowerQuery:
    """``nvidia-smi``'s card name, power limit and top SM clock, asked in
    the background while the run sets up, so the query adds nothing to
    ``setup_s``."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            self.proc, self.error = None, str(e)

    def line(self) -> str:
        if self.proc is None:
            return f"nvidia-smi unavailable: {self.error}"
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return "nvidia-smi gave no answer in 30 s"
        return out.strip()


def cpu_seconds() -> float:
    """This process's CPU seconds, every thread's, user and system."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def run_cell(bench: dict, cell: dict, config: dict, workload: dict,
             seed: int, seconds: float, trace: bool, device: str,
             started: float, workdir: str, **options) -> tuple:
    """Set up, measure and check one run on ``device``; ``options`` go to
    the driver.  Returns (result line, check lines)."""
    import torch

    module = importlib.import_module(
        f"port_bench.drivers.{workload['driver']}")
    drv = module.Driver(config, workload["traffic"], seed, device, workdir,
                        trace, **options)
    before = time.perf_counter() - started
    try:
        drv.setup()
        setup_s = time.perf_counter() - started
        t0, cpu0 = time.perf_counter(), cpu_seconds()
        e2e = drv.window(seconds)
        host = ("process cpu over the window "
                f"{(cpu_seconds() - cpu0) / (time.perf_counter() - t0):.3f}"
                " cores")
        if trace:
            drv.profile()
        found = forbidden_modules()
        if found:
            raise RuntimeError("the run loaded " + ", ".join(found))
        cuda = torch.device(device).type == "cuda"
        peak = max(getattr(drv, "run_peak", 0),
                   torch.cuda.max_memory_allocated() if cuda else 0)
        t0 = time.perf_counter()
        checks = drv.check()
        notes = [f"setup seconds before the driver {before:.3f}, host "
                 f"threads {torch.get_num_threads()}, check seconds "
                 f"{time.perf_counter() - t0:.3f}", host] + drv.notes()
    finally:
        drv.close()
    limits = workload["limits"]
    correct = all(checks[k] <= limits[k] for k in limits) and set(
        checks) == set(limits)
    name = cell["name"]
    metrics = {}
    if not trace:
        for m in metrics_of(bench, name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, name, "per_layer"):
            value = reader(m["name"])(drv.observations)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = e2e.get("builds", e2e.get("steps"))
    failed = getattr(drv, "failed_builds", getattr(drv, "failed_steps", 0))
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace:
        prof = drv.observations["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    lines = notes + [f"check {k} {checks[k]} (limit {limits[k]})"
                     for k in limits]
    return result, lines


def control_checks(config: dict, workload: dict, seed: int, seconds: float,
                   device: str, workdir: str) -> tuple:
    """(sound numbers, control numbers) of one run of a cell: the numbers
    the program's outputs give against the reference, and those they
    give against the reference with its uint16 vote counters narrowed to
    uint8.  The program equals the first reference wherever the sound
    numbers read 0, so the second reading is that of the narrowed
    reference put in the program's place."""
    module = importlib.import_module(
        f"port_bench.drivers.{workload['driver']}")
    drv = module.Driver(config, workload["traffic"], seed, device, workdir,
                        False)
    try:
        drv.setup()
        drv.window(seconds)
        return drv.check(), drv.check(bits=8)
    finally:
        drv.close()


def main(argv, started: float, root: str) -> int:
    args = parse(argv)
    bench, cell, config, workload = cell_files(root, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    power = PowerQuery()
    workdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        result, lines = run_cell(bench, cell, config, workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda",
                                 started, workdir)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        print(f"card: {power.line()}", file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print("the run loaded " + ", ".join(found), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
