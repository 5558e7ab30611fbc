"""What a run may load and where it may run."""

import ast
import json
import os
import pathlib
import subprocess
import sys

from port_bench import harness
from port_bench.tests import small

PKG = pathlib.Path(harness.HERE)
ROOT = PKG.parent


def imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in imported(path)}
        assert not tops & {"remap_tpu_torch", "remap_tpu", "jax"}, path


def test_no_file_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {n.split(".")[0] for n in imported(path)}
        assert not tops & set(harness.FORBIDDEN), path


GUARD = """
import importlib, pathlib, sys, tempfile, time
sys.path.insert(0, {root!r})
from port_bench import harness
from port_bench.tests import small
pkg = pathlib.Path(harness.HERE)
for path in sorted(pkg.rglob("*.py")):
    rel = path.relative_to(pkg.parent).with_suffix("")
    if path.parent.name == "metrics":
        harness.reader(path.stem)
    elif "tests" not in rel.parts and path.name != "run.py" \\
            and path.name != "control.py":
        importlib.import_module(".".join(rel.parts).replace(
            ".__init__", ""))
from port_bench.tests import small
small.run("nes_stream_ingest", tempfile.mkdtemp())
print("loaded:" + ",".join(harness.forbidden_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:", out.stdout


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(PKG / "run.py"), "--workload",
         "c64_map_clean", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_named_file_exists():
    bench = small.bench()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        wl = json.loads((PKG / "workloads" / f"{w['name']}.json").read_text())
        assert (PKG / "drivers" / f"{wl['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
