#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, and print its result as the last line of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the checkout's root.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  Without enough
CUDA devices it exits non-zero and prints no result.  See README.md.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this folder, is where modules come from
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]
# kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".port_bench_cache", sub)

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED, ROOT))
