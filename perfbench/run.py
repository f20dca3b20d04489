#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result's line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (see perfbench/core/cli.py). Build and kernel
caches stay inside the checkout, under build/.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                              "triton")
sys.path.insert(0, ROOT)

from perfbench.core.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
