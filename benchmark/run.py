"""Run one cell of the benchmark of spcies_tpu_torch once, on the machine
it is started on, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

The cell is an entry of BENCHMARK.json's workloads. With --trace 0 the
last line of standard output is the result with the cell's end-to-end
metrics, with --trace 1 with its per-layer metrics, read under the
device profiler; the numbers `correct` compared, each with its limit,
are the last lines of standard error and the result's last key. The run
needs the CUDA devices the cell asks for, and exits with another code
than 0, printing no result, without them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
# few host threads: one caller, steady host work
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "2")
# caches of the toolchain, at fixed paths inside the checkout
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from harness import runner
    sys.exit(runner.main(parse(), T_PROCESS))
