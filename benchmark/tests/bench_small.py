"""Small cells for the CPU tests: a BENCHMARK.json cell with its traffic
cut to a size a test run holds."""

import time

from harness import runner
from harness.spec import Cell

SMALL = {
    "laxmpc_admm.sweep": dict(batch=512, pool=2),
    "hmpc_split.sweep": dict(batch=512, pool=1),
    "laxmpc_admm.fleet_shift": dict(batch=512, pool=1, steps=4),
    "hmpc_split.step_b1024": dict(batch=512, pool=1),
}
SEED = 2 ** 31 + 77


def small_run(name: str, seconds: float = 0.05, trace: bool = False,
              **kw) -> dict:
    """One run of the cell on the CPU at its small size."""
    return runner.run(Cell(name), SEED, seconds, trace, device="cpu",
                      t_process=time.perf_counter(),
                      traffic_override=SMALL[name], **kw)
