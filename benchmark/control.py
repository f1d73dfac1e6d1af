"""The control of `correct`: the plain reference put in the program's
place and computed in the nearest precision below the configuration's
float32 with TF32 off, that is with TF32 products (float32 element-wise
work), on every pool batch a run draws from the seed. Each answer is
compared with the float64 reference's, by the cell's own limits, as a
run compares the program's; the control has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed, then one with the smallest reading of each
number over the seeds (the upper reading the limits are set below). On a
CUDA device the products run on the card's TF32 path; on the CPU they
read operands rounded to TF32 (benchmark/reference/common.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def readings(cell, seed: int, device, traffic_override=None) -> dict:
    """The control's numbers on one seed: {name: {"value", "limit"}}."""
    from harness import compare
    from harness.spec import load_module
    from harness.traffic import draw_pool
    from reference.common import Arith, plant_matrices

    traffic = dict(cell.traffic, **(traffic_override or {}))
    ref = load_module("reference", cell.config["reference"])
    problem = ref.Problem(cell.config)
    A, B = plant_matrices(cell.config)
    pool = draw_pool(traffic, A, B, seed)
    expected = compare.expected_answers(ref, problem, traffic, pool,
                                        Arith("fp64", device))
    control = compare.expected_answers(ref, problem, traffic, pool,
                                       Arith("tf32", device))
    records = [dict(pool=p, out=out) for p, out in enumerate(control)]
    return compare.numbers(cell.limits, records, dict(enumerate(expected)))


def main(argv=None) -> int:
    from harness import compare
    from harness.spec import Cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    least: dict = {}
    for seed in args.seeds:
        nums = readings(cell, seed, args.device)
        print(json.dumps(dict(seed=seed, correct=compare.passed(nums),
                              checks=nums)), flush=True)
        for name, v in nums.items():
            least[name] = min(least.get(name, v["value"]), v["value"])
    print(json.dumps(dict(workload=cell.name, seeds=args.seeds,
                          smallest=least)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
