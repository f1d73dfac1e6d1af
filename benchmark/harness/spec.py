"""What a run reads from the repository: BENCHMARK.json at the root of
the checkout, and the files the benchmark keeps for each configuration,
traffic mix, cell and metric, each found by its name:

    benchmark/configs/<config>.json   the configuration (BENCHMARK.json's
                                      "file" of that configuration)
    benchmark/traffic/<traffic>.json  the traffic mix's parameters
    benchmark/limits/<cell>.json      the numbers `correct` compares, each
                                      with its limit and the readings it
                                      was set from
    benchmark/metrics/<metric>.py     the reader of one metric
    benchmark/reference/<name>.py     a formulation's plain reference
    benchmark/work/<kernel>.py        a kernel's operations and bytes
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    traffic, limits and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]
