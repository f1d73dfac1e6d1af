"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its file: a configuration, a traffic mix and limits for each cell,
a reader for each metric."""

import json
import re

from harness.spec import BENCH, ROOT, Cell, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["why"])
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file()
        names.add(c["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        names.add(m["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        names.add(w["name"])
    assert len(names) == (len(b["configs"]) + len(b["workloads"])
                          + len(b["end_to_end"]) + len(b["per_layer"]))


def test_bounds_and_metrics_of_each_cell():
    b = benchmark()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    used_configs = set()
    for w in b["workloads"]:
        cell = Cell(w["name"], b)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        used_configs.add(w["config"])
    assert used_configs == {c["name"] for c in b["configs"]}
