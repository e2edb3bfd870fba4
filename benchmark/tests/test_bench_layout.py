"""BENCHMARK.json keeps the contract's shape, and every name in it finds its file under benchmark/."""

from __future__ import annotations

import json
import re

import pytest
from bench_helpers import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/configs/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(data["reduced"])
    assert names == {w["config"] for w in bench["workloads"]}


def test_workloads_find_their_files(bench):
    seen = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert spec["name"] == w["name"] and spec["config"] == w["config"] and spec["chips"] == w["chips"]
        assert spec["why"] == w["why"]
        assert (BENCH / "drivers" / f"{spec['driver']}.py").is_file()


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m["name"] for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


def test_each_metric_reader_returns_nothing_from_an_empty_run():
    import run

    record = {"recorder": None, "outcome": {}, "device": {"window_s": 0, "busy_s": 0, "by_op": {}}}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        if path.stem in ("stft_s_per_figure",):
            continue
        assert run.load_module(path).read(record) is None, path.name


def test_paths_hold_only_names_the_contract_allows():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
