"""BENCHMARK.json against the benchmark's contract: its keys, names, units and
lengths, and that every configuration, mix, cell check and metric reader it
names is a file the harness finds."""
from __future__ import annotations

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == TOP
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) for p in manifest["paths"])
    for word in manifest["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        mine = [n for n, _ in harness.metrics_of(manifest, cell, False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.metrics_of(manifest, cell, True)
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells and ("workloads" not in moved or cell in moved["workloads"])
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", ["encode.sgpt-5.8b.beir-docs", "encode.sgpt-bloom-7b1.beir-docs",
                                  "rerank.sgpt-5.8b.bm25-top100", "search.sgpt-5.8b.nq-poisson"])
def test_cell_files_are_found_by_name(manifest, cell):
    spec = harness.cell(manifest, cell)
    assert spec["config"]["name"] == spec["entry"]["config"]
    assert spec["config"]["reduced"] == next(
        c["reduced"] for c in manifest["configs"] if c["name"] == spec["entry"]["config"])
    assert harness.driver_class(spec["mix"]).kind == spec["mix"]["driver"]
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    for trace in (False, True):
        for name, _ in harness.metrics_of(manifest, cell, trace):
            assert callable(harness.reader(name))


def test_files_under_paths_are_named_from_name_characters():
    for p in (harness.ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
