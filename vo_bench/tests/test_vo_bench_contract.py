"""BENCHMARK.json keeps the contract's shape, and every cell, configuration, traffic mix,
limit and per-layer metric it names resolves to its files by name."""

import json
import os
import re

import pytest

from vo_bench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vo_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = run.find_cell(cell)
    w = spec["cell"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert spec["traffic"]["mode"] in ("replay", "live")
    assert spec["limits"]["pose_gap"] > 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in spec["per_layer"]:
        assert m["moves"] in names, (cell, m["name"])      # each cell reports what it moves
    assert spec["per_layer"], cell


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vo_bench/") and os.path.exists(os.path.join(run.ROOT, c["file"]))
        doc = run.load_json(run.ROOT, c["file"])
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert callable(run.reader(m["name"]))
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(run.HERE, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"^\s*(from|import)\s+(lcvo_tpu|jax)\b", src, re.M), f
