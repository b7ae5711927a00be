"""BENCHMARK.json against the contract's shape, and every cell, mix and
metric found by name; a cell added from data alone runs."""
import json
import re
import shutil

import pytest

from benchmarks import harness
from benchmarks.tests.helpers import small_config

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmarks/run.py"]
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/") and (harness.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} == {"setup_s", "frames_per_s", "call_p95_ms"}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves and m["layer"] and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    suite = harness.Suite.load()
    cell = suite.cell(name)
    assert cell.config["canny"]["height"] > 0
    assert cell.traffic.in_flight >= 1
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "frames_per_s", "call_p95_ms"]
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(suite.reader(m["name"]))
        assert m["moves"] in [e["name"] for e in cell.end_to_end]


def test_a_cell_added_from_data_alone_runs(tmp_path):
    """A new mix and cell are two data files and an entry: no code edit."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(harness.BENCH_DIR / "traffic", bench / "traffic")
    shutil.copytree(harness.BENCH_DIR / "metrics", bench / "metrics")
    (bench / "traffic" / "pair_calm.json").write_text(json.dumps(
        {"scenes": 2, "times": 2, "batch": 2, "batched": True, "in_flight": 3, "check_calls": 2}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "cam1080p.pair_calm", "config": "cam1080p",
                              "traffic": "pair_calm", "chips": 1, "why": "two cameras a call"})
    suite = harness.Suite(spec, harness.ROOT, bench)
    cell = suite.cell("cam1080p.pair_calm")
    assert cell.traffic.batch == 2
    r = harness.run_cell(suite, "cam1080p.pair_calm", 5, 0.2, False, device="cpu",
                         config=small_config(cell))
    assert r["correct"] and r["attempted"] == 2 * r["run"]["calls"]
    assert r["checks"]["frames_compared"]["value"] == 4
