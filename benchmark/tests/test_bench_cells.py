"""Cells, configurations, mixes and metrics are found by name, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.lib import cells

ROOT = cells.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads(name):
    cell = cells.load(name)
    assert cell["traffic"]["loop"] in ("train", "serve")
    assert (ROOT / "benchmark" / "loops" / f"{cell['traffic']['loop']}.py").exists()
    assert (ROOT / "benchmark" / "reference" / f"{cell['config']['reference']}.py").exists()
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(cells.reader(m["name"]))
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell, configuration, mix and metric added as files and entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "circuit19_24q.json").read_text())
    cfg.update(name="circuit19_22q", n_qubits=22)
    (bench / "configs" / "circuit19_22q.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "serve.json").read_text())
    (bench / "traffic" / "serve_b16.json").write_text(json.dumps(dict(traffic, pool=16)))
    (bench / "limits" / "circuit19_22q.serve_b16.json").write_text('{"expval_gap": 1e-5}')
    (bench / "metrics" / "answers.py").write_text("def read(run):\n    return run['circuits']\n")
    spec["configs"].append({"name": "circuit19_22q", "source": "s", "reduced": [], "why": "w",
                            "file": "benchmark/configs/circuit19_22q.json"})
    spec["workloads"].append({"name": "circuit19_22q.serve_b16", "config": "circuit19_22q",
                              "traffic": "serve_b16", "chips": 1, "why": "w"})
    spec["per_layer"].append({"name": "answers", "unit": "circuits", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "setup_s",
                              "workloads": ["circuit19_22q.serve_b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load("circuit19_22q.serve_b16", tmp_path)
    assert cell["config"]["n_qubits"] == 22 and cell["traffic"]["pool"] == 16
    assert [m["name"] for m in cell["per_layer"]] == ["answers"]
    assert "circuit19_22q.serve_b16" in cells.names(tmp_path)
    with pytest.raises(KeyError):
        cells.load("no_such.cell", tmp_path)


def test_metrics_leave_out_what_they_cannot_read():
    cell = cells.load(SPEC["workloads"][0]["name"])
    run = {"trace": None, "flops": 0.0, "window_s": 1.0, "chips": 1, "circuits": 0,
           "launches": {}, "latencies_s": [], "steps": None, "peak_bytes": 0, "setup_s": 2.0}
    assert cells.metrics(cell, run, "per_layer") == {}
    assert cells.metrics(cell, run, "end_to_end") == {"setup_s": {"value": 2.0, "unit": "s"}}


def test_contract():
    s = SPEC
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"] and s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    cells_n = len(s["workloads"])
    assert 2 + 14 * 24 * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == [] and any(w["config"] == c["name"] for w in s["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, cells_n // 4)
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            cell = cells.load(w)
            assert m["moves"] in {x["name"] for x in cell["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    allnames = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(allnames) == len(set(allnames))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
