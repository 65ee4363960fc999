"""Cells found by name: ``BENCHMARK.json`` at the checkout's root names each
cell's configuration and traffic mix; the files are

* ``benchmark/configs/<config>.json`` (the entry's ``file``): the model's
  sizes, noise, dtype, its reference (``benchmark/reference/<reference>.py``);
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, and the loop
  that drives it (``benchmark/loops/<loop>.py``);
* ``benchmark/limits/<cell>.json``: each compared number's limit;
* ``benchmark/metrics/<metric>.py``: a reader per metric.

Adding a cell, configuration, mix or metric adds files and entries; no file
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports; KeyError for a name ``BENCHMARK.json`` lacks."""
    s = spec(root)
    found = [w for w in s["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    entry = next(c for c in s["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": _json(root / entry["file"]),
        "traffic": _json(bench / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(bench / "limits" / f"{name}.json"),
        "end_to_end": [m for m in s["end_to_end"] if _reports(m, name)],
        "per_layer": [m for m in s["per_layer"] if _reports(m, name)],
    }


def _module(path: Path, name: str):
    spec_ = importlib.util.spec_from_file_location(name, path)
    if spec_ is None or spec_.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def loop(traffic: dict):
    """The loop module that drives a traffic mix."""
    return _module(BENCH / "loops" / f"{traffic['loop']}.py", f"benchmark_loop_{traffic['loop']}")


def reference(config: dict):
    """The configuration's plain reference module."""
    return _module(BENCH / "reference" / f"{config['reference']}.py",
                   f"benchmark_reference_{config['reference']}")


def reader(metric: str) -> Callable[[dict], object]:
    """``read(run)`` of ``benchmark/metrics/<metric>.py``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _module(BENCH / "metrics" / f"{metric}.py", f"benchmark_metric_{safe}").read


def metrics(cell: dict, run: dict, kind: str) -> Dict[str, dict]:
    """Each metric of ``kind`` (``end_to_end`` or ``per_layer``) that its
    reader finds, with its unit; a reader that finds nothing is left out."""
    out: Dict[str, dict] = {}
    for m in cell[kind]:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def names(root: Path = ROOT) -> List[str]:
    return [w["name"] for w in spec(root)["workloads"]]
