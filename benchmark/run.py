"""The benchmark of ``qml_essentials_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json`` (its configuration, traffic mix,
limits and metrics: see ``benchmark/lib/cells.py``), sets it up from the seed,
measures a closed loop for ``--seconds``, checks the window's answers against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read after a profiled
slice of further requests), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number with its limit, also printed as
the last lines of standard error.

Exits non-zero, printing no result, without enough CUDA cards, or when JAX or
the JAX package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "qml_essentials_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``qml_essentials_tpu_torch`` is not
    ``qml_essentials_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, run: dict) -> dict:
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    info = {"platform": "gpu", "kind": kind, "count": run["chips"],
            "memory_peak_bytes": int(run["process_peak_bytes"])}
    if run["trace"] is not None:
        info["busy_s"] = run["trace"]["busy_s"]
        info["window_s"] = run["trace"]["window_s"]
    return info


def execute(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure, check: the result line of one run on ``device``."""
    import torch

    from benchmark.lib import cells

    run = cells.loop(cell["traffic"]).run(cell, seed, seconds, trace, device, T_START)
    if run.get("diagnostics"):
        print(f"not compared: {json.dumps(run['diagnostics'])}", file=sys.stderr)
    checks = {name: {"value": float(value), "limit": cell["limits"][name]}
              for name, value in run["readings"].items()}
    correct = (run["failed"] == 0 and run["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    kind = "per_layer" if trace else "end_to_end"
    result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": cells.metrics(cell, run, kind), "device": device_info(torch, run)}
    if trace and run["trace"] is not None:
        result["breakdown"] = {k: run["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import cells, program

    cell = cells.load(args.workload, ROOT)
    os.environ.update(cell["config"].get("env", {}))
    import torch

    program.stage("torch imported", T_START)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
