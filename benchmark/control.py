"""Readings that set a cell's limits (not run by the benchmark's own runs).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each ``--seeds`` seed: the program's compared numbers at the cell's own
size (a training cell's checked steps, a serving cell's check after a
``--seconds`` window at its load), in this one process.  For each
``--control-seeds`` seed: the same numbers with the reference computed in
TF32 (the next precision below the configuration's float32) put in the
program's place, and for a training cell the faults planted in the float64
reference put there (half of each batch left out, the gradient negated, every
step at the first step's parameters).  Prints one JSON line a reading and the
largest program reading and smallest control reading of each number.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import cells, program

    cell = cells.load(args.workload, ROOT)
    loop = cells.loop(cell["traffic"])
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    worst, least = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        if cell["traffic"]["loop"] == "train":
            r = loop.run(cell, seed, 0.0, False, device, t0)
        else:
            r = loop.run(cell, seed, args.seconds, False, device, t0)
        for k, v in r["readings"].items():
            worst[k] = max(worst.get(k, 0.0), float(v))
        _emit(out, kind="program", seed=seed, readings=r["readings"], failed=r["failed"],
              look=r.get("diagnostics"), seconds=time.perf_counter() - t0)
        program.free(device)
    for seed in controls:
        t0 = time.perf_counter()
        for kind, got in control_readings(cell, loop, seed, device).items():
            for k, v in got.items():
                least.setdefault(kind, {})
                least[kind][k] = min(least[kind].get(k, float("inf")), float(v))
            _emit(out, kind=kind, seed=seed, readings=got, seconds=time.perf_counter() - t0)
        program.free(device)
    _emit(out, kind="summary", cell=args.workload, program_max=worst, control_min=least,
          device=torch.cuda.get_device_name(0))
    return 0


# The faults planted in the float64 reference put in a training program's
# place, by the keyword of ``reference_steps`` that plants each.
TRAIN_FAULTS = {"fault_half_batch": "half_batch", "fault_negated_gradient": "negated",
                "fault_stale_parameters": "stale"}


def control_readings(cell: dict, loop, seed: int, device) -> dict:
    """The numbers of the TF32 reference (and, training, of each planted
    fault) in the program's place, against the float64 reference."""
    import torch

    from benchmark.lib import cells, program

    cfg, traffic = cell["config"], cell["traffic"]
    ref = cells.reference(cfg)
    gen = program.generator(seed, device)
    params = program.parameters(cfg, ref.params_shape(cfg), gen, device)
    if traffic["loop"] == "train":
        count = int(traffic["check_steps"])
        xs = torch.rand((count, traffic["batch"]), generator=gen, device=device,
                        dtype=params.dtype)
        xs = xs * (traffic["input_high"] - traffic["input_low"]) + traffic["input_low"]
        ys = torch.sin(torch.pi * xs)
        p0, xs, ys = params.cpu(), xs.cpu(), ys.cpu()
        stand_ins = {"control_tf32": {"precision": "tf32"}}
        stand_ins.update({kind: {kw: True} for kind, kw in TRAIN_FAULTS.items()})
        return {kind: loop.judge(cell, loop.reference_steps(cell, p0, xs, ys, device, **kw),
                                 p0, xs, ys, device)[0]
                for kind, kw in stand_ins.items()}
    k = int(traffic["check_requests"])
    xs = loop.inputs(traffic, seed, k)
    sim = ref.simulator(cfg, "tf32", device)
    answers = [sim.forward(params.to(device, sim.rdtype),
                           torch.tensor([float(x)], dtype=sim.rdtype, device=device))[0]
               .double().cpu().numpy() for x in xs]
    return {"control_tf32": {"expval_gap": loop.expval_gap(cell, params.cpu(), xs, answers,
                                                           device)}}


if __name__ == "__main__":
    sys.exit(main())
