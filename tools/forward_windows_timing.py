#!/usr/bin/env python3
"""Times the port's forward window kernels, B1 ``window_apply`` and B6
``rotmat_apply``, at one plan's shapes on one NVIDIA GPU.

    python3 tools/forward_windows_timing.py [--root DIR] [--n 24]

Imports ``qml_essentials_tpu_torch`` and ``chip_smoke`` from ``--root`` (by
default this checkout), builds its kernels, prints ptxas's lines for the
forward kernels and any wgmma warning, then for every window and rotmat call
of the n-qubit Circuit_19 plan (``chip_smoke.plan_shapes``): the kernel
against its plain version in float64 (max|err| / max|ref|, which must stay
within 1e-5), its time (CUDA events, best of 3 means of 10 after a warm-up),
the cuBLAS complex64 product of the same shapes (``torch.matmul``, TF32 off)
and the TFLOP/s issued in split TF32 (3 passes x 8K flops an amplitude).
Pointing ``--root`` at a second tree compares two versions of the kernels
in one call on one card.  Exits non-zero without CUDA or on a failed check.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

TOL = 1e-5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--n", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forward_windows_timing: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from qml_essentials_tpu_torch.ops import cuda_kernels as ck, kernels as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {args.root}  card: {smi}", flush=True)
    path, seconds = ck.build()
    print(f"built {path.name} in {seconds:.1f} s", flush=True)
    entry = None  # ptxas's lines for the forward kernels: registers, stack, spills
    for line in ck.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            entry = line if any(k in line for k in ("forward_wgmma", "WindowMap")) else None
            if entry:
                print(f"  {line.strip()}")
        elif entry and ("Used" in line or "spill" in line):
            print(f"    {line.strip()}")
        elif "wgmma" in line.lower():
            print(f"  ptxas: {line.strip()}")

    n = args.n
    shapes = cs.plan_shapes(n)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = cs.np.random.default_rng(cs.SEED)
    x = cs._state(n, gen)
    calls = [("window_apply", (a, k)) for a, k in shapes["window_apply"]]
    calls += [("rotmat_apply", (r,)) for r in shapes["rotmat_apply"]]
    totals, ok = {}, True
    for name, geom in calls:
        k = geom[-1]
        K, run = 2**k, 2 ** (n - sum(geom))
        w = cs._unitary(k, rng)
        kern = lambda: getattr(ck, name)(x, w, *geom, n)  # noqa: E731
        lib = cs.lib_window(x, w, *geom, n) if name == "window_apply" else \
            cs.lib_rotmat(x, w, *geom, n)
        y = kern()
        ref = getattr(kn, f"{name}_plain")(x.double(), w.double(), *geom, n)
        torch.cuda.synchronize()
        rel = ((y.double() - ref).abs().max() / ref.abs().max()).item()
        ok &= rel <= TOL
        del y, ref
        t_k, t_l = cs._events_ms(kern), cs._events_ms(lib)
        path_ = (("wgmma" if ck.forward_path(K, run) else "tile")
                 if hasattr(ck, "forward_path") else "-")
        tflops = 3 * 8 * K * 2**n / t_k / 1e9
        print(f"  {name:13s} {str(geom):8s} K={K:5d} run={run:6d} {path_:5s} rel {rel:.2e}  "
              f"kernel {t_k * 1e3:8.1f} us  library {t_l * 1e3:8.1f} us  "
              f"{tflops:6.1f} TFLOP/s issued", flush=True)
        tot = totals.setdefault(name, [0.0, 0.0])
        tot[0] += t_k
        tot[1] += t_l
    for name, (t_k, t_l) in totals.items():
        print(f"  total {name:13s} kernel {t_k:.3f} ms  library {t_l:.3f} ms per {n}q forward")
    print(f"card: {smi}")
    if not ok:
        print(f"forward_windows_timing: a kernel missed {TOL} against float64", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
