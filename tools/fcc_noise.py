#!/usr/bin/env python3
"""FCC Fig. 3a on the CPU, per package, precision and seed.

    python3 tools/fcc_noise.py [--circuits Hardware_Efficient,Circuit_17]
        [--samples 500] [--seeds 1] [--dtypes float32,float64] [--jax]

Runs ``FCC.get_fcc(model, n_samples, scale=True)`` on the 6-qubit, one-layer,
RY-encoded models of ``tests/test_golden.py:352-376`` (2^6 x samples
parameter sets x 13 grid inputs) with the PyTorch port on the CPU in each
dtype, and with ``--jax`` the JAX package (float32, its default) too, one
line per run.  With ``--same-coefficients`` it also feeds one set of
coefficients (the JAX package's, from its parameters) to both packages'
fingerprint code, which must agree exactly.  Circuits whose coefficients
vanish in exact arithmetic (Hardware_Efficient, frequencies 4-6) show their
FCC moving with the rounding noise of those coefficients.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GOLDENS = {"Circuit_20": 0.004, "Circuit_19": 0.010, "Circuit_17": 0.078,
           "Hardware_Efficient": 0.080}


def port_fcc(circuit: str, samples: int, seed: int, dtype: torch.dtype) -> float:
    from qml_essentials_tpu_torch.analysis.coefficients import FCC
    from qml_essentials_tpu_torch.models.model import Model

    m = Model(n_qubits=6, n_layers=1, circuit_type=circuit, output_qubit=-1, encoding=["RY"],
              device="cpu", dtype=dtype, random_seed=1000 + seed)
    with torch.no_grad():
        return float(FCC.get_fcc(model=m, n_samples=samples, scale=True,
                                 random_key=torch.Generator().manual_seed(seed)))


def jax_fcc(circuit: str, samples: int, seed: int) -> float:
    import jax

    from qml_essentials_tpu.analysis.coefficients import FCC
    from qml_essentials_tpu.models.model import Model

    m = Model(n_qubits=6, n_layers=1, circuit_type=circuit, output_qubit=-1, encoding=["RY"],
              random_seed=1000 + seed)
    return float(FCC.get_fcc(model=m, n_samples=samples, scale=True,
                             random_key=jax.random.PRNGKey(seed)))


def same_coefficients(circuit: str, samples: int) -> tuple:
    """Both packages' fingerprint code on the JAX package's coefficients."""
    from qml_essentials_tpu.analysis.coefficients import FCC as JFCC
    from qml_essentials_tpu.models.model import Model as JModel
    from qml_essentials_tpu_torch.analysis.coefficients import FCC as TFCC
    from qml_essentials_tpu_torch.models.model import Model as TModel

    jm = JModel(n_qubits=6, n_layers=1, circuit_type=circuit, output_qubit=-1, encoding=["RY"])
    params, coeffs, freqs = JFCC._calculate_coefficients(jm, samples, scale=True)
    tm = TModel(n_qubits=6, n_layers=1, circuit_type=circuit, output_qubit=-1,
                encoding=["RY"], device="cpu")
    jfix, tfix = JFCC._calculate_coefficients, TFCC._calculate_coefficients
    JFCC._calculate_coefficients = classmethod(lambda cls, *a, **k: (params, coeffs, freqs))
    TFCC._calculate_coefficients = classmethod(lambda cls, *a, **k: (
        torch.as_tensor(np.asarray(params)), torch.as_tensor(np.asarray(coeffs)),
        np.asarray(freqs)))
    try:
        return (float(JFCC.get_fcc(model=jm, n_samples=samples, scale=True)),
                float(TFCC.get_fcc(model=tm, n_samples=samples, scale=True)))
    finally:
        JFCC._calculate_coefficients, TFCC._calculate_coefficients = jfix, tfix


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--circuits", default="Hardware_Efficient,Circuit_17")
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--dtypes", default="float32,float64")
    p.add_argument("--jax", action="store_true")
    p.add_argument("--same-coefficients", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(4)
    if args.jax or args.same_coefficients:
        import jax

        jax.config.update("jax_platforms", "cpu")
    for circuit in args.circuits.split(","):
        golden = GOLDENS[circuit]
        for seed in range(args.seeds):
            for name in args.dtypes.split(","):
                t0 = time.perf_counter()
                v = port_fcc(circuit, args.samples, seed, getattr(torch, name))
                print(f"port {name:7s} {circuit:18s} seed {seed}: FCC {v:.4f} (Fig. 3a {golden}, "
                      f"{abs(v - golden):.4f} off) {time.perf_counter() - t0:.1f} s", flush=True)
            if args.jax:
                t0 = time.perf_counter()
                v = jax_fcc(circuit, args.samples, seed)
                print(f"jax  float32 {circuit:18s} seed {seed}: FCC {v:.4f} (Fig. 3a {golden}, "
                      f"{abs(v - golden):.4f} off) {time.perf_counter() - t0:.1f} s", flush=True)
        if args.same_coefficients:
            j, t = same_coefficients(circuit, args.samples)
            print(f"same coefficients {circuit}: JAX fingerprint {j:.6f}, port {t:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
