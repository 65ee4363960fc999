"""What the benchmark takes from the program under test
(``qml_essentials_tpu_torch``): the ``Model``, its kernel wrappers' launch
counters, and nothing it computes for the check.  The parameters and inputs
are the benchmark's, made from the seed."""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, Tuple

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def kernels_module():
    from qml_essentials_tpu_torch.ops import cuda_kernels

    return cuda_kernels


def launches() -> Dict[str, int]:
    return dict(kernels_module().LAUNCHES)


def launch_diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def parameters(config: dict, shape: Tuple[int, ...], gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Angles uniform in [0, 2 pi), in the configuration's dtype, made on
    the device in one call."""
    dtype = getattr(torch, config["dtype"])
    return torch.rand(shape, generator=gen, device=device, dtype=dtype) * (2 * math.pi)


def model(config: dict, params: torch.Tensor, device: torch.device):
    """The program's model of the configuration, holding ``params``."""
    from qml_essentials_tpu_torch import Model

    m = Model(n_qubits=config["n_qubits"], n_layers=config["n_layers"],
              circuit_type=config["circuit"], device=device,
              dtype=getattr(torch, config["dtype"]))
    m.params = params[None]
    m.noise_params = config.get("noise")
    return m


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def stage(label: str, t_start: float) -> None:
    """Note on standard error when a set-up stage ended."""
    print(f"setup {label}: {time.perf_counter() - t_start:.3f} s", file=sys.stderr, flush=True)
