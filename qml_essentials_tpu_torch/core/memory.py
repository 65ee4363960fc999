"""Memory estimation and memory-aware batch chunking.

Decides whether a batched simulation fits in device memory and, if not,
splits the batch into chunks that do.  The estimates are plain Python
arithmetic (no cost when everything fits).  Free memory is read on the
simulation's own device: the card's free memory plus what PyTorch's caching
allocator holds unused, or the host's available RAM for the CPU.

The port runs a batch vectorised: every composed window of its plan is a
``(Bt, 2, K, K)`` payload per element, alive for the whole run.  So
:func:`estimate_peak_bytes` adds those payload bytes (``payload_bytes`` per
element, from the plan) to the reference's state terms — a term of the
port's own; the JAX package's estimate counts states only.

Counterpart of ``qml_essentials_tpu/core/memory.py``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import torch

from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)

# Whether to call ``torch.cuda.empty_cache()`` between chunks.  Off by
# default: the caching allocator reuses one chunk's blocks for the next.
CLEAR_CACHES_BETWEEN_CHUNKS: bool = False

# How many per-gate intermediate buffers the estimator assumes alive at once
# (the reference's constant: the fused plan keeps this small and roughly
# depth-independent).
LIVE_BUFFERS: int = 4

_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def _itemsizes(dtype: torch.dtype) -> Tuple[int, int]:
    """(complex, real) bytes of an amplitude of a simulation in real *dtype*:
    float32 gives 8 and 4, float64 16 and 8."""
    real = _ITEMSIZE[dtype]
    return 2 * real, real


def _output_bytes(
    type: str, batch_size: int, dim: int, elem: int, real_elem: int, n_obs: int
) -> int:
    """Bytes of the returned ``(batch_size, ...)`` measurement array."""
    if type == "density":
        return batch_size * dim * dim * elem
    if type == "expval":
        return batch_size * max(n_obs, 1) * real_elem
    if type == "probs":
        return batch_size * dim * real_elem
    return batch_size * dim * elem  # state


def estimate_peak_bytes(
    n_qubits: int,
    batch_size: int,
    type: str,
    use_density: bool,
    n_obs: int = 0,
    n_ops: int = 1,
    dtype: torch.dtype = torch.float32,
    payload_bytes: int = 0,
) -> int:
    """Analytic peak-memory estimate for a batched simulation.

    Counts the batched state (or density) working set times the number of
    simultaneously-live contraction buffers, plus the output accumulator,
    with a 1.5x safety factor for temporaries and padding (the reference's
    terms), and — the port's own term — *payload_bytes* per element: the
    bytes of the batched plan's payloads, every one alive for the run.
    """
    dim = 2**n_qubits
    elem, real_elem = _itemsizes(dtype)
    live = max(1, min(int(n_ops), LIVE_BUFFERS))

    state_bytes = batch_size * dim * elem
    if use_density:
        work = (1 + 2 * live) * batch_size * dim * dim * elem + state_bytes
    else:
        work = (1 + live) * state_bytes
    work += batch_size * payload_bytes

    out = _output_bytes(type, batch_size, dim, elem, real_elem, n_obs)
    return int(max(work, out) * 1.5)


def available_memory_bytes(device=DEFAULT_DEVICE) -> int:
    """Bytes free for new tensors on *device* (the card by default; raises
    without CUDA): on a CUDA device the free memory CUDA reports plus what
    PyTorch's caching allocator holds unused; on the CPU the host's
    available RAM (psutil, then ``/proc/meminfo``, then a 4 GiB default)."""
    device = resolve_device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int(free + cached)

    mem = 4 * 1024**3
    try:
        import psutil

        mem = psutil.virtual_memory().available
    except Exception:
        log.debug("psutil unavailable; falling back to /proc/meminfo")
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        mem = int(line.split()[1]) * 1024
                        break
        except Exception:
            log.debug("Could not read /proc/meminfo; using 4 GiB default")
    return int(mem)


def compute_chunk_size(
    n_qubits: int,
    batch_size: int,
    type: str,
    use_density: bool,
    n_obs: int = 0,
    memory_fraction: float = 0.8,
    n_ops: int = 1,
    dtype: torch.dtype = torch.float32,
    payload_bytes: int = 0,
    device=DEFAULT_DEVICE,
    available: Optional[int] = None,
) -> int:
    """Largest chunk size whose computation + output accumulator fits in the
    memory free on *device* (*available* bytes when the caller has read
    them).

    Returns *batch_size* (no chunking) when the full batch fits; minimum 1.
    """
    if available is None:
        available = available_memory_bytes(device)
    avail = int(available * memory_fraction)
    full_est = estimate_peak_bytes(n_qubits, batch_size, type, use_density, n_obs, n_ops,
                                   dtype, payload_bytes)
    if full_est <= avail:
        return batch_size

    dim = 2**n_qubits
    elem, real_elem = _itemsizes(dtype)
    accum = _output_bytes(type, batch_size, dim, elem, real_elem, n_obs)
    avail_for_chunks = max(avail - accum, elem)

    per_elem = estimate_peak_bytes(n_qubits, 1, type, use_density, n_obs, n_ops, dtype,
                                   payload_bytes)
    if per_elem <= 0:
        return batch_size

    chunk = max(1, min(avail_for_chunks // per_elem, batch_size))
    if chunk == 1 and per_elem > avail:
        log.warning(
            f"A single batch element needs ~{per_elem / 1024**3:.2f} GB but only "
            f"~{avail / 1024**3:.2f} GB is available; proceeding with "
            f"chunk_size=1 — OOM is possible."
        )
    log.info(
        f"Batched run needs ~{full_est / 1024**3:.2f} GB (> {avail / 1024**3:.2f} GB "
        f"available); chunking with chunk size {chunk}."
    )
    return chunk


def _rows_of(a, ax: int, start: int, size: int):
    """Rows ``[start, start + size)`` of a batched argument along *ax*: a
    tensor is narrowed, a sequence (or a ``GeneratorBatch``) sliced."""
    if isinstance(a, torch.Tensor):
        return a.narrow(ax, start, size)
    return a[start:start + size]


def execute_chunked(
    batched_fn: Callable,
    args: tuple,
    in_axes: Tuple,
    batch_size: int,
    chunk_size: int,
    clear_caches: bool = False,
) -> torch.Tensor:
    """Run a batched function over the batch in memory-safe chunks.

    One chunk's intermediates are alive at a time (without autograd); results
    are written into a pre-allocated output so peak memory is roughly
    ``output + one chunk``.  The copies are recorded by autograd: gradients
    flow through the chunked output into every chunk.
    """
    n_chunks = (batch_size + chunk_size - 1) // chunk_size
    log.debug(f"Chunking batch of {batch_size} into {n_chunks} x <= {chunk_size}.")

    output = None
    for idx in range(n_chunks):
        start = idx * chunk_size
        end = min(start + chunk_size, batch_size)
        size = end - start
        chunk_args = tuple(
            _rows_of(a, ax, start, size) if ax is not None else a
            for a, ax in zip(args, in_axes)
        )
        chunk_result = batched_fn(*chunk_args)
        if output is None:
            output = torch.zeros((batch_size,) + tuple(chunk_result.shape[1:]),
                                 dtype=chunk_result.dtype, device=chunk_result.device)
        output[start:end] = chunk_result
        del chunk_result, chunk_args
        if clear_caches and torch.cuda.is_available():
            torch.cuda.empty_cache()
    return output
