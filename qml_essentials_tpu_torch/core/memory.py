"""Memory available to a simulation.

Counterpart of ``available_memory_bytes`` in
``qml_essentials_tpu/core/memory.py`` (the chunking estimates come with the
executor slice).
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)


def available_memory_bytes(device=None) -> int:
    """Bytes free for new tensors on *device*: on a CUDA device the free
    memory CUDA reports plus what PyTorch's caching allocator holds unused; on the
    CPU the host's available RAM (psutil, then ``/proc/meminfo``, then a
    4 GiB default)."""
    device = torch.device(device if device is not None else "cpu")
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
