"""Multi-device execution on ``torch.distributed``: the mesh and sharded
simulation.

Every rank runs the same program (SPMD): the caller initialises the default
process group (``torch.distributed.init_process_group`` with its address,
world size and rank) and builds the same mesh on every rank.

* ``set_mesh`` / ``get_mesh`` — a process-global
  :class:`torch.distributed.device_mesh.DeviceMesh` with the axis names
  ``data`` and ``state``.  With a ``data`` axis larger than one that divides
  a batch, each data rank runs its rows of every batched
  :meth:`Script.execute` and the ranks gather the whole batch (pure data
  parallelism).
* :mod:`~qml_essentials_tpu_torch.parallel.state_sharding` — the statevector
  sharded over the ``state`` axis, sharded qubits made local by grouped
  exchanges (``all_to_all_single``), the local windows on the ported
  kernels.
* :mod:`~qml_essentials_tpu_torch.parallel.density_sharding` — noisy tapes
  lowered to the interleaved doubled register and run by the same machinery,
  measured off the pair diagonal.

Counterpart of ``qml_essentials_tpu/parallel/__init__.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from qml_essentials_tpu_torch.parallel.density_sharding import (  # noqa: F401
    ShardedDensitySim,
)
from qml_essentials_tpu_torch.parallel.state_sharding import (  # noqa: F401
    ShardedStateSim,
    ShardingUnavailable,
    sharded_expval_z,
)

_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    """Install (or clear, with ``None``) the process-global execution mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    """Return the active execution mesh, or ``None``."""
    return _ACTIVE_MESH


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mesh, in axis order."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def explain(target) -> str:
    """Report what sharded and what fell back (and why) for *target*.

    *target* is a :class:`~qml_essentials_tpu_torch.core.executor.Script` or
    a :class:`~qml_essentials_tpu_torch.models.model.Model` (its ``.script``
    is read).  Returns the script's recent routing decisions, one line each:
    ``sharded:state`` / ``sharded:density`` / ``sharded:cached`` per served
    request, or ``fallback: <reason>`` when a request ran single-device.
    Fallbacks also warn (once per reason) at execution time.
    """
    script = getattr(target, "script", target)
    decisions = getattr(script, "sharding_decisions", None)
    mesh = get_mesh()
    header = (
        "mesh: none configured"
        if mesh is None
        else "mesh: " + " × ".join(f"{k}={v}" for k, v in _mesh_shape(mesh).items())
    )
    if decisions is None:
        return header + "\n(target has no execution script)"
    if not decisions:
        return header + "\n(no sharding-routable executions recorded yet)"
    lines = [header]
    for request, route in decisions:
        lines.append(f"  {request} -> {route}")
    return "\n".join(lines)


def make_mesh(
    axis_sizes: Sequence[int] = (-1,),
    axis_names: Sequence[str] = ("data",),
    device=None,
):
    """Build a mesh over the ranks of the initialised default group.

    A single ``-1`` axis size absorbs all remaining ranks; sizes whose
    product is below the world size take its first ranks.  The mesh targets
    the card unless *device* asks for the CPU (``"cpu"``: a ``gloo`` group).
    Every rank of the default group calls this with the same arguments.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) on every rank first."
        )
    world = dist.get_world_size()
    sizes = list(axis_sizes)
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    n = math.prod(sizes)
    if n > world or n < 1:
        raise ValueError(f"a mesh of {sizes} needs {n} ranks; the group has {world}")
    device_type = "cuda" if device is None else torch.device(device).type
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axis_names))
