"""Checkpointing for models and long QOC runs, on ``torch.save``.

Array trees — a Model's trainable state (variational, encoding and pulse
parameters), a QOC optimiser's state — are saved with ``torch.save`` and
read back with ``torch.load(weights_only=True)``, versioned as
``<path>/step_<k>``.  A save writes a temporary file beside its target and
renames it into place (``os.replace``), so an interrupted save never leaves
a half-written ``step_<k>`` for :func:`latest_step` to pick.

The JAX package checkpoints with orbax; this port neither reads nor writes
orbax checkpoints, and the JAX package cannot read these: the formats
differ by design.  A tree holds tensors, numpy arrays and scalars (saved as
CPU tensors), Python scalars and strings, nested in dicts, lists and tuples;
it comes back with CPU tensors where arrays were saved.

Counterpart of ``qml_essentials_tpu/utils/checkpointing.py``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch


def _to_saveable(tree: Any) -> Any:
    """The tree with its arrays as detached CPU tensors (what
    ``weights_only`` loading accepts)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(tree))
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_saveable(v) for v in tree)
    return tree


def _target(path: str, step: Optional[int]) -> str:
    target = os.path.join(path, f"step_{step}") if step is not None else path
    return os.path.abspath(target)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Save an array tree; returns the concrete file written.

    With *step*, checkpoints are versioned as ``<path>/step_<k>``;
    otherwise *path* itself is (over)written.
    """
    target = _target(path, step)
    parent = os.path.dirname(target)
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".partial_", dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_saveable(tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return target


def restore_checkpoint(path: str, step: Optional[int] = None) -> Any:
    """Restore an array tree saved by :func:`save_checkpoint` (its tensors
    on the CPU)."""
    return torch.load(_target(path, step), map_location="cpu", weights_only=True)


def latest_step(path: str) -> Optional[int]:
    """Largest ``step_<k>`` version under *path*, or ``None``."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def save_model(path: str, model, step: Optional[int] = None) -> str:
    """Checkpoint a Model's trainable state (params, enc_params, pulse)."""
    tree = {
        "params": model.params,
        "enc_params": model.enc_params,
        "pulse_params": model.pulse_params,
    }
    return save_checkpoint(path, tree, step=step)


def restore_model(path: str, model, step: Optional[int] = None):
    """Restore a Model's trainable state in place, on the model's own device
    and in its dtype; returns the model."""
    tree = restore_checkpoint(path, step=step)
    place = dict(device=model.device, dtype=model.dtype)
    model.params = tree["params"].to(**place)
    model.enc_params.data = tree["enc_params"].to(**place)
    model.pulse_params = tree["pulse_params"].to(**place)
    return model
