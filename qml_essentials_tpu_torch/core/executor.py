"""Script: the execution orchestrator.

``Script`` wraps a circuit function whose body records
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects; it
records the tape and hands it to
:func:`~qml_essentials_tpu_torch.ops.simulation.simulate_and_measure` on an
explicit device and dtype.  A batch (``in_axes``) runs as a plain loop over
its elements, stacked at the end: PyTorch runs eagerly, so there is no jit,
no vmap and no plan cache.  Under autograd every element's saved states stay
alive until the backward, so the loop passes the batch size down to the
simulator's memory estimate (the JAX package reads it off the vmap batch).

Counterpart of ``qml_essentials_tpu/core/executor.py`` (memory-aware
chunking, sharding and shot sampling come later).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from qml_essentials_tpu_torch.ops import simulation
from qml_essentials_tpu_torch.ops.operations import Operation
from qml_essentials_tpu_torch.ops.tape import recording


class Script:
    """Circuit container + executor.

    Example:
        >>> def circuit(theta):
        ...     RX(theta, wires=0)
        >>> script = Script(circuit, n_qubits=2)
        >>> script.execute(type="expval", obs=[PauliZ(0, record=False)], args=(0.3,))
    """

    def __init__(
        self,
        f: Callable[..., None],
        n_qubits: Optional[int] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.f = f
        self._n_qubits = n_qubits
        self.device = torch.device(device if device is not None else "cpu")
        self.dtype = dtype

    def _record(self, *args, **kwargs) -> List[Operation]:
        """Run the circuit function, collecting operations on a fresh tape."""
        with recording() as tape:
            self.f(*args, **kwargs)
        return tape

    def _run_one(self, type: str, obs: List[Operation], args: tuple, kwargs: dict,
                 batch: int = 1) -> torch.Tensor:
        tape = self._record(*args, **kwargs)
        n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, obs)
        use_density = simulation.uses_density(tape, type)
        return simulation.simulate_and_measure(
            tape, n_qubits, type, obs, use_density,
            dtype=self.dtype, device=self.device, batch=batch,
        )

    def execute(
        self,
        type: str = "expval",
        obs: Optional[List[Operation]] = None,
        *,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        in_axes: Optional[Tuple] = None,
    ) -> torch.Tensor:
        """Execute the circuit and return measurement results.

        Args:
            type: ``"expval"`` | ``"probs"`` | ``"state"``.
            obs: Observables for ``"expval"``.
            args / kwargs: Forwarded to the circuit function.
            in_axes: Per-positional-arg batch axes (``None`` = broadcast);
                when given, results carry a leading batch dimension.
        """
        obs = [] if obs is None else obs
        kwargs = {} if kwargs is None else kwargs
        if in_axes is None:
            return self._run_one(type, obs, args, kwargs)

        if len(in_axes) != len(args):
            raise ValueError(
                f"in_axes has {len(in_axes)} entries but args has {len(args)}. "
                "Provide one in_axes entry per positional argument."
            )
        sizes = {a.shape[ax] for a, ax in zip(args, in_axes) if ax is not None}
        if len(sizes) > 1:
            raise ValueError(f"batched arguments disagree on the batch size: {sorted(sizes)}")
        batch = sizes.pop() if sizes else 1
        results = [
            self._run_one(
                type,
                obs,
                tuple(a if ax is None else a.select(ax, i) for a, ax in zip(args, in_axes)),
                kwargs,
                batch,
            )
            for i in range(batch)
        ]
        return torch.stack(results)
