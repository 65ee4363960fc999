"""Script: the execution orchestrator.

``Script`` wraps a circuit function whose body records
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects; it
records the tape and hands it to
:func:`~qml_essentials_tpu_torch.ops.simulation.simulate_and_measure` on an
explicit device (the card unless the caller asks for the CPU) and dtype.  A
batch (``in_axes``) runs as a plain loop over its elements, stacked at the
end: PyTorch runs eagerly, so there is no jit, no vmap and no plan cache.
Under autograd every element's saved states stay alive until the backward,
so the loop passes the batch size down to the
simulator's memory estimate (the JAX package reads it off the vmap batch),
and one :class:`~qml_essentials_tpu_torch.ops.simulation.BackwardChoice`
for the whole batch: the first element decides between the saved-residual
and the adjoint backward, from the memory free before the batch, and every
element takes that executor.  A batched argument is a tensor (sliced
along its axis) or a list (one entry per element, e.g. the model's
per-element ``torch.Generator``).  Finite ``shots`` sample each element's
exact probabilities on its own generator, split off the one passed in.

Counterpart of ``qml_essentials_tpu/core/executor.py`` (memory-aware
chunking and sharding come later).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.ops import simulation
from qml_essentials_tpu_torch.ops.operations import Operation
from qml_essentials_tpu_torch.ops.tape import recording
from qml_essentials_tpu_torch.utils import safe_random_split


class Script:
    """Circuit container + executor.

    Example:
        >>> def circuit(theta):
        ...     RX(theta, wires=0)
        >>> script = Script(circuit, n_qubits=2, device="cpu")
        >>> script.execute(type="expval", obs=[PauliZ(0, record=False)], args=(0.3,))
    """

    def __init__(
        self,
        f: Callable[..., None],
        n_qubits: Optional[int] = None,
        device=DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.f = f
        self._n_qubits = n_qubits
        self.device = resolve_device(device)
        self.dtype = dtype

    def _record(self, *args, **kwargs) -> List[Operation]:
        """Run the circuit function, collecting operations on a fresh tape."""
        with recording() as tape:
            self.f(*args, **kwargs)
        return tape

    def _run_one(self, type: str, obs: List[Operation], args: tuple, kwargs: dict,
                 batch: int = 1, choice: Optional[simulation.BackwardChoice] = None,
                 shots: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 ) -> torch.Tensor:
        tape = self._record(*args, **kwargs)
        n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, obs)
        use_density = simulation.uses_density(tape, type)
        return simulation.simulate_and_measure(
            tape, n_qubits, type, obs, use_density, shots=shots, generator=generator,
            dtype=self.dtype, device=self.device, batch=batch, choice=choice,
        )

    def execute(
        self,
        type: str = "expval",
        obs: Optional[List[Operation]] = None,
        *,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        in_axes: Optional[Tuple] = None,
        shots: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Execute the circuit and return measurement results.

        Args:
            type: ``"expval"`` | ``"probs"`` | ``"state"`` | ``"density"``.
            obs: Observables for ``"expval"``.
            args / kwargs: Forwarded to the circuit function.
            in_axes: Per-positional-arg batch axes (``None`` = broadcast);
                when given, results carry a leading batch dimension.
            shots: Finite-shot sampling count (``"probs"``/``"expval"`` only).
            generator: ``torch.Generator`` of the shot draws (seed 0 when
                ``None``); a batch splits one per element off it.
        """
        obs = [] if obs is None else obs
        kwargs = {} if kwargs is None else kwargs
        if shots is not None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if in_axes is None:
            return self._run_one(type, obs, args, kwargs, shots=shots, generator=generator)

        if len(in_axes) != len(args):
            raise ValueError(
                f"in_axes has {len(in_axes)} entries but args has {len(args)}. "
                "Provide one in_axes entry per positional argument."
            )
        sizes = {len(a) if isinstance(a, (list, tuple)) else a.shape[ax]
                 for a, ax in zip(args, in_axes) if ax is not None}
        if len(sizes) > 1:
            raise ValueError(f"batched arguments disagree on the batch size: {sorted(sizes)}")
        batch = sizes.pop() if sizes else 1
        choice = simulation.BackwardChoice()
        shot_gens = safe_random_split(generator, batch, device=self.device)

        def element(a, ax, i):
            if ax is None:
                return a
            return a[i] if isinstance(a, (list, tuple)) else a.select(ax, i)

        results = [
            self._run_one(
                type,
                obs,
                tuple(element(a, ax, i) for a, ax in zip(args, in_axes)),
                kwargs,
                batch,
                choice,
                shots,
                shot_gens[i],
            )
            for i in range(batch)
        ]
        return torch.stack(results)
