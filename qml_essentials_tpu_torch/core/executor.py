"""Script: the execution orchestrator.

``Script`` wraps a circuit function whose body records
:class:`~qml_essentials_tpu_torch.ops.operations.Operation` objects; it
records the tape and hands it to
:func:`~qml_essentials_tpu_torch.ops.simulation.simulate_and_measure` on an
explicit device (the card unless the caller asks for the CPU) and dtype:

record -> plan (cached) -> memory-aware chunking -> batched run -> readout.

*Batches* (``in_axes``).  The circuit function is called once with the
batched arguments themselves (a tensor's batch axis moved to the front, a
list of generators as a
:class:`~qml_essentials_tpu_torch.utils.GeneratorBatch`): its gates receive
``(Bt,)`` parameters and record ``(Bt, K, K)`` matrices, so the batch is
recorded once, planned once and run with a leading batch axis — one kernel
launch per plan step for the whole batch (or chunk) below
``LARGE_STATE_MIN_N`` qubits, the steps element by element on the shared
plan's payload rows from there.  This is the counterpart of the JAX
package's ``vmap`` over one trace.  A batch that cannot be recorded so — a
circuit whose Python control flow reads argument values, a parameter whose
leading dimension is neither the batch nor 1, a batched argument that is
neither a tensor nor a list of generators — runs as a loop over its
elements, stacked at the end.  ``Script.routes`` logs the route of every
batched request, newest last: ``"vectorised"``, ``"per element: <reason>"``
(recorded and planned once, run element by element:
:func:`~qml_essentials_tpu_torch.ops.simulation.batch_route`) or
``"loop: <reason>"``.  Every batched call checks the recording
once: its last element, recorded on its own, must give the batched tape's
last row.

*Plan cache.*  Plans are cached on the recorded tape's structure
(:func:`~qml_essentials_tpu_torch.ops.recipes.tape_signature`: gate classes
and wires in order) together with the qubit count, measurement type, shots,
dtype, device, the observables' signature, ``UnitaryGates.batch_gate_error``
and the planner's flags and functions.  The port records every call, so a
key read off what was recorded cannot serve a stale plan (the JAX package
keys on the arguments, which cannot see, say, a zero input that elides the
encodings).  A hit skips the planner's structural work and only recomposes
the payloads from the fresh gate matrices.

*Chunks.*  :mod:`~qml_essentials_tpu_torch.core.memory` sizes the chunks a
batch runs in (memoised per key and batch size); the batch is still
recorded once and each chunk runs the rows of its slice.

*Gradients.*  One :class:`~qml_essentials_tpu_torch.ops.simulation.BackwardChoice`
decides for the whole batch between the saved-residual and the adjoint
backward, from the memory free before the batch.  Finite ``shots`` sample
each element's exact probabilities on its own generator, split off the one
passed in.

*Pulse gates.*  A pulse-mode gate records a pending operation; closing the
recording solves every pending operation of the tape, one batched solve per
Hamiltonian family (:mod:`~qml_essentials_tpu_torch.pulse.evolution`),
before the plan key or the planner reads a matrix.  A batch's pulse gates
carry ``(Bt, d, d)`` matrices like any other gate.

*Meshes.*  With a mesh configured
(:func:`qml_essentials_tpu_torch.parallel.set_mesh`; every rank of the
process group runs the same requests), a mesh with a ``state`` axis routes
each request through the sharded simulators
(:mod:`~qml_essentials_tpu_torch.parallel`): pure tapes through the sharded
statevector, noisy ones through the sharded doubled register, a batch split
over a ``data`` axis that divides it.  ``Script.sharding_decisions`` logs
each routable request's route, newest last (``sharded:state``,
``sharded:density``, ``sharded:cached`` or ``fallback: <reason>``; a
fallback runs the single-device path on the script's device and warns once
per reason).  A mesh with a ``data`` axis and no sharded route splits a
batch over the data ranks, each running its rows on the ordinary batched
route, and gathers it back.

Counterpart of ``qml_essentials_tpu/core/executor.py``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from qml_essentials_tpu_torch.ops import chains, recipes, simulation
from qml_essentials_tpu_torch.ops.operations import KrausChannel, Operation
from qml_essentials_tpu_torch.ops.tape import pulse_recording, recording
from qml_essentials_tpu_torch.utils import GeneratorBatch, profiling, safe_random_split

logger = logging.getLogger(__name__)

# Routes kept in Script.routes.
_ROUTE_LOG = 64


def _obs_signature(obs: List[Operation]) -> tuple:
    """Value signature of the observable list for the plan cache: Pauli
    observables key on (class, wires, label), any other on its matrix's
    content (PyTorch has no tracers: every matrix is concrete)."""
    sig = []
    for o in obs:
        label = getattr(o, "_pauli_label", None)
        if label is not None:
            sig.append((o.__class__.__name__, tuple(o.wires), label))
            continue
        m = getattr(o, "_matrix", None)
        if m is None:
            sig.append((o.__class__.__name__, tuple(o.wires), None))
            continue
        arr = np.asarray(m.detach().cpu())
        sig.append((o.__class__.__name__, tuple(o.wires), arr.shape, hash(arr.tobytes())))
    return tuple(sig)


def _planner_signature() -> tuple:
    """The planner's flags (which tests and tools set) and functions (which
    they replace): a change to either makes a new cache entry."""
    s = simulation
    flags = (s.FUSE_LAYOUT_ROT, s.USE_CHAINS, s.LARGE_STATE_MIN_N, s.FUSE_MAX_WIDTH,
             s.REFUSE_MAX_WIDTH, s.BACKWARD_MODE, s.LARGE_FUSE_WIDTH, s.FUSE_MIN_EXCESS)
    fns = (s.plan_contractions, s.schedule_layout, s._zero_state_prefix, s.refuse_windows,
           s.fuse_layout_rotations, s.scheduled_plan, s.interleaved_plan, s.mixed_plan,
           s._lower_interleaved_tape, chains.plan_chains)
    return flags + tuple(id(f) for f in fns)


def _arg_signature(args: tuple) -> tuple:
    """Signature of positional args for the sharded program cache: tensors
    key on (shape, dtype), Python floats and generators on their type
    (their values do not change the program), anything else on its repr."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype)))
        elif isinstance(a, float):
            out.append("<pyfloat>")
        elif isinstance(a, complex):
            out.append("<pycomplex>")
        elif isinstance(a, torch.Generator):
            out.append("<generator>")
        elif isinstance(a, GeneratorBatch) or (
                isinstance(a, (list, tuple)) and a
                and all(isinstance(g, torch.Generator) for g in a)):
            out.append(("<generators>", len(a)))
        else:
            out.append(repr(a))
    return tuple(out)


def _make_hashable(obj):
    """Recursively convert dicts/lists/sets into hashable cache-key forms."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _make_hashable(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_make_hashable(x) for x in obj)
    if isinstance(obj, set):
        return frozenset(_make_hashable(x) for x in obj)
    return obj


class _NotVectorisable(Exception):
    """A batch that takes the loop route; the message is the reason."""


def _batch_size(args: tuple, in_axes: Tuple) -> int:
    """The batch size the batched arguments agree on (1 when none is)."""
    sizes = {len(a) if not isinstance(a, torch.Tensor) else a.shape[ax]
             for a, ax in zip(args, in_axes) if ax is not None}
    if len(sizes) > 1:
        raise ValueError(f"batched arguments disagree on the batch size: {sorted(sizes)}")
    return sizes.pop() if sizes else 1


def _element(a, ax, i):
    if ax is None:
        return a
    return a.select(ax, i) if isinstance(a, torch.Tensor) else a[i]


def _alone(a, ax, i):
    """Element *i* of an argument as the batch's check records it: a
    generator copied as it stands before the batch draws from it."""
    e = _element(a, ax, i)
    if isinstance(e, torch.Generator):
        e = torch.Generator(device=e.device).set_state(e.get_state())
    return e


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
        # Plan cache: key -> simulation.PlanSlot; chunk sizes by (key, batch).
        self._plans: Dict[tuple, simulation.PlanSlot] = {}
        self._chunks: Dict[tuple, int] = {}
        # Route of every batched request, newest last.
        self.routes: List[str] = []
        # Sharded-routing log: (request, "sharded:<route>" | "fallback: <reason>"),
        # newest last, read by parallel.explain(); fallbacks warn once per reason.
        self.sharding_decisions: List[Tuple[str, str]] = []
        self._warned_fallbacks: set = set()
        # Sharded programs, cached after their first successful call.
        self._sharded: Dict[tuple, Callable] = {}

    # ------------------------------------------------------------ recording
    def _record(self, *args, **kwargs) -> List[Operation]:
        """Run the circuit function, collecting operations on a fresh tape."""
        with recording() as tape:
            self.f(*args, **kwargs)
        return tape

    def pulse_events(self, *args, **kwargs) -> list:
        """Run the circuit and collect pulse events for schedule drawing."""
        with pulse_recording() as events:
            with recording():
                self.f(*args, **kwargs)
        return events

    def _plan_key(self, tape, n_qubits, type, obs, use_density, shots) -> tuple:
        from qml_essentials_tpu_torch.models.unitary import UnitaryGates

        return (recipes.tape_signature(tape), n_qubits, type, use_density, shots,
                str(self.dtype), str(self.device), _obs_signature(obs),
                UnitaryGates.batch_gate_error, _planner_signature())

    def _slot(self, tape, n_qubits, type, obs, use_density, shots):
        key = self._plan_key(tape, n_qubits, type, obs, use_density, shots)
        slot = self._plans.get(key)
        if slot is None:
            slot = self._plans[key] = simulation.PlanSlot()
        return key, slot

    def _log_route(self, route: str) -> None:
        self.routes.append(route)
        del self.routes[:-_ROUTE_LOG]

    # -------------------------------------------------------------- execute
    def _run_one(self, type: str, obs: List[Operation], args: tuple, kwargs: dict,
                 batch: int = 1, choice: Optional[simulation.BackwardChoice] = None,
                 shots: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 ) -> torch.Tensor:
        with profiling.span("script.record"):
            tape = self._record(*args, **kwargs)
        with profiling.span("plan.prepare"):
            n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, obs)
            use_density = simulation.uses_density(tape, type)
            _, slot = self._slot(tape, n_qubits, type, obs, use_density, shots)
            simulation.engine(tape, slot, n_qubits, use_density, self.dtype, self.device)
        return simulation.simulate_and_measure(
            tape, n_qubits, type, obs, use_density, shots=shots, generator=generator,
            dtype=self.dtype, device=self.device, batch=batch, choice=choice, plans=slot,
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
                when given, results carry a leading batch dimension.  A
                batched argument is a tensor (batched along its axis) or a
                list (one entry per element, e.g. per-element
                ``torch.Generator``\\ s).
            shots: Finite-shot sampling count (``"probs"``/``"expval"`` only).
            generator: ``torch.Generator`` of the shot draws (seed 0 when
                ``None``); a batch splits one per element off it.
        """
        obs = [] if obs is None else obs
        kwargs = {} if kwargs is None else kwargs
        if shots is not None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if in_axes is None:
            sharded = self._try_sharded_state(type, obs, args, kwargs, shots=shots,
                                              generator=generator)
            if sharded is not None:
                return sharded
            return self._run_one(type, obs, args, kwargs, shots=shots, generator=generator)

        if len(in_axes) != len(args):
            raise ValueError(
                f"in_axes has {len(in_axes)} entries but args has {len(args)}. "
                "Provide one in_axes entry per positional argument."
            )
        batch = _batch_size(args, in_axes)
        sharded = self._try_sharded_state(type, obs, args, kwargs, in_axes=in_axes, shots=shots,
                                          generator=generator)
        if sharded is not None:
            return sharded
        shot_gens = list(safe_random_split(generator, batch, device=self.device))
        dp = self._data_parallel(args, in_axes, batch)
        if dp is not None:
            args, rows, dax = dp
            out = self._execute_batched(type, obs, args, kwargs, in_axes, len(rows), shots,
                                        [shot_gens[i] for i in rows])
            from qml_essentials_tpu_torch.parallel.state_sharding import _Gather

            gathered = _Gather.apply(out, dax)
            return gathered.reshape((-1,) + tuple(gathered.shape[2:]))
        return self._execute_batched(type, obs, args, kwargs, in_axes, batch, shots, shot_gens)

    def _execute_batched(self, type, obs, args, kwargs, in_axes, batch, shots, shot_gens
                         ) -> torch.Tensor:
        """The single-device batched route: vectorised, or a loop."""
        choice = simulation.BackwardChoice()
        try:
            return self._execute_vectorised(type, obs, args, kwargs, in_axes, batch, choice,
                                            shots, shot_gens)
        except _NotVectorisable as why:
            self._log_route(f"loop: {why}")
            logger.info("Batch of %r runs as a loop: %s", getattr(self.f, "__name__", self.f),
                        why)
        return torch.stack([
            self._run_one(type, obs, tuple(_element(a, ax, i) for a, ax in zip(args, in_axes)),
                          kwargs, batch, choice, shots, shot_gens[i])
            for i in range(batch)
        ])

    # -------------------------------------------------------------- meshes
    @staticmethod
    def _data_parallel(args: tuple, in_axes: Tuple, batch: int):
        """This rank's part of a batch split over the mesh's ``data`` axis
        (:func:`~qml_essentials_tpu_torch.parallel.state_sharding._split_batch`):
        ``(args, rows, axis)``, or None without such an axis or when it does
        not divide the batch."""
        from qml_essentials_tpu_torch import parallel
        from qml_essentials_tpu_torch.parallel import state_sharding as ss

        mesh = parallel.get_mesh()
        size = parallel._mesh_shape(mesh).get("data", 1) if mesh is not None else 1
        if size <= 1 or batch % size != 0:
            return None
        part, dax, rows = ss._split_batch(mesh, "data", args, in_axes)
        return part, rows, dax

    def _try_sharded_state(
        self,
        type: str,
        obs: List[Operation],
        args: tuple,
        kwargs: dict,
        in_axes: Optional[Tuple] = None,
        shots: Optional[int] = None,
        generator=None,
    ) -> Optional[torch.Tensor]:
        """Route through the distributed statevector backend when the mesh
        (:func:`qml_essentials_tpu_torch.parallel.get_mesh`) has a ``state``
        axis and the request is one it runs: ``expval`` over observables with
        a matrix (I/Z Pauli words fold the probabilities, other Hermitians
        take an exchange and a local contraction), ``state``, ``probs``,
        pure-tape ``density`` (the sharded state's outer product), and
        finite shots for ``expval``/``probs``.  Noisy tapes go to
        :meth:`_try_sharded_density`.  A batch (``in_axes``) runs on batched
        shards, split over the mesh's ``data`` axis when that divides it.
        Returns ``None`` (the single-device path, with a warning once per
        reason) otherwise.  The program is cached after its first successful
        call."""
        from qml_essentials_tpu_torch import parallel
        from qml_essentials_tpu_torch.parallel import state_sharding

        mesh = parallel.get_mesh()
        if mesh is None or "state" not in (mesh.mesh_dim_names or ()):
            return None
        shape = parallel._mesh_shape(mesh)

        request = f"{type}(in_axes={in_axes is not None}, shots={shots})"

        def note(route: str) -> None:
            self.sharding_decisions.append((request, route))
            if len(self.sharding_decisions) > 64:
                del self.sharding_decisions[:-64]

        def fall_back(reason: str) -> None:
            note(f"fallback: {reason}")
            log = logger.warning if reason not in self._warned_fallbacks else logger.info
            self._warned_fallbacks.add(reason)
            log(
                "Sharded route unavailable (%s); falling back to the "
                "single-device path for %r.",
                reason,
                getattr(self.f, "__name__", self.f),
            )

        if type not in ("expval", "state", "probs", "density"):
            fall_back(f"measurement type {type!r} not sharded")
            return None
        if shots is not None and type not in ("expval", "probs"):
            fall_back(f"shot sampling is undefined for type {type!r}")
            return None
        observables: tuple = ()
        obs_sig: tuple = ()
        if type == "expval":
            norm, sig = [], []
            for o in obs:
                w = state_sharding.zword_of(o)
                if w is not None:
                    norm.append(w)
                    sig.append(("zword", w))
                    continue
                m = getattr(o, "_matrix", None)
                if m is None:
                    fall_back(f"observable {o.name} has no concrete matrix")
                    return None
                norm.append(o)
                sig.append(("gen", o.__class__.__name__, tuple(o.wires),
                            np.asarray(m.detach().cpu()).tobytes()))
            observables, obs_sig = tuple(norm), tuple(sig)

        from qml_essentials_tpu_torch.models.unitary import UnitaryGates

        cache_kwargs = _make_hashable(
            {k: v for k, v in kwargs.items() if not isinstance(v, torch.Tensor)})
        mesh_key = (tuple(shape.items()), mesh.device_type, tuple(mesh.mesh.flatten().tolist()))
        cache_key = ("sharded", type, obs_sig, in_axes, shots, _arg_signature(args),
                     cache_kwargs, mesh_key, UnitaryGates.batch_gate_error, str(self.dtype),
                     str(self.device))
        batch_size = _batch_size(args, in_axes) if in_axes is not None else None

        def shot_keys():
            if in_axes is None:
                return generator
            return list(safe_random_split(generator, batch_size, device=self.device))

        cached = self._sharded.get(cache_key)
        if cached is not None:
            note("sharded:cached")
            return cached(shot_keys(), *args) if shots is not None else cached(*args)

        scalar_args = args
        data_axis = None
        if in_axes is not None:
            scalar_args = tuple(_element(a, ax, 0) for a, ax in zip(args, in_axes))
            if shape.get("data", 1) > 1 and batch_size % shape["data"] == 0:
                data_axis = "data"

        tape = self._record(*state_sharding._frozen(scalar_args), **kwargs)
        n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, obs)
        tape_fn = lambda *a: self._record(*a, **kwargs)  # noqa: E731

        if any(isinstance(op, KrausChannel) for op in tape):
            return self._try_sharded_density(
                type, observables, tape_fn, args, in_axes, data_axis, shots, shot_keys,
                n_qubits, mesh, cache_key, fall_back, note)

        if 2**n_qubits < 2 * shape["state"]:
            fall_back("too few qubits to shard meaningfully")
            return None

        sim = state_sharding.ShardedStateSim(n_qubits, mesh, dtype=self.dtype,
                                             device=self.device)
        try:
            if shots is not None:
                fn = sim.build_shot_program(tape_fn, type, observables, shots, args,
                                            in_axes=in_axes, data_axis=data_axis)
                out = fn(shot_keys(), *args)
            elif type == "expval":
                fn = sim.build_expval_program(tape_fn, observables, args, in_axes=in_axes,
                                              data_axis=data_axis)
                out = fn(*args)
            elif type == "state":
                fn = sim.build_state_program(tape_fn, args, in_axes=in_axes,
                                             data_axis=data_axis)
                out = fn(*args)
            elif type == "density":
                # A pure tape: the sharded statevector and one outer product.
                state_fn = sim.build_state_program(tape_fn, args, in_axes=in_axes,
                                                   data_axis=data_axis)

                def fn(*a):
                    psi = state_fn(*a)
                    return torch.einsum("...i,...j->...ij", psi, psi.conj())

                out = fn(*args)
            else:
                fn = sim.build_probs_program(tape_fn, args, in_axes=in_axes,
                                             data_axis=data_axis)
                out = fn(*args)
            self._sharded[cache_key] = fn
            note("sharded:state" + self._staging_note(sim))
            return out
        except state_sharding.ShardingUnavailable as exc:
            fall_back(str(exc))
            return None

    @staticmethod
    def _staging_note(sim) -> str:
        return " (exchanges staged through host memory)" if sim.staged else ""

    def _try_sharded_density(self, type: str, observables: tuple, tape_fn, args: tuple,
                             in_axes: Optional[Tuple], data_axis: Optional[str],
                             shots: Optional[int], shot_keys, n_qubits: int, mesh, cache_key,
                             fall_back, note) -> Optional[torch.Tensor]:
        """Route a noisy request through the sharded doubled register:
        ``expval`` (Z-words off the pair diagonal, other Hermitians by a
        local ``Tr(O ρ_S)``), ``probs``, ``density`` and finite shots for
        ``probs``/``expval``, batched or not; a tape with no interleaved
        doubled form falls back."""
        from qml_essentials_tpu_torch import parallel
        from qml_essentials_tpu_torch.parallel import density_sharding, state_sharding

        if type == "state":
            fall_back("state output is undefined for density tapes")
            return None
        if 4**n_qubits < 2 * parallel._mesh_shape(mesh)["state"]:
            fall_back("too few qubits to shard the density meaningfully")
            return None
        sim = density_sharding.ShardedDensitySim(n_qubits, mesh, dtype=self.dtype,
                                                 device=self.device)
        try:
            if shots is not None:
                fn = sim.build_shot_program(tape_fn, type, observables, shots, args,
                                            in_axes=in_axes, data_axis=data_axis)
                out = fn(shot_keys(), *args)
            elif type == "expval":
                fn = sim.build_expval_program(tape_fn, observables, args, in_axes=in_axes,
                                              data_axis=data_axis)
                out = fn(*args)
            elif type == "probs":
                fn = sim.build_probs_program(tape_fn, args, in_axes=in_axes,
                                             data_axis=data_axis)
                out = fn(*args)
            else:  # density
                fn = sim.build_density_program(tape_fn, args, in_axes=in_axes,
                                               data_axis=data_axis)
                out = fn(*args)
            self._sharded[cache_key] = fn
            note("sharded:density" + self._staging_note(sim.inner))
            return out
        except state_sharding.ShardingUnavailable as exc:
            fall_back(str(exc))
            return None

    # ----------------------------------------------------------- vectorised
    @staticmethod
    def _batched_arg(a, ax):
        """A batched argument as the circuit receives it in one recording."""
        if ax is None:
            return a
        if isinstance(a, torch.Tensor):
            return a.movedim(ax, 0)
        if isinstance(a, GeneratorBatch):
            return a
        if isinstance(a, (list, tuple)) and all(isinstance(g, torch.Generator) for g in a):
            return GeneratorBatch(list(a))
        if isinstance(a, (list, tuple)) and all(g is None for g in a):
            return None
        raise _NotVectorisable(f"a batched argument of type {type(a).__name__}")

    def _record_batch(self, args: tuple, in_axes: Tuple, kwargs: dict, batch: int):
        if batch < 2:
            raise _NotVectorisable("a batch of one")
        bargs = tuple(self._batched_arg(a, ax) for a, ax in zip(args, in_axes))
        last = tuple(_alone(a, ax, batch - 1) for a, ax in zip(args, in_axes))
        try:
            tape = self._record(*bargs, **kwargs)
            rows = recipes.batch_of(tape)
        except Exception as e:  # the loop records each element and raises what is real
            raise _NotVectorisable(f"recording the batch raised {type(e).__name__}: {e}")
        if rows is None:
            raise _NotVectorisable("no gate depends on the batched arguments")
        if rows != batch:
            raise _NotVectorisable(
                f"a parameter's leading dimension is {rows}, neither {batch} nor 1")
        self._check_last_element(tape, last, kwargs, batch)
        return tape

    def _check_last_element(self, tape, last_args, kwargs, batch) -> None:
        """The last element recorded on its own (*last_args*) must give the
        batched tape's last row: a circuit that indexes a batched argument
        from the front would not."""
        last = self._record(*last_args, **kwargs)
        if recipes.tape_signature(last) != recipes.tape_signature(tape):
            raise _NotVectorisable("the last element records another circuit")
        row = recipes.materialize(recipes.proxy_tape(tape), tape, batch - 1)
        for a, b in zip(last, row):
            for k in ("_matrix", "diag"):
                x, y = a.__dict__.get(k), b.__dict__.get(k)
                if isinstance(x, torch.Tensor) and not torch.allclose(
                        x.detach(), y.detach().to(x.dtype), rtol=1e-5, atol=1e-6):
                    raise _NotVectorisable(
                        f"the last element's {a.name} differs from the batch's last row")

    def _execute_vectorised(self, type, obs, args, kwargs, in_axes, batch, choice, shots,
                            shot_gens) -> torch.Tensor:
        with profiling.span("script.record"):
            tape = self._record_batch(args, in_axes, kwargs, batch)
        with profiling.span("plan.prepare"):
            n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, obs)
            use_density = simulation.uses_density(tape, type)
            key, slot = self._slot(tape, n_qubits, type, obs, use_density, shots)
            chunk = self._chunk_size(key, slot, tape, n_qubits, type, len(obs), use_density,
                                     batch, choice)
            self._log_route(simulation.batch_route(tape, slot, n_qubits, type, use_density,
                                                   self.dtype, self.device, batch, choice))

        def run(rows: torch.Tensor, gens: list) -> torch.Tensor:
            start = int(rows[0])
            part = slice(start, start + len(rows)) if len(rows) < batch else None
            return simulation.simulate_and_measure(
                tape, n_qubits, type, obs, use_density, shots=shots, generator=gens,
                dtype=self.dtype, device=self.device, batch=batch, choice=choice,
                plans=slot, rows=part)

        return self._dispatch(run, batch, chunk, shot_gens)

    def _chunk_size(self, key, slot, tape, n_qubits, type, n_obs, use_density, batch,
                    choice) -> int:
        """Memoised memory-aware chunk size for this plan key + batch size.
        A fresh estimate reads free memory once for the batch: the batch's
        backward decision (*choice*) takes the same reading."""
        mem_key = (key, batch)
        chunk = self._chunks.get(mem_key)
        if chunk is None:
            choice.free = memory.available_memory_bytes(self.device)
            chunk = memory.compute_chunk_size(
                n_qubits, batch, type, use_density, n_obs, n_ops=len(tape), dtype=self.dtype,
                payload_bytes=simulation.payload_bytes(
                    slot, tape, n_qubits, use_density, self.dtype, self.device),
                device=self.device, available=choice.free,
            )
            self._chunks[mem_key] = chunk
        return chunk

    @staticmethod
    def _dispatch(run: Callable, batch: int, chunk: int, shot_gens: list) -> torch.Tensor:
        """Run the batch whole, or in chunks of *chunk* rows."""
        rows = torch.arange(batch)
        if chunk >= batch:
            return run(rows, shot_gens)
        return memory.execute_chunked(run, (rows, shot_gens), (0, 0), batch, chunk,
                                      clear_caches=memory.CLEAR_CACHES_BETWEEN_CHUNKS)

    # ----------------------------------------------------------------- draw
    def draw(
        self,
        figure: str = "text",
        args: tuple = (),
        kwargs: Optional[dict] = None,
        **draw_kwargs: Any,
    ) -> Union[str, Any]:
        """Render the circuit: ``"text"`` | ``"mpl"`` | ``"tikz"`` | ``"pulse"``
        (noise channels are left out of the drawing; ``"mpl"`` and
        ``"pulse"`` need matplotlib)."""
        if figure not in ("text", "mpl", "tikz", "pulse"):
            raise ValueError(
                f"Invalid figure mode: {figure!r}. "
                "Must be 'text', 'mpl', 'tikz', or 'pulse'."
            )
        if kwargs is None:
            kwargs = {}

        if figure == "pulse":
            from qml_essentials_tpu_torch.utils.drawing import draw_pulse_schedule

            with torch.no_grad():
                events = self.pulse_events(*args, **kwargs)
            n_qubits = (
                self._n_qubits
                or max((w for ev in events for w in ev.wires), default=0) + 1
            )
            return draw_pulse_schedule(events, n_qubits, **draw_kwargs)

        from qml_essentials_tpu_torch.utils.drawing import draw_mpl, draw_text, draw_tikz

        with torch.no_grad():
            tape = self._record(*args, **kwargs)
        n_qubits = self._n_qubits or simulation.infer_n_qubits(tape, [])
        ops = [op for op in tape if not isinstance(op, KrausChannel)]

        if figure == "text":
            return draw_text(ops, n_qubits, **draw_kwargs)
        if figure == "mpl":
            return draw_mpl(ops, n_qubits, **draw_kwargs)
        return draw_tikz(ops, n_qubits, **draw_kwargs)
