"""Rank processes for the sharded port's CPU tests (not a test module).

:class:`RankPool` starts ``world`` processes that join one ``gloo`` group
through a ``file://`` store and serve requests until closed; a request names
a function of this module, which every rank runs with the same arguments
(SPMD), and the pool returns each rank's answer.  The functions build the
port's circuits, meshes and models from plain arguments (numpy arrays,
names), so the test module can run the JAX package on the same inputs;
this module imports nothing of JAX.  The circuits take the operations module
as their first argument, so both packages record the same gates.
"""

from __future__ import annotations

import os
import traceback
from datetime import timedelta

import numpy as np

# ---------------------------------------------------------------------------
# Circuits shared with the JAX side (``op`` is either package's operations)
# ---------------------------------------------------------------------------


def circ5(op, theta):
    """H/RX layer, CX chain and a final RY: gates on sharded qubits."""
    for w in range(5):
        op.H(wires=w)
        op.RX(theta * (w + 1) * 0.3, wires=w)
    for w in range(4):
        op.CX(wires=[w, w + 1])
    op.RY(theta, wires=0)


def layered(op, params):
    """Per-wire angles from a ``(5,)`` parameter row, a two-bit RXX on the
    two sharded qubits of a 4-rank mesh, and a CX chain."""
    for w in range(5):
        op.RY(params[w], wires=w)
        op.RZ(params[(w + 1) % 5] * 0.7, wires=w)
    op.RXX(params[1] * 0.5, wires=[0, 1])
    for w in range(4):
        op.CX(wires=[w, w + 1])
    op.RY(params[0] * 0.5, wires=4)


def deep(op, theta):
    """Enough layers that the fused plan on a 4-rank mesh has >= 16 steps."""
    for layer in range(6):
        for w in range(6):
            op.RY(theta * (w + 1) * 0.1 + layer, wires=w)
        for w in range(5):
            op.CX(wires=[w, w + 1])
        op.CZ(wires=[5, 0])


def noisy4(op, theta):
    """A noisy 4-qubit tape: BitFlip, Depolarizing and AmplitudeDamping."""
    n = 4
    for w in range(n):
        op.RY(theta * 0.4 + w, wires=w)
        op.RX(theta * (w + 1) * 0.3, wires=w)
    op.BitFlip(0.07, wires=2)
    for w in range(n - 1):
        op.CX(wires=[w, w + 1])
        op.DepolarizingChannel(0.05, wires=w)
    op.AmplitudeDamping(0.1, wires=n - 1)


def noisy_batch(op, params):
    """:func:`layered` with depolarizing noise on every wire (5 qubits)."""
    layered(op, params)
    for w in range(5):
        op.DepolarizingChannel(0.03, wires=w)


def too_small(op, theta):
    op.RY(theta, wires=0)


def ry4(op, theta):
    for w in range(4):
        op.RY(theta, wires=w)


def unlowerable(op, theta, diag):
    """A noisy tape with a scattered diagonal: no interleaved doubled form."""
    op.RY(theta, wires=0)
    op.BitFlip(0.1, wires=0)
    op.DiagonalQubitUnitary(diag, wires=[0, 2])


def ghz(op, n):
    op.H(wires=0)
    for q in range(n - 1):
        op.CX(wires=[q, q + 1])


def ghz_dephased(op, n):
    ghz(op, n)
    for q in range(n):
        op.PhaseDamping(1.0, wires=q)


CIRCUITS = {f.__name__: f for f in (circ5, layered, deep, noisy4, noisy_batch, too_small,
                                    ry4, unlowerable)}


def hermitian(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2**k, 2**k)) + 1j * rng.normal(size=(2**k, 2**k))
    return (a + a.conj().T) / 2


def observables(op, specs, tensor):
    """Observables from ``(name, wires)`` or ``("Hermitian", seed, wires)``;
    *tensor* turns a numpy matrix into the package's array."""
    out = []
    for spec in specs:
        if spec[0] == "Hermitian":
            _, seed, wires = spec
            out.append(op.Hermitian(tensor(hermitian(seed, len(wires))), wires=list(wires),
                                    record=False))
        elif spec[0] == "ZZ":  # an I/Z-labelled word with repeated wires
            o = op.Hermitian(tensor(np.diag([1.0, -1.0]).astype(complex)), wires=[spec[1][0]],
                             record=False)
            o.wires = list(spec[1])
            o._pauli_label = "Z" * len(spec[1])
            out.append(o)
        else:
            out.append(getattr(op, spec[0])(wires=spec[1], record=False))
    return out


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


def _serve(rank: int, world: int, store: str, inbox, outbox) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    while True:
        task = inbox.get()
        if task is None:
            break
        name, args = task
        try:
            outbox.put((rank, True, globals()[name](*args)))
        except Exception:  # noqa: BLE001 - the test reports the rank's traceback
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks serving :meth:`run` requests."""

    def __init__(self, world: int, directory: str) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self._directory = directory
        self._ctx = ctx
        self._starts = 0
        self._start()

    def _start(self) -> None:
        self._starts += 1
        store = os.path.join(self._directory, f"store_{self._starts}")
        self.inboxes = [self._ctx.Queue() for _ in range(self.world)]
        self.outbox = self._ctx.Queue()
        self.procs = [self._ctx.Process(target=_serve,
                                        args=(r, self.world, store, self.inboxes[r], self.outbox),
                                        daemon=True) for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, timeout: float = 240.0) -> list:
        """Every rank's answer to ``name(*args)``, in rank order; a rank's
        exception is raised here (and the pool restarted)."""
        for q in self.inboxes:
            q.put((name, args))
        answers, errors = [None] * self.world, []
        try:
            for _ in range(self.world):
                rank, ok, value = self.outbox.get(timeout=timeout)
                if ok:
                    answers[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except Exception as e:  # noqa: BLE001 - a lost or hung rank
            errors.append(f"no answer: {type(e).__name__} {e}")
        if errors:
            self.close(force=True)
            self._start()
            raise RuntimeError("\n".join(errors))
        return answers

    def close(self, force: bool = False) -> None:
        if not force:
            for q in self.inboxes:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def _mesh(spec):
    """``None``, or a CPU mesh from ``(sizes, names)`` (cached per spec)."""
    if spec is None:
        return None
    from qml_essentials_tpu_torch import parallel

    key = (tuple(spec[0]), tuple(spec[1]))
    if key not in _MESHES:
        _MESHES[key] = parallel.make_mesh(spec[0], spec[1], device="cpu")
    return _MESHES[key]


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return x


def _tensor(a):
    import torch

    return torch.as_tensor(np.asarray(a))


class _Knobs:
    """Set module attributes of the port for one request."""

    def __init__(self, knobs):
        self.knobs = knobs or {}

    def __enter__(self):
        import importlib

        self.before = []
        for path, value in self.knobs.items():
            mod, name = path.rsplit(".", 1)
            m = importlib.import_module(mod)
            self.before.append((m, name, getattr(m, name)))
            setattr(m, name, value)

    def __exit__(self, *exc):
        for m, name, value in reversed(self.before):
            setattr(m, name, value)


def script_requests(circuit: str, n_qubits: int, mesh_spec, requests, knobs=None) -> dict:
    """Run *requests* on one port ``Script`` of *circuit* in float64 with
    the mesh set: each ``(type, obs_specs, args, in_axes, shots, grad)``
    answers its output (and, with *grad*, d sum(output) / d args[0]).
    Returns the answers, the route log, ``explain``'s text, the host plans
    built and the fused plan's length."""
    import torch

    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.core.executor import Script
    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    f = CIRCUITS[circuit]
    script = Script(lambda *a: f(op, *a), n_qubits=n_qubits, device="cpu", dtype=torch.float64)
    answers, plans = [], []
    parallel.set_mesh(_mesh(mesh_spec))
    try:
        with _Knobs(knobs):
            for type, obs_specs, args, in_axes, shots, grad in requests:
                obs = observables(op, obs_specs, _tensor)
                targs = tuple(torch.tensor(a, dtype=torch.float64) if isinstance(a, float)
                              else torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                              for a in args)
                if grad:
                    targs = (targs[0].requires_grad_(),) + targs[1:]
                before = ss.TRACE_COUNT
                gen = torch.Generator().manual_seed(11) if shots else None
                try:
                    out = script.execute(type=type, obs=obs, args=targs, in_axes=in_axes,
                                         shots=shots, generator=gen)
                except ValueError as e:  # the single-device path refuses the request
                    answers.append((f"ValueError: {e}", None))
                    plans.append(ss.TRACE_COUNT - before)
                    continue
                g = torch.autograd.grad(out.sum(), targs[0])[0] if grad else None
                answers.append((_np(out), _np(g)))
                plans.append(ss.TRACE_COUNT - before)
        report = parallel.explain(script)
    finally:
        parallel.set_mesh(None)
    return {"answers": answers, "decisions": list(script.sharding_decisions),
            "explain": report, "plans": plans}


def warnings_of(circuit: str, n_qubits: int, mesh_spec, requests) -> int:
    """Warnings that :func:`script_requests` makes the executor log about
    falling back."""
    import logging

    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("qml_essentials_tpu_torch.core.executor")
    logger.addHandler(handler)
    try:
        script_requests(circuit, n_qubits, mesh_spec, requests)
    finally:
        logger.removeHandler(handler)
    return sum(r.levelno == logging.WARNING and "falling back" in r.getMessage().lower()
               for r in records)


def plan_length(circuit: str, n_qubits: int, g: int, args, density: bool = False) -> int:
    """Steps of the fused plan the sharded simulator runs for *circuit*."""
    import torch

    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.ops import simulation
    from qml_essentials_tpu_torch.ops.tape import recording
    from qml_essentials_tpu_torch.parallel.state_sharding import _fused_ops

    with recording() as tape:
        CIRCUITS[circuit](op, *(torch.tensor(a, dtype=torch.float64) for a in args))
    if density:
        tape = simulation._lower_interleaved_tape(tape, n_qubits)
        n_qubits *= 2
    return len(_fused_ops(tape, n_qubits, g))


def model_requests(n_qubits: int, n_layers: int, params, inputs, mesh_spec, noise=None,
                   execution_type="expval", grad=True) -> dict:
    """A float64 port ``Model`` (Circuit_19) with *params* loaded: its
    output for *inputs* and d sum(output) / d params, with the mesh set."""
    import torch

    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.models.model import Model

    m = Model(n_qubits=n_qubits, n_layers=n_layers, circuit_type="Circuit_19",
              device="cpu", dtype=torch.float64)
    m.load_numpy(np.asarray(params))
    parallel.set_mesh(_mesh(mesh_spec))
    try:
        x = torch.as_tensor(np.asarray(inputs), dtype=torch.float64)
        out = m(inputs=x, noise_params=noise, execution_type=execution_type)
        g = torch.autograd.grad(out.sum(), m.params)[0] if grad else None
    finally:
        parallel.set_mesh(None)
    return {"out": _np(out), "grad": _np(g), "decisions": list(m.script.sharding_decisions)}


def exchanges(n: int, seed: int, cases, piece_bytes=None) -> list:
    """:func:`_exchange_bits` on a 4-rank state mesh against the definition
    (the physical positions of each pair swapped), for each ``(pairs,
    batch, form)``, in pieces of at most *piece_bytes* when given; returns
    max|error| per case."""
    import torch

    from qml_essentials_tpu_torch.parallel import state_sharding as ss

    if piece_bytes is not None:
        with _Knobs({"qml_essentials_tpu_torch.parallel.state_sharding.EXCHANGE_PIECE_BYTES":
                     piece_bytes}):
            return exchanges(n, seed, cases)

    ax = ss._Axis(_mesh(((4,), ("state",))), "state")
    g = 2
    errs = []
    for pairs, batch, form in cases:
        rng = np.random.default_rng(seed)
        lead = (2,) if batch is None else (2, batch)
        full = rng.normal(size=lead + (2**n,))
        L = 2 ** (n - g)
        local = torch.as_tensor(full[..., ax.d * L:(ax.d + 1) * L].copy())
        before = ss.BATCHED_EXCHANGE
        ss.BATCHED_EXCHANGE = form
        try:
            got = ss._exchange_bits(local, [tuple(p) for p in pairs], ax, via_ppermute=True)
        finally:
            ss.BATCHED_EXCHANGE = before
        gathered = ss._all_gather(got, ax).movedim(0, -2).reshape(lead + (2**n,)).numpy()
        want = full.reshape(lead + (2,) * n)
        o = len(lead)
        for gp, v in pairs:
            want = np.swapaxes(want, o + gp, o + v)
        errs.append(float(np.abs(gathered - want.reshape(lead + (2**n,))).max()))
    return errs


def direct_sims(n: int) -> dict:
    """The simulators without a Script: the GHZ state, its ⟨Z⟩ through
    ``sharded_expval_z``, and the dephased GHZ density."""
    import torch

    from qml_essentials_tpu_torch.ops import operations as op
    from qml_essentials_tpu_torch.ops.tape import recording
    from qml_essentials_tpu_torch.parallel import (
        ShardedDensitySim,
        ShardedStateSim,
        ShardingUnavailable,
        sharded_expval_z,
    )

    mesh = _mesh(((4,), ("state",)))

    def tape(f):
        def fn():
            with recording() as t:
                f(op, n)
            return t
        return fn

    def noisy(theta):
        with recording() as t:
            op.RX(theta, wires=0)
            op.BitFlip(0.1, wires=0)
        return t

    kw = dict(dtype=torch.float64, device="cpu")
    psi = ShardedStateSim(n, mesh, **kw).state(tape(ghz))
    zz = ShardedStateSim(n, mesh, **kw).expval_z(tape(ghz), [0, (0, n - 1)])
    z_helper = sharded_expval_z(tape(ghz), n, [n - 1], mesh)
    rho = ShardedDensitySim(n, mesh, **kw).density(tape(ghz_dephased))
    try:
        ShardedStateSim(4, mesh, **kw).expval_z(noisy, [0], torch.tensor(0.3))
        raised = False
    except ShardingUnavailable:
        raised = True
    return {"psi": _np(psi), "zz": _np(zz), "z": _np(z_helper), "rho": _np(rho),
            "noise_raises": raised}


def largest_tensors(n: int, params, x: float) -> dict:
    """The largest tensor (elements, and the operation that made it) this
    rank creates while it builds a float64 Circuit_19 ``Model`` (2 layers)
    on a 4-rank ``state`` mesh and runs a forward, then a forward +
    gradient (a ``TorchDispatchMode`` sees every tensor an operation
    returns); and the answers with the exchanges in whole shards and in
    pieces of 1 KiB."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.models.model import Model

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel, self.op = 0, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.numel() > self.numel:
                    self.numel, self.op = t.numel(), str(func)
            return out

    parallel.set_mesh(_mesh(((4,), ("state",))))
    try:
        fwd, grad = Largest(), Largest()
        with fwd:
            m = Model(n_qubits=n, n_layers=2, circuit_type="Circuit_19", device="cpu",
                      dtype=torch.float64)
            m.load_numpy(np.asarray(params))
            m(inputs=x)
        with grad:
            out = m(inputs=x)
            out.mean().backward()
        answers = {}
        for piece in (None, 1024):
            knob = {} if piece is None else {
                "qml_essentials_tpu_torch.parallel.state_sharding.EXCHANGE_PIECE_BYTES": piece}
            with _Knobs(knob):
                m.zero_grad()
                out = m(inputs=x)
                out.mean().backward()
                answers[piece] = (_np(out), _np(m.params.grad))
    finally:
        parallel.set_mesh(None)
    return {"forward": (fwd.numel, fwd.op), "gradient": (grad.numel, grad.op),
            "answers": answers, "decisions": list(m.script.sharding_decisions)}


def free_memory_reads(n: int, params, inputs) -> dict:
    """How often the executor reads free memory (``memory.available_memory_bytes``)
    while a float64 Circuit_19 ``Model`` (1 layer) runs a forward +
    gradient on ``state=4`` and a batch forward + gradient on ``data=2 x
    state=2``, and a noisy forward on ``state=4``: a choice read off one
    rank's free memory could send the ranks down different collectives."""
    import torch

    from qml_essentials_tpu_torch import parallel
    from qml_essentials_tpu_torch.core import memory
    from qml_essentials_tpu_torch.models.model import Model

    reads = []
    read = memory.available_memory_bytes

    def counted(*a, **k):
        reads.append(1)
        return read(*a, **k)

    m = Model(n_qubits=n, n_layers=1, circuit_type="Circuit_19", device="cpu",
              dtype=torch.float64)
    m.load_numpy(np.asarray(params))
    memory.available_memory_bytes = counted
    decisions = []
    try:
        for spec, x, noise in ((((4,), ("state",)), inputs[:1], None),
                               ((((2, 2), ("data", "state"))), inputs, None),
                               (((4,), ("state",)), inputs[:1], {"BitFlip": 0.05})):
            parallel.set_mesh(_mesh(spec))
            try:
                m.zero_grad()
                out = m(inputs=torch.as_tensor(x), noise_params=noise)
                out.sum().backward()
            finally:
                parallel.set_mesh(None)
        decisions = list(m.script.sharding_decisions)
    finally:
        memory.available_memory_bytes = read
    return {"reads": len(reads), "decisions": decisions}
