"""The PyTorch port's pulse stack against the JAX package.

``Evolution`` (static, fixed-grid Magnus, adaptive Dormand-Prince), the
pulse gates (every leaf and composite), the pulse configuration, the
pulse-mode Model (its tape, expectation values, a noisy request, both
gradients, the third batch axis) and the batched solve (one call per
Hamiltonian family, each row as it would be alone).

Tolerances: float64 on both sides (JAX with x64 switched on inside a
context): Magnus and static solves and the gate matrices 1e-10, the
adaptive solvers 1e-8, tapes and expectation values 1e-10, gradients 1e-8
of max|g|; float32 gate matrices 1e-5.  The JAX side never calls a jitted
pulse-mode ``Model``: its circuits are recorded eagerly and simulated with
``simulate_pure`` / ``simulate_mixed``.  Both packages' process-global
pulse state is restored after every test.
"""

import warnings
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import jaqsi as jjs
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.pulse.pulses import PulseGates as JaxPulseGates
from qml_essentials_tpu.pulse.pulses import PulseInformation as JaxPulseInformation
from qml_essentials_tpu_torch.core import jaqsi as tjs
from qml_essentials_tpu_torch.core.executor import Script
from qml_essentials_tpu_torch.models.gates import Gates
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording
from qml_essentials_tpu_torch.pulse.evolution import EvolvedOperation, Evolution
from qml_essentials_tpu_torch.pulse.pulses import (
    PulseEnvelope,
    PulseGates,
    PulseInformation,
    PulseParamManager,
    PulseParams,
)

torch.set_num_threads(2)

MAGNUS_TOL = 1e-10
ADAPTIVE_TOL = 1e-8
F32_TOL = 1e-5
GRAD_REL = 1e-8
X = 0.37

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Z = np.array([[1, 0], [0, -1]], dtype=complex)
_H4 = np.random.default_rng(4).normal(size=(4, 4)) + 1j * np.random.default_rng(5).normal(
    size=(4, 4))
_H4 = (_H4 + _H4.conj().T) / 4


@pytest.fixture(autouse=True)
def both_pulse_states():
    """Restore both packages' global pulse configuration after every test."""
    jax_state = JaxPulseInformation.snapshot_state()
    state = PulseInformation.snapshot_state()
    yield
    JaxPulseInformation.restore_state(jax_state)
    PulseInformation.restore_state(state)


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128, as they are when the package is imported under x64."""
    promoted = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                cls._matrix = m.astype(jnp.complex128)
        yield
    finally:
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _both_envelopes(name, rwa=True, frame="drive"):
    JaxPulseInformation.set_envelope(name, rwa=rwa, frame=frame)
    PulseInformation.set_envelope(name, rwa=rwa, frame=frame)


# ---------------------------------------------------------------------------
# Evolution
# ---------------------------------------------------------------------------


def _coeffs(m):
    """A constant and a time-dependent pair of coefficient functions written
    with the math module *m* (jax.numpy or torch)."""

    def const(p, t):
        return p[0] * p[1]

    def drive(p, t):
        return p[0] * m.cos(p[1] * t)

    def chirp(p, t):
        return p[0] * m.sin(p[1] * t) * t

    return const, drive, chirp


J_CONST, J_DRIVE, J_CHIRP = _coeffs(jnp)
T_CONST, T_DRIVE, T_CHIRP = _coeffs(torch)
P1, P2 = np.array([0.7, 1.3]), np.array([0.4, 2.1])


def _solve_both(case, solver, T=1.7):
    """The propagator of *case* in both packages (float64), as numpy."""
    opts = {} if solver is None else {"solver": solver}

    def build(js, fns, arr):
        const, drive, chirp = fns
        if case == "constant":
            return const * js.Hamiltonian(_X, wires=0), [arr(P1)]
        if case == "two-term":
            h = drive * js.Hamiltonian(_X, wires=0) + chirp * js.Hamiltonian(_Z, wires=0)
            return h, [arr(P1), arr(P2)]
        # a two-qubit family (the Taylor exponential)
        return drive * js.Hamiltonian(_H4, wires=[0, 1]), [arr(P1)]

    with jax_x64():
        jh, jargs = build(jjs, (J_CONST, J_DRIVE, J_CHIRP), jnp.asarray)
        ref = np.asarray(jh.evolve(**opts)(jargs, T).matrix)
    th, targs = build(tjs, (T_CONST, T_DRIVE, T_CHIRP), torch.tensor)
    got = th.evolve(**opts)(targs, torch.tensor(T, dtype=torch.float64)).matrix
    assert got.dtype == torch.complex128
    return _np(got), ref


@pytest.mark.unittest
def test_static_evolution_matches_jax():
    with jax_x64():
        ref = np.asarray(jjs.Hamiltonian(_H4, wires=[0, 1]).evolve()(0.83).matrix)
    got = tjs.Hamiltonian(_H4, wires=[0, 1]).evolve()(torch.tensor(0.83, dtype=torch.float64))
    assert np.abs(_np(got.matrix) - ref).max() <= MAGNUS_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("case,solver", [
    (case, solver) for case in ("constant", "two-term") for solver in
    ("magnus2", "magnus4", "dopri5", "dopri8")] + [("4x4", "magnus2"), ("4x4", "magnus4")])
def test_parametrized_evolution_matches_jax(case, solver):
    got, ref = _solve_both(case, solver)
    tol = MAGNUS_TOL if solver.startswith("magnus") else ADAPTIVE_TOL
    assert np.abs(got - ref).max() <= tol
    assert np.abs(got.conj().T @ got - np.eye(len(got))).max() <= 1e-8


@pytest.mark.unittest
def test_gradient_through_magnus4_matches_jax():
    """d/dp and d/dT of |U[0, 1]|^2 + Re U[1, 1] (two-term drive)."""

    def loss_jax(p, T):
        h = J_DRIVE * jjs.Hamiltonian(_X, wires=0) + J_CHIRP * jjs.Hamiltonian(_Z, wires=0)
        U = h.evolve()([p, jnp.asarray(P2)], T).matrix
        return jnp.abs(U[0, 1]) ** 2 + jnp.real(U[1, 1])

    with jax_x64():
        gp, gT = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(P1), jnp.asarray(1.7))
        gp, gT = np.asarray(gp), float(gT)
    p = torch.tensor(P1, requires_grad=True)
    T = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    h = T_DRIVE * tjs.Hamiltonian(_X, wires=0) + T_CHIRP * tjs.Hamiltonian(_Z, wires=0)
    U = h.evolve()([p, torch.tensor(P2)], T).matrix
    (U[0, 1].abs() ** 2 + U[1, 1].real).backward()
    scale = max(np.abs(gp).max(), abs(gT))
    assert np.abs(_np(p.grad) - gp).max() <= GRAD_REL * scale
    assert abs(T.grad.item() - gT) <= GRAD_REL * scale


@pytest.mark.unittest
def test_solver_defaults_validation_and_cache():
    prev = Evolution.set_solver_defaults(solver="dopri5", magnus_steps=64, throw=None)
    try:
        assert prev == {"solver": "magnus4", "magnus_steps": 256}
        assert Evolution._solver_defaults["solver"] == "dopri5"
    finally:
        Evolution.set_solver_defaults(**prev)
    assert Evolution._solver_defaults["magnus_steps"] == 256
    with pytest.raises(TypeError):
        Evolution.set_solver_defaults(bogus=1)
    with pytest.raises(ValueError):
        Evolution.set_solver_defaults(solver="rk4")
    with pytest.raises(ValueError):
        (T_DRIVE * tjs.Hamiltonian(_X)).evolve(solver="rk4")
    with pytest.raises(TypeError):
        Evolution.evolve("not a Hamiltonian")
    with pytest.raises(ValueError):
        (T_DRIVE * tjs.Hamiltonian(_X)).evolve()([P1, P2], 1.0)
    with pytest.raises(TypeError):
        3.0 * tjs.Hamiltonian(_X)
    with pytest.raises(ValueError):  # terms on different wires
        T_DRIVE * tjs.Hamiltonian(_X, wires=0) + T_DRIVE * tjs.Hamiltonian(_X, wires=1)
    # An omitted tolerance follows the solve's dtype.
    assert Evolution._parse_evolve_solver_options({})[:2] == (None, None)
    # One solver per coefficient code + dim + options; cleared on demand
    # and by an envelope switch.
    Evolution.clear_evolve_solver_cache()
    (T_DRIVE * tjs.Hamiltonian(_X)).evolve()
    (T_DRIVE * tjs.Hamiltonian(_Z)).evolve()
    (T_DRIVE * tjs.Hamiltonian(_X)).evolve(solver="magnus2")
    assert len(Evolution._evolve_solver_cache) == 2
    PulseInformation.set_envelope("square")
    assert len(Evolution._evolve_solver_cache) == 0
    # The combinators.
    h = T_DRIVE * tjs.Hamiltonian(_X) - T_CHIRP * tjs.Hamiltonian(_Z)
    assert h.n_terms == 2 and len(h.coeff_fns) == 2 and len(h.H_mats) == 2
    assert float(h.coeff_fns[1](torch.tensor(P2), torch.tensor(0.5))) == pytest.approx(
        -float(T_CHIRP(torch.tensor(P2), torch.tensor(0.5))))


@pytest.mark.unittest
@pytest.mark.parametrize("solver", ["dopri5", "dopri8"])
def test_exhausted_step_budget_gives_nan_as_in_jax(solver):
    th = T_DRIVE * tjs.Hamiltonian(_X)
    jh = J_DRIVE * jjs.Hamiltonian(_X)
    with jax_x64():
        ref = np.asarray(jh.evolve(solver=solver, max_steps=3)([jnp.asarray(P1)], 5.0).matrix)
    got = _np(th.evolve(solver=solver, max_steps=3)([torch.tensor(P1)], 5.0).matrix)
    assert np.isnan(ref).all() and np.isnan(got).all()
    # A float32 gate: solved in float64 at its dtype's default tolerance
    # (1.4e-8) and rounded once.
    U = th.evolve(solver=solver)([torch.tensor(P1, dtype=torch.float32)], 1.0).matrix
    assert U.dtype == torch.complex64 and torch.isfinite(U).all()


@pytest.mark.unittest
def test_a_family_solves_in_one_call_and_each_row_as_alone():
    """Five RX leaves (three of them a batch of two) solve in one call, each
    row exactly as the gate recorded alone."""
    PulseInformation.set_envelope("gaussian")
    angles = [0.3, -1.1, 2.5]
    before = Evolution.solve_calls
    with recording() as tape:
        for i, w in enumerate(angles):
            PulseGates.RX(torch.tensor(w, dtype=torch.float32), wires=i)
        PulseGates.RX(torch.tensor([0.9, 1.7]), wires=0)
    assert Evolution.solve_calls - before == 1
    assert all(isinstance(o, EvolvedOperation) and "_pending" not in o.__dict__ for o in tape)
    for w, op in zip(angles + [0.9, 1.7], [*tape[:3], None, None]):
        with recording() as alone:
            PulseGates.RX(torch.tensor(w, dtype=torch.float32), wires=0)
        row = op.matrix if op is not None else tape[3].matrix[[0.9, 1.7].index(w)]
        assert torch.allclose(alone[0].matrix, row, rtol=1e-5, atol=1e-6)
    assert tape[3].matrix.shape == (2, 2, 2)
    # Outside a recording the gate solves when its matrix is read.
    gate = (T_DRIVE * tjs.Hamiltonian(_X)).evolve()([torch.tensor(P1)], 1.0)
    assert "_pending" in gate.__dict__
    assert gate.matrix.shape == (2, 2) and "_pending" not in gate.__dict__


# ---------------------------------------------------------------------------
# Pulse gates
# ---------------------------------------------------------------------------

GATES = [
    ("RX", (0.7,), 0), ("RY", (1.1,), 0), ("RZ", (0.9,), 0), ("CZ", (), [0, 1]),
    ("H", (), 0), ("CX", (), [0, 1]), ("CY", (), [0, 1]), ("CRX", (0.8,), [0, 1]),
    ("CRY", (-0.6,), [0, 1]), ("CRZ", (1.3,), [0, 1]), ("CPhase", (0.5,), [0, 1]),
    ("RZZ", (0.4,), [0, 1]), ("RXX", (-1.2,), [0, 1]), ("RYY", (0.3,), [0, 1]),
    ("RZX", (2.2,), [0, 1]), ("Rot", (0.3, 0.9, -0.5), 0),
]


def _gate_tapes(name, args, wires, dtype=None):
    """Both packages' tapes of one pulse gate; with *dtype*, the port's
    gate gets its angles and its tree's parameters in that dtype."""
    with jax_recording() as jt:
        getattr(JaxPulseGates, name)(*args, wires=wires)
    kw = {}
    targs = args
    if dtype is not None:
        targs = tuple(torch.tensor(a, dtype=dtype) for a in args)
        kw["pulse_params"] = PulseInformation.gate_by_name(name).params.to(dtype)
    with recording() as tt:
        getattr(PulseGates, name)(*targs, wires=wires, **kw)
    assert [o.name for o in jt] == [o.name for o in tt]
    assert [list(o.wires) for o in jt] == [o.wires for o in tt]
    return [np.asarray(o.matrix) for o in jt], [_np(o.matrix) for o in tt]


@pytest.mark.unittest
def test_every_gate_matches_jax():
    """Every leaf and composite, float64 (1e-10) and float32 (1e-5), both
    against the JAX package's float64 gate.  (The JAX package's own float32
    solve is ~1.5e-5 off its float64 one: its 512 near-identity step factors
    round their cosines the same way; the port solves in float64 and rounds
    once.)"""
    with jax_x64():
        _both_envelopes("gaussian")
        for name, args, wires in GATES:
            ref, got = _gate_tapes(name, args, wires)
            assert max(np.abs(a - b).max() for a, b in zip(ref, got)) <= MAGNUS_TOL, name
            _, got32 = _gate_tapes(name, args, wires, dtype=torch.float32)
            assert all(b.dtype == np.complex64 for b in got32), name
            assert max(np.abs(a - b).max() for a, b in zip(ref, got32)) <= F32_TOL, name


@pytest.mark.unittest
@pytest.mark.parametrize("config", [
    ("square", True, "drive"), ("cosine", True, "drive"), ("drag", True, "drive"),
    ("sech", True, "drive"), ("gaussian", False, "drive"), ("gaussian", False, "lab"),
])
def test_drive_leaves_match_jax_for_every_envelope_and_frame(config):
    """The envelope and the frame reach the drive leaves only (RZ, CZ and
    the composites' other leaves are envelope-free and held above)."""
    with jax_x64():
        _both_envelopes(*config)
        for name, args, wires in GATES[:2]:
            ref, got = _gate_tapes(name, args, wires)
            assert max(np.abs(a - b).max() for a, b in zip(ref, got)) <= MAGNUS_TOL, name


@pytest.mark.unittest
def test_pulse_configuration_matches_jax():
    """Parameter counts, trees, the envelope registry, the manager, and
    snapshot / restore / preserve."""
    for env in [e for e in PulseEnvelope.available() if e != "general"]:
        _both_envelopes(env)
        for name in ["RX", "RY", "RZ", "CZ", "H", "CX", "CY", "CRX", "CRY", "CRZ",
                     "CPhase", "RZZ", "RXX", "RYY", "RZX", "Rot"]:
            j, t = JaxPulseInformation.gate_by_name(name), PulseInformation.gate_by_name(name)
            assert len(t) == len(j) and t.shape == j.shape and t.is_leaf == j.is_leaf, name
            assert [leaf.name for leaf in t.leafs] == [leaf.name for leaf in j.leafs]
            assert np.allclose(_np(t.params), np.asarray(j.params), atol=1e-7), name
            if not t.is_leaf:
                assert [c.shape[-1] for c in t.split_params(t.params)] == [
                    np.asarray(c).shape[-1] for c in j.split_params(j.params)]
        assert PulseEnvelope.get(env)["n_envelope_params"] == \
            PulseEnvelope._N_ENV_PARAMS[env]
    with pytest.raises(ValueError):
        PulseEnvelope.get("bogus")
    with pytest.raises(ValueError):
        PulseInformation.set_frame("rotating")
    with pytest.raises(AssertionError):
        PulseParams(name="bad")

    mgr = PulseParamManager(torch.arange(5.0))
    assert mgr.get(2).tolist() == [0.0, 1.0] and float(mgr.get(1)) == 2.0
    with pytest.raises(ValueError):
        mgr.get(3)
    assert PulseParamManager(torch.ones(3, 4)).get(2).shape == (3, 2)

    PulseInformation.set_envelope("drag")
    snap = PulseInformation.snapshot_state()
    PulseInformation.set_envelope("gaussian", rwa=False, frame="lab")
    PulseInformation.RX.params = torch.full((3,), 0.5, dtype=torch.float64)
    PulseInformation.restore_state(snap)
    assert (PulseInformation.get_envelope(), PulseInformation.get_rwa(),
            PulseInformation.get_frame()) == ("drag", True, "drive")
    assert PulseInformation.RX.params.shape == (4,)
    with pytest.raises(RuntimeError):
        with PulseInformation.preserve_state():
            PulseInformation.set_envelope("sech")
            raise RuntimeError("inside")
    assert PulseInformation.get_envelope() == "drag"
    PulseInformation.shuffle_params(torch.Generator().manual_seed(3))
    assert all(((t.params >= 0) & (t.params < 1)).all() for t in PulseInformation.unique_gate_set)
    PulseInformation.reset_defaults()
    assert PulseInformation.get_envelope() == PulseInformation.DEFAULT_ENVELOPE


@pytest.mark.unittest
def test_update_params_reads_the_qoc_csv(tmp_path):
    path = tmp_path / "qoc_results.csv"
    path.write_text("RX,0.99,0.1,0.2,0.3\n")
    PulseInformation.update_params(str(path))
    JaxPulseInformation.update_params(str(path))
    assert np.allclose(_np(PulseInformation.OPTIMIZED_PULSES["RX"]),
                       np.asarray(JaxPulseInformation.OPTIMIZED_PULSES["RX"]))


@pytest.mark.unittest
def test_pulse_events_match_jax():
    def circuit(mod):
        def f():
            mod.RX(0.4, wires=0)
            mod.CZ(wires=[0, 1])
            mod.RZ(0.2, wires=1)
        return f

    _both_envelopes("gaussian")
    with jax_x64():
        ref = jjs.Script(circuit(JaxPulseGates), n_qubits=2).pulse_events()
    got = Script(circuit(PulseGates), n_qubits=2, device="cpu").pulse_events()
    assert [(e.gate, e.wires, e.carrier_phase) for e in got] == [
        (e.gate, list(e.wires), e.carrier_phase) for e in ref]
    assert [e.duration for e in got] == pytest.approx([e.duration for e in ref])
    assert [e.w for e in got] == pytest.approx([e.w for e in ref])


# ---------------------------------------------------------------------------
# The pulse-mode Model
# ---------------------------------------------------------------------------


def _pulse_pair(n, layers, seed=7):
    """A JAX and a port Circuit_19 model with the same parameters and pulse
    scalers perturbed off 1 (float64 port)."""
    jax_state = JaxPulseInformation.snapshot_state()
    jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type="Circuit_19", random_seed=seed)
    JaxPulseInformation.restore_state(jax_state)
    tm = Model(n_qubits=n, n_layers=layers, circuit_type="Circuit_19", random_seed=seed,
               device="cpu", dtype=torch.float64)
    pp = 1 + 0.05 * np.random.default_rng(seed).standard_normal(np.asarray(jm.pulse_params).shape)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params), pp)
    return jm, tm, pp


def _jax_tape(jm, params, pp, noise=None):
    with jax_recording() as tape:
        jm._variational(params, jnp.array([X]), pulse_params=pp, gate_mode="pulse",
                        noise_params=noise, random_key=jax.random.key(0))
    return tape


@pytest.fixture(scope="module")
def tape6():
    """The 6q, 2-layer Circuit_19 pulse tape in both packages, and the JAX
    tape's statevector."""
    jax_state = JaxPulseInformation.snapshot_state()
    state = PulseInformation.snapshot_state()
    try:
        jm, tm, pp = _pulse_pair(6, 2)
        with jax_x64():
            _both_envelopes("gaussian")
            jt = _jax_tape(jm, jnp.asarray(np.asarray(jm.params[0]), dtype=jnp.float64),
                           jnp.asarray(pp[0]))
            psi = np.asarray(jsim.simulate_pure(jt, 6))
            jt = [(o.name, list(o.wires), None if o.name == "Barrier" else np.asarray(o.matrix))
                  for o in jt]
        with recording() as tt, torch.no_grad():
            tm._variational(tm.params[0], torch.tensor([X], dtype=torch.float64),
                            pulse_params=tm.pulse_params[0], gate_mode="pulse")
        return jt, tt, psi, tm
    finally:
        JaxPulseInformation.restore_state(jax_state)
        PulseInformation.restore_state(state)


def _z(psi, n):
    probs = np.abs(psi.reshape((2,) * n)) ** 2
    return np.array([probs.sum(axis=tuple(a for a in range(n) if a != q)) @ [1, -1]
                     for q in range(n)])


@pytest.mark.unittest
def test_pulse_tape_matches_jax_operation_by_operation(tape6):
    jt, tt, _, _ = tape6
    assert len(tt) == len(jt) > 300
    for (name, wires, ref), op in zip(jt, tt):
        assert (op.name, op.wires) == (name, wires)
        if ref is not None:
            assert np.abs(_np(op.matrix) - ref).max() <= MAGNUS_TOL, name


@pytest.mark.unittest
def test_pulse_request_matches_simulate_pure(tape6):
    _, _, psi, tm = tape6
    PulseInformation.set_envelope("gaussian")
    before = Evolution.solve_calls
    got = tm(inputs=X, gate_mode="pulse")
    assert Evolution.solve_calls - before == 5  # RX, RY, RZ, CZ, H's correction
    assert np.abs(_np(got) - _z(psi, 6)).max() <= MAGNUS_TOL


@pytest.mark.unittest
def test_noisy_request_and_gradients_match_jax():
    """A 2q, 1-layer pulse model: the noisy request (``Depolarizing``)
    against ``simulate_mixed`` of the JAX package's eagerly recorded tape,
    and d mean<Z> / d params and d pulse_params, held along random
    directions against Richardson-extrapolated central differences of the
    JAX package's forward (``simulate_pure`` of its eager tape):
    ``|g . v - D_v f| <= 1e-8 max|g| |v|_1``.  (A full ``jax.grad``
    through the eager pulse tape costs ~55 s.)"""
    jm, tm, pp = _pulse_pair(2, 1)
    n, noise = 2, {"Depolarizing": 0.01}
    got = tm(inputs=X, gate_mode="pulse", noise_params=noise)
    tm.noise_params = None
    tm(inputs=X, gate_mode="pulse").mean().backward()
    grads = {"params": _np(tm.params.grad[0]), "pulse": _np(tm.pulse_params.grad[0])}
    params0 = np.asarray(jm.params[0], dtype=np.float64)

    def loss(params, pulse):
        psi = np.asarray(jsim.simulate_pure(_jax_tape(jm, jnp.asarray(params),
                                                      jnp.asarray(pulse)), n))
        return _z(psi, n).mean()

    rng = np.random.default_rng(11)
    with jax_x64():
        _both_envelopes("gaussian")
        jt = _jax_tape(jm, jnp.asarray(params0), jnp.asarray(pp[0]), noise=noise)
        probs = np.real(np.diag(np.asarray(jsim.simulate_mixed(jt, n)))).reshape(2, 2)
        ref = np.array([probs.sum(axis=1 - q) @ [1, -1] for q in range(n)])
        assert np.abs(_np(got) - ref).max() <= MAGNUS_TOL
        for which, g in grads.items():
            v = rng.uniform(-1, 1, size=g.shape)

            def f(t):
                if which == "params":
                    return loss(params0 + t * v, pp[0])
                return loss(params0, pp[0] + t * v)

            h = 1e-3
            d1 = (f(h) - f(-h)) / (2 * h)
            d2 = (f(h / 2) - f(-h / 2)) / h
            deriv = (4 * d2 - d1) / 3
            assert abs(float(g.ravel() @ v.ravel()) - deriv) <= \
                GRAD_REL * np.abs(g).max() * np.abs(v).sum(), which


@pytest.mark.unittest
def test_changed_pulse_params_are_read_from_a_cache_hit(monkeypatch):
    """A second request with other pulse scalers plans nothing new and
    answers with the new matrices."""
    calls = []
    real = tsim.plan_contractions
    monkeypatch.setattr(tsim, "plan_contractions",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    PulseInformation.set_envelope("gaussian")
    tm = Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", random_seed=3,
               device="cpu", dtype=torch.float64)
    fresh = Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", random_seed=3,
                  device="cpu", dtype=torch.float64)
    a = tm(inputs=X, gate_mode="pulse")
    planned = len(calls)
    scaled = torch.full_like(tm.pulse_params, 1.1)
    b = tm(inputs=X, gate_mode="pulse", pulse_params=scaled)
    assert len(calls) == planned == 1 and len(tm.script._plans) == 1
    assert not torch.allclose(a, b)
    fresh.script._plans.clear()
    assert torch.allclose(b, fresh(inputs=X, gate_mode="pulse", pulse_params=scaled),
                          atol=1e-14)


@pytest.mark.unittest
def test_three_batch_axes_vectorise_and_equal_the_loop():
    """3 inputs x 2 params x 2 pulse scalers: one vectorised batch equal to
    the loop over its elements (float64 1e-12, float32 1e-5)."""
    PulseInformation.set_envelope("gaussian")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tm = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", random_seed=2,
                   device="cpu", dtype=dtype)
        tm.params = torch.rand((2,) + tm._params_shape, generator=torch.Generator().manual_seed(0))
        pp = torch.ones((2,) + tm._pulse_params_shape, dtype=dtype)
        pp[1] *= 1.03
        xs = torch.tensor([0.1, -0.7, 1.9], dtype=dtype)
        params = tm.params.detach().clone()
        got = tm(inputs=xs, pulse_params=pp, gate_mode="pulse")
        assert got.shape == (3, 2, 2, 2) and tm.script.routes[-1] == "vectorised"
        loop = torch.stack([tm(params=params[i], inputs=x, pulse_params=pp[j], gate_mode="pulse")
                            for x in xs for i in range(2) for j in range(2)]).reshape(got.shape)
        assert (got - loop).abs().max() <= tol
    tm.repeat_batch_axis = [True, True, False]
    assert tm(inputs=xs, params=params, pulse_params=pp[:1], gate_mode="pulse").shape == (3, 2, 2)


@pytest.mark.unittest
def test_pulse_mode_validation():
    PulseInformation.set_envelope("gaussian")
    tm = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", device="cpu")
    with pytest.raises(ValueError):
        tm(inputs=X, pulse_params=tm.pulse_params)  # unitary mode
    with pytest.raises(ValueError):
        tm(inputs=X, gate_mode="pulse", pulse_params=torch.ones(1, 2, 3))
    with pytest.raises(ValueError):
        tm(inputs=X, gate_mode="warp")
    with pytest.raises(TypeError):
        Gates.RX(0.1, wires=0, pulse_params=[1j, 2, 3], gate_mode="pulse")
    with pytest.raises(ValueError):
        Gates.RX(0.1, wires=0, pulse_params=[1.0, 2.0], gate_mode="pulse")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeWarning):
            with recording():
                tm._variational(tm.params[0], torch.tensor([X]), gate_mode="pulse")
    fresh = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", device="cpu")
    assert fresh.pulse_params.shape == (1,) + fresh._pulse_params_shape
    assert fresh._pulse_params_shape[1] == fresh.pqc.n_pulse_params_per_layer(2)


@pytest.mark.unittest
def test_pulse_params_counts_match_jax():
    from qml_essentials_tpu.models.ansaetze import Ansaetze as JaxAnsaetze
    from qml_essentials_tpu_torch.models.ansaetze import Ansaetze

    _both_envelopes("gaussian")
    for circuit in ["Circuit_19", "Circuit_1", "Circuit_6", "Hardware_Efficient",
                    "Strongly_Entangling", "GHZ", "No_Ansatz"]:
        for n in (2, 4):
            assert getattr(Ansaetze, circuit).n_pulse_params_per_layer(n) == \
                getattr(JaxAnsaetze, circuit).n_pulse_params_per_layer(n), (circuit, n)


@pytest.mark.unittest
def test_pulse_slice_imports_no_jax_in_a_fresh_process():
    """Importing the pulse slice (and running a pulse gate) loads neither
    JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import qml_essentials_tpu_torch.pulse.qoc, qml_essentials_tpu_torch.pulses\n"
        "import qml_essentials_tpu_torch.evolution, qml_essentials_tpu_torch.qoc\n"
        "from qml_essentials_tpu_torch.pulse.pulses import PulseGates\n"
        "from qml_essentials_tpu_torch.ops.tape import recording\n"
        "with recording() as t:\n"
        "    PulseGates.H(wires=0)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'qml_essentials_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(t))\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"
