"""The PyTorch port's noisy density engine against the JAX package.

Noise channels, the density plain functions, the interleaved lowering and
plan, ``simulate_and_measure`` on noisy tapes (both density engines),
``Model`` with every noise knob, ``GateError`` and the noisy density
gradient, at small sizes.

Tolerances: superoperators, lowered operators and the plain functions to
1e-12 and the small-state answers to 1e-10 (float64 on both sides, JAX with
x64 enabled; in the large-state regime, its threshold lowered to the test
width on both sides as tests/test_torch_plan.py does, the JAX package's
Pallas kernels run in interpret mode); the interleaved plan's windows to
1e-6 (complex64 compositions on both sides); the gradient to 1e-4 of max|g|
+ 1e-6 (float32, f32 lambda on both sides, Pallas in interpret mode at full
float32 precision).  GateError draws differ between the packages' generators, so
its tests compare distributions.
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import executor as jax_executor
from qml_essentials_tpu.models.ansaetze import Ansaetze as JaxAnsaetze
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.models.unitary import UnitaryGates as JaxGates
from qml_essentials_tpu.ops import kernels as jk
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import saved as jax_saved
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.models.unitary import UnitaryGates
from qml_essentials_tpu_torch.ops import adjoint, saved
from qml_essentials_tpu_torch.ops import kernels as tk
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

EXACT_TOL = 1e-12
ANSWER_TOL = 1e-10
MAT_TOL = 1e-6
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
X = 0.37

ALL_NOISE = {
    "BitFlip": 0.02, "PhaseFlip": 0.03, "Depolarizing": 0.025, "MultiQubitDepolarizing": 0.02,
    "AmplitudeDamping": 0.04, "PhaseDamping": 0.03, "StatePreparation": 0.02,
    "Measurement": 0.03, "ThermalRelaxation": {"t1": 100.0, "t2": 150.0, "t_factor": 0.1},
}


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128, as they are when the package is imported under x64 (a
    channel's sqrt(p) * constant stays complex64 otherwise)."""
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


def _large_regime(mp, n):
    """Both packages schedule from n doubled wires (the JAX package's Pallas
    kernels in interpret mode, full float32 precision, f32 lambda)."""
    mp.setattr(pallas_kernels, "ENABLED", True)
    mp.setattr(pallas_kernels, "PALLAS_MIN_N", n)
    mp.setattr(pallas_kernels, "INTERPRET", True)
    mp.setattr(pallas_kernels, "GRAM_MODE", "split3")
    mp.setattr(pallas_kernels, "PRECISION_MODE", "highest")
    mp.setattr(jsim, "USE_CHAINS", False)
    mp.setattr(jax_saved, "LAMBDA_MODE", "f32")
    mp.setattr(tsim, "LARGE_STATE_MIN_N", n)
    mp.setattr(saved, "LAMBDA_MODE", "f32")


def _models(n, circuit="Circuit_19", layers=2, dtype=torch.float64, **kw):
    jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type=circuit, random_seed=5, **kw)
    tm = Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu", dtype=dtype, **kw)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    return jm, tm


def _tapes(jm, tm, noise, x=X):
    """The noisy tape of one forward in each package."""
    jm.noise_params, tm.noise_params = noise, noise
    with jax_recording() as jt:
        jm._variational(jnp.asarray(np.asarray(jm.params[0])), jnp.array([x]),
                        random_key=jax.random.key(0), noise_params=jm.noise_params)
    with recording() as tt, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([x], dtype=tm.dtype),
                        random_key=torch.Generator(), noise_params=tm.noise_params)
    return jt, tt


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------

_KRAUS = np.random.default_rng(3).normal(size=(3, 4, 4)) + 0j

CHANNELS = {
    "BitFlip": lambda m, g: m.BitFlip(0.13, wires=0),
    "PhaseFlip": lambda m, g: m.PhaseFlip(0.21, wires=0),
    "Depolarizing": lambda m, g: m.DepolarizingChannel(0.07, wires=0),
    "AmplitudeDamping": lambda m, g: m.AmplitudeDamping(0.3, wires=0),
    "PhaseDamping": lambda m, g: m.PhaseDamping(0.17, wires=0),
    "Thermal-Markovian": lambda m, g: m.ThermalRelaxationError(0.2, 100.0, 80.0, 5.0, wires=0),
    "Thermal-Choi": lambda m, g: m.ThermalRelaxationError(0.7, 100.0, 150.0, 5.0, wires=0),
    "NQubitDepolarizing-2": lambda m, g: g.NQubitDepolarizingChannel(0.05, [0, 1]),
    "NQubitDepolarizing-3": lambda m, g: g.NQubitDepolarizingChannel(0.05, [2, 0, 1]),
    "QubitChannel": lambda m, g: m.QubitChannel(list(_KRAUS), wires=[1, 0]),
}


@pytest.mark.unittest
@pytest.mark.parametrize("name", list(CHANNELS))
def test_channel_superoperator_matches_jax(name):
    """Σ K ⊗ conj(K) of every channel (the Choi branch's eigenvector phases
    differ between the packages; the superoperator does not)."""
    with jax_x64():
        jop = CHANNELS[name](jo, JaxGates)
        js, jw = jsim._channel_superop(jop)
        js = np.asarray(js)
    top = CHANNELS[name](to, UnitaryGates)
    ts, tw = tsim._channel_superop(top)
    assert tw == list(jw) and ts.dtype == torch.complex128
    assert np.abs(_np(ts) - js).max() <= EXACT_TOL
    if name != "QubitChannel":  # a trace-preserving channel: sum K^dag K = 1
        kraus = top.kraus_matrices()
        eye = sum(K.conj().T @ K for K in kraus)
        assert (eye - torch.eye(eye.shape[0], dtype=eye.dtype)).abs().max() <= EXACT_TOL


INVALID = {
    "p<0": lambda m, g: m.BitFlip(-0.1, wires=0),
    "p>1": lambda m, g: m.DepolarizingChannel(1.5, wires=0),
    "gamma>1": lambda m, g: m.AmplitudeDamping(2.0, wires=0),
    "pe>1": lambda m, g: m.ThermalRelaxationError(1.2, 100.0, 80.0, 5.0, wires=0),
    "t1<=0": lambda m, g: m.ThermalRelaxationError(0.2, 0.0, 80.0, 5.0, wires=0),
    "t2<=0": lambda m, g: m.ThermalRelaxationError(0.2, 100.0, 0.0, 5.0, wires=0),
    "t2>2t1": lambda m, g: m.ThermalRelaxationError(0.2, 100.0, 201.0, 5.0, wires=0),
    "tg<0": lambda m, g: m.ThermalRelaxationError(0.2, 100.0, 80.0, -1.0, wires=0),
    "nq-p": lambda m, g: g.NQubitDepolarizingChannel(1.5, [0, 1]),
    "nq-one-wire": lambda m, g: g.NQubitDepolarizingChannel(0.1, [0]),
}


@pytest.mark.unittest
@pytest.mark.parametrize("case", list(INVALID))
def test_channel_validation_errors_match_jax(case):
    with pytest.raises(ValueError):
        INVALID[case](jo, JaxGates)
    with pytest.raises(ValueError):
        INVALID[case](to, UnitaryGates)


@pytest.mark.unittest
def test_channels_refuse_pure_states():
    op = to.BitFlip(0.1, wires=0)
    with pytest.raises(TypeError):
        op.matrix
    with pytest.raises(TypeError):
        op.apply_to_state_ri(tk.zero_state_ri(1, torch.float64), 1)


# ---------------------------------------------------------------------------
# The density plain functions
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("what", ["unitary", "kraus", "zero"])
def test_density_plain_functions_match_jax(what):
    n = 3
    rng = np.random.default_rng(7)
    rho2 = rng.normal(size=(2, 4**n))
    u = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
    with jax_x64():
        if what == "unitary":
            ref = jk.apply_unitary_to_density_flat_ri(jnp.asarray(rho2), jnp.asarray(u), [2, 0], n)
        elif what == "kraus":
            kraus = jo.AmplitudeDamping(0.3, wires=1).kraus_matrices()
            ref = jk.apply_kraus_to_density_flat_ri(jnp.asarray(rho2), kraus, [1], n)
        else:
            ref = jk.zero_density_ri(n)
        ref = np.asarray(ref)
    r2 = torch.from_numpy(rho2)
    if what == "unitary":
        got = tk.apply_unitary_to_density_flat_ri(r2, torch.from_numpy(u), [2, 0], n)
    elif what == "kraus":
        got = tk.apply_kraus_to_density_flat_ri(
            r2, to.AmplitudeDamping(0.3, wires=1).kraus_matrices(), [1], n)
    else:
        got = tk.zero_density_ri(n, torch.float64)
    assert got.shape == ref.shape and np.abs(_np(got) - ref).max() <= EXACT_TOL


# ---------------------------------------------------------------------------
# Lowering and planning
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_lower_interleaved_tape_matches_jax():
    """A 5q Circuit_19 tape with every noise knob (MultiQubitDepolarizing a
    two-wire QubitChannel) lowers to the same doubled operators."""
    with jax_x64():
        jm, tm = _models(5)
        jt, tt = _tapes(jm, tm, ALL_NOISE)
        jd = jsim._lower_interleaved_tape(jt, 5)
        jmats = [(list(o.wires), np.asarray(o.matrix)) for o in jd]
    td = tsim._lower_interleaved_tape(tt, 5)
    assert len(td) == len(jmats) > 300
    for o, (jw, jm_) in zip(td, jmats):
        assert list(o.wires) == jw
        assert np.abs(_np(o.matrix) - jm_).max() <= EXACT_TOL


NOT_LOWERABLE = {
    "channel-4-wires": lambda m: m.QubitChannel([np.eye(16)], wires=[0, 1, 2, 3]),
    "gate-6-wires": lambda m: m.Hermitian(np.eye(64), wires=[0, 1, 2, 3, 4, 5]),
    "scattered-diagonal": lambda m: m.DiagonalQubitUnitary(
        (jnp if m is jo else torch).ones(4, dtype=(jnp.complex64 if m is jo else torch.complex64)),
        wires=[0, 2]),
}


@pytest.mark.unittest
@pytest.mark.parametrize("case", list(NOT_LOWERABLE))
def test_lowering_refuses_what_jax_refuses(case):
    """``None`` in the same cases; the ket-then-bra engine takes them."""
    with jax_recording() as jt:
        jo.RX(0.3, wires=0)
        jo.BitFlip(0.1, wires=1)
        NOT_LOWERABLE[case](jo)
    with recording() as tt:
        to.RX(0.3, wires=0)
        to.BitFlip(0.1, wires=1)
        NOT_LOWERABLE[case](to)
    assert jsim._lower_interleaved_tape(jt, 6) is None
    assert tsim._lower_interleaved_tape(tt, 6) is None


@pytest.mark.unittest
def test_interleaved_plan_matches_jax(monkeypatch):
    """8 data qubits on 16 doubled wires, the regime lowered to 16: the same
    steps (kinds, wires, rotations), windows to 1e-6, the same start."""
    _large_regime(monkeypatch, 16)
    jm, tm = _models(8, dtype=torch.float32)
    jt, tt = _tapes(jm, tm, {"Depolarizing": 0.01, "AmplitudeDamping": 0.02})
    jd = jsim._lower_interleaved_tape(jt, 8)
    jplan = jsim.plan_contractions(jd, n_qubits=16)
    peeled, jpsi2 = jsim._zero_state_prefix(jplan, 16)
    jplan = jsim.schedule_layout(jsim._drop_indices(jplan, peeled), 16)
    plan, psi2 = tsim.interleaved_plan(tsim._lower_interleaved_tape(tt, 8), 16)
    assert "rot" in [s[0] for s in plan] and len(plan) == len(jplan)
    assert np.abs(_np(psi2) - np.asarray(jpsi2)).max() <= MAT_TOL
    for (tk_, tp, tw), (jk_, jp, jw) in zip(plan, jplan):
        assert tk_ == jk_ and list(tw) == list(jw)
        if tk_ == "rot":
            assert tp == jp
        else:
            tmat, jmat = (tp[1], jp[1]) if tk_ in ("rotmat", "matrot") else (tp, jp)
            if tk_ in ("rotmat", "matrot"):
                assert tp[0] == jp[0]
            assert np.abs(_np(tmat) - np.asarray(jmat)).max() <= MAT_TOL


@pytest.mark.unittest
def test_interleaved_plan_ignores_chains(monkeypatch):
    """USE_CHAINS leaves the density plan alone."""
    _large_regime(monkeypatch, 16)
    _, tm = _models(8, dtype=torch.float32)
    tm.noise_params = {"Depolarizing": 0.01}
    with recording() as tt, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([X]), random_key=torch.Generator(),
                        noise_params=tm.noise_params)
    dtape = tsim._lower_interleaved_tape(tt, 8)
    plans = []
    for on in (False, True):
        monkeypatch.setattr(tsim, "USE_CHAINS", on)
        plans.append([(k, list(w)) for k, _, w in tsim.interleaved_plan(dtape, 16)[0]])
    assert plans[0] == plans[1]


@pytest.mark.unittest
def test_statevector_planners_refuse_channels():
    """The chain planner gives ``None`` for a noisy tape in both packages,
    and the plan normaliser of the statevector executors refuses one."""
    from qml_essentials_tpu.ops import chains as jax_chains
    from qml_essentials_tpu_torch.ops import chains

    with recording() as tt:
        to.RY(0.3, wires=0)
        to.BitFlip(0.1, wires=1)
    with jax_recording() as jt:
        jo.RY(0.3, wires=0)
        jo.BitFlip(0.1, wires=1)
    assert chains.plan_chains(tt, 20) is None and jax_chains.plan_chains(jt, 20) is None
    plan = tsim.plan_contractions(tt, max_width=2)
    assert [k for k, _, _ in plan] == ["op", "op"] and plan[1][1] is tt[1]  # a flush
    with pytest.raises(TypeError):
        adjoint.normalize_plan(plan, 2)


# ---------------------------------------------------------------------------
# simulate_and_measure
# ---------------------------------------------------------------------------


def _obs(m, n):
    return [m.PauliZ(wires=q, record=False) for q in range(n)] + [
        m.PauliX(wires=1, record=False)]


def _answers(sim, tape, n, obs, **kw):
    return {t: sim.simulate_and_measure(tape, n, t, obs if t == "expval" else [], True, **kw)
            for t in ("expval", "probs", "density")}


@pytest.mark.unittest
@pytest.mark.parametrize("engine", ["interleaved", "ket-then-bra"])
def test_small_state_answers_match_jax(engine):
    """4 data qubits, float64: expval (with a non-diagonal observable), probs
    and density through the interleaved engine, and through the ket-then-bra
    engine when a 4-wire channel blocks the lowering."""
    noise = {"Depolarizing": 0.03, "AmplitudeDamping": 0.05, "MultiQubitDepolarizing": 0.02}
    with jax_x64():
        jm, tm = _models(4)
        jt, tt = _tapes(jm, tm, noise)
        if engine == "ket-then-bra":
            k = np.eye(16) * np.sqrt(0.9)
            jt.append(jo.QubitChannel([k, np.sqrt(0.1) * np.eye(16)], wires=[3, 1, 0, 2]))
            tt.append(to.QubitChannel([k, np.sqrt(0.1) * np.eye(16)], wires=[3, 1, 0, 2]))
        assert (jsim._lower_interleaved_tape(jt, 4) is None) == (engine == "ket-then-bra")
        ref = {t: np.asarray(v) for t, v in _answers(jsim, jt, 4, _obs(jo, 4)).items()}
    got = _answers(tsim, tt, 4, _obs(to, 4), dtype=torch.float64)
    for t in ref:
        assert got[t].shape == ref[t].shape and np.abs(_np(got[t]) - ref[t]).max() <= ANSWER_TOL


@pytest.mark.unittest
def test_large_state_answers_match_jax_and_engines_agree(monkeypatch):
    """7 data qubits on 14 wires, the regime lowered to 14 (scheduled plans,
    the JAX package's Pallas kernels in interpret mode), float64 on both
    sides: the interleaved answers to 1e-10, and the port's two engines
    agree to 1e-10."""
    _large_regime(monkeypatch, 14)
    noise = {"Depolarizing": 0.03, "PhaseDamping": 0.05}
    with jax_x64():
        jm, tm = _models(7)
        jt, tt = _tapes(jm, tm, noise)
        rho2il = jsim._simulate_interleaved_ri(jsim._lower_interleaved_tape(jt, 7), 14)
        ref = {t: np.asarray(jsim._measure_interleaved_ri(
            rho2il, 7, t, _obs(jo, 7) if t == "expval" else [])) for t in ("expval", "probs",
                                                                          "density")}
    got = _answers(tsim, tt, 7, _obs(to, 7), dtype=torch.float64)
    for t in ref:
        assert np.abs(_np(got[t]) - ref[t]).max() <= ANSWER_TOL

    rho_il = tsim._simulate_interleaved_ri(tsim._lower_interleaved_tape(tt, 7), 14, torch.float64)
    rho_kb = tsim.simulate_mixed_ri(tt, 7, torch.float64)
    assert np.abs(_np(tsim._deinterleave_ri(rho_il, 7) - rho_kb)).max() <= ANSWER_TOL


@pytest.mark.unittest
def test_noise_free_density_is_the_outer_product():
    """A noise-free density request runs the statevector and one outer
    product; its lowered tape gives the same matrix."""
    _, tm = _models(4)
    with recording() as tape, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([X], dtype=torch.float64))
    rho = tsim.simulate_and_measure(tape, 4, "density", [], True, dtype=torch.float64)
    psi = tsim.simulate_and_measure(tape, 4, "state", [], False, dtype=torch.float64)
    assert (rho - torch.outer(psi, psi.conj())).abs().max() <= ANSWER_TOL
    rho_il = tsim._simulate_interleaved_ri(tsim._lower_interleaved_tape(tape, 4), 8, torch.float64)
    got = tk.from_ri(tsim._deinterleave_ri(rho_il, 4)).reshape(16, 16)
    assert (got - rho).abs().max() <= ANSWER_TOL


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

KNOBS = {
    "BitFlip": {"BitFlip": 0.05},
    "PhaseFlip": {"PhaseFlip": 0.05},
    "Depolarizing": {"Depolarizing": 0.05},
    "MultiQubitDepolarizing": {"MultiQubitDepolarizing": 0.05},
    "AmplitudeDamping": {"AmplitudeDamping": 0.1},
    "PhaseDamping": {"PhaseDamping": 0.1},
    "StatePreparation": {"StatePreparation": 0.05},
    "Measurement": {"Measurement": 0.05},
    "Thermal-Markovian": {"ThermalRelaxation": {"t1": 100.0, "t2": 80.0, "t_factor": 0.5}},
    "Thermal-Choi": {"ThermalRelaxation": {"t1": 100.0, "t2": 150.0, "t_factor": 0.5}},
    "all": ALL_NOISE,
}


@pytest.mark.unittest
@pytest.mark.parametrize("circuit", ["Circuit_19", "Circuit_15"])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_model_noise_matches_jax(circuit, knob, monkeypatch):
    """4 qubits, float64: expval on [0, [1, 2]], probs on [0, 2] and the
    density of [1, 3]."""
    monkeypatch.setattr(jax_executor, "JIT_SINGLE", False)  # eager: no compile per knob
    inputs = -0.8
    with jax_x64():
        jm, tm = _models(4, circuit)
        for out, et in (([0, [1, 2]], "expval"), ([0, 2], "probs"), ([1, 3], "density")):
            jm.output_qubit = tm.output_qubit = out
            ref = np.asarray(jm(jm.params, inputs=inputs, noise_params=KNOBS[knob],
                                execution_type=et))
            got = tm(inputs=inputs, noise_params=KNOBS[knob], execution_type=et)
            assert got.shape == ref.shape
            assert np.abs(_np(got) - ref).max() <= ANSWER_TOL


@pytest.mark.unittest
def test_canon_noise_matches_jax():
    """Defaults filled in, unknown keys warned about, a degenerate thermal
    setting warned about and switched off, all-zero dicts meaning no noise."""
    cases = [
        {"BitFlip": 0.1, "Bogus": 0.2},
        {"ThermalRelaxation": {"t1": 10.0, "t2": 5.0, "t_factor": 0.1, "extra": 1.0}},
        {"ThermalRelaxation": {"t1": 10.0, "t2": 25.0, "t_factor": 0.1}},
        {"ThermalRelaxation": {"t1": 10.0, "t2": 5.0}},
        {"BitFlip": 0.0, "Depolarizing": 0.0},
        None,
    ]
    import warnings

    for kvs, warns in zip(cases, (1, 1, 1, 1, 0, 0)):
        said = []
        for canon in (Model._canon_noise, JaxModel._canon_noise):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = canon(kvs)
            said.append((out, sorted(str(w.message) for w in caught)))
        assert said[0] == said[1]
        assert len(said[0][1]) == warns
    assert said[0][0] is None


@pytest.mark.unittest
@pytest.mark.parametrize("circuit", [c.__name__ for c in JaxAnsaetze.get_available()])
def test_circuit_depth_matches_jax(circuit):
    jm, tm = _models(4, circuit, dtype=torch.float32)
    assert tm._get_circuit_depth() == jm._get_circuit_depth()
    assert not tm._zero_inputs  # the depth's zero-input recording leaves no trace


# ---------------------------------------------------------------------------
# GateError
# ---------------------------------------------------------------------------


def _perturbed(sigma, count=1, w=0.0):
    gen = torch.Generator().manual_seed(11)
    with recording() as tape:
        for _ in range(count):
            UnitaryGates.RX(w, wires=0, noise_params={"GateError": sigma}, random_key=gen)
    return torch.stack([op.theta for op in tape if isinstance(op, to.RX)]).double()


@pytest.mark.unittest
def test_gate_error_zero_is_noise_free():
    """sigma = 0 leaves every angle as it was: the same gates, the same
    answers as without the knob."""
    thetas = _perturbed(0.0, 5, w=0.37)
    assert (thetas == torch.tensor(0.37, dtype=torch.float64)).all()  # the Python float, exactly
    _, tm = _models(4)
    ref = tm(inputs=X, noise_params={"BitFlip": 0.02}).detach()
    got = tm(inputs=X, noise_params={"BitFlip": 0.02, "GateError": 0.0}).detach()
    assert torch.equal(got, ref)


@pytest.mark.unittest
def test_gate_error_distribution():
    """Perturbations of sigma = 0.2 over 4000 gates: mean 0 and std sigma,
    each within 5 statistical errors; the JAX package's draws too."""
    sigma, count = 0.2, 4000
    for draws in (_perturbed(sigma, count).numpy(), _jax_perturbed(sigma, count)):
        assert abs(draws.mean()) <= 5 * sigma / np.sqrt(count)
        assert abs(draws.std() - sigma) <= 5 * sigma / np.sqrt(2 * count)


def _jax_perturbed(sigma, count):
    key = jax.random.key(11)
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        w, _ = JaxGates.GateError(jnp.asarray(0.0), {"GateError": sigma}, sub)
        out.append(float(w))
    return np.array(out)


@pytest.mark.unittest
@pytest.mark.parametrize("batched", [True, False])
def test_gate_error_batch_broadcast(batched, monkeypatch):
    """batch_gate_error=False broadcasts one sample across the batch: equal
    inputs give equal answers; True draws per element."""
    monkeypatch.setattr(UnitaryGates, "batch_gate_error", batched)
    _, tm = _models(4, dtype=torch.float64)
    out = tm(inputs=[X, X, X], noise_params={"GateError": 0.3}).detach()
    tm.noise_params = None
    clean = tm(inputs=X).detach()
    assert (out[0] - clean).abs().max() > 1e-3
    spread = (out - out[0]).abs().max().item()
    assert (spread > 1e-3) if batched else (spread == 0.0)


# ---------------------------------------------------------------------------
# Gradient
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_density_gradient_matches_jax(monkeypatch):
    """8 data qubits (16 doubled wires, the regime lowered to 16), one layer
    and its closing layer: the gradient of the mean <Z> through the port's
    saved executor against the JAX package's interleaved saved gradient
    (f32 lambda both sides)."""
    _large_regime(monkeypatch, 16)
    noise = {"Depolarizing": 0.01}
    jm, tm = _models(8, layers=1, dtype=torch.float32)
    jm.noise_params = tm.noise_params = noise
    obs = [jo.PauliZ(wires=q, record=False) for q in range(8)]

    def loss(p):
        with jax_recording() as tape:
            jm._variational(p[0], jnp.array([X]), random_key=jax.random.key(0),
                            noise_params=jm.noise_params)
        return jsim.simulate_and_measure(tape, 8, "expval", obs, True).mean()

    ref = np.asarray(jax.jit(jax.grad(loss))(jm.params), np.float64)
    calls = []
    real = saved.execute_plan_saved_ri
    monkeypatch.setattr(saved, "execute_plan_saved_ri",
                        lambda *a: calls.append(1) or real(*a))
    tm(inputs=X).mean().backward()
    got = tm.params.grad.double().numpy()
    assert calls == [1] and got.shape == ref.shape
    assert np.abs(got - ref).max() <= GRAD_REL * np.abs(ref).max() + GRAD_ABS


@pytest.mark.unittest
@pytest.mark.parametrize("forcing", ["adjoint-mode", "line-lowered", "chains-on"])
def test_density_gradient_takes_the_saved_executor(forcing, monkeypatch):
    """What sends a statevector gradient to the adjoint (a forced mode, the
    0.35 line below the residuals) or to the chain plan leaves a density
    gradient on the saved executor, with the same gradient."""
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", 14)
    _, tm = _models(7, layers=1, dtype=torch.float32)
    tm.noise_params = {"Depolarizing": 0.02}
    tm(inputs=X).mean().backward()
    ref = tm.params.grad.clone()
    tm.params.grad = None
    if forcing == "adjoint-mode":
        monkeypatch.setattr(tsim, "BACKWARD_MODE", "adjoint")
    elif forcing == "line-lowered":
        monkeypatch.setattr(tsim, "_RESIDUAL_MEM_FRACTION", 0.0)
    else:
        monkeypatch.setattr(tsim, "USE_CHAINS", True)
    calls = []
    real = saved.execute_plan_saved_ri
    monkeypatch.setattr(saved, "execute_plan_saved_ri", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(adjoint, "execute_plan_ri",
                        lambda *a: pytest.fail("a density gradient reached the adjoint"))
    tm(inputs=X).mean().backward()
    assert calls == [1]
    assert (tm.params.grad - ref).abs().max() <= 1e-7
