"""The PyTorch port's analysis stack against the JAX package: the Pauli
algebra, quantum-information math (fidelities, QFI), the Pauli-Clifford
transform, entanglement measures and expressibility.

Both packages get the same inputs, made with numpy from a seed, at float64
(JAX with x64 enabled); parameter sets are carried across with
``Model.load_numpy``, never by seeding both generators alike.  Tolerances:
Pauli words, decompositions and the canonical form exact in their labels,
coefficients and angles to 1e-12; fidelity, trace distance and phase
difference to 1e-12; QFI and the Fubini-Study metric to 1e-9 (the port's
reverse-mode Jacobian against ``jax.jacfwd``); the entanglement measures on a
carried batch of three parameter sets to 1e-10, the relative entropy and the
entanglement of formation to 1e-8 (matrix logarithms and an
eigendecomposition in between); expressibility fidelities to
FIDELITY_TOL (below), then equal histograms and KL divergences.  Sampled paths draw from each
package's own generator and are compared by distribution.

One tolerance is set from the arithmetic of the quantity itself: the
Uhlmann fidelity of rank-deficient (pure) states takes square roots of
eigenvalues that are rounding noise (~1e-17, so ~3e-9 each), which puts the
sampled pure-state fidelities of either package ~1e-7 from the exact
value; they are held to FIDELITY_TOL = 1e-6, and full-rank states to 1e-12.
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.analysis import entanglement as jent
from qml_essentials_tpu.analysis import math as jmath
from qml_essentials_tpu.analysis.expressibility import Expressibility as JExpr
from qml_essentials_tpu.analysis.pauli import PauliCircuit as JPauliCircuit
from qml_essentials_tpu.core import jaqsi as jax_jaqsi
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.analysis import entanglement as tent
from qml_essentials_tpu_torch.analysis import math as tmath
from qml_essentials_tpu_torch.analysis.expressibility import Expressibility
from qml_essentials_tpu_torch.analysis.pauli import PauliCircuit
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import kernels as tk
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import tape as ttape
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

EXACT = 1e-12
QFI_TOL = 1e-9
MEASURE_TOL = 1e-10
LOG_TOL = 1e-8
FIDELITY_TOL = 1e-6  # pure states through the Uhlmann formula (module docstring)
X = 0.37


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128, as they are when the package is imported under x64 (H's
    1/sqrt(2) recomputed in float64: a float32 one is 3e-8 off)."""
    promoted = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                cls._matrix = m.astype(jnp.complex128)
        jo.H._matrix = jnp.asarray(np.array([[1, 1], [1, -1]]) / np.sqrt(2.0), jnp.complex128)
        yield
    finally:
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x)


def _pair(n, layers, circuit, seed=11, batch=1, **kw):
    """A JAX model and a float64 CPU port model computing the same function:
    the JAX model's parameters, redrawn with numpy, carried to the port."""
    snapshot = PulseInformation.snapshot_state()
    try:
        jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type=circuit, **kw)
    finally:
        PulseInformation.restore_state(snapshot)  # JaxModel() sets the pulse envelope
    tm = Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu",
               dtype=torch.float64, **kw)
    shape = (batch, *np.asarray(jm.params).shape[1:])
    params = np.random.default_rng(seed).uniform(0, 2 * np.pi, shape)
    jm.params = jnp.asarray(params)
    tm.load_numpy(params)
    return jm, tm


# ---------------------------------------------------------------------------
# Pauli algebra
# ---------------------------------------------------------------------------


def _random_label(rng, n):
    return "".join(rng.choice(list("IXYZ"), size=n))


@pytest.mark.unittest
@pytest.mark.parametrize("seed", range(4))
def test_pauli_word_algebra_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4
    for _ in range(12):
        la, lb = _random_label(rng, n), _random_label(rng, n)
        wires = [int(w) for w in rng.permutation(n)]
        ja = jo.PauliWord.from_pauli_string(la, wires, n)
        jb = jo.PauliWord.from_pauli_string(lb, list(range(n)), n)
        ta = to.PauliWord.from_pauli_string(la, wires, n)
        tb = to.PauliWord.from_pauli_string(lb, list(range(n)), n)
        for j, t in ((ja, ta), (jb, tb), (ja.compose(jb), ta.compose(tb)),
                     (jb.compose(ja), tb.compose(ta))):
            assert (t.xm, t.zm, t.n, t.phase) == (j.xm, j.zm, j.n, j.phase)
            assert t.to_pauli_string_and_phase() == j.to_pauli_string_and_phase()
            assert np.array_equal(t.xy_mask, j.xy_mask)
            assert t.zero_expectation() == j.zero_expectation()
            assert np.array_equal(t.to_list_repr(), j.to_list_repr())
            assert np.abs(_np(t.to_matrix()) - np.asarray(j.to_matrix())).max() <= EXACT
        assert ta.commutes_with(tb) == ja.commutes_with(jb)
        back = to.PauliWord.from_matrix(ta.to_matrix())
        assert back == ta


_CLIFFORDS = [("H", [1]), ("S", [2]), ("PauliX", [0]), ("CX", [0, 2]), ("CZ", [3, 1]),
              ("CY", [1, 2]), ("SWAP", [2, 0])]


@pytest.mark.unittest
@pytest.mark.parametrize("adjoint_left", [False, True])
def test_clifford_conjugation_matches_jax(adjoint_left):
    rng = np.random.default_rng(5)
    n = 4
    for _ in range(10):
        label = _random_label(rng, n)
        jw = jo.PauliWord.from_pauli_string(label, list(range(n)), n)
        tw = to.PauliWord.from_pauli_string(label, list(range(n)), n)
        for name, wires in _CLIFFORDS:
            jc = getattr(jo, name)(wires=wires, record=False)
            tc = getattr(to, name)(wires=wires, record=False)
            j = jw.conjugate_by_clifford(jc, adjoint_left=adjoint_left)
            t = tw.conjugate_by_clifford(tc, adjoint_left=adjoint_left)
            assert t == to.PauliWord._make(j.xm, j.zm, j.n, j.phase), (name, label)
            # The dense fallback (a 3-qubit Clifford has no table) agrees too.
            dense = tw._conjugate_via_matrix(tc, adjoint_left)
            assert dense == t, (name, label)


@pytest.mark.unittest
def test_dense_pauli_helpers_match_jax():
    rng = np.random.default_rng(7)
    with jax_x64():
        for label in ("ZIX", "YY", "IZI", "X"):
            k = len(label)
            coeff = rng.normal() + 1j * rng.normal()
            jm = coeff * np.asarray(jo.PauliWord.from_pauli_string(label, list(range(k)), k)
                                    .to_matrix())
            jc, jop = jo.pauli_decompose(jnp.asarray(jm), wire_order=[3, 1, 4][:k])
            tc, top = to.pauli_decompose(torch.from_numpy(jm), wire_order=[3, 1, 4][:k])
            assert abs(complex(tc) - complex(jc)) <= EXACT
            assert top._pauli_label == jop._pauli_label and top.wires == jop.wires
            assert to.pauli_string_from_operation(top) == jo.pauli_string_from_operation(jop)
        for (cname, cw), (pname, pw) in ((("CX", [0, 1]), ("PauliZ", [1])),
                                         (("S", [2]), ("PauliX", [2])),
                                         (("CZ", [0, 2]), ("PauliY", [0]))):
            for adj in (True, False):
                j = jo.evolve_pauli_with_clifford(getattr(jo, cname)(wires=cw, record=False),
                                                  getattr(jo, pname)(wires=pw, record=False),
                                                  adjoint_left=adj)
                t = to.evolve_pauli_with_clifford(getattr(to, cname)(wires=cw, record=False),
                                                  getattr(to, pname)(wires=pw, record=False),
                                                  adjoint_left=adj)
                assert t.wires == j.wires
                assert np.abs(_np(t.matrix) - np.asarray(j.matrix)).max() <= EXACT
        a, b = rng.uniform(0, 2 * np.pi, 2)
        jp = jo.prod(jo.RX(a, wires=0, record=False), jo.CZ(wires=[0, 2], record=False),
                     jo.RY(b, wires=1, record=False))
        tp = to.prod(to.RX(torch.tensor(a), wires=0, record=False),
                     to.CZ(wires=[0, 2], record=False), to.RY(torch.tensor(b), wires=1, record=False))
        assert tp.wires == jp.wires and tp.name == jp.name
        assert np.abs(_np(tp.matrix) - np.asarray(jp.matrix)).max() <= EXACT
    with pytest.raises(ValueError):
        to.prod()


@pytest.mark.unittest
@pytest.mark.parametrize("gate", ["CZ", "Rot", "CRX", "CRY", "CRZ"])
def test_decompositions_match_jax(gate):
    angles = np.random.default_rng(3).uniform(0, 2 * np.pi, 3)
    with jax_x64():
        if gate == "Rot":
            j = jo.Rot(*angles, wires=1, record=False)
            t = to.Rot(*[torch.tensor(v) for v in angles], wires=1, record=False)
        elif gate == "CZ":
            j, t = jo.CZ(wires=[2, 0], record=False), to.CZ(wires=[2, 0], record=False)
        else:
            j = getattr(jo, gate)(angles[0], wires=[2, 0], record=False)
            t = getattr(to, gate)(torch.tensor(angles[0]), wires=[2, 0], record=False)
        jd, td = j.decompose(), t.decompose()
        assert [(o.name, o.wires) for o in td] == [(o.name, o.wires) for o in jd]
        for a, b in zip(td, jd):
            assert np.allclose([float(p) for p in a.parameters],
                               [float(p) for p in b.parameters], atol=EXACT, rtol=0)
        # The primitives, applied in order, are the gate itself.
        prod = to.prod(*reversed(td))
        order = sorted(t.wires)
        got = tk.lift_matrix(prod.matrix, prod.wires, order)
        want = tk.lift_matrix(t.matrix, t.wires, order)
        assert np.abs(_np(got) - _np(want)).max() <= EXACT
    with pytest.raises(NotImplementedError):
        to.CCX(wires=[0, 1, 2], record=False).decompose()


@pytest.mark.unittest
def test_copy_to_tape_shifts_wires():
    with recording() as tape:
        ttape.copy_to_tape(lambda: (to.H(wires=0), to.CX(wires=[0, 1])), offset=3)
    assert [(o.name, o.wires) for o in tape] == [("H", [3]), ("CX", [3, 4])]
    source = []
    with recording() as tape:
        ttape.shift_and_append([to.H(wires=1, record=False)], 2)
        ttape.shift_and_append(source, 1)
    assert [(o.name, o.wires) for o in tape] == [("H", [3])]
    ttape.shift_and_append([to.H(wires=1, record=False)], 2)  # no tape: a no-op


# ---------------------------------------------------------------------------
# Pauli-Clifford canonical form
# ---------------------------------------------------------------------------


def _canonical(package, model, n):
    rec, PC = (jax_recording, JPauliCircuit) if package == "jax" else (recording, PauliCircuit)
    with rec() as tape:
        if package == "jax":
            model._variational(model.params[0], jnp.asarray([X]))
        else:
            model._variational(model.params[0], torch.tensor([X], dtype=torch.float64))
    _, obs = model._build_obs()
    return PC.from_parameterised_circuit(list(tape), observables=obs, n_qubits=n)


@pytest.mark.unittest
@pytest.mark.parametrize("circuit", ["Circuit_19", "Circuit_15", "Circuit_18", "Hardware_Efficient"])
def test_pauli_circuit_matches_jax(circuit):
    n = 3
    with jax_x64():
        jm, tm = _pair(n, 1, circuit)
        jrot, jobs = _canonical("jax", jm, n)
        trot, tobs = _canonical("torch", tm, n)
    assert [(r.name, getattr(r, "pauli_word", None), r.wires) for r in trot] == \
        [(r.name, getattr(r, "pauli_word", None), r.wires) for r in jrot]
    ja = np.array([float(p) for p in JPauliCircuit.get_parameters(jrot)])
    ta = np.array([float(p) for p in PauliCircuit.get_parameters(trot)])
    assert np.abs(ta - ja).max() <= EXACT
    assert len(tobs) == len(jobs)
    for t, j in zip(tobs, jobs):
        assert t._pauli_label == j._pauli_label and t.wires == j.wires
        assert t._pauli_word == to.PauliWord._make(
            j._pauli_word.xm, j._pauli_word.zm, j._pauli_word.n, j._pauli_word.phase)
        assert np.abs(_np(t.matrix) - np.asarray(j.matrix)).max() <= EXACT
    assert all(PauliCircuit._is_pauli_rotation(r) for r in trot)


@pytest.mark.unittest
def test_pauli_circuit_helpers_and_errors():
    with recording() as tape:
        to.H(wires=0)
        to.RX(torch.tensor(0.3), wires=0)
        to.CX(wires=[0, 1])
        to.RZ(torch.tensor(0.2), wires=1)
        to.Barrier(wires=[0, 1])
    prims = PauliCircuit.get_clifford_pauli_gates(list(tape))
    assert [o.name for o in prims] == ["H", "RX", "CX", "RZ"]
    rot, tail = PauliCircuit.commute_all_cliffords_to_the_end(prims, 2)
    assert [o.name for o in tail] == ["H", "CX"] and len(rot) == 2
    assert PauliCircuit._is_clifford(tail[0]) and not PauliCircuit._is_clifford(rot[0])
    obs = PauliCircuit.cliffords_in_observable(tail, [to.PauliZ(wires=1, record=False)], 2)
    assert obs[0]._pauli_label == "XZ"  # CX† Z_1 CX = Z_0 Z_1, then H† Z_0 H = X_0
    with recording() as tape:
        to.CCX(wires=[0, 1, 2])
        to.RX(torch.tensor(0.1), wires=0)
    with pytest.raises(NotImplementedError):
        PauliCircuit.from_parameterised_circuit(list(tape), n_qubits=3)


# ---------------------------------------------------------------------------
# Math: fidelities, distances, QFI
# ---------------------------------------------------------------------------


def _random_states(rng, n, batch=()):
    v = rng.normal(size=(*batch, 2**n)) + 1j * rng.normal(size=(*batch, 2**n))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _random_density(rng, n, rank=3):
    v = _random_states(rng, n, (rank,))
    w = rng.uniform(0.1, 1.0, rank)
    rho = np.einsum("k,ki,kj->ij", w / w.sum(), v, v.conj())
    return rho


@pytest.mark.unittest
def test_fidelity_distance_phase_match_jax():
    rng = np.random.default_rng(0)
    with jax_x64():
        a, b = _random_states(rng, 3, (4,)), _random_states(rng, 3, (4,))
        for j, t in ((jmath.fidelity(a, b), tmath.fidelity(a, b)),
                     (jmath.fidelity(a[0], b[0]), tmath.fidelity(torch.from_numpy(a[0]), b[0])),
                     (jmath.phase_difference(a, b), tmath.phase_difference(a, b))):
            assert np.abs(_np(t) - np.asarray(j)).max() <= EXACT
        # Full-rank states: a zero eigenvalue enters the Uhlmann fidelity
        # through a square root, which lifts rounding noise to ~1e-8.
        r0, r1 = _random_density(rng, 2, rank=4), _random_density(rng, 2, rank=4)
        stack0 = np.stack([r0, r1])
        stack1 = np.stack([r1, _random_density(rng, 2, rank=4)])
        for j, t in ((jmath.fidelity(r0, r1), tmath.fidelity(r0, r1)),
                     (jmath.fidelity(stack0, stack1), tmath.fidelity(stack0, stack1)),
                     (jmath.trace_distance(stack0, stack1), tmath.trace_distance(stack0, stack1)),
                     (jmath._sqrt_matrix(jnp.asarray(stack0)),
                      tmath._sqrt_matrix(torch.from_numpy(stack0)))):
            assert np.abs(_np(t) - np.asarray(j)).max() <= EXACT
        pd = np.stack([np.eye(4) * 0.25 + 0.1 * (r0 - np.eye(4) * 0.25), r1])
        assert np.abs(_np(tmath.logm_v(pd)) - np.asarray(jmath.logm_v(pd))).max() <= EXACT
        assert np.abs(_np(tmath.logm_v(r0)) - np.asarray(jmath.logm_v(r0))).max() <= EXACT
    # A pure state's fidelity with itself as a density matrix is 1 (to the
    # square root of rounding noise).
    rho = np.outer(a[0], a[0].conj())
    assert abs(float(tmath.fidelity(rho, rho)) - 1.0) <= 1e-7
    with pytest.raises(ValueError):
        tmath.fidelity(a[0], rho)
    with pytest.raises(ValueError):
        tmath.fidelity(a[0], _random_states(rng, 2))
    with pytest.raises(NotImplementedError):
        tmath.logm_v(np.zeros((2, 2, 2, 2)))


@pytest.mark.unittest
@pytest.mark.parametrize("kind", ["state", "density"])
def test_qfi_and_fubini_study_match_jacfwd(kind):
    """Pure: the 2q Circuit_19 state.  Mixed: the 3q Circuit_19's density
    of qubits [0, 1].  The reference is the JAX package's ``jax.jacfwd``
    state and Jacobian (``_state_and_jacobian``, under ``jax.jit`` through its
    Script: the eager model call takes ~12 s a Jacobian on the CPU) and its
    closed forms for the QFI and the metric; the port's public functions
    take the model's own call."""
    n, keep = (2, None) if kind == "state" else (3, [0, 1])
    with jax_x64():
        jm, tm = _pair(n, 1, "Circuit_19")
        p0 = np.asarray(jm.params[0])
        x = jnp.asarray([X])

        def jfn(p):
            out = jm.script.execute(type=kind, args=(p, x), kwargs=dict(enc_params=jm.enc_params))
            return out if keep is None else jax_jaqsi.partial_trace(out, n, keep)

        if keep is not None:
            tm.output_qubit = keep

        def tfn(p):
            return tm(params=p, inputs=X, execution_type=kind)

        state, jac = jax.jit(lambda p: jmath._state_and_jacobian(jfn, p))(jnp.asarray(p0))
        assert np.abs(_np(tfn(torch.from_numpy(p0))) - np.asarray(state)).max() <= EXACT
        if kind == "state":
            jac = jac.reshape(state.shape[0], -1)
            jq = np.asarray(jmath._qfi_statevector(jac, state))
            jg = np.asarray(jmath._fubini_study_statevector(jac, state))
        else:
            jq = np.asarray(jmath._qfi_density(jac.reshape(*state.shape, -1), state))
        tq = _np(tmath.quantum_fisher_information(tfn, torch.from_numpy(p0)))
        assert tq.shape == jq.shape == (p0.size, p0.size)
        assert np.abs(tq - jq).max() <= QFI_TOL * max(1.0, np.abs(jq).max())
        if kind == "state":
            tg = _np(tmath.fubini_study_metric(tfn, torch.from_numpy(p0)))
            assert np.abs(tg - jg).max() <= QFI_TOL * max(1.0, np.abs(jg).max())
        else:
            with pytest.raises(ValueError):
                tmath.fubini_study_metric(tfn, torch.from_numpy(p0))


# ---------------------------------------------------------------------------
# Entanglement
# ---------------------------------------------------------------------------


def _measure(module, name, model, **kw):
    """A measure on the model's stored parameters.  A generator (key) is
    passed: the JAX package's batch path splits it even when no gate draws
    (with none it raises); the noise-free circuits here never draw."""
    key = jax.random.PRNGKey(0) if module is jent else torch.Generator().manual_seed(0)
    return float(getattr(module.Entanglement, name)(model, n_samples=-1, random_key=key, **kw))


@pytest.mark.unittest
@pytest.mark.parametrize("name, n, circuit, kw", [
    ("meyer_wallach", 3, "Circuit_19", {}),
    ("bell_measurements", 3, "Circuit_19", {}),
    ("concentratable_entanglement", 2, "Circuit_15", {}),
    ("concentratable_entanglement_estimation", 2, "Circuit_15", {}),
    ("entanglement_of_formation", 2, "Circuit_19", {}),
])
def test_entanglement_measures_match_jax(name, n, circuit, kw):
    with jax_x64():
        jm, tm = _pair(n, 1, circuit, batch=3, data_reupload=False)
        j = _measure(jent, name, jm, **kw)
        t = _measure(tent, name, tm, **kw)
    assert abs(t - j) <= MEASURE_TOL, (name, t, j)


@pytest.mark.unittest
def test_entanglement_of_formation_decomposed_matches_jax():
    noise = {"Depolarizing": 0.05, "AmplitudeDamping": 0.03}
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19", batch=3, data_reupload=False)
        j = _measure(jent, "entanglement_of_formation", jm, always_decompose=True,
                     noise_params=noise)
        t = _measure(tent, "entanglement_of_formation", tm, always_decompose=True,
                     noise_params=noise)
    assert abs(t - j) <= LOG_TOL, (t, j)


@pytest.mark.unittest
def test_relative_entropy_matches_jax(monkeypatch):
    """The separable states are carried too: both packages' samplers are
    replaced by one that returns the same logarithms of the same product
    states."""
    n, n_sigmas = 2, 3
    with jax_x64():
        shape = Model(n, 1, "No_Entangling", data_reupload=False, device="cpu").params.shape
        sigma_params = np.random.default_rng(23).uniform(0, 2 * np.pi, (n_sigmas, *shape[1:]))
        jm, tm = _pair(n, 1, "Circuit_19", batch=3, data_reupload=False)

        pm = Model(n, 1, "No_Entangling", data_reupload=False, device="cpu",
                   dtype=torch.float64)
        pm.load_numpy(sigma_params)
        sigmas = _np(pm(execution_type="density", inputs=None))
        # One set of logarithms for both: logm of a rank-1 state is dominated
        # by rounding noise in its kernel, so each package's own would differ.
        log_sigmas = np.asarray(jmath.logm_v(sigmas)) / np.log(2.0)

        def jax_sigmas(n_qubits, n_samples, random_key, take_log=False):
            return jnp.asarray(log_sigmas)

        def torch_sigmas(n_qubits, n_samples, random_key, take_log=False, device=None,
                         dtype=None):
            return torch.from_numpy(log_sigmas)

        monkeypatch.setattr(jent, "sample_random_separable_states", jax_sigmas)
        monkeypatch.setattr(tent, "sample_random_separable_states", torch_sigmas)
        j = float(jent.Entanglement.relative_entropy(jm, n_samples=-1, n_sigmas=n_sigmas))
        t = float(tent.Entanglement.relative_entropy(tm, n_samples=-1, n_sigmas=n_sigmas))
    assert np.isfinite(t) and abs(t - j) <= LOG_TOL, (t, j)


def _cpu(n, layers, circuit, **kw):
    return Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu",
                 dtype=torch.float64, **kw)


@pytest.mark.unittest
def test_entanglement_endpoints():
    """The reference's own checks (tests/test_analysis.py), on the port."""
    gen = torch.Generator().manual_seed
    assert abs(_measure(tent, "meyer_wallach", _cpu(3, 1, "GHZ", data_reupload=False)) - 1) <= 1e-5
    prod = _cpu(3, 1, "No_Entangling", data_reupload=False)
    assert abs(float(tent.Entanglement.meyer_wallach(prod, n_samples=5, random_key=gen(0)))) <= 1e-5
    m = _cpu(2, 1, "Circuit_19", data_reupload=False, random_seed=77)
    assert abs(_measure(tent, "meyer_wallach", m) - _measure(tent, "bell_measurements", m)) <= 1e-4
    ghz2 = _cpu(2, 1, "GHZ", data_reupload=False)
    assert abs(_measure(tent, "concentratable_entanglement", ghz2) - 0.25) <= 1e-5
    assert abs(_measure(tent, "concentratable_entanglement_estimation", ghz2) - 0.25) <= 1e-4
    assert abs(_measure(tent, "entanglement_of_formation", ghz2) - 1.0) <= 1e-5
    prod2 = _cpu(2, 1, "No_Entangling", data_reupload=False)
    ce = tent.Entanglement.concentratable_entanglement(prod2, n_samples=3, random_key=gen(2))
    assert abs(ce) <= 1e-5
    rel = tent.Entanglement.relative_entropy(_cpu(2, 1, "Circuit_19", data_reupload=False),
                                             n_samples=2, n_sigmas=2, random_key=gen(1))
    assert np.isfinite(float(rel))


@pytest.mark.unittest
def test_replicated_copies_share_their_noise_draws():
    """GateError noise: the two copies of a replicated register draw the same
    angles, as the JAX package's copies share one key, so the SWAP test of a
    pure state still reads its purity (CE of a product state stays 0)."""
    m = _cpu(2, 1, "No_Entangling", data_reupload=False)
    ce = tent.Entanglement.concentratable_entanglement(
        m, n_samples=3, random_key=torch.Generator().manual_seed(4),
        noise_params={"GateError": 0.3})
    assert abs(ce) <= 1e-10


@pytest.mark.unittest
def test_separable_states_sampler():
    sig = tent.sample_random_separable_states(2, 4, torch.Generator().manual_seed(0),
                                              device="cpu", dtype=torch.float64)
    assert sig.shape == (4, 4, 4)
    purities = torch.einsum("bij,bji->b", sig, sig).real
    assert torch.allclose(purities, torch.ones(4, dtype=torch.float64), atol=1e-12)
    mw = tent._mw_values(sig, 2)
    assert float(mw.abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# Expressibility
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_expressibility_matches_jax_on_carried_parameters():
    n_samples, n_bins = 40, 12
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_9", batch=2 * n_samples, data_reupload=False)
        carried = np.asarray(jm.params)
        jm.initialize_params = lambda key, repeat: setattr(jm, "params", jnp.asarray(carried))
        tm.initialize_params = lambda key, repeat: tm.load_numpy(carried)
        jf = np.asarray(JExpr._sample_state_fidelities(jm, n_samples))
        tf = _np(Expressibility._sample_state_fidelities(tm, n_samples))
        assert np.abs(tf - jf).max() <= FIDELITY_TOL
        jx, jh = JExpr.state_fidelities(n_samples, n_bins, jm)
        tx, th = Expressibility.state_fidelities(n_samples, n_bins, tm)
        assert np.array_equal(_np(th), np.asarray(jh))
        assert np.abs(_np(tx) - np.asarray(jx)).max() <= EXACT
        jk = JExpr.kl_divergence_to_haar(jm, n_samples, n_bins)
        tk = Expressibility.kl_divergence_to_haar(tm, n_samples, n_bins)
        assert np.array_equal(tk, jk)
        jhx, jhy = JExpr.haar_integral(3, 9, scale=True)
        thx, thy = Expressibility.haar_integral(3, 9, scale=True)
    assert np.abs(_np(thy) - np.asarray(jhy)).max() <= EXACT
    assert np.abs(_np(thx) - np.asarray(jhx)).max() <= EXACT
    assert abs(float(thy.sum()) - 1.0) <= EXACT
    assert Expressibility._haar_probability(0.25, 2) == JExpr._haar_probability(0.25, 2)


@pytest.mark.unittest
def test_histogram_closed_right_edge():
    """Bins [lo, hi), the last closed at 1, outliers dropped: jnp.histogram's."""
    from qml_essentials_tpu_torch.analysis.expressibility import _histogram

    values = np.array([0.0, 0.25, 0.2499999, 0.5, 0.999, 1.0, 1.0, -0.1, 1.2, 0.75])
    edges = np.linspace(0, 1, 5)
    ref, _ = jnp.histogram(jnp.asarray(values), bins=jnp.asarray(edges))
    got = _histogram(torch.from_numpy(values), torch.from_numpy(edges))
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.unittest
def test_expressibility_endpoints():
    """The reference's checks.  The idle-vs-expressive comparison takes 500
    samples: at the reference's 100 the two KL estimates (expected ~0.07 and
    ~0.01 at 2q, plus a bias of ~(bins - 1) / 2N = 0.1) overlap from one
    generator seed to the next."""
    gen = torch.Generator().manual_seed
    m = _cpu(2, 1, "Circuit_9", data_reupload=False)
    _, z = Expressibility.state_fidelities(n_samples=100, n_bins=20, model=m, random_key=gen(0))
    assert abs(float(z.sum()) - 1.0) <= 1e-12
    idle = Expressibility.kl_divergence_to_haar(_cpu(2, 1, "Circuit_1", data_reupload=False),
                                                n_samples=500, n_bins=20, random_key=gen(0))
    expr = Expressibility.kl_divergence_to_haar(_cpu(2, 3, "Circuit_9", data_reupload=False),
                                                n_samples=500, n_bins=20, random_key=gen(0))
    assert idle[0] > expr[0]
    with pytest.raises(ValueError):
        Expressibility.kullback_leibler_divergence(np.ones(3) / 3, np.ones(4) / 4)


@pytest.mark.unittest
def test_sampled_fidelities_match_jax_in_distribution():
    """Each package draws its own parameter sets: the fidelity samples of the
    same circuit come from one distribution (two-sample KS at 1 %)."""
    from scipy.stats import ks_2samp

    n = 100
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_9", data_reupload=False)
        jf = np.asarray(JExpr._sample_state_fidelities(jm, n, random_key=jax.random.PRNGKey(3)))
        tf = _np(Expressibility._sample_state_fidelities(tm, n, torch.Generator().manual_seed(3)))
    assert ks_2samp(jf, tf).pvalue > 0.01
