"""Finite-shot sampling of the PyTorch port against the JAX package.

The packages draw from different generators (a ``torch.Generator`` here,
a JAX PRNG key there), so their samples are compared by distribution: every
estimate lies within 5 standard errors (plus one count) of the exact value,
and the same seed gives the same counts.  4 qubits, float64.
"""

import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import executor as jax_executor
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu_torch.core.executor import Script
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import simulation as tsim

torch.set_num_threads(2)

N = 4
SHOTS = 20000
SIGMAS = 5
X = 0.37
NOISE = {"Depolarizing": 0.05, "AmplitudeDamping": 0.05}


def _model(shots=SHOTS, seed=1000, noise=None, execution_type="expval"):
    m = Model(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=seed, shots=shots,
              device="cpu", dtype=torch.float64)
    m.noise_params = noise
    m.execution_type = execution_type
    return m


def _within(est, exact, kind):
    """|estimate - exact| <= 5 standard errors + one count, element-wise."""
    est, exact = np.asarray(est, np.float64), np.asarray(exact, np.float64)
    var = (1 - exact**2) if kind == "expval" else exact * (1 - exact)
    bound = SIGMAS * np.sqrt(np.clip(var, 0, None) / SHOTS) + 1.0 / SHOTS
    assert est.shape == exact.shape
    assert (np.abs(est - exact) <= bound).all()


@pytest.mark.unittest
@pytest.mark.parametrize("kind", ["expval", "probs"])
@pytest.mark.parametrize("path", ["statevector", "noisy density", "ket-then-bra engine"])
def test_shot_estimates_within_standard_errors(path, kind):
    """The statevector path, the interleaved density engine and (a 4-wire
    channel that blocks the lowering) the ket-then-bra engine."""
    noise = None if path == "statevector" else NOISE
    sampled = _model(noise=noise, execution_type=kind)
    exact = _model(shots=None, noise=noise, execution_type=kind)
    if path == "ket-then-bra engine":
        for m in (sampled, exact):
            m._variational = _with_wide_identity_channel(m._variational)
            m.script.f = m._variational
    est = sampled(inputs=X).detach().numpy()
    ref = exact(inputs=X).detach().numpy()
    _within(est, ref, kind)
    if kind == "probs":
        assert abs(est.sum() - 1) <= 1e-12
        assert np.allclose(est * SHOTS, np.round(est * SHOTS))


def _with_wide_identity_channel(variational):
    def f(*args, **kwargs):
        variational(*args, **kwargs)
        to.QubitChannel([np.eye(16)], wires=[0, 1, 2, 3])

    return f


@pytest.mark.unittest
def test_same_seed_same_counts():
    a, b, c = (_model(seed=s, noise=NOISE, execution_type="probs") for s in (3, 3, 4))
    ea, eb, ec = (m(inputs=X) for m in (a, b, c))
    assert torch.equal(ea, eb) and not torch.equal(ea, ec)
    # Each call draws anew from the model's generator.
    assert not torch.equal(a(inputs=X), ea)
    probs = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    draws = [tsim.sample_shots(probs, 2, "probs", [], 1000, torch.Generator().manual_seed(s))
             for s in (7, 7, 8)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


@pytest.mark.unittest
def test_density_with_shots_raises():
    """As in the JAX package: density is incompatible with finite shots."""
    m = _model()
    with pytest.raises(ValueError):
        m.execution_type = "density"
    with pytest.raises(ValueError):
        m(inputs=X, execution_type="density")
    jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", shots=SHOTS)
    with pytest.raises(ValueError):
        jm.execution_type = "density"


@pytest.mark.unittest
@pytest.mark.parametrize("noise", [None, NOISE], ids=["statevector", "noisy"])
def test_shots_match_jax_by_distribution(noise, monkeypatch):
    """Both packages' estimates lie within 5 standard errors of the JAX
    package's exact value on the same parameters."""
    monkeypatch.setattr(jax_executor, "JIT_SINGLE", False)
    jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=9, shots=SHOTS)
    exact_jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=9)
    tm = _model(noise=noise)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    exact = np.asarray(exact_jm(exact_jm.params, inputs=X, noise_params=noise))
    _within(np.asarray(jm(jm.params, inputs=X, noise_params=noise)), exact, "expval")
    _within(tm(inputs=X).detach().numpy(), exact, "expval")


@pytest.mark.unittest
def test_batched_shots_draw_per_element():
    """One generator per batch element: equal inputs, independent draws."""
    m = _model(noise=NOISE)
    est = m(inputs=[X, X, -X]).detach().numpy()
    exact = _model(shots=None, noise=NOISE)(inputs=[X, X, -X]).detach().numpy()
    assert est.shape == (3, N) and not np.array_equal(est[0], est[1])
    _within(est, exact, "expval")


@pytest.mark.unittest
def test_script_shots_take_the_generator():
    def circuit(theta):
        to.RX(theta, wires=0)
        to.RY(0.4 * theta, wires=1)

    script = Script(circuit, n_qubits=2, device="cpu", dtype=torch.float64)
    obs = [to.PauliZ(wires=0, record=False), to.PauliZ(wires=1, record=False)]
    theta = torch.tensor(0.9, dtype=torch.float64)
    runs = [script.execute(type="expval", obs=obs, args=(theta,), shots=SHOTS,
                           generator=torch.Generator().manual_seed(s)) for s in (5, 5)]
    assert torch.equal(runs[0], runs[1])
    default = [script.execute(type="probs", args=(theta,), shots=SHOTS) for _ in range(2)]
    assert torch.equal(default[0], default[1])  # no generator: seed 0
    exact = script.execute(type="expval", obs=obs, args=(theta,))
    _within(runs[0].numpy(), exact.numpy(), "expval")
    batched = script.execute(type="expval", obs=obs, args=(torch.stack([theta, theta]),),
                             in_axes=(0,), shots=SHOTS, generator=torch.Generator().manual_seed(5))
    assert batched.shape == (2, 2) and not torch.equal(batched[0], batched[1])


@pytest.mark.unittest
def test_sample_shots_clips_and_ignores_other_types():
    """Rounding below zero is clipped; state / density requests ignore shots
    (the JAX package's semantics)."""
    probs = torch.tensor([0.5, -1e-9, 0.25, 0.25 + 1e-9], dtype=torch.float64)
    est = tsim.sample_shots(probs, 2, "probs", [], SHOTS, torch.Generator().manual_seed(1))
    assert est[1] == 0 and abs(est.sum().item() - 1) <= 1e-12
    with pytest.raises(ValueError):
        tsim.sample_shots(probs.clamp_min(0), 2, "state", [], 10)
    with to.recording() as tape:
        to.RX(torch.tensor(0.3, dtype=torch.float64), wires=0)
    exact = tsim.simulate_and_measure(tape, 1, "state", [], False, dtype=torch.float64)
    shot = tsim.simulate_and_measure(tape, 1, "state", [], False, shots=10,
                                     dtype=torch.float64)
    assert torch.equal(exact, shot)
