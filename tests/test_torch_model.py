"""``Model(...)(params, inputs)`` in the PyTorch port against the JAX
package, with the JAX model's parameters carried across by
``Model.load_numpy``.

Tolerance: 5e-5 relative to the largest output magnitude (float32 on both
sides; at 16 qubits the JAX side runs its Pallas kernels in interpret mode,
whose split3 bf16 products add ~1e-5 per window).

The port's entry points run on the card unless the caller asks for the CPU:
without CUDA their default raises, and ``device="cpu"`` runs.
"""

import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import executor as jax_executor
from qml_essentials_tpu.models.ansaetze import Ansaetze as JaxAnsaetze
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.core.executor import Script
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops import simulation as tsim

torch.set_num_threads(2)

REL_TOL = 5e-5
INPUTS = np.array([0.31, -1.2, 2.05], dtype=np.float32)


def _pair(n, layers=2, circuit="Circuit_19", **kw):
    jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type=circuit, random_seed=11, **kw)
    tm = Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu", **kw)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    return jm, tm


def _assert_close(got, ref):
    """Relative to the largest output magnitude; outputs that vanish (e.g.
    Circuit_9's <Z> at 0) are held to 5e-5 of 1e-3 absolute."""
    got = got.detach().resolve_conj().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-3)
    assert np.abs(got - ref).max() / scale <= REL_TOL


@pytest.fixture(scope="module")
def pair6():
    pulse_state = PulseInformation.snapshot_state()
    pair = _pair(6)
    PulseInformation.restore_state(pulse_state)  # JaxModel() sets the global pulse envelope
    return pair


@pytest.mark.unittest
@pytest.mark.parametrize("n", [6, 8])
def test_circuit19_expval_single_and_batch(n, pair6):
    jm, tm = pair6 if n == 6 else _pair(n)
    x0 = float(INPUTS[0])
    _assert_close(tm(inputs=x0, execution_type="expval"), jm(jm.params, inputs=x0, execution_type="expval"))
    _assert_close(tm(inputs=torch.from_numpy(INPUTS)), jm(jm.params, inputs=INPUTS))


@pytest.mark.unittest
@pytest.mark.parametrize("execution_type", ["probs", "state"])
def test_circuit19_probs_and_state(execution_type, pair6):
    jm, tm = pair6
    ref = jm(jm.params, inputs=INPUTS, execution_type=execution_type)
    got = tm(inputs=torch.from_numpy(INPUTS), execution_type=execution_type)
    _assert_close(got, ref)


@pytest.mark.unittest
def test_partial_measurements_and_param_batches():
    jm, tm = _pair(6, output_qubit=[0, 3])
    _assert_close(tm(inputs=float(INPUTS[1])), jm(jm.params, inputs=float(INPUTS[1])))
    ref = jm(jm.params, inputs=INPUTS, execution_type="probs")
    _assert_close(tm(inputs=torch.from_numpy(INPUTS), execution_type="probs"), ref)

    rng = np.random.default_rng(2)
    params = rng.uniform(0, 2 * np.pi, size=(3, *np.asarray(jm.params).shape[1:]))
    jm2, tm2 = _pair(5)
    ref = jm2(params.astype(np.float32), inputs=float(INPUTS[2]), execution_type="expval")
    _assert_close(tm2(torch.from_numpy(params), inputs=float(INPUTS[2])), ref)


@pytest.mark.unittest
def test_circuit19_large_regime_matches_jax_interpret(monkeypatch):
    """16 qubits through the scheduled plan on both sides: Pallas kernels in
    interpret mode for JAX, the plain versions of the port's kernels."""
    n = 16
    monkeypatch.setattr(pallas_kernels, "ENABLED", True)
    monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_N", n)
    monkeypatch.setattr(pallas_kernels, "INTERPRET", True)
    monkeypatch.setattr(jsim, "FUSE_LAYOUT_ROT", False)
    monkeypatch.setattr(jsim, "USE_CHAINS", False)
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", n)
    jm, tm = _pair(n)
    _assert_close(tm(inputs=torch.from_numpy(INPUTS)), jm(jm.params, inputs=INPUTS))


@pytest.mark.unittest
def test_port_forward_is_differentiable_on_cpu():
    _, tm = _pair(5)
    out = tm(inputs=0.4).sum()
    out.backward()
    assert tm.params.grad is not None and torch.isfinite(tm.params.grad).all()
    assert tm.params.grad.abs().max() > 0


@pytest.mark.unittest
def test_float64_mode_is_explicit(pair6):
    jm, tm32 = pair6
    tm64 = Model(n_qubits=6, n_layers=2, circuit_type="Circuit_19", dtype=torch.float64,
                 device="cpu")
    tm64.load_numpy(np.asarray(jm.params))
    out = tm64(inputs=0.9)
    assert out.dtype == torch.float64
    assert (out.float() - tm32(inputs=0.9, execution_type="expval")).abs().max() <= 1e-5


@pytest.mark.unittest
@pytest.mark.parametrize("what", ["noise", "shots", "density"])
def test_later_slices_raise(what):
    """Noise, shots and density came with the density slice and answer
    (tests/test_torch_density.py and tests/test_torch_shots.py hold them to
    the JAX package); pulses came with the pulse slice
    (tests/test_torch_pulses.py)."""
    tm = Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", device="cpu")
    if what == "noise":
        out = tm(inputs=0.1, noise_params={"BitFlip": 0.1})
        assert out.shape == (3,) and bool((out.abs() <= 1).all())
    elif what == "shots":
        ts = Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", shots=100, device="cpu")
        out = ts(inputs=0.1)
        assert out.shape == (3,) and bool((out.abs() <= 1).all())
    else:
        rho = tm(inputs=0.1, execution_type="density").detach()
        assert rho.shape == (8, 8)
        assert abs(torch.trace(rho).real.item() - 1) <= 1e-5
        assert (rho - rho.conj().T).abs().max() <= 1e-6


# Every ansatz of the registry uses only gates the port has (RX/RY/RZ, Rot,
# H, CX/CZ, CRX/CRZ), so none is skipped; an ansatz needing an unported
# gate would be listed here with the gate it needs.
SKIPPED_ANSAETZE: dict = {}


@pytest.mark.unittest
@pytest.mark.parametrize("circuit", [c.__name__ for c in JaxAnsaetze.get_available()])
def test_every_ansatz_matches_jax(monkeypatch, circuit):
    if circuit in SKIPPED_ANSAETZE:
        pytest.skip(SKIPPED_ANSAETZE[circuit])
    monkeypatch.setattr(jax_executor, "JIT_SINGLE", False)  # eager: no per-ansatz compile
    jm, tm = _pair(5, layers=1, circuit=circuit)
    _assert_close(tm(inputs=float(INPUTS[0])), jm(jm.params, inputs=float(INPUTS[0])))


def _one_qubit_circuit(theta):
    op.RX(theta, wires=0)


# Each entry point built with its default device, then with device="cpu".
ENTRY_POINTS = {
    "Model": lambda **kw: Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", **kw),
    "Script": lambda **kw: Script(_one_qubit_circuit, n_qubits=1, **kw),
    "available_memory_bytes": lambda **kw: memory.available_memory_bytes(**kw),
}


@pytest.mark.unittest
@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_the_card_is_the_default_device(monkeypatch, entry):
    """Without CUDA the default device raises (it never falls back to the
    CPU quietly); ``device="cpu"`` runs there."""
    make = ENTRY_POINTS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    on_cpu = make(device="cpu")
    if entry == "Model":
        assert on_cpu.params.device.type == "cpu"
        assert torch.isfinite(on_cpu(inputs=0.2)).all()
    elif entry == "Script":
        out = on_cpu.execute(type="expval", obs=[op.PauliZ(0, record=False)], args=(0.3,))
        assert abs(float(out[0]) - np.cos(0.3)) <= 1e-6
    else:
        assert on_cpu > 0
