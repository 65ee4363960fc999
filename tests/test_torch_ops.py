"""Parity of the PyTorch port's operation algebra and plain kernels with the
JAX package.

Gate matrices must agree to 1e-6 (complex64 on both sides).  The plain
real-split applications agree to 1e-5 relative: the JAX side runs its
large-state route (``pallas_kernels.ENABLED`` with the regime threshold at
the test width, Pallas in interpret mode at full f32 precision), so the
supports it pads to a lane tile (k <= 2, top windows) or recentres with a
rotation (B < 128 at n >= 14, ring-wrap) go through those workarounds there
and through a direct contraction in the port.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.ops import kernels as jk
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu_torch.ops import kernels as tk
from qml_essentials_tpu_torch.ops import operations as to

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GATE_TOL = 1e-6
APPLY_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


# Each factory takes the operations module of either package.
GATES = {
    "Id": lambda m: m.Id(wires=0, record=False),
    "Id3": lambda m: m.Id(wires=[0, 1, 2], record=False),
    "PauliX": lambda m: m.PauliX(wires=0, record=False),
    "PauliY": lambda m: m.PauliY(wires=0, record=False),
    "PauliZ": lambda m: m.PauliZ(wires=0, record=False),
    "H": lambda m: m.H(wires=0, record=False),
    "S": lambda m: m.S(wires=0, record=False),
    "SWAP": lambda m: m.SWAP(wires=[0, 1], record=False),
    "RX": lambda m: m.RX(0.37, wires=0, record=False),
    "RY": lambda m: m.RY(-1.21, wires=0, record=False),
    "RZ": lambda m: m.RZ(2.5, wires=0, record=False),
    "CX": lambda m: m.CX(wires=[0, 1], record=False),
    "CY": lambda m: m.CY(wires=[0, 1], record=False),
    "CZ": lambda m: m.CZ(wires=[0, 1], record=False),
    "CCX": lambda m: m.CCX(wires=[0, 1, 2], record=False),
    "CSWAP": lambda m: m.CSWAP(wires=[0, 1, 2], record=False),
    "CPhase": lambda m: m.ControlledPhaseShift(0.81, wires=[0, 1], record=False),
    "Rot": lambda m: m.Rot(0.3, -0.7, 1.9, wires=0, record=False),
    "PauliRot": lambda m: m.PauliRot(0.44, "XYZ", wires=[0, 1, 2], record=False),
    "RXX": lambda m: m.RXX(0.6, wires=[0, 1], record=False),
    "RYY": lambda m: m.RYY(-0.2, wires=[0, 1], record=False),
    "RZZ": lambda m: m.RZZ(1.3, wires=[0, 1], record=False),
    "RZX": lambda m: m.RZX(2.2, wires=[0, 1], record=False),
    "ControlledPauliRot": lambda m: m.ControlledPauliRot(
        0.9, "XY", wires=[0, 1, 2, 3], n_controls=2, record=False
    ),
    "CRX": lambda m: m.CRX(0.5, wires=[0, 1], record=False),
    "CRY": lambda m: m.CRY(-1.5, wires=[0, 1], record=False),
    "CRZ": lambda m: m.CRZ(3.0, wires=[0, 1], record=False),
    "Hermitian": lambda m: m.Hermitian(
        np.array([[1.0, 0.5 - 0.2j], [0.5 + 0.2j, -0.3]]), wires=1, record=False
    ),
    "DiagonalQubitUnitary": lambda m: m.DiagonalQubitUnitary(
        (jnp if m is jo else torch).asarray(np.exp(1j * np.arange(4.0)).astype(np.complex64)),
        wires=[0, 1],
        record=False,
    ),
    "prod": lambda m: m.RX(0.2, wires=0, record=False).prod(
        m.CRY(0.7, wires=[2, 1], record=False)
    ),
    "dagger": lambda m: m.Rot(0.1, 0.2, 0.3, wires=0, record=False).dagger(),
    "power": lambda m: m.CRX(0.4, wires=[0, 1], record=False).power(3),
}


@pytest.mark.unittest
@pytest.mark.parametrize("name", sorted(GATES))
def test_gate_matrix_matches_jax(name):
    ref = GATES[name](jo)
    got = GATES[name](to)
    assert got.wires == ref.wires
    assert np.abs(_np(got.matrix) - _np(ref.matrix)).max() <= GATE_TOL


@pytest.mark.unittest
def test_gate_matrix_follows_parameter_dtype():
    m32 = to.CRX(torch.tensor(0.5), wires=[0, 1], record=False).matrix
    m64 = to.CRX(torch.tensor(0.5, dtype=torch.float64), wires=[0, 1], record=False).matrix
    assert m32.dtype == torch.complex64 and m64.dtype == torch.complex128
    assert np.abs(_np(m64) - _np(m32)).max() <= GATE_TOL


@pytest.mark.unittest
def test_rotation_matrix_is_differentiable():
    theta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    to.RY(theta, wires=0, record=False).matrix.real.sum().backward()
    # d/dθ of (cos θ/2 + cos θ/2) = -sin(θ/2)
    assert abs(theta.grad.item() + np.sin(0.35)) < 1e-12


def _state(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(2, 2**n)).astype(np.float32)
    return s / np.linalg.norm(s)


def _unitary_pair(k, seed):
    rng = np.random.default_rng(seed)
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return np.stack([q.real, q.imag]).astype(np.float32)


@pytest.fixture
def jax_large_regime(monkeypatch):
    """Put the JAX package's kernel layer in its large-state route at width n."""

    def enable(n):
        monkeypatch.setattr(pallas_kernels, "ENABLED", True)
        monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_N", n)
        monkeypatch.setattr(pallas_kernels, "INTERPRET", True)
        monkeypatch.setattr(pallas_kernels, "PRECISION_MODE", "highest")

    return enable


# (n, wires, what the JAX large-state route does with it)
APPLY_CASES = [
    (12, [3, 4, 5], "mid window"),
    (12, [0], "k=1, identity-padded to K=8"),
    (12, [1, 2], "k=2, identity-padded to K=8"),
    (12, [11], "top k=1, identity-padded to K=128"),
    (12, [9, 10, 11], "top k=3, identity-padded to K=128"),
    (12, list(range(4, 12)), "top K=256"),
    (12, [6, 7, 8], "B=8 < 128, no recentring below 14q"),
    (12, [11, 0], "ring-wrap, scattered below 14q"),
    (12, [9, 2, 5], "scattered, unsorted"),
    (10, [7, 3], "scattered pair, unsorted"),
    (14, [8, 9, 10], "B=8 < 128, recentred by a rotation"),
    (14, [10, 11], "B=4 < 128, recentred by a rotation"),
    (14, [13, 0], "ring-wrap, made contiguous by a rotation"),
    (14, [12, 13, 0, 1], "wide ring-wrap"),
]


@pytest.mark.unittest
@pytest.mark.parametrize("n,wires,_what", APPLY_CASES, ids=[c[2] for c in APPLY_CASES])
def test_apply_matrix_pair_matches_jax(jax_large_regime, n, wires, _what):
    jax_large_regime(n)
    psi2 = _state(n, n + len(wires))
    w2 = _unitary_pair(len(wires), sum(wires))
    ref = _np(jk.apply_matrix_pair_ri(jnp.asarray(psi2), jnp.asarray(w2), wires, n))
    got = _np(tk.apply_matrix_pair_ri(torch.from_numpy(psi2), torch.from_numpy(w2), wires, n))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() <= APPLY_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n,wires", [(11, [4, 6]), (12, [10, 11]), (12, [7, 2, 0])])
def test_apply_diagonal_pair_matches_jax(n, wires):
    psi2 = _state(n, 3)
    rng = np.random.default_rng(4)
    ph = rng.uniform(-np.pi, np.pi, size=2 ** len(wires))
    d2 = np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)
    ref = _np(jk.apply_diagonal_pair_ri(jnp.asarray(psi2), jnp.asarray(d2), wires, n))
    got = _np(tk.apply_diagonal_pair_ri(torch.from_numpy(psi2), torch.from_numpy(d2), wires, n))
    assert np.abs(got - ref).max() / np.abs(ref).max() <= APPLY_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n,r", [(10, 1), (12, 5), (12, 11), (14, 7)])
def test_rotate_qubits_matches_jax_bit_for_bit(jax_large_regime, n, r):
    jax_large_regime(n)
    psi2 = _state(n, r)
    ref = _np(jk._rotate_qubits_ri(jnp.asarray(psi2), r, n))
    got = _np(tk._rotate_qubits_ri(torch.from_numpy(psi2), r, n))
    assert np.array_equal(got, ref)


@pytest.mark.unittest
def test_measurement_reductions_match_jax():
    n = 9
    psi2 = _state(n, 11)
    probs = psi2[0] ** 2 + psi2[1] ** 2
    weights = [None, (1.0, -1.0), None, None, (0.5, 2.0), None, None, None, (1.0, -1.0)]
    ref = _np(jk.reduce_diagonal_expectation(jnp.asarray(probs), weights))
    got = _np(tk.reduce_diagonal_expectation(torch.from_numpy(probs), weights))
    assert abs(float(got) - float(ref)) <= 1e-6
    ref_m = _np(jk.marginal_probs_on(jnp.asarray(probs), [1, 4, 7], n))
    got_m = _np(tk.marginal_probs_on(torch.from_numpy(probs), [1, 4, 7], n))
    assert np.abs(got_m - ref_m).max() <= 1e-6
    assert np.array_equal(_np(tk.zero_state_ri(n)), _np(jk.zero_state_ri(n)))


@pytest.mark.unittest
def test_port_never_imports_jax():
    """The port runs where JAX is absent: no module of it, and not the smoke
    script, may import jax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|qml_essentials_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "qml_essentials_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


@pytest.mark.unittest
def test_safe_random_split_derives_independent_generators():
    from qml_essentials_tpu_torch.utils import safe_random_split

    assert safe_random_split(None) == (None, None)
    a, b = safe_random_split(torch.Generator().manual_seed(3))
    a2, _ = safe_random_split(torch.Generator().manual_seed(3))
    draw = lambda g: torch.rand(4, generator=g)  # noqa: E731
    assert torch.equal(draw(a), draw(a2))  # same seed, same stream
    assert not torch.equal(draw(a), draw(b))


def _ghz(n):
    to.H(wires=0)
    for q in range(n - 1):
        to.CX(wires=[q, q + 1])


@pytest.mark.unittest
def test_float64_ghz_state_is_exact():
    """A float64 circuit computes with its fixed gates in float64: the 5q
    GHZ state is (|0...0> + |1...1>)/sqrt(2) to 1e-15 (complex64 constants
    would leave H's 1/sqrt(2) off by ~1e-8)."""
    from qml_essentials_tpu_torch.core.executor import Script

    n = 5
    state = Script(_ghz, n_qubits=n, device="cpu", dtype=torch.float64).execute(
        type="state", args=(n,))
    assert state.dtype == torch.complex128
    want = np.zeros(2**n, dtype=np.complex128)
    want[0] = want[-1] = 1 / np.sqrt(2.0)
    assert np.abs(_np(state) - want).max() <= 1e-15


@pytest.mark.unittest
@pytest.mark.parametrize("which", ["H", "Hermitian"])
def test_fixed_matrices_are_exact_at_float64(which):
    """H and a numpy-built Hermitian, cast to complex128 where a float64
    state uses them, equal numpy's matrices to 1e-15."""
    if which == "H":
        want = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
        mat = to.H(wires=0, record=False).matrix
    else:
        want = np.array([[0.1, 0.5 - 0.2j], [0.5 + 0.2j, -1 / 3]])
        mat = to.Hermitian(want, wires=0, record=False).matrix
    got = to._placed(mat, torch.device("cpu"), torch.complex128)
    assert np.abs(_np(got) - want).max() <= 1e-15
