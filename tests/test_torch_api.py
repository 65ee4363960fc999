"""The PyTorch port's API surface against the JAX package.

* Every public name of the JAX package's top-level shim modules and of its
  ``utils`` modules exists in the port's module of the same name, but for
  the names listed in ``NOT_PORTED`` (ROADMAP.md lists the same).
* The package and its shims import without matplotlib and without JAX.
* The complex-state API (``Operation.apply_to_state`` and its siblings, the
  complex helpers of ``ops/kernels.py``, ``simulate_pure``,
  ``simulate_mixed``, ``set_fusion``) and the Pauli rotations' generators
  agree with the JAX package at float64 to 1e-12 (JAX with x64 enabled and
  its constant matrices promoted to complex128).
* ``RandomUnitary`` draws from the JAX package's law (a two-sample
  Kolmogorov-Smirnov test over 2,000 draws of each) and is reproducible from
  a seeded generator.
"""

import ast
import importlib
import logging
import pathlib
import subprocess
import sys
import types
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import kernels as jk
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.pulse.pulses import PulseInformation as JaxPulseInformation
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import kernels as tk
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-12
N = 5
X = 0.37

SHIMS = ("ansaetze", "drawing", "gates", "jaqsi", "memory", "operations", "script",
         "simulation", "tape", "topologies", "unitary")
UTILS = ("utils", "utils.drawing", "utils.checkpointing", "utils.profiling")
PARALLEL = ("parallel", "parallel.state_sharding", "parallel.density_sharding")

# JAX names the port does not offer, by module (ROADMAP.md, "Not to port"):
# the jit switch of the JAX executor and the Pallas regime's fusion width,
# which the port calls LARGE_FUSE_WIDTH.
NOT_PORTED = {
    "script": {"JIT_SINGLE"},
    "simulation": {"PALLAS_FUSE_WIDTH"},
}


@pytest.fixture(autouse=True)
def jax_pulse_state():
    """A JAX Model's constructor sets the global pulse envelope."""
    state = JaxPulseInformation.snapshot_state()
    yield
    JaxPulseInformation.restore_state(state)


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128, as they are when the package is imported under x64: the
    classes' own, and the Pauli matrices the rotation classes keep in their
    closures and in tables (exact in complex64, so promoting them changes no
    value; left complex64, they would round a Python-float angle's sine)."""
    promoted, cells, entries = {}, [], []
    jax.config.update("jax_enable_x64", True)
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                cls._matrix = m.astype(jnp.complex128)
        tables = [vars(c) for c in vars(jo).values() if isinstance(c, type)] + [vars(jo)]
        for table in tables:
            for v in list(table.values()):
                if isinstance(v, (dict, list)):
                    for k in (v.keys() if isinstance(v, dict) else range(len(v))):
                        if getattr(v[k], "dtype", None) == jnp.complex64:
                            entries.append((v, k, v[k]))
                            v[k] = v[k].astype(jnp.complex128)
        for cls in vars(jo).values():
            init = vars(cls).get("__init__") if isinstance(cls, type) else None
            for cell in getattr(init, "__closure__", None) or ():
                v = cell.cell_contents
                if getattr(v, "dtype", None) == jnp.complex64:
                    cells.append((cell, v))
                    cell.cell_contents = v.astype(jnp.complex128)
        yield
    finally:
        for cell, v in cells:
            cell.cell_contents = v
        for v, k, m in reversed(entries):
            v[k] = m
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# Names and imports
# ---------------------------------------------------------------------------


def _defined(path: pathlib.Path) -> set:
    """Public names a module file defines (functions, classes, assignments)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _public_names(name: str) -> set:
    """The JAX module's public names: those its file and the files it
    star-imports define, and those it re-exports by name (private ones
    included), less modules and loggers."""
    mod = importlib.import_module(f"qml_essentials_tpu.{name}")
    path = pathlib.Path(mod.__file__)
    names = _defined(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("qml_essentials_tpu"):
            if node.names[0].name == "*":
                names |= _defined(pathlib.Path(importlib.import_module(node.module).__file__))
            else:
                names |= {a.asname or a.name for a in node.names}
    return {n for n in names if hasattr(mod, n)
            and not isinstance(getattr(mod, n), (types.ModuleType, logging.Logger))}


@pytest.mark.unittest
@pytest.mark.parametrize("name", SHIMS + UTILS + PARALLEL)
def test_every_public_jax_name_is_ported(name):
    port = importlib.import_module(f"qml_essentials_tpu_torch.{name}")
    missing = {n for n in _public_names(name) if not hasattr(port, n)}
    assert missing == NOT_PORTED.get(name, set())


@pytest.mark.unittest
def test_the_not_ported_names_are_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for names in NOT_PORTED.values():
        for n in names:
            assert f"`{n}`" in roadmap, n


@pytest.mark.unittest
def test_shims_import_without_matplotlib_or_jax():
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import importlib\n"
        "import qml_essentials_tpu_torch\n"
        f"for name in {SHIMS + UTILS + PARALLEL!r}:\n"
        "    importlib.import_module('qml_essentials_tpu_torch.' + name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qml_essentials_tpu.'))"
        " or m == 'qml_essentials_tpu']\n"
        "assert not bad, bad\n"
        "from qml_essentials_tpu_torch.drawing import draw_mpl\n"
        "try:\n"
        "    draw_mpl([], 1)\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# Operation.apply_to_state / _tensor / apply_to_density / _flat
# ---------------------------------------------------------------------------


def _rng(seed=0):
    return np.random.default_rng(seed)


def _state(n, seed=0):
    rng = _rng(seed)
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    return psi / np.linalg.norm(psi)


def _density(n, seed=1):
    rng = _rng(seed)
    a = rng.standard_normal((2**n, 2**n)) + 1j * rng.standard_normal((2**n, 2**n))
    rho = a @ a.conj().T
    return rho / np.trace(rho)


_DIAG = np.exp(1j * _rng(2).uniform(0, 2 * np.pi, size=4))

# name -> (constructor, takes a float64 angle of its package)
OPS = {
    "1q RX": lambda m, t: m.RX(t(0.41), wires=1, record=False),
    "scattered CRY": lambda m, t: m.CRY(t(-1.3), wires=[3, 1], record=False),
    "ring-wrap RZZ": lambda m, t: m.RZZ(t(0.77), wires=[4, 0], record=False),
    "scattered CCX": lambda m, t: m.CCX(wires=[4, 0, 2], record=False),
    "DiagonalQubitUnitary": lambda m, t: m.DiagonalQubitUnitary(
        t(_DIAG), wires=[2, 0], record=False),
    "Barrier": lambda m, t: m.Barrier(wires=list(range(N)), record=False),
}
CHANNELS = {
    "BitFlip": lambda m: m.BitFlip(0.1, wires=2),
    "AmplitudeDamping": lambda m: m.AmplitudeDamping(0.2, wires=0),
    "DepolarizingChannel": lambda m: m.DepolarizingChannel(0.15, wires=4),
}


def _jax_value(v):
    return jnp.asarray(v, dtype=jnp.complex128 if np.iscomplexobj(v) else jnp.float64)


def _torch_value(v):
    return torch.tensor(v, dtype=torch.complex128 if np.iscomplexobj(v) else torch.float64)


def _apply_all(op, psi, rho, lib):
    """The four complex-state methods of *op* on *psi* and *rho*."""
    arr = jnp.asarray if lib == "jax" else torch.tensor
    return {
        "state": op.apply_to_state(arr(psi), N),
        "tensor": op.apply_to_state_tensor(arr(psi.reshape((2,) * N)), N),
        "density": op.apply_to_density(arr(rho), N),
        "flat": op.apply_to_density_flat(arr(rho.reshape(-1)), N),
    }


@pytest.mark.unittest
@pytest.mark.parametrize("name", list(OPS))
def test_gate_complex_state_api_matches_jax(name):
    psi, rho = _state(N), _density(N)
    with jax_x64():
        ref = {k: _np(v) for k, v in _apply_all(OPS[name](jo, _jax_value), psi, rho,
                                                "jax").items()}
    got = _apply_all(OPS[name](to, _torch_value), psi, rho, "torch")
    for key in ref:
        assert got[key].dtype == torch.complex128, key
        _close(got[key], ref[key])


@pytest.mark.unittest
@pytest.mark.parametrize("op", [to.Barrier(wires=[0, 1], record=False),
                                to.Id(wires=[0, 2], record=False)])
def test_noops_return_their_input(op):
    psi = torch.tensor(_state(3))
    rho = torch.tensor(_density(3))
    assert op.apply_to_state(psi, 3) is psi
    assert op.apply_to_state_tensor(psi.reshape(2, 2, 2), 3).data_ptr() == psi.data_ptr()
    assert op.apply_to_density(rho, 3) is rho
    assert op.apply_to_density_flat(rho.reshape(-1), 3).data_ptr() == rho.data_ptr()


@pytest.mark.unittest
@pytest.mark.parametrize("name", list(CHANNELS))
def test_channel_complex_state_api_matches_jax(name):
    psi, rho = _state(N), _density(N)
    with jax_x64():
        jop = CHANNELS[name](jo)
        ref = {"density": _np(jop.apply_to_density(jnp.asarray(rho), N)),
               "flat": _np(jop.apply_to_density_flat(jnp.asarray(rho.reshape(-1)), N))}
        with pytest.raises(TypeError):
            jop.apply_to_state(jnp.asarray(psi), N)
    op = CHANNELS[name](to)
    _close(op.apply_to_density(torch.tensor(rho), N), ref["density"])
    _close(op.apply_to_density_flat(torch.tensor(rho.reshape(-1)), N), ref["flat"])
    for method, arg in (("apply_to_state", torch.tensor(psi)),
                        ("apply_to_state_tensor", torch.tensor(psi.reshape((2,) * N)))):
        with pytest.raises(TypeError, match="noise channel"):
            getattr(op, method)(arg, N)


@pytest.mark.unittest
def test_complex64_states_stay_complex64():
    psi = torch.tensor(_state(3), dtype=torch.complex64)
    out = to.RX(0.3, wires=2, record=False).apply_to_state(psi, 3)
    assert out.dtype == torch.complex64
    _close(out, to.RX(0.3, wires=2, record=False).apply_to_state(psi.to(torch.complex128), 3),
           1e-6)


# ---------------------------------------------------------------------------
# The complex helpers of ops/kernels.py
# ---------------------------------------------------------------------------


def _unitary(k, seed):
    q, _ = np.linalg.qr(_rng(seed).standard_normal((2**k, 2**k))
                        + 1j * _rng(seed + 1).standard_normal((2**k, 2**k)))
    return q


@pytest.mark.unittest
def test_kernel_helpers_match_jax():
    psi = _state(N)
    mat3 = _rng(3).standard_normal((8, 8)) + 1j * _rng(4).standard_normal((8, 8))
    u2 = _unitary(2, 5)
    rho3 = _density(3, seed=6)
    kraus = [_rng(7 + i).standard_normal((4, 4)) + 1j * _rng(9 + i).standard_normal((4, 4))
             for i in range(3)]
    probs = np.abs(_state(4, seed=8).reshape((2,) * 4)) ** 2
    cases = {
        "to_ri": lambda k, a: k.to_ri(a(psi)),
        "from_ri": lambda k, a: k.from_ri(k.to_ri(a(psi))),
        "permute_qubits_matrix": lambda k, a: k.permute_qubits_matrix(a(mat3), [2, 0, 1], 3),
        "apply_diagonal_flat": lambda k, a: k.apply_diagonal_flat(a(psi), a(_DIAG), [3, 1], N),
        "apply_matrix": lambda k, a: k.apply_matrix(a(psi.reshape((2,) * N)), a(u2), [4, 1]),
        "apply_matrix contiguous": lambda k, a: k.apply_matrix(a(psi.reshape((2,) * N)), a(u2),
                                                                [2, 3]),
        "apply_diagonal": lambda k, a: k.apply_diagonal(a(psi.reshape((2,) * N)), a(_DIAG),
                                                        [0, 4]),
        "apply_unitary_to_density_flat": lambda k, a: k.apply_unitary_to_density_flat(
            a(rho3.reshape(-1)), a(u2), [2, 0], 3),
        "apply_unitary_to_density": lambda k, a: k.apply_unitary_to_density(
            a(rho3.reshape((2,) * 6)), a(u2), [1, 2], 3),
        "apply_kraus_to_density_flat": lambda k, a: k.apply_kraus_to_density_flat(
            a(rho3.reshape(-1)), [a(K) for K in kraus], [2, 0], 3),
        "apply_kraus_to_density": lambda k, a: k.apply_kraus_to_density(
            a(rho3.reshape((2,) * 6)), [a(K) for K in kraus], [0, 1], 3),
        "marginal_qubit_probs": lambda k, a: k.marginal_qubit_probs(a(probs), 2),
        "marginal_qubit_probs flat": lambda k, a: k.marginal_qubit_probs(a(probs.reshape(-1)),
                                                                         0),
    }
    with jax_x64():
        ref = {name: _np(f(jk, jnp.asarray)) for name, f in cases.items()}
    for name, f in cases.items():
        _close(f(tk, torch.tensor), ref[name])


@pytest.mark.unittest
@pytest.mark.parametrize("fn, n", [("zero_state", 3), ("zero_state_tensor", 3),
                                   ("zero_density", 2), ("zero_density_tensor", 2)])
def test_zero_states_match_jax(fn, n):
    with jax_x64():
        ref = _np(getattr(jk, fn)(n))
    got = getattr(tk, fn)(n, torch.complex128, device="cpu")
    assert got.dtype == torch.complex128
    _close(got, ref)
    assert getattr(tk, fn)(n, device="cpu").dtype == torch.complex64


@pytest.mark.unittest
@pytest.mark.parametrize("fn", ["zero_state", "zero_state_tensor", "zero_density",
                                "zero_density_tensor"])
def test_zero_states_default_to_the_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tk, fn)(2)


@pytest.mark.unittest
def test_set_matmul_precision_takes_the_jax_names():
    before = torch.get_float32_matmul_precision()
    try:
        for name, want in (("highest", "highest"), ("FLOAT32", "highest"), ("high", "high"),
                           ("tensorfloat32", "high"), ("default", "medium"),
                           ("bfloat16", "medium")):
            tk.set_matmul_precision(name)
            assert torch.get_float32_matmul_precision() == want, name
        for lib in (jk, tk):
            with pytest.raises(KeyError):
                lib.set_matmul_precision("fp8")
    finally:
        torch.set_float32_matmul_precision(before)


# ---------------------------------------------------------------------------
# simulate_pure, simulate_mixed, set_fusion
# ---------------------------------------------------------------------------

NOISE = {"BitFlip": 0.02, "Depolarizing": 0.03, "AmplitudeDamping": 0.04, "PhaseDamping": 0.01}


@pytest.fixture(scope="module")
def tapes():
    """The 5q 2-layer Circuit_19 tape, noise-free and noisy, in both
    packages (float64), parameters carried by ``Model.load_numpy``."""
    state = JaxPulseInformation.snapshot_state()
    try:
        jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=11)
    finally:
        JaxPulseInformation.restore_state(state)
    tm = Model(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=11,
               device="cpu", dtype=torch.float64)
    tm.load_numpy(np.asarray(jm.params, dtype=np.float64), np.asarray(jm.enc_params))
    out = {}
    for noise in (None, NOISE):
        with jax_x64():
            with jax_recording() as jt:
                jm._variational(jnp.asarray(np.asarray(jm.params[0]), dtype=jnp.float64),
                                jnp.asarray([X], dtype=jnp.float64), noise_params=noise,
                                random_key=jax.random.key(0))
            ref = (_np(jsim.simulate_pure(jt, N)) if noise is None
                   else _np(jsim.simulate_mixed(jt, N)))
            plans = {w: [(kind, list(wires)) for kind, _, wires in _jax_plans(jt, w)]
                     for w in FUSION_CASES} if noise is None else None
        with recording() as tt, torch.no_grad():
            tm._variational(tm.params[0], torch.tensor([X], dtype=torch.float64),
                            noise_params=noise, random_key=torch.Generator().manual_seed(0))
        out["noisy" if noise else "pure"] = (jt, tt, ref, plans)
    return out


FUSION_CASES = ((5, None), (5, 0), (3, 1), (0, None))


def _with_fusion(sim, width, excess, fn):
    before = (sim.FUSE_MAX_WIDTH, sim.FUSE_MIN_EXCESS)
    try:
        sim.set_fusion(width, excess)
        return fn()
    finally:
        sim.FUSE_MAX_WIDTH, sim.FUSE_MIN_EXCESS = before


def _jax_plans(jt, case):
    return _with_fusion(jsim, *case, lambda: jsim.plan_contractions(jt, n_qubits=N))


@pytest.mark.unittest
def test_simulate_pure_matches_jax(tapes):
    _, tt, ref, _ = tapes["pure"]
    got = tsim.simulate_pure(tt, N, torch.float64, device="cpu")
    assert got.dtype == torch.complex128 and got.shape == (2**N,)
    _close(got, ref)


@pytest.mark.unittest
def test_simulate_mixed_matches_jax(tapes):
    _, tt, ref, _ = tapes["noisy"]
    got = tsim.simulate_mixed(tt, N, torch.float64, device="cpu")
    assert got.dtype == torch.complex128 and got.shape == (2**N, 2**N)
    _close(got, ref)
    _, pure, psi, _ = tapes["pure"]
    _close(tsim.simulate_mixed(pure, N, torch.float64, device="cpu"),
           np.outer(psi, psi.conj()))


@pytest.mark.unittest
def test_simulate_pure_defaults_to_the_card(tapes):
    _, tt, _, _ = tapes["pure"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate_pure(tt, N)


@pytest.mark.unittest
def test_tape_dtype_follows_the_gates():
    """The precision is the caller's *dtype* (float32 unless asked), whatever
    the gates' own matrices hold, as the JAX package's follows its x64 switch."""
    with recording() as single:
        to.H(wires=0)
        to.RX(0.3, wires=0)
    with recording() as fixed:
        to.H(wires=0)
        to.CZ(wires=[0, 1])
    for tape, n in ((single, 1), (fixed, 2)):
        for sim in (tsim.simulate_pure, tsim.simulate_mixed):
            assert sim(tape, n, device="cpu").dtype == torch.complex64
            assert sim(tape, n, torch.float64, device="cpu").dtype == torch.complex128


@pytest.mark.unittest
@pytest.mark.parametrize("case", FUSION_CASES)
def test_set_fusion_changes_the_plan_as_in_jax(tapes, case):
    _, tt, _, plans = tapes["pure"]
    got = _with_fusion(tsim, *case, lambda: tsim.plan_contractions(tt, n_qubits=N))
    assert [(kind, list(wires)) for kind, _, wires in got] == plans[case]
    if case != FUSION_CASES[0]:
        assert plans[case] != plans[FUSION_CASES[0]]


# ---------------------------------------------------------------------------
# The Gates accessor
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("gate_mode", ["unitary", "pulse"])
def test_gates_instance_accessor_records_as_jax(gate_mode):
    """``Gates().RX(w=0.3, wires=0)`` (keyword arguments on an instance)
    records the JAX package's tape in both gate modes: the same gates on the
    same wires, their matrices to 1e-6 (a Python float angle makes a float32
    gate in both packages; the JAX package's pulse solve runs in float32,
    the port's in float64)."""
    from qml_essentials_tpu.models.gates import Gates as JaxGates
    from qml_essentials_tpu_torch.models.gates import Gates

    with jax_recording() as jt:
        JaxGates().RX(w=0.3, wires=0, gate_mode=gate_mode)
    with recording() as tt:
        Gates().RX(w=0.3, wires=0, gate_mode=gate_mode)
    assert [(o.name, o.wires) for o in tt] == [(o.name, list(o.wires)) for o in jt]
    for o, j in zip(tt, jt):
        _close(o.matrix, j.matrix, 1e-6 if gate_mode == "unitary" else 5e-5)
    with pytest.raises(AttributeError):
        Gates().__wrapped__  # noqa: B018 - dunder lookups stay attribute errors


# ---------------------------------------------------------------------------
# Scalar angles take the script's precision
# ---------------------------------------------------------------------------

# Every gate class that takes an angle, by the route its angle comes by
# (``_pauli_exponential``, ``ControlledPhaseShift``, ``ControlledPauliRot``,
# ``Rot``'s three, ``PauliRot`` and its fixed-word subclasses).
ANGLE_GATES = {
    "RX": lambda m, a: m.RX(a, wires=1),
    "RY": lambda m, a: m.RY(a, wires=1),
    "RZ": lambda m, a: m.RZ(a, wires=1),
    "ControlledPhaseShift": lambda m, a: m.ControlledPhaseShift(a, wires=[0, 2]),
    "CRX": lambda m, a: m.CRX(a, wires=[2, 0]),
    "CRY": lambda m, a: m.CRY(a, wires=[2, 0]),
    "CRZ": lambda m, a: m.CRZ(a, wires=[2, 0]),
    "Rot": lambda m, a: m.Rot(a, a * 0.5 + 0.25, a - 1.5, wires=1),
    "PauliRot": lambda m, a: m.PauliRot(a, "XZY", wires=[0, 1, 2]),
    "RXX": lambda m, a: m.RXX(a, wires=[1, 2]),
    "RYY": lambda m, a: m.RYY(a, wires=[1, 2]),
    "RZZ": lambda m, a: m.RZZ(a, wires=[1, 2]),
    "RZX": lambda m, a: m.RZX(a, wires=[1, 2]),
}
SCALARS = {"python": float, "numpy": np.float64}


def _scalar_circuit(m, name, scalar):
    """RY(scalar) on every wire, then the gate under test with a scalar
    angle (every angle a Python or numpy scalar)."""
    def circuit():
        for w in range(3):
            m.RY(scalar(0.3 + 0.4 * w), wires=w)
        ANGLE_GATES[name](m, scalar(0.7))
    return circuit


def _scalar_answers(name, scalar, dtype):
    """(state, <Z> on every wire) of the circuit in the port (*dtype*) and
    in the JAX package (x64 for float64)."""
    from qml_essentials_tpu.core.executor import Script as JaxScript
    from qml_essentials_tpu_torch.core.executor import Script

    def jax_run():
        s = JaxScript(_scalar_circuit(jo, name, scalar), n_qubits=3)
        return (_np(s.execute(type="state")),
                _np(s.execute(type="expval", obs=[jo.PauliZ(w, record=False)
                                                   for w in range(3)])))

    s = Script(_scalar_circuit(to, name, scalar), n_qubits=3, device="cpu", dtype=dtype)
    got = (s.execute(type="state"),
           s.execute(type="expval", obs=[to.PauliZ(w, record=False) for w in range(3)]))
    if dtype == torch.float64:
        with jax_x64():
            ref = jax_run()
    else:
        ref = jax_run()
    return got, ref


@pytest.mark.unittest
@pytest.mark.parametrize("scalar", list(SCALARS))
@pytest.mark.parametrize("name", list(ANGLE_GATES))
def test_scalar_angles_run_at_float64(name, scalar):
    """A float64 script whose gates take Python or numpy scalar angles
    computes them in float64, as the JAX package does under x64 (a float32
    angle would leave the state ~5e-9 off)."""
    (state, z), (ref_state, ref_z) = _scalar_answers(name, SCALARS[scalar], torch.float64)
    assert state.dtype == torch.complex128 and z.dtype == torch.float64
    _close(state, ref_state)
    _close(z, ref_z)


@pytest.mark.unittest
@pytest.mark.parametrize("name", ["RX", "CRY", "Rot", "RZX"])
def test_scalar_angles_in_float32_scripts_match_jax(name):
    """A float32 script rounds the float64 scalar gate once to complex64: it
    agrees with the JAX package's float32 path at the float32 tolerance."""
    (state, z), (ref_state, ref_z) = _scalar_answers(name, float, torch.float32)
    assert state.dtype == torch.complex64 and z.dtype == torch.float32
    _close(state, ref_state, 1e-6)
    _close(z, ref_z, 1e-6)


# ---------------------------------------------------------------------------
# Generators and RandomUnitary
# ---------------------------------------------------------------------------

GENERATORS = {
    "PauliRot XZY": lambda m: m.PauliRot(0.3, "XZY", wires=[2, 0, 1], record=False),
    "RZZ": lambda m: m.RZZ(0.3, wires=[1, 3], record=False),
    "CRY": lambda m: m.CRY(0.3, wires=[1, 0], record=False),
    "ControlledPauliRot 2 controls": lambda m: m.ControlledPauliRot(
        0.3, "XY", wires=[0, 1, 2, 3], n_controls=2, record=False),
}


@pytest.mark.unittest
@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_match_jax(name):
    with jax_x64():
        ref = GENERATORS[name](jo).generator()
        ref_mat = _np(ref.matrix)
    with recording() as tape:
        gen = GENERATORS[name](to).generator()
    assert tape == [] and isinstance(gen, to.Hermitian)
    assert gen.wires == list(ref.wires)
    _close(gen.matrix, ref_mat)


@pytest.mark.unittest
@pytest.mark.parametrize("wires, scale", [(0, 1.0), ([0, 1], 0.7), ([2, 0, 1], 3.0)])
def test_random_unitary_properties(wires, scale):
    with recording() as tape:
        op = to.RandomUnitary(wires, torch.Generator().manual_seed(5), scale=scale)
    assert tape == [op]
    H = op.matrix
    dim = 2 ** len(op.wires)
    assert H.shape == (dim, dim) and H.dtype == torch.complex128
    assert torch.equal(H, H.mH)
    assert abs(torch.linalg.matrix_norm(H).item() - scale) <= TOL
    with recording() as tape:
        to.RandomUnitary(wires, torch.Generator().manual_seed(5), record=False)
    assert tape == []


@pytest.mark.unittest
def test_random_unitary_is_reproducible():
    a, b = torch.Generator().manual_seed(42), torch.Generator().manual_seed(42)
    first = to.RandomUnitary([0, 1], a, record=False).matrix
    assert torch.equal(first, to.RandomUnitary([0, 1], b, record=False).matrix)
    assert not torch.equal(first, to.RandomUnitary([0, 1], a, record=False).matrix)


def _features(H: np.ndarray) -> dict:
    """Entries and the top eigenvalue of a batch of 2x2 draws."""
    return {"Re H00": H[:, 0, 0].real, "Re H01": H[:, 0, 1].real, "Im H01": H[:, 0, 1].imag,
            "H11": H[:, 1, 1].real, "top eigenvalue": np.linalg.eigvalsh(H)[:, -1]}


@pytest.mark.unittest
def test_random_unitary_follows_the_jax_law():
    draws = 2000
    keys = jax.random.split(jax.random.PRNGKey(3), draws)
    ref = np.asarray(jax.vmap(lambda k: jo.RandomUnitary(0, k, record=False).matrix)(keys))
    gen = torch.Generator().manual_seed(3)
    got = np.stack([_np(to.RandomUnitary(0, gen, record=False).matrix) for _ in range(draws)])
    for (name, a), b in zip(_features(got).items(), _features(ref).values()):
        assert stats.ks_2samp(a, b).pvalue > 1e-3, name
