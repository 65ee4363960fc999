"""The adjoint-state backward of the PyTorch port (``ops/adjoint.py``) and its
kernels' plain versions, against the JAX package.

Kernel level.  ``adjoint_step_plain`` / ``adjoint_step_top_plain`` /
``rotate_pair_plain`` against the JAX package's own launchers
(``pallas_kernels.adjoint_step_ri`` / ``adjoint_step_top_ri`` /
``rotate_pair_ri``, interpret mode, ``GRAM_MODE = "split3"`` and
``PRECISION_MODE = "highest"`` set with monkeypatch so its products are plain
float32), on random states, unitaries and cotangents from
``numpy.random.default_rng``:

* the rebuilt state, a float32 cotangent and the matrix cotangent within
  1e-5 of the largest magnitude (float32 sums in other orders, Karatsuba
  against the 4-multiply form);
* a bfloat16 cotangent out, compared after upcast: within one bf16 ulp (2^-8
  of the value's binade) plus that 1e-5 floor — both sides round values that
  differ by float32 rounding;
* a bfloat16 cotangent in: within 2^-8 of the largest magnitude (the
  reference's Karatsuba form adds ``lr + li`` in bfloat16 before it
  multiplies, where the port upcasts first);
* the paired rotation, in float32 and bfloat16, bit for bit;
* in float64, each plain adjoint step undoes the forward window to 1e-12 and
  equals the window backward on the rebuilt input;
* the fused steps ``adjoint_rotmat_plain`` / ``adjoint_matrot_plain``
  against ``pallas_kernels.adjoint_rotmat_ri`` / ``adjoint_matrot_ri`` by the
  same bounds, and in float64 against the fused forward and backward.

Executor level.  A 16-qubit, 2-layer Circuit_19 with ``LARGE_STATE_MIN_N``
lowered to 16 (so the scheduled plan, with its outer-product start,
rotations, windows and a top window, runs through the executor) and
``BACKWARD_MODE = "adjoint"``:

* λ in "f32": the gradient of the mean <Z> matches the JAX package's
  ``jax.grad`` in adjoint mode (its einsum path, weights carried by
  ``load_numpy``) within 1e-4 of max|g| (float32 on both sides, ~20 steps);
  in float64 it equals the port's saved-residual executor to 1e-10 of
  max|g| (the same algebra; the adjoint rebuilds each state instead of
  keeping it);
* λ in "bf16": max|g - g_f64| <= 5e-4, the budget the JAX package accepts for
  a bfloat16 cotangent (docs/performance.md);
* dtype discipline, one state-sized residual, the small plans of the JAX
  package's own adjoint tests (ring-wrap CX chains, scattered windows, a
  diagonal gate, a ring-wrap gate at 14 qubits: to 1e-5 against the port's
  autodiff and the JAX package's adjoint), the backward rule, and one
  decision for a whole batch;
* scattered windows between kernel steps at 6 qubits with
  ``LARGE_STATE_MIN_N`` lowered, so the bfloat16 cotangent is in force:
  lambda leaves each scattered step in float32, and the gradients match the
  JAX package's adjoint within 1e-5 (f32 lambda) or 2^-8 (one bfloat16
  rounding of lambda) of the largest magnitude;
* with ``adjoint.set_adjoint(False)`` a gradient sent to the adjoint raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import executor as jax_executor
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import operations as jop
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jrecording
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import adjoint, cuda_kernels, kernels, saved
from qml_essentials_tpu_torch.ops import operations as op
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_IN_TOL = 2.0**-8
EXACT_TOL = 1e-12


def _unitary_pair(rng, k):
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return np.stack([q.real, q.imag])


def _inputs(n, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w2 = _unitary_pair(rng, k).astype(dtype)
    psi = rng.normal(size=(2, 2**n)).astype(dtype)
    lam = rng.normal(size=(2, 2**n)).astype(dtype)
    return w2, psi / np.linalg.norm(psi), lam / np.linalg.norm(lam)


def _bf16_ulp(ref):
    _, e = np.frexp(np.asarray(ref, dtype=np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_close(got, ref, dtype=torch.float32):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), dtype=np.float64)
    floor = F32_TOL * np.abs(ref).max()
    if dtype == torch.bfloat16:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref) + floor)
    else:
        assert np.abs(got - ref).max() <= floor


@pytest.fixture
def split3_gram(monkeypatch):
    monkeypatch.setattr(pallas_kernels, "GRAM_MODE", "split3")
    monkeypatch.setattr(pallas_kernels, "PRECISION_MODE", "highest")


# ---------------------------------------------------------------------------
# Kernel level: plain versions against the Pallas launchers
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("lam", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,a,k", [(10, 0, 3), (11, 2, 4), (12, 2, 3)])
def test_adjoint_step_plain_matches_pallas(split3_gram, n, a, k, lam):
    w2, psi, lam2 = _inputs(n, k, seed=n + a + k)
    lam_t = getattr(torch, lam)
    ref = pallas_kernels.adjoint_step_ri(jnp.asarray(psi), jnp.asarray(lam2), jnp.asarray(w2),
                                         a, k, n, True, getattr(jnp, lam))
    got = kernels.adjoint_step_plain(torch.from_numpy(w2), torch.from_numpy(psi),
                                     torch.from_numpy(lam2), a, k, n, lam_t)
    assert [t.dtype for t in got] == [torch.float32, lam_t, torch.float32]
    for t, r, dt in zip(got, ref, (torch.float32, lam_t, torch.float32)):
        _assert_close(t, r, dt)


@pytest.mark.unittest
@pytest.mark.parametrize("lam", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(10, 3), (12, 4), (10, 1)])
def test_adjoint_step_top_plain_matches_pallas(split3_gram, n, k, lam):
    w2, psi, lam2 = _inputs(n, k, seed=3 * n + k)
    lam_t = getattr(torch, lam)
    ref = pallas_kernels.adjoint_step_top_ri(jnp.asarray(psi), jnp.asarray(lam2),
                                             jnp.asarray(w2), k, n, True, getattr(jnp, lam))
    got = kernels.adjoint_step_top_plain(torch.from_numpy(w2), torch.from_numpy(psi),
                                         torch.from_numpy(lam2), k, n, lam_t)
    assert [t.dtype for t in got] == [torch.float32, lam_t, torch.float32]
    for t, r, dt in zip(got, ref, (torch.float32, lam_t, torch.float32)):
        _assert_close(t, r, dt)


@pytest.mark.unittest
@pytest.mark.parametrize("top", [False, True], ids=["window", "top"])
def test_bf16_cotangent_in_matches_pallas(split3_gram, top):
    n, a, k = 11, 2, 4
    w2, psi, lam2 = _inputs(n, k, seed=9)
    lam16 = torch.from_numpy(lam2).to(torch.bfloat16)
    lam16_j = jnp.asarray(lam16.float().numpy()).astype(jnp.bfloat16)
    args = (torch.from_numpy(w2), torch.from_numpy(psi), lam16)
    if top:
        ref = pallas_kernels.adjoint_step_top_ri(jnp.asarray(psi), lam16_j, jnp.asarray(w2), k,
                                                 n, True, jnp.float32)
        got = kernels.adjoint_step_top_plain(*args, k, n, torch.float32)
    else:
        ref = pallas_kernels.adjoint_step_ri(jnp.asarray(psi), lam16_j, jnp.asarray(w2), a, k,
                                             n, True, jnp.float32)
        got = kernels.adjoint_step_plain(*args, a, k, n, torch.float32)
    for t, r in zip(got, ref):
        r = np.asarray(r, dtype=np.float64)
        assert np.abs(t.numpy() - r).max() <= BF16_IN_TOL * np.abs(r).max()


@pytest.mark.unittest
@pytest.mark.parametrize("lam", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,r", [(10, 3), (12, 7), (11, 1)])
def test_rotate_pair_plain_matches_pallas(n, r, lam):
    _, psi, lam2 = _inputs(n, 1, seed=n + r)
    lam_t = torch.from_numpy(lam2).to(getattr(torch, lam))
    lam_j = jnp.asarray(lam_t.float().numpy()).astype(getattr(jnp, lam))
    ref_psi, ref_lam = pallas_kernels.rotate_pair_ri(jnp.asarray(psi), lam_j, r, n, True)
    got_psi, got_lam = kernels.rotate_pair_plain(torch.from_numpy(psi), lam_t, r, n)
    assert got_psi.dtype == torch.float32 and got_lam.dtype == lam_t.dtype
    assert np.array_equal(got_psi.numpy(), np.asarray(ref_psi))
    assert np.array_equal(got_lam.float().numpy(), np.asarray(ref_lam, dtype=np.float32))


@pytest.mark.unittest
@pytest.mark.parametrize(
    "n,a,k", [(8, 1, 3), (8, 0, 2), (8, 6, 1), (8, 5, 3), (6, 3, 3)],
    ids=["mid", "a0-K4", "B2-K2", "top", "top-a3"],
)
def test_plain_adjoint_step_undoes_the_window(n, a, k):
    """float64: the step rebuilds the window's input from its output, and its
    (lambda_prev, gw) are the window backward's on that input."""
    w2, x, lam = (torch.from_numpy(t) for t in _inputs(n, k, seed=n * 10 + a + k, dtype=np.float64))
    if a + k == n:
        y = kernels.window_apply_top_plain(x, w2, k, n)
        got = kernels.adjoint_step_top_plain(w2, y, lam, k, n, torch.float64)
        ref = kernels.window_apply_top_bwd_plain(w2, lam, got[0], k, n, torch.float64)
    else:
        y = kernels.window_apply_plain(x, w2, a, k, n)
        got = kernels.adjoint_step_plain(w2, y, lam, a, k, n, torch.float64)
        ref = kernels.window_apply_bwd_plain(w2, lam, got[0], a, k, n, torch.float64)
    assert (got[0] - x).abs().max() <= EXACT_TOL
    assert (got[1] - ref[0]).abs().max() <= EXACT_TOL
    assert (got[2] - ref[1]).abs().max() <= EXACT_TOL


# Fused (rotation, window) adjoint steps: (kind, n, r, k), k == r for rotmat
# and k == n - r for matrot.
FUSED_ADJ_CASES = [("rotmat", 10, 4, 4), ("rotmat", 12, 7, 7), ("matrot", 10, 6, 4),
                   ("matrot", 12, 5, 7)]


@pytest.mark.unittest
@pytest.mark.parametrize("lam", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n,r,k", FUSED_ADJ_CASES)
def test_fused_adjoint_plain_matches_pallas(split3_gram, kind, n, r, k, lam):
    """adjoint_rotmat / adjoint_matrot (B14 / B15): the undo of the window and
    the rotation on psi and lambda, and gw = G0 W."""
    w2, psi, lam2 = _inputs(n, k, seed=7 * n + r)
    lam_t = getattr(torch, lam)
    ref = getattr(pallas_kernels, f"adjoint_{kind}_ri")(
        jnp.asarray(psi), jnp.asarray(lam2), jnp.asarray(w2), r, n, True, getattr(jnp, lam))
    got = getattr(kernels, f"adjoint_{kind}_plain")(
        torch.from_numpy(w2), torch.from_numpy(psi), torch.from_numpy(lam2), r, n, lam_t)
    assert [t.dtype for t in got] == [torch.float32, lam_t, torch.float32]
    for t, rf, dt in zip(got, ref, (torch.float32, lam_t, torch.float32)):
        _assert_close(t, rf, dt)


@pytest.mark.unittest
@pytest.mark.parametrize("kind,n,r", [("rotmat", 7, 3), ("rotmat", 6, 1), ("matrot", 7, 4),
                                      ("matrot", 6, 5)])
def test_plain_fused_adjoint_undoes_the_step(kind, n, r):
    """float64: the fused adjoint step rebuilds the step's input from its
    output, and its (lambda_in, gw) are the fused backward's on that input."""
    k = r if kind == "rotmat" else n - r
    w2, x, lam = (torch.from_numpy(t) for t in _inputs(n, k, seed=n * 10 + r, dtype=np.float64))
    y = getattr(kernels, f"{kind}_apply_plain")(x, w2, r, n)
    got = getattr(kernels, f"adjoint_{kind}_plain")(w2, y, lam, r, n, torch.float64)
    ref = getattr(kernels, f"{kind}_apply_bwd_plain")(w2, lam, got[0], r, n, torch.float64)
    assert (got[0] - x).abs().max() <= EXACT_TOL
    assert (got[1] - ref[0]).abs().max() <= EXACT_TOL
    assert (got[2] - ref[1]).abs().max() <= EXACT_TOL


# ---------------------------------------------------------------------------
# Executor level: 16-qubit Circuit_19 through the adjoint executor
# ---------------------------------------------------------------------------

N = 16
X0 = 0.37
BATCH = (0.37, -0.81, 1.42)
JAX_TOL = 1e-4
F64_TOL = 1e-10
BF16_BUDGET = 5e-4
SMALL_TOL = 1e-5


def _port_model(params, dtype=torch.float32):
    m = Model(n_qubits=N, n_layers=2, circuit_type="Circuit_19", dtype=dtype, device="cpu")
    m.load_numpy(params)
    return m


def _port_grad(params, dtype=torch.float32, inputs=X0):
    m = _port_model(params, dtype)
    loss = m(inputs=inputs).mean()
    loss.backward()
    return float(loss), m.params.grad.double().numpy()


@pytest.fixture(scope="module")
def results():
    """Gradients of the same model under every configuration, computed once."""
    pulse_state = PulseInformation.snapshot_state()
    jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=13)
    PulseInformation.restore_state(pulse_state)  # JaxModel() sets the global pulse envelope
    params = np.asarray(jm.params)
    out = {"params": params}
    steps, rotations = [], []
    orig_step, orig_top, orig_rot = (cuda_kernels.adjoint_step, cuda_kernels.adjoint_step_top,
                                     cuda_kernels.rotate_pair)

    def spy_step(w2, psi2, lam2, *rest):
        steps.append((psi2.dtype, lam2.dtype, rest[-1]))
        return orig_step(w2, psi2, lam2, *rest)

    def spy_top(w2, psi2, lam2, *rest):
        steps.append((psi2.dtype, lam2.dtype, rest[-1]))
        return orig_top(w2, psi2, lam2, *rest)

    def spy_rot(psi2, lam2, r, n):
        rotations.append((psi2.dtype, lam2.dtype))
        return orig_rot(psi2, lam2, r, n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_executor, "JIT_SINGLE", False)  # eager: no 16q compile
        jsim.set_backward_mode("adjoint")
        try:
            v, g = jax.value_and_grad(lambda p: jm(p, inputs=X0).mean())(jm.params)
        finally:
            jsim.set_backward_mode("auto")
        out["jax"] = (float(v), np.asarray(g, dtype=np.float64))

        mp.setattr(tsim, "LARGE_STATE_MIN_N", N)
        mp.setattr(saved, "LAMBDA_MODE", "f32")
        mp.setattr(tsim, "BACKWARD_MODE", "autodiff")
        out["saved_f64"] = _port_grad(params, torch.float64)
        mp.setattr(tsim, "BACKWARD_MODE", "adjoint")
        out["adjoint_f64"] = _port_grad(params, torch.float64)
        out["adjoint_f32"] = _port_grad(params)
        mp.setattr(saved, "LAMBDA_MODE", "bf16")
        mp.setattr(cuda_kernels, "adjoint_step", spy_step)
        mp.setattr(cuda_kernels, "adjoint_step_top", spy_top)
        mp.setattr(cuda_kernels, "rotate_pair", spy_rot)
        out["adjoint_bf16"] = _port_grad(params)
    out["steps"], out["rotations"] = steps, rotations
    return out


@pytest.mark.unittest
def test_adjoint_f32_matches_jax_and_f64_matches_the_saved_executor(results):
    v_jax, g_jax = results["jax"]
    v, g = results["adjoint_f32"]
    assert g.shape == g_jax.shape
    assert abs(v - v_jax) <= JAX_TOL
    assert np.abs(g - g_jax).max() <= JAX_TOL * np.abs(g_jax).max()
    _, g_saved = results["saved_f64"]
    _, g_adj = results["adjoint_f64"]
    assert np.abs(g_adj - g_saved).max() <= F64_TOL * np.abs(g_saved).max()


@pytest.mark.unittest
def test_bf16_lambda_within_budget(results):
    v64, g64 = results["adjoint_f64"]
    v, g = results["adjoint_bf16"]
    assert abs(v - v64) <= JAX_TOL
    assert np.abs(g - g64).max() <= BF16_BUDGET


@pytest.mark.unittest
def test_dtype_discipline(results):
    """psi stays float32; lambda enters float32, travels bfloat16 between
    payload steps, and leaves the earliest one in float32; the paired
    rotation sees (float32, bfloat16)."""
    steps = results["steps"]
    assert len(steps) >= 3
    assert all(s[0] == torch.float32 for s in steps)
    assert steps[0][1] == torch.float32 and steps[0][2] == torch.bfloat16
    assert all(s[1] == torch.bfloat16 for s in steps[1:])
    assert all(s[2] == torch.bfloat16 for s in steps[:-1])
    assert steps[-1][2] == torch.float32
    rotations = results["rotations"]
    assert all(r[0] == torch.float32 for r in rotations)
    assert (torch.float32, torch.bfloat16) in rotations


def _state_sized_saves(params, mode, monkeypatch):
    """Tensors of the state's full (2, 2**N) shape that autograd keeps for the
    backward of one forward."""
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    monkeypatch.setattr(tsim, "BACKWARD_MODE", mode)
    m = _port_model(params)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = m(inputs=X0).mean()
    out.backward()
    return sum(s == (2, 2**N) for s in shapes)


@pytest.mark.unittest
def test_forward_keeps_one_state(results, monkeypatch):
    with recording() as tape:
        m = _port_model(results["params"])
        m._variational(m.params[0], torch.tensor([X0]))
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    plan, _ = tsim.scheduled_plan(tape, N)
    payload_steps = sum(kind != "rot" for kind, _, _ in plan)
    assert payload_steps > 1
    assert _state_sized_saves(results["params"], "adjoint", monkeypatch) == 1
    assert _state_sized_saves(results["params"], "autodiff", monkeypatch) == payload_steps


# ---------------------------------------------------------------------------
# Small plans (the JAX package's own adjoint tests)
# ---------------------------------------------------------------------------


def _ring_circuit(lib, theta, n):
    for q in range(n):
        lib.RY(theta[q], wires=q)
    for q in range(n):
        lib.CX(wires=[q, (q + 1) % n])
    lib.H(wires=0)
    for q in range(n):
        lib.RX(theta[q] * 0.7, wires=q)


def _diag_circuit(lib, n, diag, wires):
    for q in range(n):
        lib.H(wires=q)
    lib.DiagonalQubitUnitary(diag, wires=wires)
    lib.RY(0.4, wires=1)


def _wrap_circuit(lib, theta, n):
    for q in range(n):
        lib.RY(0.3 + 0.01 * q, wires=q)
    lib.CRX(theta, wires=[n - 1, 0])


def _port_value_and_grad(build, x, n, obs_wires, obs="Z"):
    x = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    with recording() as tape:
        build(x)
    ob_cls = op.PauliZ if obs == "Z" else op.PauliX
    obs_ops = [ob_cls(wires=q, record=False) for q in obs_wires]
    v = tsim.simulate_and_measure(tape, n, "expval", obs_ops, False,
                                  dtype=torch.float64).sum()
    (g,) = torch.autograd.grad(v, x)
    return float(v), g.numpy()


def _jax_value_and_grad(build, x, n, obs_wires, obs="Z"):
    def f(x):
        with jrecording() as tape:
            build(x)
        ob_cls = jop.PauliZ if obs == "Z" else jop.PauliX
        obs_ops = [ob_cls(wires=q, record=False) for q in obs_wires]
        return jnp.sum(jsim.simulate_and_measure(tape, n, "expval", obs_ops, False))

    jsim.set_backward_mode("adjoint")
    try:
        v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(x, dtype=jnp.float32))
    finally:
        jsim.set_backward_mode("auto")
    return float(v), np.asarray(g, dtype=np.float64)


def _compare_small(monkeypatch, port_build, jax_build, x, n, obs_wires, obs="Z"):
    calls = []
    orig = adjoint.execute_plan_ri
    monkeypatch.setattr(adjoint, "execute_plan_ri", lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(tsim, "BACKWARD_MODE", "adjoint")
    v1, g1 = _port_value_and_grad(port_build, x, n, obs_wires, obs)
    assert calls == [1]
    monkeypatch.setattr(tsim, "BACKWARD_MODE", "autodiff")
    v0, g0 = _port_value_and_grad(port_build, x, n, obs_wires, obs)
    assert len(calls) == 1
    vj, gj = _jax_value_and_grad(jax_build, x, n, obs_wires, obs)
    assert abs(v1 - v0) <= SMALL_TOL and abs(v1 - vj) <= SMALL_TOL
    assert np.abs(g1 - g0).max() <= SMALL_TOL
    assert np.abs(g1 - gj).max() <= SMALL_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n", [2, 4, 6])
def test_small_ring_plans_match_autodiff_and_jax(monkeypatch, n):
    """A ring-wrap CX chain: below the large-state regime the wrap gate is a
    scattered support, undone with plain ops."""
    x = np.linspace(0.1, 1.3, n)
    _compare_small(monkeypatch, lambda t: _ring_circuit(op, t, n),
                   lambda t: _ring_circuit(jop, t, n), x, n, range(n))


@pytest.mark.unittest
@pytest.mark.parametrize("wires", [[0, 2], [1, 2]], ids=["scattered", "contiguous"])
def test_diagonal_gate_matches_autodiff_and_jax(monkeypatch, wires):
    n = 3

    def build(lib, cplx, x):
        phases = x * lib_arange(cplx, 4)
        _diag_circuit(lib, n, cplx_exp(cplx, phases), wires)

    def lib_arange(cplx, k):
        return torch.arange(k, dtype=torch.float64) if cplx == "torch" else jnp.arange(
            k, dtype=jnp.float32)

    def cplx_exp(cplx, phases):
        if cplx == "torch":
            return torch.exp(1j * phases.to(torch.complex128))
        return jnp.exp(1j * phases.astype(jnp.complex64))

    _compare_small(monkeypatch, lambda x: build(op, "torch", x), lambda x: build(jop, "jax", x),
                   0.53, n, [0], obs="X")


@pytest.mark.unittest
def test_ring_wrap_gate_takes_the_paired_rotation(monkeypatch):
    """At 14 qubits a {13, 0} support is one run on the qubit circle: the
    backward rotates both arrays to make it contiguous and back."""
    n = 14
    pairs = []
    orig = cuda_kernels.rotate_pair
    monkeypatch.setattr(cuda_kernels, "rotate_pair",
                        lambda *a: pairs.append(a[2]) or orig(*a))
    _compare_small(monkeypatch, lambda t: _wrap_circuit(op, t, n),
                   lambda t: _wrap_circuit(jop, t, n), 0.63, n, [0])
    assert len(pairs) == 2 and (pairs[0] + pairs[1]) % n == 0


@pytest.mark.unittest
@pytest.mark.parametrize("lam", ["f32", "bf16"])
def test_scattered_windows_in_the_large_regime_match_jax(monkeypatch, lam):
    """Two scattered windows between kernel steps, with the bfloat16
    cotangent in force: lambda enters the scattered steps in bfloat16 and
    leaves them in float32, and the gradients match the JAX package's
    adjoint (float32 throughout on the CPU) within 1e-5 (f32 lambda) or 2^-8
    (one bfloat16 rounding of lambda) of the largest magnitude."""
    from qml_essentials_tpu.ops import adjoint as jadjoint

    n = 6
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", n)
    monkeypatch.setattr(saved, "LAMBDA_MODE", lam)
    static = (("mat", (0, 1)), ("mat", (1, 3)), ("mat", (2, 4)), ("mat", (3, 4)))
    assert all(kernels._cyclic_run(list(s[1]), n) is None for s in static[1:3])
    rng = np.random.default_rng(21)
    pays = [_unitary_pair(rng, 2).astype(np.float32) for _ in static]
    psi = rng.normal(size=(2, 2**n)).astype(np.float32)
    psi /= np.linalg.norm(psi)
    tgt = rng.normal(size=(2, 2**n)).astype(np.float32)
    steps = []
    orig = cuda_kernels.adjoint_step
    monkeypatch.setattr(cuda_kernels, "adjoint_step",
                        lambda w2, p, l, *rest: steps.append((l.dtype, rest[-1]))
                        or orig(w2, p, l, *rest))

    ps = torch.from_numpy(psi).requires_grad_()
    ws = [torch.from_numpy(w).requires_grad_() for w in pays]
    out = adjoint.execute_plan_ri(ps, ws, static, n)
    got = torch.autograd.grad((out * torch.from_numpy(tgt)).sum(), [ps, *ws])
    lam_out = torch.bfloat16 if lam == "bf16" else torch.float32
    assert steps == [(torch.float32, lam_out), (torch.float32, torch.float32)]

    ref = jax.grad(lambda p, w: jnp.sum(jadjoint.execute_plan_ri(p, tuple(w), static, n) * tgt),
                   argnums=(0, 1))(jnp.asarray(psi), [jnp.asarray(w) for w in pays])
    tol = BF16_IN_TOL if lam == "bf16" else F32_TOL
    for g, r in zip(got, [ref[0], *ref[1]]):
        r = np.asarray(r, dtype=np.float64)
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max()


@pytest.mark.unittest
@pytest.mark.parametrize("piece_bytes", [64, 256])
def test_scattered_cotangents_in_pieces_match_the_whole(monkeypatch, piece_bytes):
    """Scattered and contiguous windows' and diagonals' cotangents read
    both arrays a piece at a time (``COTANGENT_PIECE_BYTES``): the same
    gradients as in one piece, to rounding."""
    n = 7
    static = (("mat", (0, 2, 5)), ("diag", (1, 6)), ("mat", (3, 4)), ("diag", (4, 5)))
    rng = np.random.default_rng(8)

    def phases(k):
        return np.stack([np.cos(rng.uniform(0, 6, 2**k)), np.sin(rng.uniform(0, 6, 2**k))])

    pays = [_unitary_pair(rng, 3), phases(2), _unitary_pair(rng, 2), phases(2)]
    psi = rng.normal(size=(2, 2**n))
    tgt = torch.from_numpy(rng.normal(size=(2, 2**n)))

    def grads():
        ps = torch.from_numpy(psi).requires_grad_()
        ws = [torch.from_numpy(w).requires_grad_() for w in pays]
        out = adjoint.execute_plan_ri(ps, ws, static, n)
        return torch.autograd.grad((out * tgt).sum(), [ps, *ws])

    whole = grads()
    monkeypatch.setattr(adjoint, "COTANGENT_PIECE_BYTES", piece_bytes)
    for g, w in zip(grads(), whole):
        assert np.abs(g.numpy() - w.numpy()).max() <= 1e-12 * np.abs(w.numpy()).max()


# ---------------------------------------------------------------------------
# The backward rule, and one decision per batch
# ---------------------------------------------------------------------------


def _plan_bytes(params, monkeypatch):
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    m = _port_model(params)
    with recording() as tape:
        m._variational(m.params[0], torch.tensor([X0]))
    plan, _ = tsim.scheduled_plan(tape, N)
    return m, plan, len(plan) * 8 * 2**N


def _spy_executors(monkeypatch):
    calls = []
    for name, module in (("saved", saved), ("adjoint", adjoint)):
        fn = "execute_plan_saved_ri" if name == "saved" else "execute_plan_ri"
        orig = getattr(module, fn)
        monkeypatch.setattr(module, fn,
                            lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    return calls


@pytest.mark.unittest
def test_rule_picks_the_executor_and_forced_modes_win(results, monkeypatch):
    m, plan, per = _plan_bytes(results["params"], monkeypatch)
    monkeypatch.setattr(tsim, "BACKWARD_MODE", "auto")
    calls = _spy_executors(monkeypatch)
    for free, want in ((4 * per / tsim._RESIDUAL_MEM_FRACTION, "saved"),
                       (0.5 * per / tsim._RESIDUAL_MEM_FRACTION, "adjoint")):
        monkeypatch.setattr(memory, "available_memory_bytes", lambda device=None, f=free: f)
        m(inputs=X0).mean().backward()
        assert calls[-1] == want
        for mode, forced in (("adjoint", "adjoint"), ("autodiff", "saved")):
            monkeypatch.setattr(tsim, "BACKWARD_MODE", mode)
            m(inputs=X0).mean().backward()
            assert calls[-1] == forced
        monkeypatch.setattr(tsim, "BACKWARD_MODE", "auto")
    assert len(calls) == 6


@pytest.mark.unittest
def test_one_backward_decision_per_batch(results, monkeypatch):
    """Free memory shrinks on every read, so re-reading it per element would
    switch executors part-way through the batch; the batch reads it once."""
    m, plan, per = _plan_bytes(results["params"], monkeypatch)
    monkeypatch.setattr(tsim, "BACKWARD_MODE", "auto")
    fits = 1.2 * len(BATCH) * per / tsim._RESIDUAL_MEM_FRACTION
    reads = []

    def shrinking(device=None):
        reads.append(1)
        return fits - (len(reads) - 1) * per / tsim._RESIDUAL_MEM_FRACTION

    monkeypatch.setattr(memory, "available_memory_bytes", shrinking)
    calls = _spy_executors(monkeypatch)
    m(inputs=list(BATCH)).sum().backward()
    assert len(reads) == 1
    assert calls == ["saved"] * len(BATCH)
    g_batch = m.params.grad.double().numpy()

    monkeypatch.setattr(tsim, "BACKWARD_MODE", "autodiff")
    g_sum = sum(_port_grad(results["params"], inputs=x)[1] * N for x in BATCH)
    assert np.abs(g_batch - g_sum).max() <= 1e-6 * max(1.0, np.abs(g_sum).max())


@pytest.mark.unittest
def test_adjoint_switch_and_choice(monkeypatch):
    """With the switch off, a gradient that a forced mode or the rule sends
    to the adjoint raises (no executor runs in its place); forced autodiff
    still runs."""
    n = 2
    x = np.linspace(0.1, 1.3, n)
    calls = _spy_executors(monkeypatch)
    assert adjoint.ENABLED
    adjoint.set_adjoint(False)
    try:
        assert not adjoint.ENABLED
        monkeypatch.setattr(tsim, "BACKWARD_MODE", "adjoint")
        with pytest.raises(RuntimeError, match="adjoint backward"):
            _port_value_and_grad(lambda t: _ring_circuit(op, t, n), x, n, range(n))
        monkeypatch.setattr(tsim, "BACKWARD_MODE", "auto")
        monkeypatch.setattr(memory, "available_memory_bytes", lambda device=None: 0)
        with pytest.raises(RuntimeError, match="adjoint backward"):
            _port_value_and_grad(lambda t: _ring_circuit(op, t, n), x, n, range(n))
        monkeypatch.setattr(tsim, "BACKWARD_MODE", "autodiff")
        _, g = _port_value_and_grad(lambda t: _ring_circuit(op, t, n), x, n, range(n))
        assert np.all(np.isfinite(g))
        assert calls == []
    finally:
        adjoint.set_adjoint(True)
    choice = tsim.BackwardChoice()
    tsim.set_backward_mode("adjoint")
    try:
        assert choice.use_adjoint([], 2, 1, None)
        tsim.set_backward_mode("autodiff")
        assert choice.use_adjoint([], 2, 1, None)  # decided once, kept
        assert not tsim.BackwardChoice().use_adjoint([], 2, 1, None)
    finally:
        tsim.set_backward_mode("auto")
