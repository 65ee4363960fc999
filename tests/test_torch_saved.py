"""The gradient slice of the PyTorch port: the window backward kernels' plain
versions and the saved-residual executor (``ops/saved.py``), against the
JAX package.

Kernel level.  ``window_apply_bwd_plain`` / ``window_apply_top_bwd_plain``
against the JAX package's own launchers (``pallas_kernels._apply_bwd`` /
``_apply_top_bwd``, interpret mode, ``GRAM_MODE = "split3"`` and
``PRECISION_MODE = "highest"`` set with monkeypatch, so its products are
plain float32 rather than the TPU's bf16 splits, whose ~1.6e-5 relative
error through the Karatsuba form would exceed the bound below), on random
states, unitaries and cotangents from ``numpy.random.default_rng``:

* float32 out: ``gp`` and ``gw`` within 1e-5 of the largest magnitude
  (float32 sums in other orders, Karatsuba against the 4-multiply form);
* bfloat16 out, compared after upcast: within one bf16 ulp (2^-8 of the
  value's binade) plus that 1e-5 floor — the two sides round values that
  differ by float32 rounding, so they may land one ulp apart;
* a bfloat16 cotangent: within 2^-8 of the largest magnitude, because the
  reference's Karatsuba form adds ``gr + gi`` in bfloat16 before it
  multiplies (one bf16 rounding), where the port upcasts first;
* each plain backward equals ``torch.autograd`` over the matching plain
  forward in float64 to 1e-12 (same products, other order of sums).

Executor level.  A 16-qubit, 2-layer Circuit_19 with the port's
``LARGE_STATE_MIN_N`` lowered to 16, so the saved executor runs the
scheduled plan (outer-product start, rotations, windows, a top window):

* λ in "f32": the gradient of the mean <Z> matches the JAX package's
  ``jax.grad`` (its einsum path, weights carried by ``load_numpy``) within
  1e-4 of max|g| (float32 on both sides, sums in other orders over ~20
  steps), and the port's own per-kernel loop to 1e-6 (the same products);
* λ in "bf16": max|g - g_f64| <= 5e-4, the budget the JAX package accepts
  for a bfloat16 cotangent (docs/performance.md);
* dtype discipline, the gradient of the peeled outer-product-start windows,
  the choice of backward, and a batch against the sum of single gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import executor as jax_executor
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu_torch.core import memory
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import adjoint, kernels, saved
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_G_TOL = 2.0**-8
AUTOGRAD_TOL = 1e-12


def _unitary_pair(rng, k):
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return np.stack([q.real, q.imag])


def _inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    w2 = _unitary_pair(rng, k).astype(np.float32)
    g = rng.normal(size=(2, 2**n)).astype(np.float32)
    x = rng.normal(size=(2, 2**n)).astype(np.float32)
    return w2, g / np.linalg.norm(g), x / np.linalg.norm(x)


def _bf16_ulp(ref):
    """One bfloat16 ulp of each element: 2^-8 of the top of its binade."""
    _, e = np.frexp(np.asarray(ref, dtype=np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_out_close(got, ref, out_dtype):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), dtype=np.float64)
    floor = F32_TOL * np.abs(ref).max()
    if out_dtype == torch.bfloat16:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref) + floor)
    else:
        assert np.abs(got - ref).max() <= floor


@pytest.fixture
def split3_gram(monkeypatch):
    monkeypatch.setattr(pallas_kernels, "GRAM_MODE", "split3")
    monkeypatch.setattr(pallas_kernels, "PRECISION_MODE", "highest")


@pytest.mark.unittest
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,a,k", [(10, 0, 3), (11, 2, 4), (12, 2, 3), (12, 0, 4)])
def test_window_bwd_plain_matches_pallas(split3_gram, n, a, k, out):
    w2, g, x = _inputs(n, k, seed=n + a + k)
    out_t = getattr(torch, out)
    gp_ref, gw_ref = pallas_kernels._apply_bwd(
        jnp.asarray(w2), jnp.asarray(g), jnp.asarray(x), a, k, n, True, getattr(jnp, out)
    )
    gp, gw = kernels.window_apply_bwd_plain(
        torch.from_numpy(w2), torch.from_numpy(g), torch.from_numpy(x), a, k, n, out_t
    )
    assert gp.dtype == out_t and gw.dtype == torch.float32
    _assert_out_close(gp, gp_ref, out_t)
    _assert_out_close(gw, gw_ref, torch.float32)


@pytest.mark.unittest
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(10, 3), (12, 4)])
def test_window_top_bwd_plain_matches_pallas(split3_gram, n, k, out):
    w2, g, x = _inputs(n, k, seed=3 * n + k)
    out_t = getattr(torch, out)
    gp_ref, gw_ref = pallas_kernels._apply_top_bwd(
        jnp.asarray(w2), jnp.asarray(g), jnp.asarray(x), k, n, True, getattr(jnp, out)
    )
    gp, gw = kernels.window_apply_top_bwd_plain(
        torch.from_numpy(w2), torch.from_numpy(g), torch.from_numpy(x), k, n, out_t
    )
    assert gp.dtype == out_t and gw.dtype == torch.float32
    _assert_out_close(gp, gp_ref, out_t)
    _assert_out_close(gw, gw_ref, torch.float32)


@pytest.mark.unittest
@pytest.mark.parametrize("top", [False, True], ids=["window", "top"])
def test_bf16_cotangent_matches_pallas(split3_gram, top):
    n, a, k = 11, 2, 4
    if top:
        a = n - k
    w2, g, x = _inputs(n, k, seed=5)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    g16_j = jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16)
    args = (torch.from_numpy(w2), g16, torch.from_numpy(x))
    if top:
        ref = pallas_kernels._apply_top_bwd(jnp.asarray(w2), g16_j, jnp.asarray(x), k, n, True,
                                            jnp.float32)
        got = kernels.window_apply_top_bwd_plain(*args, k, n, torch.float32)
    else:
        ref = pallas_kernels._apply_bwd(jnp.asarray(w2), g16_j, jnp.asarray(x), a, k, n, True,
                                        jnp.float32)
        got = kernels.window_apply_bwd_plain(*args, a, k, n, torch.float32)
    for t, r in zip(got, ref):
        r = np.asarray(r, dtype=np.float64)
        assert np.abs(t.numpy() - r).max() <= BF16_G_TOL * np.abs(r).max()
    # The plain version upcasts a bf16 cotangent before any arithmetic.
    up = (args[0], g16.float(), args[2])
    if top:
        again = kernels.window_apply_top_bwd_plain(*up, k, n, torch.float32)
    else:
        again = kernels.window_apply_bwd_plain(*up, a, k, n, torch.float32)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.unittest
@pytest.mark.parametrize(
    "n,a,k", [(8, 1, 3), (8, 0, 2), (8, 6, 1), (7, 0, 1), (8, 5, 3), (6, 3, 3)],
    ids=["mid", "a0-K4", "B2-K2", "K2", "top", "top-a3"],
)
def test_plain_bwd_is_autograd_of_plain_fwd(n, a, k):
    """float64: each plain backward equals torch.autograd over its forward
    (K = 2 and K = 4 windows, B = 2, a = 0, and top windows included)."""
    rng = np.random.default_rng(n * 10 + a + k)
    top = a + k == n
    w2 = torch.from_numpy(_unitary_pair(rng, k)).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(2, 2**n))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 2**n)))
    if top:
        y = kernels.window_apply_top_plain(x, w2, k, n)
        gp, gw = kernels.window_apply_top_bwd_plain(w2, g, x, k, n, torch.float64)
    else:
        y = kernels.window_apply_plain(x, w2, a, k, n)
        gp, gw = kernels.window_apply_bwd_plain(w2, g, x, a, k, n, torch.float64)
    ref_x, ref_w = torch.autograd.grad(y, (x, w2), g)
    assert (gp - ref_x).abs().max() <= AUTOGRAD_TOL
    assert (gw - ref_w).abs().max() <= AUTOGRAD_TOL


# ---------------------------------------------------------------------------
# Executor level: 16-qubit Circuit_19 through the saved executor
# ---------------------------------------------------------------------------

N = 16
X0 = 0.37
BATCH = (0.37, -0.81, 1.42)
LOOP_TOL = 1e-6
JAX_TOL = 1e-4
BF16_BUDGET = 5e-4


def _port_model(params, dtype=torch.float32):
    m = Model(n_qubits=N, n_layers=2, circuit_type="Circuit_19", dtype=dtype)
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
    jm = JaxModel(n_qubits=N, n_layers=2, circuit_type="Circuit_19", random_seed=11)
    params = np.asarray(jm.params)
    out = {"params": params}
    hits = []
    orig_step_bwd = saved._step_bwd

    def spy(step, w2, lam, x, n, out_dt):
        hits.append((step[0], lam.dtype, out_dt))
        return orig_step_bwd(step, w2, lam, x, n, out_dt)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_executor, "JIT_SINGLE", False)  # eager: no 16q compile
        v, g = jax.value_and_grad(lambda p: jm(p, inputs=X0).mean())(jm.params)
        out["jax"] = (float(v), np.asarray(g, dtype=np.float64))

        mp.setattr(tsim, "LARGE_STATE_MIN_N", N)
        mp.setattr(tsim, "BACKWARD_MODE", "auto")
        mp.setattr(saved, "ENABLED", False)
        out["f64"] = _port_grad(params, torch.float64)
        out["loop"] = _port_grad(params)
        mp.setattr(saved, "ENABLED", True)
        mp.setattr(saved, "LAMBDA_MODE", "f32")
        out["saved_f32"] = _port_grad(params)
        mp.setattr(saved, "LAMBDA_MODE", "bf16")
        mp.setattr(saved, "_step_bwd", spy)
        out["saved_bf16"] = _port_grad(params)
        out["hits"] = list(hits)
    return out


@pytest.mark.unittest
def test_saved_f32_matches_jax_and_the_per_kernel_loop(results):
    v_jax, g_jax = results["jax"]
    v, g = results["saved_f32"]
    assert g.shape == g_jax.shape
    assert abs(v - v_jax) <= JAX_TOL
    assert np.abs(g - g_jax).max() <= JAX_TOL * np.abs(g_jax).max()
    _, g_loop = results["loop"]
    assert np.abs(g - g_loop).max() <= LOOP_TOL


@pytest.mark.unittest
def test_bf16_lambda_within_budget(results):
    _, g64 = results["f64"]
    v, g = results["saved_bf16"]
    assert abs(v - results["f64"][0]) <= JAX_TOL  # the forward is unchanged
    assert np.abs(g - g64).max() <= BF16_BUDGET


@pytest.mark.unittest
def test_bf16_lambda_dtype_discipline(results):
    """λ enters float32, travels bfloat16 between steps, and the earliest
    payload step writes the float32 boundary cotangent."""
    hits = results["hits"]
    assert len(hits) >= 3
    assert hits[0][1] == torch.float32 and hits[0][2] == torch.bfloat16
    assert all(h[1] == torch.bfloat16 for h in hits[1:])
    assert all(h[2] == torch.bfloat16 for h in hits[:-1])
    assert hits[-1][2] == torch.float32


@pytest.mark.unittest
def test_gradient_reaches_the_peeled_start_windows(results, monkeypatch):
    """The leading disjoint windows become the outer-product start and never
    run as steps: their parameters get their gradient only through the
    executor's boundary cotangent."""
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    m = _port_model(results["params"])
    with recording() as tape:
        m._variational(m.params[0], torch.tensor([X0]))
    plan = tsim.plan_contractions(tape, n_qubits=N)
    peeled, psi2 = tsim._zero_state_prefix(plan, N)
    assert len(peeled) >= 2
    (dpsi,) = torch.autograd.grad(psi2[0].sum(), m.params)
    start_only = dpsi.abs() > 0
    assert start_only.any()
    _, g64 = results["f64"]
    _, g = results["saved_bf16"]
    mask = start_only.numpy()
    assert np.abs(g64[mask]).max() > 1e-3
    assert np.abs(g[mask] - g64[mask]).max() <= BF16_BUDGET


@pytest.mark.unittest
def test_adjoint_mode_raises_with_a_gradient_only(results, monkeypatch):
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    m = _port_model(results["params"])
    tsim.set_backward_mode("adjoint")
    try:
        with torch.no_grad():
            assert torch.isfinite(m(inputs=X0)).all()
        with pytest.raises(NotImplementedError, match="adjoint"):
            m(inputs=X0)
    finally:
        tsim.set_backward_mode("auto")
    with pytest.raises(ValueError):
        tsim.set_backward_mode("residual")


@pytest.mark.unittest
def test_auto_takes_the_saved_executor_while_residuals_fit(results, monkeypatch):
    """The estimate is len(plan) * 8 * 2**n bytes per batch element against
    0.35 of free memory: with room for two elements' residuals a single
    request runs the saved executor and a batch of three is sent to the
    adjoint backward (which raises until it is ported)."""
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    m = _port_model(results["params"])
    with recording() as tape:
        m._variational(m.params[0], torch.tensor([X0]))
    plan, _ = tsim.scheduled_plan(tape, N)
    per_element = len(plan) * 8 * 2**N
    free = 2.5 * per_element / tsim._RESIDUAL_MEM_FRACTION
    monkeypatch.setattr(memory, "available_memory_bytes", lambda device=None: free)
    assert not tsim._adjoint_pays_off(plan, N, batch=2)
    assert tsim._adjoint_pays_off(plan, N, batch=3)

    calls = []
    orig = saved.execute_plan_saved_ri
    monkeypatch.setattr(saved, "execute_plan_saved_ri",
                        lambda *a: calls.append(1) or orig(*a))
    m(inputs=X0).mean().backward()
    assert calls == [1]
    with pytest.raises(NotImplementedError, match="adjoint"):
        m(inputs=list(BATCH)).mean().backward()


@pytest.mark.unittest
def test_batch_gradient_is_the_sum_of_single_gradients(results, monkeypatch):
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    params = results["params"]
    m = _port_model(params)
    m(inputs=list(BATCH)).sum().backward()
    g_batch = m.params.grad.double().numpy()
    g_sum = sum(_port_grad(params, inputs=x)[1] * N for x in BATCH)  # mean -> sum over N
    assert np.abs(g_batch - g_sum).max() <= LOOP_TOL * max(1.0, np.abs(g_sum).max())


@pytest.mark.unittest
def test_training_after_serving_under_inference_mode(monkeypatch):
    """Gate constants copied to the model's device and dtype while serving
    under inference mode must still serve a later gradient (the cached
    copies used to be inference tensors, which autograd refuses)."""
    from qml_essentials_tpu_torch.ops import operations

    monkeypatch.setattr(operations, "_CONST_CACHE", {})
    m = Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", dtype=torch.float64)
    with torch.inference_mode():
        served = m(inputs=0.3)
    out = m(inputs=0.3)
    out.sum().backward()
    assert torch.equal(out.detach(), served)
    assert torch.isfinite(m.params.grad).all() and m.params.grad.abs().max() > 0


@pytest.mark.unittest
def test_normalize_plan_sorts_wires_and_pairs_payloads():
    mat = torch.arange(16, dtype=torch.float32).reshape(4, 4).to(torch.complex64) * (1 + 2j)
    diag = torch.tensor([1, 1j, -1, -1j], dtype=torch.complex64)
    static, payloads = adjoint.normalize_plan(
        [("rot", 7, []), ("mat", mat, [3, 1]), ("diag", diag, [2, 0])], 16
    )
    assert static == (("rot", 7), ("mat", (1, 3)), ("diag", (0, 2)))
    swapped = kernels.permute_gate_qubits(mat, [1, 0], 2)
    assert torch.equal(payloads[0], torch.stack([swapped.real, swapped.imag]))
    assert torch.equal(payloads[1][0], diag.reshape(2, 2).T.reshape(-1).real)


@pytest.mark.unittest
def test_lambda_mode_and_executor_switches():
    with pytest.raises(ValueError):
        saved.set_lambda_mode("f16")
    saved.set_lambda_mode("f32")
    assert saved.LAMBDA_MODE == "f32"
    saved.set_lambda_mode("bf16")
    saved.set_saved_executor(False)
    assert not saved.ENABLED
    saved.set_saved_executor(True)
    assert saved.usable(tsim.LARGE_STATE_MIN_N) and not saved.usable(12)
    assert memory.available_memory_bytes() > 0
