"""The port's executor (``qml_essentials_tpu_torch.core.executor.Script``):
batches recorded once and run with a leading batch axis, the plan cache, the
route log and memory-aware chunks, held against the JAX package's executor
on the CPU with inputs made from a numpy seed.

Tolerances: Script requests against the JAX package in float32 (its
default) 1e-6; models at float64 against the JAX package under x64 1e-10
(``jax_x64``: x64 on, the operation classes' constant matrices promoted);
the vectorised route against the port's own per-element loop 1e-12 at
float64; shot estimates by distribution (5 standard errors).
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qml_essentials_tpu.ops.operations as jo
from qml_essentials_tpu.core.executor import Script as JaxScript
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.core import executor, memory
from qml_essentials_tpu_torch.core.executor import Script
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import kernels, recipes
from qml_essentials_tpu_torch.ops import simulation as tsim

torch.set_num_threads(2)

TOL32 = 1e-6
TOL64 = 1e-10
LOOP_TOL = 1e-12


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
        jo.H._matrix = jnp.asarray(np.array([[1, 1], [1, -1]]) / np.sqrt(2.0), jnp.complex128)
        yield
    finally:
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


@contextmanager
def loop_route():
    """Every batched request through the per-element loop."""
    saved = Script._execute_vectorised

    def refuse(*a, **kw):
        raise executor._NotVectorisable("forced by the test")

    Script._execute_vectorised = refuse
    try:
        yield
    finally:
        Script._execute_vectorised = saved


def _np(x):
    return x.detach().resolve_conj().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rx_chain_t(theta):
    to.RX(theta, wires=0)
    to.CX(wires=[0, 1])


def rx_chain_j(theta):
    jo.RX(theta, wires=0)
    jo.CX(wires=[0, 1])


def _scripts(tc=rx_chain_t, jc=rx_chain_j, n=2, **kw):
    return (Script(tc, n_qubits=n, device="cpu", **kw), JaxScript(jc, n_qubits=n))


# ---------------------------------------------------------------------------
# tests/test_script.py's cases on the port, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_single_requests_match_jax():
    ts, js = _scripts()
    tz, jz = to.PauliZ(wires=0, record=False), jo.PauliZ(wires=0, record=False)
    for theta in (0.5, np.pi):
        got = ts.execute(type="expval", obs=[tz], args=(theta,))
        assert np.abs(_np(got) - np.asarray(js.execute(type="expval", obs=[jz], args=(theta,)))).max() <= TOL32
        for kind in ("state", "probs", "density"):
            got = _np(ts.execute(type=kind, args=(theta,)))
            ref = np.asarray(js.execute(type=kind, args=(theta,)))
            assert got.shape == ref.shape and np.abs(got - ref).max() <= TOL32
    inferred = Script(rx_chain_t, device="cpu")  # no n_qubits declared
    out = inferred.execute(type="expval", obs=[to.PauliZ(wires=1, record=False)], args=(0.3,))
    assert np.isclose(float(out[0]), np.cos(0.3), atol=TOL32)
    assert ts.routes == [] and inferred.routes == []  # single requests log no route


@pytest.mark.unittest
def test_batches_match_jax_and_take_the_vectorised_route():
    ts, js = _scripts()
    thetas = np.random.default_rng(0).uniform(0, np.pi, 8).astype(np.float32)
    tz, jz = to.PauliZ(wires=0, record=False), jo.PauliZ(wires=0, record=False)
    got = ts.execute(type="expval", obs=[tz], args=(torch.from_numpy(thetas),), in_axes=(0,))
    ref = js.execute(type="expval", obs=[jz], args=(jnp.asarray(thetas),), in_axes=(0,))
    assert got.shape == (8, 1) and np.abs(_np(got) - np.asarray(ref)).max() <= TOL32
    assert np.allclose(_np(got)[:, 0], np.cos(thetas), atol=1e-5)
    assert ts.routes == ["vectorised"]
    for kind in ("probs", "state", "density"):
        g = _np(ts.execute(type=kind, args=(torch.from_numpy(thetas),), in_axes=(0,)))
        r = np.asarray(js.execute(type=kind, args=(jnp.asarray(thetas),), in_axes=(0,)))
        assert g.shape == r.shape and np.abs(g - r).max() <= TOL32


@pytest.mark.unittest
def test_second_call_reuses_the_plan(monkeypatch):
    """Same structure, new values: no new cache entry and no structural
    planning (the planner functions are counted)."""
    calls = []
    for name in ("plan_contractions", "schedule_layout", "_zero_state_prefix"):
        real = getattr(tsim, name)
        monkeypatch.setattr(tsim, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or
                            _r(*a, **k))
    s = Script(rx_chain_t, n_qubits=2, device="cpu")
    obs = [to.PauliZ(wires=0, record=False)]
    thetas = torch.linspace(0, 1, 4)
    a = s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    entries, planned = len(s._plans), len(calls)
    b = s.execute(type="expval", obs=obs, args=(thetas + 1.0,), in_axes=(0,))
    assert len(s._plans) == entries == 1 and len(calls) == planned == 1
    assert torch.allclose(b[:, 0], torch.cos(thetas + 1.0), atol=1e-6)
    assert not torch.allclose(a, b)
    s.execute(type="expval", obs=obs, args=(torch.tensor(0.2),))  # a single request: same plan
    assert len(s._plans) == 1 and len(calls) == planned


@pytest.mark.unittest
def test_mixed_static_args_and_in_axes_mismatch():
    def circ(theta, label):
        to.RX(theta, wires=0)
        assert isinstance(label, str)

    s = Script(circ, n_qubits=1, device="cpu")
    thetas = torch.tensor([0.1, 0.2])
    out = s.execute(type="expval", obs=[to.PauliZ(wires=0, record=False)],
                    args=(thetas, "hello"), in_axes=(0, None))
    assert np.allclose(_np(out)[:, 0], np.cos(_np(thetas)), atol=1e-6)
    with pytest.raises(ValueError):
        Script(rx_chain_t, n_qubits=2, device="cpu").execute(
            type="probs", args=(torch.zeros(3),), in_axes=(0, 0))


@pytest.mark.unittest
def test_batched_shots_by_distribution():
    ts, js = _scripts()
    thetas = np.array([0.0, np.pi, 1.1])
    shots = 4000
    got = _np(ts.execute(type="probs", args=(torch.from_numpy(thetas).float(),), in_axes=(0,),
                         shots=shots, generator=torch.Generator().manual_seed(0)))
    exact = np.asarray(js.execute(type="probs", args=(jnp.asarray(thetas),), in_axes=(0,)))
    assert got.shape == (3, 4) and ts.routes == ["vectorised"]
    sigma = np.sqrt(exact * (1 - exact) / shots) + 1e-3
    assert (np.abs(got - exact) <= 5 * sigma).all()
    with loop_route():
        again = ts.execute(type="probs", args=(torch.from_numpy(thetas).float(),), in_axes=(0,),
                           shots=shots, generator=torch.Generator().manual_seed(0))
    assert np.array_equal(_np(again), got)  # each element on its own generator, either route


@pytest.mark.unittest
def test_gradients_through_single_and_batched_execute():
    s = Script(rx_chain_t, n_qubits=2, device="cpu", dtype=torch.float64)
    obs = [to.PauliZ(wires=0, record=False)]
    theta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    s.execute(type="expval", obs=obs, args=(theta,))[0].backward()
    assert np.isclose(float(theta.grad), -np.sin(0.7), atol=1e-12)
    thetas = torch.tensor([0.2, 0.9], dtype=torch.float64, requires_grad=True)
    s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,)).sum().backward()
    assert np.allclose(_np(thetas.grad), -np.sin([0.2, 0.9]), atol=1e-12)
    t3 = torch.tensor([0.2, 0.5, 1.3], dtype=torch.float64)
    J = torch.autograd.functional.jacobian(
        lambda t: s.execute(type="expval", obs=obs, args=(t,), in_axes=(0,))[:, 0], t3)
    assert np.allclose(np.diag(_np(J)), -np.sin(_np(t3)), atol=1e-12)
    assert np.allclose(_np(J) - np.diag(np.diag(_np(J))), 0.0, atol=1e-14)


@pytest.mark.unittest
def test_chunked_equals_full(monkeypatch):
    s = Script(rx_chain_t, n_qubits=2, device="cpu", dtype=torch.float64)
    thetas = torch.linspace(0, 2, 10, dtype=torch.float64)
    obs = [to.PauliZ(wires=0, record=False)]
    full = s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    monkeypatch.setattr(memory, "compute_chunk_size", lambda *a, **k: 3)
    s._chunks.clear()
    chunked = s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    assert torch.allclose(chunked, full, atol=1e-15)


def _ry_cx_t(theta):
    to.RY(theta, wires=0)
    to.CX(wires=[0, 1])


@pytest.mark.unittest
def test_observables_key_the_plan():
    """A changed observable list or matrix makes a new entry and a new
    answer; the single path keys on observables too."""
    s = Script(_ry_cx_t, n_qubits=2, device="cpu", dtype=torch.float64)
    thetas = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    two = s.execute(type="expval", obs=[to.PauliZ(wires=0, record=False),
                                        to.PauliZ(wires=1, record=False)],
                    args=(thetas,), in_axes=(0,))
    one = s.execute(type="expval", obs=[to.PauliZ(wires=0, record=False)], args=(thetas,),
                    in_axes=(0,))
    assert two.shape == (4, 2) and one.shape == (4, 1) and len(s._plans) == 2
    h1 = to.Hermitian(np.diag([1.0, 0.0]).astype(complex), wires=[0], record=False)
    h2 = to.Hermitian(np.diag([0.0, 1.0]).astype(complex), wires=[0], record=False)
    p0 = _np(s.execute(type="expval", obs=[h1], args=(thetas + 0.2,), in_axes=(0,)))
    p1 = _np(s.execute(type="expval", obs=[h2], args=(thetas + 0.2,), in_axes=(0,)))
    assert np.allclose(p0 + p1, 1.0, atol=1e-12) and not np.allclose(p0, p1, atol=1e-3)
    assert len(s._plans) == 4
    a = _np(s.execute(type="expval", obs=[to.PauliZ(wires=0, record=False),
                                          to.PauliZ(wires=1, record=False)],
                      args=(torch.tensor(0.7, dtype=torch.float64),)))
    b = _np(s.execute(type="expval", obs=[to.PauliZ(wires=1, record=False)],
                      args=(torch.tensor(0.7, dtype=torch.float64),)))
    assert a.shape == (2,) and b.shape == (1,) and np.isclose(a[1], b[0], atol=1e-12)


@pytest.mark.unittest
def test_planner_flags_key_the_plan(monkeypatch):
    """A monkeypatched planner flag makes a new entry (the fusion width
    changes the plan, not the answer)."""
    m = Model(n_qubits=5, n_layers=1, circuit_type="Circuit_19", device="cpu",
              dtype=torch.float64, random_seed=2)
    x = torch.linspace(0.1, 1.0, 3, dtype=torch.float64)
    with torch.no_grad():
        a = m(inputs=x)
        monkeypatch.setattr(tsim, "FUSE_MAX_WIDTH", 1)
        b = m(inputs=x)
    assert len(m.script._plans) == 2 and torch.allclose(a, b, atol=1e-12)
    plans = [slot.skeletons["pure"][0] for slot in m.script._plans.values()]
    assert len(plans[0]) < len(plans[1])


# ---------------------------------------------------------------------------
# Models: inputs x params batches, against the JAX package and the loop
# ---------------------------------------------------------------------------


def _pair(n, circuit, seed=11, batch=3, layers=2, **kw):
    """A JAX model and a float64 CPU port model computing the same function:
    numpy-drawn parameters carried to both."""
    snapshot = PulseInformation.snapshot_state()
    try:
        jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type=circuit, **kw)
    finally:
        PulseInformation.restore_state(snapshot)
    tm = Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu",
               dtype=torch.float64, **kw)
    shape = (batch, *np.asarray(jm.params).shape[1:])
    params = np.random.default_rng(seed).uniform(0, 2 * np.pi, shape)
    jm.params = jnp.asarray(params)
    tm.load_numpy(params)
    return jm, tm, params


X = np.random.default_rng(5).uniform(-np.pi, np.pi, 4)


@pytest.mark.unittest
@pytest.mark.parametrize("n,circuit,kind", [
    (4, "Circuit_19", "expval"), (4, "Circuit_20", "expval"), (4, "Hardware_Efficient", "probs"),
    (3, "Strongly_Entangling", "state"), (4, "Circuit_9", "density"), (6, "Circuit_15", "expval"),
])
def test_model_batches_match_jax_and_the_loop(n, circuit, kind):
    jm, tm, params = _pair(n, circuit)
    with jax_x64():
        ref = np.asarray(jm(jnp.asarray(params), inputs=jnp.asarray(X), execution_type=kind))
    with torch.no_grad():
        got = tm(params=torch.from_numpy(params), inputs=torch.from_numpy(X), execution_type=kind)
        assert tm.script.routes[-1] == "vectorised"
        with loop_route():
            loop = tm(params=torch.from_numpy(params), inputs=torch.from_numpy(X),
                      execution_type=kind)
    assert got.shape == ref.shape == loop.shape
    assert np.abs(_np(got) - ref).max() <= TOL64
    assert np.abs(_np(got) - _np(loop)).max() <= LOOP_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("noise", [{"Depolarizing": 0.02}, {"BitFlip": 0.01, "AmplitudeDamping": 0.03}])
def test_noisy_batches_match_jax_and_the_loop(noise):
    jm, tm, params = _pair(4, "Circuit_19", batch=2)
    with jax_x64():
        ref = np.asarray(jm(jnp.asarray(params), inputs=jnp.asarray(X[:3]), noise_params=noise))
    with torch.no_grad():
        got = tm(params=torch.from_numpy(params), inputs=torch.from_numpy(X[:3]),
                 noise_params=noise)
        assert tm.script.routes[-1] == "vectorised"
        with loop_route():
            loop = tm(params=torch.from_numpy(params), inputs=torch.from_numpy(X[:3]),
                      noise_params=noise)
    assert np.abs(_np(got) - ref).max() <= TOL64
    assert np.abs(_np(got) - _np(loop)).max() <= LOOP_TOL


@pytest.mark.unittest
def test_gate_error_batches_draw_what_the_loop_draws():
    """GateError draws each element's noise on its own generator: the
    vectorised batch equals the loop, draw for draw, and the batch is not
    one sample broadcast."""
    tm = Model(n_qubits=4, n_layers=2, circuit_type="Circuit_19", device="cpu",
               dtype=torch.float64, random_seed=4)
    x = torch.full((5,), 0.4, dtype=torch.float64)
    outs = []
    for route in ("vectorised", "loop"):
        tm.random_key = torch.Generator().manual_seed(9)
        with torch.no_grad():
            if route == "loop":
                with loop_route():
                    outs.append(tm(inputs=x, noise_params={"GateError": 0.1}))
            else:
                outs.append(tm(inputs=x, noise_params={"GateError": 0.1}))
                assert tm.script.routes[-1] == "vectorised"
    assert torch.allclose(outs[0], outs[1], atol=LOOP_TOL)
    assert not torch.allclose(outs[0][0], outs[0][1])


@pytest.mark.unittest
def test_shot_batches_by_distribution():
    jm, tm, params = _pair(4, "Circuit_19", batch=1)
    tm.shots = 20000
    with jax_x64():
        exact = np.asarray(jm(jnp.asarray(params), inputs=jnp.asarray(X)))
    with torch.no_grad():
        got = _np(tm(inputs=torch.from_numpy(X)))
    assert tm.script.routes[-1] == "vectorised" and got.shape == exact.shape
    sigma = np.sqrt(np.clip(1 - exact**2, 1e-3, None) / tm.shots)
    assert (np.abs(got - exact) <= 5 * sigma).all()


@pytest.mark.unittest
def test_batched_gradient_matches_jax():
    jm, tm, params = _pair(3, "Circuit_19", batch=1, layers=1)
    with jax_x64():
        gj = np.asarray(jax.grad(lambda p: jnp.sum(jm(p, inputs=jnp.asarray(X)) ** 2))(
            jnp.asarray(params)))
    p = torch.from_numpy(params).requires_grad_()
    (tm(params=p, inputs=torch.from_numpy(X)) ** 2).sum().backward()
    assert tm.script.routes[-1] == "vectorised"
    assert np.abs(_np(p.grad) - gj).max() <= TOL64
    q = torch.from_numpy(params).requires_grad_()
    with loop_route():
        (tm(params=q, inputs=torch.from_numpy(X)) ** 2).sum().backward()
    assert np.abs(_np(p.grad) - _np(q.grad)).max() <= LOOP_TOL


@pytest.mark.unittest
def test_chunked_model_batch_and_gradient(monkeypatch):
    tm = Model(n_qubits=5, n_layers=2, circuit_type="Hardware_Efficient", device="cpu",
               dtype=torch.float64, random_seed=8)
    x = torch.linspace(-1, 1, 11, dtype=torch.float64)
    whole = tm(inputs=x)
    (g_whole,) = torch.autograd.grad(whole.sum(), tm.params)
    monkeypatch.setattr(memory, "compute_chunk_size", lambda *a, **k: 4)
    tm.script._chunks.clear()
    chunked = tm(inputs=x)
    (g_chunked,) = torch.autograd.grad(chunked.sum(), tm.params)
    assert torch.allclose(chunked, whole, atol=1e-14)
    assert torch.allclose(g_chunked, g_whole, atol=1e-13)


@pytest.mark.unittest
def test_large_regime_batch_runs_each_element_on_one_plan(monkeypatch):
    """From LARGE_STATE_MIN_N the batch is recorded and planned once and its
    elements run one by one on the plan's payload rows."""
    n = 16
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", n)
    tm = Model(n_qubits=n, n_layers=1, circuit_type="Circuit_19", device="cpu",
               dtype=torch.float64, random_seed=1)
    x = torch.tensor([0.3, -0.8, 1.7], dtype=torch.float64)
    rows, plans = [], []
    real_sim, real_plan = tsim._simulate, tsim.scheduled_plan
    monkeypatch.setattr(tsim, "_simulate", lambda *a: rows.append((a[2], a[3])) or real_sim(*a))
    monkeypatch.setattr(tsim, "scheduled_plan", lambda *a, **k: plans.append(1) or
                        real_plan(*a, **k))
    with torch.no_grad():
        got = tm(inputs=x)
    assert tm.script.routes[-1] == "per element: 16 wires, from LARGE_STATE_MIN_N = 16"
    assert rows == [(0, None), (1, None), (2, None)] and plans == [1]
    with torch.no_grad(), loop_route():
        loop = tm(inputs=x)
    assert torch.allclose(got, loop, atol=LOOP_TOL)


# case: data qubits, noise, the register width the per-element route starts
# at (None: the default, the adjoint backward's route), the forced chunk
# size, the backward mode
PER_ELEMENT_CASES = {
    "outer_start": (16, None, 16, None, "auto"),
    "chunked": (16, None, 16, 2, "auto"),
    "interleaved": (7, {"Depolarizing": 0.01}, 14, None, "auto"),
    "adjoint": (16, None, None, None, "adjoint"),
}


@pytest.mark.unittest
@pytest.mark.parametrize("case", list(PER_ELEMENT_CASES))
def test_per_element_batches_match_the_vectorised_route(case, monkeypatch):
    """A batch run element by element, its chunk's payloads composed once,
    gives the vectorised route's outputs and parameter gradients."""
    n, noise, wires, chunk, mode = PER_ELEMENT_CASES[case]
    x = torch.tensor([0.3, -0.8, 1.7], dtype=torch.float64)

    def run():
        tm = Model(n_qubits=n, n_layers=1, circuit_type="Circuit_19", device="cpu",
                   dtype=torch.float64, random_seed=3)
        out = tm(inputs=x, noise_params=noise)
        (grad,) = torch.autograd.grad((out**2).sum(), tm.params)
        return tm, out.detach(), grad

    ref_model, ref, g_ref = run()
    assert ref_model.script.routes[-1] == "vectorised"
    if wires is not None:
        monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", wires)
    if chunk is not None:
        monkeypatch.setattr(memory, "compute_chunk_size", lambda *a, **k: chunk)
    monkeypatch.setattr(tsim, "BACKWARD_MODE", tsim.BACKWARD_MODE)
    tsim.set_backward_mode(mode)
    # the saved executor's cotangent in the state's precision, not bfloat16
    monkeypatch.setattr(tsim.saved, "LAMBDA_MODE", "f32")
    runs = []
    for module, name in ((tsim.adjoint, "execute_plan_ri"), (tsim.saved, "execute_plan_saved_ri")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _f=real: runs.append(_n) or _f(*a))
    tm, got, grad = run()
    assert tm.script.routes[-1].startswith("per element")
    (slot,) = tm.script._plans.values()
    if case == "outer_start":  # the plan's leading windows peeled into its start
        assert isinstance(slot.skeletons["pure"][1], recipes.PerElement)
    executor = "execute_plan_ri" if mode == "adjoint" else "execute_plan_saved_ri"
    assert runs == [executor] * 3
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= TOL64
    assert (grad - g_ref).abs().max() <= TOL64


def _wide_channel_circuit(theta, w):
    """A channel on four wires, which the interleaved engine cannot lower."""
    eye = torch.eye(16, dtype=torch.complex128)
    x = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
    xxxx = torch.kron(torch.kron(x, x), torch.kron(x, x))
    for q in range(6):
        to.RX(theta * (q + 1), wires=q)
        to.RY(w[q], wires=q)
    to.CX(wires=[0, 1])
    to.CX(wires=[2, 3])
    to.QubitChannel([np.sqrt(0.95) * eye, np.sqrt(0.05) * xxxx], wires=[0, 1, 2, 3])
    to.CX(wires=[3, 4])
    to.RZ(theta, wires=5)


@pytest.mark.unittest
def test_per_element_ket_then_bra_batches_match_the_vectorised_route(monkeypatch):
    obs = [to.PauliZ(wires=q, record=False) for q in range(6)]
    theta = torch.tensor([0.3, -0.8, 1.7], dtype=torch.float64)

    def run():
        w = torch.linspace(0.1, 0.6, 6, dtype=torch.float64).requires_grad_()
        s = Script(_wide_channel_circuit, n_qubits=6, device="cpu", dtype=torch.float64)
        out = s.execute(type="expval", obs=obs, args=(theta, w), in_axes=(0, None))
        (grad,) = torch.autograd.grad((out**2).sum(), w)
        return s, out.detach(), grad

    s, ref, g_ref = run()
    assert s.routes[-1] == "vectorised"
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", 12)
    s, got, grad = run()
    assert s.routes[-1] == "per element: 12 wires, from LARGE_STATE_MIN_N = 12"
    (slot,) = s._plans.values()
    assert slot.skeletons["interleaved"] is None and "mixed" in slot.skeletons
    assert (got - ref).abs().max() <= TOL64
    assert (grad - g_ref).abs().max() <= TOL64


@pytest.mark.unittest
def test_a_chunks_payloads_are_composed_once(monkeypatch):
    """Every element's plan holds the same tensor for a payload no batched
    gate reaches, and a row of one composition for a batched one; the
    outer-product start is built for each element."""
    n = 16
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", n)
    tm = Model(n_qubits=n, n_layers=1, circuit_type="Circuit_19", device="cpu",
               dtype=torch.float64, random_seed=1)
    handed = []
    real = recipes.RowPlans.element
    monkeypatch.setattr(recipes.RowPlans, "element",
                        lambda self, row: handed.append(real(self, row)) or handed[-1])
    with torch.no_grad():
        tm(inputs=torch.tensor([0.3, -0.8, 1.7], dtype=torch.float64))
    assert len(handed) == 3
    shared = batched = 0
    for steps in zip(*(plan for plan, _ in handed)):
        payloads = [tsim._payload_tensors(kind, payload) for kind, payload, _ in steps]
        for ts in zip(*payloads):
            if all(t is ts[0] for t in ts):
                shared += 1
                continue
            base = ts[0]._base
            assert base is not None and all(t._base is base for t in ts)
            assert len({t.storage_offset() for t in ts}) == len(ts)
            batched += 1
    assert shared and batched
    starts = [psi2 for _, psi2 in handed]
    assert all(s.shape == (2, 2**n) for s in starts)
    assert len({s.data_ptr() for s in starts}) == len(starts)


@pytest.mark.unittest
@pytest.mark.parametrize("batched", ["state", "gate", "both"])
@pytest.mark.parametrize("wires", [[0], [3], [0, 1], [2, 5], [7, 0], [15, 0]])
def test_a_batched_composition_rounds_as_each_row_alone(wires, batched):
    """Composing a window's unitary for a batch gives each row, bit for bit,
    what composing that row alone gives, with both operands needing a
    gradient: so a batch run element by element on its chunk's payloads
    rounds as single requests do."""
    n = 16  # an 8-qubit window's flat unitary
    gen = torch.Generator().manual_seed(5)
    K = 2 ** len(wires)
    psi = torch.randn((3, 2**n) if batched != "gate" else (2**n,), dtype=torch.complex64,
                      generator=gen).requires_grad_()
    mat = torch.randn((3, K, K) if batched != "state" else (K, K), dtype=torch.complex64,
                      generator=gen).requires_grad_()
    out = kernels.apply_matrix_flat(psi, mat, wires, n)
    assert out.shape == (3, 2**n)
    for i in range(3):
        alone = kernels.apply_matrix_flat(psi[i] if psi.dim() > 1 else psi,
                                          mat[i] if mat.dim() > 2 else mat, wires, n)
        assert torch.equal(out[i], alone)


@pytest.mark.unittest
def test_zero_input_elision_cannot_serve_a_stale_plan():
    """A single all-zero input elides the encodings (another tape, so
    another plan); the next input takes its own."""
    tm = Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", device="cpu",
               dtype=torch.float64, random_seed=6)
    fresh = Model(n_qubits=4, n_layers=1, circuit_type="Circuit_19", device="cpu",
                  dtype=torch.float64, random_seed=6)
    with torch.no_grad():
        tm(inputs=0.0)
        got = tm(inputs=0.9)
        ref = fresh(inputs=0.9)
    assert len(tm.script._plans) == 2 and torch.allclose(got, ref, atol=1e-14)


# ---------------------------------------------------------------------------
# The route log
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_route_log_names_why_a_batch_loops():
    obs = [to.PauliZ(wires=0, record=False)]
    thetas = torch.tensor([0.3, -0.2, 0.8])

    def branching(theta):  # Python control flow on the argument's value
        if theta > 0:
            to.RX(theta, wires=0)
        else:
            to.RY(theta, wires=0)

    s = Script(branching, n_qubits=1, device="cpu")
    out = s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    assert s.routes[-1].startswith("loop: recording the batch raised")
    want = [np.cos(0.3), np.cos(0.2), np.cos(0.8)]
    assert np.allclose(_np(out)[:, 0], want, atol=1e-6)

    def front(x):  # indexes the batched argument from the front
        to.RX(x[0], wires=0)

    s = Script(front, n_qubits=1, device="cpu")
    xs = torch.tensor([[0.1, 0.5], [0.7, 0.9]])
    out = s.execute(type="expval", obs=obs, args=(xs,), in_axes=(0,))
    assert s.routes[-1].startswith("loop: the last element's")
    assert np.allclose(_np(out)[:, 0], np.cos([0.1, 0.7]), atol=1e-6)

    def width(x, w):  # a parameter of another leading dimension than the batch
        to.RY(w, wires=0)

    s = Script(width, n_qubits=1, device="cpu")
    s.execute(type="expval", obs=obs, args=(thetas, torch.linspace(0, 1, 5)), in_axes=(0, None))
    assert s.routes[-1] == "loop: a parameter's leading dimension is 5, neither 3 nor 1"
    s = Script(rx_chain_t, n_qubits=2, device="cpu")
    s.execute(type="expval", obs=obs, args=(thetas[:1],), in_axes=(0,))
    assert s.routes[-1] == "loop: a batch of one"
    assert len(s.routes) == 1
