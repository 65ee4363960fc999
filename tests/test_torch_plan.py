"""The PyTorch port plans like the JAX package: for the same tape,
``plan_contractions`` -> ``_zero_state_prefix`` -> ``schedule_layout`` gives
the same steps (kinds, wires, rotation amounts) with window matrices equal
to 1e-6 (complex64 compositions in both packages).

The large-state regime is exercised at 16 qubits with the regime threshold
lowered to 16 on both sides, as tests/test_lightcone.py does for the JAX
package; below 14 qubits ``schedule_layout`` returns the plan unchanged, so
8 qubits checks the plain regime.

The fused-rotation slice as a whole runs at 15 qubits with
``FUSE_LAYOUT_ROT`` on in both packages: the port's forward (1e-5 on <Z>)
and its saved-executor and adjoint gradients (1e-4 of max|g|, float32 lambda
on both sides) against the JAX package's forward and adjoint gradient, its
fused Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import kernels
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

MAT_TOL = 1e-6


def _large_regime(mp, n, fuse_layout_rot):
    """Both packages schedule from n qubits (the JAX package's Pallas
    kernels in interpret mode), with or without fused rotation steps."""
    mp.setattr(pallas_kernels, "ENABLED", True)
    mp.setattr(pallas_kernels, "PALLAS_MIN_N", n)
    mp.setattr(pallas_kernels, "INTERPRET", True)
    mp.setattr(jsim, "FUSE_LAYOUT_ROT", fuse_layout_rot)
    mp.setattr(jsim, "USE_CHAINS", False)
    mp.setattr(tsim, "LARGE_STATE_MIN_N", n)
    mp.setattr(tsim, "FUSE_LAYOUT_ROT", fuse_layout_rot)


@pytest.fixture
def large_regime_at(monkeypatch):
    def at(n, fuse_layout_rot=False):
        _large_regime(monkeypatch, n, fuse_layout_rot)

    return at


def _models(n, circuit="Circuit_19"):
    jm = JaxModel(n_qubits=n, n_layers=2, circuit_type=circuit, random_seed=5)
    tm = Model(n_qubits=n, n_layers=2, circuit_type=circuit, device="cpu")
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    return jm, tm


def _tapes(n, circuit="Circuit_19", x=0.37):
    jm, tm = _models(n, circuit)
    with jax_recording() as jt:
        jm._variational(jnp.asarray(np.asarray(jm.params[0])), jnp.array([x]), noise_params=None)
    with recording() as tt, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([x]))
    return jt, tt


def _jax_schedule(tape, n):
    plan = jsim.plan_contractions(tape, n_qubits=n)
    peeled, psi2 = jsim._zero_state_prefix(plan, n)
    if n >= pallas_kernels.PALLAS_MIN_N:
        plan = jsim.schedule_layout(jsim._drop_indices(plan, peeled), n)
    return plan, peeled, psi2


def _payload_matrix(kind, payload):
    if kind == "op":
        return payload.matrix
    if kind in ("rotmat", "matrot"):
        return payload[1]
    return payload


def _assert_same_steps(jax_steps, port_steps):
    assert [s[0] for s in port_steps] == [s[0] for s in jax_steps]
    for (jk_, jp, jw), (tk_, tp, tw) in zip(jax_steps, port_steps):
        assert list(tw) == list(jw)
        if jk_ == "rot":
            assert int(tp) == int(jp)
            continue
        if jk_ in ("rotmat", "matrot"):
            assert tp[0] == jp[0]
        if jk_ == "op":
            assert type(tp).__name__ == type(jp).__name__
        got = _payload_matrix(tk_, tp).detach().numpy()
        ref = np.asarray(_payload_matrix(jk_, jp))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= MAT_TOL


@pytest.mark.unittest
def test_plain_regime_plan_matches_jax():
    n = 8
    jt, tt = _tapes(n)
    jplan, _, _ = _jax_schedule(jt, n)
    _assert_same_steps(jplan, tsim.plan_contractions(tt, n_qubits=n))
    plan, start = tsim.scheduled_plan(tt, n)
    assert start is None
    _assert_same_steps(jplan, plan)


@pytest.mark.unittest
@pytest.mark.parametrize("fuse_layout_rot", [False, True], ids=["slice", "fused-rotations"])
def test_large_regime_schedule_matches_jax(large_regime_at, fuse_layout_rot):
    n = 16
    large_regime_at(n, fuse_layout_rot)
    jt, tt = _tapes(n)
    jplan, peeled, jpsi2 = _jax_schedule(jt, n)
    plan, psi2 = tsim.scheduled_plan(tt, n)

    tplan = tsim.plan_contractions(tt, n_qubits=n)
    tpeeled, _ = tsim._zero_state_prefix(tplan, n)
    assert tpeeled == peeled and len(peeled) >= 2
    assert np.abs(psi2.numpy() - np.asarray(jpsi2)).max() <= MAT_TOL

    kinds = [s[0] for s in plan]
    assert "rot" in kinds or "rotmat" in kinds
    if not fuse_layout_rot:
        # The slice's configuration: windows and rotations only, with top
        # windows reaching the top-window kernel.
        assert set(kinds) == {"mat", "rot"}
        assert any(max(w) == n - 1 for k, _, w in plan if k == "mat")
    _assert_same_steps(jplan, plan)


@pytest.mark.unittest
def test_large_regime_runs_the_same_state(large_regime_at):
    """The scheduled plan in the port gives the plain-regime state."""
    n = 16
    _, tt = _tapes(n, x=-0.6)
    ref = tsim.simulate_pure_ri(tt, n)
    large_regime_at(n)
    got = tsim.simulate_pure_ri(tt, n)
    assert np.abs(got.numpy() - ref.numpy()).max() <= 1e-5


@pytest.mark.unittest
def test_fused_rotation_steps_refuse_the_card():
    """A fused step goes to its kernel's wrapper: on a device with no kernel
    (``meta``, state and payload both there) the wrapper's device check
    raises; on the CPU the wrapper gives the plain two-pass result."""
    n, r = 4, 2
    mat = torch.from_numpy(np.linalg.qr(np.arange(16.0).reshape(4, 4) + np.eye(4))[0])
    mat = mat.to(torch.complex64)
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        tsim._apply_step_ri(torch.zeros((2, 2**n), device="meta"), "rotmat",
                            (r, mat.to("meta")), [0, 1], n)
    psi2 = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2**n)).astype(np.float32))
    w2 = torch.stack([mat.real, mat.imag])
    for kind, wires, two_pass in (
        ("rotmat", [0, 1], lambda p: kernels.window_apply_plain(
            kernels.rotate_plain(p, r, n), w2, 0, 2, n)),
        ("matrot", [0, 1], lambda p: kernels.rotate_plain(
            kernels.window_apply_plain(p, w2, 0, 2, n), r, n)),
    ):
        got = tsim._apply_step_ri(psi2, kind, (r, mat), wires, n)
        assert torch.equal(got, two_pass(psi2))


# ---------------------------------------------------------------------------
# The fused-rotation slice as a whole: both packages with FUSE_LAYOUT_ROT on
# ---------------------------------------------------------------------------

# 15 qubits is the narrowest Circuit_19 whose scheduled plan holds all three
# fused kinds (16 qubits has no matrot): rotmat (r=8, k=8), rotwin (r=7, k=8),
# matrot (r=7, k=8), beside windows, rotations and a top window.
SLICE_N = 15
SLICE_X = 0.37
SLICE_FWD_TOL = 1e-5  # <Z>, float32 through 12 steps on both sides
SLICE_GRAD_TOL = 1e-4  # x max|g|: float32 gradients, sums in other orders
FUSED_WRAPPERS = ("rotmat_apply", "matrot_apply", "rotwin_apply", "rotmat_apply_bwd",
                  "matrot_apply_bwd", "rotwin_apply_bwd", "adjoint_rotmat", "adjoint_matrot")


@pytest.fixture(scope="module")
def fused_slice():
    """The 15-qubit model through both packages with the scheduled, fused
    plan: the JAX package's forward and adjoint gradient (its fused Pallas
    kernels in interpret mode, float32 products, gram and lambda), and the port's
    forward, saved-executor and adjoint gradients with f32 lambda, each with
    the fused wrappers it called."""
    import jax

    from qml_essentials_tpu.core import executor as jax_executor
    from qml_essentials_tpu.ops import saved as jax_saved
    from qml_essentials_tpu_torch.ops import cuda_kernels, saved

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _large_regime(mp, SLICE_N, True)
        mp.setattr(jax_executor, "JIT_SINGLE", False)  # eager: no 15q compile
        mp.setattr(pallas_kernels, "GRAM_MODE", "split3")
        mp.setattr(pallas_kernels, "PRECISION_MODE", "highest")
        mp.setattr(jsim, "BACKWARD_MODE", "adjoint")
        mp.setattr(jax_saved, "LAMBDA_MODE", "f32")
        pulse_state = PulseInformation.snapshot_state()
        jm, tm = _models(SLICE_N)
        PulseInformation.restore_state(pulse_state)  # JaxModel() sets the global pulse envelope
        z, vjp = jax.vjp(lambda p: jm(p, inputs=SLICE_X), jm.params)
        (g,) = vjp(jnp.full(z.shape, 1.0 / z.size, z.dtype))
        out["jax"] = (np.asarray(z, np.float64), np.asarray(g, np.float64))

        with recording() as tape, torch.no_grad():
            tm._variational(tm.params[0], torch.tensor([SLICE_X]))
        out["plan"] = tsim.scheduled_plan(tape, SLICE_N)[0]

        calls = []
        for name in FUSED_WRAPPERS:
            def spy(*args, _f=getattr(cuda_kernels, name), _name=name):
                calls.append(_name)
                return _f(*args)

            mp.setattr(cuda_kernels, name, spy)
        mp.setattr(saved, "LAMBDA_MODE", "f32")
        with torch.no_grad():
            out["forward"] = (tm(inputs=SLICE_X).double().numpy(), set(calls))
        for mode in ("autodiff", "adjoint"):
            calls.clear()
            mp.setattr(tsim, "BACKWARD_MODE", mode)
            tm.params.grad = None
            tm(inputs=SLICE_X).mean().backward()
            out[mode] = (tm.params.grad.double().numpy(), set(calls))
    return out


@pytest.mark.unittest
def test_fused_slice_plan_holds_every_fused_kind(fused_slice):
    shapes = {(kind, payload[0], len(wires)) for kind, payload, wires in fused_slice["plan"]
              if kind in ("rotmat", "matrot")}
    assert {("rotmat", 8, 8), ("rotmat", 7, 8), ("matrot", 7, 8)} <= shapes
    assert any(kind == "mat" and max(w) == SLICE_N - 1 for kind, _, w in fused_slice["plan"])


@pytest.mark.unittest
def test_fused_slice_forward_matches_jax(fused_slice):
    z_jax, _ = fused_slice["jax"]
    z, called = fused_slice["forward"]
    assert z.shape == z_jax.shape == (SLICE_N,)
    assert np.abs(z - z_jax).max() <= SLICE_FWD_TOL
    assert called == {"rotmat_apply", "matrot_apply", "rotwin_apply"}


@pytest.mark.unittest
@pytest.mark.parametrize("mode", ["autodiff", "adjoint"], ids=["saved", "adjoint"])
def test_fused_slice_gradient_matches_jax(fused_slice, mode):
    """The saved executor runs the fused backwards (B7/B9/B11); the adjoint
    runs B14/B15, and rotwin through the unfused adjoint step, as the JAX
    package does."""
    _, g_jax = fused_slice["jax"]
    g, called = fused_slice[mode]
    assert g.shape == g_jax.shape
    assert np.abs(g - g_jax).max() <= SLICE_GRAD_TOL * np.abs(g_jax).max()
    fused_bwd = {"rotmat_apply_bwd", "matrot_apply_bwd", "rotwin_apply_bwd"}
    fused_adj = {"adjoint_rotmat", "adjoint_matrot"}
    if mode == "autodiff":
        assert fused_bwd <= called and not fused_adj & called
    else:
        assert fused_adj <= called and not fused_bwd & called
