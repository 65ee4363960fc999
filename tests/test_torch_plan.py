"""The PyTorch port plans like the JAX package: for the same tape,
``plan_contractions`` -> ``_zero_state_prefix`` -> ``schedule_layout`` gives
the same steps (kinds, wires, rotation amounts) with window matrices equal
to 1e-6 (complex64 compositions in both packages).

The large-state regime is exercised at 16 qubits with the regime threshold
lowered to 16 on both sides, as tests/test_lightcone.py does for the JAX
package; below 14 qubits ``schedule_layout`` returns the plan unchanged, so
8 qubits checks the plain regime.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

MAT_TOL = 1e-6


@pytest.fixture
def large_regime_at(monkeypatch):
    def at(n, fuse_layout_rot=False):
        monkeypatch.setattr(pallas_kernels, "ENABLED", True)
        monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_N", n)
        monkeypatch.setattr(pallas_kernels, "INTERPRET", True)
        monkeypatch.setattr(jsim, "FUSE_LAYOUT_ROT", fuse_layout_rot)
        monkeypatch.setattr(jsim, "USE_CHAINS", False)
        monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", n)
        monkeypatch.setattr(tsim, "FUSE_LAYOUT_ROT", fuse_layout_rot)

    return at


def _tapes(n, circuit="Circuit_19", x=0.37):
    jm = JaxModel(n_qubits=n, n_layers=2, circuit_type=circuit, random_seed=5)
    tm = Model(n_qubits=n, n_layers=2, circuit_type=circuit)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
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
    psi2 = torch.zeros((2, 2**4), device="meta")
    with pytest.raises(NotImplementedError):
        tsim._apply_step_ri(psi2, "rotmat", (2, torch.eye(4)), [0, 1], 4)
