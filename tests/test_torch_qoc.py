"""The PyTorch port's QOC against the JAX package.

Cost functions at 1e-10 on the same parameters (float64 on both sides);
the population optimiser's steps against optax's trajectory from the same
starts at 1e-8 (a gradient clip that binds for one member only, a member
that goes NaN and freezes); optax's warmup-cosine schedule; the results
CSV, the CLI parser and small end-to-end runs (port only).  The JAX QOC
entry points switch on ``jax_enable_x64`` process-wide: it is switched off
after every test, and both packages' pulse state is restored.
"""

import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import qml_essentials_tpu.pulse.qoc as jq
from qml_essentials_tpu.core import jaqsi as jjs
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.pulse.pulses import PulseInformation as JaxPulseInformation
import qml_essentials_tpu_torch.pulse.qoc as tq
from qml_essentials_tpu_torch.pulse.evolution import Evolution
from qml_essentials_tpu_torch.pulse.pulses import PulseInformation

torch.set_num_threads(2)

COST_TOL = 1e-10
STEP_TOL = 1e-8


@pytest.fixture(autouse=True)
def restore_x64_and_pulse_state():
    jax_state = JaxPulseInformation.snapshot_state()
    state = PulseInformation.snapshot_state()
    yield
    jax.config.update("jax_enable_x64", False)
    JaxPulseInformation.restore_state(jax_state)
    PulseInformation.restore_state(state)


def _knobs(tmp_path, **overrides):
    knobs = dict(envelope="gaussian", cost_fns=[("unitary", (0.5, 0.5))], t_target=0.5,
                 n_steps=10, n_samples=3, learning_rate=1e-3, log_interval=5,
                 file_dir=str(tmp_path), n_restarts=1, scan_steps=0, random_seed=7)
    knobs.update(overrides)
    return knobs


@contextmanager
def _x64_constants():
    """The JAX operation classes' constant matrices in complex128, as they
    are when the package is imported under x64 (the probes' H would stay
    complex64 otherwise)."""
    promoted = {}
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                cls._matrix = m.astype(jnp.complex128)
        yield
    finally:
        for cls, m in promoted.items():
            cls._matrix = m


def _both(tmp_path, **overrides):
    jax.config.update("jax_enable_x64", True)
    return jq.QOC(**_knobs(tmp_path, **overrides)), tq.QOC(**_knobs(tmp_path, **overrides),
                                                           device="cpu")


# ---------------------------------------------------------------------------
# Cost functions
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("gate,cost", [("RX", "unitary"), ("RX", "fidelity"),
                                       ("H", "fidelity"),
                                       ("CZ", "unitary")])
def test_cost_functions_match_jax(tmp_path, gate, cost):
    """Pulse parameters 7 % off the calibration, 3 sampled angles.  The
    two-qubit case is held at 1e-7: with x64 switched on after the JAX
    package was imported, its two-qubit statevector path keeps a complex64
    constant and its own states move by 1.2e-8 (the same cost with x64 on
    from import agrees with the port to 3e-14)."""
    _both(tmp_path)
    nw = jq._GATE_LIBRARY[gate].wires
    pp = np.asarray(JaxPulseInformation.gate_by_name(gate).params, dtype=np.float64) * 1.07
    jp, jt = jq._pair_from_spec(gate)
    tp, tt = tq._pair_from_spec(gate)
    with _x64_constants():
        if cost == "unitary":
            ref = jq.unitary_cost_fn(jnp.asarray(pp), jq._basis_scripts(jp, nw),
                                     jq._basis_scripts(jt, nw), 3, nw)
        else:
            ref = jq.fidelity_cost_fn(jnp.asarray(pp), [jjs.Script(jp, n_qubits=nw)],
                                      [jjs.Script(jt, n_qubits=nw)], 3)
    if cost == "unitary":
        got = tq.unitary_cost_fn(torch.tensor(pp), tq._basis_scripts(tp, nw, "cpu"),
                                 tq._basis_scripts(tt, nw, "cpu"), 3, nw)
    else:
        got = tq.fidelity_cost_fn(torch.tensor(pp), [tq._script(tp, nw, "cpu")],
                                  [tq._script(tt, nw, "cpu")], 3)
    tol = COST_TOL if nw == 1 else 1e-7
    for a, b in zip(ref, got):
        assert b.dtype == torch.float64
        assert abs(float(a) - float(b)) <= tol


@pytest.mark.unittest
def test_auxiliary_cost_functions_and_angles_match_jax(tmp_path):
    _both(tmp_path)
    for env in ("gaussian", "square", "cosine", "drag", "sech", "general"):
        n_env = tq.PulseEnvelope.get(env)["n_envelope_params"]
        # (+0.03: the square envelope's edges fall between the FFT grid's
        # points, not on one, where a rounding would flip a sample.)
        pp = np.linspace(0.6, 2.2, n_env + 1) + 0.03
        for name in ("pulse_width", "spectral_density"):
            ref = getattr(jq, f"{name}_cost_fn")(jnp.asarray(pp), env)
            got = getattr(tq, f"{name}_cost_fn")(torch.tensor(pp), env)
            assert abs(float(ref) - float(got)) <= COST_TOL, (env, name)
        ref = jq.evolution_time_cost_fn(jnp.asarray(pp), 0.5)
        assert abs(float(ref) - float(tq.evolution_time_cost_fn(torch.tensor(pp), 0.5))) \
            <= COST_TOL
    for n in (1, 3, 7, 20):
        assert np.allclose(tq._sample_rotation_angles(n).numpy(),
                           np.asarray(jq._sample_rotation_angles(n)), atol=1e-14)
    # Composition and the registry.
    c1 = tq.Cost(lambda p: (p[0], p[0] * 2), weight=(0.5, 0.25))
    assert float(c1(torch.tensor([2.0]))) == pytest.approx(2.0)
    assert float((tq.Cost(lambda p: p[0], weight=2.0) + c1)(torch.tensor([2.0]))) == \
        pytest.approx(6.0)
    with pytest.raises(TypeError):
        tq.Cost(lambda p: p, weight=1.0) + 5
    assert tq.CostFnRegistry.available() == jq.CostFnRegistry.available()
    assert tq.CostFnRegistry.parse_cost_arg("unitary:0.7,0.3") == ("unitary", (0.7, 0.3))
    with pytest.raises(ValueError):
        tq.CostFnRegistry.parse_cost_arg("unitary:0.5")
    with pytest.raises(ValueError):
        tq.CostFnRegistry.get("bogus")


# ---------------------------------------------------------------------------
# The optimiser
# ---------------------------------------------------------------------------

_TARGET = np.array([2.0, 0.4, 1.5])
_WEIGHT = np.array([1.0, 3.0, 0.5])


def _cost(m):
    """A smooth cost with a square root that goes NaN past p[0] = 1.3,
    written with the math module *m*."""

    def cost(p):
        return (m.sum(_w(m, p) * (p - _t(m, p)) ** 2) + 0.1 * m.sqrt(1.3 - p[0])
                + 0.05 * m.sin(3 * p[1]))

    return cost


def _t(m, p):
    return m.asarray(_TARGET) if m is jnp else torch.tensor(_TARGET)


def _w(m, p):
    return m.asarray(_WEIGHT) if m is jnp else torch.tensor(_WEIGHT)


# Member 0 moves freely, member 1 is far off (its gradient norm exceeds the
# clip), member 2 sits just under p[0] = 1.3 and steps over it.
_STARTS = np.array([[0.6, 0.5, 1.3], [0.2, 1.9, 0.1], [1.27, 0.42, 1.48]])
_CLIP = 5.0


@pytest.mark.unittest
@pytest.mark.parametrize("stage", ["stage 0 (adam)", "stage 1 (adamw, schedule)"])
def test_descend_matches_optax(tmp_path, stage):
    jqoc, tqoc = _both(tmp_path, learning_rate=0.05, n_steps=3, warmup_ratio=0.34,
                       end_lr_ratio=0.1, grad_clip=_CLIP)
    if stage.startswith("stage 0"):
        jopt = optax.chain(optax.clip_by_global_norm(_CLIP), optax.adam(0.1))
        topt = tq._PopulationAdam(0.1, clip=_CLIP)
    else:
        jopt = optax.chain(optax.clip_by_global_norm(_CLIP), optax.adamw(jqoc._lr_schedule()))
        topt = tq._PopulationAdam(tqoc._lr_schedule(), weight_decay=1e-4, clip=_CLIP)
    ref = jqoc._descend(_cost(jnp), jnp.asarray(_STARTS), jopt, 3)
    got = tqoc._descend(_cost(torch), torch.tensor(_STARTS), topt, 3)

    # The clip binds for member 1 only (at the start).
    grads = [np.asarray(jax.grad(lambda lp: _cost(jnp)(jqoc._from_log_space(lp)))(
        jqoc._to_log_space(jnp.asarray(s)))) for s in _STARTS]
    assert [bool(np.linalg.norm(g) > _CLIP) for g in grads] == [False, True, False]
    # Member 2 went NaN and froze; the others did not.
    assert np.asarray(ref["halted"]).tolist() == got["halted"].tolist() == [False, False, True]
    assert np.isinf(np.asarray(ref["losses"])[-1, 2]) and np.isinf(got["losses"][-1, 2].item())
    for key in ("init_loss", "best_loss", "losses", "best"):
        a, b = np.asarray(ref[key]), got[key].numpy()
        assert a.shape == b.shape, key
        finite = np.isfinite(a)
        assert (finite == np.isfinite(b)).all(), key
        assert np.abs(a[finite] - b[finite]).max() <= STEP_TOL, key


@pytest.mark.unittest
@pytest.mark.parametrize("knobs", [(0.05, 0.01, 100), (0.0, 0.1, 40), (0.3, 1.0, 25)])
def test_schedule_matches_optax(tmp_path, knobs):
    warmup, end_ratio, steps = knobs
    jqoc, tqoc = _both(tmp_path, learning_rate=3e-3, n_steps=steps, warmup_ratio=warmup,
                       end_lr_ratio=end_ratio)
    jsched, tsched = jqoc._lr_schedule(), tqoc._lr_schedule()
    counts = np.arange(steps + 5)
    if callable(jsched):
        # optax calls a schedule with its int32 step count (float32 values).
        ref = np.array([float(jsched(jnp.int32(c))) for c in counts])
        got = tsched(torch.tensor(counts)).numpy()
        assert got.dtype == np.float32
        assert np.abs(ref - got).max() <= 2.5e-7 * np.abs(ref).max()
    else:
        assert jsched == tsched == 3e-3


# ---------------------------------------------------------------------------
# Persistence, the CLI, end-to-end runs (port)
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_save_results_merges_the_csv(tmp_path):
    qoc = tq.QOC(**_knobs(tmp_path), device="cpu")
    f64 = dict(dtype=torch.float64)
    qoc.save_results("RX", 0.9, torch.tensor([1.0, 2.0, 3.0], **f64))
    qoc.save_results("RY", 0.8, torch.tensor([4.0, 5.0, 6.0], **f64))
    qoc.save_results("RX", 0.95, torch.tensor([1.1, 2.1, 3.1], **f64))
    qoc.save_results("RY", 0.7, torch.tensor([4.5, 5.5, 6.5], **f64))  # a downgrade still lands
    rows = [line.split(",") for line in
            open(os.path.join(str(tmp_path), "qoc_results_gaussian.csv")).read().splitlines()]
    assert [r[0] for r in rows] == ["RX", "RY"]
    assert float(rows[0][1]) == 0.95 and [float(x) for x in rows[0][2:]] == [1.1, 2.1, 3.1]
    assert float(rows[1][1]) == 0.7
    PulseInformation.update_params(os.path.join(str(tmp_path), "qoc_results_gaussian.csv"))
    assert PulseInformation.OPTIMIZED_PULSES["RY"].tolist() == [4.5, 5.5, 6.5]


@pytest.mark.unittest
def test_cli_parser_matches_jax():
    argv = ["--gates", "RX", "CZ", "--envelope", "drag", "--n_steps", "12",
            "--learning_rate", "0.01", "--scan_ranges", "0.1,1", "0.2,2", "--joint", "--rwa",
            "--joint_weights", "RX:0.5"]
    ref = vars(jq._build_arg_parser().parse_args(argv))
    got = vars(tq._build_arg_parser().parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == ref
    assert vars(tq._build_arg_parser().parse_args([]))["device"] == "cuda"


@pytest.mark.unittest
def test_optimize_rx_improves_and_saves(tmp_path):
    """tests/test_qoc.py's budget, two restarts: the loss falls, the CSV lands."""
    qoc = tq.QOC(**_knobs(tmp_path, n_steps=15, learning_rate=5e-3, n_restarts=2),
                 device="cpu")
    init = PulseInformation.gate_by_name("RX").params * 1.15
    before = Evolution.solve_calls
    best, history = qoc.optimize(wires=1)(qoc.create_RX)(init_pulse_params=init)
    assert len(history) == 16 and Evolution.solve_calls > before
    assert float(min(history[1:])) < float(history[0])
    assert torch.isfinite(best).all()
    assert os.path.isfile(os.path.join(str(tmp_path), "qoc_results_gaussian.csv"))


@pytest.mark.unittest
def test_stage0_early_stop_and_joint_mode(tmp_path):
    qoc = tq.QOC(**_knobs(tmp_path, scan_steps=1, scan_grid_size=2, n_steps=2,
                          early_stop_patience=1, early_stop_min_delta=10.0), device="cpu")
    grid, axes = qoc._build_scan_grid(2, init_pulse_params=torch.tensor([1.0, 2.0]))
    assert grid.shape == (4, 2) and len(axes) == 2
    best, history = qoc.optimize(wires=1)(qoc.create_RZ)()
    assert torch.isfinite(best).all() and len(history) == 3
    p = torch.tensor([2.0, 0.5, 1.5], dtype=torch.float64)
    assert torch.allclose(qoc._from_log_space(qoc._to_log_space(p)), p)

    qoc = tq.QOC(**_knobs(tmp_path, n_steps=2, n_samples=2), device="cpu")
    theta, slices, log_idx = qoc._build_joint_layout(("RX", "RY", "RZ", "CZ"))
    assert slices["RX"] == slices["RY"] and theta.shape == (5,) and log_idx == [0, 2]
    h = tq.QOC._assemble_for_gate(theta, PulseInformation.H, slices)
    assert h.shape == (4,) and torch.equal(h[1:], theta[slices["RY"]])
    theta, slices, history = qoc.optimize_joint(target_gates=["RX", "RZ"])
    assert torch.isfinite(theta).all() and len(history) == 3


@pytest.mark.unittest
def test_cli_and_profile_run_on_the_cpu(tmp_path):
    tq.main(["--gates", "RZ", "--envelope", "gaussian", "--n_steps", "2", "--n_samples", "2",
             "--scan_steps", "0", "--n_restarts", "1", "--file_dir", str(tmp_path),
             "--device", "cpu"])
    assert os.path.isfile(os.path.join(str(tmp_path), "qoc_results_gaussian.csv"))
    assert PulseInformation.get_frame() == "lab" and PulseInformation.get_rwa() is False
    result = tq.profile_pulse_pipeline("RX", n_samples=1, rwa=True, device="cpu")
    assert result["mean_fwd"] > 0 and np.isfinite(result["loss"])
