"""The PyTorch port's drawing backends against the JAX package.

Text and TikZ drawings of the same circuits must be equal character for
character (the circuit of tests/test_drawing.py, symbolic and with gate
values, and ``str(Model)`` of Circuit_19 models whose parameters are carried
over with ``Model.load_numpy``); the pulse events of the same pulse circuits
must agree in gate, wires, ``w``, duration and carrier phase to 1e-12 (the
JAX side recorded eagerly under x64, never jitted; the port's leaf pulse
parameters set to the JAX package's, whose calibration constants are
float32 where the port's are float64).  The matplotlib backends
are run for their figures.
"""

from contextlib import contextmanager

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import qml_essentials_tpu.ops.operations as jo  # noqa: E402
import qml_essentials_tpu_torch.ops.operations as to  # noqa: E402
from qml_essentials_tpu.core.executor import Script as JaxScript  # noqa: E402
from qml_essentials_tpu.models.model import Model as JaxModel  # noqa: E402
from qml_essentials_tpu.pulse.pulses import PulseGates as JaxPulseGates  # noqa: E402
from qml_essentials_tpu.pulse.pulses import PulseInformation as JaxPulseInformation  # noqa: E402
from qml_essentials_tpu.utils import drawing as jdraw  # noqa: E402
from qml_essentials_tpu_torch.core.executor import Script  # noqa: E402
from qml_essentials_tpu_torch.models.model import Model  # noqa: E402
from qml_essentials_tpu_torch.pulse.pulses import PulseGates, PulseInformation  # noqa: E402
from qml_essentials_tpu_torch.utils import drawing as tdraw  # noqa: E402

EVENT_TOL = 1e-12
THETA = 0.3


@pytest.fixture(autouse=True)
def both_pulse_states():
    """Restore both packages' global pulse configuration after every test
    (a Model's constructor sets the envelope)."""
    jax_state = JaxPulseInformation.snapshot_state()
    state = PulseInformation.snapshot_state()
    yield
    JaxPulseInformation.restore_state(jax_state)
    PulseInformation.restore_state(state)


@contextmanager
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _circuit(mod, half_pi):
    """tests/test_drawing.py's circuit, in the operations module *mod*."""

    def circuit(theta):
        mod.H(wires=0)
        mod.RX(theta, wires=0)
        mod.CX(wires=[0, 1])
        mod.CRZ(0.5, wires=[1, 2])
        mod.Barrier(wires=[0, 1, 2])
        mod.RY(half_pi, wires=2)

    return circuit


def _scripts():
    return (JaxScript(_circuit(jo, jnp.pi / 2), n_qubits=3),
            Script(_circuit(to, np.pi / 2), n_qubits=3, device="cpu"))


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("value, latex, want", [
    (np.pi, False, "π"),
    (np.pi / 2, False, "π/2"),
    (-3 * np.pi / 4, False, "-3π/4"),
    (2 * np.pi, False, "2π"),
    (0.0, False, "0"),
    (0.123, False, "0.12"),
    (np.pi / 2, True, "\\pi/2"),
])
def test_format_pi_fraction_matches_jax(value, latex, want):
    assert tdraw.format_pi_fraction(value, latex=latex) == want
    assert jdraw.format_pi_fraction(value, latex=latex) == want


@pytest.mark.unittest
def test_tensor_parameters_label_as_in_jax():
    """A scalar tensor (on any device) reads its value; a batch of angles is
    labelled "θ", as a non-scalar is in the JAX package."""
    scalar = to.RX(torch.tensor(np.pi / 4, dtype=torch.float64), wires=0, record=False)
    batch = to.RX(torch.tensor([0.1, 0.2]), wires=0, record=False)
    assert tdraw._gate_label(scalar, True, [0]) == "RX(π/4)"
    assert tdraw._gate_label(batch, True, [0]) == "RX(θ)"
    jbatch = jo.RX(jnp.array([0.1, 0.2]), wires=0, record=False)
    assert jdraw._gate_label(jbatch, True, [0]) == "RX(θ)"


# ---------------------------------------------------------------------------
# Text and TikZ
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("figure, kwargs", [
    ("text", {}),
    ("text", {"gate_values": True}),
    ("tikz", {}),
    ("tikz", {"gate_values": True}),
])
def test_script_drawing_matches_jax(figure, kwargs):
    js, ts = _scripts()
    ref = js.draw(figure=figure, args=(THETA,), **kwargs)
    got = ts.draw(figure=figure, args=(THETA,), **kwargs)
    assert str(got) == str(ref)
    if figure == "tikz":
        assert isinstance(got, tdraw.TikzFigure) and got.code == ref.code


@pytest.mark.unittest
def test_noise_channels_are_not_drawn():
    def circuit():
        to.RX(0.4, wires=0)
        to.BitFlip(0.1, wires=0)
        to.CZ(wires=[0, 1])

    def plain():
        to.RX(0.4, wires=0)
        to.CZ(wires=[0, 1])

    noisy = Script(circuit, n_qubits=2, device="cpu").draw("text", gate_values=True)
    assert noisy == Script(plain, n_qubits=2, device="cpu").draw("text", gate_values=True)


@pytest.mark.unittest
def test_invalid_figure_raises():
    _, ts = _scripts()
    with pytest.raises(ValueError, match="Invalid figure mode"):
        ts.draw(figure="svg", args=(THETA,))


def _model_pair(n, seed=3, **kw):
    jm = JaxModel(n_qubits=n, n_layers=2, circuit_type="Circuit_19", random_seed=seed, **kw)
    tm = Model(n_qubits=n, n_layers=2, circuit_type="Circuit_19", random_seed=seed,
               device="cpu", **kw)
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    return jm, tm


@pytest.mark.unittest
@pytest.mark.parametrize("n", [2, 4])
def test_model_str_matches_jax(n):
    jm, tm = _model_pair(n)
    assert str(tm) == str(jm)
    assert repr(tm) == str(tm)


@pytest.mark.unittest
@pytest.mark.parametrize("figure", ["text", "tikz"])
def test_model_drawing_with_values_matches_jax(figure):
    """The first parameter set and the first input of a batch, with the
    encodings drawn (a nonzero input)."""
    jm, tm = _model_pair(4)
    inputs = np.random.default_rng(5).uniform(-1, 1, size=(3, 1)).astype(np.float32)
    ref = jm.draw(inputs=jnp.asarray(inputs), figure=figure, gate_values=True)
    got = tm.draw(inputs=torch.tensor(inputs), figure=figure, gate_values=True)
    assert str(got) == str(ref)


@pytest.mark.unittest
@pytest.mark.parametrize("full_document", [False, True])
def test_tikz_export_matches_jax(tmp_path, full_document):
    js, ts = _scripts()
    ref_path, got_path = tmp_path / "ref.tex", tmp_path / "got.tex"
    js.draw(figure="tikz", args=(THETA,)).export(str(ref_path), full_document=full_document)
    ts.draw(figure="tikz", args=(THETA,)).export(str(got_path), full_document=full_document)
    assert got_path.read_text() == ref_path.read_text()
    assert tdraw.QuanTikz.TikzFigure is tdraw.TikzFigure


# ---------------------------------------------------------------------------
# Matplotlib and pulse schedules
# ---------------------------------------------------------------------------


@pytest.mark.smoketest
def test_draw_mpl_returns_a_figure():
    import matplotlib.pyplot as plt

    _, ts = _scripts()
    fig, ax = ts.draw(figure="mpl", args=(THETA,))
    assert fig is not None and ax is not None
    plt.close(fig)


def _pulse_circuit(gates):
    def pulse_circ():
        gates.RX(0.5, wires=0)
        gates.RZ(0.3, wires=1)
        gates.CZ(wires=[0, 1])

    return pulse_circ


LEAVES = ("RX", "RY", "RZ", "CZ")


def _carry_jax_calibration():
    """The port's leaf pulse parameters set to the JAX package's values (the
    fixture restores them)."""
    for name in LEAVES:
        getattr(PulseInformation, name).params = torch.tensor(
            np.asarray(getattr(JaxPulseInformation, name).params), dtype=torch.float64)


def _assert_events_match(got, ref):
    assert [(e.gate, list(e.wires), e.parent) for e in got] == [
        (e.gate, list(e.wires), e.parent) for e in ref]
    for g, r in zip(got, ref):
        assert (g.envelope_fn is None) == (r.envelope_fn is None)
        for key in ("w", "duration", "carrier_phase"):
            assert abs(float(getattr(g, key)) - float(getattr(r, key))) <= EVENT_TOL, key
        np.testing.assert_allclose(np.asarray(g.envelope_params, dtype=np.float64),
                                   np.asarray(r.envelope_params, dtype=np.float64),
                                   rtol=0, atol=EVENT_TOL)


@pytest.mark.smoketest
def test_pulse_events_and_schedule_match_jax():
    import matplotlib.pyplot as plt

    JaxPulseInformation.set_envelope("gaussian", rwa=True)
    PulseInformation.set_envelope("gaussian", rwa=True)
    _carry_jax_calibration()
    with jax_x64():
        ref = JaxScript(_pulse_circuit(JaxPulseGates), n_qubits=2).pulse_events()
    ts = Script(_pulse_circuit(PulseGates), n_qubits=2, device="cpu")
    got = ts.pulse_events()
    assert len(got) == 3 and got[0].envelope_fn is not None and got[1].envelope_fn is None
    _assert_events_match(got, ref)

    fig, axes = ts.draw(figure="pulse")
    assert len(axes) == 2
    plt.close(fig)
    fig, axes = ts.draw(figure="pulse", show_envelope=False, envelope_width=1.0)
    plt.close(fig)


@pytest.mark.smoketest
def test_model_draw_pulse_matches_jax():
    import matplotlib.pyplot as plt

    kw = dict(n_qubits=2, n_layers=1, circuit_type="Circuit_1", data_reupload=False,
              pulse_shape="gaussian", random_seed=4)
    jm = JaxModel(**kw)
    tm = Model(device="cpu", dtype=torch.float64, **kw)
    tm.load_numpy(np.asarray(jm.params, dtype=np.float64), np.asarray(jm.enc_params))
    _carry_jax_calibration()
    with jax_x64():
        jparams, jinp = jm._draw_call_args(None)
        ref = JaxScript(jm._variational, n_qubits=2).pulse_events(
            jnp.asarray(np.asarray(jparams), dtype=jnp.float64), jinp,
            gate_mode="pulse", noise_params=None)
    params, inp = tm._draw_call_args(None)
    got = tm.script.pulse_events(params, inp, tm.pulse_params[0], gate_mode="pulse",
                                 noise_params=None)
    _assert_events_match(got, ref)

    fig, axes = tm.draw_pulse()
    assert len(axes) == 2
    plt.close(fig)
    fig, axes = tm.draw(figure="pulse", envelope_width=0.5, max_events=2)
    plt.close(fig)
