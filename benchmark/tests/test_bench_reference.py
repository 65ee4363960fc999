"""The plain reference against closed forms and against the program's CPU
path (float64) at small registers, pure and depolarized, with gradients."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import circuit19
from benchmark.reference.circuit19 import Circuit19


def _params(n, layers, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((layers + 1, 3 * n), generator=g, dtype=torch.float64) * 2 * math.pi


@pytest.mark.parametrize("p", [0.0, 0.01, 0.2])
def test_zero_angles_closed_form(p):
    """All angles zero: each qubit sees RX(x) twice and, with noise, 14
    depolarizing channels (4 gates in each of 3 ansatz layers, 2 encodings),
    each shrinking the Bloch vector by 1 - 4p/3."""
    n, layers = 4, 2
    xs = torch.tensor([0.3, -0.8], dtype=torch.float64)
    sim = Circuit19(n, layers, p)
    got = sim.forward(torch.zeros((layers + 1, 3 * n), dtype=torch.float64), xs)
    want = (1 - 4 * p / 3) ** 14 * torch.cos(2 * xs)[:, None].expand(2, n)
    assert torch.allclose(got, want, atol=1e-12)


def test_single_rx_layer_closed_form():
    """Only the first layer's RX angles set: <Z_q> = cos(rx_q + 2x)."""
    n, layers = 5, 2
    params = torch.zeros((layers + 1, 3 * n), dtype=torch.float64)
    params[0, :n] = torch.linspace(0.1, 1.3, n, dtype=torch.float64)
    xs = torch.tensor([0.45], dtype=torch.float64)
    got = Circuit19(n, layers).forward(params, xs)
    assert torch.allclose(got[0], torch.cos(params[0, :n] + 2 * xs), atol=1e-12)


def test_gate_layout():
    g = circuit19.gates(3, 2)
    assert len(g) == 3 * 9 + 2 * 3
    assert [w for k, w, _ in g[6:9]] == [(2, 0), (1, 2), (0, 1)]
    assert [s for _, _, s in g[6:9]] == [(0, 6), (0, 7), (0, 8)]
    assert circuit19.params_shape({"n_layers": 2, "n_qubits": 24}) == (3, 72)


def _port(n, layers, params, noise=None):
    from qml_essentials_tpu_torch import Model

    m = Model(n_qubits=n, n_layers=layers, circuit_type="Circuit_19", device="cpu",
              dtype=torch.float64)
    m.params = params[None]
    m.noise_params = noise
    return m


@pytest.mark.parametrize("n", [4, 6, 8])
def test_pure_against_the_port(n):
    params = _params(n, 2, n)
    xs = torch.tensor([0.31, -0.77, 0.05], dtype=torch.float64)
    want = _port(n, 2, params)(inputs=xs)
    assert torch.allclose(Circuit19(n, 2).forward(params, xs), want, atol=1e-12)


@pytest.mark.parametrize("n", [3, 4])
def test_depolarized_against_the_port(n):
    params = _params(n, 2, 10 + n)
    xs = torch.tensor([0.62, -0.4], dtype=torch.float64)
    want = _port(n, 2, params, {"Depolarizing": 0.01})(inputs=xs)
    got = Circuit19(n, 2, 0.01).forward(params, xs)
    assert torch.allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n", [4, 6])
def test_gradient_against_the_port(n):
    params = _params(n, 2, 20 + n)
    xs = torch.tensor([0.3, -0.7, 0.9, 0.1], dtype=torch.float64)
    ys = torch.sin(math.pi * xs)
    m = _port(n, 2, params)
    loss = ((m(inputs=xs, force_mean=True) - ys) ** 2).mean()
    loss.backward()
    got_loss, got_grad = Circuit19(n, 2).mse_and_grad(params, xs, ys)
    assert abs(got_loss - loss.item()) < 1e-12
    assert torch.allclose(got_grad, m.params.grad[0], atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0], dtype=torch.float32)
    r = circuit19.tf32(torch.complex(x, -x)).real
    assert r.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0]


def test_tf32_control_departs():
    """The control departs from the float64 reference by far more than
    float32 rounding at a register a test can hold."""
    n = 6
    params = _params(n, 2, 5)
    xs = torch.tensor([0.3, -0.6], dtype=torch.float64)
    want = Circuit19(n, 2).forward(params, xs)
    got = Circuit19(n, 2, precision="tf32").forward(params.float(), xs.float()).double()
    assert float((got - want).abs().max()) > 1e-4
    assert np.isfinite(got.numpy()).all()
