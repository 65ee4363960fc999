"""Parameter gradients of the PyTorch port's ``Model`` against the JAX
package, for every parametrised ansatz.

5 qubits, 2 layers, float64 on both sides (JAX with x64 enabled), the
parameters and the input drawn from a numpy seed and carried across with
``Model.load_numpy``.  The loss is a seeded weighted sum of the all-qubit
<Z> outputs.  Tolerance 1e-12: both sides compute in float64 with their
fixed gates in float64 (complex64 constants would leave an H-based state off
by ~1e-8), so what is left is the rounding of two contraction orders.

A file of its own: the JAX side compiles one forward and one gradient per
ansatz (~5-35 s each on the CPU), which the test runner's workers then take
in parallel with the other files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.models.ansaetze import Ansaetze as JaxAnsaetze
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu_torch.models.model import Model

torch.set_num_threads(2)

N_QUBITS, N_LAYERS = 5, 2
GRAD_TOL = 1e-12


@pytest.mark.unittest
@pytest.mark.parametrize("circuit",
                         [c.__name__ for c in JaxAnsaetze.get_available(parameterized_only=True)])
def test_every_ansatz_gradient_matches_jax(circuit):
    rng = np.random.default_rng(sum(map(ord, circuit)))
    x = float(rng.uniform(-np.pi, np.pi))
    weights = rng.normal(size=N_QUBITS)
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JaxModel(n_qubits=N_QUBITS, n_layers=N_LAYERS, circuit_type=circuit, random_seed=11)
        params = rng.uniform(0, 2 * np.pi, size=np.asarray(jm.params).shape)
        enc = np.asarray(jm.enc_params, dtype=np.float64)
        w64 = jnp.asarray(weights)
        ref = np.asarray(jax.grad(lambda p: jnp.sum(w64 * jm(p, inputs=x)))(jnp.asarray(params)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert ref.dtype == np.float64
    tm = Model(n_qubits=N_QUBITS, n_layers=N_LAYERS, circuit_type=circuit, dtype=torch.float64,
               device="cpu")
    tm.load_numpy(params, enc)
    (torch.from_numpy(weights) * tm(inputs=x)).sum().backward()
    got = tm.params.grad.numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= GRAD_TOL
