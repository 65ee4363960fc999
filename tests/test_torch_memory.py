"""The port's memory estimates and chunked execution
(``qml_essentials_tpu_torch.core.memory``) against the JAX package's
(``qml_essentials_tpu.core.memory``) on the reference's own terms, with the
port's payload term on top, on the CPU.

The JAX package's estimate counts states only; the port adds the bytes of a
vectorised batch's plan payloads per element (``payload_bytes``), so with
``payload_bytes=0`` the two agree exactly, and the payload term adds
``1.5 * batch * payload_bytes`` where the working set dominates.
"""

import numpy as np
import pytest
import torch

from qml_essentials_tpu.core import memory as jmem
from qml_essentials_tpu_torch.core import memory as tmem
from qml_essentials_tpu_torch.core.executor import Script
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import operations as to
from qml_essentials_tpu_torch.ops import simulation as tsim

torch.set_num_threads(2)

# (n_qubits, batch, type, use_density, n_obs, n_ops), as in tests/test_script.py.
CASES = [
    (4, 16, "expval", False, 1, 1),
    (20, 10_000_000, "density", True, 0, 1),
    (8, 1, "state", False, 0, 10),
    (12, 64, "state", False, 0, 10),
    (8, 1, "density", True, 0, 10),
    (10, 20, "density", True, 0, 3),
    (6, 416_000, "expval", False, 6, 42),
    (5, 3, "probs", False, 0, 2),
]


@pytest.mark.unittest
@pytest.mark.parametrize("case", CASES)
def test_estimate_matches_the_reference(case):
    """float32 (complex64 amplitudes, the JAX package's default) with no
    payload term: the reference's own estimate, byte for byte."""
    assert tmem.estimate_peak_bytes(*case) == jmem.estimate_peak_bytes(*case)
    assert tmem._output_bytes(case[2], case[1], 2 ** case[0], 8, 4, case[4]) == \
        jmem._output_bytes(case[2], case[1], 2 ** case[0], 8, 4, case[4])


@pytest.mark.unittest
@pytest.mark.parametrize("case", CASES)
def test_payload_term_and_float64(case):
    """The port's payload term adds 1.5 x batch x payload bytes to the
    working set; float64 doubles every state term."""
    n, batch, type_, dens, n_obs, n_ops = case
    base = tmem.estimate_peak_bytes(*case)
    with_payload = tmem.estimate_peak_bytes(*case, payload_bytes=1024)
    dim = 2**n
    live = max(1, min(n_ops, tmem.LIVE_BUFFERS))
    work = ((1 + 2 * live) * batch * dim * dim * 8 + batch * dim * 8 if dens
            else (1 + live) * batch * dim * 8)
    out = tmem._output_bytes(type_, batch, dim, 8, 4, n_obs)
    assert with_payload == int(max(work + batch * 1024, out) * 1.5)
    assert base == int(max(work, out) * 1.5)
    f64 = tmem.estimate_peak_bytes(*case, dtype=torch.float64)
    assert f64 == int(max(2 * work, 2 * out) * 1.5)


@pytest.mark.unittest
@pytest.mark.parametrize("free", [2**20, 2**26, 2**34])
@pytest.mark.parametrize("case", CASES)
def test_chunk_size_matches_the_reference(case, free, monkeypatch):
    """With the same free memory the chunk sizes agree; the payload term
    only ever makes chunks smaller."""
    monkeypatch.setattr(jmem, "available_memory_bytes", lambda: free)
    n, batch, type_, dens, n_obs, n_ops = case
    ref = jmem.compute_chunk_size(n, batch, type_, dens, n_obs, n_ops=n_ops)
    got = tmem.compute_chunk_size(n, batch, type_, dens, n_obs, n_ops=n_ops, device="cpu",
                                  available=free)
    assert got == ref
    assert 1 <= tmem.compute_chunk_size(n, batch, type_, dens, n_obs, n_ops=n_ops,
                                        device="cpu", available=free,
                                        payload_bytes=4096) <= got


@pytest.mark.unittest
def test_reference_bounds_and_monotonicity():
    """tests/test_script.py:178-195 on the port."""
    assert tmem.compute_chunk_size(4, 16, "expval", False, 1, device="cpu") == 16
    c = tmem.compute_chunk_size(20, 10_000_000, "density", True, 0, device="cpu")
    assert 1 <= c < 10_000_000
    small = tmem.estimate_peak_bytes(8, 1, "state", False, 0, 10)
    large = tmem.estimate_peak_bytes(12, 64, "state", False, 0, 10)
    assert large > small
    assert tmem.estimate_peak_bytes(8, 1, "density", True, 0, 10) > small
    assert tmem.CLEAR_CACHES_BETWEEN_CHUNKS is False


@pytest.mark.unittest
@pytest.mark.parametrize("chunk", [1, 3, 4, 10])
def test_execute_chunked_matches_the_reference(chunk):
    """A batched function in chunks: the port fills its preallocated output
    as the reference does, and matches the whole batch."""
    import jax.numpy as jnp

    x = np.linspace(0.0, 2.0, 10)
    fn = lambda a, b: np.stack([np.cos(a) * b, np.sin(a)], axis=-1)  # noqa: E731
    ref = np.asarray(jmem.execute_chunked(lambda a, b: jnp.asarray(fn(np.asarray(a), b)),
                                          (jnp.asarray(x), 2.0), (0, None), 10, chunk))
    got = tmem.execute_chunked(lambda a, b: torch.as_tensor(fn(a.numpy(), b)),
                               (torch.as_tensor(x), 2.0), (0, None), 10, chunk)
    assert np.allclose(got.numpy(), ref, atol=1e-12)
    assert np.allclose(got.numpy(), fn(x, 2.0), atol=1e-15)


@pytest.mark.unittest
def test_gradients_flow_through_the_chunked_output():
    x = torch.linspace(0.1, 1.3, 7, dtype=torch.float64, requires_grad=True)
    out = tmem.execute_chunked(lambda a: torch.stack([a.sin(), a * a], -1), (x,), (0,), 7, 3)
    out.sum().backward()
    assert torch.allclose(x.grad, torch.cos(x.detach()) + 2 * x.detach(), atol=1e-14)


def _circuit(theta):
    to.RX(theta, wires=0)
    to.CRX(0.5 * theta, wires=[0, 1])
    to.RY(theta, wires=2)


@pytest.mark.unittest
def test_executor_chunks_by_the_estimate(monkeypatch):
    """The executor sizes a batch's chunks with compute_chunk_size on the
    Script's device and dtype and the plan's payload bytes (memoised per key
    and batch size), runs the batch in those chunks, recorded once, and
    equals the unchunked answer, its gradient included."""
    s = Script(_circuit, n_qubits=3, device="cpu", dtype=torch.float64)
    obs = [to.PauliZ(wires=w, record=False) for w in range(3)]
    thetas = torch.linspace(0.0, 2.0, 10, dtype=torch.float64, requires_grad=True)
    full = s.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    g_full, = torch.autograd.grad(full.square().sum(), thetas)
    seen = []

    def chunk(*a, **kw):
        seen.append(kw)
        return 3

    monkeypatch.setattr(tmem, "compute_chunk_size", chunk)
    records = []
    real = Script._record
    monkeypatch.setattr(Script, "_record", lambda self, *a, **k: records.append(1) or
                        real(self, *a, **k))
    s2 = Script(_circuit, n_qubits=3, device="cpu", dtype=torch.float64)
    got = s2.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    g, = torch.autograd.grad(got.square().sum(), thetas)
    s2.execute(type="expval", obs=obs, args=(thetas,), in_axes=(0,))
    # Memoised; a call records the batch and, to check it, its last element.
    assert len(seen) == 1 and len(records) == 4
    assert seen[0]["dtype"] == torch.float64 and seen[0]["payload_bytes"] > 0
    assert s2.routes == ["vectorised", "vectorised"]
    assert torch.allclose(got, full, atol=1e-14) and torch.allclose(g, g_full, atol=1e-13)


@pytest.mark.unittest
def test_chunked_density_batch_equals_unchunked(monkeypatch):
    """A 5q density batch of 20 in chunks of 5 (the shape of BASELINE.md:18's
    10q case, cut to the CPU) equals the unchunked one."""
    m = Model(n_qubits=5, n_layers=1, circuit_type="Circuit_19", device="cpu",
              dtype=torch.float64, random_seed=3)
    xs = torch.linspace(0, 2 * np.pi, 20, dtype=torch.float64)
    with torch.no_grad():
        whole = m(inputs=xs, execution_type="density")
        monkeypatch.setattr(tmem, "compute_chunk_size", lambda *a, **k: 5)
        m.script._chunks.clear()
        chunked = m(inputs=xs, execution_type="density")
    assert chunked.shape == (20, 32, 32)
    assert torch.allclose(chunked, whole, atol=1e-14)


@pytest.mark.unittest
def test_payload_bytes_count_the_plan():
    """The payload term is the plan's per-element bytes: each matrix step's
    K^2 entries as complex and as a real-split pair."""
    m = Model(n_qubits=6, n_layers=1, circuit_type="Circuit_19", device="cpu", random_seed=3)
    with to.recording() as tape:
        m._variational(m.params[0], torch.tensor([0.3]))
    slot = tsim.PlanSlot()
    got = tsim.payload_bytes(slot, tape, 6, False, torch.float32, "cpu")
    plan, _ = tsim.scheduled_plan(tape, 6)
    want = sum(16 * (2 ** len(w)) ** 2 for _, _, w in plan)
    assert got == want > 0
