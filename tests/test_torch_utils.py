"""The PyTorch port's utils: generator splitting, the PauliCircuit
re-export, profiling and checkpointing (the cases of tests/test_utils.py on
the port, and what the port adds: the trace file, atomic saves, the model's
device and dtype on restore)."""

import json
import os

import numpy as np
import pytest
import torch

from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.utils import checkpointing, safe_random_split
from qml_essentials_tpu_torch.utils.checkpointing import (
    latest_step,
    restore_checkpoint,
    restore_model,
    save_checkpoint,
    save_model,
)
from qml_essentials_tpu_torch.utils.profiling import (
    TRACE_FILE,
    device_memory_stats,
    timed,
    xla_trace,
)


@pytest.mark.unittest
def test_safe_random_split_is_none_tolerant():
    assert safe_random_split(None) == (None, None)
    k1, k2 = safe_random_split(torch.Generator().manual_seed(0))
    assert isinstance(k1, torch.Generator) and isinstance(k2, torch.Generator)
    assert torch.rand(4, generator=k1).tolist() != torch.rand(4, generator=k2).tolist()


@pytest.mark.unittest
def test_pauli_circuit_reexport():
    from qml_essentials_tpu_torch.analysis.pauli import PauliCircuit as direct
    from qml_essentials_tpu_torch.utils import PauliCircuit

    assert PauliCircuit is direct
    assert hasattr(PauliCircuit, "from_parameterised_circuit")
    with pytest.raises(ImportError):
        from qml_essentials_tpu_torch.utils import NoSuchName  # noqa: F401


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_timed():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    stats = timed(f, torch.ones(8), iters=3, warmup=2)
    assert stats["compile_s"] > 0 and stats["mean_s"] > 0
    assert torch.equal(stats["result"], torch.full((8,), 2.0))
    assert len(calls) == 1 + 1 + 3


@pytest.mark.unittest
def test_memory_stats_are_empty_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


@pytest.mark.unittest
def test_xla_trace_writes_a_chrome_trace(tmp_path):
    model = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", device="cpu")
    with xla_trace(str(tmp_path / "trace")) as log_dir:
        model(inputs=0.3)
    assert log_dir == str(tmp_path / "trace")
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": {"c": np.float32(1.5)},
            "t": torch.arange(3, dtype=torch.float64), "l": [1, "x", (2.5,)]}
    target = save_checkpoint(str(tmp_path / "ckpt"), tree)
    back = restore_checkpoint(target)
    assert np.allclose(np.asarray(back["a"]), tree["a"])
    assert np.isclose(float(back["b"]["c"]), 1.5)
    assert torch.equal(back["t"], tree["t"])
    assert back["l"] == [1, "x", (2.5,)]


@pytest.mark.unittest
def test_versioned_steps(tmp_path):
    base = str(tmp_path / "run")
    assert latest_step(base) is None
    save_checkpoint(base, {"x": np.ones(2)}, step=1)
    save_checkpoint(base, {"x": np.ones(2) * 2}, step=5)
    os.makedirs(os.path.join(base, "step_notanumber"))
    assert latest_step(base) == 5
    assert np.allclose(np.asarray(restore_checkpoint(base, step=5)["x"]), 2.0)
    assert np.allclose(np.asarray(restore_checkpoint(base, step=1)["x"]), 1.0)


@pytest.mark.unittest
def test_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    """A save that fails halfway (torch.save raising after writing part of
    the file) leaves the earlier steps as they were and no step_<k>."""
    base = str(tmp_path / "run")
    save_checkpoint(base, {"x": np.ones(2)}, step=1)
    real_save = torch.save

    def crash(obj, f, *args, **kwargs):
        f.write(b"partial")
        raise OSError("disk went away")

    monkeypatch.setattr(checkpointing.torch, "save", crash)
    with pytest.raises(OSError, match="disk went away"):
        save_checkpoint(base, {"x": np.ones(2) * 7}, step=2)
    monkeypatch.setattr(checkpointing.torch, "save", real_save)
    assert sorted(os.listdir(base)) == ["step_1"]
    assert latest_step(base) == 1
    assert np.allclose(np.asarray(restore_checkpoint(base, step=1)["x"]), 1.0)


@pytest.mark.unittest
def test_model_roundtrip_gives_the_same_expvals(tmp_path):
    m = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", random_seed=1, device="cpu")
    original = m.params.detach().clone()
    with torch.no_grad():
        z0 = m(inputs=0.3)
    target = save_model(str(tmp_path / "model"), m, step=3)
    assert target.endswith("step_3")

    m.params = torch.zeros_like(m.params)
    restore_model(str(tmp_path / "model"), m, step=3)
    assert torch.equal(m.params, original)
    with torch.no_grad():
        assert torch.equal(m(inputs=0.3), z0)


@pytest.mark.unittest
def test_restore_model_takes_the_models_dtype(tmp_path):
    """A float32 checkpoint restored into a float64 model comes back in
    float64 on the model's device."""
    src = Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", random_seed=2,
                trainable_frequencies=True, device="cpu")
    src.enc_params.data = src.enc_params.data * 1.5
    target = save_model(str(tmp_path / "model"), src)
    dst = Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19", random_seed=9,
                trainable_frequencies=True, device="cpu", dtype=torch.float64)
    restore_model(target, dst)
    for name in ("params", "enc_params", "pulse_params"):
        got, want = getattr(dst, name), getattr(src, name)
        assert got.dtype == torch.float64 and got.device == dst.device
        assert torch.equal(got, want.double()), name
    assert dst.enc_params.requires_grad
