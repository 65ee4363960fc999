"""A run whose timed path is broken underneath comes out not correct, on the
CPU at a small register (the look for a card skipped); the same run unbroken
comes out correct; the TF32 control fails the cell's limits."""

import torch
import pytest

from benchmark import control, run
from benchmark.lib import cells

CPU = torch.device("cpu")
SMALL = {"circuit19_24q.train": 5, "circuit19_13q_depol.serve": 4}


@pytest.fixture(autouse=True)
def _fresh_identities():
    """The program caches identity matrices first made under the serving
    loop's ``torch.inference_mode()``; on the CPU a later gradient in this
    process would use them as they are.  Each test starts without them."""
    from qml_essentials_tpu_torch.ops import operations

    yield
    operations._EYES.clear()


def _cell(name):
    cell = cells.load(name)
    cell["config"]["n_qubits"] = SMALL[name]
    return cell


def _execute(name, monkeypatch, patch_loop=None):
    cell = _cell(name)
    loop = cells.loop(cell["traffic"])
    if patch_loop is not None:
        patch_loop(loop)
    monkeypatch.setattr(cells, "loop", lambda traffic: loop)
    return run.execute(cell, 2**31 + 77, 0.5, False, CPU)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name, monkeypatch):
    result = _execute(name, monkeypatch)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = _execute("circuit19_24q.train", monkeypatch)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    def half(loop):
        loop.mse = lambda pred, y: ((pred - y)[: len(y) // 2] ** 2).mean()

    result = _execute("circuit19_24q.train", monkeypatch, half)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


def test_gradient_negated(monkeypatch):
    """Adam given the gradient's negative: the norms of the gradient and of
    the change are the same, the change's direction is not."""
    adam_step = torch.optim.Adam.step

    def ascent(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.neg_()
        return adam_step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", ascent)
    result = _execute("circuit19_24q.train", monkeypatch)
    assert not result["correct"]
    assert result["checks"]["step_gap"]["value"] == pytest.approx(2.0, rel=1e-3)


def test_stale_parameters(monkeypatch):
    """Every step run at the first step's parameter values (a cached plan
    that kept them), with the gradient still reaching the parameters."""
    from qml_essentials_tpu_torch import Model

    forward, first = Model.forward, {}

    def stale(self, *args, **kwargs):
        p = self.params
        held = first.setdefault("params", p.detach().clone())
        return forward(self, *args, params=held + (p - p.detach()), **kwargs)

    monkeypatch.setattr(Model, "forward", stale)
    result = _execute("circuit19_24q.train", monkeypatch)
    checks = result["checks"]
    assert not result["correct"]
    assert checks["later_loss_gap"]["value"] > checks["later_loss_gap"]["limit"]
    for name in ("loss_gap", "grad_gap", "change_gap", "step_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], name


def test_answer_altered(monkeypatch):
    from qml_essentials_tpu_torch import Model

    forward = Model.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs).clone()
        out[..., 0] += 1e-3
        return out

    monkeypatch.setattr(Model, "forward", altered)
    result = _execute("circuit19_13q_depol.serve", monkeypatch)
    assert not result["correct"]
    assert result["checks"]["expval_gap"]["value"] > result["checks"]["expval_gap"]["limit"]


def test_failed_requests_are_not_correct(monkeypatch):
    from qml_essentials_tpu_torch import Model

    forward, calls = Model.forward, []

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("planted failure")
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(Model, "forward", flaky)
    result = _execute("circuit19_13q_depol.serve", monkeypatch)
    assert result["failed"] > 0 and not result["correct"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_tf32_control_fails_the_limits(name):
    cell = _cell(name)
    got = control.control_readings(cell, cells.loop(cell["traffic"]), 2**31 + 3, CPU)
    limits = cell["limits"]
    assert set(got) == ({"control_tf32"} | (set(control.TRAIN_FAULTS)
                                            if cell["traffic"]["loop"] == "train" else set()))
    for kind, readings in got.items():
        assert any(readings[k] > limits[k] for k in limits), (kind, readings, limits)
