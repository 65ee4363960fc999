"""The chain route of the PyTorch port (``simulation.USE_CHAINS``) against
the JAX package.

- Planner: the port's ``plan_chains`` gives the JAX package's chain plan
  step for step (geometries, descriptors, wires; payloads to 1e-6) on the
  Circuit_19 tape at 18, 22 and 24 qubits, and ``None`` at 26 qubits; the
  seam decompositions of the ring-wrap entanglers match.
- Kernels: the plain versions of B17 ``chain_apply`` and B18
  ``adjoint_chain`` against the JAX Pallas kernels in interpret mode, on one
  L and one H step of the 18-qubit plan (state 5e-5 relative: the Pallas
  ``split3`` products; cotangents 1e-4 relative).
- The slice: an 18-qubit Circuit_19 model with the chain route on, on the
  CPU, against the JAX model with the same weights (its default plain path):
  <Z> to 1e-5, the adjoint gradient and the ``"auto"`` gradient (the chain
  steps' expansion) to 1e-4 of max|g|, with the wrappers each one called.
- Routing: one ``chain_apply`` per chain step without a gradient, the saved
  executor refuses chain plans, the chain plan starts from |0...0>, and with
  the flag off nothing of the route runs.

The large-state regime is lowered to 18 qubits (the narrowest register the
L geometry of 17 bits leaves a block index in) in the port, and the JAX
kernels run as ``tests/test_chains.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import chains as jchains
from qml_essentials_tpu.ops import operations as jops
from qml_essentials_tpu.ops import pallas_kernels
from qml_essentials_tpu.ops import simulation as jsim
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch.models.model import Model
from qml_essentials_tpu_torch.ops import adjoint, chains, cuda_kernels, kernels, saved
from qml_essentials_tpu_torch.ops import operations as tops
from qml_essentials_tpu_torch.ops import simulation as tsim
from qml_essentials_tpu_torch.ops.tape import recording

torch.set_num_threads(2)

N = 18
X = 0.37
PAYLOAD_TOL = 1e-6  # complex64 compositions in both packages
STATE_TOL = 5e-5  # relative: the Pallas split3 products against fp32 matmuls
GRAD_TOL = 1e-4  # relative: fp32 sums over 2^18 amplitudes in other orders
FWD_TOL = 1e-5  # <Z>, float32 through the whole circuit on both sides


def _models(n):
    jm = JaxModel(n_qubits=n, n_layers=2, circuit_type="Circuit_19", random_seed=5)
    tm = Model(n_qubits=n, n_layers=2, circuit_type="Circuit_19", device="cpu")
    tm.load_numpy(np.asarray(jm.params), np.asarray(jm.enc_params))
    return jm, tm


def _tapes(n):
    """The Circuit_19 tape of both packages for input X, same weights."""
    jm, tm = _models(n)
    with jax_recording() as jt:
        jm._variational(jnp.asarray(np.asarray(jm.params[0])), jnp.array([X]), noise_params=None)
    with recording() as tt, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([X]))
    return jt, tt


def _port_tape(n):
    tm = Model(n_qubits=n, n_layers=2, circuit_type="Circuit_19", random_seed=5, device="cpu")
    with recording() as tape, torch.no_grad():
        tm._variational(tm.params[0], torch.tensor([X]))
    return tape


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("n", [18, 22, 24, 26])
def test_plan_chains_matches_jax(n):
    jt, tt = _tapes(n)
    jplan, tplan = jchains.plan_chains(jt, n), chains.plan_chains(tt, n)
    if n == 26:
        # Wire 8 lies in neither region (L: wires >= n - 17 = 9, H: < 8).
        assert jplan is None and tplan is None
        return
    assert tplan is not None and len(tplan) == len(jplan) == 9
    for (jk, (jg, jd, jp), jw), (tk, (tg, td, tp), tw) in zip(jplan, tplan):
        assert tk == jk == "chain"
        assert tg == jg and td == jd and list(tw) == list(jw)
        assert len(tp) == len(td)
        for a, b in zip(jp, tp):
            assert b.dtype == torch.complex64 and tuple(b.shape) == np.asarray(a).shape
            assert np.abs(b.numpy() - np.asarray(a)).max() <= PAYLOAD_TOL


@pytest.mark.unittest
def test_the_24_qubit_plan():
    """The main path's chain plan: 9 steps, H and L in turns, 23 windows
    (sum of K 4992) and 3 two-bit diagonals."""
    win, diag = (lambda lo, hi: ("win", lo, hi)), (lambda *b: ("diag", b))
    L4 = (win(0, 8), win(7, 15), win(0, 8), win(7, 14), win(9, 17))
    H5 = (win(16, 24), diag(23, 0), win(17, 24))
    want = [
        (("H", 8), (win(16, 24),)),
        (("L", 17), (win(10, 17), win(0, 8), win(8, 16))),
        (("H", 8), (diag(23, 0), win(17, 24))),
        (("L", 17), L4), (("H", 8), H5), (("L", 17), L4), (("H", 8), H5),
        (("L", 17), (win(0, 8), win(7, 15), win(10, 17))),
        (("H", 8), (win(16, 24),)),
    ]
    plan = chains.plan_chains(_port_tape(24), 24)
    assert [(geom, descs) for _, (geom, descs, _), _ in plan] == want
    descs = [d for _, (_, ds, _), _ in plan for d in ds]
    assert sum(2 ** (d[2] - d[1]) for d in descs if d[0] == "win") == 4992
    assert sum(d[0] == "diag" for d in descs) == 3


_SEAM_GATES = [
    ("CRX", (0.73,)), ("CRY", (-1.21,)), ("CRZ", (0.4,)), ("CX", ()), ("CY", ()), ("CZ", ()),
    ("ControlledPhaseShift", (0.9,)), ("RXX", (0.61,)), ("RYY", (-0.5,)), ("RZZ", (1.3,)),
    ("RZX", (0.8,)),
]


@pytest.mark.unittest
@pytest.mark.parametrize("name,args", _SEAM_GATES, ids=[g for g, _ in _SEAM_GATES])
def test_seam_decomposition_matches_jax(name, args):
    """A ring-wrap entangler splits into the same (conjugators, diagonal,
    conjugators^dag) items as in the JAX package, and they rebuild it."""
    wires = [N - 1, 0]
    tg = getattr(tops, name)(*args, wires=wires, record=False)
    jg = getattr(jops, name)(*args, wires=wires, record=False)
    titems, jitems = chains._decompose_seam(tg), jchains._decompose_seam(jg)
    assert titems is not None and len(titems) == len(jitems)
    m = np.eye(4, dtype=np.complex128)
    for (tk, tp, tw), (jk, jp, jw) in zip(titems, jitems):
        assert tk == jk and list(tw) == list(jw)
        tp = tp.resolve_conj().numpy()
        assert np.abs(tp - np.asarray(jp)).max() <= PAYLOAD_TOL
        if tk == "diag":
            full = np.diag(tp)
        else:
            full = np.kron(tp, np.eye(2)) if tw[0] == wires[0] else np.kron(np.eye(2), tp)
        m = full @ m
    assert np.abs(m - tg.matrix.numpy()).max() <= PAYLOAD_TOL


@pytest.mark.unittest
def test_plan_chains_refuses_what_it_cannot_express():
    """A wrap gate with no conjugator form (SWAP, a three-wire CCX) gives
    ``None`` in both packages, as a noise channel does (for the port:
    tests/test_torch_density.py)."""
    for make in (lambda ops: ops.SWAP(wires=[N - 1, 0]),
                 lambda ops: ops.CCX(wires=[N - 1, 0, 1])):
        with recording() as tt:
            tops.RY(0.3, wires=0)
            make(tops)
        with jax_recording() as jt:
            jops.RY(0.3, wires=0)
            make(jops)
        assert chains.plan_chains(tt, N) is None and jchains.plan_chains(jt, N) is None
    with jax_recording() as jt:
        jops.RY(0.3, wires=0)
        jops.BitFlip(0.1, wires=0)
    assert jchains.plan_chains(jt, N) is None
    assert chains.plan_chains([], N) == []
    assert chains.plan_chains(_port_tape(N - 1), N - 1) is None  # no block index bit


# ---------------------------------------------------------------------------
# The plain kernels against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps18():
    """The 18-qubit plan's first 5-window L step and first H step with a
    diagonal, as (geom, descs, payload pairs), and a numpy-seeded ψ, λ."""
    plan = chains.plan_chains(_port_tape(N), N)
    picked = {}
    for _, (geom, descs, pays), _ in plan:
        key = "L" if geom[0] == "L" and len(descs) == 5 else (
            "H" if geom[0] == "H" and any(d[0] == "diag" for d in descs) else None)
        if key and key not in picked:
            picked[key] = (geom, descs, [torch.stack([p.real, p.imag]).contiguous() for p in pays])
    rng = np.random.default_rng(1)
    psi, lam = (rng.normal(size=(2, 2**N)).astype(np.float32) for _ in range(2))
    return picked, psi / np.linalg.norm(psi), lam / np.linalg.norm(lam)


@pytest.fixture
def pallas_chains(monkeypatch):
    """The JAX chain kernels in interpret mode, as tests/test_chains.py runs
    them (full-precision grams)."""
    monkeypatch.setattr(pallas_kernels, "ENABLED", True)
    monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_N", N)
    monkeypatch.setattr(pallas_kernels, "INTERPRET", True)
    monkeypatch.setattr(pallas_kernels, "GRAM_MODE", "split3")


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.unittest
@pytest.mark.parametrize("geom", ["L", "H"])
def test_chain_apply_plain_matches_pallas(pallas_chains, steps18, geom):
    picked, psi, _ = steps18
    g, descs, pairs = picked[geom]
    ref = pallas_kernels.chain_apply_ri(jnp.asarray(psi), [jnp.asarray(p.numpy()) for p in pairs],
                                        g, descs, N, interpret=True)
    got = kernels.chain_apply_plain(torch.from_numpy(psi), pairs, g, descs, N)
    assert got.shape == (2, 2**N) and got.dtype == torch.float32
    assert _rel(got, ref) <= STATE_TOL
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(cuda_kernels.chain_apply(torch.from_numpy(psi), pairs, g, descs, N), got)


@pytest.mark.unittest
@pytest.mark.parametrize("geom", ["L", "H"])
def test_adjoint_chain_plain_matches_pallas(pallas_chains, steps18, geom):
    picked, psi, lam = steps18
    g, descs, pairs = picked[geom]
    rp, rl, rg = pallas_kernels.adjoint_chain_ri(
        jnp.asarray(psi), jnp.asarray(lam), [jnp.asarray(p.numpy()) for p in pairs], g, descs,
        N, interpret=True)
    gp, gl, gg = kernels.adjoint_chain_plain(torch.from_numpy(psi), torch.from_numpy(lam),
                                             pairs, g, descs, N)
    assert _rel(gp, rp) <= STATE_TOL and _rel(gl, rl) <= STATE_TOL
    assert len(gg) == len(descs)
    for d, a, b, p in zip(descs, gg, rg, pairs):
        assert a.shape == p.shape, d
        assert _rel(a, b) <= GRAD_TOL, d
    # The reverse walk undoes the forward: ψ_prev is the step's input.
    back = kernels.adjoint_chain_plain(
        kernels.chain_apply_plain(torch.from_numpy(psi), pairs, g, descs, N),
        torch.from_numpy(lam), pairs, g, descs, N)[0]
    assert _rel(back, psi) <= STATE_TOL


# ---------------------------------------------------------------------------
# The slice: an 18-qubit model through the chain route
# ---------------------------------------------------------------------------

SPIED = ("chain_apply", "adjoint_chain", "window_apply", "window_apply_top", "window_apply_bwd",
         "window_apply_top_bwd", "adjoint_step", "adjoint_step_top")


def _spy(mp, calls):
    for name in SPIED:
        def spy(*args, _f=getattr(cuda_kernels, name), _name=name):
            calls.append(_name)
            return _f(*args)

        mp.setattr(cuda_kernels, name, spy)


@pytest.fixture(scope="module")
def chain_slice():
    """The JAX model's <Z> and gradient of the mean <Z> (float32, one jit:
    eager dispatch would compile each primitive on its own), and the port's
    with the chain route on: the forward, the adjoint gradient and the
    ``"auto"`` gradient, each with the wrappers it called."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        pulse_state = PulseInformation.snapshot_state()
        jm, tm = _models(N)
        PulseInformation.restore_state(pulse_state)  # JaxModel() sets the global pulse envelope

        def loss(p):
            z = jm(p, inputs=np.array([X]))
            return z.mean(), z

        (_, z), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jm.params)
        out["jax"] = (np.asarray(z, np.float64), np.asarray(g, np.float64))

        mp.setattr(tsim, "LARGE_STATE_MIN_N", N)
        mp.setattr(tsim, "USE_CHAINS", True)
        mp.setattr(saved, "LAMBDA_MODE", "f32")
        calls = []
        _spy(mp, calls)
        with torch.no_grad():
            out["forward"] = (tm(inputs=X).double().numpy(), list(calls))
        for mode in ("adjoint", "auto"):
            calls.clear()
            mp.setattr(tsim, "BACKWARD_MODE", mode)
            tm.params.grad = None
            tm(inputs=X).mean().backward()
            out[mode] = (tm.params.grad.double().numpy(), list(calls))
    return out


@pytest.mark.unittest
def test_chain_slice_forward_matches_jax(chain_slice):
    z_jax, _ = chain_slice["jax"]
    z, called = chain_slice["forward"]
    assert z.shape == z_jax.shape == (N,)
    assert np.abs(z - z_jax).max() <= FWD_TOL
    assert called == ["chain_apply"] * 9  # one launch per chain step, nothing else


@pytest.mark.unittest
@pytest.mark.parametrize("mode", ["adjoint", "auto"])
def test_chain_slice_gradient_matches_jax(chain_slice, mode):
    """``"adjoint"`` keeps the chain steps (9 chain_apply forward, 9
    adjoint_chain back); ``"auto"`` under the residual line goes to the
    per-step loop over the steps' expansion, one window kernel per window
    (no chain kernel)."""
    _, g_jax = chain_slice["jax"]
    g, called = chain_slice[mode]
    assert g.shape == g_jax.shape
    assert np.abs(g - g_jax).max() <= GRAD_TOL * np.abs(g_jax).max()
    if mode == "adjoint":
        assert sorted(called) == ["adjoint_chain"] * 9 + ["chain_apply"] * 9
    else:
        assert called and not {"chain_apply", "adjoint_chain"} & set(called)
        windows = [d for _, (_, ds, _), _ in chains.plan_chains(_port_tape(N), N)
                   for d in ds if d[0] == "win"]
        fwd = [c for c in called if c in ("window_apply", "window_apply_top")]
        assert len(fwd) == len(windows)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.fixture
def chain_route(monkeypatch):
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    monkeypatch.setattr(tsim, "USE_CHAINS", True)
    return monkeypatch


@pytest.mark.unittest
def test_chain_plan_starts_from_zero_and_runs_one_kernel_per_step(chain_route):
    tape = _port_tape(N)
    chain_route.setattr(tsim, "_zero_state_prefix", lambda *a: pytest.fail("prefix peeled"))
    plan, start = tsim.scheduled_plan(tape, N)
    assert start is None and [k for k, _, _ in plan] == ["chain"] * 9
    calls = []
    _spy(chain_route, calls)
    with torch.no_grad():
        got = tsim.simulate_pure_ri(tape, N)
    assert calls == ["chain_apply"] * 9
    chain_route.undo()  # the plain regime's plan
    ref = tsim.simulate_pure_ri(tape, N)
    assert np.abs(got.numpy() - ref.numpy()).max() <= FWD_TOL


@pytest.mark.unittest
def test_saved_executor_refuses_chain_plans(chain_route):
    plan, _ = tsim.scheduled_plan(_port_tape(N), N)
    static, payloads = adjoint.normalize_plan(plan, N)
    assert [s[0] for s in static] == ["chain"] * 9
    assert len(payloads) == sum(len(s[2]) for s in static)
    assert not saved.usable(plan, N) and not saved.usable(static, N)
    # Below the regime the adjoint executor expands the steps instead.
    chain_route.setattr(tsim, "LARGE_STATE_MIN_N", N + 1)
    static, _ = adjoint.normalize_plan(plan, N)
    assert {s[0] for s in static} <= {"mat", "diag"} and len(static) == len(payloads)
    assert saved.usable((("mat", (0, 1)),), N + 1)


@pytest.mark.unittest
def test_flag_off_leaves_the_scheduled_plan(monkeypatch):
    tape = _port_tape(N)
    monkeypatch.setattr(tsim, "LARGE_STATE_MIN_N", N)
    assert not tsim.USE_CHAINS  # off by default, as in the JAX package
    assert not jsim.USE_CHAINS
    monkeypatch.setattr(chains, "plan_chains", lambda *a: pytest.fail("planned chains"))
    plan, start = tsim.scheduled_plan(tape, N)
    assert start is not None and "chain" not in {k for k, _, _ in plan}
    calls = []
    _spy(monkeypatch, calls)
    with torch.no_grad():
        tsim.simulate_pure_ri(tape, N)
    assert calls and not {"chain_apply", "adjoint_chain"} & set(calls)
