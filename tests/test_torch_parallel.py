"""The port's sharded simulators and mesh routes against the JAX package.

The JAX side runs on its virtual 8-CPU mesh (``tests/conftest.py``) in
float64 (x64).  The port runs in one module-scoped pool of four ``gloo``
ranks (:mod:`torch_parallel_ranks`, a ``file://`` store under the test's
temporary directory), in float64; every rank answers, and the ranks must
agree.  Checked:

* exact equality of the host plans: ``_plan_layout``, ``_fused_ops``' wire
  lists (and their matrices to 1e-12), ``_measurement_exchange`` (unsorted
  pairs included), the Z-word helpers;
* the exchange against its definition (pairs swapped), both forms, batched,
  unsorted pairs;
* outputs (expval over Z-words and general Hermitians, probs, state,
  density) to 1e-10 and gradients to 1e-8·max|g|, on ``state=4`` and
  ``data=2 × state=2`` meshes, batched and not, both batched exchange
  forms, the adjoint and the checkpointed residual backward (>= 16 steps),
  the sharded density engine on noisy 4-5 qubit tapes (BitFlip,
  Depolarizing, AmplitudeDamping), ``Model`` with parameters carried over
  by ``load_numpy``, and a pure ``data=4`` mesh;
* shots by distribution (both within 1e-2 of the exact values, equal
  shapes; 200,000 shots, at which 1e-2 is >= 4.5 standard errors of a
  ⟨Z⟩ estimate);
* the route log and ``explain`` text equal to the JAX package's, fallbacks
  included, a repeated signature building no second host plan, and one
  warning per fallback reason.
"""

import pickle
from contextlib import contextmanager
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from qml_essentials_tpu import parallel as jpar
from qml_essentials_tpu.core.executor import Script as JaxScript
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.ops.tape import recording as jax_recording
from qml_essentials_tpu.parallel import state_sharding as jss
from qml_essentials_tpu.pulse.pulses import PulseInformation as JaxPulseInformation

OUT_TOL = 1e-10
GRAD_REL = 1e-8
SHOT_TOL = 1e-2
SHOTS = 200_000
STATE4 = ((4,), ("state",))
COMPOSED = ((2, 2), ("data", "state"))
DATA4 = ((4,), ("data",))
MIXED_OBS = (("PauliX", 0), ("Hermitian", 3, (0, 3)), ("PauliZ", 2), ("PauliY", 4))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(4, str(tmp_path_factory.mktemp("gloo")))
    yield pool
    pool.close()


@pytest.fixture(autouse=True)
def jax_pulse_state():
    """A JAX Model's constructor sets the global pulse envelope."""
    state = JaxPulseInformation.snapshot_state()
    yield
    JaxPulseInformation.restore_state(state)


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128, as they are when the package is imported under x64: a
    constant the port holds too (``H``'s 1/sqrt(2)) takes the port's
    float64 values, which the complex64 constant only rounds, and the Pauli
    matrices the rotation classes keep in their closures are promoted."""
    import torch  # noqa: F401

    from qml_essentials_tpu_torch.ops import operations as to

    promoted, cells, entries = {}, [], []
    jax.config.update("jax_enable_x64", True)
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                twin = vars(getattr(to, cls.__name__, object)).get("_matrix")
                exact = None if twin is None else twin.detach().numpy()
                if exact is not None and exact.shape == m.shape and np.allclose(exact, m,
                                                                                atol=1e-6):
                    cls._matrix = jnp.asarray(exact, dtype=jnp.complex128)
                else:
                    cls._matrix = m.astype(jnp.complex128)
        # Pauli matrices in tables (PauliRot's map, the module's) and in the
        # rotation classes' closures.
        tables = [vars(c) for c in vars(jo).values() if isinstance(c, type)] + [vars(jo)]
        for table in tables:
            for v in list(table.values()):
                if isinstance(v, (dict, list)):
                    keys = v.keys() if isinstance(v, dict) else range(len(v))
                    for k in keys:
                        if getattr(v[k], "dtype", None) == jnp.complex64:
                            entries.append((v, k, v[k]))
                            v[k] = v[k].astype(jnp.complex128)
        for cls in vars(jo).values():
            init = vars(cls).get("__init__") if isinstance(cls, type) else None
            for cell in getattr(init, "__closure__", None) or ():
                v = cell.cell_contents
                if getattr(v, "dtype", None) == jnp.complex64:
                    cells.append((cell, v))
                    cell.cell_contents = v.astype(jnp.complex128)
        yield
    finally:
        for cell, v in cells:
            cell.cell_contents = v
        for v, k, m in reversed(entries):
            v[k] = m
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


def _jax_mesh(spec):
    return None if spec is None else jpar.make_mesh(spec[0], spec[1])


_JAX_ANSWERS: dict = {}


def jax_requests(circuit, n_qubits, mesh_spec, requests, routes=True):
    key = pickle.dumps((circuit, n_qubits, mesh_spec if routes else None, requests, routes))
    if key not in _JAX_ANSWERS:
        _JAX_ANSWERS[key] = _jax_requests(circuit, n_qubits, mesh_spec, requests, routes)
    return _JAX_ANSWERS[key]


def _jax_requests(circuit, n_qubits, mesh_spec, requests, routes):
    """The JAX counterpart of :func:`torch_parallel_ranks.script_requests`.

    The numbers (outputs, and d sum(output) / d args[0] where asked) come
    from the JAX package's single-device route in float64: its sharded
    programs return expectation values in float32 whatever x64 says.  With
    *routes*, the forward requests run again on the JAX mesh for the route
    log, ``explain`` and the sharded answers (``"sharded"``)."""
    f = R.CIRCUITS[circuit]

    def arrays(args):
        return tuple(jnp.asarray(a) if isinstance(a, (float, np.ndarray)) else a for a in args)

    def run(script):
        outs = []
        for type, obs_specs, args, in_axes, shots, grad in requests:
            obs = R.observables(jo, obs_specs, jnp.asarray)
            key = jax.random.PRNGKey(5) if shots else None
            try:
                outs.append(np.asarray(script.execute(type=type, obs=obs, args=arrays(args),
                                                      in_axes=in_axes, shots=shots, key=key)))
            except ValueError as e:  # the single-device path refuses the request
                outs.append(f"ValueError: {e}")
        return outs

    out = {}
    with jax_x64():
        script = JaxScript(lambda *a: f(jo, *a), n_qubits=n_qubits)
        answers = [[o, None] for o in run(script)]
        for i, (type, obs_specs, args, in_axes, shots, grad) in enumerate(requests):
            if grad:
                obs = R.observables(jo, obs_specs, jnp.asarray)
                rest = arrays(args[1:])

                def loss(a0, obs=obs, rest=rest, type=type, in_axes=in_axes):
                    return jnp.sum(script.execute(type=type, obs=obs, args=(a0,) + rest,
                                                  in_axes=in_axes))

                answers[i][1] = np.asarray(jax.grad(loss)(jnp.asarray(args[0])))
        out["answers"] = answers
        if routes:
            script = JaxScript(lambda *a: f(jo, *a), n_qubits=n_qubits)
            jpar.set_mesh(_jax_mesh(mesh_spec))
            try:
                out["sharded"] = run(script)
                out["decisions"] = list(script.sharding_decisions)
                out["explain"] = jpar.explain(script)
            finally:
                jpar.set_mesh(None)
    return out


def _agree(answers):
    """Every rank returned the same answer; rank 0's."""
    first = answers[0]
    for other in answers[1:]:
        for (a, ga), (b, gb) in zip(first["answers"], other["answers"]):
            np.testing.assert_array_equal(a, b)
            if ga is not None:
                np.testing.assert_array_equal(ga, gb)
        assert other["decisions"] == first["decisions"]
    return first


def _close(got, ref, tol=OUT_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _grad_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_REL * np.abs(ref).max())


def _both(ranks, circuit, n, mesh, requests, knobs=None, routes=True):
    port = _agree(ranks.run("script_requests", circuit, n, mesh, requests, knobs))
    ref = jax_requests(circuit, n, mesh, requests, routes)
    for (out, g), (rout, rg) in zip(port["answers"], ref["answers"]):
        _close(out, rout)
        if rg is not None:
            _grad_close(g, rg)
    return port, ref


# ---------------------------------------------------------------------------
# Host plans: exact equality
# ---------------------------------------------------------------------------


def _wire_lists(rng, n, T):
    out = []
    for _ in range(T):
        k = int(rng.integers(1, 4))
        out.append([int(w) for w in rng.choice(n, size=k, replace=False)])
    return out


@pytest.mark.unittest
@pytest.mark.parametrize("seed", range(6))
def test_plan_layout_matches_jax(seed):
    from qml_essentials_tpu_torch.parallel import state_sharding as tss

    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 9))
    g = int(rng.integers(1, 4))
    wires = _wire_lists(rng, n, 40)
    assert tss._plan_layout(wires, n, g) == jss._plan_layout(wires, n, g)
    too_wide = [list(range(n - g + 1))]
    with pytest.raises(tss.ShardingUnavailable):
        tss._plan_layout([[0, 1, 2]] + too_wide, n, n - 1)
    with pytest.raises(jss.ShardingUnavailable):
        jss._plan_layout([[0, 1, 2]] + too_wide, n, n - 1)


_GATES = (("H", 1), ("RX", 1), ("RY", 1), ("CX", 2), ("CZ", 2), ("RXX", 2), ("CRZ", 2),
          ("CCX", 3), ("CSWAP", 3))


def _random_tape(ops, rng_seed, n, T, tensor):
    from qml_essentials_tpu_torch.ops.tape import recording

    rng = np.random.default_rng(rng_seed)
    with (jax_recording() if ops is jo else recording()) as tape:
        for _ in range(T):
            name, k = _GATES[int(rng.integers(len(_GATES)))]
            wires = [int(w) for w in rng.choice(n, size=k, replace=False)]
            cls = getattr(ops, name)
            if name in ("RX", "RY", "RXX", "CRZ"):
                cls(tensor(float(rng.uniform(0, np.pi))), wires=wires)
            else:
                cls(wires=wires)
    return tape


@pytest.mark.unittest
@pytest.mark.parametrize("seed", range(4))
def test_fused_ops_match_jax(seed):
    import torch

    from qml_essentials_tpu_torch.ops import operations as to
    from qml_essentials_tpu_torch.parallel import state_sharding as tss

    n, g = 6 + seed % 2, 1 + seed % 3
    with jax_x64():
        jt = _random_tape(jo, seed, n, 30, lambda x: jnp.asarray(x))
        jf = jss._fused_ops(jt, n, g)
        jw = [list(op.wires) for op in jf]
        jm = [np.asarray(op.matrix) for op in jf]
    tt = _random_tape(to, seed, n, 30, lambda x: torch.tensor(x, dtype=torch.float64))
    tf = tss._fused_ops(tt, n, g, dtype=torch.complex128)
    assert [list(op.wires) for op in tf] == jw
    for a, b in zip(tf, jm):
        np.testing.assert_allclose(a.matrix.numpy(), b, rtol=0, atol=1e-12)


@pytest.mark.unittest
@pytest.mark.parametrize("seed", range(4))
def test_measurement_exchange_matches_jax(seed):
    from qml_essentials_tpu_torch.parallel import state_sharding as tss

    rng = np.random.default_rng(seed)
    n, g = 7, 3
    stub = SimpleNamespace(n=n, g=g)
    for _ in range(20):
        order = [int(q) for q in rng.permutation(n)]
        k = int(rng.integers(1, 4))
        wires = [int(w) for w in rng.choice(n, size=k, replace=False)]
        got = tss.ShardedStateSim._measurement_exchange(stub, order, wires)
        assert got == jss.ShardedStateSim._measurement_exchange(stub, order, wires)
    # Two sharded wires listed against their positions: unsorted pairs.
    order = list(range(n))
    pairs, _ = tss.ShardedStateSim._measurement_exchange(stub, order, [2, 0])
    assert [p for p, _ in pairs] == [2, 0]
    assert pairs == jss.ShardedStateSim._measurement_exchange(stub, order, [2, 0])[0]


@pytest.mark.unittest
def test_zword_helpers_match_jax():
    import torch

    from qml_essentials_tpu_torch.ops import operations as to
    from qml_essentials_tpu_torch.parallel import state_sharding as tss

    for word in [(0, 0), (0, 0, 1), (3, 1, 3, 2), ()]:
        assert tss.reduce_zword(word) == jss.reduce_zword(word)
    specs = (("PauliZ", 2), ("PauliX", 1), ("ZZ", (0, 0, 1)), ("Hermitian", 1, (0,)))
    with jax_x64():
        jobs = R.observables(jo, specs, jnp.asarray)
        want = [jss.zword_of(o) for o in jobs]
    tobs = R.observables(to, specs, lambda a: torch.as_tensor(a))
    assert [tss.zword_of(o) for o in tobs] == want
    from qml_essentials_tpu_torch.core.jaqsi import build_parity_observable as tb
    from qml_essentials_tpu.core.jaqsi import build_parity_observable as jb

    assert tss.zword_of(tb([0, 1, 2])) == jss.zword_of(jb([0, 1, 2]))


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_exchanges_swap_the_positions(ranks):
    pairs = ([[0, 2]], [[1, 4]], [[0, 3], [1, 2]], [[1, 2], [0, 4]], [[1, 4], [0, 3]])
    cases = [(p, b, f) for p in pairs for b in (None, 3) for f in ("a2a", "ppermute")]
    for errs in ranks.run("exchanges", 5, 4, cases):
        assert errs == [0.0] * len(cases)


@pytest.mark.unittest
@pytest.mark.parametrize("piece_bytes", [64, 16])
def test_exchanges_in_pieces_swap_the_positions(ranks, piece_bytes):
    """A shard larger than ``EXCHANGE_PIECE_BYTES`` moves in pieces, one
    collective a piece: 64 bytes cuts the Re/Im and batch dims, 16 bytes
    the runs of local positions too."""
    pairs = ([[0, 2]], [[0, 3], [1, 2]], [[1, 4], [0, 3]], [[1, 5], [0, 6]])
    cases = [(p, b, f) for p in pairs for b in (None, 3) for f in ("a2a", "ppermute")]
    for errs in ranks.run("exchanges", 7, 4, cases, piece_bytes):
        assert errs == [0.0] * len(cases)


@pytest.mark.unittest
def test_every_rank_holds_only_its_shard(ranks):
    """At 14 qubits on ``state=4`` no rank creates a tensor as large as the
    whole real-split register (2 * 2**14 elements) while it builds the
    model, runs a forward and a forward + gradient; and the exchanges in
    1 KiB pieces give the same answers, bit for bit."""
    n = 14
    params = np.random.default_rng(3).uniform(0, 2 * np.pi, (3, 3 * n))
    for a in ranks.run("largest_tensors", n, params, 0.37):
        assert a["decisions"] and all(r == "sharded:state" or r == "sharded:cached"
                                      for _, r in a["decisions"])
        for what in ("forward", "gradient"):
            numel, op = a[what]
            assert numel < 2 * 2**n, (what, numel, op)
        whole, pieces = a["answers"][None], a["answers"][1024]
        np.testing.assert_array_equal(whole[0], pieces[0])
        np.testing.assert_array_equal(whole[1], pieces[1])


@pytest.mark.unittest
def test_sharded_routes_read_no_free_memory(ranks):
    """No sharded request reads free memory: each rank's would differ, and
    a choice made from it could send the ranks down different collectives."""
    params = np.random.default_rng(5).uniform(0, 2 * np.pi, (2, 12))
    inputs = np.linspace(-1.0, 1.0, 4).reshape(-1, 1)
    for a in ranks.run("free_memory_reads", 4, params, inputs):
        assert a["reads"] == 0
        assert len(a["decisions"]) == 3
        assert all(r.startswith("sharded:") for _, r in a["decisions"]), a["decisions"]


# ---------------------------------------------------------------------------
# Outputs and gradients
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_state_mesh_matches_jax(ranks):
    requests = [
        ("expval", MIXED_OBS, (0.7,), None, None, True),
        ("expval", (("PauliZ", 0), ("ZZ", (0, 4))), (0.4,), None, None, False),
        ("state", (), (0.7,), None, None, False),
        ("probs", (), (0.7,), None, None, False),
        ("density", (), (0.7,), None, None, False),
    ]
    port, _ = _both(ranks, "circ5", 5, STATE4, requests, routes=False)
    assert all(r == "sharded:state" for _, r in port["decisions"])


def _batch(B=8, seed=11):
    return np.random.default_rng(seed).uniform(0.0, np.pi, (B, 5))


@pytest.mark.unittest
def test_composed_mesh_batches_match_jax(ranks):
    ps = _batch()
    requests = [
        ("expval", MIXED_OBS, (ps,), (0,), None, True),
        ("probs", (), (ps,), (0,), None, False),
        ("state", (), (ps,), (0,), None, False),
        ("density", (), (ps,), (0,), None, False),
        ("expval", (("PauliZ", 1),), (ps[0],), None, None, True),
    ]
    port, _ = _both(ranks, "layered", 5, COMPOSED, requests, routes=False)
    assert all(r == "sharded:state" for _, r in port["decisions"])
    assert "data=2 × state=2" in port["explain"]


@pytest.mark.unittest
@pytest.mark.parametrize("form", ["a2a", "ppermute"])
def test_batched_exchange_forms_match_jax(ranks, form):
    ps = _batch(4, seed=3)
    requests = [("expval", (("PauliY", 0), ("Hermitian", 3, (0, 3))), (ps,), (0,), None, True)]
    _both(ranks, "layered", 5, STATE4, requests,
          {"qml_essentials_tpu_torch.parallel.state_sharding.BATCHED_EXCHANGE": form},
          routes=False)


@pytest.mark.unittest
@pytest.mark.parametrize("adjoint", [True, False])
def test_adjoint_and_checkpointed_backward_match_jax(ranks, adjoint):
    """The residual branch runs checkpoint segments from 16 steps; the plan
    has more."""
    assert ranks.run("plan_length", "deep", 6, 2, (0.3,))[0] >= 16
    requests = [("expval", (("PauliZ", 0), ("Hermitian", 5, (1, 4))), (0.3,), None, None, True)]
    _both(ranks, "deep", 6, STATE4, requests,
          {"qml_essentials_tpu_torch.parallel.state_sharding.ADJOINT": adjoint}, routes=False)


def _jax_model(n, layers):
    with jax_x64():
        m = JaxModel(n_qubits=n, n_layers=layers, circuit_type="Circuit_19", random_seed=7)
        return m, np.asarray(m.params)


def _jax_model_answer(m, inputs, noise=None, grad=True):
    """The JAX Model's float64 output (and gradient) on its single-device
    route."""
    with jax_x64():
        x = jnp.asarray(inputs)

        def loss(p):
            return jnp.sum(m(p, inputs=x, noise_params=noise))

        out = np.asarray(m(m.params, inputs=x, noise_params=noise))
        g = np.asarray(jax.grad(loss)(m.params)) if grad else None
    return out, g


@pytest.mark.unittest
@pytest.mark.parametrize("mesh, inputs, grad", [
    (STATE4, np.array([0.4]), False),
    (COMPOSED, np.linspace(-1.0, 1.0, 4).reshape(-1, 1), True),
], ids=["state4", "data2xstate2"])
def test_model_matches_jax(ranks, mesh, inputs, grad):
    """The data x state gradient: each data rank's parameter gradient covers
    its rows only until the data axis sums it."""
    m, params = _jax_model(4, 1)
    out, g = _jax_model_answer(m, inputs, grad=grad)
    request = (f"expval(in_axes={len(inputs) > 1}, shots=None)", "sharded:state")
    for a in ranks.run("model_requests", 4, 1, params, inputs, mesh, None, "expval", grad):
        _close(a["out"], out)
        if grad:
            _grad_close(a["grad"], g)
        assert a["decisions"] == [request]


@pytest.mark.unittest
def test_density_engine_matches_jax(ranks):
    obs = (("PauliZ", 0), ("PauliX", 1), ("Hermitian", 3, (1, 3)))
    requests = [
        ("expval", obs, (0.7,), None, None, True),
        ("probs", (), (0.7,), None, None, False),
        ("density", (), (0.7,), None, None, False),
    ]
    port, _ = _both(ranks, "noisy4", 4, STATE4, requests, routes=False)
    assert all(r == "sharded:density" for _, r in port["decisions"])


@pytest.mark.unittest
def test_batched_density_engine_matches_jax(ranks):
    ps = _batch(4, seed=5)
    requests = [
        ("expval", (("PauliZ", 0), ("Hermitian", 3, (1, 3))), (ps,), (0,), None, True),
        ("probs", (), (ps,), (0,), None, False),
        ("density", (), (ps,), (0,), None, False),
    ]
    port, _ = _both(ranks, "noisy_batch", 5, COMPOSED, requests, routes=False)
    assert all(r == "sharded:density" for _, r in port["decisions"])


@pytest.mark.unittest
def test_noisy_model_matches_jax(ranks):
    noise = {"BitFlip": 0.03, "Depolarizing": 0.02, "AmplitudeDamping": 0.05}
    m, params = _jax_model(3, 1)
    out, _ = _jax_model_answer(m, np.array([0.3]), noise, grad=False)
    for a in ranks.run("model_requests", 3, 1, params, np.array([0.3]), STATE4, noise,
                       "expval", False):
        _close(a["out"], out)
        assert a["decisions"] == [("expval(in_axes=False, shots=None)", "sharded:density")]


@pytest.mark.unittest
def test_duplicate_zword_wires_reduce_mod_2(ranks):
    """<Z0 Z0> = 1 and <Z0 Z0 Z1> = <Z1> on the sharded density engine (the
    single-device routes refuse such words)."""
    requests = [("expval", (("ZZ", (0, 0)), ("ZZ", (0, 0, 1)), ("PauliZ", 1)),
                 (_batch(1)[0],), None, None, False)]
    port = _agree(ranks.run("script_requests", "noisy_batch", 5, COMPOSED, requests))
    out = port["answers"][0][0]
    assert abs(out[0] - 1.0) <= OUT_TOL and abs(out[1] - out[2]) <= OUT_TOL
    assert port["decisions"] == [("expval(in_axes=False, shots=None)", "sharded:density")]


@pytest.mark.unittest
def test_data_parallel_mesh_matches_jax(ranks):
    """A mesh of four data ranks and no state axis: the batch split, run on
    the ordinary batched route and gathered; a batch of 6 does not divide."""
    for B in (8, 6):
        ps = _batch(B, seed=B)
        requests = [("expval", (("PauliY", 0), ("PauliX", 2)), (ps,), (0,), None, B == 8)]
        port, _ = _both(ranks, "layered", 5, DATA4, requests, routes=False)
        assert port["decisions"] == []


# ---------------------------------------------------------------------------
# Shots, by distribution
# ---------------------------------------------------------------------------


def _exact(circuit, n, type, obs, args, in_axes=None):
    f = R.CIRCUITS[circuit]
    with jax_x64():
        s = JaxScript(lambda *a: f(jo, *a), n_qubits=n)
        return np.asarray(s.execute(type=type, obs=R.observables(jo, obs, jnp.asarray),
                                    args=tuple(jnp.asarray(a) for a in args), in_axes=in_axes))


@pytest.mark.unittest
@pytest.mark.parametrize("circuit, n, mesh, type, obs, batched", [
    ("circ5", 5, STATE4, "probs", (), False),
    ("circ5", 5, STATE4, "expval", (("PauliZ", 0), ("PauliZ", 3), ("Hermitian", 2, (1, 4))),
     False),
    ("noisy4", 4, STATE4, "probs", (), False),
    ("noisy4", 4, STATE4, "expval", (("PauliZ", 0), ("PauliZ", 2)), False),
    ("layered", 5, COMPOSED, "expval", (("PauliZ", 0), ("PauliZ", 4)), True),
], ids=["state-probs", "state-expval", "density-probs", "density-expval", "batched-expval"])
def test_shots_by_distribution(ranks, circuit, n, mesh, type, obs, batched):
    args = (_batch(4, seed=2),) if batched else (0.7,)
    in_axes = (0,) if batched else None
    if type == "expval":  # the observables' diagonals against the exact probabilities
        probs = _exact(circuit, n, "probs", (), args, in_axes)
        with jax_x64():
            lifted = [np.real(np.diagonal(np.asarray(o.lifted_matrix(n))))
                      for o in R.observables(jo, obs, jnp.asarray)]
        exact = np.stack([probs @ d for d in lifted], axis=-1)
    else:
        exact = _exact(circuit, n, type, obs, args, in_axes)
    requests = [(type, obs, args, in_axes, SHOTS, False)]
    port = _agree(ranks.run("script_requests", circuit, n, mesh, requests))
    ref = jax_requests(circuit, n, mesh, requests)
    got, want = port["answers"][0][0], ref["sharded"][0]
    assert got.shape == want.shape == exact.shape
    assert np.abs(got - exact).max() < SHOT_TOL
    assert np.abs(want - exact).max() < SHOT_TOL
    assert port["decisions"] == ref["decisions"]


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

WIDE_OBS = (("Hermitian", 1, (0, 1, 2)),)


@pytest.mark.unittest
@pytest.mark.parametrize("circuit, n, requests", [
    ("circ5", 5, [("expval", (("PauliZ", 0),), (0.3,), None, None, False),
                  ("expval", (("PauliZ", 0),), (0.9,), None, None, False),
                  ("variance", (), (0.3,), None, None, False),
                  ("probs", (), (0.3,), None, None, False)]),
    ("too_small", 1, [("expval", (("PauliZ", 0),), (0.3,), None, None, False),
                      ("expval", (("PauliZ", 0),), (0.4,), None, None, False)]),
    ("ry4", 4, [("expval", WIDE_OBS, (0.5,), None, None, False)]),
    ("noisy4", 4, [("state", (), (0.5,), None, None, False),
                   ("probs", (), (0.5,), None, None, False)]),
], ids=["cached-and-shots-on-state", "too-few-qubits", "observable-too-wide", "noisy"])
def test_route_log_matches_jax(ranks, circuit, n, requests):
    port = _agree(ranks.run("script_requests", circuit, n, STATE4, requests))
    ref = jax_requests(circuit, n, STATE4, requests)
    assert port["decisions"] == ref["decisions"]
    assert port["explain"] == ref["explain"]
    for (out, _), (want, _) in zip(port["answers"], ref["answers"]):
        if isinstance(want, str):  # both refuse it
            assert isinstance(out, str) and out.startswith("ValueError"), out
        else:
            _close(out, want)


@pytest.mark.unittest
def test_unlowerable_noisy_tape_falls_back_as_in_jax(ranks):
    diag = np.exp(1j * np.arange(4.0))
    requests = [("probs", (), (0.6, diag), None, None, False)]
    port = _agree(ranks.run("script_requests", "unlowerable", 4, STATE4, requests))
    ref = jax_requests("unlowerable", 4, STATE4, requests)
    assert port["decisions"] == ref["decisions"]
    assert port["decisions"][0][1].startswith("fallback: ")
    _close(port["answers"][0][0], ref["answers"][0][0])


@pytest.mark.unittest
def test_repeated_signature_builds_no_second_plan(ranks):
    ps = _batch(4)
    requests = [("expval", (("PauliZ", 0),), (np.full(5, 0.3),), None, None, False),
                ("expval", (("PauliZ", 0),), (np.full(5, 0.9),), None, None, False),
                ("probs", (), (ps,), (0,), None, False),
                ("probs", (), (ps,), (0,), None, False)]
    port = _agree(ranks.run("script_requests", "layered", 5, COMPOSED, requests))
    assert port["plans"] == [1, 0, 1, 0]
    assert [r for _, r in port["decisions"]] == ["sharded:state", "sharded:cached"] * 2
    ref = jax_requests("layered", 5, COMPOSED, requests)
    assert port["decisions"] == ref["decisions"]


@pytest.mark.unittest
def test_fallback_warns_once_per_reason(ranks):
    requests = [("expval", (("PauliZ", 0),), (0.3,), None, None, False)] * 3
    assert ranks.run("warnings_of", "too_small", 1, STATE4, requests) == [1] * 4


@pytest.mark.unittest
def test_direct_simulators(ranks):
    n = 5
    psi = np.zeros(2**n, complex)
    psi[0] = psi[-1] = 1 / np.sqrt(2)
    rho = np.zeros((2**n, 2**n))
    rho[0, 0] = rho[-1, -1] = 0.5
    for a in ranks.run("direct_sims", n):
        _close(a["psi"], psi)
        _close(a["zz"], np.array([0.0, 1.0]))
        np.testing.assert_allclose(a["z"], [0.0], atol=1e-6)
        _close(a["rho"], rho)
        assert a["noise_raises"]
