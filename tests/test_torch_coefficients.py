"""The PyTorch port's Fourier analysis against the JAX package:
``Coefficients`` (grid, FFT, shift, trim, cap, series evaluation),
``FourierTree`` (the leaf tables, native and Python, coefficients, support),
``FCC`` fingerprints and ``Datasets``, and ``Model.exact_spectrum``.

Both packages get the same parameters, made with numpy from a seed, at
float64 (JAX with x64 enabled), carried with ``Model.load_numpy``.
Tolerances: spectra, FourierTree coefficients and expectation values to
1e-10; the leaf tables equal as sets of (sin mask, cos mask, amplitude);
FCC fingerprints and values to 1e-8 (a correlation divides by products of
standard deviations); random Fourier-series targets, drawn from each
package's own generator, by their properties.
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_essentials_tpu import native as jax_native
from qml_essentials_tpu.analysis import coefficients as jcoef
from qml_essentials_tpu.models.model import Model as JaxModel
from qml_essentials_tpu.ops import operations as jo
from qml_essentials_tpu.pulse.pulses import PulseInformation
from qml_essentials_tpu_torch import native
from qml_essentials_tpu_torch.analysis import coefficients as tcoef
from qml_essentials_tpu_torch.analysis.coefficients import (
    FCC,
    Coefficients,
    Datasets,
    FourierTree,
)
from qml_essentials_tpu_torch.models.model import Model

torch.set_num_threads(2)

TOL = 1e-10
FCC_TOL = 1e-8


@contextmanager
def jax_x64():
    """JAX with x64 enabled and the operation classes' constant matrices in
    complex128 (H's 1/sqrt(2) recomputed in float64)."""
    promoted = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for cls in vars(jo).values():
            m = vars(cls).get("_matrix") if isinstance(cls, type) else None
            if m is not None and getattr(m, "dtype", None) == jnp.complex64:
                promoted[cls] = m
                cls._matrix = m.astype(jnp.complex128)
        jo.H._matrix = jnp.asarray(np.array([[1, 1], [1, -1]]) / np.sqrt(2.0), jnp.complex128)
        yield
    finally:
        for cls, m in promoted.items():
            cls._matrix = m
        jax.config.update("jax_enable_x64", False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x)


def _pair(n, layers, circuit, seed=5, batch=1, **kw):
    """A JAX model and a float64 CPU port model on the same parameters."""
    snapshot = PulseInformation.snapshot_state()
    try:
        jm = JaxModel(n_qubits=n, n_layers=layers, circuit_type=circuit, **kw)
    finally:
        PulseInformation.restore_state(snapshot)  # JaxModel() sets the pulse envelope
    tm = Model(n_qubits=n, n_layers=layers, circuit_type=circuit, device="cpu",
               dtype=torch.float64, **kw)
    shape = (batch, *np.asarray(jm.params).shape[1:])
    params = np.random.default_rng(seed).uniform(0, 2 * np.pi, shape)
    jm.params = jnp.asarray(params)
    tm.load_numpy(params)
    return jm, tm


def _close(got, ref, tol=TOL):
    """Equal shapes, NaN where the reference has NaN, the rest within *tol*."""
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    assert np.abs(got[~nan] - ref[~nan]).max(initial=0.0) <= tol


def _freqs_equal(got, ref):
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref)
        for g, r in zip(got, ref):
            assert np.array_equal(np.asarray(g), np.asarray(r))
    else:
        assert np.array_equal(np.asarray(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# Coefficients
# ---------------------------------------------------------------------------


_SPECTRUM_CASES = [
    ("one feature", dict(), dict()),
    ("one feature shift trim cap", dict(), dict(mfs=2, shift=True, trim=True, numerical_cap=0.02)),
    ("one feature, every qubit", dict(), dict(shift=True, force_mean=False)),
    ("two features shift", dict(encoding=["RX", "RY"]), dict(shift=True)),
    ("two features trim cap", dict(encoding=["RX", "RY"]),
     dict(mfs=2, trim=True, numerical_cap=0.01)),
]


@pytest.mark.unittest
@pytest.mark.parametrize("label, model_kw, spec_kw", _SPECTRUM_CASES,
                         ids=[c[0] for c in _SPECTRUM_CASES])
def test_get_spectrum_matches_jax(label, model_kw, spec_kw):
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19", **model_kw)
        jc, jf = jcoef.Coefficients.get_spectrum(jm, **spec_kw)
        tc, tf = Coefficients.get_spectrum(tm, **spec_kw)
    _close(tc, jc)
    _freqs_equal(tf, jf)


@pytest.mark.unittest
def test_fourier_series_reconstruction_and_psd():
    xs = np.linspace(0.0, 2 * np.pi, 7)
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19")
        jc, jf = jcoef.Coefficients.get_spectrum(jm, shift=True)
        tc, tf = Coefficients.get_spectrum(tm, shift=True)
        ref = jcoef.Coefficients.evaluate_Fourier_series(jc, jf, xs)
        _close(Coefficients.evaluate_Fourier_series(tc, tf, xs), ref)
        _close(Coefficients.evaluate_Fourier_series(tc, tf, 0.4),
               jcoef.Coefficients.evaluate_Fourier_series(jc, jf, 0.4))
        direct = tm(inputs=torch.from_numpy(xs).reshape(-1, 1), force_mean=True)
        _close(Coefficients.evaluate_Fourier_series(tc, tf, xs), _np(direct))
        _close(Coefficients.get_psd(tc), jcoef.Coefficients.get_psd(jc))
        # Two features: per-axis frequency lists and a (d, n) array.
        jm2, tm2 = _pair(2, 1, "Circuit_19", encoding=["RX", "RY"])
        jc2, jf2 = jcoef.Coefficients.get_spectrum(jm2)
        tc2, tf2 = Coefficients.get_spectrum(tm2)
        pts = np.array([[0.3, 1.2], [2.0, -0.7]])
        _close(Coefficients.evaluate_Fourier_series(tc2, tf2, pts),
               jcoef.Coefficients.evaluate_Fourier_series(jc2, jf2, pts))
        _close(Coefficients.evaluate_Fourier_series(tc2, np.asarray(tf2), pts[0]),
               jcoef.Coefficients.evaluate_Fourier_series(jc2, jnp.asarray(np.asarray(jf2)), pts[0]))
    psd = Coefficients.get_psd(torch.tensor([1.0 + 0j, 0.5j, 0.0]))
    assert np.allclose(_np(psd), 2 / 9 * np.array([1.0, 0.25, 0.0]), atol=1e-7)


@pytest.mark.unittest
def test_single_qubit_spectrum_and_leak_budget():
    m = Model(n_qubits=1, n_layers=1, circuit_type="No_Ansatz", data_reupload=False,
              device="cpu", dtype=torch.float64)
    coeffs, freqs = Coefficients.get_spectrum(m, shift=True)
    c = dict(zip(np.asarray(freqs).tolist(), _np(coeffs)))
    assert abs(c[1.0] - 0.5) <= 1e-12 and abs(c[0.0]) <= 1e-12


# ---------------------------------------------------------------------------
# FourierTree
# ---------------------------------------------------------------------------


def _rows(table):
    """A leaf table as a set of (sin mask, cos mask, amplitude) rows."""
    S, C, amp = (np.asarray(table[0], dtype=bool), np.asarray(table[1], dtype=bool),
                 np.asarray(table[2]))
    return {(s.tobytes(), c.tobytes(), complex(a)) for s, c, a in zip(S, C, amp)}


@pytest.mark.unittest
@pytest.mark.parametrize("circuit", ["Circuit_19", "Circuit_15", "Hardware_Efficient"])
def test_fourier_tree_matches_jax(circuit, monkeypatch):
    with jax_x64():
        jm, tm = _pair(2, 1, circuit, seed=31)
        jt, tt = jcoef.FourierTree(jm), FourierTree(tm)
        assert tt.n_params == jt.n_params
        assert tt.all_input_indices == jt.all_input_indices
        assert np.array_equal(tt.input_scaling, jt.input_scaling)
        assert np.array_equal(tt.var_positions, jt.var_positions)
        # Leaf tables: the port's native enumerator, its Python walk and the
        # JAX package's tables, equal as sets of rows.
        assert native.native_available()
        tables = tt._leaf_tables()
        for root, table in zip(tt.observable_words, tables):
            monkeypatch.setattr(native, "enumerate_leaves", lambda *a: None)
            python = tt._expand_root(root)
            monkeypatch.undo()
            assert _rows(python) == _rows(table)
        for t, j in zip(tables, jt._leaf_tables()):
            assert _rows(t) == _rows(j)
        # Coefficients and frequencies, per root and averaged.
        for force_mean in (False, True):
            jcl, jfl = jt.get_spectrum(force_mean=force_mean)
            tcl, tfl = tt.get_spectrum(force_mean=force_mean)
            for tc, jc, tf, jf in zip(tcl, jcl, tfl, jfl):
                _close(tc, jc)
                assert np.array_equal(np.asarray(tf), np.asarray(jf))
        for x in (0.3, 1.1):
            _close(tt(inputs=torch.tensor([x], dtype=torch.float64), force_mean=True),
                   jt(inputs=jnp.asarray([x]), force_mean=True))
            _close(tt(inputs=torch.tensor([x], dtype=torch.float64)), jt(inputs=jnp.asarray([x])))
            direct = tm(inputs=x).mean()
            assert abs(float(tt(inputs=torch.tensor([x], dtype=torch.float64), force_mean=True)) - float(direct)) <= TOL
        for method in ("tree", "dp"):
            for ts, js_ in zip(tt.get_exact_support(method), jt.get_exact_support(method)):
                assert np.array_equal(ts, np.asarray(js_))
        for ts, ds in zip(tt.get_exact_support("tree"), tt.get_exact_support("dp")):
            assert set(np.asarray(ts).ravel()) <= set(np.asarray(ds).ravel())
    with pytest.raises(NotImplementedError):
        tt(execution_type="probs")
    with pytest.raises(NotImplementedError):
        tt(noise_params={"Depolarizing": 0.1})


@pytest.mark.unittest
def test_fourier_tree_spectrum_matches_fft_and_two_features():
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19", seed=8, encoding=["RX", "RY"])
        jt, tt = jcoef.FourierTree(jm), FourierTree(tm)
        jcl, jfl = jt.get_spectrum(force_mean=True)
        tcl, tfl = tt.get_spectrum(force_mean=True)
        _close(tcl[0], jcl[0])
        assert np.array_equal(tfl[0], np.asarray(jfl[0]))
        assert tt.features == jt.features == [0, 1]
        with pytest.raises(NotImplementedError):
            tt.get_exact_support("dp")
    # One feature: every tree coefficient is the FFT's at its frequency.
    m = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", random_seed=8, device="cpu",
              dtype=torch.float64)
    tc, tf = FourierTree(m).get_spectrum(force_mean=True)
    fc, ff = Coefficients.get_spectrum(m, shift=True)
    fft = dict(zip(np.asarray(ff).tolist(), _np(fc)))
    for f, c in zip(np.asarray(tf[0]).tolist(), _np(tc[0])):
        assert abs(c - fft[f]) <= TOL, f
    with pytest.raises(ValueError):
        FourierTree(m).get_exact_support("magic")


def _leaf_case():
    """The rotation words of a 3q Circuit_19 and the root Z_1."""
    words = FourierTree(Model(n_qubits=3, n_layers=1, circuit_type="Circuit_19",
                              device="cpu", dtype=torch.float64)).rotation_words
    return words, tcoef.PauliWord.from_pauli_string("Z", [1], 3)


def _jax_native_leaves(monkeypatch, words, root, n):
    """The JAX package's native leaf tables.  Its loader compiles straight
    into its final path, so a process that loaded while another was still
    writing the file keeps ``_load_failed`` set for good and returns None
    (test workers collecting tests/test_native.py at once do that).  The
    file is complete by now: clear the flag and let the loader try again."""
    monkeypatch.setattr(jax_native, "_load_failed", False)
    monkeypatch.setattr(jax_native, "_lib", None)
    jroot = jo.PauliWord._make(root.xm, root.zm, root.n, root.phase)
    jwords = [jo.PauliWord._make(w.xm, w.zm, w.n, w.phase) for w in words]
    tables = jax_native.enumerate_leaves(jwords, jroot, n)
    assert tables is not None, "the JAX package's native enumerator did not load"
    return tables


@pytest.mark.unittest
def test_native_enumerator_builds_outside_the_package(monkeypatch):
    """The library is compiled into build/native at the repository root,
    not beside its source in either package, and is named by a hash."""
    assert native.native_available()
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert "qml_essentials_tpu_torch" not in path.parts
    words, root = _leaf_case()
    S, C, amp = native.enumerate_leaves(words, root, 3)
    jS, jC, jamp = _jax_native_leaves(monkeypatch, words, root, 3)
    assert _rows((S, C, amp)) == _rows((jS, jC, jamp))
    assert native.enumerate_leaves(words, root, 65) is None


@pytest.mark.unittest
def test_reference_enumerator_survives_a_lost_build_race(monkeypatch):
    """A process whose JAX loader lost the build race (``_load_failed`` set)
    still gets the reference's native tables, equal to the port's."""
    monkeypatch.setattr(jax_native, "_load_failed", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.enumerate_leaves([], None, 3) is None  # the state the race leaves
    words, root = _leaf_case()
    assert _rows(native.enumerate_leaves(words, root, 3)) == \
        _rows(_jax_native_leaves(monkeypatch, words, root, 3))


@pytest.mark.unittest
def test_model_exact_spectrum_matches_jax():
    with jax_x64():
        for kw in (dict(), dict(encoding=["RX", "RY"])):
            jm, tm = _pair(2, 1, "Circuit_19", seed=3, **kw)
            got, ref = tm.exact_spectrum(), jm.exact_spectrum()
            assert len(got) == len(ref) == tm.n_input_feat
            for g, r in zip(got, ref):
                assert np.array_equal(g, np.asarray(r))
            for g, f in zip(got, tm.frequencies):
                assert set(g) <= set(np.asarray(f))


# ---------------------------------------------------------------------------
# FCC
# ---------------------------------------------------------------------------


@pytest.mark.unittest
@pytest.mark.parametrize("method", ["pearson", "complex_pearson", "spearman", "covariance"])
def test_fcc_matches_jax(method):
    """Ten carried parameter sets (``n_samples=0`` takes the stored batch)."""
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19", seed=12, batch=10)
        for kw in (dict(), dict(trim_redundant=False), dict(weight=True),
                   dict(weight=True, trim_redundant=False, nan_to_one=True)):
            jfp, jlab = jcoef.FCC.get_fourier_fingerprint(jm, 0, method=method, **kw)
            tfp, tlab = FCC.get_fourier_fingerprint(tm, 0, method=method, **kw)
            _close(tfp, jfp, FCC_TOL)
            if isinstance(jlab, tuple):
                for a, b in zip(tlab, jlab):
                    assert np.array_equal(np.asarray(a), np.asarray(b))
            else:
                _freqs_equal(tlab, jlab)
            j = float(jcoef.FCC.calculate_fcc(jfp))
            t = float(FCC.calculate_fcc(tfp))
            assert abs(t - j) <= FCC_TOL
        assert abs(float(FCC.get_fcc(tm, 0, method=method))
                   - float(jcoef.FCC.get_fcc(jm, 0, method=method))) <= FCC_TOL


@pytest.mark.unittest
def test_fcc_helpers_match_jax():
    rng = np.random.default_rng(2)
    mat = rng.normal(size=(12, 5)) + 1j * rng.normal(size=(12, 5))
    mat[3, 1] = np.nan
    mat[7, 4] = np.inf
    with jax_x64():
        for name in ("_pearson", "_complex_pearson", "_spearman", "_covariance"):
            ref = getattr(jcoef.FCC, name)(jnp.asarray(mat))
            got = getattr(FCC, name)(torch.from_numpy(mat))
            ref, got = np.asarray(ref), _np(got)
            assert np.array_equal(np.isnan(ref), np.isnan(got)), name
            ok = ~np.isnan(ref)
            assert np.abs(got[ok] - ref[ok]).max() <= FCC_TOL, name
        sq = rng.normal(size=(5, 5))
        _close(FCC._weighting_linear(torch.from_numpy(sq)), jcoef.FCC._weighting_linear(jnp.asarray(sq)))
        f2 = [np.array([-1.0, 0.0, 1.0]), np.array([-1.0, 0.0, 1.0])]
        assert np.array_equal(FCC._nonneg_indices(np.asarray(f2)),
                              np.asarray(jcoef.FCC._nonneg_indices(jnp.asarray(f2))))
        assert np.array_equal(FCC._flat_frequencies(np.asarray(f2)),
                              np.asarray(jcoef.FCC._flat_frequencies(jnp.asarray(f2))))
    with pytest.raises(ValueError):
        FCC._correlate(torch.zeros((3, 3)), method="kendall")
    with pytest.raises(ValueError):
        FCC._weighting_linear(torch.zeros((4, 4)))


@pytest.mark.unittest
def test_fcc_sampled_paths():
    """The reference's checks on freshly drawn parameters: the FCC lies in
    [0, 1], and the fast (trimmed) path equals the fingerprint's."""
    gen = torch.Generator().manual_seed
    m = Model(n_qubits=2, n_layers=1, circuit_type="Circuit_19", device="cpu", dtype=torch.float64)
    fcc = float(FCC.get_fcc(m, n_samples=10, random_key=gen(0)))
    assert 0.0 <= fcc <= 1.0
    fp, _ = FCC.get_fourier_fingerprint(m, n_samples=10, random_key=gen(4))
    fast = float(FCC.get_fcc(m, n_samples=10, random_key=gen(4)))
    assert abs(fast - float(FCC.calculate_fcc(fp))) <= 1e-12
    # scale=True draws 2^n * n_samples * n_features parameter sets.
    FCC.get_fcc(m, n_samples=2, random_key=gen(1), scale=True)
    assert m.params.shape[0] == 2**2 * 2


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


@pytest.mark.unittest
def test_generate_fourier_series():
    """Drawn from the port's generator: the JAX package's shapes and
    guarantees (a real series, conjugate-symmetric coefficients whose
    magnitudes lie in the annulus)."""
    with jax_x64():
        jm, tm = _pair(2, 1, "Circuit_19")
        jd, jv, jc = jcoef.Datasets.generate_fourier_series(jax.random.PRNGKey(0), jm)
    for zero in (False, True):
        domain, values, coeffs = Datasets.generate_fourier_series(
            torch.Generator().manual_seed(0), tm, 0.2, 0.8, zero_centered=zero)
        assert tuple(domain.shape) == tuple(jd.shape)
        assert tuple(values.shape) == tuple(jv.shape) == tuple(tm.degree)
        assert tuple(coeffs.shape) == tuple(jc.shape)
        _close(domain, jd)
        flat = _np(coeffs).reshape(-1)
        assert np.allclose(flat, np.conj(flat[::-1]), atol=1e-12)
        assert np.all(np.isfinite(_np(values)))
        mid = flat.size // 2
        if zero:
            assert flat[mid] == 0
        mags = np.abs(np.delete(flat, mid)) ** 2
        assert mags.min() >= 0.2 - 1e-12 and mags.max() <= 0.8 + 1e-12
        # The values are the series' real part at the domain points.
        series = Coefficients.evaluate_Fourier_series(
            coeffs.reshape(-1) / coeffs.numel(),
            np.stack(np.meshgrid(*tm.frequencies)).T.reshape(-1, 1)[:, 0],
            _np(domain).reshape(-1))
        _close(series, _np(values).reshape(-1), 1e-12)
    z = Datasets.uniform_circle(torch.Generator().manual_seed(3), 4000, low=0.25, high=1.0)
    r2 = _np(z.abs() ** 2)
    assert r2.min() >= 0.25 and r2.max() <= 1.0
    assert abs(r2.mean() - 0.625) <= 0.02  # |z|^2 uniform on [0.25, 1]
