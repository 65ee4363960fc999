"""The kernels of the PyTorch port: plain versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' routing, and — on a machine with a GPU — each CUDA kernel against
its plain version (the backward kernels' plain versions are held to the JAX
package in tests/test_torch_saved.py).

Tolerances: the Pallas kernels multiply in the TPU's split3 bf16 scheme
(~9e-6 relative per window, measured against an f64 oracle), so window
parity is 2e-5 relative; the rotation is a permutation and must be exact.
On the card the kernels accumulate in fp32 FMA over K <= 1024 terms; they
are held to 1e-5 relative against the plain version in float64.  The matrix
cotangent of the backward kernels sums up to 2**16 columns in fp32 (split
into chunks, the partials added in a fixed order): 1e-4 relative.  A
bfloat16 state cotangent is held to one bf16 ulp of the float64 value plus
the 1e-5 floor (the kernel rounds its fp32 sum, the reference its float64
one).

The machine with the card has no JAX, so only the Pallas tests import it;
there the card's tests run with ``-m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qml_essentials_tpu_torch.ops import cuda_kernels, kernels

torch.set_num_threads(2)

PALLAS_TOL = 2e-5
CUDA_TOL = 1e-5
CUDA_GRAM_TOL = 1e-4


def _state(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(2, 2**n)).astype(np.float32)
    return s / np.linalg.norm(s)


def _unitary_pair(k, seed):
    rng = np.random.default_rng(seed)
    K = 2**k
    q, _ = np.linalg.qr(rng.normal(size=(K, K)) + 1j * rng.normal(size=(K, K)))
    return np.stack([q.real, q.imag]).astype(np.float32)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.mark.unittest
@pytest.mark.parametrize("n,a,k", [(12, 2, 3), (13, 0, 8), (14, 3, 5), (14, 1, 9), (13, 7, 3)])
def test_window_plain_matches_pallas(n, a, k):
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    psi2, w2 = _state(n, a), _unitary_pair(k, k)
    ref = pallas_kernels.window_apply_ri(jnp.asarray(psi2), jnp.asarray(w2), a, k, n, True)
    got = kernels.window_apply_plain(torch.from_numpy(psi2), torch.from_numpy(w2), a, k, n)
    assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n,k", [(12, 7), (13, 8), (14, 6), (12, 2)])
def test_window_top_plain_matches_pallas(n, k):
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    psi2, w2 = _state(n, k), _unitary_pair(k, n)
    ref = pallas_kernels.window_apply_top_ri(jnp.asarray(psi2), jnp.asarray(w2), k, n, True)
    got = kernels.window_apply_top_plain(torch.from_numpy(psi2), torch.from_numpy(w2), k, n)
    assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n,r", [(12, 7), (14, 7), (14, 3), (13, 12)])
def test_rotate_plain_matches_pallas(n, r):
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    psi2 = _state(n, r)
    ref = pallas_kernels.rotate_ri(jnp.asarray(psi2), r, n, True)
    got = kernels.rotate_plain(torch.from_numpy(psi2), r, n)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.unittest
def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    n = 10
    psi2 = torch.from_numpy(_state(n, 0))
    w2 = torch.from_numpy(_unitary_pair(3, 0))
    cuda_kernels.reset_launch_counts()
    assert torch.equal(
        cuda_kernels.window_apply(psi2, w2, 2, 3, n), kernels.window_apply_plain(psi2, w2, 2, 3, n)
    )
    assert torch.equal(
        cuda_kernels.window_apply_top(psi2, w2, 3, n), kernels.window_apply_top_plain(psi2, w2, 3, n)
    )
    assert torch.equal(cuda_kernels.rotate(psi2, 4, n), kernels.rotate_plain(psi2, 4, n))
    g = psi2.flip(1).to(torch.bfloat16)
    for got, ref in (
        (cuda_kernels.window_apply_bwd(w2, g, psi2, 2, 3, n, torch.bfloat16),
         kernels.window_apply_bwd_plain(w2, g, psi2, 2, 3, n, torch.bfloat16)),
        (cuda_kernels.window_apply_top_bwd(w2, g, psi2, 3, n, torch.float32),
         kernels.window_apply_top_bwd_plain(w2, g, psi2, 3, n, torch.float32)),
    ):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert set(cuda_kernels.launch_counts().values()) == {0}
    assert set(cuda_kernels.launch_counts()) == {
        "window_apply", "window_apply_bwd", "window_apply_top", "window_apply_top_bwd", "rotate"
    }


@pytest.mark.unittest
def test_wrappers_refuse_other_devices():
    psi2 = torch.zeros((2, 2**6), device="meta")
    w2 = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(NotImplementedError):
        cuda_kernels.window_apply(psi2, w2, 1, 2, 6)
    with pytest.raises(NotImplementedError):
        cuda_kernels.rotate(psi2, 2, 6)
    with pytest.raises(ValueError):
        cuda_kernels.window_apply(psi2, torch.zeros((2, 4, 4)), 1, 2, 6)


@pytest.mark.unittest
@pytest.mark.parametrize("K,C", [(2, 2**23), (4, 64), (64, 2**16), (256, 2**16), (1024, 2**14)])
def test_gram_split_fills_the_card_within_its_workspace(K, C):
    splits = cuda_kernels.gram_splits(K, C)
    assert 1 <= splits <= 65535
    assert splits * 2 * K * K * 4 <= cuda_kernels._GRAM_MAX_WS
    assert splits == 1 or C // splits >= cuda_kernels._GRAM_MIN_CHUNK
    tiles = (-(-K // 64)) ** 2
    assert tiles * splits >= min(cuda_kernels._GRAM_BLOCKS, tiles * max(1, C // 256))


@pytest.mark.unittest
def test_library_name_tracks_the_sources():
    path = cuda_kernels.library_path()
    assert path.parent == cuda_kernels.BUILD_DIR
    assert path == cuda_kernels.library_path()
    assert all((cuda_kernels.CSRC / s).is_file() for s in cuda_kernels.SOURCES)


@pytest.mark.unittest
def test_model_on_cuda_needs_cuda():
    from qml_essentials_tpu_torch.models.model import Model

    if torch.cuda.is_available():
        assert Model(4, 1, "Circuit_19", device="cuda").params.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Model(4, 1, "Circuit_19", device="cuda")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check_cuda_window(cuda, n, a, k, top):
    x = torch.from_numpy(_state(n, n + k)).to(cuda)
    w = torch.from_numpy(_unitary_pair(k, a)).to(cuda)
    before = cuda_kernels.launch_counts()
    if top:
        got = cuda_kernels.window_apply_top(x, w, k, n)
        ref = kernels.window_apply_top_plain(x.double(), w.double(), k, n)
        name = "window_apply_top"
    else:
        got = cuda_kernels.window_apply(x, w, a, k, n)
        ref = kernels.window_apply_plain(x.double(), w.double(), a, k, n)
        name = "window_apply"
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before[name] + 1
    assert _rel(got.double().cpu(), ref.cpu()) <= CUDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,a,k", [(14, 3, 1), (14, 0, 2), (14, 12, 1), (10, 1, 5), (16, 0, 8), (18, 4, 9), (20, 0, 10)]
)
def test_cuda_window_matches_plain(cuda, n, a, k):
    _check_cuda_window(cuda, n, a, k, top=False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(12, 1), (12, 2), (6, 6), (16, 6), (16, 8), (18, 7)])
def test_cuda_window_top_matches_plain(cuda, n, k):
    _check_cuda_window(cuda, n, n - k, k, top=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(5, 2), (13, 1), (13, 12), (16, 8), (20, 7), (20, 13)])
def test_cuda_rotate_is_exact(cuda, n, r):
    x = torch.from_numpy(_state(n, r)).to(cuda)
    got = cuda_kernels.rotate(x, r, n)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.rotate_plain(x, r, n))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.from_numpy(_state(8, 0)).to(cuda)
    w = torch.from_numpy(_unitary_pair(2, 0)).to(cuda)
    with pytest.raises(TypeError):
        cuda_kernels.window_apply(x.double(), w.double(), 1, 2, 8)
    with pytest.raises(ValueError):
        cuda_kernels.window_apply(x, w, 6, 2, 8)  # B = 1: the top kernel's case
    with pytest.raises(ValueError):
        cuda_kernels.rotate(x[:, ::2].contiguous(), 3, 8)
    with pytest.raises(TypeError):
        cuda_kernels.rotate(x.half(), 3, 8)
    with pytest.raises(TypeError):
        cuda_kernels.window_apply_bwd(w, x, x, 1, 2, 8, torch.float16)
    with pytest.raises(TypeError):
        cuda_kernels.window_apply_bwd(w, x.double(), x, 1, 2, 8, torch.float32)
    # A gradient is no longer refused: the kernels carry their backwards.
    xg = x.clone().requires_grad_()
    cuda_kernels.window_apply(xg, w, 1, 2, 8).square().sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def _bwd_inputs(cuda, n, k, seed, g_dtype):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(_unitary_pair(k, seed)).to(cuda)
    x = torch.from_numpy(_state(n, seed)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(2, 2**n)).astype(np.float32)).to(cuda)
    return w, (g / g.norm()).to(g_dtype), x


def _assert_bwd_close(got, ref, out_dtype):
    (gp, gw), (rp, rw) = got, ref
    assert gp.dtype == out_dtype and gw.dtype == torch.float32
    rp, rw = rp.cpu(), rw.cpu()
    floor = CUDA_TOL * rp.abs().max()
    err = (gp.double().cpu() - rp).abs()
    if out_dtype == torch.bfloat16:
        _, e = torch.frexp(rp)
        assert (err <= torch.ldexp(torch.ones_like(rp), e - 8) + floor).all()
    else:
        assert err.max() <= floor
    assert _rel(gw.double().cpu(), rw) <= CUDA_GRAM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,a,k", [(14, 3, 1), (14, 0, 2), (14, 12, 1), (10, 1, 5), (16, 0, 8), (18, 4, 9), (20, 0, 10)]
)
def test_cuda_window_bwd_matches_plain(cuda, n, a, k, g_dtype, out_dtype):
    """K = 2 and 4, B = 2, a = 0, and the K = 1024 window; bf16 in and out."""
    out_dtype = getattr(torch, out_dtype)
    w, g, x = _bwd_inputs(cuda, n, k, n + a + k, getattr(torch, g_dtype))
    before = cuda_kernels.launch_counts()["window_apply_bwd"]
    got = cuda_kernels.window_apply_bwd(w, g, x, a, k, n, out_dtype)
    ref = kernels.window_apply_bwd_plain(w.double(), g.double(), x.double(), a, k, n, torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["window_apply_bwd"] == before + 1
    _assert_bwd_close(got, ref, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(12, 1), (12, 2), (6, 6), (16, 6), (16, 8), (22, 6)])
def test_cuda_window_top_bwd_matches_plain(cuda, n, k, g_dtype, out_dtype):
    """Top windows, the 22q K = 64 one with 2**16 rows included."""
    out_dtype = getattr(torch, out_dtype)
    w, g, x = _bwd_inputs(cuda, n, k, 3 * n + k, getattr(torch, g_dtype))
    before = cuda_kernels.launch_counts()["window_apply_top_bwd"]
    got = cuda_kernels.window_apply_top_bwd(w, g, x, k, n, out_dtype)
    ref = kernels.window_apply_top_bwd_plain(w.double(), g.double(), x.double(), k, n, torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["window_apply_top_bwd"] == before + 1
    _assert_bwd_close(got, ref, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(5, 2), (13, 1), (13, 12), (20, 7), (24, 8)])
def test_cuda_rotate_bf16_is_exact(cuda, n, r):
    x = torch.from_numpy(_state(n, r)).to(cuda).to(torch.bfloat16)
    got = cuda_kernels.rotate(x, r, n)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kernels.rotate_plain(x, r, n))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["window", "top", "rotate"])
def test_cuda_autograd_functions_match_plain_autograd(cuda, which):
    """The kernels' autograd Functions against autograd over the plain
    versions, in float64 on the card."""
    n, k = 12, 3
    x = torch.from_numpy(_state(n, 1)).to(cuda)
    w = torch.from_numpy(_unitary_pair(k, 2)).to(cuda)
    g = torch.from_numpy(_state(n, 3)).to(cuda)

    def run(fn, dtype):
        xx = x.detach().to(dtype).clone().requires_grad_()
        ww = w.detach().to(dtype).clone().requires_grad_()
        if which == "window":
            y = fn[0](xx, ww, 2, k, n)
        elif which == "top":
            y = fn[1](xx, ww, k, n)
        else:
            y = fn[2](xx, 5, n)
        y.backward(g.to(dtype))
        return xx.grad, (ww.grad if which != "rotate" else None)

    got = run((cuda_kernels.window_apply, cuda_kernels.window_apply_top, cuda_kernels.rotate),
              torch.float32)
    ref = run((kernels.window_apply_plain, kernels.window_apply_top_plain, kernels.rotate_plain),
              torch.float64)
    assert _rel(got[0].double().cpu(), ref[0].cpu()) <= CUDA_TOL
    if which != "rotate":
        assert _rel(got[1].double().cpu(), ref[1].cpu()) <= CUDA_GRAM_TOL
