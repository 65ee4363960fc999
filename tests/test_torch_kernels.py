"""The kernels of the PyTorch port: plain versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' routing, and — on a machine with a GPU — each CUDA kernel against
its plain version (the backward kernels' plain versions are held to the JAX
package in tests/test_torch_saved.py, the adjoint steps' in
tests/test_torch_adjoint.py).  The fused (rotation, window) kernels — rotmat,
matrot, rotwin, their backwards and the rotmat/matrot adjoint steps — are
held to the same bounds as the window kernels they fuse.

Tolerances: the Pallas kernels multiply in the TPU's split3 bf16 scheme
(~9e-6 relative per window, measured against an f64 oracle), so window
parity is 2e-5 relative; the rotation is a permutation and must be exact.
On the card the kernels accumulate in fp32 FMA over K <= 1024 terms; they
are held to 1e-5 relative against the plain version in float64.  The matrix
cotangent of the backward kernels sums up to 2**16 columns in fp32 (split
into chunks, the partials added in a fixed order): 1e-4 relative.  A
bfloat16 state cotangent is held to one bf16 ulp of the float64 value plus
the 1e-5 floor (the kernel rounds its fp32 sum, the reference its float64
one).  The adjoint steps are held to the same three bounds: the rebuilt state
and a float32 cotangent 1e-5, a bfloat16 cotangent one ulp, the matrix
cotangent 1e-4; the paired rotation is a permutation and must be exact.
B1, B3, B6 and B8 (on wgmma) and B2, B7, B9, B11, B12, B13, B14 and B15
(on mma.sync) multiply in split TF32 on the tensor cores and are held to the
same bounds; the ``test_split_tf32_*`` tests emulate that scheme on the CPU
against float64.

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
@pytest.mark.parametrize("n", [15, 16])
def test_rotmat_plain_matches_pallas(n):
    """A rotation by r = 8 and the K = 256 window on [0, 8)."""
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    r = 8
    psi2, w2 = _state(n, n), _unitary_pair(r, n + 1)
    ref = pallas_kernels.rotmat_apply_ri(jnp.asarray(psi2), jnp.asarray(w2), r, n, True)
    got = kernels.rotmat_apply_plain(torch.from_numpy(psi2), torch.from_numpy(w2), r, n)
    assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("n", [15, 16])
def test_matrot_plain_matches_pallas(n):
    """The K = 256 window on [0, 8) and the rotation by r = n - 8."""
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    r = n - 8
    psi2, w2 = _state(n, 2 * n), _unitary_pair(8, n + 2)
    ref = pallas_kernels.matrot_apply_ri(jnp.asarray(psi2), jnp.asarray(w2), r, n, True)
    got = kernels.matrot_apply_plain(torch.from_numpy(psi2), torch.from_numpy(w2), r, n)
    assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.unittest
@pytest.mark.parametrize("r,k", [(7, 8), (7, 9), (8, 9), (5, 7)])
def test_rotwin_plain_matches_pallas(r, k):
    """A rotation by r and a window on [0, k), k > r, at 16 qubits ((5, 7):
    L = 32, the smallest depth run of B10's wgmma rule)."""
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    n = 16
    psi2, w2 = _state(n, r + k), _unitary_pair(k, r)
    ref = pallas_kernels.rotwin_apply_ri(jnp.asarray(psi2), jnp.asarray(w2), r, k, n, True)
    got = kernels.rotwin_apply_plain(torch.from_numpy(psi2), torch.from_numpy(w2), r, k, n)
    assert _rel(got, ref) <= PALLAS_TOL


@pytest.mark.unittest
def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    n = 10
    psi2 = torch.from_numpy(_state(n, 0))
    w2 = torch.from_numpy(_unitary_pair(3, 0))
    w4 = torch.from_numpy(_unitary_pair(4, 1))
    cuda_kernels.reset_launch_counts()
    assert torch.equal(
        cuda_kernels.window_apply(psi2, w2, 2, 3, n), kernels.window_apply_plain(psi2, w2, 2, 3, n)
    )
    assert torch.equal(
        cuda_kernels.window_apply_top(psi2, w2, 3, n), kernels.window_apply_top_plain(psi2, w2, 3, n)
    )
    assert torch.equal(cuda_kernels.rotate(psi2, 4, n), kernels.rotate_plain(psi2, 4, n))
    for got, ref in (
        (cuda_kernels.rotmat_apply(psi2, w2, 3, n), kernels.rotmat_apply_plain(psi2, w2, 3, n)),
        (cuda_kernels.matrot_apply(psi2, w2, 7, n), kernels.matrot_apply_plain(psi2, w2, 7, n)),
        (cuda_kernels.rotwin_apply(psi2, w4, 3, 4, n),
         kernels.rotwin_apply_plain(psi2, w4, 3, 4, n)),
    ):
        assert torch.equal(got, ref)
    g = psi2.flip(1).to(torch.bfloat16)
    for got, ref in (
        (cuda_kernels.window_apply_bwd(w2, g, psi2, 2, 3, n, torch.bfloat16),
         kernels.window_apply_bwd_plain(w2, g, psi2, 2, 3, n, torch.bfloat16)),
        (cuda_kernels.window_apply_top_bwd(w2, g, psi2, 3, n, torch.float32),
         kernels.window_apply_top_bwd_plain(w2, g, psi2, 3, n, torch.float32)),
        (cuda_kernels.rotmat_apply_bwd(w2, g, psi2, 3, n, torch.bfloat16),
         kernels.rotmat_apply_bwd_plain(w2, g, psi2, 3, n, torch.bfloat16)),
        (cuda_kernels.matrot_apply_bwd(w2, g, psi2, 7, n, torch.float32),
         kernels.matrot_apply_bwd_plain(w2, g, psi2, 7, n, torch.float32)),
        (cuda_kernels.rotwin_apply_bwd(w4, g, psi2, 3, 4, n, torch.bfloat16),
         kernels.rotwin_apply_bwd_plain(w4, g, psi2, 3, 4, n, torch.bfloat16)),
        (cuda_kernels.adjoint_step(w2, psi2, g, 2, 3, n, torch.bfloat16),
         kernels.adjoint_step_plain(w2, psi2, g, 2, 3, n, torch.bfloat16)),
        (cuda_kernels.adjoint_step_top(w2, psi2, g, 3, n, torch.float32),
         kernels.adjoint_step_top_plain(w2, psi2, g, 3, n, torch.float32)),
        (cuda_kernels.adjoint_rotmat(w2, psi2, g, 3, n, torch.bfloat16),
         kernels.adjoint_rotmat_plain(w2, psi2, g, 3, n, torch.bfloat16)),
        (cuda_kernels.adjoint_matrot(w2, psi2, g, 7, n, torch.float32),
         kernels.adjoint_matrot_plain(w2, psi2, g, 7, n, torch.float32)),
        (cuda_kernels.rotate_pair(psi2, g, 4, n), kernels.rotate_pair_plain(psi2, g, 4, n)),
    ):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    descs, pays = (("win", 7, 9), ("diag", (8, 1))), [w2[:, :4, :4].contiguous(), w2[:, 0, :4]]
    assert torch.equal(cuda_kernels.chain_apply(psi2, pays, ("L", 9), descs, n),
                       kernels.chain_apply_plain(psi2, pays, ("L", 9), descs, n))
    got = cuda_kernels.adjoint_chain(psi2, g, pays, ("L", 9), descs, n)
    ref = kernels.adjoint_chain_plain(psi2, g, pays, ("L", 9), descs, n)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
    assert set(cuda_kernels.launch_counts().values()) == {0}
    assert set(cuda_kernels.launch_counts()) == {
        "window_apply", "window_apply_bwd", "window_apply_top", "window_apply_top_bwd", "rotate",
        "rotmat_apply", "rotmat_apply_bwd", "matrot_apply", "matrot_apply_bwd", "rotwin_apply",
        "rotwin_apply_bwd", "adjoint_step", "adjoint_step_top", "adjoint_rotmat",
        "adjoint_matrot", "rotate_pair", "chain_apply", "adjoint_chain",
        "window_apply_batch", "window_apply_bwd_batch", "window_apply_top_batch",
        "window_apply_top_bwd_batch",
    }


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest with ties away
    from zero (cvt.rna.tf32.f32, as the kernel computes it)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a tensor core reads of a float32 operand: its top 19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b for float32 operands as the tensor-core tile forms it: hi the
    TF32 rounding, lo = x - hi read as TF32, the products of the passes exact
    (float64), the sum in float64 and rounded once to float32.  One pass is
    plain TF32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    terms = [(ah, bh), (ah, bl), (al, bh)][:passes]
    return sum(x.double() @ y.double() for x, y in terms).float()


@pytest.mark.unittest
@pytest.mark.parametrize("view,passes,within",
                         [("window", 3, True), ("window", 1, False), ("top", 3, True),
                          ("top", 1, False)],
                         ids=["3-True", "1-False", "top-3-True", "top-1-False"])
def test_split_tf32_scheme_is_float32_grade(view, passes, within):
    """The adjoint steps' split-TF32 pullback scheme (four real products) is
    within CUDA_TOL of float64, and plain TF32 (one pass) is not: psi_prev =
    W^dagger psi at K = 1024 on 64 columns (the window view), and
    adjoint_step_top's psi_prev = psi conj(W) at the 22q plan's K = 64 on
    1024 rows of the (A, K) view (the state the row operand, conj(W) the
    column operand, as TopPullbackMap reads them)."""
    k = 10 if view == "window" else 6
    K = 2**k
    w = torch.from_numpy(_unitary_pair(k, 3))
    w64 = w.double()
    if view == "window":
        x = torch.from_numpy(_state(16, 4)).reshape(2, K, 64)
        wr, wi = w[0].T.contiguous(), -w[1].T.contiguous()  # W^dagger = conj(W)^T
        re = _split_tf32_product(wr, x[0], passes) - _split_tf32_product(wi, x[1], passes)
        im = _split_tf32_product(wr, x[1], passes) + _split_tf32_product(wi, x[0], passes)
        x64 = x.double()
        ref_re = w64[0].T @ x64[0] + w64[1].T @ x64[1]
        ref_im = w64[0].T @ x64[1] - w64[1].T @ x64[0]
    else:
        x = torch.from_numpy(_state(16, 4)).reshape(2, -1, K)  # (A, K) rows, 2**10 of them
        wr, wi = w[0], -w[1]  # conj(W)
        re = _split_tf32_product(x[0], wr, passes) - _split_tf32_product(x[1], wi, passes)
        im = _split_tf32_product(x[1], wr, passes) + _split_tf32_product(x[0], wi, passes)
        x64 = x.double()
        ref_re = x64[0] @ w64[0] + x64[1] @ w64[1]
        ref_im = x64[1] @ w64[0] - x64[0] @ w64[1]
    got, ref = torch.stack([re, im]).double(), torch.stack([ref_re, ref_im])
    assert (_rel(got, ref) <= CUDA_TOL) == within


def _trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero, as the tensor cores round
    their accumulator."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _tc_gram(g: torch.Tensor, x: torch.Tensor, splits: int, passes: int,
             split_g: bool = False, rows: bool = False,
             x_rows: bool | None = None) -> torch.Tensor:
    """The gram gw = sum_c g[:, c] conj(x[:, c])^T on the split-TF32 tile,
    for a float32 x split into hi + lo and a g that is bfloat16 (exact in
    TF32, so its own hi) or, with `split_g`, float32 split the same way: the
    columns cut into `splits` chunks; in each, 32-deep stages whose m16n8k8
    steps run the passes (small terms first: g_lo x_hi, g_hi x_lo, g_hi
    x_hi, as mma_split issues them) and the Re/Im products into fresh
    accumulators, each step's sum exact and rounded toward zero; each
    stage's partial added to the chunk's float32 sum, and the chunks' sums
    added in order in float32.  g and x are (2, K, C), the window view's
    rows along the depth c (WindowGramMap), or with `rows` (2, C, K), depth
    first and the gram's rows contiguous, as TopGramMap reads the (B, K)
    view: each 32-deep stage is then cut from 32 whole rows.  `x_rows` (by
    default `rows`) gives x's layout apart from g's: matrot_apply_bwd's
    gram (MatrotGramMap) reads g from the (B, K) view and x from the
    (K, B) one."""
    x_rows = rows if x_rows is None else x_rows
    K, C = (g.shape[2], g.shape[1]) if rows else (g.shape[1], g.shape[2])
    xh = torch.stack([_tf32_rna(x[0]), -_tf32_rna(x[1])])  # conj(x): Im negated
    xl = torch.stack([_tf32_read(x[0] - _tf32_rna(x[0])), -_tf32_read(x[1] - _tf32_rna(x[1]))])
    chunk = C // splits

    def steps(t, by_rows):  # -> (2, splits, stages, 4, K, 8)
        if by_rows:
            return t.reshape(2, splits, chunk // 32, 4, 8, K).transpose(-1, -2).double()
        return t.reshape(2, K, splits, chunk // 32, 4, 8).permute(0, 2, 3, 4, 1, 5).double()

    if split_g:
        gh = _tf32_rna(g)
        terms = [(_tf32_read(g - gh), xh), (gh, xl), (gh, xh)]
    else:
        terms = [(g, xl), (g, xh)]
    terms = [(steps(a, rows), steps(b, x_rows)) for a, b in terms[-passes:]]
    acc = torch.zeros((2, splits, K, K), dtype=torch.float32)
    for st in range(chunk // 32):
        part = torch.zeros_like(acc)
        for kk in range(4):
            ops = [(a[:, :, st, kk], b[:, :, st, kk].transpose(-1, -2)) for a, b in terms]
            # Cr = Ar Br - Ai Bi and Ci = Ar Bi + Ai Br, as mma_stage issues them.
            for c, sign, i, j in ((0, 1, 0, 0), (0, -1, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0)):
                for a, b in ops:
                    part[c] = _trunc32(part[c].double() + sign * (a[i] @ b[j]))
        acc += part
    out = torch.zeros((2, K, K), dtype=torch.float32)
    for z in range(splits):
        out += acc[:, z]
    return out


@pytest.mark.unittest
@pytest.mark.parametrize(
    "view,g_dtype,passes,within",
    [("window", "bfloat16", 2, True), ("window", "bfloat16", 1, False),
     ("matrot", "float32", 3, True), ("matrot", "float32", 1, False),
     ("matrot", "bfloat16", 2, True), ("matrot", "bfloat16", 1, False),
     ("matrot_bwd", "float32", 3, True), ("matrot_bwd", "float32", 1, False),
     ("matrot_bwd", "bfloat16", 2, True), ("matrot_bwd", "bfloat16", 1, False),
     ("rotwin_bwd", "float32", 3, True), ("rotwin_bwd", "float32", 1, False),
     ("rotwin_bwd", "bfloat16", 2, True), ("rotwin_bwd", "bfloat16", 1, False)],
    ids=["2-True", "1-False", "matrot-f32-3-True", "matrot-f32-1-False", "matrot-bf16-2-True",
         "matrot-bf16-1-False", "matrot_bwd-f32-3-True", "matrot_bwd-f32-1-False",
         "matrot_bwd-bf16-2-True", "matrot_bwd-bf16-1-False", "rotwin_bwd-f32-3-True",
         "rotwin_bwd-f32-1-False", "rotwin_bwd-bf16-2-True", "rotwin_bwd-bf16-1-False"])
def test_split_tf32_saved_gram_is_float32_grade(view, g_dtype, passes, within):
    """The grams on the split-TF32 tile, over 2**14 columns at K = 64 in the
    kernel's chunks, stages and accumulator rounding, against float64: the
    saved backward's (window_apply_bwd, rotmat_apply_bwd; the window view's
    (K, C) columns), a bfloat16 g, exact in TF32, against a float32 x split
    in two passes; and adjoint_matrot's G0 = sum_b lam[b, i] conj(psi[b,
    j]) over the 2**14 rows b of the (B, K) view, lam and psi laid out as
    the matrot step holds them and staged row by row as TopGramMap stages
    them, a float32 lam split in three passes or a bfloat16 one in two;
    and matrot_apply_bwd's gw[i, j] = sum_b g[b, i] conj(x[j, b]), its mixed
    layout (MatrotGramMap): g in the (B, K) view read along i, x in the
    (K, B) view read along b, a float32 g in three passes or a bfloat16 one
    in two; and rotwin_apply_bwd's gw'[i, j'] = sum_x g[i, x] conj(x_pre[a,
    x, l]) with L = 16 < K (RotGramMap): g in the (K, X) view, x_pre read
    through pre(j', x) = a X L + x L + l, four a-groups in each 64-wide
    column tile, a float32 g in three passes or a bfloat16 one in two.  The
    tile's order of sums is the window case's; what differs is
    the operands' layout and the float32 operand's split.  Each is within
    CUDA_GRAM_TOL with all its passes, and not with one (x, and a float32 g,
    rounded to TF32 alone)."""
    K, C = 64, 2**14
    rows = view in ("matrot", "matrot_bwd")  # g (lam) (2, B, K): the depth b first
    x_rows = view == "matrot"  # psi (2, B, K); matrot_bwd's x is (2, K, B)
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=(2, C, K) if rows else (2, K, C)).astype(np.float32))
    g = g / g.norm()
    if g_dtype == "bfloat16":
        g = g.to(torch.bfloat16).float()
    x = torch.from_numpy(_state(20, 6)).reshape((2, C, K) if x_rows else (2, K, C))
    if view == "rotwin_bwd":  # x[:, j', c] = x_pre[:, pre(j', c)]
        L = 16
        j, c = torch.arange(K)[:, None], torch.arange(C)[None, :]
        x = x.reshape(2, -1)[:, (j // L) * C * L + c * L + j % L]
    got = _tc_gram(g, x, cuda_kernels.gram_splits(K, C), passes, g_dtype == "float32", rows,
                   x_rows)
    g64, x64 = g.double(), x.double()
    if rows:
        g64 = g64.transpose(1, 2)
    if x_rows:
        x64 = x64.transpose(1, 2)
    ref = torch.stack([g64[0] @ x64[0].T + g64[1] @ x64[1].T,
                       g64[1] @ x64[0].T - g64[0] @ x64[1].T])
    assert (_rel(got.double(), ref) <= CUDA_GRAM_TOL) == within


def _wgmma_forward(w: torch.Tensor, x: torch.Tensor, passes: int) -> torch.Tensor:
    """y = W x (x: (2, K, C)) as the forward wgmma kernel forms it: W split
    into hi + lo by its prologue's rounding, x split in registers the same
    way, lo read as TF32; per k8 step the two chains (Re: Ar Br then -Ai Bi;
    Im: Ar Bi then Ai Br) issue the passes x_lo W_hi, x_hi W_lo, x_hi W_hi
    (the last `passes` of them), each product exact and added to the
    stage's partial rounded toward zero; every 32-deep stage's partial joins
    the float32 running sum with a float32 add."""
    K, C = x.shape[1], x.shape[2]

    def parts(t):
        hi = _tf32_rna(t)
        return hi.double(), _tf32_read(t - hi).double()

    (wrh, wrl), (wih, wil) = parts(w[0]), parts(w[1])
    (xrh, xrl), (xih, xil) = parts(x[0]), parts(x[1])
    chains = (
        [(1, wrh, xrl), (1, wrl, xrh), (1, wrh, xrh)][-passes:]
        + [(-1, wih, xil), (-1, wil, xih), (-1, wih, xih)][-passes:],
        [(1, wih, xrl), (1, wil, xrh), (1, wih, xrh)][-passes:]
        + [(1, wrh, xil), (1, wrl, xih), (1, wrh, xih)][-passes:],
    )
    acc = torch.zeros((2, K, C), dtype=torch.float32)
    for s in range(0, K, 32):
        part = torch.zeros((2, K, C), dtype=torch.float32)
        for j in range(s, s + 32, 8):
            for c, terms in enumerate(chains):
                for sign, wt, xt in terms:
                    part[c] = _trunc32(part[c].double() + sign * (wt[:, j:j + 8] @ xt[j:j + 8]))
        acc += part
    return acc


def _chain_view(t: torch.Tensor, lo: int, hi: int, span: int = 17) -> torch.Tensor:
    """One L block (2, 2**span) as a window's (2, K, C) view: the columns
    c = a 2**lo + b of the (A, K, 2**lo) layout; for a minor window (lo = 0)
    the transpose of the row-major (C, K) block, as the chain kernels'
    wgmma product holds it (y^T = x^T W^T, the state's rows its columns)."""
    K = 2 ** (hi - lo)
    v = t.reshape(2, 2 ** (span - hi), K, 2**lo)
    return v.permute(0, 2, 1, 3).reshape(2, K, -1)


def _chain_unview(v: torch.Tensor, lo: int, hi: int, span: int = 17) -> torch.Tensor:
    K = 2 ** (hi - lo)
    return v.reshape(2, K, 2 ** (span - hi), 2**lo).permute(0, 2, 1, 3).reshape(2, -1)


@pytest.mark.unittest
@pytest.mark.parametrize("view,passes,within",
                         [("window", 3, True), ("window", 1, False), ("top", 3, True),
                          ("top", 1, False), ("matrot", 3, True), ("matrot", 1, False),
                          ("chain-rows", 3, True), ("chain-rows", 1, False),
                          ("chain-minor", 3, True), ("chain-minor", 1, False)],
                         ids=["3-True", "1-False", "top-3-True", "top-1-False", "matrot-3-True",
                              "matrot-1-False", "chain-rows-3-True", "chain-rows-1-False",
                              "chain-minor-3-True", "chain-minor-1-False"])
def test_split_tf32_forward_is_float32_grade(view, passes, within):
    """The forward windows' split-TF32 wgmma scheme, in the kernel's pass
    order, truncating sums and 32-deep promotion interval, is within
    CUDA_TOL of float64, and plain TF32 (one pass) is not: window_apply and
    rotmat_apply at K = 1024 on 64 columns, window_apply_top (Y = X W^T
    on the (A, K) view, formed as Y^T = W X^T) at the 22q plan's K = 64,
    two stages, on 1024 rows of X, and matrot_apply (y = (W x)^T on the
    (K, B) view, W x formed on the window view and stored along its rows)
    at the 24q plan's K = 256, eight stages, on 256 columns, against the
    plain version in float64; and chain_apply's window product (one
    2**17-amplitude L block of the 24q chain plan) on a row window (7, 15),
    K = 256 on the (4, 256, 128) view's 512 columns, and on the minor
    window (0, 8), Y = X W^T on the (512, 256) block formed as
    Y^T = W X^T, against chain_apply_plain in float64."""
    if view.startswith("chain"):
        lo, hi = (7, 15) if view == "chain-rows" else (0, 8)
        w = torch.from_numpy(_unitary_pair(hi - lo, 8))
        x = torch.from_numpy(_state(17, 9))
        got = _chain_unview(_wgmma_forward(w, _chain_view(x, lo, hi), passes), lo, hi)
        ref = kernels.chain_apply_plain(x.double(), [w.double()], ("L", 17),
                                        (("win", lo, hi),), 17)
        assert (_rel(got.double(), ref) <= CUDA_TOL) == within
        return
    k = {"window": 10, "top": 6, "matrot": 8}[view]
    K = 2**k
    w = torch.from_numpy(_unitary_pair(k, 8))
    x = torch.from_numpy(_state(16, 9)).reshape(2, K, -1)
    if view == "top":
        x = x.reshape(2, -1, K).transpose(1, 2)  # X^T: columns a, depth j
    got = _wgmma_forward(w, x, passes)
    w64, x64 = w.double(), x.double()
    if view == "matrot":  # y[b, i] at b K + i: the tile stored along its rows
        got = got.transpose(1, 2)
        ref = kernels.matrot_apply_plain(x64.reshape(2, -1), w64, 16 - k, 16).reshape(2, -1, K)
    else:
        ref = torch.stack([w64[0] @ x64[0] - w64[1] @ x64[1],
                           w64[0] @ x64[1] + w64[1] @ x64[0]])
    assert (_rel(got.double(), ref) <= CUDA_TOL) == within


@pytest.mark.unittest
@pytest.mark.parametrize("part,passes,within",
                         [("rows-gram", 3, True), ("rows-gram", 1, False),
                          ("minor-gram", 3, True), ("minor-gram", 1, False),
                          ("rows-pull", 3, True), ("rows-pull", 1, False),
                          ("minor-pull", 3, True), ("minor-pull", 1, False)])
def test_split_tf32_chain_adjoint_is_float32_grade(part, passes, within):
    """adjoint_chain's arithmetic on an 18-qubit state of two L blocks (the
    24q chain plan's geometry), float32 lam, against adjoint_chain_plain in
    float64: the gram G0 on the wgmma gram (k8 steps summed exactly and
    truncated, each term's passes small ones first, the same order as the
    mma.sync stage's), each block's K x K partial summed in 32-deep stages
    (3 passes: lam split too) and the blocks' partials added in order (two
    clusters, one block each), then gw = G0 W in float32, for a row window
    (7, 14) (both along the columns, K = 128 over 1024 columns a block) and
    a minor window (0, 7) (the (1024, 128) block's rows the depth); and the
    pullback psi_prev =
    W^dagger psi on the wgmma product through conj(W)^T's split planes
    (split_windows), a row window (7, 15) and a minor window (0, 8), K =
    256.  Each within its bound with all its passes (gw CUDA_GRAM_TOL, the
    state CUDA_TOL), and not with one."""
    n, span = 18, 17
    rows = part.startswith("rows")
    if part.endswith("gram"):
        lo, hi = (7, 14) if rows else (0, 7)
    else:
        lo, hi = (7, 15) if rows else (0, 8)
    K = 2 ** (hi - lo)
    w = torch.from_numpy(_unitary_pair(hi - lo, 11))
    psi, lam = torch.from_numpy(_state(n, 12)), torch.from_numpy(_state(n, 13))
    ref = kernels.adjoint_chain_plain(psi.double(), lam.double(), [w.double()], ("L", span),
                                      (("win", lo, hi),), n)
    blocks = [(psi[:, b * 2**span:(b + 1) * 2**span], lam[:, b * 2**span:(b + 1) * 2**span])
              for b in range(2 ** (n - span))]
    if part.endswith("pull"):
        wct = torch.stack([w[0].T, -w[1].T]).contiguous()  # conj(W)^T, split by the prologue
        got = torch.cat([_chain_unview(_wgmma_forward(wct, _chain_view(p, lo, hi), passes),
                                       lo, hi) for p, _ in blocks], dim=1)
        assert (_rel(got.double(), ref[0]) <= CUDA_TOL) == within
        return
    g0 = torch.zeros((2, K, K), dtype=torch.float32)
    for p, lm in blocks:  # each block's partial added to the slot, the slots in order
        if rows:
            g0 += _tc_gram(_chain_view(lm, lo, hi), _chain_view(p, lo, hi), 1, passes, True)
        else:
            g0 += _tc_gram(lm.reshape(2, -1, K), p.reshape(2, -1, K), 1, passes, True, True)
    gw = torch.stack([g0[0] @ w[0] - g0[1] @ w[1], g0[0] @ w[1] + g0[1] @ w[0]])
    assert (_rel(gw.double(), ref[2][0]) <= CUDA_GRAM_TOL) == within


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


# B1 on the card: K = 2 and 4 and two-column states (the scalar-staged
# tile), the 24q plan's (9, 8) and (0, 10) and the 22q plan's (0, 6) on the
# wgmma kernel, and K = 8 and 16 on both sides of its shape rule (B = 2:
# the tile; B = 64: wgmma).
@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,a,k", [(14, 3, 1), (14, 0, 2), (14, 12, 1), (10, 1, 5), (16, 0, 8), (18, 4, 9), (20, 0, 10),
              (24, 9, 8), (24, 0, 10), (22, 0, 6), (10, 6, 3), (12, 3, 3), (11, 6, 4), (12, 2, 4)]
)
def test_cuda_window_matches_plain(cuda, n, a, k):
    _check_cuda_window(cuda, n, a, k, top=False)


# B3 on the card: K = 2 and 4 (the scalar-staged tile), K = 64 with one row
# (the tile), the 22q plan's (22, 6) and K = 64-256 on the wgmma kernel, and
# K = 8 and 16 on both sides of its shape rule (A = 16: the tile; A = 512
# and 256: wgmma).
@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(12, 1), (12, 2), (6, 6), (16, 6), (16, 8), (18, 7), (22, 6),
                                 (7, 3), (12, 3), (8, 4), (12, 4)])
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
        cuda_kernels.window_apply(x.half(), w.half(), 1, 2, 8)
    # A float64 state runs the batch entry as a batch of one.
    before = cuda_kernels.launch_counts()["window_apply_batch"]
    got = cuda_kernels.window_apply(x.double(), w.double(), 1, 2, 8)
    assert cuda_kernels.launch_counts()["window_apply_batch"] == before + 1
    assert _rel(got.cpu(), kernels.window_apply_plain(x.double(), w.double(), 1, 2, 8).cpu()) <= 1e-12
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


# The shapes of the split-TF32 window kernels (window_apply_bwd and the
# adjoint step, whose pullback and gram it shares): edges (K = 2, 4 and 8
# with B = 2, which take the tile's scalar staging; K = 8 and 16 with B = 8,
# the smallest shapes of its 16-byte copies), the 24q plan's nine windows
# (a, k) = (9, 8), (2, 8), (7, 9), (8, 9), rotwin's (0, 9) and (0, 10), and a
# 26q K = 1024 window.
TC_WINDOW_CASES = [
    (14, 3, 1), (14, 0, 2), (14, 12, 1), (14, 11, 2), (12, 8, 3), (14, 3, 3), (12, 5, 4),
    (10, 1, 5), (16, 0, 8), (18, 4, 9), (20, 0, 10),
    (24, 9, 8), (24, 2, 8), (24, 7, 9), (24, 8, 9), (24, 0, 9), (24, 0, 10), (26, 0, 10),
]


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,a,k", TC_WINDOW_CASES)
def test_cuda_window_bwd_matches_plain(cuda, n, a, k, g_dtype, out_dtype):
    """At the split-TF32 tile's window shapes (TC_WINDOW_CASES), bf16 in and out."""
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


def _assert_adjoint_close(got, ref, lam_dtype):
    (pp, lp, gw), (rp, rl, rw) = got, ref
    assert pp.dtype == torch.float32
    assert _rel(pp.double().cpu(), rp.cpu()) <= CUDA_TOL
    _assert_bwd_close((lp, gw), (rl, rw), lam_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,a,k", TC_WINDOW_CASES)
def test_cuda_adjoint_step_matches_plain(cuda, n, a, k, lam_dtype, out_dtype):
    """K = 2 to 1024, B = 2 up, a = 0, the 24q and 26q plans' windows; lambda
    bf16 in and out."""
    out_dtype = getattr(torch, out_dtype)
    w, lam, psi = _bwd_inputs(cuda, n, k, 7 * n + a + k, getattr(torch, lam_dtype))
    before = cuda_kernels.launch_counts()["adjoint_step"]
    got = cuda_kernels.adjoint_step(w, psi, lam, a, k, n, out_dtype)
    ref = kernels.adjoint_step_plain(w.double(), psi.double(), lam.double(), a, k, n,
                                     torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["adjoint_step"] == before + 1
    _assert_adjoint_close(got, ref, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(12, 1), (12, 2), (6, 6), (16, 6), (16, 8), (22, 6), (7, 3)])
def test_cuda_adjoint_step_top_matches_plain(cuda, n, k, lam_dtype, out_dtype):
    """Top windows: K = 2 and 4 (the split-TF32 tile's scalar staging), a
    full-width window (one row), the 22q K = 64 one, K = 8 with A = 16 (the
    smallest 16-byte copies)."""
    out_dtype = getattr(torch, out_dtype)
    w, lam, psi = _bwd_inputs(cuda, n, k, 5 * n + k, getattr(torch, lam_dtype))
    before = cuda_kernels.launch_counts()["adjoint_step_top"]
    got = cuda_kernels.adjoint_step_top(w, psi, lam, k, n, out_dtype)
    ref = kernels.adjoint_step_top_plain(w.double(), psi.double(), lam.double(), k, n,
                                         torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["adjoint_step_top"] == before + 1
    _assert_adjoint_close(got, ref, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,r", [(5, 2), (13, 1), (13, 12), (20, 7), (24, 8)])
def test_cuda_rotate_pair_is_exact(cuda, n, r, lam_dtype):
    psi = torch.from_numpy(_state(n, r)).to(cuda)
    lam = torch.from_numpy(_state(n, r + 1)).to(cuda).to(getattr(torch, lam_dtype))
    before = cuda_kernels.launch_counts()["rotate_pair"]
    got_psi, got_lam = cuda_kernels.rotate_pair(psi, lam, r, n)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()["rotate_pair"] == before + 1
    assert got_psi.dtype == torch.float32 and got_lam.dtype == lam.dtype
    assert torch.equal(got_psi, kernels.rotate_plain(psi, r, n))
    assert torch.equal(got_lam, kernels.rotate_plain(lam, r, n))


@pytest.mark.cuda
def test_cuda_adjoint_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.from_numpy(_state(8, 0)).to(cuda)
    w = torch.from_numpy(_unitary_pair(2, 0)).to(cuda)
    with pytest.raises(TypeError):
        cuda_kernels.adjoint_step(w, x.to(torch.bfloat16), x, 1, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        cuda_kernels.adjoint_step(w, x, x.half(), 1, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        cuda_kernels.adjoint_step_top(w, x, x, 2, 8, torch.float16)
    with pytest.raises(ValueError):
        cuda_kernels.adjoint_step(w, x, x, 6, 2, 8, torch.float32)  # B = 1: the top kernel's
    with pytest.raises(ValueError):
        cuda_kernels.rotate_pair(x, x[:, ::2].contiguous(), 3, 8)
    with pytest.raises(ValueError):
        cuda_kernels.rotate_pair(x, x.cpu(), 3, 8)


# The fused (rotation, window) kernels: (kind, n, r, k) with k == r for
# rotmat, k == n - r for matrot and r < k < n for rotwin.  K = 2 windows,
# two-column states, the main path's 22-24q shapes and 26q planes (64-bit
# offsets) included.
FUSED_CASES = [
    ("rotmat", 6, 1, 1), ("rotmat", 9, 8, 8), ("rotmat", 16, 8, 8), ("rotmat", 26, 9, 9),
    ("matrot", 6, 5, 1), ("matrot", 9, 1, 8), ("matrot", 24, 16, 8), ("matrot", 26, 17, 9),
    ("rotwin", 6, 1, 3), ("rotwin", 10, 2, 5), ("rotwin", 22, 8, 10), ("rotwin", 26, 9, 10),
]


def _fused_geom(kind, r, k):
    return (r, k) if kind == "rotwin" else (r,)



# rotmat beyond FUSED_CASES, for its split-TF32 kernels (B6, B7 and B14): the
# 24q plan's rotmat (r = 8), K = 4 and K = 8 with X = 8 and X = 2 (scalar
# staging) and X = 256 (16-byte copies; B6's wgmma kernel).
ROTMAT_EXTRA = [
    ("rotmat", 24, 8, 8), ("rotmat", 5, 2, 2), ("rotmat", 4, 3, 3), ("rotmat", 11, 3, 3),
]

# matrot beyond FUSED_CASES, on both sides of B9's 16-byte copy rule
# (K >= 8 and B >= 8): K = 8 with B = 16 (copies), K = 16 with B = 4 and
# K = 4 with B = 8 (scalar staging); and of B8's wgmma rule (K >= 8 and
# B >= 32): K = 256 with B = 32 and K = 8 with B = 32 (wgmma, at its column
# and K edges), K = 256 with B = 16 (the tile, with copies).
MATROT_EXTRA = [("matrot", 7, 4, 3), ("matrot", 6, 2, 4), ("matrot", 5, 3, 2),
                ("matrot", 13, 5, 8), ("matrot", 12, 4, 8), ("matrot", 8, 5, 3)]

# rotwin beyond FUSED_CASES, on both sides of B11's 16-byte copy rule
# (K >= 8, X >= 8 and L >= 8): L = 8, K = 128, X = 32 (copies, each 64-wide
# column tile across eight a-groups), L = 8 with X = 8 (copies, at the X
# edge), X = 4 and L = 4 (scalar staging), and the 24q plan's (8, 9); and of
# B10's wgmma rule (K >= 8, X >= 32 and L >= 32): L = 32 with X = 32 (wgmma,
# at both edges), L = 16 and X = 16 (the tile).
ROTWIN_EXTRA = [("rotwin", 12, 3, 7), ("rotwin", 8, 3, 5), ("rotwin", 7, 3, 5),
                ("rotwin", 9, 2, 5), ("rotwin", 24, 8, 9), ("rotwin", 12, 5, 7),
                ("rotwin", 12, 4, 7), ("rotwin", 11, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,r,k", FUSED_CASES + ROTMAT_EXTRA + MATROT_EXTRA + ROTWIN_EXTRA)
def test_cuda_fused_window_matches_plain(cuda, kind, n, r, k):
    x = torch.from_numpy(_state(n, n + r)).to(cuda)
    w = torch.from_numpy(_unitary_pair(k, r)).to(cuda)
    name = f"{kind}_apply"
    before = cuda_kernels.launch_counts()[name]
    got = getattr(cuda_kernels, name)(x, w, *_fused_geom(kind, r, k), n)
    ref = getattr(kernels, f"{name}_plain")(x.double(), w.double(), *_fused_geom(kind, r, k), n)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before + 1
    assert _rel(got.double().cpu(), ref.cpu()) <= CUDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n,r,k", FUSED_CASES + ROTMAT_EXTRA + MATROT_EXTRA + ROTWIN_EXTRA)
def test_cuda_fused_window_bwd_matches_plain(cuda, kind, n, r, k, g_dtype, out_dtype):
    out_dtype = getattr(torch, out_dtype)
    w, g, x = _bwd_inputs(cuda, n, k, 11 * n + r, getattr(torch, g_dtype))
    name = f"{kind}_apply_bwd"
    before = cuda_kernels.launch_counts()[name]
    geom = _fused_geom(kind, r, k)
    got = getattr(cuda_kernels, name)(w, g, x, *geom, n, out_dtype)
    ref = getattr(kernels, f"{name}_plain")(w.double(), g.double(), x.double(), *geom, n,
                                            torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before + 1
    _assert_bwd_close(got, ref, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lam_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n,r,k",
                         [c for c in FUSED_CASES if c[0] != "rotwin"] + ROTMAT_EXTRA
                         + MATROT_EXTRA)
def test_cuda_fused_adjoint_matches_plain(cuda, kind, n, r, k, lam_dtype, out_dtype):
    out_dtype = getattr(torch, out_dtype)
    w, lam, psi = _bwd_inputs(cuda, n, k, 13 * n + r, getattr(torch, lam_dtype))
    name = f"adjoint_{kind}"
    before = cuda_kernels.launch_counts()[name]
    got = getattr(cuda_kernels, name)(w, psi, lam, r, n, out_dtype)
    ref = getattr(kernels, f"{name}_plain")(w.double(), psi.double(), lam.double(), r, n,
                                            torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before + 1
    _assert_adjoint_close(got, ref, out_dtype)


# A chain step of each geometry on a 20-qubit state (B17, B18): minor and row
# windows and a two-bit diagonal on L blocks, row windows and a diagonal
# across the rows and columns on H blocks.
CHAIN_STEPS_20 = {
    "chain-L": (("L", 17), (("win", 0, 8), ("win", 7, 15), ("diag", (16, 3)), ("win", 9, 17))),
    "chain-H": (("H", 8), (("win", 12, 20), ("diag", (19, 0)), ("win", 13, 20))),
}


def _chain_payloads(cuda, descs):
    return [torch.from_numpy(_unitary_pair(d[2] - d[1], i) if d[0] == "win"
                             else _diag_pair(d[1], i)).to(cuda) for i, d in enumerate(descs)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lam_dtype", [("step", "float32"), ("step", "bfloat16"),
                                            ("rotmat", "float32"), ("rotmat", "bfloat16"),
                                            ("matrot", "float32"), ("matrot", "bfloat16"),
                                            ("top", "float32"), ("top", "bfloat16"),
                                            ("chain-L", "float32"), ("chain-H", "float32")])
def test_cuda_adjoint_gradients_repeat_bit_for_bit(cuda, kind, lam_dtype):
    """Two launches of B12 / B13 / B14 / B15 / B18 on the same inputs give the
    same bits: the gram's split partials (B18: the clusters' slots) are
    summed in a fixed order, with no atomics."""
    n, k = 20, 8
    w, lam, psi = _bwd_inputs(cuda, n, k, 17, getattr(torch, lam_dtype))
    if kind in CHAIN_STEPS_20:
        geom, descs = CHAIN_STEPS_20[kind]
        pays = _chain_payloads(cuda, descs)
        first, second = (cuda_kernels.adjoint_chain(psi, lam, pays, geom, descs, n)
                         for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        assert all(torch.equal(a, b) for a, b in zip(first[2], second[2]))
        return
    if kind == "step":
        run = lambda: cuda_kernels.adjoint_step(w, psi, lam, 3, k, n, torch.bfloat16)  # noqa: E731
    elif kind == "top":
        run = lambda: cuda_kernels.adjoint_step_top(  # noqa: E731
            w, psi, lam, k, n, torch.bfloat16)
    elif kind == "rotmat":
        run = lambda: cuda_kernels.adjoint_rotmat(w, psi, lam, k, n, torch.bfloat16)  # noqa: E731
    else:
        run = lambda: cuda_kernels.adjoint_matrot(  # noqa: E731
            w, psi, lam, n - k, n, torch.bfloat16)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g_dtype", [("window", "float32"), ("window", "bfloat16"),
                                          ("rotmat", "float32"), ("rotmat", "bfloat16"),
                                          ("matrot", "float32"), ("matrot", "bfloat16"),
                                          ("rotwin", "float32"), ("rotwin", "bfloat16"),
                                          ("top", "float32"), ("top", "bfloat16")])
def test_cuda_saved_gradients_repeat_bit_for_bit(cuda, kind, g_dtype):
    """Two launches of B2 / B4 / B7 / B9 / B11 on the same inputs give the
    same bits: the gram's split partials are summed in a fixed order, with no
    atomics (B11 with L = 16 < K = 256; B4 over 16 splits of the A rows)."""
    n, k = 20, 8
    w, g, x = _bwd_inputs(cuda, n, k, 19, getattr(torch, g_dtype))
    if kind == "window":
        run = lambda: cuda_kernels.window_apply_bwd(w, g, x, 3, k, n, torch.bfloat16)  # noqa: E731
    elif kind == "rotmat":
        run = lambda: cuda_kernels.rotmat_apply_bwd(w, g, x, k, n, torch.bfloat16)  # noqa: E731
    elif kind == "rotwin":
        run = lambda: cuda_kernels.rotwin_apply_bwd(  # noqa: E731
            w, g, x, 4, k, n, torch.bfloat16)
    elif kind == "top":
        run = lambda: cuda_kernels.window_apply_top_bwd(  # noqa: E731
            w, g, x, k, n, torch.bfloat16)
    else:
        run = lambda: cuda_kernels.matrot_apply_bwd(  # noqa: E731
            w, g, x, n - k, n, torch.bfloat16)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,geom", [("window", 20, (3, 8)), ("window", 16, (0, 10)),
                                         ("rotmat", 20, (8,)), ("rotmat", 9, (8,)),
                                         ("top", 22, (6,)), ("top", 7, (3,)),
                                         ("matrot", 20, (12,)), ("rotwin", 20, (8, 9)),
                                         ("chain-L", 20, ()), ("chain-H", 20, ())])
def test_cuda_forward_windows_repeat_bit_for_bit(cuda, kind, n, geom):
    """Two launches of B1 / B6 / B3 / B8 / B10 / B17 on the same inputs give
    the same bits: every output is written once, by one block, with no
    atomics (the wgmma kernel; rotmat n = 9, r = 8, two columns, and the top
    window with 16 rows of K = 8, on adjoint_tc.cuh's tile; matrot's
    K = 2^(n - r); rotwin's L = 256 < K = 512; a chain step of each
    geometry)."""
    x = torch.from_numpy(_state(n, 23)).to(cuda)
    if kind in CHAIN_STEPS_20:
        chain_geom, descs = CHAIN_STEPS_20[kind]
        pays = _chain_payloads(cuda, descs)
        first, second = (cuda_kernels.chain_apply(x, pays, chain_geom, descs, n)
                         for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        return
    k = n - geom[0] if kind == "matrot" else geom[-1]
    w = torch.from_numpy(_unitary_pair(k, 29)).to(cuda)
    name = "window_apply_top" if kind == "top" else f"{kind}_apply"
    run = lambda: getattr(cuda_kernels, name)(x, w, *geom, n)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,n,r,k", [("rotmat", 12, 4, 4), ("matrot", 12, 4, 8), ("rotwin", 12, 4, 6)] + ROTWIN_EXTRA,
    ids=["rotmat", "matrot", "rotwin"] + ["-".join(map(str, c)) for c in ROTWIN_EXTRA])
def test_cuda_fused_autograd_matches_plain_autograd(cuda, kind, n, r, k):
    """The fused kernels' autograd Functions (backward = the *_bwd kernel)
    against autograd over the plain versions, in float64 on the card;
    rotwin's also on both sides of B11's copy rule."""
    x = torch.from_numpy(_state(n, 1)).to(cuda)
    w = torch.from_numpy(_unitary_pair(k, 2)).to(cuda)
    g = torch.from_numpy(_state(n, 3)).to(cuda)
    geom = _fused_geom(kind, r, k)

    def run(fn, dtype):
        xx = x.detach().to(dtype).clone().requires_grad_()
        ww = w.detach().to(dtype).clone().requires_grad_()
        fn(xx, ww, *geom, n).backward(g.to(dtype))
        return xx.grad, ww.grad

    before = cuda_kernels.launch_counts()[f"{kind}_apply_bwd"]
    got = run(getattr(cuda_kernels, f"{kind}_apply"), torch.float32)
    ref = run(getattr(kernels, f"{kind}_apply_plain"), torch.float64)
    assert cuda_kernels.launch_counts()[f"{kind}_apply_bwd"] == before + 1
    assert _rel(got[0].double().cpu(), ref[0].cpu()) <= CUDA_TOL
    assert _rel(got[1].double().cpu(), ref[1].cpu()) <= CUDA_GRAM_TOL


@pytest.mark.cuda
def test_cuda_fused_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.from_numpy(_state(8, 0)).to(cuda)
    w = torch.from_numpy(_unitary_pair(2, 0)).to(cuda)
    with pytest.raises(ValueError):
        cuda_kernels.rotmat_apply(x, w, 3, 8)  # a K = 4 window is r = 2
    with pytest.raises(ValueError):
        cuda_kernels.rotwin_apply(x, w, 2, 2, 8)  # k == r is rotmat's
    with pytest.raises(ValueError):
        cuda_kernels.matrot_apply(x, w, 0, 8)
    with pytest.raises(TypeError):
        cuda_kernels.matrot_apply_bwd(w, x, x, 6, 8, torch.float16)
    with pytest.raises(TypeError):
        cuda_kernels.adjoint_rotmat(w, x, x.half(), 2, 8, torch.float32)
    with pytest.raises(ValueError):
        cuda_kernels.adjoint_matrot(w, x, x[:, ::2].contiguous(), 6, 8, torch.float32)


# ---------------------------------------------------------------------------
# The chain kernels (B17 chain_apply, B18 adjoint_chain) on the card
# ---------------------------------------------------------------------------


def _chain_plan(n):
    """The chain plan of the n-qubit Circuit_19 model (2 layers, seed 5,
    input 0.37), planned on the CPU."""
    from qml_essentials_tpu_torch.models.model import Model
    from qml_essentials_tpu_torch.ops import chains
    from qml_essentials_tpu_torch.ops.tape import recording

    model = Model(n_qubits=n, n_layers=2, circuit_type="Circuit_19", random_seed=5, device="cpu")
    with recording() as tape, torch.no_grad():
        model._variational(model.params[0], torch.tensor([0.37]))
    return [step[1] for step in chains.plan_chains(tape, n)]


def _diag_pair(bits, seed):
    phases = np.random.default_rng(seed).uniform(-np.pi, np.pi, size=2 ** len(bits))
    return np.stack([np.cos(phases), np.sin(phases)]).astype(np.float32)


def _check_cuda_chain(cuda, n, geom, descs, pays, seed):
    """B17 and B18 against their plain versions in float64: the states 1e-5
    relative, each descriptor's cotangent 1e-4 (fp32 sums over a block's
    columns, then over the blocks in a fixed order)."""
    x = torch.from_numpy(_state(n, seed)).to(cuda)
    lam = torch.from_numpy(_state(n, seed + 1)).to(cuda)
    pays = [p.to(cuda) for p in pays]
    before = cuda_kernels.launch_counts()
    y = cuda_kernels.chain_apply(x, pays, geom, descs, n)
    got = cuda_kernels.adjoint_chain(x, lam, pays, geom, descs, n)
    p64 = [p.double() for p in pays]
    ref_y = kernels.chain_apply_plain(x.double(), p64, geom, descs, n)
    ref = kernels.adjoint_chain_plain(x.double(), lam.double(), p64, geom, descs, n)
    torch.cuda.synchronize()
    after = cuda_kernels.launch_counts()
    assert after["chain_apply"] == before["chain_apply"] + 1
    assert after["adjoint_chain"] == before["adjoint_chain"] + 1
    assert _rel(y.double().cpu(), ref_y.cpu()) <= CUDA_TOL
    assert _rel(got[0].double().cpu(), ref[0].cpu()) <= CUDA_TOL
    assert got[1].dtype == torch.float32
    assert _rel(got[1].double().cpu(), ref[1].cpu()) <= CUDA_TOL
    assert len(got[2]) == len(descs)
    for g, r, p in zip(got[2], ref[2], pays):
        assert g.shape == p.shape and g.dtype == torch.float32
        assert _rel(g.double().cpu(), r.cpu()) <= CUDA_GRAM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [22, 24])
def test_cuda_chain_kernels_match_plain_on_the_plan(cuda, n):
    """Every step of the Circuit_19 chain plan at the main path's widths."""
    for i, (geom, descs, pays) in enumerate(_chain_plan(n)):
        pairs = [torch.stack([p.real, p.imag]).contiguous() for p in pays]
        _check_cuda_chain(cuda, n, geom, descs, pairs, 7 * i)


@pytest.mark.cuda
@pytest.mark.parametrize("n,geom,descs", [
    (18, ("L", 17), (("diag", (17,)), ("win", 0, 9), ("win", 9, 17), ("diag", (5, 2)))),
    (18, ("L", 17), (("win", 7, 14),)),
    (18, ("H", 8), (("win", 10, 18), ("diag", (17, 3)), ("win", 11, 18))),
    (18, ("H", 8), (("diag", (12,)),)),
    (12, ("L", 10), (("win", 7, 9), ("diag", (8, 1)))),
    (18, ("L", 17), (("win", 0, 1), ("win", 3, 4), ("win", 0, 2), ("win", 2, 5), ("win", 4, 9),
                     ("win", 5, 8))),
    (15, ("H", 8), (("win", 7, 15), ("win", 13, 15), ("diag", (14, 6)))),
], ids=["L-K512-diags", "L-one-window", "H-wrap-diag", "H-one-diag", "L10-K4-diag",
        "L-sub-rule", "H-128-columns"])
def test_cuda_chain_kernels_match_plain_on_edges(cuda, n, geom, descs):
    """18 qubits: the K = 512 minor window, one-bit diagonals, a step of one
    descriptor (no workspace), H windows at the register's top; and the
    windows under the wgmma rule on the mma.sync product: a K = 4 window on
    a 10-bit L block, K = 2 and 4 (minor and row windows), K = 8 with a
    4-column run (its gram without 16-byte copies), K = 32 with a 16-column
    run and K = 8 with 32 (on wgmma, K < 32 deep); H blocks of 128 columns
    at 15 qubits with a K = 4 window."""
    pays = [torch.from_numpy(_unitary_pair(d[2] - d[1], i) if d[0] == "win"
                             else _diag_pair(d[1], i)) for i, d in enumerate(descs)]
    _check_cuda_chain(cuda, n, geom, descs, pays, 3)


@pytest.mark.cuda
def test_cuda_chain_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    n = 18
    x = torch.from_numpy(_state(n, 0)).to(cuda)
    w = torch.from_numpy(_unitary_pair(7, 0)).to(cuda)
    with pytest.raises(ValueError):
        cuda_kernels.chain_apply(x, [w], ("L", 17), (("win", 11, 18),), n)  # outside L
    with pytest.raises(ValueError):
        cuda_kernels.chain_apply(x, [w], ("H", 8), (("win", 9, 16),), n)  # outside H
    with pytest.raises(ValueError):
        cuda_kernels.chain_apply(x, [w[:, 0, :8].contiguous()], ("L", 17),
                                 (("diag", (1, 2, 3)),), n)  # three bits
    with pytest.raises(TypeError):
        cuda_kernels.chain_apply(x, [w.double()], ("L", 17), (("win", 7, 14),), n)
    with pytest.raises(RuntimeError, match="no autograd backward"):
        cuda_kernels.chain_apply(x, [w.clone().requires_grad_()], ("L", 17),
                                 (("win", 7, 14),), n)


# ---------------------------------------------------------------------------
# Batch entries of B1-B4 (csrc/window_batch.cuh): a (2, Bt, 2**n) state, a
# shared (2, K, K) or a per-element (Bt, 2, K, K) window
# ---------------------------------------------------------------------------


def _batch_inputs(n, k, bt, seed, shared):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, bt, 2**n))
    x /= np.linalg.norm(x, axis=(0, 2), keepdims=True)
    g = rng.normal(size=(2, bt, 2**n))
    if shared:
        w = _unitary_pair(k, seed)
    else:
        w = np.stack([_unitary_pair(k, seed + e).transpose(0, 1, 2) for e in range(bt)])
    return (torch.from_numpy(x.astype(np.float32)), torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy((g / np.linalg.norm(g)).astype(np.float32)))


def _jax_batch(n, a, k, x, w, g, shared):
    """The JAX package's Pallas kernels (interpret mode) under jax.vmap over
    the batch, as tests/test_pallas.py runs them: forward, pullback, gram."""
    import jax
    import jax.numpy as jnp

    from qml_essentials_tpu.ops import pallas_kernels

    xs = jnp.asarray(x.numpy().transpose(1, 0, 2))
    gs = jnp.asarray(g.numpy().transpose(1, 0, 2))
    ws = jnp.asarray(np.broadcast_to(w.numpy(), (x.shape[1], 2, 2**k, 2**k))
                     if shared else w.numpy())
    top = a + k == n
    if top:
        fwd = jax.vmap(lambda p, m: pallas_kernels.window_apply_top_ri(p, m, k, n, True))
        bwd = jax.vmap(lambda m, c, p: pallas_kernels._apply_top_bwd(m, c, p, k, n, True))
    else:
        fwd = jax.vmap(lambda p, m: pallas_kernels.window_apply_ri(p, m, a, k, n, True))
        bwd = jax.vmap(lambda m, c, p: pallas_kernels._apply_bwd(m, c, p, a, k, n, True))
    y = np.asarray(fwd(xs, ws)).transpose(1, 0, 2)
    prev = pallas_kernels.GRAM_MODE
    pallas_kernels.set_gram_mode("split3")  # the gram at float32 grade, as test_pallas.py pins
    try:
        gp, gw = (np.asarray(t) for t in bwd(ws, gs, xs))
    finally:
        pallas_kernels.set_gram_mode(prev)
    return y, gp.transpose(1, 0, 2), gw.sum(0) if shared else gw


# n <= 10, per-element and shared W, windows inside the register and on top.
BATCH_PLAIN_CASES = [(6, 1, 3, 5), (6, 3, 3, 4), (8, 0, 2, 3), (10, 2, 5, 3), (5, 4, 1, 6)]


@pytest.mark.unittest
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", BATCH_PLAIN_CASES)
def test_batched_plain_matches_vmapped_pallas(n, a, k, bt, shared):
    """The plain versions of B1-B4 on a batched state against jax.vmap of
    the Pallas kernels: outputs, state cotangents and matrix cotangents (one
    an element, or their sum for a shared window)."""
    x, w, g = _batch_inputs(n, k, bt, 10 * n + a + k, shared)
    ref_y, ref_gp, ref_gw = _jax_batch(n, a, k, x, w, g, shared)
    if a + k == n:
        y = kernels.window_apply_top_plain(x, w, k, n)
        gp, gw = kernels.window_apply_top_bwd_plain(w, g, x, k, n, torch.float32)
    else:
        y = kernels.window_apply_plain(x, w, a, k, n)
        gp, gw = kernels.window_apply_bwd_plain(w, g, x, a, k, n, torch.float32)
    assert tuple(gw.shape) == tuple(w.shape)
    assert _rel(y, ref_y) <= PALLAS_TOL
    assert _rel(gp, ref_gp) <= PALLAS_TOL
    assert _rel(gw, ref_gw) <= 1e-4


@pytest.mark.unittest
def test_batched_plain_is_the_loop_of_single_elements():
    """Per element, the batched plain versions are the single-state ones."""
    n, a, k, bt = 7, 2, 3, 4
    x, w, g = (t.double() for t in _batch_inputs(n, k, bt, 3, False))
    y = kernels.window_apply_plain(x, w, a, k, n)
    gp, gw = kernels.window_apply_bwd_plain(w, g, x, a, k, n, torch.float64)
    for e in range(bt):
        assert torch.allclose(y[:, e], kernels.window_apply_plain(x[:, e], w[e], a, k, n),
                              atol=1e-14)
        gpe, gwe = kernels.window_apply_bwd_plain(w[e], g[:, e], x[:, e], a, k, n, torch.float64)
        assert torch.allclose(gp[:, e], gpe, atol=1e-14) and torch.allclose(gw[e], gwe, atol=1e-14)
    rot = kernels.rotate_plain(x, 3, n)
    for e in range(bt):
        assert torch.equal(rot[:, e], kernels.rotate_plain(x[:, e], 3, n))


# The batch backward's launch geometry (cuda_kernels.batch_bwd_geometry) and
# its schedule, as csrc/window_batch.cuh's backward_kernel walks it.

_BWD_STATIC_SMEM = 256 * 16 + 16  # the kernel's tree buffer and flag


def _bwd_ctas(geom):
    """Per CTA of a batch backward launch, in blockIdx order: (gram group,
    output block, part, [(first column, columns) of each tile it walks])."""
    C = geom.A * geom.B
    Q = geom.E * C
    cg = geom.tc if geom.group else (C if geom.w_stride else Q)
    for b in range(geom.grid):
        grp, u, s = b // (geom.blocks * geom.parts), b // geom.parts % geom.blocks, b % geom.parts
        gq0 = grp * cg
        gcols = min(cg, Q - gq0)
        k1 = min(-(-gcols // geom.tc), (s + 1) * geom.tpc)
        yield grp, u, s, [(gq0 + kt * geom.tc, min(geom.tc, gcols - kt * geom.tc))
                          for kt in range(s * geom.tpc, k1)]


def _check_bwd_geometry(E, A, K, B, per_element, f64):
    geom = cuda_kernels.batch_bwd_geometry(E, A, K, B, per_element, f64)
    C = A * B
    Q = E * C
    assert geom.smem + _BWD_STATIC_SMEM <= 48 * 1024  # no opt-in, and 227 KB a fortiori
    assert geom.grid < 2**31 and geom.counters <= cuda_kernels._BWD_COUNTERS
    assert geom.slots * 2 * geom.block * (8 if f64 else 4) <= 8 * 2**20
    outputs = geom.group * K * K if geom.group else geom.block
    assert outputs <= 1024 and (outputs < 256 or outputs % 256 == 0)
    if geom.parts > 1:
        assert geom.parts * 2 * geom.block <= cuda_kernels._BWD_FINAL
    covered = [[] for _ in range(geom.blocks)]
    for grp, u, s, tiles in _bwd_ctas(geom):
        assert tiles, f"CTA ({grp}, {u}, {s}) walks no tile"
        for q0, cols in tiles:
            assert 0 < cols <= geom.tc
            if geom.group:  # whole elements
                assert q0 % C == 0 and cols % C == 0 and cols <= geom.group * C
            elif per_element:  # inside the CTA's element
                assert q0 // C == grp and (q0 + cols - 1) // C == grp
            covered[u].append((q0, cols))
    for tiles in covered:  # every column once in every output block
        tiles.sort()
        ends = [0] + [q0 + cols for q0, cols in tiles]
        assert [q0 for q0, _ in tiles] == ends[:-1] and ends[-1] == Q
    return geom


# Edges of the geometry: whole elements with a ragged last CTA, a shared
# batch whose tiles span elements with a ragged last tile, an element split
# over CTAs (n = 20, K = 32), a wide shared batch, output blocks (K = 64, 128),
# a window too wide to stage (K = 4096), top windows.
BWD_GEOMETRY_CASES = [(1001, 1, 4, 4), (20000, 8, 8, 1), (2, 8, 32, 4096), (65536, 8, 8, 1),
                      (3, 2, 64, 1), (5, 1, 128, 8), (1, 1, 2**12, 1), (7, 32, 32, 1),
                      (1, 2**19, 2, 1), (1, 1, 2, 2**20)]


@pytest.mark.unittest
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("per_element", [False, True], ids=["shared", "per_element"])
@pytest.mark.parametrize("E,A,K,B", BWD_GEOMETRY_CASES)
def test_batch_bwd_geometry_covers_every_column_once(E, A, K, B, per_element, f64):
    """The batch backward's tiles cover every column of every element once
    in each output block, a CTA's tiles stay inside its element (or hold
    whole elements), and a CTA fits the shared memory a launch takes
    without asking."""
    _check_bwd_geometry(E, A, K, B, per_element, f64)


@pytest.mark.unittest
def test_batch_bwd_geometry_at_the_smoke_runs_shapes():
    """Every batch shape chip_smoke.py runs (phase 5g's workloads, read off
    them on the CPU), both window modes and both dtypes: the geometry covers
    and fits as above; the 6q gradient's calls take a CTA an SM (128)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = smoke.batch_shapes()
    for n, a, k, _, bt, _ in shapes["fwd"] + shapes["bwd"]:
        for per_element in (False, True):
            for f64 in (False, True):
                _check_bwd_geometry(bt, 2**a, 2**k, 2 ** (n - a - k), per_element, f64)
    for n, a, k, per_element, bt, f64 in shapes["bwd"]:
        geom = cuda_kernels.batch_bwd_geometry(bt, 2**a, 2**k, 2 ** (n - a - k), per_element, f64)
        assert geom.grid == cuda_kernels._BWD_TARGET, geom


def _emulate_bwd(geom, w, g, x):
    """backward_kernel's schedule in complex128 on the CPU: each CTA's tiles
    read at the kernel's offsets, its pullback rows written where the kernel
    writes them, its gram outputs to gw or to their slot, and the last CTA of
    a gram block summing the slots; unwritten values stay NaN."""
    E, A, K, B = geom.E, geom.A, geom.K, geom.B
    C, KK = A * B, K * K
    gc, xc = (torch.complex(t[0], t[1]).reshape(-1) for t in (g, x))
    W = torch.complex(w[..., 0, :, :], w[..., 1, :, :]).reshape(-1, K, K)
    gp = torch.full_like(gc, complex("nan"))
    gw = torch.full((W.shape[0], KK), complex("nan"), dtype=gc.dtype)
    slots = torch.full((geom.slots, geom.block), complex("nan"), dtype=gc.dtype)
    arrived = {}
    run = min(B, geom.tc)
    no = geom.group * KK if geom.group else geom.block
    for grp, u, s, tiles in _bwd_ctas(geom):
        acc = torch.zeros(no, dtype=gc.dtype)
        j0, j1 = -(-u * K // geom.blocks), -(-(u + 1) * K // geom.blocks)
        e0 = tiles[0][0] // C
        for q0, cols in tiles:
            c = torch.arange(cols)
            base = q0 // B * K * B + q0 % B
            at = base + (c // run * K * B + c % run)[None, :] + (torch.arange(K) * B)[:, None]
            gt, xt = gc[at], xc[at]
            e = (q0 + c) // C
            we = W[e] if geom.w_stride else W[0].expand(cols, K, K)
            gp[at[j0:j1]] = torch.einsum("cij,ic->jc", we.conj(), gt)[j0:j1]
            if geom.group:
                for ge in range(cols // C):
                    sl = slice(ge * C, (ge + 1) * C)
                    acc[ge * KK:(ge + 1) * KK] += (gt[:, sl] @ xt[:, sl].conj().T).reshape(-1)
            else:
                o = u * no + torch.arange(no)
                acc += (gt[o // K] * xt[o % K].conj()).sum(1)
        if geom.group:
            for ge in range(tiles[0][1] // C):
                gw[e0 + ge] = acc[ge * KK:(ge + 1) * KK]
            continue
        row = grp if geom.w_stride else 0
        if geom.parts == 1:
            gw[row, u * no:(u + 1) * no] = acc
            continue
        gb = grp * geom.blocks + u
        slots[gb * geom.parts + s] = acc
        arrived[gb] = arrived.get(gb, 0) + 1
        if arrived[gb] == geom.parts:
            gw[row, u * no:(u + 1) * no] = slots[gb * geom.parts:(gb + 1) * geom.parts].sum(0)
    gp = gp.reshape(E, -1)
    gw = gw.reshape(W.shape[0], K, K)
    return (torch.stack([gp.real, gp.imag]),
            torch.stack([gw.real, gw.imag], dim=1).reshape(w.shape))


# Small shapes of every branch: whole elements (ragged last CTA), a shared
# batch (ragged last tile, tiles spanning elements), top windows, an element
# split over CTAs (n = 12, K = 32), output blocks (K = 64), float64 tiles.
BWD_EMULATION_CASES = [(6, 1, 3, 7), (6, 3, 3, 7), (6, 0, 2, 256), (4, 0, 2, 1001),
                       (12, 3, 5, 2), (12, 7, 5, 2), (7, 0, 6, 3), (7, 1, 6, 2), (3, 0, 3, 9)]


@pytest.mark.unittest
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", BWD_EMULATION_CASES)
def test_batch_bwd_schedule_matches_plain(n, a, k, bt, shared, f64):
    """The batch backward's schedule writes every value of gp and gw once,
    from the right tiles and windows: its emulation in complex128 against
    the plain version, 1e-12 relative."""
    x, w, g = (t.double() for t in _batch_inputs(n, k, bt, n + a + k + bt, shared))
    geom = cuda_kernels.batch_bwd_geometry(bt, 2**a, 2**k, 2 ** (n - a - k), not shared, f64)
    gp, gw = _emulate_bwd(geom, w, g, x)
    if a + k == n:
        rp, rw = kernels.window_apply_top_bwd_plain(w, g, x, k, n, torch.float64)
    else:
        rp, rw = kernels.window_apply_bwd_plain(w, g, x, a, k, n, torch.float64)
    assert not gp.isnan().any() and not gw.isnan().any()
    assert _rel(gp, rp) <= 1e-12 and _rel(gw, rw) <= 1e-12


# The batch forward's launch geometry (cuda_kernels.batch_fwd_geometry) and
# its schedule, as csrc/window_batch.cuh's forward_kernel walks it.

_SMEM_PER_BLOCK = 232448  # an H100 CTA's shared memory at most (227 KB)


def _fwd_replay(geom, x, w, grid=None):
    """forward_kernel's schedule on the CPU, in numpy: each CTA's tiles
    (``b, b + grid, ...``) copied segment by segment into a shared-memory
    array (NaN where nothing was copied) with their windows, each thread's
    column read from its slots, its K outputs written back over them and
    the tile stored; the wide path's items column slice by column slice.
    Returns ``y`` (NaN where nothing was written) and how often each
    output was written."""
    E, A, K, B = geom.E, geom.A, geom.K, geom.B
    Q, KK, EA = E * A * B, K * K, E * A
    plane = Q * K
    xf = np.asarray(x, dtype=np.float64).reshape(2, plane)
    wf = np.asarray(w, dtype=np.float64).reshape(-1)
    y = np.full((2, plane), np.nan)
    count = np.zeros((2, plane), dtype=np.int64)

    def window(e, rows):  # W_e[rows, :] of elements e, complex: (..., R, K)
        at = (np.asarray(e) * geom.w_stride)[..., None, None] + \
            np.asarray(rows)[..., :, None] * K + np.arange(K)
        return wf[at] + 1j * wf[at + KK]

    if geom.rows < K:  # forward_wide
        R = geom.rows
        S = K // R
        u = np.arange(geom.tiles)
        grp = u >> 5
        s = grp % S
        q = (grp // S) * 32 + u % 32
        keep = q < Q
        s, q = s[keep], q[keep]
        base = q // B * K * B + q % B
        cols = base[:, None] + np.arange(K)[None, :] * B
        X = xf[0][cols] + 1j * xf[1][cols]
        rows = s[:, None] * R + np.arange(R)[None, :]
        Y = np.einsum("crj,cj->cr", window(q // B // A, rows), X)
        out = base[:, None] + rows * B
        np.add.at(count[0], out, 1)
        np.add.at(count[1], out, 1)
        y[0][out], y[1][out] = Y.real, Y.imag
        return y, count

    tc, pad, dim, wdim = geom.tc, geom.pad, geom.dim, geom.wdim
    flat = tc > B
    run = B if flat else tc
    sstr = K * B + pad if flat else tc
    seglen, gstr, segmax = (K * B, K * B, tc // B) if flat else (tc, B, K)
    one_w = geom.w_stride == 0
    grid = grid or geom.grid
    for b in range(grid):
        for kt in range(b, geom.tiles, grid):
            q0 = kt * tc
            ea0 = q0 // B
            nseg = min(segmax, EA - ea0) if flat else K
            g0 = ea0 * K * B + q0 % B
            sm = np.full(2 * dim + wdim, np.nan)
            sidx = (np.arange(nseg)[:, None] * sstr + np.arange(seglen)[None, :]).ravel()
            gidx = (g0 + np.arange(nseg)[:, None] * gstr + np.arange(seglen)[None, :]).ravel()
            assert sidx.max() < dim and np.unique(sidx).size == sidx.size
            sm[sidx], sm[dim + sidx] = xf[0][gidx], xf[1][gidx]
            if wdim:
                e0, e1 = ea0 // A, (ea0 + (nseg if flat else 1) - 1) // A
                nw = (e1 - e0 + 1) * 2 * KK
                assert nw <= wdim
                sm[2 * dim:2 * dim + nw] = wf[e0 * 2 * KK:e0 * 2 * KK + nw]
            t = np.arange(min(tc, Q - q0))
            off = t // run * sstr + t % run
            rd = off[:, None] + np.arange(K)[None, :] * run
            X = sm[rd] + 1j * sm[dim + rd]
            if one_w:
                W = window(0, np.arange(K))[None]
            elif not wdim:  # own windows read in place
                W = window((ea0 + t // run) // A, np.arange(K))
            else:
                el = (ea0 + t // B) // A - ea0 // A if flat else np.zeros_like(t)
                at = (2 * dim + el * 2 * KK)[:, None, None] + \
                    np.arange(K)[:, None] * K + np.arange(K)[None, :]
                W = sm[at] + 1j * sm[at + KK]
            Y = np.einsum("cij,cj->ci", W, X)
            sm[rd], sm[dim + rd] = Y.real, Y.imag
            y[0][gidx], y[1][gidx] = sm[sidx], sm[dim + sidx]
            count[0][gidx] += 1
            count[1][gidx] += 1
    return y, count


def _fwd_inputs(n, k, bt, per_element, seed):
    """A float64 batch and windows for the replay: the windows need not be
    unitary, so no QR per element (K = 1024 at the edges)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, bt, 2**n))
    K = 2**k
    wshape = (bt, 2, K, K) if per_element else (2, K, K)
    return torch.from_numpy(x), torch.from_numpy(rng.normal(size=wshape))


def _check_fwd_geometry(n, a, k, bt, per_element, f64):
    """The launch at the full batch fits the card; its schedule, replayed at
    a batch cut to at most three tiles' worth of elements more than a
    multiple of the tile (the same last tile), writes every output once and
    gives the plain version's values."""
    A, K, B = 2**a, 2**k, 2 ** (n - a - k)
    geom = cuda_kernels.batch_fwd_geometry(bt, A, K, B, per_element, f64)
    Q = bt * A * B
    assert geom.threads % 32 == 0 and 32 <= geom.threads <= 256 and 1 <= geom.grid
    assert geom.grid <= max(geom.tiles, 1) and geom.smem <= _SMEM_PER_BLOCK
    if geom.rows == K:
        V = 16 // (8 if f64 else 4)
        assert geom.threads == geom.tc and geom.smem <= cuda_kernels._FWD_SMEM
        assert (geom.tiles - 1) * geom.tc < Q <= geom.tiles * geom.tc
        assert geom.dim % V == 0 and geom.pad % V == 0
    else:
        assert K > cuda_kernels._FWD_KREG[f64] and geom.tc == 0
        assert geom.tiles == -(-Q // 32) * 32 * (K // geom.rows)
    small = geom
    if geom.tc and bt > 3 * geom.tc:  # the same layout over fewer tiles
        cut = bt % geom.tc + 2 * geom.tc
        tiles = -(-cut * A * B // geom.tc)
        small = geom._replace(E=cut, tiles=tiles, grid=min(tiles, geom.grid))
    x, w = _fwd_inputs(n, k, small.E, per_element, n + a + k)
    for grid in (None, 3) if small.tc and small.tiles <= 64 else (None,):
        y, count = _fwd_replay(small, x, w, grid)
        assert (count == 1).all()
        ref = (kernels.window_apply_top_plain(x, w, k, n) if a + k == n else
               kernels.window_apply_plain(x, w, a, k, n))
        assert _rel(y.reshape(ref.shape), ref) <= 1e-12
    return geom


# The forward shapes chip_smoke.py's phase 5g runs (n, a, k, Bt:
# chip_smoke.batch_shapes(), both window modes and dtypes below), its
# BATCH_EDGE_CASES, and edges of the geometry: a ragged last tile, a K = 64
# and a K = 1024 window above the register budget, a K = 32 float64 window
# (wide there), tiles of runs (B >= 256), a top window with A = 2**15.
FWD_SMOKE_SHAPES = [
    (4, 0, 1, 10000), (4, 0, 2, 10000), (4, 1, 1, 10000), (4, 1, 2, 10000), (4, 2, 1, 10000),
    (4, 2, 2, 10000), (4, 3, 1, 10000), (6, 0, 2, 256), (6, 0, 2, 416000), (6, 0, 3, 256),
    (6, 0, 3, 416000), (6, 1, 2, 416000), (6, 1, 3, 256), (6, 1, 3, 416000), (6, 2, 3, 416000),
    (6, 3, 3, 256), (6, 3, 3, 416000), (6, 5, 1, 416000), (10, 0, 2, 5), (10, 0, 5, 5),
    (10, 1, 5, 5), (10, 5, 5, 5)]
FWD_EDGE_SHAPES = [(20, 3, 5, 2), (6, 3, 3, 65536), (10, 5, 5, 7), (10, 0, 10, 2),
                   (5, 1, 2, 1001), (8, 1, 6, 3), (11, 0, 10, 2), (7, 1, 5, 9), (12, 0, 2, 7),
                   (15, 0, 2, 1)]
FWD_GEOMETRY_SHAPES = FWD_SMOKE_SHAPES + FWD_EDGE_SHAPES


@pytest.mark.unittest
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("per_element", [False, True], ids=["shared", "per_element"])
@pytest.mark.parametrize("n,a,k,bt", FWD_GEOMETRY_SHAPES)
def test_batch_fwd_geometry_covers_every_output_once(n, a, k, bt, per_element, f64):
    """The batch forward's tiles and columns write every output of every
    element once, from the right window, within the shared memory a CTA
    may take (two CTAs an SM for the staged path)."""
    _check_fwd_geometry(n, a, k, bt, per_element, f64)


@pytest.mark.unittest
def test_batch_fwd_geometry_at_the_smoke_runs_shapes():
    """Every forward shape chip_smoke.py runs in phase 5g (read off its
    workloads on the CPU) and every one of its edge shapes is among the
    shapes above."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = smoke.batch_shapes()
    assert {(n, a, k, bt) for n, a, k, _, bt, _ in shapes["fwd"]} <= set(FWD_SMOKE_SHAPES)
    assert set(smoke.BATCH_EDGE_CASES) <= set(FWD_EDGE_SHAPES)


# Small shapes of every path: blocks of B = 2..16 with a ragged last tile,
# runs (B = 256), top windows (K = 2, 8, 16), windows straddling elements
# (A*B < tc), the wide path (K = 64; float64 K = 32).
FWD_REPLAY_CASES = [(6, 1, 3, 7), (6, 3, 3, 7), (6, 0, 2, 37), (4, 2, 1, 101), (10, 0, 2, 3),
                    (5, 4, 1, 9), (8, 4, 4, 3), (7, 1, 6, 2), (7, 0, 5, 3)]


@pytest.mark.unittest
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", FWD_REPLAY_CASES)
def test_batch_fwd_schedule_matches_plain(n, a, k, bt, shared, f64):
    """The batch forward's schedule, replayed column by column from its
    shared-memory slots, against the plain version: every output written
    once, 1e-12 relative in float64."""
    geom = cuda_kernels.batch_fwd_geometry(bt, 2**a, 2**k, 2 ** (n - a - k), not shared, f64)
    x, w = (t.double() for t in _batch_inputs(n, k, bt, n + a + k + bt, shared)[:2])
    y, count = _fwd_replay(geom, x, w)
    ref = (kernels.window_apply_top_plain(x, w, k, n) if a + k == n else
           kernels.window_apply_plain(x, w, a, k, n))
    assert (count == 1).all()
    assert _rel(y.reshape(ref.shape), ref) <= 1e-12


# On the card: Bt = 1, 7 and 4096, the 6q FCC plans' windows (K = 8) and the
# 4q KL plans' single-qubit gates (K = 2, 4), a K = 32 window at 10q; an
# element split over CTAs (20q, K = 32), a wide batch (Bt = 65536), a K = 32
# top window, and a whole-register window (K = 1024: one column a tile,
# 1024 gram blocks; float64 reads its tile in place).
BATCH_CUDA_CASES = [(6, 1, 3, 1), (6, 1, 3, 7), (6, 3, 3, 4096), (4, 0, 1, 4096), (4, 2, 2, 7),
                    (4, 1, 2, 4096), (10, 2, 5, 7), (12, 0, 2, 7), (20, 3, 5, 2),
                    (6, 3, 3, 65536), (10, 5, 5, 7), (10, 0, 10, 2)]


# The forward's own: the FCC's small-B windows over a wide batch (B = 4 at
# its Bt = 416000; B = 8, 16 and a K = 2 top window at 65536), the KL's
# B = 2, and a K = 1024 window above the register budget with B = 2.
FWD_CUDA_CASES = BATCH_CUDA_CASES + [(6, 1, 3, 416000), (6, 0, 3, 65536), (6, 0, 2, 65536),
                                     (6, 5, 1, 65536), (4, 2, 1, 10000), (11, 0, 10, 2)]


def _cuda_batch(cuda, n, a, k, bt, shared):
    x, w, g = (t.to(cuda) for t in _batch_inputs(n, k, bt, n + a + k + bt, shared))
    return x, w, g


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", FWD_CUDA_CASES)
def test_cuda_window_batch_matches_plain(cuda, n, a, k, bt, shared):
    """B1 / B3's batch entries (the top window when a + k = n) against the
    plain version in float64, one launch each."""
    x, w, _ = _cuda_batch(cuda, n, a, k, bt, shared)
    name = "window_apply_top_batch" if a + k == n else "window_apply_batch"
    before = cuda_kernels.launch_counts()[name]
    if a + k == n:
        got = cuda_kernels.window_apply_top(x, w, k, n)
        ref = kernels.window_apply_top_plain(x.double(), w.double(), k, n)
    else:
        got = cuda_kernels.window_apply(x, w, a, k, n)
        ref = kernels.window_apply_plain(x.double(), w.double(), a, k, n)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before + 1
    assert _rel(got.double().cpu(), ref.cpu()) <= CUDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", BATCH_CUDA_CASES)
def test_cuda_window_batch_bwd_matches_plain(cuda, n, a, k, bt, shared):
    """B2 / B4's batch entries: the state cotangent 1e-5, the matrix
    cotangent (per element, or summed over the batch) 1e-4, one launch."""
    x, w, g = _cuda_batch(cuda, n, a, k, bt, shared)
    top = a + k == n
    name = "window_apply_top_bwd_batch" if top else "window_apply_bwd_batch"
    before = cuda_kernels.launch_counts()[name]
    if top:
        got = cuda_kernels.window_apply_top_bwd(w, g, x, k, n, torch.float32)
        ref = kernels.window_apply_top_bwd_plain(w.double(), g.double(), x.double(), k, n,
                                                 torch.float64)
    else:
        got = cuda_kernels.window_apply_bwd(w, g, x, a, k, n, torch.float32)
        ref = kernels.window_apply_bwd_plain(w.double(), g.double(), x.double(), a, k, n,
                                             torch.float64)
    torch.cuda.synchronize()
    assert cuda_kernels.launch_counts()[name] == before + 1
    assert tuple(got[1].shape) == tuple(w.shape)
    _assert_bwd_close(got, ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
@pytest.mark.parametrize("n,a,k,bt", FWD_CUDA_CASES)
def test_cuda_window_batch_float64_matches_plain(cuda, n, a, k, bt, shared):
    """B1-B4's batch entries in float64 (the dtype of the FCC goldens):
    output, state cotangent and matrix cotangent within 1e-12 of the plain
    version, relative, one launch each."""
    x, w, g = (t.double() for t in _cuda_batch(cuda, n, a, k, bt, shared))
    top = a + k == n
    fwd, bwd = (("window_apply_top_batch", "window_apply_top_bwd_batch") if top else
                ("window_apply_batch", "window_apply_bwd_batch"))
    before = cuda_kernels.launch_counts()
    if top:
        got = (cuda_kernels.window_apply_top(x, w, k, n),
               *cuda_kernels.window_apply_top_bwd(w, g, x, k, n, torch.float64))
        ref = (kernels.window_apply_top_plain(x, w, k, n),
               *kernels.window_apply_top_bwd_plain(w, g, x, k, n, torch.float64))
    else:
        got = (cuda_kernels.window_apply(x, w, a, k, n),
               *cuda_kernels.window_apply_bwd(w, g, x, a, k, n, torch.float64))
        ref = (kernels.window_apply_plain(x, w, a, k, n),
               *kernels.window_apply_bwd_plain(w, g, x, a, k, n, torch.float64))
    torch.cuda.synchronize()
    after = cuda_kernels.launch_counts()
    assert after[fwd] == before[fwd] + 1 and after[bwd] == before[bwd] + 1
    assert all(t.dtype == torch.float64 for t in got)
    for y, r in zip(got, ref):
        assert _rel(y.cpu(), r.cpu()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
def test_cuda_window_batch_gradients_repeat_bit_for_bit(cuda, shared):
    """Two launches of B2 / B4's batch entries give the same bits: the
    grams' splits (and a shared window's elements) are summed in a fixed
    order, with no atomics."""
    for n, a, k, bt in ((6, 1, 3, 4096), (6, 3, 3, 64), (12, 0, 2, 7), (20, 3, 5, 2),
                        (6, 3, 3, 65536)):
        x, w, g = _cuda_batch(cuda, n, a, k, bt, shared)
        first, second = (cuda_kernels.window_apply_bwd(w, g, x, a, k, n, torch.float32)
                         if a + k < n else
                         cuda_kernels.window_apply_top_bwd(w, g, x, k, n, torch.float32)
                         for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_element", "shared"])
def test_cuda_window_batch_forward_repeats_bit_for_bit(cuda, shared, f64):
    """Two launches of B1 / B3's batch entries give the same bits: each
    output sums its terms in a fixed order."""
    for n, a, k, bt in ((6, 1, 3, 4096), (6, 3, 3, 4096), (4, 2, 1, 10000), (20, 3, 5, 2),
                        (11, 0, 10, 2)):
        x, w, _ = _cuda_batch(cuda, n, a, k, bt, shared)
        if f64:
            x, w = x.double(), w.double()
        first, second = (cuda_kernels.window_apply(x, w, a, k, n) if a + k < n else
                         cuda_kernels.window_apply_top(x, w, k, n) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_rotate_batch_is_exact(cuda):
    """B5 on a batched state: the same transpose on every element, exact."""
    x = torch.from_numpy(_batch_inputs(16, 1, 5, 1, True)[0].numpy()).to(cuda)
    got = cuda_kernels.rotate(x, 7, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.rotate_plain(x, 7, 16))
