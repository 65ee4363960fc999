// rotwin_apply_bwd: backward of rotwin_apply.cu (a rotation by r and a
// window on [0, k), k > r, in one pass).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_rotwin_apply_bwd (the
// launcher of _rotwin_bwd_kernel).  With W's columns permuted by the caller
// to j' = a*L + l (L = 2^r, A = 2^(k-r)), g viewed (K, X) and the saved
// pre-rotation input x_pre viewed (A, X, L):
//
//     gp[a, x, l] = sum_i conj(W'[i, j']) g[i, x]     (W^dagger g, rotated back)
//     gw'[i, j']  = sum_x g[i, x] conj(x_pre[a, x, l])
//
// and the caller unpermutes gw' (the reference's _rotwin_wunperm).  g and
// gp are float32 or bfloat16, gw float32.
//
// What bounds it on an H100: arithmetic, 16K flops per amplitude (K = 256,
// 512 and 1024 on the main path), as rotmat_apply_bwd.cu, so both products
// run on the split-TF32 tensor cores of adjoint_tc.cuh (3 passes with a
// float32 g, 2 with a bfloat16 one) through rotmat_apply_bwd.cu's maps with
// the pre-rotation index split in two (RotCols with L < K): the pullback
// (RotPullbackMap) has rows x, depth i, columns j', reads g along x and W
// along j', and stores gp through pre(j', x); the gram (RotGramMap) has rows
// i, depth x, columns j', reads g along x and x_pre along j' in runs of L,
// and is split over the X columns (gram_splits) into a caller-owned
// workspace summed in a fixed order (no atomics).  The TPU kernel's loop
// over a disappears into the column index.
//
// The 16-byte copies (tc_vec_shape(K, X) and L >= 8).  A copy moves the 4
// float32 (8 bfloat16) elements that follow its first element's address, so
// each chunk's elements must be contiguous and 16-byte aligned.  g is read
// along x, in runs of X: X >= 8.  W is read along j', in runs of K: K >= 8.
// x_pre is read along j' through pre(j', x), which is contiguous only within
// a run of L: L >= 4 for float32 x_pre, taken as L >= 8 so that every
// operand keeps one rule.  Other shapes (X = 2 or 4, L = 2 or 4) take the
// tile's scalar staging.  A 64-wide column tile crosses a-groups when
// L < 64: the staging's chunks never do (a chunk starts at a multiple of
// its width, which divides L), and the epilogue stores gp one element at a
// time at pre(j', x) of its own column, so no store assumes a run either.
#include "adjoint_tc.cuh"

// w: (2, K, K) float32, columns permuted; g, x, gp: (2, K*X) as in
// rotmat_apply_bwd.cu; gw: (2, K, K) float32, permuted columns; ws: splits *
// 2*K*K float32 scratch.  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int qml_rotwin_apply_bwd(const float* w, const void* g, const float* x, void* gp,
                                    float* gw, float* ws, long long K, long long X,
                                    long long L, long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  const qml::RotCols cols = qml::rot_cols(K, X, L);
  const bool vec = qml::tc_vec_shape(K, X) && L >= 8;
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return qml::launch_fused_bwd_tc(w, gt, x, pt, gw, ws, K * X, K, X, K, X, splits, vec,
                                    qml::RotPullbackMap{cols}, qml::RotGramMap{cols},
                                    (cudaStream_t)stream);
  });
}
