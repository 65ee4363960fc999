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
// 512 and 1024 on the main path).  The design is rotmat_apply_bwd.cu's with
// the pre-rotation index split in two (RotCols with L < K): the pullback
// stores gp along l in runs of L >= 128, so a 64-wide column tile never
// crosses an a-group; the gram reads x_pre along l the same way.  The TPU
// kernel's loop over a disappears into the column index.
#include "cgemm_tile.cuh"

// w: (2, K, K) float32, columns permuted; g, x, gp: (2, K*X) as in
// rotmat_apply_bwd.cu; gw: (2, K, K) float32, permuted columns; ws: splits *
// 2*K*K float32 scratch.  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int qml_rotwin_apply_bwd(const float* w, const void* g, const float* x, void* gp,
                                    float* gw, float* ws, long long K, long long X,
                                    long long L, long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  const qml::RotCols cols = qml::rot_cols(K, X, L);
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return qml::launch_fused_bwd(w, gt, x, pt, gw, ws, K * X, K, X, K, X, splits,
                                 qml::RotPullbackMap{cols}, qml::RotGramMap{cols},
                                 (cudaStream_t)stream);
  });
}
