// rotmat_apply_bwd: backward of rotmat_apply.cu (a rotation by r and the
// window on [0, r) in one pass).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_rotmat_apply_bwd (the
// launcher of _rotmat_bwd_kernel).  For y = W x_pre^T (y viewed (K, X),
// x_pre (X, K), K = 2^r), given the output cotangent g and the saved
// pre-rotation input x_pre:
//
//     gp[x, j] = sum_i conj(W[i, j]) g[i, x]     (W^dagger g, rotated back)
//     gw[i, j] = sum_x g[i, x] conj(x_pre[x, j])
//
// g is float32 or bfloat16, gp float32 or bfloat16, gw float32.
//
// What bounds it on an H100: arithmetic, 16K flops per amplitude (two
// products), as window_apply_bwd.cu, so both run on the split-TF32 tensor
// cores of adjoint_tc.cuh: the pullback (RotPullbackMap, adjoint_rotmat.cu's)
// oriented rows x, columns j, so g is read along its contiguous x and gp is
// stored along its contiguous j (the transposed store of the TPU kernel
// becomes the orientation of the product); the gram (RotGramMap) reads g
// along x and x_pre along j, in runs of K (pre(j, x) = x*K + j), split over
// the X columns into a caller-owned workspace and summed in a fixed order
// (no atomics).
#include "adjoint_tc.cuh"

// w: (2, K, K) float32; g: (2, K*X) float32 (g_bf16 = 0) or bfloat16;
// x: (2, K*X) float32; gp: (2, K*X) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_rotmat_apply_bwd(const float* w, const void* g, const float* x, void* gp,
                                    float* gw, float* ws, long long K, long long X,
                                    long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  const qml::RotCols cols = qml::rot_cols(K, X, K);
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return qml::launch_fused_bwd_tc(w, gt, x, pt, gw, ws, K * X, K, X, K, X, splits,
                                    qml::tc_vec_shape(K, X), qml::RotPullbackMap{cols},
                                    qml::RotGramMap{cols}, (cudaStream_t)stream);
  });
}
