// adjoint_rotmat: the adjoint-state backward step of a rotmat plan step
// (a rotation by r and the window on [0, r)).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:adjoint_rotmat_ri (the
// launcher of _adj_rotmat_kernel).  From the step's output state psi and its
// cotangent lam, both in the post-rotation (K, X) layout (K = 2^r), it undoes
// the window and the rotation on both and reduces the matrix cotangent:
//
//     psi_in[x, j] = sum_i conj(W[i, j]) psi[i, x]     (pre-rotation layout)
//     lam_in[x, j] = sum_i conj(W[i, j]) lam[i, x]     (float32 or bfloat16)
//     G0[i, j]     = sum_x lam[i, x] conj(psi[j, x]),   gw = G0 W
//
// replacing a paired rotation and an adjoint window step (4 state passes of
// traffic become 2 for the undo).
//
// What bounds it on an H100: arithmetic, 24K flops per amplitude (three
// products).  The design is adjoint_step.cu's, on the split-TF32 tensor-core
// tile of adjoint_tc.cuh: the two pullbacks over a shared conj(W) column
// operand, oriented rows x, columns j (RotPullbackMap, the pullback of
// rotmat_apply_bwd.cu), so psi and lam are read along x and the undone arrays
// stored along j (the rotation back is the orientation of the store); the
// gram on the step's output, split over the X columns (WindowGramMap on the
// (K, X) view) and summed in a fixed order; gw = G0 W in fp32 FMA.
#include "adjoint_tc.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_in, TO* lam_in,
        float* gw, float* ws, int64_t K, int64_t X, int64_t splits, cudaStream_t stream) {
  return qml::launch_adjoint_tc(w, psi, lam, psi_in, lam_in, gw, ws, K * X, K, X, K, X, splits,
                                qml::tc_vec_shape(K, X),
                                qml::RotPullbackMap{qml::rot_cols(K, X, K)},
                                qml::WindowGramMap{qml::window_cols(K, X)}, stream);
}

}  // namespace

// w: (2, K, K) float32; psi, psi_in: (2, K*X) float32; lam: (2, K*X) float32
// (lam_bf16 = 0) or bfloat16; lam_in: the same, float32 (out_bf16 = 0) or
// bfloat16; gw: (2, K, K) float32; ws: (splits + 1) * 2*K*K float32 scratch
// (the partials, then G0).  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int qml_adjoint_rotmat(const float* w, const float* psi, const void* lam,
                                  float* psi_in, void* lam_in, float* gw, float* ws,
                                  long long K, long long X, long long splits, int lam_bf16,
                                  int out_bf16, void* stream) {
  return qml::with_cotangent_types(lam, lam_in, lam_bf16, out_bf16, [&](auto lt, auto ot) {
    return run(w, psi, lt, psi_in, ot, gw, ws, K, X, splits, (cudaStream_t)stream);
  });
}
