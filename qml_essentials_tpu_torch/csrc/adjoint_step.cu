// adjoint_step: one step of the adjoint-state backward on a window [a, a+k).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:adjoint_step_ri (the
// launcher of _adj_kernel).  The backward walks the plan in reverse without
// residuals: from the step's output state psi and its cotangent lam it
// rebuilds the step's input and pulls the cotangent back through the same
// unitary, on the (2, A, K, B) view:
//
//     psi_prev = W^dagger psi          (unitarity: recompute, do not store)
//     lam_prev = W^dagger lam          (in float32 or bfloat16)
//     G0       = sum over the A*B columns of lam conj(psi)^T
//     gw       = G0 W                  (= sum lam conj(psi_prev)^T)
//
// The gram runs on the step's output psi, as the TPU kernel does, so it does
// not wait on the undo; the K x K post-multiply is cheap (8 K^3 flops against
// 24 K 2^n for the step).
//
// What bounds it on an H100: arithmetic.  Three products of K complex
// multiply-adds per amplitude (24K flops per amplitude, 1.5x the saved
// backward's window_apply_bwd), at K = 256..1024 on the main path.  The
// design is four launches on cgemm_tile.cuh:
//
// * the two pullbacks in one pass (cgemm_pair_kernel): a block stages its
//   slice of W^dagger once per depth stage and applies it to psi (float32 in
//   and out) and to lam (float32 or bfloat16 in, either out);
// * the gram split over the columns into a caller-owned workspace, as in
//   window_apply_bwd.cu, and a fixed-order sum of the partials (no atomics:
//   gradients repeat bit for bit);
// * gw = G0 W in fp32 FMA, whatever the caller's TF32 setting.
//
// The TPU kernel reads (psi, lam) once for all three products and keeps G0
// in VMEM across its sequential grid; here psi and lam are read twice and the
// workspace written and read once.  One fused pass and tensor cores are later
// work.
#include "cgemm_tile.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_prev, TO* lam_prev,
        float* gw, float* ws, int64_t A, int64_t K, int64_t B, int64_t splits,
        cudaStream_t stream) {
  const qml::WindowCols cols = qml::window_cols(K, B);
  const int64_t plane = A * K * B;
  const int64_t C = A * B;
  int code = qml::launch_cgemm_pair<qml::WindowPullbackMap, true>(
      w, K * K, psi, lam, plane, psi_prev, lam_prev, plane, K, C, K,
      qml::WindowPullbackMap{cols}, stream);
  if (code != 0) return code;
  code = qml::launch_cgemm(lam, plane, psi, plane, ws, K * K, 2 * K * K, K, K, C, splits,
                           qml::WindowGramMap{cols}, stream);
  if (code != 0) return code;
  return qml::launch_gram_times_w(ws, splits, ws + splits * 2 * K * K, w, gw, K, stream);
}

}  // namespace

// w: (2, K, K) float32; psi, psi_prev: (2, A*K*B) float32; lam: (2, A*K*B)
// float32 (lam_bf16 = 0) or bfloat16; lam_prev: the same, float32
// (out_bf16 = 0) or bfloat16; gw: (2, K, K) float32; ws: (splits + 1) * 2*K*K
// float32 scratch (the partials, then G0).  Launches on `stream`; returns the
// first CUDA error, or 0.
extern "C" int qml_adjoint_step(const float* w, const float* psi, const void* lam,
                                float* psi_prev, void* lam_prev, float* gw, float* ws,
                                long long A, long long K, long long B, long long splits,
                                int lam_bf16, int out_bf16, void* stream) {
  return qml::with_cotangent_types(lam, lam_prev, lam_bf16, out_bf16, [&](auto lt, auto ot) {
    return run(w, psi, lt, psi_prev, ot, gw, ws, A, K, B, splits, (cudaStream_t)stream);
  });
}
