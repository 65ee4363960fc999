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
// backward's window_apply_bwd), at K = 256..1024 on the main path.  On the
// float32 CUDA cores (67 TFLOP/s) that is the ceiling whatever the tile, so
// the products run on the tensor cores in split TF32 (adjoint_tc.cuh:
// mma.sync m16n8k8 TF32 with cvt.rna.tf32.f32 hi/lo splits, float32-grade,
// whatever the caller's TF32 setting), staged through a cp.async ring:
//
// * the two pullbacks, one launch each over W^dagger (psi float32 in and
//   out; lam float32 or bfloat16 in, either out: three passes, two for a
//   bfloat16 lam, which is exact in TF32);
// * the gram split over the columns into a caller-owned workspace, as in
//   window_apply_bwd.cu, and a fixed-order sum of the partials (no atomics:
//   gradients repeat bit for bit);
// * gw = G0 W in fp32 FMA (8K^3 flops, cgemm_tile.cuh).
//
// The TPU kernel reads (psi, lam) once for all three products and keeps G0
// in VMEM across its sequential grid; G0 is 2K x 2K real (4 MB at K = 512),
// far above a block's shared memory, so here psi and lam are read twice and
// the workspace written and read once.
#include "adjoint_tc.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_prev, TO* lam_prev,
        float* gw, float* ws, int64_t A, int64_t K, int64_t B, int64_t splits,
        cudaStream_t stream) {
  const qml::WindowCols cols = qml::window_cols(K, B);
  const int64_t C = A * B;
  return qml::launch_adjoint_tc(w, psi, lam, psi_prev, lam_prev, gw, ws, A * K * B, K, K, C, C,
                                splits, qml::tc_vec_shape(K, B), qml::WindowPullbackMap{cols},
                                qml::WindowGramMap{cols}, stream);
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
