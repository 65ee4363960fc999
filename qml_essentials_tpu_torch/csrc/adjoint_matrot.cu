// adjoint_matrot: the adjoint-state backward step of a matrot plan step (a
// window on [0, k) and the rotation by r = n - k).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:adjoint_matrot_ri (the
// launcher of _adj_matrot_kernel).  From the step's output state psi and its
// cotangent lam, both in the post-rotation (B, K) layout (K = 2^k, B = 2^r),
// it undoes the rotation and the window on both and reduces the matrix
// cotangent:
//
//     psi_in[j, b] = sum_i conj(W[i, j]) psi[b, i]     (pre-rotation (K, B))
//     lam_in[j, b] = sum_i conj(W[i, j]) lam[b, i]     (float32 or bfloat16)
//     G0[i, j]     = sum_b lam[b, i] conj(psi[b, j]),   gw = G0 W
//
// What bounds it on an H100: arithmetic, 24K flops per amplitude.  The
// design is adjoint_step.cu's with transposed loads: the two pullbacks in
// one pass of cgemm_pair_kernel with conj(W) as the shared row operand, rows
// j, columns b (MatrotPullbackMap, the pullback of matrot_apply_bwd.cu), so
// psi and lam are read along their contiguous i and stored along b; the gram
// on the step's output is the top-window gram of the (B, K) row-major view
// (TopGramMap), split over the B rows and summed in a fixed order; gw = G0 W
// in fp32 FMA.
#include "cgemm_tile.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_in, TO* lam_in,
        float* gw, float* ws, int64_t K, int64_t B, int64_t splits, cudaStream_t stream) {
  const int64_t plane = K * B;
  int code = qml::launch_cgemm_pair<qml::MatrotPullbackMap, true>(
      w, K * K, psi, lam, plane, psi_in, lam_in, plane, K, B, K,
      qml::MatrotPullbackMap{K, B}, stream);
  if (code != 0) return code;
  code = qml::launch_cgemm(lam, plane, psi, plane, ws, K * K, 2 * K * K, K, K, B, splits,
                           qml::TopGramMap{K}, stream);
  if (code != 0) return code;
  return qml::launch_gram_times_w(ws, splits, ws + splits * 2 * K * K, w, gw, K, stream);
}

}  // namespace

// w: (2, K, K) float32; psi, psi_in: (2, K*B) float32; lam: (2, K*B) float32
// (lam_bf16 = 0) or bfloat16; lam_in: the same, float32 (out_bf16 = 0) or
// bfloat16; gw: (2, K, K) float32; ws: (splits + 1) * 2*K*K float32 scratch
// (the partials, then G0).  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int qml_adjoint_matrot(const float* w, const float* psi, const void* lam,
                                  float* psi_in, void* lam_in, float* gw, float* ws,
                                  long long K, long long B, long long splits, int lam_bf16,
                                  int out_bf16, void* stream) {
  return qml::with_cotangent_types(lam, lam_in, lam_bf16, out_bf16, [&](auto lt, auto ot) {
    return run(w, psi, lt, psi_in, ot, gw, ws, K, B, splits, (cudaStream_t)stream);
  });
}
