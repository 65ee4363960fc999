// adjoint_step_top: one step of the adjoint-state backward on a window on the
// top of the register, [n-k, n).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:adjoint_step_top_ri (the
// launcher of _adj_top_kernel).  The forward there is the row-vector product
// Y = X W^T on the row-major (A, K) view (A = 2^(n-k) rows), so the undo is a
// right product with conj(W) = (W^T)^-1:
//
//     psi_prev = psi conj(W)           lam_prev = lam conj(W)
//     G0[i, j] = sum_t lam[t, i] conj(psi[t, j])    (on the step's output psi)
//     gw       = G0 W                  (= sum_t lam[t, i] conj(psi_prev[t, j]))
//
// What bounds it on an H100: arithmetic at K >= 64 (24K flops per amplitude),
// as window_apply_top_bwd.cu, whose tiling it reuses: the pullbacks are that
// kernel's pullback with conj(W) as the shared column operand of one
// cgemm_pair_kernel pass (a block stages its slice of conj(W) once and applies
// it to a 64-row strip of psi and of lam, both read along their contiguous
// index); the gram reduces over the A rows (2^16 at 22 qubits, K = 64), split
// across blocks into a caller-owned workspace and summed in a fixed order; gw
// = G0 W is one more fp32 product.  Every K from 2 up is taken: the TPU
// kernel's lane-tile limit (128 <= K <= 256) does not apply.
#include "cgemm_tile.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_prev, TO* lam_prev,
        float* gw, float* ws, int64_t A, int64_t K, int64_t splits, cudaStream_t stream) {
  const int64_t plane = A * K;
  int code = qml::launch_cgemm_pair<qml::TopPullbackMap, false>(
      w, K * K, psi, lam, plane, psi_prev, lam_prev, plane, A, K, K,
      qml::TopPullbackMap{K}, stream);
  if (code != 0) return code;
  code = qml::launch_cgemm(lam, plane, psi, plane, ws, K * K, 2 * K * K, K, K, A, splits,
                           qml::TopGramMap{K}, stream);
  if (code != 0) return code;
  return qml::launch_gram_times_w(ws, splits, ws + splits * 2 * K * K, w, gw, K, stream);
}

}  // namespace

// w: (2, K, K) float32; psi, psi_prev: (2, A*K) float32; lam: (2, A*K) float32
// (lam_bf16 = 0) or bfloat16; lam_prev: the same, float32 (out_bf16 = 0) or
// bfloat16; gw: (2, K, K) float32; ws: (splits + 1) * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_adjoint_step_top(const float* w, const float* psi, const void* lam,
                                    float* psi_prev, void* lam_prev, float* gw, float* ws,
                                    long long A, long long K, long long splits,
                                    int lam_bf16, int out_bf16, void* stream) {
  return qml::with_cotangent_types(lam, lam_prev, lam_bf16, out_bf16, [&](auto lt, auto ot) {
    return run(w, psi, lt, psi_prev, ot, gw, ws, A, K, splits, (cudaStream_t)stream);
  });
}
