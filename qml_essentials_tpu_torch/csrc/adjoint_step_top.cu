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
// What bounds it on an H100: at the 22q plan's K = 64, bytes and tensor-core
// arithmetic about equally (each ~0.03 ms: four state-sized arrays moved,
// 24K flops per amplitude in split TF32); above K = 64, arithmetic.  So its
// three products run on the split-TF32 tensor-core tile of adjoint_tc.cuh,
// as adjoint_step.cu's: the two pullbacks with conj(W) as the column operand
// (TopPullbackMap: rows t, depth i, columns j), psi and lam read along their
// contiguous i and the outputs stored along j; the gram on the step's output
// (TopGramMap, adjoint_matrot.cu's: rows i, depth t, columns j), split over
// the A rows (gram_splits) into a caller-owned workspace and summed in a
// fixed order (no atomics: gradients repeat bit for bit); gw = G0 W in fp32
// FMA.  The launches read psi and lam twice (pullback, gram): half again
// the bytes the bound counts.  Every K from 2 up is taken: the TPU
// kernel's lane-tile limit (128 <= K <= 256) does not apply.
//
// The 16-byte copies (tc_vec_shape(K, K)).  Every operand runs along the
// window index: the pullbacks read psi / lam along i and conj(W) along its
// rows j, the gram reads lam along i and psi along j, all in runs of K (the
// rows of the (A, K) view and of W), never along t.  So the copies need
// K >= 8 (a bfloat16 lam's 16 bytes are 8 elements), whatever A is; K = 2
// and 4 take the tile's scalar staging.
#include "adjoint_tc.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_prev, TO* lam_prev,
        float* gw, float* ws, int64_t A, int64_t K, int64_t splits, cudaStream_t stream) {
  return qml::launch_adjoint_tc(w, psi, lam, psi_prev, lam_prev, gw, ws, A * K, K, A, K, A,
                                splits, qml::tc_vec_shape(K, K), qml::TopPullbackMap{K},
                                qml::TopGramMap{K}, stream);
}

}  // namespace

// w: (2, K, K) float32; psi, psi_prev: (2, A*K) float32; lam: (2, A*K) float32
// (lam_bf16 = 0) or bfloat16; lam_prev: the same, float32 (out_bf16 = 0) or
// bfloat16; gw: (2, K, K) float32; ws: (splits + 1) * 2*K*K float32 scratch
// (the partials, then G0).  Launches on `stream`; returns the first CUDA
// error, or 0.
extern "C" int qml_adjoint_step_top(const float* w, const float* psi, const void* lam,
                                    float* psi_prev, void* lam_prev, float* gw, float* ws,
                                    long long A, long long K, long long splits,
                                    int lam_bf16, int out_bf16, void* stream) {
  return qml::with_cotangent_types(lam, lam_prev, lam_bf16, out_bf16, [&](auto lt, auto ot) {
    return run(w, psi, lt, psi_prev, ot, gw, ws, A, K, splits, (cudaStream_t)stream);
  });
}
