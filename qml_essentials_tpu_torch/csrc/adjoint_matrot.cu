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
// What bounds it on an H100: arithmetic, 24K flops per amplitude (three
// products).  The design is adjoint_step.cu's and adjoint_rotmat.cu's, on the
// split-TF32 tensor-core tile of adjoint_tc.cuh: the two pullbacks with
// conj(W) as the row operand, rows j, depth i, columns b (MatrotPullbackMap,
// the pullback of matrot_apply_bwd.cu), so psi and lam are read along their
// contiguous i (the rotation back is the orientation of the load) and the
// undone arrays stored along b; the gram on the step's output is the
// top-window gram of the (B, K) row-major view (TopGramMap: rows i, depth b,
// columns j), split over the B rows and summed in a fixed order (no atomics:
// gradients repeat bit for bit); gw = G0 W in fp32 FMA.
//
// The 16-byte copies (tc_vec_shape(K, K)).  Every operand of the three
// products runs along the window index: the pullbacks read conj(W) along its
// rows j and psi / lam along i, the gram reads lam along i and psi along j,
// all in runs of K (the rows of W and of the (B, K) view), never along b.
// So the copies need K >= 8 (a bfloat16 lam's 16 bytes are 8 elements),
// whatever B is; K = 2 and 4 take the tile's scalar staging.
#include "adjoint_tc.cuh"

namespace {

template <class TL, class TO>
int run(const float* w, const float* psi, const TL* lam, float* psi_in, TO* lam_in,
        float* gw, float* ws, int64_t K, int64_t B, int64_t splits, cudaStream_t stream) {
  return qml::launch_adjoint_tc(w, psi, lam, psi_in, lam_in, gw, ws, K * B, K, K, B, B, splits,
                                qml::tc_vec_shape(K, K), qml::MatrotPullbackMap{K, B},
                                qml::TopGramMap{K}, stream);
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
