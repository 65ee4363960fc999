// window_apply_bwd: backward of one fused gate window (window_apply.cu).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_apply_bwd (the launcher
// of _bwd_kernel).  For y = W x on the (2, A, K, B) view, given the output
// cotangent g and the saved input x, it computes
//
//     gp = W^dagger g                      gp[a, j, b] = sum_i conj(W[i, j]) g[a, i, b]
//     gw = sum over the A*B columns of g conj(x)^T     gw[i, j] = sum_c g[i, c] conj(x[j, c])
//
// g is float32 or bfloat16 (the saved-residual backward carries the
// cotangent in bfloat16 between steps), gp is written as float32 or
// bfloat16, gw is always float32.
//
// What bounds it on an H100: arithmetic, as the forward.  Both products are
// K complex multiply-adds per amplitude (8K flops each, 16K in all: twice the
// forward), so the design is the forward's tile (cgemm_tile.cuh) run twice:
//
// * the pullback is the forward's product with A = W^dagger: W is read along
//   its row index (A_M_CONTIG) with the Im part negated, g is the right
//   operand, loaded and upcast from bfloat16 where it is one;
// * the matrix cotangent is a (K x C) * (C x K) product with C = A*B = 2^n/K
//   columns (2^14..2^16 at 24 qubits), so a K x K output has too few 64 x 64
//   tiles to fill 132 SMs.  The TPU kernel kept one (2, K, K) accumulator in
//   VMEM across a sequential grid; CUDA blocks cannot share one, so the
//   reduction over C is split: each of `splits` blocks per output tile sums
//   its chunk of columns into its own (2, K, K) partial in a workspace the
//   caller allocates, and a second pass adds the partials in a fixed order
//   (deterministic: no atomics).  The sum is fp32 FMA throughout.
//
// Unlike the TPU kernel, which reads (g, x) once for both outputs, this is
// three launches (pullback, split gram, reduction): g is read twice and x
// once, plus the workspace (at most 64 MB, chosen by the caller) written and
// read once.  One fused pass is later work, as are tensor cores.
#include "cgemm_tile.cuh"

namespace {

// gp = W^dagger g: rows j, depth i, columns c.
struct PullbackMap : qml::WindowCols {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = true, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t c) const { return col(c) + i * B; }
  __device__ __forceinline__ int64_t c_off(int64_t j, int64_t c) const { return col(c) + j * B; }
};

// gw = g conj(x)^T: rows i, depth c, columns j.
struct GramMap : qml::WindowCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t c) const { return col(c) + i * B; }
  __device__ __forceinline__ int64_t b_off(int64_t c, int64_t j) const { return col(c) + j * B; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

template <class TG, class TP>
int run(const float* w, const TG* g, const float* x, TP* gp, float* gw, float* ws,
        int64_t A, int64_t K, int64_t B, int64_t splits, cudaStream_t stream) {
  const qml::WindowCols cols = qml::window_cols(K, B);
  const int64_t plane = A * K * B;
  const int64_t C = A * B;
  int code = qml::launch_cgemm(w, K * K, g, plane, gp, plane, 0, K, C, K, 1,
                               PullbackMap{cols}, stream);
  if (code != 0) return code;
  code = qml::launch_cgemm(g, plane, x, plane, ws, K * K, 2 * K * K, K, K, C, splits,
                           GramMap{cols}, stream);
  if (code != 0) return code;
  return qml::launch_reduce(ws, gw, 2 * K * K, splits, stream);
}

}  // namespace

// w: (2, K, K) float32; g: (2, A*K*B) float32 (g_bf16 = 0) or bfloat16;
// x: (2, A*K*B) float32; gp: (2, A*K*B) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply_bwd(const float* w, const void* g, const float* x,
                                    void* gp, float* gw, float* ws,
                                    long long A, long long K, long long B,
                                    long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return run(w, gt, x, pt, gw, ws, A, K, B, splits, (cudaStream_t)stream);
  });
}
