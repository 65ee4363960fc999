// window_apply_top_bwd: backward of a window on the top of the register
// (window_apply_top.cu).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_apply_top_bwd (the
// launcher of _top_bwd_kernel).  For Y = X W^T on the row-major (A, K) view
// (A = 2^(n-k) rows), given the output cotangent g and the saved input x:
//
//     gp = g conj(W)                   gp[t, j] = sum_i g[t, i] conj(W[i, j])
//     gw[i, j] = sum_t g[t, i] conj(x[t, j])      (over all A rows)
//
// g is float32 or bfloat16, gp float32 or bfloat16, gw float32.
//
// What bounds it on an H100: arithmetic at K >= 64 (8K flops per amplitude
// for each product), as the forward.  The pullback is the forward's tiling
// with conj(W) in place of W^T: a block owns 64 rows x 64 outputs and reads g
// along its contiguous index i.  The matrix cotangent reduces over the A rows
// (2^16 at 22 qubits, K = 64): one output tile, so the rows are split across
// `splits` blocks, each writing its own (2, K, K) partial to a caller-owned
// workspace, and a second pass sums the partials in a fixed order (no
// atomics; fp32 throughout).  Both operands of the gram are read along their
// contiguous index (g^T along i, x along j).  Three launches, where the TPU
// kernel read (g, x) once for both outputs; fusing them is later work.
#include "cgemm_tile.cuh"

namespace {

// gp = g conj(W): rows t, depth i, columns j.
struct TopPullbackMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = false;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t t, int64_t i) const { return t * K + i; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t t, int64_t j) const { return t * K + j; }
};

// gw = g^T conj(x): rows i, depth t, columns j.
struct TopGramMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t t) const { return t * K + i; }
  __device__ __forceinline__ int64_t b_off(int64_t t, int64_t j) const { return t * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

template <class TG, class TP>
int run(const float* w, const TG* g, const float* x, TP* gp, float* gw, float* ws,
        int64_t A, int64_t K, int64_t splits, cudaStream_t stream) {
  const int64_t plane = A * K;
  int code = qml::launch_cgemm(g, plane, w, K * K, gp, plane, 0, A, K, K, 1,
                               TopPullbackMap{K}, stream);
  if (code != 0) return code;
  code = qml::launch_cgemm(g, plane, x, plane, ws, K * K, 2 * K * K, K, K, A, splits,
                           TopGramMap{K}, stream);
  if (code != 0) return code;
  return qml::launch_reduce(ws, gw, 2 * K * K, splits, stream);
}

}  // namespace

// w: (2, K, K) float32; g: (2, A*K) float32 (g_bf16 = 0) or bfloat16;
// x: (2, A*K) float32; gp: (2, A*K) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply_top_bwd(const float* w, const void* g, const float* x,
                                        void* gp, float* gw, float* ws,
                                        long long A, long long K, long long splits,
                                        int g_bf16, int gp_bf16, void* stream) {
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return run(w, gt, x, pt, gw, ws, A, K, splits, (cudaStream_t)stream);
  });
}
