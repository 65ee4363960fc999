// matrot_apply: a window on [0, k) and the layout rotation by r = n - k that
// follows it, in one pass.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:matrot_apply_ri (the
// _matrot_apply launcher and _matrot_kernel).  The rotation's minor axis is
// the window axis, so with K = 2^k, B = 2^r and x viewed (K, B):
//
//     y[b, i] = sum_j W[i, j] x[j, b]          y = (W x)^T
//
// replaces one window pass and one rotation pass.
//
// What bounds it on an H100: arithmetic (8K flops per amplitude; K = 256 at
// 24 qubits).  The design is window_apply.cu's tile with the product
// oriented so the output's contiguous index i is the tile's column: rows b,
// depth j, columns i.  x is read along b (A_M_CONTIG) and W along j (W^T,
// B_K_CONTIG), so both transposes live in the loads and the store is
// row-major.  Consecutive blocks walk the column tiles first: they share one
// row tile of x through L2.
#include "cgemm_tile.cuh"

namespace {

struct MatrotMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = false;
  int64_t K, B;
  __device__ __forceinline__ int64_t a_off(int64_t b, int64_t j) const { return j * B + b; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t b, int64_t i) const { return b * K + i; }
};

}  // namespace

// x, y: (2, K*B) float32 real-split states; w: (2, K, K) float32 Re/Im.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int qml_matrot_apply(const float* x, const float* w, float* y, long long K,
                                long long B, void* stream) {
  const int64_t plane = (int64_t)K * B;
  return qml::launch_cgemm(x, plane, w, K * K, y, plane, 0, B, K, K, 1, MatrotMap{K, B},
                           (cudaStream_t)stream);
}
