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
// 24 qubits), as the window kernel, so it runs window_apply.cu's split-TF32
// wgmma kernel (forward_wgmma.cuh, bounded by 3 x 8K flops / 495 TFLOP/s).
// Its loads are the window view's with A = 1 (x[j, b] at j*B + b, brought
// by TMA in 32-column boxes along b) and its store is window_apply_top.cu's
// row-contiguous one (y[b, i] at b*K + i: C_M_CONTIG, the tile staged
// column by column and written in 16-byte runs along i), so the rotation
// lives in the store.  Consecutive blocks walk W's row tiles first: at
// K = 256 the four row tiles of one state tile run side by side and share
// it through L2.  Shapes under forward_wgmma_shape (K < 8 or B < 32) take
// adjoint_tc.cuh's split-TF32 mma.sync tile with MatrotMap, the product
// oriented so the output's contiguous index i is the tile's column: rows b,
// depth j, columns i; x is read along b (A_M_CONTIG) and W along j (W^T,
// B_K_CONTIG), so the 16-byte copies need K >= 8 and B >= 8
// (tc_vec_shape(K, B)), and other shapes take the tile's scalar staging.
#include "forward_wgmma.cuh"

namespace {

// The forward wgmma kernel's orientation, y^T = W x: rows i, depth j,
// columns b.
struct MatrotForwardMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false, C_M_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  int64_t K, B;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t b) const { return j * B + b; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t b) const { return b * K + i; }
};

// The tile's orientation, y = x^T W^T: rows b, depth j, columns i.
struct MatrotMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = false;
  int64_t K, B;
  __device__ __forceinline__ int64_t a_off(int64_t b, int64_t j) const { return j * B + b; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t b, int64_t i) const { return b * K + i; }
};

}  // namespace

// x, y: (2, K*B) float32 real-split states; w: (2, K, K) float32 Re/Im;
// ws: 4*K*K float32 scratch (W's split planes).  Launches on `stream`;
// returns the first CUDA error, or 0.
extern "C" int qml_matrot_apply(const float* x, const float* w, float* ws, float* y,
                                long long K, long long B, void* stream) {
  const int64_t plane = (int64_t)K * B;
  if (qml::forward_wgmma_shape(K, B))
    return qml::launch_forward_wgmma(x, w, ws, y, plane, K, B, B, MatrotForwardMap{K, B},
                                     (cudaStream_t)stream);
  return qml::launch_tc_cgemm(x, plane, w, K * K, y, plane, 0, B, K, K, 1,
                              qml::tc_vec_shape(K, B), MatrotMap{K, B}, (cudaStream_t)stream);
}
