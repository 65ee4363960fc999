// window_apply_top: a fused gate window on the top of the register.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:window_apply_top_ri (the
// _apply_top launcher and _top_kernel): a window on [n-k, n), where B = 1 and
// the window axis is the contiguous one, so the state is a row-major (A, K)
// matrix X and the application is a right product
//
//     y[a, i] = sum_j x[a, j] W[i, j]      (Y = X W^T on each plane pair).
//
// What bounds it on an H100: the bytes.  Each amplitude takes K complex
// multiply-adds (8K flops) for 16 bytes read and written; at the planner's
// top-window K = 64 that is 32 flops a byte, above the float32 CUDA cores'
// ~20 but, in split TF32 on the tensor cores (3 x 8K flops / 495 TFLOP/s),
// below the state's 16 bytes / 3.35 TB/s.  So the product runs on
// window_apply.cu's warpgroup kernel (forward_wgmma.cuh), written
// Y^T = W X^T: the state is wgmma's register A operand read along its
// contiguous depth j, the depth-contiguous view rotmat_apply.cu's loads
// already take (TopForwardMap: x[a, j] at a K + j is x_pre[x, j] with
// L = K), W's split planes the shared-memory B operand; the output y[a, i]
// at a K + i is contiguous along the window rows i, so the map sets
// C_M_CONTIG and the kernel stages its tile column by column and writes
// 16-byte runs along i.  Shapes under forward_wgmma_shape(K, A) (K < 8 or
// A < 32) take adjoint_tc.cuh's split-TF32 mma.sync tile with TopMap (the
// state as the row operand, 16-byte copies when K >= 8).  Every K from 2 up
// is taken directly: the TPU kernel's identity padding to K >= 128 is not
// needed.
#include "forward_wgmma.cuh"
#include "window_batch.cuh"

namespace {

// The forward wgmma kernel's orientation, y^T = W x^T: rows i, depth j,
// columns a.
struct TopForwardMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true, C_M_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t a) const { return a * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t a) const { return a * K + i; }
};

// The tile's orientation, y = x W^T: rows a, depth j, columns i.
struct TopMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = false;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t a, int64_t j) const { return a * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t a, int64_t i) const { return a * K + i; }
};

}  // namespace

// The top window on adjoint_tc.cuh's tile, at any shape: the route of the
// shapes under forward_wgmma_shape, and at the plans' shapes the datum
// chip_smoke.py times the wgmma route against (no wrapper counts it).
extern "C" int qml_window_apply_top_tile(const float* x, const float* w, float* y, long long A,
                                         long long K, void* stream) {
  const int64_t plane = (int64_t)A * K;
  return qml::launch_tc_cgemm(x, plane, w, K * K, y, plane, 0, A, K, K, 1,
                              qml::tc_vec_shape(K, K), TopMap{K}, (cudaStream_t)stream);
}

// x, y: (2, A*K) float32 real-split states; w: (2, K, K) float32 Re/Im;
// ws: 4*K*K float32 scratch (W's split planes).  K and A are powers of two.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply_top(const float* x, const float* w, float* ws, float* y,
                                    long long A, long long K, void* stream) {
  const int64_t plane = (int64_t)A * K;
  if (qml::forward_wgmma_shape(K, A))
    return qml::launch_forward_wgmma(x, w, ws, y, plane, K, A, K, TopForwardMap{K},
                                     (cudaStream_t)stream);
  return qml_window_apply_top_tile(x, w, y, A, K, stream);
}

// The batch entry (window_batch.cuh): geom, the launch's FwdGeom
// (cuda_kernels.batch_fwd_geometry, B = 1); x, y: (2, E*A*K), the top
// window on each of E elements; w: one (2, K, K) window (w_stride = 0) or E
// of them (w_stride = 2*K*K); float32, or float64 when f64.
extern "C" int qml_window_apply_top_batch(const long long* geom, const void* x, const void* w,
                                          void* y, void* stream) {
  return qml::batch::forward<true>(geom, x, w, y, (cudaStream_t)stream);
}
