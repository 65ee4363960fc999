// window_apply: one fused gate window on the real-split statevector.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:window_apply_ri (the
// _apply launcher and _win_kernel), the TPU kernel that applies a fused
// (2, K, K) window unitary W to a contiguous qubit support [a, a+k):
//
//     y[a, i, b] = sum_j W[i, j] x[a, j, b]   on the (2, A, K, B) view,
//
// A = 2^a, K = 2^k, B = 2^(n-a-k) > 1 (B = 1 is window_apply_top.cu).
//
// What bounds it on an H100: arithmetic.  Each amplitude takes K complex
// multiply-adds (8K flops) for 16 bytes read and written, so at the main
// path's K = 64..1024 the intensity is 32..512 flop/byte, above the ~20
// flop/byte where float32 CUDA-core work overtakes HBM traffic; on the
// CUDA cores no tile goes below 8K flops / 67 TFLOP/s.  So the product runs
// on the warpgroup tensor cores in split TF32 (forward_wgmma.cuh: three
// m64n64k8 wgmma passes at float32 grade, the state as wgmma's register A
// operand, W's hi/lo planes split once a call into a workspace and staged
// as the K-major shared-memory B operand), bounded by 3 x 8K flops /
// 495 TFLOP/s.  The TPU kernel's lane-tile workarounds (identity padding to
// K >= 8, recentring rotations for B < 128) are not needed: rows, columns
// and depth are masked, and a column index c = a*B + b walks across
// a-groups when B < 128.  Shapes under forward_wgmma_shape (K < 8 or
// B < 32) take adjoint_tc.cuh's split-TF32 mma.sync tile (16-byte copies
// when K >= 8 and B >= 8, else scalar staging).
#include "forward_wgmma.cuh"
#include "window_batch.cuh"

namespace {

struct WindowMap : qml::WindowCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false, C_M_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t c) const { return col(c) + j * B; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t c) const { return col(c) + i * B; }
};

}  // namespace

// x, y: (2, A*K*B) float32 real-split states; w: (2, K, K) float32 Re/Im;
// ws: 4*K*K float32 scratch (W's split planes).  K and B are powers of two.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply(const float* x, const float* w, float* ws, float* y,
                                long long A, long long K, long long B, void* stream) {
  const WindowMap map{qml::window_cols(K, B)};
  const int64_t plane = (int64_t)A * K * B;
  if (qml::forward_wgmma_shape(K, B))
    return qml::launch_forward_wgmma(x, w, ws, y, plane, K, (int64_t)A * B, B, map,
                                     (cudaStream_t)stream);
  return qml::launch_tc_cgemm(w, K * K, x, plane, y, plane, 0, K, (int64_t)A * B, K, 1,
                              qml::tc_vec_shape(K, B), map, (cudaStream_t)stream);
}

// 1 when a forward window, rotmat step or top window of K rows and state
// column run `run` (B, X, or the top window's A) takes the wgmma kernel, 0
// when it takes adjoint_tc.cuh's tile.
extern "C" int qml_forward_path(long long K, long long run) {
  return qml::forward_wgmma_shape(K, run) ? 1 : 0;
}

// The batch entry (window_batch.cuh): geom, the launch's FwdGeom
// (cuda_kernels.batch_fwd_geometry); x, y: (2, E*A*K*B), element e owning
// rows [e*A, (e+1)*A) of the (2, E*A, K, B) view; w: one (2, K, K) window
// (w_stride = 0) or E of them (w_stride = 2*K*K); float32, or float64 when
// f64.  B > 1.
extern "C" int qml_window_apply_batch(const long long* geom, const void* x, const void* w,
                                      void* y, void* stream) {
  return qml::batch::forward<false>(geom, x, w, y, (cudaStream_t)stream);
}
