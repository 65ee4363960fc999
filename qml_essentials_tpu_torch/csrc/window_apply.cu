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
// path's K = 256..1024 the intensity is 128..512 flop/byte, far above the
// ~20 flop/byte where fp32 CUDA-core work overtakes HBM traffic.  The design
// therefore reuses each loaded element many times: a 64 x 64 output tile per
// block, 16-deep stages of W and x in shared memory, a 4 x 4 complex
// register tile per thread read with float4 loads (16 floats loaded per 64
// FMAs).  W (8 MB at K = 1024) streams through shared memory tile by tile
// and stays in the 50 MB L2; consecutive blocks share one column tile of x.
// The TPU kernel's lane-tile workarounds (identity padding to K >= 8,
// recentring rotations for B < 128) are not needed: rows, columns and depth
// are masked, and a column index c = a*B + b walks across a-groups when
// B < 64.  Tensor-core variants (3xTF32, split bf16) are later work.
#include "cgemm_tile.cuh"

namespace {

struct WindowMap : qml::WindowCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t c) const { return col(c) + j * B; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t c) const { return col(c) + i * B; }
};

}  // namespace

// x, y: (2, A*K*B) float32 real-split states; w: (2, K, K) float32 Re/Im.
// K and B are powers of two.  Launches on `stream`; returns cudaGetLastError().
extern "C" int qml_window_apply(const float* x, const float* w, float* y,
                                long long A, long long K, long long B,
                                void* stream) {
  const WindowMap map{qml::window_cols(K, B)};
  const int64_t plane = (int64_t)A * K * B;
  return qml::launch_cgemm(w, K * K, x, plane, y, plane, 0, K, (int64_t)A * B, K, 1,
                           map, (cudaStream_t)stream);
}
