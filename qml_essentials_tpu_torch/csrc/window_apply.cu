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

struct WindowMap {
  int64_t K, B;
  int log_b;
  // Column c of the (K, A*B) right operand: x[a, :, b] with a = c / B.
  __device__ __forceinline__ int64_t col(int64_t c) const {
    return (c >> log_b) * K * B + (c & (B - 1));
  }
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
  int log_b = 0;
  while ((1LL << log_b) < B) ++log_b;
  const WindowMap map{K, B, log_b};
  const int64_t plane = (int64_t)A * K * B;
  const int64_t M = K, N = (int64_t)A * B;
  const int64_t tiles_m = qml::ceil_div(M, qml::BM);
  const int64_t tiles_n = qml::ceil_div(N, qml::BN);
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qml::cgemm_tile_kernel<WindowMap, false, true>
      <<<(unsigned)blocks, qml::NT, 0, (cudaStream_t)stream>>>(
          w, K * K, x, plane, y, plane, M, N, K, tiles_m, tiles_n, map);
  return (int)cudaGetLastError();
}
