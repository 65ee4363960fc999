// window_apply_top: a fused gate window on the top of the register.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:window_apply_top_ri (the
// _apply_top launcher and _top_kernel): a window on [n-k, n), where B = 1 and
// the window axis is the contiguous one, so the state is a row-major (A, K)
// matrix X and the application is a right product
//
//     y[a, i] = sum_j x[a, j] W[i, j]      (Y = X W^T on each plane pair).
//
// What bounds it on an H100: arithmetic, as for window_apply (8K flops per
// amplitude), at K = 64..256 on the widths where the planner places a window
// on the top.  A window_apply-style tiling over (a, b) would read this layout
// with stride K, so this entry point tiles the other way: a block owns 64
// state rows x 64 window outputs, both operands are read along the
// contiguous depth index j (16-float runs of x rows and W rows), and the
// output tile is written along i, contiguous.  Consecutive blocks walk the
// window outputs first, so one strip of x rows is reused from L2 by the
// K/64 blocks that need it.  Every K from 2 up is taken directly: the TPU
// kernel's identity padding to K >= 128 is not needed.
#include "cgemm_tile.cuh"

namespace {

struct TopMap {
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t a, int64_t j) const { return a * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t a, int64_t i) const { return a * K + i; }
};

}  // namespace

// x, y: (2, A*K) float32 real-split states; w: (2, K, K) float32 Re/Im.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int qml_window_apply_top(const float* x, const float* w, float* y,
                                    long long A, long long K, void* stream) {
  const TopMap map{K};
  const int64_t plane = (int64_t)A * K;
  const int64_t M = A, N = K;
  const int64_t tiles_m = qml::ceil_div(M, qml::BM);
  const int64_t tiles_n = qml::ceil_div(N, qml::BN);
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qml::cgemm_tile_kernel<TopMap, true, false>
      <<<(unsigned)blocks, qml::NT, 0, (cudaStream_t)stream>>>(
          x, plane, w, K * K, y, plane, M, N, K, tiles_m, tiles_n, map);
  return (int)cudaGetLastError();
}
