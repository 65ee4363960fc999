// rotate_pair: the cyclic qubit relabel q -> (q + r) mod n of a state and its
// cotangent in one launch.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:rotate_pair_ri (the
// launcher of _rot_pair_kernel).  The adjoint-state backward repeats every
// layout rotation of the plan on both arrays it carries, the rebuilt state
// psi (float32) and the cotangent lam (float32, or bfloat16 between payload
// steps), so one launch transposes both (2, X, R) -> (2, R, X), each in its
// own element type, moved as raw bits (bit-exact).
//
// What bounds it on an H100: HBM bandwidth, as rotate.cu (24 bytes a complex
// amplitude in and out with a bfloat16 lam, 32 with a float32 one).  One
// one-dimensional grid covers both arrays: its first half of blocks takes
// psi's tiles, its second half lam's (each block one 32 x 32 tile of
// transpose_tile.cuh), so both streams are in flight together and every
// 1 <= r < n fits.
#include "transpose_tile.cuh"

namespace {

template <class T0, class T1>
__global__ void __launch_bounds__(qml::TILE * qml::ROWS)
rotate_pair_kernel(const T0* __restrict__ x0, T0* __restrict__ y0, const T1* __restrict__ x1,
                   T1* __restrict__ y1, int64_t X, int64_t R, int64_t tiles_r,
                   int64_t tiles_per_plane) {
  __shared__ T0 tile0[qml::TILE][qml::TILE + 1];
  __shared__ T1 tile1[qml::TILE][qml::TILE + 1];
  const int64_t per_array = 2 * tiles_per_plane;
  const int64_t t = blockIdx.x;
  if (t < per_array)
    qml::transpose_block(x0, y0, X, R, tiles_r, tiles_per_plane, t, tile0);
  else
    qml::transpose_block(x1, y1, X, R, tiles_r, tiles_per_plane, t - per_array, tile1);
}

template <class T1>
int launch(const void* psi, void* psi_out, const void* lam, void* lam_out, long long X,
           long long R, void* stream) {
  int64_t tiles_r, tiles_per_plane;
  qml::transpose_tiles(X, R, &tiles_r, &tiles_per_plane);
  const int64_t blocks = 4 * tiles_per_plane;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rotate_pair_kernel<uint32_t, T1>
      <<<(unsigned)blocks, dim3(qml::TILE, qml::ROWS), 0, (cudaStream_t)stream>>>(
          (const uint32_t*)psi, (uint32_t*)psi_out, (const T1*)lam, (T1*)lam_out, X, R,
          tiles_r, tiles_per_plane);
  return (int)cudaGetLastError();
}

}  // namespace

// psi, psi_out: (2, X*R) float32; lam, lam_out: (2, X*R) float32 (lam_bf16 =
// 0) or bfloat16.  Launches on `stream`; returns cudaGetLastError().
extern "C" int qml_rotate_pair(const float* psi, float* psi_out, const void* lam,
                               void* lam_out, long long X, long long R, int lam_bf16,
                               void* stream) {
  if (lam_bf16) return launch<uint16_t>(psi, psi_out, lam, lam_out, X, R, stream);
  return launch<uint32_t>(psi, psi_out, lam, lam_out, X, R, stream);
}
