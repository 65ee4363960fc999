// rotate: cyclic qubit relabel q -> (q + r) mod n of the real-split state.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:rotate_ri (the _rotate
// launcher and _rot_kernel).  On the flat state the rotation is the matrix
// transpose (2, X, R) -> (2, R, X) with R = 2^r and X = 2^(n-r), per plane.
// Its backward is the same transpose with r -> n - r, run on the cotangent,
// which the saved-residual backward keeps in bfloat16: so the kernel is
// instantiated for 4-byte (float32) and 2-byte (bfloat16) elements, moved as
// raw bits.
//
// What bounds it on an H100: HBM bandwidth.  It does no arithmetic and moves
// each amplitude once in and once out (16 bytes per complex float32
// amplitude, 8 in bfloat16; two state passes in all), so the target is the
// copy rate of the card.  Reads and writes are both coalesced through a
// padded 32 x 32 shared-memory tile (transpose_tile.cuh).  The grid is
// one-dimensional over (plane, row tile, column tile) so every 1 <= r < n
// fits (a two-dimensional grid would overflow gridDim.y at r = 1 or n-1).
// The copy is exact: bit for bit the input values.
#include "transpose_tile.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(qml::TILE * qml::ROWS)
rotate_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t X, int64_t R,
              int64_t tiles_r, int64_t tiles_per_plane) {
  __shared__ T tile[qml::TILE][qml::TILE + 1];
  qml::transpose_block(x, y, X, R, tiles_r, tiles_per_plane, blockIdx.x, tile);
}

template <class T>
int launch(const void* x, void* y, long long X, long long R, void* stream,
           long long planes = 2) {
  int64_t tiles_r, tiles_per_plane;
  qml::transpose_tiles(X, R, &tiles_r, &tiles_per_plane);
  const int64_t blocks = planes * tiles_per_plane;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rotate_kernel<T><<<(unsigned)blocks, dim3(qml::TILE, qml::ROWS), 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, X, R, tiles_r, tiles_per_plane);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (2, X*R) float32 real-split states.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int qml_rotate(const float* x, float* y, long long X, long long R,
                          void* stream) {
  return launch<uint32_t>(x, y, X, R, stream);
}

// The same for 2-byte elements (a bfloat16 cotangent).
extern "C" int qml_rotate_b16(const void* x, void* y, long long X, long long R,
                              void* stream) {
  return launch<uint16_t>(x, y, X, R, stream);
}

// The batch entry: x, y: (planes, X*R) float32 (float64 when f64), the same
// transpose on every plane; a batched (2, Bt, X*R) state is 2*Bt planes.
extern "C" int qml_rotate_batch(const void* x, void* y, long long planes, long long X,
                                long long R, int f64, void* stream) {
  if (f64) return launch<uint64_t>(x, y, X, R, stream, planes);
  return launch<uint32_t>(x, y, X, R, stream, planes);
}
