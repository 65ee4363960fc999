// rotate: cyclic qubit relabel q -> (q + r) mod n of the real-split state.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:rotate_ri (the _rotate
// launcher and _rot_kernel).  On the flat state the rotation is the matrix
// transpose (2, X, R) -> (2, R, X) with R = 2^r and X = 2^(n-r), per plane.
//
// What bounds it on an H100: HBM bandwidth.  It does no arithmetic and moves
// each amplitude once in and once out (16 bytes per complex amplitude, two
// state passes in all), so the target is the copy rate of the card.  Reads
// and writes are both coalesced through a 32 x 32 shared-memory tile: a warp
// reads 32 consecutive floats of an input row and writes 32 consecutive
// floats of an output row; the tile's row stride is padded to 33 so the
// transposed read from shared memory hits 32 different banks.  The grid is
// one-dimensional over (plane, row tile, column tile) so every 1 <= r < n
// fits (a two-dimensional grid would overflow gridDim.y at r = 1 or n-1);
// ragged tiles are masked.  The copy is exact: bit for bit the input values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // threads per block: TILE x ROWS

__global__ void __launch_bounds__(TILE * ROWS)
rotate_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t X,
              int64_t R, int64_t plane, int64_t tiles_r, int64_t tiles_per_plane) {
  __shared__ float tile[TILE][TILE + 1];
  int64_t t = blockIdx.x;
  const int64_t p = t / tiles_per_plane;
  t -= p * tiles_per_plane;
  const int64_t r0 = (t / tiles_r) * TILE;  // first input row (in X)
  const int64_t c0 = (t % tiles_r) * TILE;  // first input column (in R)
  const float* src = x + p * plane;
  float* dst = y + p * plane;

  for (int j = threadIdx.y; j < TILE; j += ROWS) {
    const int64_t row = r0 + j, col = c0 + threadIdx.x;
    if (row < X && col < R) tile[j][threadIdx.x] = src[row * R + col];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TILE; j += ROWS) {
    const int64_t orow = c0 + j, ocol = r0 + threadIdx.x;
    if (orow < R && ocol < X) dst[orow * X + ocol] = tile[threadIdx.x][j];
  }
}

}  // namespace

// x, y: (2, X*R) float32 real-split states.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int qml_rotate(const float* x, float* y, long long X, long long R,
                          void* stream) {
  const int64_t tiles_r = (R + TILE - 1) / TILE;
  const int64_t tiles_x = (X + TILE - 1) / TILE;
  const int64_t tiles_per_plane = tiles_r * tiles_x;
  const int64_t blocks = 2 * tiles_per_plane;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rotate_kernel<<<(unsigned)blocks, dim3(TILE, ROWS), 0, (cudaStream_t)stream>>>(
      x, y, X, R, (int64_t)X * R, tiles_r, tiles_per_plane);
  return (int)cudaGetLastError();
}
