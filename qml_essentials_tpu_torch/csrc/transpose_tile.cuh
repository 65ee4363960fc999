// Shared block of the rotation kernels (rotate.cu, rotate_pair.cu): one
// 32 x 32 tile of the per-plane transpose (2, X, R) -> (2, R, X), moved as
// raw bits.  A warp reads 32 consecutive elements of an input row and writes
// 32 consecutive elements of an output row through a shared-memory tile whose
// row stride is padded to 33, so the transposed read hits 32 different banks.
// Block t of a one-dimensional grid over (plane, row tile, column tile) takes
// one tile; ragged tiles are masked; every offset is 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qml {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // threads per block: TILE x ROWS

template <class T>
__device__ __forceinline__ void transpose_block(const T* __restrict__ x, T* __restrict__ y,
                                                int64_t X, int64_t R, int64_t tiles_r,
                                                int64_t tiles_per_plane, int64_t t,
                                                T (&tile)[TILE][TILE + 1]) {
  const int64_t p = t / tiles_per_plane;
  t -= p * tiles_per_plane;
  const int64_t r0 = (t / tiles_r) * TILE;  // first input row (in X)
  const int64_t c0 = (t % tiles_r) * TILE;  // first input column (in R)
  const T* src = x + p * X * R;
  T* dst = y + p * X * R;

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

// Tiles of one (2, X, R) array: (column tiles, tiles per plane).
inline void transpose_tiles(int64_t X, int64_t R, int64_t* tiles_r, int64_t* tiles_per_plane) {
  *tiles_r = (R + TILE - 1) / TILE;
  *tiles_per_plane = *tiles_r * ((X + TILE - 1) / TILE);
}

}  // namespace qml
