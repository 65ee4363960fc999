// Shared block tile of the two window kernels (window_apply.cu and
// window_apply_top.cu): a complex matrix product C = A * B on real-split
// float32 planes (each operand is a Re plane followed, `plane` floats later,
// by an Im plane), with fp32 FMA on the CUDA cores.
//
// The complex product is the 4-multiply form, Cr = Ar Br - Ai Bi and
// Ci = Ar Bi + Ai Br, accumulated with fmaf in float32: it keeps the plain
// version's rounding behaviour (no Karatsuba cancellation) and costs 8 flops
// per complex multiply-add.
//
// Tiling: a block of 256 threads owns a BM x BN tile of C and walks the
// reduction in BK-deep stages through shared memory; each thread keeps a
// TM x TN complex sub-tile (32 float accumulators) in registers and reads its
// operands from shared memory as float4.  The kernels differ only in how
// (row, depth) and (depth, column) map to addresses, which the Map argument
// supplies; every offset is 64-bit (a 26-qubit plane is 2^26 floats and
// products of strides exceed int32).  Out-of-range rows, columns and depths
// are masked, so every power-of-two K from 2 up and every column count works.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qml {

constexpr int BM = 64;   // C rows per block
constexpr int BN = 64;   // C columns per block
constexpr int BK = 16;   // reduction depth per shared-memory stage
constexpr int TM = 4;    // C rows per thread
constexpr int TN = 4;    // C columns per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int PAD = 4;   // keeps rows 16-byte aligned for float4 reads

// B_K_CONTIG: the B operand is contiguous along the depth index (the top
// window's W^T) rather than along the column index (the window's state).
// INNER_M: consecutive blocks walk the row tiles first (they then share one
// column tile of B through L2); otherwise the column tiles first.
template <class Map, bool B_K_CONTIG, bool INNER_M>
__global__ void __launch_bounds__(NT)
cgemm_tile_kernel(const float* __restrict__ a, int64_t a_plane,
                  const float* __restrict__ b, int64_t b_plane,
                  float* __restrict__ c, int64_t c_plane,
                  int64_t M, int64_t N, int64_t KD,
                  int64_t tiles_m, int64_t tiles_n, Map map) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // [re/im][depth][row]
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];  // [re/im][depth][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t t = blockIdx.x;
  const int64_t mt = INNER_M ? t % tiles_m : t / tiles_n;
  const int64_t nt = INNER_M ? t / tiles_m : t % tiles_n;
  const int64_t m0 = mt * BM;
  const int64_t n0 = nt * BN;

  float accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < KD; k0 += BK) {
    // A tile: both operands read along the depth index (contiguous).
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int e = tid + r * NT;
      const int mm = e / BK, kk = e % BK;
      const int64_t m = m0 + mm, k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (m < M && k < KD) {
        const int64_t off = map.a_off(m, k);
        vr = a[off];
        vi = a[off + a_plane];
      }
      As[0][kk][mm] = vr;
      As[1][kk][mm] = vi;
    }
    // B tile: neighbouring threads on neighbouring addresses.
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = B_K_CONTIG ? e % BK : e / BN;
      const int nn = B_K_CONTIG ? e / BK : e % BN;
      const int64_t k = k0 + kk, n = n0 + nn;
      float vr = 0.f, vi = 0.f;
      if (k < KD && n < N) {
        const int64_t off = map.b_off(k, n);
        vr = b[off];
        vi = b[off + b_plane];
      }
      Bs[0][kk][nn] = vr;
      Bs[1][kk][nn] = vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 ar4 = *reinterpret_cast<const float4*>(&As[0][kk][ty * TM]);
      const float4 ai4 = *reinterpret_cast<const float4*>(&As[1][kk][ty * TM]);
      const float4 br4 = *reinterpret_cast<const float4*>(&Bs[0][kk][tx * TN]);
      const float4 bi4 = *reinterpret_cast<const float4*>(&Bs[1][kk][tx * TN]);
      const float ar[TM] = {ar4.x, ar4.y, ar4.z, ar4.w};
      const float ai[TM] = {ai4.x, ai4.y, ai4.z, ai4.w};
      const float br[TN] = {br4.x, br4.y, br4.z, br4.w};
      const float bi[TN] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accr[i][j] = fmaf(ar[i], br[j], accr[i][j]);
          accr[i][j] = fmaf(-ai[i], bi[j], accr[i][j]);
          acci[i][j] = fmaf(ar[i], bi[j], acci[i][j]);
          acci[i][j] = fmaf(ai[i], br[j], acci[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx * TN + j;
      if (n >= N) continue;
      const int64_t off = map.c_off(m, n);
      c[off] = accr[i][j];
      c[off + c_plane] = acci[i][j];
    }
  }
}

inline int64_t ceil_div(int64_t x, int64_t y) { return (x + y - 1) / y; }

}  // namespace qml
