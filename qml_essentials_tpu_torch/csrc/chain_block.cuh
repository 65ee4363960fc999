// Shared part of the chain kernels (chain_apply.cu, adjoint_chain.cu): one
// launch applies a whole chain step of ops/chains.py, a list of windows and
// 1-2-bit diagonals, to every independent block of the state.
//
// Blocks.  The step's geometry cuts the flat state into blocks that never
// exchange data: "L" is state bits [0, 17) (2^17 contiguous amplitudes), "H"
// is the rows of bits [n-8, n) times a chunk of columns of the other bits.
// A block-local index l maps to the flat index
//     flat(g, l) = g * stride + (l >> split) * hi_stride + (l & (2^split - 1)),
// so a window on state bits [lo, hi) is a window on local bits [llo, llo + k):
// the (K, size / K) view of the block, column c at local
// (c >> llo) * K * 2^llo + (c & (2^llo - 1)), row j 2^llo further per row.
// A diagonal reads its pattern bits straight off the flat index.
//
// Work split.  A thread-block cluster owns a block at a time; its CTAs share
// each descriptor's 64 x 64 output tiles of cgemm_tile.cuh (tile t goes to
// CTA rank t mod ranks), and step to the next descriptor behind a cluster
// barrier.  The 1 MiB L block does not fit in shared memory, so descriptors
// ping-pong through device memory: the output, and a state-sized workspace,
// the last descriptor writing the output.  Reads of the ping-pong buffers go
// to L2 (coherent_f32): they were written by other CTAs of the cluster
// earlier in the same launch.
//
// Descriptor table: DESC int64 per descriptor, built by the wrapper
// (cuda_kernels._chain_table), in device memory:
//   KIND   ROWS (window with llo > 0), MINOR (window with llo = 0: the block
//          is a row-major (size / K, K) matrix and the window its minor axis)
//          or DIAG;
//   LLO / NBITS   the window's local low bit / the diagonal's bit count (1, 2);
//   WIDTH / BIT0  the window's width k / the diagonal's first (MSB) bit;
//   BIT1   the diagonal's second bit;
//   POFF   the payload's offset in the packed payload buffer (floats): a
//          (2, K, K) window or a (2, 2^nbits) diagonal;
//   GOFF   the descriptor's offset in a cluster's gram slot (adjoint only):
//          2 K^2 floats for a window, ranks * 2 * 2^nbits for a diagonal.
#pragma once

#include <cooperative_groups.h>

#include "cgemm_tile.cuh"

namespace qml {
namespace chain {

namespace cg = cooperative_groups;

// CTAs of a chain kernel an SM holds at once (__launch_bounds__): two keep
// the kernels at 128 registers with no spill, and ran B17 / B18 21 % / 23 %
// faster on the 24q chain plan than one CTA at 145 / 165 registers (H100).
constexpr int MIN_BLOCKS = 2;

constexpr int DESC = 8;
constexpr int KIND = 0, LLO = 1, NBITS = 1, WIDTH = 2, BIT0 = 2, BIT1 = 3, POFF = 4, GOFF = 5;
constexpr int ROWS = 0, MINOR = 1, DIAG = 2;

struct Blocks {
  int64_t count;      // blocks in the state
  int64_t size;       // amplitudes per block
  int64_t stride;     // flat offset from one block to the next
  int64_t hi_stride;  // flat stride of a local index's high part
  int64_t split;      // local bits below `split` are contiguous in the state
  __device__ __forceinline__ int64_t flat(int64_t g, int64_t l) const {
    return g * stride + (l >> split) * hi_stride + (l & ((int64_t(1) << split) - 1));
  }
};

// A window's (K, size / K) view of block g: at(j, c) is the flat offset of
// row j (the window index), column c.
struct Win {
  Blocks b;
  int64_t g, K;
  int llo;
  __device__ __forceinline__ int64_t at(int64_t j, int64_t c) const {
    const int64_t q = c & ((int64_t(1) << llo) - 1);
    return b.flat(g, (((c >> llo) * K + j) << llo) + q);
  }
};

// Forward, y = W x.  Row windows: rows i, depth j, columns c (W is A).
struct RowsApply : Win {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t c) const { return at(j, c); }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t c) const { return at(i, c); }
};

// Minor windows, Y = X W^T: rows t (the block's rows), depth j, columns i.
struct MinorApply : Win {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = false;
  __device__ __forceinline__ int64_t a_off(int64_t t, int64_t j) const { return at(j, t); }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t t, int64_t i) const { return at(i, t); }
};

// Undo, x = W^dagger y.  Row windows: rows j, depth i, columns c.
struct RowsPull : Win {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = true, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t c) const { return at(i, c); }
  __device__ __forceinline__ int64_t c_off(int64_t j, int64_t c) const { return at(j, c); }
};

// Minor windows, X = Y conj(W): rows t, depth i, columns j.
struct MinorPull : Win {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = false;
  __device__ __forceinline__ int64_t a_off(int64_t t, int64_t i) const { return at(i, t); }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t t, int64_t j) const { return at(j, t); }
};

// Gram G0[i, j] = sum_c lam[i, c] conj(psi[j, c]) into a K x K slot.  Row
// windows read both along the columns c (the depth), minor windows along i
// and j.
struct RowsGram : Win {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t c) const { return at(i, c); }
  __device__ __forceinline__ int64_t b_off(int64_t c, int64_t j) const { return at(j, c); }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

struct MinorGram : Win {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t t) const { return at(i, t); }
  __device__ __forceinline__ int64_t b_off(int64_t t, int64_t j) const { return at(j, t); }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

struct Smem {
  float a[2][BK][BM + PAD];
  float b[2][BK][BN + PAD];
};

// This CTA's share of C = op(A) op(B) (M x N, depth KD): tiles rank, rank +
// ranks, ...; each stored, or added to what C holds (a gram accumulating over
// the cluster's blocks: the same CTA owns the same tile every time).
template <class Map, class TA, class TB>
__device__ void product(const TA* a, int64_t a_plane, const TB* b, int64_t b_plane, float* c,
                        int64_t c_plane, int64_t M, int64_t N, int64_t KD, const Map& map,
                        bool add, int rank, int ranks, Smem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int64_t tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  for (int64_t t = rank; t < tiles_m * tiles_n; t += ranks) {
    const int64_t m0 = (Map::INNER_M ? t % tiles_m : t / tiles_n) * BM;
    const int64_t n0 = (Map::INNER_M ? t / tiles_m : t % tiles_n) * BN;
    float accr[TM][TN], acci[TM][TN];
    zero_tile(accr, acci);
    for (int64_t k0 = 0; k0 < KD; k0 += BK) {
      stage_a(sm.a, a, a_plane, map, m0, k0, M, KD, tid);
      stage_b(sm.b, b, b_plane, map, n0, k0, N, KD, tid);
      __syncthreads();
      mac_stage(sm.a, sm.b, ty, tx, accr, acci);
      __syncthreads();
    }
    if (add) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int64_t m = m0 + ty * TM + i, n = n0 + tx * TN + j;
          if (m < M && n < N) {
            const int64_t off = map.c_off(m, n);
            c[off] += accr[i][j];
            c[off + c_plane] += acci[i][j];
          }
        }
    } else {
      store_tile(c, c_plane, map, m0, n0, M, N, ty, tx, accr, acci);
    }
  }
}

// Payload index of flat index f: its pattern bits, MSB first.
__device__ __forceinline__ int diag_index(const long long* e, int64_t f) {
  int v = (int)((f >> e[BIT0]) & 1);
  if (e[NBITS] == 2) v = (v << 1) | (int)((f >> e[BIT1]) & 1);
  return v;
}

// Every CTA of the cluster has written its share of the descriptor.
__device__ __forceinline__ void descriptor_done(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// The buffer descriptor s of a step of nd writes: the output for the last,
// the workspace before it, alternating backwards.
template <class T>
__device__ __forceinline__ T* out_of(int s, int nd, T* out, T* ws) {
  return ((nd - 1 - s) & 1) ? ws : out;
}

// Launch `clusters` thread-block clusters of `ranks` CTAs of NT threads.
template <class... P, class... A>
inline int launch_clusters(void (*kernel)(P...), int64_t clusters, int ranks,
                           cudaStream_t stream, A... args) {
  if (clusters < 1 || ranks < 1 || ranks > 8 || clusters * ranks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * ranks));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace chain
}  // namespace qml
