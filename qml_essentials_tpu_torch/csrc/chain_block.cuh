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
// each descriptor's output tiles (tile u of a product goes to CTA rank
// (first + u) mod ranks) and step to the next descriptor behind a cluster
// barrier.  The 1 MiB L block does not fit in shared memory, so descriptors
// ping-pong through device memory: the output, and a state-sized workspace,
// the last descriptor writing the output.  Reads of the ping-pong buffers go
// to L2 (cp.async.cg, ld.global.cg), never through L1: they were written by
// other CTAs of the cluster earlier in the same launch, and
// descriptor_done's fence and cluster barrier order those writes before
// them (every copy is a generic-proxy access; no TMA).
//
// Products, on the tensor cores in split TF32 (x = hi + lo, three passes
// x_lo W_hi, x_hi W_lo, x_hi W_hi; each 32-deep stage summed in fresh
// registers and promoted to the float32 running sum with an ordinary add,
// because the tensor cores truncate):
//   * wgmma_product, a window product y = V x on warpgroup wgmma: the
//     pieces of forward_wgmma.cuh (y^T = x^T V^T; the state wgmma's register
//     A operand, read from shared memory and split once; V's four hi / lo
//     planes the B operand in the 128-byte swizzle, split once a launch by
//     split_windows into a workspace at the descriptor's SOFF; wgmma_step's
//     two m64n64k8 chains).  V is W for chain_apply's windows and conj(W)^T
//     for adjoint_chain's pullbacks x = W^dagger y, so a pullback is a
//     forward product.  A CTA takes 64 window rows by 128 state columns a
//     tile, its tiles in turn through one 3-stage cp.async ring that runs on
//     across them: the next tile's first stages land while this tile's last
//     stage multiplies and its 32-byte runs of output are written from the
//     registers.  Two layouts of the state tile, both free of bank
//     conflicts on the fragment reads: rows-contiguous (RowsApply, llo > 0)
//     [Re/Im][depth 32][column 128 + 8], and depth-contiguous (MinorApply,
//     llo = 0) [Re/Im][column 128][depth 32 + 4].
//   * wgmma_gram, adjoint_chain's gram G0 += lam psi^dagger, added to the
//     cluster's slot: lam the register A operand (staged as wgmma_product
//     stages the state), psi staged as it lies and split by the CTA into
//     its conjugate's four swizzled planes (for a minor window a
//     transpose), the conjugate taken in the instructions' sign.
//   * tc_product, one complex product through a Map (below) on
//     adjoint_tc.cuh's mma.sync stage (stage(), mma_stage(), the padded
//     TileShape layouts): the window products and grams (RowsGram /
//     MinorGram) of descriptors under the wgmma rule; a 3-stage ring of
//     16-byte cp.async.cg copies (VEC), or of masked scalar ld.global.cg
//     loads (!VEC), run on across the CTA's tiles.  A function of its own
//     (inlined beside the wgmma functions, it spills); ptxas serializes the
//     wgmma of a kernel that makes any call (C7510), so chain_apply.cu
//     launches a kernel without it for steps that do not need it.
// Shape rule, per descriptor from the table's RUN (the state's contiguous
// run along the window's columns, or along its depth for a minor window):
// the wgmma product and gram when forward_wgmma_shape(K, RUN) (K >= 8,
// RUN >= 32), else tc_product, a product with scalar staging and a gram
// with 16-byte copies when tc_vec_shape(K, RUN) (K >= 8, RUN >= 8).  Every
// window of the 22q and 24q chain plans takes the wgmma product and gram.
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
//          2 K^2 floats for a window, ranks * 2 * 2^nbits for a diagonal;
//   SOFF   the window's offset in the split workspace (floats): 4 K^2, the
//          hi / lo planes of W (chain_apply) or of conj(W)^T (adjoint_chain);
//   RUN    the window's contiguous state run (above).
#pragma once

#include <cooperative_groups.h>

#include "forward_wgmma.cuh"

namespace qml {
namespace chain {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads a CTA: two warpgroups, eight mma.sync warps
static_assert(NT == tc::NT && NT == fwd::NT, "one CTA shape for both products");

constexpr int DESC = 8;
constexpr int KIND = 0, LLO = 1, NBITS = 1, WIDTH = 2, BIT0 = 2, BIT1 = 3, POFF = 4, GOFF = 5,
              SOFF = 6, RUN = 7;
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
// row j (the window index), column c.  A window's bits never straddle the
// block's contiguous bits (an L block is contiguous; an H window starts at
// or above `split`: the wrapper's table), so a row is a fixed flat stride rs
// further: at(j, c) = col(c) + j rs.
struct Win {
  Blocks b;
  int64_t g, K;
  int llo;
  int64_t rs;
  __device__ __forceinline__ Win(const Blocks& blk, int64_t g_, int64_t K_, int llo_)
      : b(blk), g(g_), K(K_), llo(llo_),
        rs(llo_ >= blk.split ? blk.hi_stride << (llo_ - blk.split) : int64_t(1) << llo_) {}
  __device__ __forceinline__ int64_t col(int64_t c) const {
    return b.flat(g, ((c >> llo) * K << llo) + (c & ((int64_t(1) << llo) - 1)));
  }
  __device__ __forceinline__ int64_t at(int64_t j, int64_t c) const { return col(c) + j * rs; }
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

// The first of this CTA's tiles when tile u goes to rank (first + u) mod ranks.
__device__ __forceinline__ int64_t lead(int first, int rank, int ranks) {
  return (rank - first % ranks + ranks) % ranks;
}

// Orders this thread's completed shared-memory writes (cp.async lands them
// through the generic proxy) before the async proxy's reads (wgmma's B).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The wgmma window product
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BN = 64;       // window rows i a tile (wgmma N)
constexpr int BC = 128;      // state columns a tile, 64 a warpgroup (wgmma M)
constexpr int BK = 32;       // depths a stage: one 128-byte swizzle row of V
constexpr int STAGES = 3;
constexpr int W_TILE = BN * BK * 4;  // bytes of one V plane tile
constexpr int W_STAGE = 4 * W_TILE;  // Re hi, Re lo, Im hi, Im lo
constexpr int XR = BC + 8;   // floats a depth row of the rows-contiguous state tile
constexpr int XM = BK + 4;   // floats a column of the depth-contiguous one
constexpr int X_PLANE = BC * XM;  // floats of one plane of either
static_assert(BK * XR <= X_PLANE, "both layouts fit a plane");
constexpr int STAGE = W_STAGE + 2 * X_PLANE * 4;
static_assert(STAGE % 1024 == 0, "every V tile 1024-byte aligned");
constexpr int SMEM = STAGES * STAGE;
}  // namespace wg

// y = V x over this CTA's tiles of the window view (the note above): x, y the
// (2, plane) source and destination, vs V's four split planes (4 K^2
// floats), C the view's columns; tile u (window rows (u mod tiles_n) * 64,
// columns (u / tiles_n) * 128) goes to rank (first + u) mod ranks.
template <bool MINOR_VIEW>
__device__ __forceinline__ void wgmma_product(const float* x, float* y, const float* vs,
                                           int64_t plane, const Win& view, int64_t C, int first,
                                           int rank, int ranks, unsigned char* smem) {
  const Win win = view;  // in registers (a reference to the caller's frame is a stack load)
  const int64_t K = win.K, KK = K * K;
  const int nk = (int)((K + wg::BK - 1) / wg::BK);
  const int64_t tiles_n = (K + wg::BN - 1) / wg::BN;
  const int64_t tiles = tiles_n * ((C + wg::BC - 1) / wg::BC);
  const int64_t t0 = lead(first, rank, ranks);
  if (t0 >= tiles) return;
  const int64_t stages = (tiles - t0 + ranks - 1) / ranks * nk;
  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  // Stage s's copies: depth (s mod nk) * 32 of this CTA's (s / nk)-th tile.
  auto issue = [&](int64_t s) {
    const int64_t t = t0 + (s / nk) * ranks;
    const int k0 = (int)(s % nk) * wg::BK;
    const int64_t i0 = (t % tiles_n) * wg::BN, m0 = (t / tiles_n) * wg::BC;
    unsigned char* st = smem + (s % wg::STAGES) * wg::STAGE;
#pragma unroll
    for (int q = 0; q < wg::W_STAGE / 16 / NT; ++q) {  // V: [plane][row 64][chunk 8], swizzled
      const int e = tid + q * NT;
      const int ch = e & 7, r = (e >> 3) & (wg::BN - 1), p = e >> 9;
      const int64_t i = i0 + r;
      const int j = k0 + 4 * ch;
      const bool in = i < K && j < K;
      tc::cp_async16(st + p * wg::W_TILE + r * 128 + ((ch ^ (r & 7)) << 4),
                     in ? vs + p * KK + i * K + j : vs, in);
    }
    float* xs = reinterpret_cast<float*>(st + wg::W_STAGE);
    // Copy q of this thread: plane q / 4; a minor view's column tid / 8 +
    // 32 (q mod 4) at depth 4 (tid mod 8), each column K further in the L
    // block; a row view's column 4 (tid mod 32) at depth tid / 32 +
    // 8 (q mod 4), each depth rs further.
    const int64_t mc = MINOR_VIEW ? m0 + tid / 8 : m0 + 4 * (tid % 32);
    const int jc = MINOR_VIEW ? k0 + 4 * (tid % 8) : k0 + tid / 32;
    const float* xb = x + win.col(mc) + jc * win.rs;
#pragma unroll
    for (int q = 0; q < 2 * wg::BC * wg::BK / 4 / NT; ++q) {
      const int p = q / 4, u = q % 4;
      const bool in = MINOR_VIEW ? jc < K && mc + 32 * u < C : jc + 8 * u < K && mc < C;
      const int dst = p * wg::X_PLANE + (MINOR_VIEW ? (tid / 8 + 32 * u) * wg::XM + 4 * (tid % 8)
                                                    : (tid / 32 + 8 * u) * wg::XR + 4 * (tid % 32));
      const int64_t off = p * plane + (MINOR_VIEW ? 32 * u * K : 8 * u * win.rs);
      tc::cp_async16(xs + dst, in ? xb + off : x, in);
    }
  };

  // This thread's state fragments of k8 step st (m16n8k8's A layout, the
  // layout of wgmma's register A: warp w holds columns 16w..16w+15), split.
  const int cb = wgi * 64 + warp * 16 + gid;
  auto fragments = [&](const float* xs, int st, uint32_t (&h)[2][4], uint32_t (&l)[2][4]) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = cb + (q & 1) * 8, j = st * 8 + tig + (q >> 1) * 4;
        const float v = xs[p * wg::X_PLANE + (MINOR_VIEW ? m * wg::XM + j : j * wg::XR + m)];
        tc::split<true>(v, h[p][q], l[p][q]);
      }
  };

  // d[v], v = v0 + 2 v1 + 4 v2: column m = cb + 8 v1, window row n = 8 v2 + 2 tig + v0.
  auto store = [&](int64_t t, const float (&accr)[32], const float (&acci)[32]) {
    const int64_t i0 = (t % tiles_n) * wg::BN, m0 = (t / tiles_n) * wg::BC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns m0 + cb and m0 + cb + 8
      const int64_t m = m0 + cb + 8 * h;
      if (m >= C) continue;
      float* yb = y + win.col(m) + i0 * win.rs;
      if constexpr (MINOR_VIEW) {  // y contiguous along the window rows (rs = 1): float2 runs
#pragma unroll
        for (int v2 = 0; v2 < 8; ++v2) {
          const int i = v2 * 8 + 2 * tig;
          if (i0 + i >= K) continue;
          const int v = 4 * v2 + 2 * h;
          *reinterpret_cast<float2*>(yb + i) = make_float2(accr[v], accr[v + 1]);
          *reinterpret_cast<float2*>(yb + i + plane) = make_float2(acci[v], acci[v + 1]);
        }
      } else {  // y contiguous along the columns: a warp's store fills 32-byte runs
#pragma unroll
        for (int v2 = 0; v2 < 8; ++v2)
#pragma unroll
          for (int v0 = 0; v0 < 2; ++v0) {
            const int i = v2 * 8 + 2 * tig + v0;
            if (i0 + i >= K) continue;
            const int v = 4 * v2 + 2 * h + v0;
            yb[i * win.rs] = accr[v];
            yb[i * win.rs + plane] = acci[v];
          }
      }
    }
  };

  float accr[32], acci[32], pr[32], pi[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) accr[v] = acci[v] = pr[v] = pi[v] = 0.f;
  issue(0);
  tc::cp_async_commit();
  if (stages > 1) issue(1);
  tc::cp_async_commit();
  for (int64_t s = 0; s < stages; ++s) {
    tc::cp_async_wait<1>();  // stage s has landed (this thread's copies) ...
    fence_proxy_async();
    __syncthreads();  // ... everyone's, and stage s - 1's slot is no longer read
    const unsigned char* st = smem + (s % wg::STAGES) * wg::STAGE;
    const float* xs = reinterpret_cast<const float*>(st + wg::W_STAGE);
    uint64_t wd[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) wd[p] = fwd::sw128_desc(st + p * wg::W_TILE);
    uint32_t h[2][2][4], l[2][2][4];
#pragma unroll
    for (int k8 = 0; k8 < wg::BK / 8; ++k8) {
      if (k8 >= 2) fwd::wgmma_wait<1>();  // step k8 - 2, the last reader of this buffer, retired
      fragments(xs, k8, h[k8 & 1], l[k8 & 1]);
      fwd::wgmma_step(pr, pi, h[k8 & 1], l[k8 & 1], wd, k8, k8 == 0);
      if (k8 == 0) {  // stage s + 2's copies, into stage s - 1's slot, while step 0 runs
        if (s + 2 < stages) issue(s + 2);
        tc::cp_async_commit();
      }
    }
    fwd::wgmma_wait<0>();
    fwd::fence_regs(pr);
    fwd::fence_regs(pi);
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      accr[v] += pr[v];
      acci[v] += pi[v];
    }
    if (s % nk == nk - 1) {
      store(t0 + (s / nk) * ranks, accr, acci);
#pragma unroll
      for (int v = 0; v < 32; ++v) accr[v] = acci[v] = 0.f;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
}

// ---------------------------------------------------------------------------
// The mma.sync product
// ---------------------------------------------------------------------------

// One operand tile of tc_product: tc::stage's 16-byte cp.async.cg copies
// (VEC), or masked scalar ld.global.cg loads into the same layout.
template <bool VEC, bool K_OUTER, int R, class Off>
__device__ __forceinline__ void stage_tile(float* s, const float* g, int64_t plane, Off off,
                                           int64_t r0, int64_t RN, int64_t k0, int64_t kend,
                                           int tid) {
  if constexpr (VEC) {
    tc::stage<true, K_OUTER, R>(s, g, plane, off, r0, RN, k0, kend, tid);
  } else {
    using S = tc::TileShape<float, K_OUTER, R>;
    constexpr int CONTIG = K_OUTER ? R : tc::BK;
    constexpr int OTHER = K_OUTER ? tc::BK : R;
#pragma unroll 4
    for (int q = 0; q < 2 * OTHER * CONTIG / NT; ++q) {
      const int e = tid + q * NT;
      const int cc = e % CONTIG, o = (e / CONTIG) % OTHER, p = e / (CONTIG * OTHER);
      const int rr = K_OUTER ? cc : o, kk = K_OUTER ? o : cc;
      const int64_t r = r0 + rr, k = k0 + kk;
      s[p * S::PLANE + S::at(rr, kk)] =
          (r < RN && k < kend) ? __ldcg(g + off(r, k) + p * plane) : 0.f;
    }
  }
}

// C = op(A) op(B) (M x N, depth KD) through Map on this CTA's 64 x 64 tiles
// (tile u to rank (first + u) mod ranks), each stored, or with `add` added
// to what C holds (a gram accumulating over the cluster's blocks: the same
// CTA owns the same tile every time).
template <class Map, bool VEC>
__device__ __noinline__ void tc_product(const float* a, int64_t a_plane, const float* b,
                                        int64_t b_plane, float* c, int64_t c_plane, int64_t M,
                                        int64_t N, int64_t KD, const Map& view, bool add,
                                        int first, int rank, int ranks, unsigned char* smem) {
  const Map map = view;
  using SA = tc::TileShape<float, Map::A_M_CONTIG, tc::BM>;
  using SB = tc::TileShape<float, !Map::B_K_CONTIG, tc::BN>;
  static_assert(tc::STAGES * (SA::BYTES + SB::BYTES) <= wg::SMEM, "one ring for both products");
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + tc::STAGES * SA::BYTES);
  const int64_t tiles_m = (M + tc::BM - 1) / tc::BM, tiles_n = (N + tc::BN - 1) / tc::BN;
  const int64_t t0 = lead(first, rank, ranks);
  if (t0 >= tiles_m * tiles_n) return;
  const int nk = (int)((KD + tc::BK - 1) / tc::BK);
  const int64_t stages = (tiles_m * tiles_n - t0 + ranks - 1) / ranks * nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / tc::WARPS_N, wn = warp % tc::WARPS_N, gid = lane / 4, tig = lane % 4;
  auto origin = [&](int64_t t, int64_t& m0, int64_t& n0) {
    m0 = (Map::INNER_M ? t % tiles_m : t / tiles_n) * tc::BM;
    n0 = (Map::INNER_M ? t / tiles_m : t % tiles_n) * tc::BN;
  };
  auto load = [&](int64_t s) {
    int64_t m0, n0;
    origin(t0 + (s / nk) * ranks, m0, n0);
    const int64_t k0 = (s % nk) * tc::BK;
    const int slot = (int)(s % tc::STAGES);
    stage_tile<VEC, Map::A_M_CONTIG, tc::BM>(
        As + slot * SA::ELEMS, a, a_plane,
        [&](int64_t m, int64_t k) { return map.a_off(m, k); }, m0, M, k0, KD, tid);
    stage_tile<VEC, !Map::B_K_CONTIG, tc::BN>(
        Bs + slot * SB::ELEMS, b, b_plane,
        [&](int64_t n, int64_t k) { return map.b_off(k, n); }, n0, N, k0, KD, tid);
  };

  float accr[tc::MT][tc::NF][4], acci[tc::MT][tc::NF][4];
  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
      for (int nf = 0; nf < tc::NF; ++nf)
#pragma unroll
        for (int q = 0; q < 4; ++q) accr[mt][nf][q] = acci[mt][nf][q] = 0.f;
  };
  zero();
#pragma unroll
  for (int s = 0; s < tc::STAGES - 1; ++s) {
    if (s < stages) load(s);
    tc::cp_async_commit();
  }
  for (int64_t s = 0; s < stages; ++s) {
    tc::cp_async_wait<tc::STAGES - 2>();
    __syncthreads();
    if (s + tc::STAGES - 1 < stages) load(s + tc::STAGES - 1);
    tc::cp_async_commit();
    const int slot = (int)(s % tc::STAGES);
    tc::mma_stage<Map>(As + slot * SA::ELEMS, Bs + slot * SB::ELEMS, wm, wn, gid, tig, accr, acci);
    if (s % nk != nk - 1) continue;
    int64_t m0, n0;
    origin(t0 + (s / nk) * ranks, m0, n0);
#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm * tc::WM + mt * 16 + gid + h * 8;
        if (m >= M) continue;
#pragma unroll
        for (int nf = 0; nf < tc::NF; ++nf)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int64_t n = n0 + wn * tc::WN + nf * 8 + 2 * tig + j;
            if (n >= N) continue;
            const int64_t off = map.c_off(m, n);
            const float vr = accr[mt][nf][2 * h + j], vi = acci[mt][nf][2 * h + j];
            c[off] = add ? c[off] + vr : vr;
            c[off + c_plane] = add ? c[off + c_plane] + vi : vi;
          }
      }
    zero();
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
}

// Dynamic shared memory of a chain kernel: either product's ring, 1024-byte
// aligned.
constexpr int SMEM_BYTES = 1024 + wg::SMEM;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (fwd::smem_u32(raw) & 1023)) & 1023);
}

// The view's tile counts for a descriptor: window rows K, columns C.
__device__ __forceinline__ int64_t wgmma_tiles(int64_t K, int64_t C) {
  return ((K + wg::BN - 1) / wg::BN) * ((C + wg::BC - 1) / wg::BC);
}
__device__ __forceinline__ int64_t tc_tiles(int64_t M, int64_t N) {
  return ((M + tc::BM - 1) / tc::BM) * ((N + tc::BN - 1) / tc::BN);
}

// ---------------------------------------------------------------------------
// The wgmma gram
// ---------------------------------------------------------------------------

namespace wgg {
constexpr int BI = 128;  // gram rows i a tile, 64 a warpgroup (wgmma M): lam, register A
constexpr int BJ = 64;   // gram columns j a tile (wgmma N): psi, split into V's planes
constexpr int BK = 32;   // depths (window columns) a stage
constexpr int STAGES = 3;
constexpr int LAM = 2 * wg::X_PLANE * 4;  // lam's tile, either layout of wgmma_product's state
constexpr int PR = BK + 4;                 // floats a row of psi's depth-contiguous raw tile
constexpr int PT = BJ + 8;                 // floats a depth of its row-contiguous one
constexpr int PSI_PLANE = BJ * PR;         // floats of one plane of either
static_assert(BK * PT <= PSI_PLANE, "both layouts fit a plane");
constexpr int STAGE = LAM + 2 * PSI_PLANE * 4;
static_assert(STAGE % 1024 == 0, "1024-byte aligned stages");
constexpr int PLANES = STAGES * STAGE;  // psi's four split planes, one buffer
constexpr int SMEM = PLANES + 4 * wg::W_TILE;
static_assert(SMEM <= wg::SMEM, "within the chain kernels' shared memory");
}  // namespace wgg

// One k8 step of the gram's 64 x 64 partials (+)= lam's fragments (hi, lo;
// [Re/Im][4]) times conj(psi) from psi's planes (Re hi, Re lo, Im hi, Im lo):
// Cr = Ar Br + Ai Bi, Ci = Ai Br - Ar Bi (the conjugate in the sign of A),
// the passes in wgmma_step's order.
__device__ __forceinline__ void gram_step(float (&pr)[32], float (&pi)[32],
                                          const uint32_t (&h)[2][4], const uint32_t (&l)[2][4],
                                          const uint64_t (&wd)[4], int t, int first) {
  const int sd = first ? 0 : 1;
  const uint64_t rh = wd[0] + 2 * t, rl = wd[1] + 2 * t, ih = wd[2] + 2 * t, il = wd[3] + 2 * t;
  fwd::wgmma_fence();
  fwd::wgmma_tf32<1>(pr, l[0], rh, sd);  // Cr = Ar Br ...
  fwd::wgmma_tf32<1>(pi, l[1], rh, sd);  // Ci = Ai Br ...
  fwd::wgmma_tf32<1>(pr, h[0], rl, 1);
  fwd::wgmma_tf32<1>(pi, h[1], rl, 1);
  fwd::wgmma_tf32<1>(pr, h[0], rh, 1);
  fwd::wgmma_tf32<1>(pi, h[1], rh, 1);
  fwd::wgmma_tf32<1>(pr, l[1], ih, 1);   // ... + Ai Bi
  fwd::wgmma_tf32<-1>(pi, l[0], ih, 1);  // ... - Ar Bi
  fwd::wgmma_tf32<1>(pr, h[1], il, 1);
  fwd::wgmma_tf32<-1>(pi, h[0], il, 1);
  fwd::wgmma_tf32<1>(pr, h[1], ih, 1);
  fwd::wgmma_tf32<-1>(pi, h[0], ih, 1);
  fwd::wgmma_commit();
}

// G0 (+)= lam psi^dagger over the window view's C columns of this block, on
// this CTA's 128 x 64 tiles of the K x K gram (tile u to rank u mod ranks,
// rows (u mod tiles_i) * 128, columns (u / tiles_i) * 64): with `add` added
// to what the slot holds (the same CTA owns the same tile every block).  lam
// is wgmma's register A operand, staged as wgmma_product stages the state
// with the window rows i as its columns (a row window's lam runs along the
// depth, a minor window's along i) and split once a read; psi is staged as
// it lies, then split by all threads into four planes of its conjugate's
// B operand (depth-contiguous rows j in the 128-byte swizzle: for a minor
// window a transpose) behind one barrier.
template <bool MINOR_VIEW>
__device__ __forceinline__ void wgmma_gram(const float* lam, const float* psi, float* gram,
                                        int64_t plane, const Win& view, int64_t C, bool add,
                                        int rank, int ranks, unsigned char* smem) {
  const Win win = view;
  const int64_t K = win.K, KK = K * K;
  const int nk = (int)((C + wgg::BK - 1) / wgg::BK);
  const int64_t tiles_i = (K + wgg::BI - 1) / wgg::BI;
  const int64_t tiles = tiles_i * ((K + wgg::BJ - 1) / wgg::BJ);
  const int64_t t0 = rank;
  if (t0 >= tiles) return;
  const int64_t stages = (tiles - t0 + ranks - 1) / ranks * nk;
  const int tid = threadIdx.x;
  const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  unsigned char* planes = smem + wgg::PLANES;

  // Stage s: depths (s mod nk) * 32 of this CTA's (s / nk)-th tile.  A row
  // window's depth c is its column (col(c), contiguous), its rows i and j
  // rs apart; a minor window's depth t is a row of the block (col(t) = t K
  // in the L block), its i and j contiguous.
  auto issue = [&](int64_t s) {
    const int64_t t = t0 + (s / nk) * ranks;
    const int64_t c0 = (s % nk) * wgg::BK;
    const int64_t i0 = (t % tiles_i) * wgg::BI, j0 = (t / tiles_i) * wgg::BJ;
    unsigned char* st = smem + (s % wgg::STAGES) * wgg::STAGE;
    float* ls = reinterpret_cast<float*>(st);
    float* ps = reinterpret_cast<float*>(st + wgg::LAM);
    {  // lam: 2 x 128 x 32, 8 copies a thread
      const int64_t ic = MINOR_VIEW ? i0 + 4 * (tid % 32) : i0 + tid / 8;
      const int64_t cc = MINOR_VIEW ? c0 + tid / 32 : c0 + 4 * (tid % 8);
      const float* lb = lam + win.col(cc) + ic * win.rs;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = q / 4, u = q % 4;
        const bool in = MINOR_VIEW ? ic < K && cc + 8 * u < C : ic + 32 * u < K && cc < C;
        const int dst = p * wg::X_PLANE + (MINOR_VIEW
                                               ? (tid / 32 + 8 * u) * wg::XR + 4 * (tid % 32)
                                               : (tid / 8 + 32 * u) * wg::XM + 4 * (tid % 8));
        const int64_t off = p * plane + (MINOR_VIEW ? 8 * u * K : 32 * u * win.rs);
        tc::cp_async16(ls + dst, in ? lb + off : lam, in);
      }
    }
    {  // psi: 2 x 64 x 32, 4 copies a thread
      const int64_t jc = MINOR_VIEW ? j0 + 4 * (tid % 16) : j0 + tid / 8;
      const int64_t cc = MINOR_VIEW ? c0 + tid / 16 : c0 + 4 * (tid % 8);
      const float* pb = psi + win.col(cc) + jc * win.rs;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = q / 2, u = q % 2;
        const bool in = MINOR_VIEW ? jc < K && cc + 16 * u < C : jc + 32 * u < K && cc < C;
        const int dst = p * wgg::PSI_PLANE + (MINOR_VIEW
                                                  ? (tid / 16 + 16 * u) * wgg::PT + 4 * (tid % 16)
                                                  : (tid / 8 + 32 * u) * wgg::PR + 4 * (tid % 8));
        const int64_t off = p * plane + (MINOR_VIEW ? 16 * u * K : 32 * u * win.rs);
        tc::cp_async16(ps + dst, in ? pb + off : psi, in);
      }
    }
  };

  // psi's raw tile of a stage into the four planes: hi and lo of Re and Im
  // at (row j, depth c), 16 bytes (4 depths) a write.
  auto split_psi = [&](const float* ps) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = tid + q * NT;
      const int p = g >> 9;
      const int j = MINOR_VIEW ? g & 63 : (g >> 3) & 63, c4 = MINOR_VIEW ? (g >> 6) & 7 : g & 7;
      float v[4];
      if constexpr (MINOR_VIEW) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ps[p * wgg::PSI_PLANE + (4 * c4 + e) * wgg::PT + j];
      } else {
        const float4 f =
            *reinterpret_cast<const float4*>(ps + p * wgg::PSI_PLANE + j * wgg::PR + 4 * c4);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split<true>(v[e], hi[e], lo[e]);
      const int at = j * 128 + ((c4 ^ (j & 7)) << 4);
      *reinterpret_cast<uint4*>(planes + 2 * p * wg::W_TILE + at) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(planes + (2 * p + 1) * wg::W_TILE + at) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  const int cb = wgi * 64 + warp * 16 + gid;
  auto fragments = [&](const float* ls, int st, uint32_t (&h)[2][4], uint32_t (&l)[2][4]) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = cb + (q & 1) * 8, k = st * 8 + tig + (q >> 1) * 4;
        const float v = ls[p * wg::X_PLANE + (MINOR_VIEW ? k * wg::XR + m : m * wg::XM + k)];
        tc::split<true>(v, h[p][q], l[p][q]);
      }
  };

  // d[v], v = v0 + 2 v1 + 4 v2: gram row i = cb + 8 v1, column j = 8 v2 + 2 tig + v0.
  auto store = [&](int64_t t, const float (&accr)[32], const float (&acci)[32]) {
    const int64_t i0 = (t % tiles_i) * wgg::BI, j0 = (t / tiles_i) * wgg::BJ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t i = i0 + cb + 8 * h;
      if (i >= K) continue;
#pragma unroll
      for (int v2 = 0; v2 < 8; ++v2) {
        const int64_t j = j0 + v2 * 8 + 2 * tig;
        if (j >= K) continue;
        const int v = 4 * v2 + 2 * h;
        float2* gr = reinterpret_cast<float2*>(gram + i * K + j);
        float2* gi = reinterpret_cast<float2*>(gram + KK + i * K + j);
        float2 r = make_float2(accr[v], accr[v + 1]), m = make_float2(acci[v], acci[v + 1]);
        if (add) {
          const float2 a = *gr, b = *gi;
          r.x += a.x, r.y += a.y, m.x += b.x, m.y += b.y;
        }
        *gr = r;
        *gi = m;
      }
    }
  };

  float accr[32], acci[32], pr[32], pi[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) accr[v] = acci[v] = pr[v] = pi[v] = 0.f;
  issue(0);
  tc::cp_async_commit();
  if (stages > 1) issue(1);
  tc::cp_async_commit();
  uint64_t wd[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) wd[p] = fwd::sw128_desc(planes + p * wg::W_TILE);
  for (int64_t s = 0; s < stages; ++s) {
    tc::cp_async_wait<1>();  // stage s has landed (this thread's copies) ...
    __syncthreads();  // ... everyone's; stage s - 1's slot and the planes are no longer read
    if (s + 2 < stages) issue(s + 2);
    tc::cp_async_commit();
    const unsigned char* st = smem + (s % wgg::STAGES) * wgg::STAGE;
    split_psi(reinterpret_cast<const float*>(st + wgg::LAM));
    fence_proxy_async();
    __syncthreads();  // the planes are whole
    const float* ls = reinterpret_cast<const float*>(st);
    uint32_t h[2][2][4], l[2][2][4];
#pragma unroll
    for (int k8 = 0; k8 < wgg::BK / 8; ++k8) {
      if (k8 >= 2) fwd::wgmma_wait<1>();
      fragments(ls, k8, h[k8 & 1], l[k8 & 1]);
      gram_step(pr, pi, h[k8 & 1], l[k8 & 1], wd, k8, k8 == 0);
    }
    fwd::wgmma_wait<0>();
    fwd::fence_regs(pr);
    fwd::fence_regs(pi);
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      accr[v] += pr[v];
      acci[v] += pi[v];
    }
    if (s % nk == nk - 1) {
      store(t0 + (s / nk) * ranks, accr, acci);
#pragma unroll
      for (int v = 0; v < 32; ++v) accr[v] = acci[v] = 0.f;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
}

__device__ __forceinline__ int64_t gram_tiles(int64_t K) {
  return ((K + wgg::BI - 1) / wgg::BI) * ((K + wgg::BJ - 1) / wgg::BJ);
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

// Whether a window of the host table takes tc_product (under the wgmma rule).
inline bool any_tc(const long long* desc_host, int64_t nd) {
  for (int64_t j = 0; j < nd; ++j) {
    const long long* e = desc_host + j * DESC;
    if (e[KIND] != DIAG && !forward_wgmma_shape(int64_t(1) << e[WIDTH], e[RUN])) return true;
  }
  return false;
}

// The buffer descriptor s of a step of nd writes: the output for the last,
// the workspace before it, alternating backwards.
template <class T>
__device__ __forceinline__ T* out_of(int s, int nd, T* out, T* ws) {
  return ((nd - 1 - s) & 1) ? ws : out;
}

// The split planes of every window of the table (blockIdx.y the descriptor):
// ws[SOFF + (2p + h) K^2 + e] = hi (h = 0) or lo (h = 1) of plane p (Re, Im)
// of W, or with conj_t of conj(W)^T, at element e = i K + j.
static __global__ void split_windows(const float* __restrict__ pay, const long long* desc,
                                     float* __restrict__ ws, int conj_t) {
  const long long* e = desc + (int64_t)blockIdx.y * DESC;
  if (e[KIND] == DIAG) return;
  const int k = (int)e[WIDTH];
  const int64_t kk = int64_t(1) << (2 * k);
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kk) return;
  const float* w = pay + e[POFF];
  const int64_t src = conj_t ? ((o & ((int64_t(1) << k) - 1)) << k) | (o >> k) : o;
  const float v[2] = {w[src], conj_t ? -w[kk + src] : w[kk + src]};
  float* out = ws + e[SOFF];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t hi, lo;
    tc::split<true>(v[p], hi, lo);
    out[2 * p * kk + o] = __uint_as_float(hi);
    out[(2 * p + 1) * kk + o] = __uint_as_float(lo);
  }
}

inline int launch_split(const float* pay, const long long* desc, int64_t nd, float* ws,
                        int64_t max_kk, bool conj_t, cudaStream_t stream) {
  if (max_kk <= 0) return 0;  // no window
  split_windows<<<dim3((unsigned)ceil_div(max_kk, 256), (unsigned)nd), 256, 0, stream>>>(
      pay, desc, ws, conj_t ? 1 : 0);
  return (int)cudaGetLastError();
}

inline cudaLaunchConfig_t cluster_config(int64_t clusters, int ranks, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * ranks));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `ranks` CTAs of the kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters at SMEM_BYTES), or minus a CUDA error.
template <class... P>
inline int active_clusters(void (*kernel)(P...), int ranks) {
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_BYTES);
  if (e != 0) return -e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, ranks, 0, attr);
  int count = 0;
  e = (int)cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return e != 0 ? -e : count;
}

// Launch `clusters` thread-block clusters of `ranks` CTAs of NT threads, each
// with SMEM_BYTES of dynamic shared memory.
template <class... P, class... A>
inline int launch_clusters(void (*kernel)(P...), int64_t clusters, int ranks,
                           cudaStream_t stream, A... args) {
  if (clusters < 1 || ranks < 1 || ranks > 8 || clusters * ranks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          SMEM_BYTES);
  if (e != 0) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(clusters, ranks, stream, attr);
  const cudaError_t r = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

}  // namespace chain
}  // namespace qml
