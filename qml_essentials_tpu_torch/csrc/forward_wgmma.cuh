// Forward window product on Hopper's warpgroup tensor cores (window_apply.cu,
// rotmat_apply.cu, rotwin_apply.cu, matrot_apply.cu, window_apply_top.cu):
// y[i, c] = sum_j W[i, j] x[j, c] for a
// (2, K, K) window W and the state's columns c, on real-split planes, at
// float32-grade accuracy.
//
// The product is written y^T = x^T W^T, so that both of wgmma's TF32 rules
// are met: its B operand must lie in shared memory depth-contiguous
// ("K-major"), which W's rows are as W lies (W[i, j], j contiguous), and its
// A operand may come from registers, whatever layout the state has in memory.
//   A: the state tile, 64 columns c per warpgroup (wgmma's M) by 8 depths j,
//      read from shared memory into the m16n8k8 fragment layout (the layout
//      of wgmma's register A: warp w holds columns 16w..16w+15) and split
//      into TF32 hi + lo in registers, each fragment read and split once.
//   B: W's rows [i0, i0 + 64) (wgmma's N = 64 for Re and 64 for Im), staged
//      as four planes (Re hi, Re lo, Im hi, Im lo) in the 128-byte swizzle,
//      one 32-float row of depths per output row.
// Split TF32 as adjoint_tc.cuh: x = hi + lo with hi rounded to nearest, ties
// away (two integer ops) and lo = x - hi read by the tensor cores as its top
// 19 bits; three passes x_lo W_hi, x_hi W_lo, x_hi W_hi (lo*lo is below
// float32's rounding).  W is split once a call, by split_w_kernel, into a
// caller-owned 4*K*K workspace: every block reads the same planes (16 MB at
// K = 1024, held in L2), none splits W again.  The complex product is two
// chains of m64n64k8 wgmma, Cr = Ar Br - Ai Bi (imm-scale-a = -1 negates the
// Im fragment in the instruction) and Ci = Ar Bi + Ai Br, six a k8 step each.
//
// Rounding.  The tensor cores truncate their sums (measured on the card), so
// each 32-deep stage accumulates in fresh registers (the first wgmma of a
// chain with scale-d = 0) and joins the float32 running sum with an ordinary
// add, as adjoint_tc.cuh's mma_stage does: 64 accumulators and 64 partials a
// thread.
//
// Staging and pipeline.  A block of two warpgroups (256 threads) owns 64
// output rows by 128 state columns, 64 columns a warpgroup.  A 3-stage ring
// in dynamic shared memory takes W's four 64 x 32 plane tiles and the
// 128-column state tile, both brought by the Tensor Memory Accelerator in
// the 128-byte swizzle: W's tile is wgmma's B operand as it lands, and the
// swizzle keeps the state's fragment reads at most two-way bank-conflicted
// (the window view: four 32-column boxes; the depth-contiguous view of
// rotmat, rotwin and the top window: one box, rows along the columns,
// conflict-free).  The depth-contiguous view is 4-D, (L, C, K/L, 2): the
// depth j = a L + l runs contiguously only within an a-group of L (rotwin's
// L = 2^r < K; L = K, one group, for rotmat and the top window), so a stage
// is issued at (k0 mod L, c0, k0 / L, 0) and, with L >= 32, lies inside one
// group and lands byte for byte as it would with L = K.  One thread issues a
// stage's copies against its "full" mbarrier (expect_tx); each warp arrives
// on the slot's "empty" mbarrier once its wgmma have retired, and the slot
// is refilled three stages ahead.  With no per-thread copy addresses, the 64
// accumulators, 64 partials and two buffers of A fragments fit each
// thread's registers.  Within a stage the four k8 steps use the two
// buffers: step t + 1's fragments are read and split while step t's wgmma
// group runs, and a buffer is rewritten only after wgmma.wait_group has
// retired the group that read it.  The tensor maps are encoded on the host
// at each launch (cuTensorMapEncodeTiled, found through
// cudaGetDriverEntryPoint: no link against the driver library).
//
// Persistence (K <= 64).  A window this shallow is one or two stages: a
// block's own stages leave nothing to overlap with its store, and at the 22q
// plan's top window (K = 64, 512 tiles) one block an SM runs load, products
// and store back to back, four times over.  So a block then takes every
// gridDim.x-th tile, one block an SM, with a ring of two stages and an
// output tile of its own beside it: its stages are numbered on across its
// tiles, so the next tile's copies are issued as this tile's stages free
// their slots and land while this tile is stored.  Deeper windows keep one
// tile a block and three stages, the output tile staged in the ring.
//
// Store.  The block's 64 x 128 complex tile is staged through shared memory
// and written with 16-byte stores along the output's contiguous index: the
// columns c ([Re/Im][row i][column c], padded), or, for a map whose output
// is contiguous along its rows (C_M_CONTIG: the top window's y[a, i] at
// a K + i, the matrot step's y[b, i] at b K + i), the rows i ([Re/Im][column c][row i], padded to 72 floats a
// column, so that the fragments' 8-byte writes of row pairs are free of
// bank conflicts).  Each output is written once, by one block: no atomics,
// so results repeat bit for bit.
//
// Shape rule (forward_wgmma_shape).  K >= 8 (the 16-byte stores; rows past
// K, depths past K and columns past the state are zero-filled by the copies
// or masked at the store) and a contiguous column run of the state >= 32 (B
// of the window view, a 32-column box within one a-group, and of the matrot
// step's (K, B) view; X of the rotmat view; A, the rows of the top window's
// (A, K) view; for rotwin the shorter of X and its depth run L, a 32-deep
// stage within one a-group).  Other shapes take adjoint_tc.cuh's tile.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "adjoint_tc.cuh"

namespace qml {
namespace fwd {

constexpr int NT = 256;             // two warpgroups
constexpr int BM = 64;              // output rows i per block (wgmma N)
constexpr int BC = 128;             // state columns per block (64 per warpgroup: wgmma M)
constexpr int BK = 32;              // depths a stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int W_TILE = BM * BK * 4;  // bytes of one W plane tile (8 KB)
constexpr int W_STAGE = 4 * W_TILE;  // Re hi, Re lo, Im hi, Im lo
constexpr int X_STAGE = 2 * BC * BK * 4;  // the state tile, Re and Im (32 KB)
constexpr int X_BOX = 2 * 32 * BK * 4;    // one 32-column box of the window view (8 KB)
constexpr int Y_STRIDE = BC + 4;     // floats per row of the staged output tile
constexpr int YT_STRIDE = BM + 8;    // floats per column of it, stored along the rows
constexpr int Y_BYTES = 2 * BC * YT_STRIDE * 4;  // the staged tile, either layout
static_assert(2 * BM * Y_STRIDE * 4 <= Y_BYTES, "both layouts fit");

// A persistent block (the note above) keeps a ring of two stages and its own
// output tile beside it; the others three stages, the output staged in them.
template <bool PERSIST>
constexpr int RING_STAGES = PERSIST ? 2 : STAGES;

template <bool PERSIST>
constexpr int smem_bytes() {  // the ring, the output tile, the mbarriers, 1024-byte alignment
  return 1024 + RING_STAGES<PERSIST> * (W_STAGE + X_STAGE) + (PERSIST ? Y_BYTES : 0) +
         2 * RING_STAGES<PERSIST> * 8;
}

// ws[(2p + h) K^2 + e] = hi (h = 0) or lo (h = 1) of w[p K^2 + e].
static __global__ void split_w_kernel(const float* __restrict__ w, float* __restrict__ ws,
                                      int64_t kk) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * kk) return;
  const int64_t p = e / kk, o = e - p * kk;
  uint32_t hi, lo;
  tc::split<true>(w[e], hi, lo);
  ws[2 * p * kk + o] = __uint_as_float(hi);
  ws[(2 * p + 1) * kk + o] = __uint_as_float(lo);
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused for this layout), stride
// 1024 bytes between 8-row groups, swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also expects `bytes` of copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// A TMA box of the tensor map at the coordinates into shared memory,
// counted on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers in place around the asynchronous wgmma: the compiler may
// not move their reads or writes across this point.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int v = 0; v < 32; ++v) asm volatile("" : "+f"(d[v])::"memory");
}

// d (+)= (SCALE_A * a) * B for a 64 x 8 TF32 fragment a in registers and the
// 8 x 64 B tile of desc; scale_d = 0 overwrites d.
template <int SCALE_A>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %37, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(SCALE_A), "r"(scale_d));
}

// One k8 step of the block's product: the warpgroup's 64 x 64 Re and Im
// partials (+)= its state fragments (hi, lo; [Re/Im][4]) times W's planes at
// depth offset 8t of the stage (descriptor + 2t: 32 bytes).
__device__ __forceinline__ void wgmma_step(float (&pr)[32], float (&pi)[32],
                                           const uint32_t (&h)[2][4], const uint32_t (&l)[2][4],
                                           const uint64_t (&wd)[4], int t, int first) {
  const int sd = first ? 0 : 1;
  const uint64_t rh = wd[0] + 2 * t, rl = wd[1] + 2 * t, ih = wd[2] + 2 * t, il = wd[3] + 2 * t;
  wgmma_fence();
  wgmma_tf32<1>(pr, l[0], rh, sd);  // Cr = Ar Br ...
  wgmma_tf32<1>(pi, l[0], ih, sd);  // Ci = Ar Bi ...
  wgmma_tf32<1>(pr, h[0], rl, 1);
  wgmma_tf32<1>(pi, h[0], il, 1);
  wgmma_tf32<1>(pr, h[0], rh, 1);
  wgmma_tf32<1>(pi, h[0], ih, 1);
  wgmma_tf32<-1>(pr, l[1], ih, 1);  // ... - Ai Bi
  wgmma_tf32<1>(pi, l[1], rh, 1);   // ... + Ai Br
  wgmma_tf32<-1>(pr, h[1], il, 1);
  wgmma_tf32<1>(pi, h[1], rl, 1);
  wgmma_tf32<-1>(pr, h[1], ih, 1);
  wgmma_tf32<1>(pi, h[1], rh, 1);
  wgmma_commit();
}

// Byte offset in a stage's state tile of element (column c, depth j).  The
// window view (column-contiguous, !B_K_CONTIG): four boxes [32 columns]
// of [Re/Im][depth 32][column 32]; the rotmat view (depth-contiguous):
// [Re/Im][column 128][depth 32]; rows of 128 bytes, 16-byte chunks swizzled
// by the row's index mod 8.
template <bool K_CONTIG>
__device__ __forceinline__ int x_at(int c, int j) {
  if constexpr (K_CONTIG) return c * 128 + ((((j >> 2) ^ c) & 7) << 4) + (j & 3) * 4;
  const int b = c & 31;
  return (c >> 5) * X_BOX + j * 128 + ((((b >> 2) ^ j) & 7) << 4) + (b & 3) * 4;
}

// Map: WindowMap, RotWindowMap (rotmat and rotwin), the matrot step's
// MatrotForwardMap or the top window's TopForwardMap (W is the row-major A
// operand a_off(i, j) = i K + j, the state the B operand b_off(j, c), the
// output c_off(i, c), contiguous along i when Map::C_M_CONTIG, else along
// c).  tmw: ws as (K, K, 4) in boxes (32, 64, 4); tmx: the window view
// (B, K, A, 2) (matrot's (B, K, 1, 2)) in boxes (32, 32, 1, 2), run = B, or
// the depth-contiguous view (L, X, K/L, 2) of rotwin (of rotmat L = K, and of
// the top window L = K, X = A) in boxes (32, 128, 1, 2), run = L.  The block
// takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the `tiles` output
// tiles: one, unless PERSIST.
template <class Map, bool PERSIST>
__global__ void __launch_bounds__(NT, 1)
forward_wgmma_kernel(const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tmx, float* __restrict__ y,
                     int64_t plane, int64_t K, int64_t C, int64_t run, int64_t tiles_m,
                     int64_t tiles, Map map) {
  static_assert(!Map::A_M_CONTIG && !Map::CONJ_A && !Map::CONJ_B, "y = W x, W row-major");
  constexpr bool KC = Map::B_K_CONTIG;
  constexpr int S = RING_STAGES<PERSIST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ws = smem;
  unsigned char* Xs = smem + S * W_STAGE;
  float* Ys = reinterpret_cast<float*>(PERSIST ? smem + S * (W_STAGE + X_STAGE) : smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * (W_STAGE + X_STAGE) +
                                               (PERSIST ? Y_BYTES : 0));
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int nk = (int)((K + BK - 1) / BK);
  // The block's g-th stage: depth (g mod nk) BK of its (g / nk)-th tile,
  // tile blockIdx.x + (g / nk) gridDim.x (with one tile a block, g = kt).
  auto tile_of = [&](int g) -> int64_t {
    return PERSIST ? blockIdx.x + (int64_t)(g / nk) * gridDim.x : (int64_t)blockIdx.x;
  };
  auto has_stage = [&](int g) { return PERSIST ? tile_of(g) < tiles : g < nk; };
  // run is a power of two: the copies' coordinates by mask and shift, not by
  // a 64-bit division, a long software sequence on the issuing thread's path
  // (its warpgroup's wgmma wait for it).
  const int log_run = 63 - __clzll(run);

  // Stage g's copies into its slot (thread 0); consecutive blocks share one
  // state tile via L2.
  auto issue = [&](int g) {
    const int64_t t = tile_of(g);
    const int slot = g % S, k0 = (PERSIST ? g % nk : g) * BK;
    const int i0 = (int)((t % tiles_m) * BM);
    const int64_t c0 = (t / tiles_m) * BC;
    mbar_expect(&full[slot], W_STAGE + X_STAGE);
    tma_load(Ws + slot * W_STAGE, &tmw, k0, i0, 0, &full[slot]);
    if constexpr (KC) {
      tma_load(Xs + slot * X_STAGE, &tmx, k0 & (int)(run - 1), (int)c0, k0 >> log_run, 0,
               &full[slot]);
    } else {
#pragma unroll
      for (int box = 0; box < BC / 32; ++box) {
        const int64_t c = c0 + 32 * box;
        tma_load(Xs + slot * X_STAGE + box * X_BOX, &tmx, (int)(c & (run - 1)), k0,
                 (int)(c >> log_run), 0, &full[slot]);
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < S && has_stage(g); ++g) issue(g);

  // This thread's fragment offsets (bytes, in the Re plane of a stage's state
  // tile) for q = 0..3 of m16n8k8's layout, at depth step 0; a step moves
  // the depth by 8.
  const int cb = wg * 64 + warp * 16 + gid;
  auto fragments = [&](const unsigned char* xs, int st, uint32_t (&h)[2][4],
                       uint32_t (&l)[2][4]) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + (q & 1) * 8, j = st * 8 + tig + (q >> 1) * 4;
        const float v = *reinterpret_cast<const float*>(
            xs + p * (KC ? BC * BK * 4 : 32 * BK * 4) + x_at<KC>(c, j));
        tc::split<true>(v, h[p][q], l[p][q]);
      }
  };

  // One output tile from the block's stages g0 .. g0 + nk - 1.
  auto run_tile = [&](int64_t t, int g0) {
    const int i0 = (int)((t % tiles_m) * BM);
    const int64_t c0 = (t / tiles_m) * BC;
    float accr[32], acci[32], pr[32], pi[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) accr[v] = acci[v] = pr[v] = pi[v] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int g = g0 + kt, slot = g % S;
      const uint32_t parity = (g / S) & 1;
      mbar_wait(&full[slot], parity);
      const unsigned char* xs = Xs + slot * X_STAGE;
      uint64_t wd[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) wd[p] = sw128_desc(Ws + slot * W_STAGE + p * W_TILE);
      uint32_t h[2][2][4], l[2][2][4];
#pragma unroll
      for (int st = 0; st < BK / 8; ++st) {
        if (st >= 2) wgmma_wait<1>();  // step st - 2, the last reader of this buffer, retired
        fragments(xs, st, h[st & 1], l[st & 1]);
        wgmma_step(pr, pi, h[st & 1], l[st & 1], wd, st, st == 0);
      }
      wgmma_wait<0>();
      fence_regs(pr);
      fence_regs(pi);
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (tid == 0 && has_stage(g + S)) {
        mbar_wait(&empty[slot], parity);  // every warp is done with the slot
        issue(g + S);
      }
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        accr[v] += pr[v];
        acci[v] += pi[v];
      }
    }
    // Every wgmma retired, and the output tile free: the last tile's store has
    // read it (PERSIST), or no copy is left in flight and the ring becomes it.
    __syncthreads();

    // d[v], v = v0 + 2 v1 + 4 v2: column m = 16 warp + gid + 8 v1, row n = 8 v2 + 2 tig + v0.
    constexpr int CHUNKS = 2 * BM * BC / 4;
    if constexpr (Map::C_M_CONTIG) {  // [Re/Im][column m][row n]: rows n, n + 1 as one float2
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int m = wg * 64 + warp * 16 + gid + (u & 1) * 8;
        const int n = (u >> 1) * 8 + 2 * tig;
        *reinterpret_cast<float2*>(&Ys[m * YT_STRIDE + n]) =
            make_float2(accr[2 * u], accr[2 * u + 1]);
        *reinterpret_cast<float2*>(&Ys[(BC + m) * YT_STRIDE + n]) =
            make_float2(acci[2 * u], acci[2 * u + 1]);
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < CHUNKS / NT; ++q) {
        const int e = tid + q * NT;
        const int r = (e % (BM / 4)) * 4, cc = (e / (BM / 4)) % BC, p = e / (BM / 4 * BC);
        const int64_t i = i0 + r, c = c0 + cc;
        if (i >= K || c >= C) continue;
        const float4 v = *reinterpret_cast<const float4*>(&Ys[(p * BC + cc) * YT_STRIDE + r]);
        *reinterpret_cast<float4*>(y + p * plane + map.c_off(i, c)) = v;
      }
    } else {  // [Re/Im][row n][column m]
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int m = wg * 64 + warp * 16 + gid + ((v >> 1) & 1) * 8;
        const int n = (v >> 2) * 8 + 2 * tig + (v & 1);
        Ys[n * Y_STRIDE + m] = accr[v];
        Ys[(BM + n) * Y_STRIDE + m] = acci[v];
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < CHUNKS / NT; ++q) {
        const int e = tid + q * NT;
        const int cc = (e % (BC / 4)) * 4, r = (e / (BC / 4)) % BM, p = e / (BC / 4 * BM);
        const int64_t i = i0 + r, c = c0 + cc;
        if (i >= K || c >= C) continue;
        const float4 v = *reinterpret_cast<const float4*>(&Ys[(p * BM + r) * Y_STRIDE + cc]);
        *reinterpret_cast<float4*>(y + p * plane + map.c_off(i, c)) = v;
      }
    }
  };
  if constexpr (PERSIST) {
    int g0 = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, g0 += nk) run_tile(t, g0);
  } else {
    run_tile(blockIdx.x, 0);
  }
}

}  // namespace fwd

// The shape rule of the forward wgmma kernel (the note above): K >= 8 and a
// state column run >= 32; run is B of the window view (and of the matrot
// step's (K, B) view), X of the rotmat view, A of the top window's (A, K)
// view, and min(X, L) of rotwin's.
__host__ __device__ inline bool forward_wgmma_shape(int64_t K, int64_t run) {
  return K >= 8 && run >= 32;
}

namespace fwd {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A float32 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) in boxes `box`, 128-byte swizzle, zeros out of range.
inline int encode(CUtensorMap* m, const float* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || p == nullptr)
      return e != cudaSuccess ? (int)e : (int)cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The current device's SM count, asked of CUDA once a device and kept.  The
// table is process-wide and keyed by device, so a process that changes its
// current card reads each card's own count; the sharded route runs one
// process a card (one NCCL rank), whose current card never changes.
inline int sm_count(int* sms) {
  static int counts[64] = {};
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e != 0) return e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    e = (int)cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != 0) return e;
  }
  *sms = counts[dev];
  return 0;
}

}  // namespace fwd

// y = W x over C state columns on the forward wgmma kernel (see the note
// above); ws: 4*K*K floats, W's split planes, written here first.  run: the
// state's contiguous run, a power of two, along the columns of the window
// view (B, and matrot's B) or along the depth of the depth-contiguous view
// (L: K for rotmat and the top window, 2^r >= 32 for rotwin).  Returns 0 or
// the first CUDA error.
template <class Map>
inline int launch_forward_wgmma(const float* x, const float* w, float* ws, float* y,
                                int64_t plane, int64_t K, int64_t C, int64_t run,
                                const Map& map, cudaStream_t stream) {
  const int64_t kk = K * K;
  fwd::split_w_kernel<<<(unsigned)ceil_div(2 * kk, 256), 256, 0, stream>>>(w, ws, kk);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  CUtensorMap tmw, tmx;
  const cuuint64_t wdims[3] = {(cuuint64_t)K, (cuuint64_t)K, 4};
  const cuuint64_t wstr[2] = {(cuuint64_t)K * 4, (cuuint64_t)kk * 4};
  const cuuint32_t wbox[3] = {fwd::BK, fwd::BM, 4};
  code = fwd::encode(&tmw, ws, 3, wdims, wstr, wbox);
  if (code != 0) return code;
  if constexpr (Map::B_K_CONTIG) {  // x_pre[a, x, l] at (a X + x) L + l (rotmat, top: L = K)
    const cuuint64_t dims[4] = {(cuuint64_t)run, (cuuint64_t)C, (cuuint64_t)(K / run), 2};
    const cuuint64_t str[3] = {(cuuint64_t)run * 4, (cuuint64_t)C * run * 4,
                               (cuuint64_t)plane * 4};
    const cuuint32_t box[4] = {fwd::BK, fwd::BC, 1, 2};
    code = fwd::encode(&tmx, x, 4, dims, str, box);
  } else {  // the window view: x[a, j, b] at (a K + j) B + b
    const cuuint64_t dims[4] = {(cuuint64_t)run, (cuuint64_t)K, (cuuint64_t)(C / run), 2};
    const cuuint64_t str[3] = {(cuuint64_t)run * 4, (cuuint64_t)K * run * 4,
                               (cuuint64_t)plane * 4};
    const cuuint32_t box[4] = {32, fwd::BK, 1, 2};
    code = fwd::encode(&tmx, x, 4, dims, str, box);
  }
  if (code != 0) return code;
  const int64_t tiles_m = ceil_div(K, fwd::BM);
  const int64_t tiles = tiles_m * ceil_div(C, fwd::BC);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto launch = [&](auto persist) {
    constexpr bool P = decltype(persist)::value;
    constexpr int bytes = fwd::smem_bytes<P>();
    auto kernel = fwd::forward_wgmma_kernel<Map, P>;
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != 0) return e;
    int64_t blocks = tiles;
    if constexpr (P) {
      int sms = 0;
      e = fwd::sm_count(&sms);
      if (e != 0) return e;
      blocks = tiles < sms ? tiles : sms;
    }
    kernel<<<(unsigned)blocks, fwd::NT, bytes, stream>>>(tmw, tmx, y, plane, K, C, run, tiles_m,
                                                          tiles, map);
    return (int)cudaGetLastError();
  };
  if (K <= 2 * fwd::BK) return launch(std::true_type{});
  return launch(std::false_type{});
}

}  // namespace qml
