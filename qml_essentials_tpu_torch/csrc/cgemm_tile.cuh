// Shared block tile of the adjoint steps' gw = G0 W (launch_gram_times_w)
// and of adjoint_chain.cu's; the window kernels, window_apply.cu,
// rotmat_apply.cu, rotwin_apply.cu, matrot_apply.cu and window_apply_top.cu
// (their products on forward_wgmma.cuh's tensor cores), window_apply_bwd.cu,
// window_apply_top_bwd.cu, rotmat_apply_bwd.cu, matrot_apply_bwd.cu,
// rotwin_apply_bwd.cu, adjoint_step.cu, adjoint_step_top.cu,
// adjoint_rotmat.cu and adjoint_matrot.cu (on adjoint_tc.cuh's), take only
// its maps and split-gram sum: a complex matrix product C = op(A) * op(B) on
// real-split planes (each operand is a Re plane followed, `plane` elements
// later, by an Im plane), with fp32 FMA on the CUDA cores.
//
// The complex product is the 4-multiply form, Cr = Ar Br - Ai Bi and
// Ci = Ar Bi + Ai Br, accumulated with fmaf in float32: it keeps the plain
// version's rounding behaviour (no Karatsuba cancellation) and costs 8 flops
// per complex multiply-add.  op() is the identity or the complex conjugate
// (the Im part negated as it is loaded).
//
// Tiling: a block of 256 threads owns a BM x BN tile of C and walks its range
// of the reduction in BK-deep stages through shared memory; each thread keeps
// a TM x TN complex sub-tile (32 float accumulators) in registers and reads
// its operands from shared memory as float4.  The kernels differ only in how
// (row, depth), (depth, column) and (row, column) map to addresses, which the
// Map argument supplies together with its layout flags; every offset is
// 64-bit (a 26-qubit plane is 2^26 elements and products of strides exceed
// int32).  Out-of-range rows, columns and depths are masked, so every
// power-of-two K from 2 up and every column count works.
//
// Split reduction: blockIdx.y = z takes the depth range
// [z * k_chunk, (z + 1) * k_chunk) and writes its partial C at c + z * c_split
// (c_split = 0 and one split for a plain product).  A separate pass sums the
// partials in a fixed order (reduce_splits below): no atomics, so the result
// is the same from run to run.
//
// Element types: A, B and C are float; the arithmetic is float32
// throughout.  store_f32 also writes a bfloat16 output
// (rounded to nearest even) for adjoint_tc.cuh's tile.
//
// The maps of the window layouts that several kernels use live at the end of
// this file.
#pragma once

#include <cuda_bf16.h>
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
static_assert(BM == BN, "row and column stages share one shared-memory shape");

__device__ __forceinline__ float load_f32(const float* p, int64_t off) { return p[off]; }
__device__ __forceinline__ void store_f32(float* p, int64_t off, float v) { p[off] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t off, float v) {
  p[off] = __float2bfloat16(v);
}

// Map supplies a_off(m, k), b_off(k, n), c_off(m, n) (offsets in the Re
// plane) and the compile-time layout flags
//   A_M_CONTIG  A is contiguous along its row index m (else along depth k);
//   B_K_CONTIG  B is contiguous along depth k (else along its column n);
//   CONJ_A, CONJ_B  use the complex conjugate of that operand;
//   INNER_M     consecutive blocks walk the row tiles first (they then share
//               one column tile of B through L2), else the column tiles;
//   C_M_CONTIG  (the maps of forward_wgmma.cuh's kernel only) C is
//               contiguous along its row index m (else along its column n).
// The loads put neighbouring threads on the contiguous index.
// One BK-deep stage of a row operand (A: rows m, depth k) into s[re/im][k][m].
template <class Map, class T>
__device__ __forceinline__ void stage_a(float (&s)[2][BK][BM + PAD], const T* __restrict__ a,
                                        int64_t a_plane, const Map& map, int64_t m0,
                                        int64_t k0, int64_t M, int64_t kend, int tid) {
#pragma unroll
  for (int r = 0; r < BM * BK / NT; ++r) {
    const int e = tid + r * NT;
    const int mm = Map::A_M_CONTIG ? e % BM : e / BK;
    const int kk = Map::A_M_CONTIG ? e / BM : e % BK;
    const int64_t m = m0 + mm, k = k0 + kk;
    float vr = 0.f, vi = 0.f;
    if (m < M && k < kend) {
      const int64_t off = map.a_off(m, k);
      vr = load_f32(a, off);
      vi = load_f32(a, off + a_plane);
      if (Map::CONJ_A) vi = -vi;
    }
    s[0][kk][mm] = vr;
    s[1][kk][mm] = vi;
  }
}

// One BK-deep stage of a column operand (B: depth k, columns n) into s[re/im][k][n].
template <class Map, class T>
__device__ __forceinline__ void stage_b(float (&s)[2][BK][BN + PAD], const T* __restrict__ b,
                                        int64_t b_plane, const Map& map, int64_t n0,
                                        int64_t k0, int64_t N, int64_t kend, int tid) {
#pragma unroll
  for (int r = 0; r < BK * BN / NT; ++r) {
    const int e = tid + r * NT;
    const int kk = Map::B_K_CONTIG ? e % BK : e / BN;
    const int nn = Map::B_K_CONTIG ? e / BK : e % BN;
    const int64_t k = k0 + kk, n = n0 + nn;
    float vr = 0.f, vi = 0.f;
    if (k < kend && n < N) {
      const int64_t off = map.b_off(k, n);
      vr = load_f32(b, off);
      vi = load_f32(b, off + b_plane);
      if (Map::CONJ_B) vi = -vi;
    }
    s[0][kk][nn] = vr;
    s[1][kk][nn] = vi;
  }
}

// The thread's TM x TN complex sub-tile += one staged A slice times one B slice.
__device__ __forceinline__ void mac_stage(const float (&As)[2][BK][BM + PAD],
                                          const float (&Bs)[2][BK][BN + PAD], int ty, int tx,
                                          float (&accr)[TM][TN], float (&acci)[TM][TN]) {
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
}

__device__ __forceinline__ void zero_tile(float (&accr)[TM][TN], float (&acci)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = 0.f;
}

template <class Map, class TC>
__device__ __forceinline__ void store_tile(TC* __restrict__ c, int64_t c_plane, const Map& map,
                                           int64_t m0, int64_t n0, int64_t M, int64_t N,
                                           int ty, int tx, const float (&accr)[TM][TN],
                                           const float (&acci)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx * TN + j;
      if (n >= N) continue;
      const int64_t off = map.c_off(m, n);
      store_f32(c, off, accr[i][j]);
      store_f32(c, off + c_plane, acci[i][j]);
    }
  }
}

template <class Map, class TA, class TB, class TC>
__global__ void __launch_bounds__(NT)
cgemm_tile_kernel(const TA* __restrict__ a, int64_t a_plane,
                  const TB* __restrict__ b, int64_t b_plane,
                  TC* __restrict__ c, int64_t c_plane, int64_t c_split,
                  int64_t M, int64_t N, int64_t KD, int64_t k_chunk,
                  int64_t tiles_m, int64_t tiles_n, Map map) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // [re/im][depth][row]
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];  // [re/im][depth][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t t = blockIdx.x;
  const int64_t mt = Map::INNER_M ? t % tiles_m : t / tiles_n;
  const int64_t nt = Map::INNER_M ? t / tiles_m : t % tiles_n;
  const int64_t m0 = mt * BM;
  const int64_t n0 = nt * BN;
  const int64_t kbeg = (int64_t)blockIdx.y * k_chunk;
  const int64_t kend = kbeg + k_chunk < KD ? kbeg + k_chunk : KD;
  c += (int64_t)blockIdx.y * c_split;

  float accr[TM][TN], acci[TM][TN];
  zero_tile(accr, acci);
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    stage_a(As, a, a_plane, map, m0, k0, M, kend, tid);
    stage_b(Bs, b, b_plane, map, n0, k0, N, kend, tid);
    __syncthreads();
    mac_stage(As, Bs, ty, tx, accr, acci);
    __syncthreads();
  }
  store_tile(c, c_plane, map, m0, n0, M, N, ty, tx, accr, acci);
}

// out[e] = sum_z parts[z * count + e] for e < count, z = 0, 1, ... in order.
// (static: this header is compiled into several translation units.)
static __global__ void reduce_splits(const float* __restrict__ parts,
                                     float* __restrict__ out, int64_t count, int64_t splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int64_t z = 0; z < splits; ++z) s += parts[z * count + e];
  out[e] = s;
}

inline int64_t ceil_div(int64_t x, int64_t y) { return (x + y - 1) / y; }

// Calls f(g, gp) with the cotangent g as const float* or const bf16* and the
// output gp as float* or bf16*, as the flags say; returns what f returns.
template <class F>
inline int with_cotangent_types(const void* g, void* gp, int g_bf16, int gp_bf16, F f) {
  using bf16 = __nv_bfloat16;
  if (g_bf16)
    return gp_bf16 ? f((const bf16*)g, (bf16*)gp) : f((const bf16*)g, (float*)gp);
  return gp_bf16 ? f((const float*)g, (bf16*)gp) : f((const float*)g, (float*)gp);
}

// Columns of the (2, A, K, B) window view: column c = a*B + b of the
// (K, A*B) matrix is x[a, :, b], at offset col(c) + j*B for row j.
struct WindowCols {
  int64_t K, B;
  int log_b;
  __device__ __forceinline__ int64_t col(int64_t c) const {
    return (c >> log_b) * K * B + (c & (B - 1));
  }
};

inline WindowCols window_cols(int64_t K, int64_t B) {
  int log_b = 0;
  while ((1LL << log_b) < B) ++log_b;
  return WindowCols{K, B, log_b};
}

// Window layout, gp = W^dagger g: rows j, depth i, columns c of the view.
struct WindowPullbackMap : WindowCols {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = true, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t c) const { return col(c) + i * B; }
  __device__ __forceinline__ int64_t c_off(int64_t j, int64_t c) const { return col(c) + j * B; }
};

// Window layout, gw = g conj(x)^T summed over the columns: rows i, depth c, columns j.
struct WindowGramMap : WindowCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t c) const { return col(c) + i * B; }
  __device__ __forceinline__ int64_t b_off(int64_t c, int64_t j) const { return col(c) + j * B; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

// Top-window layout (row-major (A, K)), gp = g conj(W): rows t, depth i, columns j.
struct TopPullbackMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = false;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t t, int64_t i) const { return t * K + i; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t t, int64_t j) const { return t * K + j; }
};

// Top-window layout, gw = g^T conj(x) summed over the rows: rows i, depth t, columns j.
struct TopGramMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t t) const { return t * K + i; }
  __device__ __forceinline__ int64_t b_off(int64_t t, int64_t j) const { return t * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

// Pre-rotation columns of a fused (rotation r, window on [0, k)) step, k >= r
// (rotmat_apply.cu, rotwin_apply.cu and their backwards, adjoint_rotmat.cu).
// The rotation q -> q + r makes the window's top r wires the pre-rotation
// state's bottom r bits l (L = 2^r) and its other k - r wires the top bits a
// (A = 2^(k-r)).  Window column j' = a*L + l (the caller permutes W's columns
// to this order) of column x (X = 2^(n-k)) lies at pre(j', x) = a*X*L + x*L + l
// of the pre-rotation state: j' walks it in runs of L.  With k == r
// (A = 1), pre(j', x) = x*K + j'.
struct RotCols {
  int64_t K, X, L;
  int log_l;
  __device__ __forceinline__ int64_t pre(int64_t j, int64_t x) const {
    return (j >> log_l) * X * L + x * L + (j & (L - 1));
  }
};

inline RotCols rot_cols(int64_t K, int64_t X, int64_t L) {
  int log_l = 0;
  while ((1LL << log_l) < L) ++log_l;
  return RotCols{K, X, L, log_l};
}

// Rotation then window, y[i, x] = sum_j' W[i, j'] pre(j', x), written in the
// post-rotation (K, X) layout: rows i, depth j', columns x.
struct RotWindowMap : RotCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = true, C_M_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t j, int64_t x) const { return pre(j, x); }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t x) const { return i * X + x; }
};

// Its pullback gp = W^dagger g, written back in the pre-rotation layout
// (the store is the transpose): rows x, depth i, columns j'.
struct RotPullbackMap : RotCols {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = false;
  __device__ __forceinline__ int64_t a_off(int64_t x, int64_t i) const { return i * X + x; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t j) const { return i * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t x, int64_t j) const { return pre(j, x); }
};

// Its matrix cotangent gw[i, j'] = sum_x g[i, x] conj(pre(j', x)): rows i,
// depth x, columns j'.
struct RotGramMap : RotCols {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t x) const { return i * X + x; }
  __device__ __forceinline__ int64_t b_off(int64_t x, int64_t j) const { return pre(j, x); }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

// Window on [0, k) then the rotation by r = n - k (matrot_apply.cu): the
// post-rotation state is (B, K), B = 2^r, the transpose of the window's
// (K, B) output.  Pullback gp[j, b] = sum_i conj(W[i, j]) g[b, i] into the
// pre-rotation (K, B) layout (matrot_apply_bwd.cu and adjoint_matrot.cu, on
// adjoint_tc.cuh's tile): rows j, depth i, columns b; g is read along i (the
// transposed load).
struct MatrotPullbackMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = true;
  static constexpr bool CONJ_A = true, CONJ_B = false, INNER_M = true;
  int64_t K, B;
  __device__ __forceinline__ int64_t a_off(int64_t j, int64_t i) const { return i * K + j; }
  __device__ __forceinline__ int64_t b_off(int64_t i, int64_t b) const { return b * K + i; }
  __device__ __forceinline__ int64_t c_off(int64_t j, int64_t b) const { return j * B + b; }
};

// A plain row-major K x K product C = A B (the adjoint steps' gw = G0 W).
struct SquareMap {
  static constexpr bool A_M_CONTIG = false, B_K_CONTIG = false;
  static constexpr bool CONJ_A = false, CONJ_B = false, INNER_M = false;
  int64_t K;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t l) const { return i * K + l; }
  __device__ __forceinline__ int64_t b_off(int64_t l, int64_t j) const { return l * K + j; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

// Launch geometry of one (possibly split) product; returns 0 or a CUDA error.
template <class Map, class TA, class TB, class TC>
inline int launch_cgemm(const TA* a, int64_t a_plane, const TB* b, int64_t b_plane,
                        TC* c, int64_t c_plane, int64_t c_split, int64_t M, int64_t N,
                        int64_t KD, int64_t splits, const Map& map, cudaStream_t stream) {
  const int64_t tiles_m = ceil_div(M, BM);
  const int64_t tiles_n = ceil_div(N, BN);
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // Whole BK stages per split, so no stage straddles two splits.
  const int64_t k_chunk = ceil_div(ceil_div(KD, splits), BK) * BK;
  cgemm_tile_kernel<Map, TA, TB, TC>
      <<<dim3((unsigned)blocks, (unsigned)splits), NT, 0, stream>>>(
          a, a_plane, b, b_plane, c, c_plane, c_split, M, N, KD, k_chunk,
          tiles_m, tiles_n, map);
  return (int)cudaGetLastError();
}

// Sum `splits` partials of `count` floats each into out, in order.
inline int launch_reduce(const float* parts, float* out, int64_t count, int64_t splits,
                         cudaStream_t stream) {
  const int threads = 256;
  reduce_splits<<<(unsigned)ceil_div(count, threads), threads, 0, stream>>>(
      parts, out, count, splits);
  return (int)cudaGetLastError();
}

// The adjoint steps' matrix cotangent from their split gram partials in ws:
// G0 = sum of the partials (into g0, 2*K*K floats), then gw = G0 W.
inline int launch_gram_times_w(const float* ws, int64_t splits, float* g0, const float* w,
                               float* gw, int64_t K, cudaStream_t stream) {
  int code = launch_reduce(ws, g0, 2 * K * K, splits, stream);
  if (code != 0) return code;
  return launch_cgemm(g0, K * K, w, K * K, gw, K * K, 0, K, K, K, 1, SquareMap{K}, stream);
}

}  // namespace qml
