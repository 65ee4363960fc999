// Tensor-core tile of the adjoint steps (adjoint_step.cu, adjoint_step_top.cu,
// adjoint_rotmat.cu, adjoint_matrot.cu), of the saved-residual backwards
// window_apply_bwd.cu, rotmat_apply_bwd.cu, matrot_apply_bwd.cu and
// rotwin_apply_bwd.cu, and of window_apply.cu, rotmat_apply.cu,
// matrot_apply.cu and window_apply_top.cu at the shapes under
// forward_wgmma.cuh's rule (which shares split() below): one complex
// matrix product C = op(A) * op(B) on real-split planes (each
// operand a Re plane followed, `plane` elements later, by an Im plane), on
// Hopper's tensor cores at float32-grade accuracy.
//
// Split TF32.  A float32 operand x is split into x = hi + lo, hi = x rounded
// to TF32 (nearest, ties away: the rounding of cvt.rna.tf32.f32, done with
// two integer operations because the cvt is a slow instruction) and
// lo = x - hi (exact in float32; the tensor core reads its top 19 bits, an
// error of at most 2^-21 |x|).  A product is then a_hi b_hi + a_hi b_lo +
// a_lo b_hi (the lo*lo term is below float32's rounding), three warp-level
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 passes with float32
// accumulation.  A bfloat16 operand (a cotangent) is
// exact in TF32 and is not split, so a product with one takes two passes.
// The complex product is four real ones, Cr = Ar Br - Ai Bi and
// Ci = Ar Bi + Ai Br, op() the identity or the conjugate (the Im fragment
// negated as it is read).  The precision is fixed here: the kernel does not
// read torch.backends.cuda.matmul.allow_tf32 or any other switch.
//
// Staging.  Operand tiles arrive through a 3-stage ring in dynamic shared
// memory, BK = 32 deep, filled with 16-byte cp.async.cg copies (zero-fill for
// chunks past an edge) while the warps multiply the stage before.  Each
// operand is kept in shared memory in the layout it has in device memory:
// along its contiguous index (A_M_CONTIG / B_K_CONTIG of the Map, as in
// cgemm_tile.cuh), with a row padding that makes the mma fragments' 4-byte
// reads free of bank conflicts in either layout.  That is why the fragments
// are read with mma.sync rather than wgmma, whose TF32 form wants both
// operands depth-contiguous: the pullback's state operand is contiguous along
// its columns.
//
// Shape rule (VEC).  The 16-byte copies need every contiguous run of an
// operand, and every extent along it, to hold whole 16-byte chunks: the
// launchers pass vec = (K >= 8 and the state's column run >= 8), the run
// being B of the window view or X of the rotmat layout; the top window's
// and the matrot adjoint step's operands all run along the window index, so
// theirs is K for both (window_apply_top.cu, adjoint_step_top.cu,
// adjoint_matrot.cu), the matrot steps' is B, along which x is read
// (matrot_apply.cu, matrot_apply_bwd.cu), and the rotwin backward's is the
// shorter of X and L, the run of x_pre along the window columns
// (rotwin_apply_bwd.cu).  Other shapes (K = 2 or 4, B = 2 or 4) take
// the same kernel with VEC = false: masked scalar loads into the same ring,
// no copy in flight.  Either way out-of-range rows,
// columns and depths are zero, so every power-of-two K from 2 up and every
// column count runs on the card.
//
// Tiling: a block of 256 threads (8 warps, 2 x 4) owns a 64 x 64 complex tile
// of C; a warp a 32 x 16 tile, 2 x 2 m16n8 fragments for Re and Im (32
// accumulators, and 16 for a stage's partial sums, below).
// __launch_bounds__(256, 2) and 110,592 bytes of shared
// memory (float32 operands) let two blocks share an SM.  Split reduction over
// blockIdx.y into per-split partials, as cgemm_tile.cuh's cgemm_tile_kernel,
// summed afterwards in a fixed order (no atomics).
#pragma once

#include "cgemm_tile.cuh"

namespace qml {
namespace tc {

constexpr int BM = 64;      // C rows per block
constexpr int BN = 64;      // C columns per block
constexpr int BK = 32;      // reduction depth per stage
constexpr int STAGES = 3;   // depth of the staging ring
constexpr int NT = 256;     // threads per block
constexpr int WARPS_N = 4;  // warps along the columns (2 along the rows)
constexpr int WM = 32;      // rows per warp
constexpr int WN = 16;      // columns per warp
constexpr int MT = WM / 16; // m16 fragments per warp
constexpr int NF = WN / 8;  // n8 fragments per warp
static_assert(BM == 2 * WM && BN == WARPS_N * WN, "8 warps cover the block tile");

// Shared-memory shape of one operand tile with R outer indices (rows of A or
// columns of B) and BK depths, both planes.  K_OUTER: the tile is stored
// [depth][R] (contiguous along R), else [R][depth].  The padding puts the
// eight rows of an mma fragment read on distinct banks.
template <class T, bool K_OUTER, int R>
struct TileShape {
  static constexpr int STRIDE = K_OUTER ? R + 8 : BK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int PLANE = K_OUTER ? BK * STRIDE : R * STRIDE;
  static constexpr int ELEMS = 2 * PLANE;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
  static_assert(BYTES % 16 == 0 && STRIDE * sizeof(T) % 16 == 0, "16-byte rows");
  __device__ __forceinline__ static int at(int r, int k) {
    return K_OUTER ? k * STRIDE + r : r * STRIDE + k;
  }
};

template <class T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes from device to shared memory, zeros when !in.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand tile for depths [k0, k0 + BK): outer indices from r0 (extent
// RN), depth below kend; off(r, k) is the element's offset in the Re plane.
template <bool VEC, bool K_OUTER, int R, class T, class Off>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g, int64_t plane, Off off,
                                      int64_t r0, int64_t RN, int64_t k0, int64_t kend,
                                      int tid) {
  using S = TileShape<T, K_OUTER, R>;
  constexpr int CONTIG = K_OUTER ? R : BK;  // the tile's extent along the contiguous index
  constexpr int OTHER = K_OUTER ? BK : R;
  if constexpr (VEC) {
    constexpr int V = 16 / (int)sizeof(T);
    constexpr int CHUNKS = 2 * OTHER * CONTIG / V;
    static_assert(CHUNKS % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int q = 0; q < CHUNKS / NT; ++q) {
      const int e = tid + q * NT;
      const int cc = (e % (CONTIG / V)) * V;
      const int o = (e / (CONTIG / V)) % OTHER;
      const int p = e / (CONTIG / V * OTHER);
      const int rr = K_OUTER ? cc : o, kk = K_OUTER ? o : cc;
      const int64_t r = r0 + rr, k = k0 + kk;
      const bool in = r < RN && k < kend;
      cp_async16(s + p * S::PLANE + S::at(rr, kk), in ? g + off(r, k) + p * plane : g, in);
    }
  } else {
    constexpr int ELEMS = 2 * OTHER * CONTIG;
#pragma unroll 4
    for (int q = 0; q < ELEMS / NT; ++q) {
      const int e = tid + q * NT;
      const int cc = e % CONTIG;
      const int o = (e / CONTIG) % OTHER;
      const int p = e / (CONTIG * OTHER);
      const int rr = K_OUTER ? cc : o, kk = K_OUTER ? o : cc;
      const int64_t r = r0 + rr, k = k0 + kk;
      s[p * S::PLANE + S::at(rr, kk)] =
          (r < RN && k < kend) ? g[off(r, k) + p * plane] : zero_value<T>();
    }
  }
}

// x = hi + lo (see the note above); a bfloat16 value (SPLIT = false) is
// exact in TF32 and its own hi.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split TF32: the small terms first, then hi * hi.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if constexpr (SA) mma_tf32(d, al, bh);
  if constexpr (SB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The warp's 32 x 16 complex tile += one staged A slice times one B slice.
// The tensor cores accumulate with truncation (round toward zero), which
// biases a long chain of mma into one accumulator by up to an ulp a step
// (measured: 1.3e-4 relative on a 4096-deep gram).  So each m16 row of
// fragments sums this stage's BK depths in fresh registers, and that partial
// joins the running sum with an ordinary float32 add (round to nearest).
template <class Map, class TA, class TB>
__device__ __forceinline__ void mma_stage(const TA* As, const TB* Bs, int wm, int wn, int gid,
                                          int tig, float (&accr)[MT][NF][4],
                                          float (&acci)[MT][NF][4]) {
  using SA = TileShape<TA, Map::A_M_CONTIG, BM>;
  using SB = TileShape<TB, !Map::B_K_CONTIG, BN>;
  constexpr bool SPLIT_A = sizeof(TA) == 4, SPLIT_B = sizeof(TB) == 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float pr[NF][4] = {}, pi[NF][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[NF][3][2], bl[NF][3][2];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wm * WM + mt * 16 + gid + (q & 1) * 8;
          const int col = kk + tig + (q >> 1) * 4;
          float v = to_f32(As[p * SA::PLANE + SA::at(row, col)]);
          if (p == 1 && Map::CONJ_A) v = -v;
          split<SPLIT_A>(v, ah[p][q], al[p][q]);
        }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = wn * WN + nf * 8 + gid;
            const int row = kk + tig + q * 4;
            float v = to_f32(Bs[p * SB::PLANE + SB::at(col, row)]);
            if (p == 1 && Map::CONJ_B) v = -v;
            split<SPLIT_B>(v, bh[nf][p][q], bl[nf][p][q]);
          }
        // -Bi, for Cr's -Ai Bi term: a sign flip of both halves.
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bh[nf][2][q] = bh[nf][1][q] ^ 0x80000000u;
          bl[nf][2][q] = bl[nf][1][q] ^ 0x80000000u;
        }
      }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        mma_split<SPLIT_A, SPLIT_B>(pr[nf], ah[0], al[0], bh[nf][0], bl[nf][0]);
        mma_split<SPLIT_A, SPLIT_B>(pr[nf], ah[1], al[1], bh[nf][2], bl[nf][2]);
        mma_split<SPLIT_A, SPLIT_B>(pi[nf], ah[0], al[0], bh[nf][1], bl[nf][1]);
        mma_split<SPLIT_A, SPLIT_B>(pi[nf], ah[1], al[1], bh[nf][0], bl[nf][0]);
      }
    }
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        accr[mt][nf][q] += pr[nf][q];
        acci[mt][nf][q] += pi[nf][q];
      }
  }
}

template <class Map, class TA, class TB>
constexpr int smem_bytes() {
  return STAGES * (TileShape<TA, Map::A_M_CONTIG, BM>::BYTES +
                   TileShape<TB, !Map::B_K_CONTIG, BN>::BYTES);
}

template <class Map, bool VEC, class TA, class TB, class TC>
__global__ void __launch_bounds__(NT, 2)
tc_cgemm_kernel(const TA* __restrict__ a, int64_t a_plane, const TB* __restrict__ b,
                int64_t b_plane, TC* __restrict__ c, int64_t c_plane, int64_t c_split,
                int64_t M, int64_t N, int64_t KD, int64_t k_chunk, int64_t tiles_m,
                int64_t tiles_n, Map map) {
  using SA = TileShape<TA, Map::A_M_CONTIG, BM>;
  using SB = TileShape<TB, !Map::B_K_CONTIG, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + STAGES * SA::BYTES);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, tig = lane % 4;
  const int64_t t = blockIdx.x;
  const int64_t m0 = (Map::INNER_M ? t % tiles_m : t / tiles_n) * BM;
  const int64_t n0 = (Map::INNER_M ? t / tiles_m : t % tiles_n) * BN;
  const int64_t kbeg = (int64_t)blockIdx.y * k_chunk;
  const int64_t kend = kbeg + k_chunk < KD ? kbeg + k_chunk : KD;
  const int nk = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;
  c += (int64_t)blockIdx.y * c_split;

  auto load = [&](int slot, int64_t k0) {
    stage<VEC, Map::A_M_CONTIG, BM>(
        As + slot * SA::ELEMS, a, a_plane,
        [&](int64_t m, int64_t k) { return map.a_off(m, k); }, m0, M, k0, kend, tid);
    stage<VEC, !Map::B_K_CONTIG, BN>(
        Bs + slot * SB::ELEMS, b, b_plane,
        [&](int64_t n, int64_t k) { return map.b_off(k, n); }, n0, N, k0, kend, tid);
  };

  float accr[MT][NF][4], acci[MT][NF][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int q = 0; q < 4; ++q) accr[mt][nf][q] = acci[mt][nf][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kbeg + (int64_t)s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and stage kt - 1 is no longer read
    const int pre = kt + STAGES - 1;
    if (pre < nk) load(pre % STAGES, kbeg + (int64_t)pre * BK);
    cp_async_commit();
    mma_stage<Map>(As + (kt % STAGES) * SA::ELEMS, Bs + (kt % STAGES) * SB::ELEMS, wm, wn, gid,
                   tig, accr, acci);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * WM + mt * 16 + gid + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int64_t n = n0 + wn * WN + nf * 8 + 2 * tig + j;
          if (n >= N) continue;
          const int64_t off = map.c_off(m, n);
          store_f32(c, off, accr[mt][nf][2 * h + j]);
          store_f32(c, off + c_plane, acci[mt][nf][2 * h + j]);
        }
    }
}

template <class Map, bool VEC, class TA, class TB, class TC>
inline int launch(const TA* a, int64_t a_plane, const TB* b, int64_t b_plane, TC* c,
                  int64_t c_plane, int64_t c_split, int64_t M, int64_t N, int64_t KD,
                  int64_t splits, const Map& map, cudaStream_t stream) {
  const int64_t tiles_m = ceil_div(M, BM);
  const int64_t tiles_n = ceil_div(N, BN);
  const int64_t blocks = tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<Map, TA, TB>();
  auto kernel = tc_cgemm_kernel<Map, VEC, TA, TB, TC>;
  int code = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (code != 0) return code;
  // Whole BK stages per split, so no stage straddles two splits.
  const int64_t k_chunk = ceil_div(ceil_div(KD, splits), BK) * BK;
  kernel<<<dim3((unsigned)blocks, (unsigned)splits), NT, bytes, stream>>>(
      a, a_plane, b, b_plane, c, c_plane, c_split, M, N, KD, k_chunk, tiles_m, tiles_n, map);
  return (int)cudaGetLastError();
}

}  // namespace tc

// One split-TF32 product (see the note above); vec selects the 16-byte copies
// (the launcher's shape rule).  Returns 0 or a CUDA error.
template <class Map, class TA, class TB, class TC>
inline int launch_tc_cgemm(const TA* a, int64_t a_plane, const TB* b, int64_t b_plane, TC* c,
                           int64_t c_plane, int64_t c_split, int64_t M, int64_t N, int64_t KD,
                           int64_t splits, bool vec, const Map& map, cudaStream_t stream) {
  return vec ? tc::launch<Map, true>(a, a_plane, b, b_plane, c, c_plane, c_split, M, N, KD,
                                     splits, map, stream)
             : tc::launch<Map, false>(a, a_plane, b, b_plane, c, c_plane, c_split, M, N, KD,
                                      splits, map, stream);
}

// The shape rule of the 16-byte copies: K >= 8 and column runs of >= 8.
__host__ __device__ inline bool tc_vec_shape(int64_t K, int64_t run) {
  return K >= 8 && run >= 8;
}

// An adjoint step on the tensor cores: the two pullbacks psi_prev = op(W) psi
// and lam_prev = op(W) lam through the pullback map P (W is the conjugated
// operand: A when P conjugates A, else B), the gram G0 of lam and psi over
// `depth` columns through G into the split partials in ws, their fixed-order
// sum and gw = G0 W.  M x N pullback outputs.  Returns 0 or the first CUDA
// error.
template <class P, class G, class TL, class TO>
inline int launch_adjoint_tc(const float* w, const float* psi, const TL* lam, float* psi_prev,
                             TO* lam_prev, float* gw, float* ws, int64_t plane, int64_t K,
                             int64_t M, int64_t N, int64_t depth, int64_t splits, bool vec,
                             const P& pull, const G& gram, cudaStream_t stream) {
  int code;
  if constexpr (P::CONJ_A) {
    code = launch_tc_cgemm(w, K * K, psi, plane, psi_prev, plane, 0, M, N, K, 1, vec, pull,
                           stream);
    if (code == 0)
      code = launch_tc_cgemm(w, K * K, lam, plane, lam_prev, plane, 0, M, N, K, 1, vec, pull,
                             stream);
  } else {
    code = launch_tc_cgemm(psi, plane, w, K * K, psi_prev, plane, 0, M, N, K, 1, vec, pull,
                           stream);
    if (code == 0)
      code = launch_tc_cgemm(lam, plane, w, K * K, lam_prev, plane, 0, M, N, K, 1, vec, pull,
                             stream);
  }
  if (code != 0) return code;
  code = launch_tc_cgemm(lam, plane, psi, plane, ws, K * K, 2 * K * K, K, K, depth, splits, vec,
                         gram, stream);
  if (code != 0) return code;
  return launch_gram_times_w(ws, splits, ws + splits * 2 * K * K, w, gw, K, stream);
}

// The saved-residual backward of a window or fused rotation step on the
// tensor cores (window_apply_bwd.cu and the rotmat, matrot and rotwin
// backwards): the pullback gp = W^dagger g through the map P over M x N
// outputs (W is the conjugated operand: A when P conjugates A, else B),
// then the gram of g and the saved input x over `depth` columns through G
// into the split partials in ws, summed in order into gw.  The saved gram
// is gw itself: no G0 W.  vec is the launcher's shape rule (the note above).
// Returns 0 or the first CUDA error.
template <class P, class G, class TG, class TP>
inline int launch_fused_bwd_tc(const float* w, const TG* g, const float* x, TP* gp, float* gw,
                               float* ws, int64_t plane, int64_t K, int64_t M, int64_t N,
                               int64_t depth, int64_t splits, bool vec, const P& pull,
                               const G& gram, cudaStream_t stream) {
  int code;
  if constexpr (P::CONJ_A)
    code = launch_tc_cgemm(w, K * K, g, plane, gp, plane, 0, M, N, K, 1, vec, pull, stream);
  else
    code = launch_tc_cgemm(g, plane, w, K * K, gp, plane, 0, M, N, K, 1, vec, pull, stream);
  if (code != 0) return code;
  code = launch_tc_cgemm(g, plane, x, plane, ws, K * K, 2 * K * K, K, K, depth, splits, vec,
                         gram, stream);
  if (code != 0) return code;
  return launch_reduce(ws, gw, 2 * K * K, splits, stream);
}

}  // namespace qml
