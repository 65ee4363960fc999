// Batch entries of the window kernels (window_apply.cu, window_apply_top.cu,
// window_apply_bwd.cu, window_apply_top_bwd.cu): a batch of Bt states in
// one launch, each element with its own window W_e, or all with one, in
// float32 or float64 (a float64 state on the card runs here, a single one
// as a batch of one).
//
// Counterpart of the JAX package's vmapped pallas_call (the batched Pallas
// window kernels under the executor's vmap).  The state is (2, Bt*A*K*B):
// Re/Im planes outermost, the batch folded into the A axis of the window
// view, so element e owns the rows [e*A, (e+1)*A) of (2, Bt*A, K, B).  W_e
// lies at w + e * w_stride as (2, K, K) (Re plane, then Im); w_stride = 0
// shares one window, 2*K*K gives one per element.  B = 1 is the top window.
//
//   forward   y[e,a,i,b]  = sum_j W_e[i,j] x[e,a,j,b]
//   pullback  gp[e,a,j,b] = sum_i conj(W_e[i,j]) g[e,a,i,b]
//   gram      gw_e[i,j]   = sum_(a,b) g[e,a,i,b] conj(x[e,a,j,b])
//
// What bounds it on an H100: below LARGE_STATE_MIN_N a batch's windows are
// small (K <= 32 in a plan, 2**n <= 2**21 amplitudes an element) and the
// batch is wide, so each launch streams the batched state once through
// HBM.  The forward runs on the float32 CUDA cores, one output amplitude a
// thread, W_e's row read through the read-only cache (it is shared by the
// K*B threads of its element).
//
// The backward (backward_kernel) is one launch a call.  Its columns are the
// Q = Bt*A*B columns (a, b) of the batch view; a CTA of 256 threads walks
// tiles of tc columns (all K rows), copied with cp.async into shared memory
// with the CTA's window(s), and from there computes the pullback of the
// tile and adds the tile to its gram outputs.  A launch at the 6q gradient's
// shapes moves ~0.4 MB: it is bound by the launch and by how fast the
// partial grams meet, not by HBM, so the design counts launches and the
// depth of the final sum:
//  * whole-element CTAs (per-element W, an element within one tile): a CTA
//    holds `group` elements and writes their grams itself;
//  * column mode (a shared W, or elements wider than a tile): the CTAs
//    split the columns of one gram (the batch's, or an element's) into
//    `parts` contiguous runs of tiles and, for K*K > 1024, its outputs into
//    `blocks`; a CTA keeps its outputs (one a thread, or up to 4: RMAX) in
//    registers across its tiles; when parts > 1 it writes a partial gram,
//    fences, and counts its arrival on an integer counter of its gram block;
//    the last CTA to arrive resets the counter and sums the block's partials
//    in index order, split over its threads and joined in a fixed pairwise
//    tree in shared memory.
// Within a CTA the columns of a gram are split into slices, each summed in
// order by one thread per output (from a column skewed by the output, so a
// warp's shared-memory reads fall on different banks), the slices then
// summed in a fixed pairwise tree.  A tile spanning whole runs of B keeps
// its blocks of K runs (K + 1) * B apart in shared memory, for the same
// reason.  For K > 32 a CTA's pullback rows are few and long: each row's
// sum is split over the threads too.  No atomic touches a value: every
// sum's order is a function of the shapes alone, so a gradient repeats bit
// for bit.  The geometry (tile, group, parts, blocks, shared memory) is
// chosen by the wrapper (cuda_kernels.batch_bwd_geometry) and handed over as
// BwdGeom; the counters are the wrapper's, one array per device and stream,
// zero between launches.  Tensor cores are not used: at K <= 32 the
// backward does 16K flops for 24 bytes an amplitude, at most the float32
// CUDA cores' ridge, and the float64 path has no TF32 counterpart.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qml {
namespace batch {
namespace {  // internal linkage: every window source includes this header

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 65535LL * 16;

inline unsigned blocks_for(int64_t work) {
  int64_t b = (work + THREADS - 1) / THREADS;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return (unsigned)(b < 1 ? 1 : b);
}

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// y = W_e x (forward) or y = W_e^dag x (pullback, ADJ) on each element.
template <bool ADJ, class T>
__global__ void __launch_bounds__(THREADS)
window_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
              int64_t plane, int64_t D, int64_t K, int64_t B, int64_t w_stride) {
  const int64_t KK = K * K;
  for (int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x; t < plane;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t e = t / D;
    const int64_t i = (t / B) % K;
    const T* we = w + e * w_stride;
    const T* xr = x + (t - i * B);  // x[e, a, 0, b]
    const T* xi = xr + plane;
    T ar = 0, ai = 0;
    for (int64_t j = 0; j < K; ++j) {
      // forward: W[i, j]; pullback: conj(W[j, i])
      const int64_t at = ADJ ? j * K + i : i * K + j;
      const T wr = __ldg(we + at);
      const T wi = ADJ ? -__ldg(we + KK + at) : __ldg(we + KK + at);
      const T br = xr[j * B], bi = xi[j * B];
      ar = madd(wr, br, ar);
      ar = madd(-wi, bi, ar);
      ai = madd(wr, bi, ai);
      ai = madd(wi, br, ai);
    }
    y[t] = ar;
    y[t + plane] = ai;
  }
}

template <class T>
int forward_t(const T* x, const T* w, T* y, int64_t E, int64_t A, int64_t K, int64_t B,
              int64_t w_stride, cudaStream_t stream) {
  const int64_t D = A * K * B, plane = E * D;
  window_kernel<false, T><<<blocks_for(plane), THREADS, 0, stream>>>(x, w, y, plane, D, K, B,
                                                                      w_stride);
  return (int)cudaGetLastError();
}

// x, w, y: float32, or float64 when f64.
inline int forward(const void* x, const void* w, void* y, int64_t E, int64_t A, int64_t K,
                   int64_t B, int64_t w_stride, int f64, cudaStream_t stream) {
  if (f64)
    return forward_t((const double*)x, (const double*)w, (double*)y, E, A, K, B, w_stride,
                     stream);
  return forward_t((const float*)x, (const float*)w, (float*)y, E, A, K, B, w_stride, stream);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Gram outputs a thread: one (RMAX 1) while a CTA has at most THREADS,
// else up to 4 (RMAX 4; at most 4 * THREADS a CTA).
constexpr int BWD_RMAX = 4;

// The launch's geometry, as cuda_kernels.BatchBwdGeometry packs it (int64
// each, in this order).
struct BwdGeom {
  int64_t E, A, K, B;  // the batch view (2, E*A, K, B)
  int64_t w_stride;    // 0: one W; 2*K*K: one an element
  int64_t tc;          // columns a tile (a power of two)
  int64_t tpc;         // tiles a CTA walks (column mode)
  int64_t parts;       // CTAs whose partial grams make one gram block (1: written directly)
  int64_t blocks;      // gram output blocks of K*K / blocks outputs (column mode)
  int64_t group;       // elements a CTA (whole-element mode), 0 in column mode
  int64_t stage;       // 1: g and x tiles through shared memory, 0: read in place
  int64_t w_smem;      // 1: the CTA's window(s) through shared memory
  int64_t grid;        // CTAs
  int64_t smem;        // dynamic shared memory, bytes
  int64_t f64;         // float64 (else float32)
};

template <class T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
template <class VT> __device__ __forceinline__ VT vzero();
template <> __device__ __forceinline__ float4 vzero<float4>() { return make_float4(0, 0, 0, 0); }
template <> __device__ __forceinline__ double2 vzero<double2>() { return make_double2(0, 0); }

__device__ __forceinline__ int ilog2(int64_t v) { return 63 - __clzll(v); }

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

// `runs` runs of `len` values: run r from src + r*gstr (the Im plane at
// +plane) to dst + r*sstr (the Im plane at +dim), CH values a copy.
template <int CH, class T>
__device__ __forceinline__ void stage_runs_by(T* dst, int sstr, int dim, const T* src,
                                              int64_t gstr, int64_t plane, int runs, int len) {
  const int per = len / CH, total = 2 * runs * per;
  for (int k = threadIdx.x; k < total; k += THREADS) {
    const int p = k / (runs * per), r = (k / per) % runs, o = (k % per) * CH;
    copy_async<(int)(CH * sizeof(T))>(dst + p * dim + r * sstr + o,
                                      src + p * plane + (int64_t)r * gstr + o);
  }
}

// 16-byte copies when every address allows them, else one value a copy.
template <class T>
__device__ __forceinline__ void stage_runs(T* dst, int sstr, int dim, const T* src,
                                           int64_t gstr, int64_t plane, int runs, int len) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
                    15) == 0 && len % V == 0 && gstr % V == 0 && plane % V == 0 &&
                   sstr % V == 0 && dim % V == 0;
  if (vec)
    stage_runs_by<V>(dst, sstr, dim, src, gstr, plane, runs, len);
  else
    stage_runs_by<1>(dst, sstr, dim, src, gstr, plane, runs, len);
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a + src[q * stride] for q in [q0, q1), in order, eight loads in flight
// (the slots lie in L2: a serial chain of loads would wait on each).
template <class VT>
__device__ __forceinline__ VT sum_parts(VT a, const VT* src, int64_t stride, int64_t q0,
                                        int64_t q1) {
  int64_t q = q0;
  for (; q + 8 <= q1; q += 8) {
    VT l[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) l[k] = __ldcg(src + (q + k) * stride);
#pragma unroll
    for (int k = 0; k < 8; ++k) a = vadd(a, l[k]);
  }
  for (; q < q1; ++q) a = vadd(a, __ldcg(src + q * stride));
  return a;
}

template <class T, int RMAX, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)  // two CTAs an SM: <= 128 registers
backward_kernel(const T* __restrict__ w, const T* __restrict__ g, const T* __restrict__ x,
                T* __restrict__ gp, T* __restrict__ gw, T* __restrict__ ws,
                unsigned* __restrict__ cnt, const BwdGeom p) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char batch_smem[];
  __shared__ VT red[THREADS];  // the trees' slices
  __shared__ bool last;
  T* redt = reinterpret_cast<T*>(red);

  // Every extent but E, parts and tpc is a power of two: shifts, not
  // divisions, on the CTA's critical path.
  const int t = threadIdx.x;
  const int K = (int)p.K, lgK = ilog2(p.K), lgKK = 2 * lgK;
  const int64_t KK = p.K * p.K, B = p.B, C = p.A * B, plane = p.E * C * p.K, Q = p.E * C;
  const int lgB = ilog2(B), lgC = ilog2(C), lgtc = ilog2(p.tc), lgbl = ilog2(p.blocks);
  const bool whole = p.group != 0, one_w = p.w_stride == 0;

  // This CTA: gram group grp (the CTA's elements, the batch, or an
  // element), output block u, part s; its tiles [k0, k1) of the group.
  const unsigned b = blockIdx.x, parts = (unsigned)p.parts;
  const unsigned bp = b / parts, s = b - bp * parts;
  const int64_t grp = bp >> lgbl, u = bp & (p.blocks - 1);
  const int64_t cg = whole ? p.tc : (one_w ? Q : C);
  const int64_t gq0 = grp * cg, gcols = min(cg, Q - gq0);
  const int64_t k0 = s * p.tpc, k1 = min((gcols + p.tc - 1) >> lgtc, k0 + p.tpc);
  const int64_t e0 = gq0 >> lgC;  // the group's first element
  const int tc = (int)p.tc, run = (int)min(B, p.tc), lgrun = ilog2(run);

  // Gram outputs: NO complex outputs a CTA; a thread owns R of them
  // (o0 + r * THREADS) and column slice h of H.
  const int NO = whole ? (int)(p.group << lgKK) : (int)(KK >> lgbl), lgNO = ilog2(NO);
  const int H = NO >= THREADS ? 1 : THREADS >> lgNO, R = NO >= THREADS ? NO / THREADS : 1;
  const int o0 = NO >= THREADS ? t : t & (NO - 1), h = NO >= THREADS ? 0 : t >> lgNO;
  const int sub = whole ? (int)C : tc;  // columns of one gram in a tile
  const int ch = max(1, sub >> ilog2(H));
  // Pullback rows of this output block.
  const int64_t j0 = (u * p.K + p.blocks - 1) >> lgbl;
  const int64_t j1 = ((u + 1) * p.K + p.blocks - 1) >> lgbl;

  T* sw = reinterpret_cast<T*>(batch_smem);
  T* sg = sw + (p.w_smem ? (whole ? p.group : 1) * 2 * KK : 0);
  T* sx = sg + 2 * (p.K + 1) * p.tc;
  const T* wsrc = w + (one_w ? 0 : e0 * 2 * KK);
  const int wcount = p.w_smem ? (int)((whole ? gcols >> lgC : 1) * 2 * KK) : 0;

  T accr[RMAX], acci[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) accr[r] = acci[r] = 0;

  for (int64_t kt = k0; kt < k1; ++kt) {
    const int64_t q0 = gq0 + kt * p.tc;
    const int ncols = (int)min(p.tc, gq0 + gcols - q0);
    const int64_t base = (q0 >> lgB) * p.K * B + (q0 & (B - 1));
    const T *tgr, *tgi, *txr, *txi;
    int rs;
    if (kt > k0) __syncthreads();  // every thread is done with the last tile
    if (kt == k0 && wcount) stage_runs(sw, 0, wcount / 2, wsrc, 0, wcount / 2, 1, wcount / 2);
    // Offset of (row i, column c) in the tile: (c >> lgrun) * blk + (c & (run-1)) + i * rs.
    int blk;
    if (p.stage) {
      // The tile: when it spans whole runs of B, its ncols / B blocks of K*B
      // contiguous values, each a plane, kept (K+1)*B apart (the pad puts
      // neighbouring blocks on other banks); else K runs of tc (stride B).
      const int dim = (K + 1) * tc;
      const bool flat = p.tc > B;
      const int runs = flat ? ncols >> lgB : K, len = flat ? K * (int)B : tc;
      const int sstr = flat ? (K + 1) * (int)B : tc;
      const int64_t gstr = flat ? K * B : B;
      stage_runs(sg, sstr, dim, g + base, gstr, plane, runs, len);
      stage_runs(sx, sstr, dim, x + base, gstr, plane, runs, len);
      tgr = sg, tgi = sg + dim, txr = sx, txi = sx + dim, rs = run, blk = sstr;
    } else {
      tgr = g + base, tgi = tgr + plane, txr = x + base, txi = txr + plane, rs = (int)B;
      blk = K * (int)B;
    }
    copies_done();
    __syncthreads();

    // Pullback of rows [j0, j1): np outputs (j, c), one a thread.  SPLIT
    // (K > 32: a wide window's output blocks, few outputs with long sums):
    // each output's sum over i is split into Hp slices of chp rows instead,
    // joined in a fixed pairwise tree (compiled only there: the generic row
    // range costs the short sums ~15 %).
    T* gpr = gp + base;
    T* gpi = gpr + plane;
    const int np = (int)(j1 - j0) << lgtc, lgnp = np ? ilog2(np) : 0;
    const int Hp = SPLIT && np && np < THREADS ? min(K, THREADS >> lgnp) : 1;
    const int chp = K >> ilog2(Hp);
    for (int idx = t; idx < np * Hp; idx += THREADS) {
      const int c = idx & (tc - 1), hp = idx >> lgnp;
      if (c >= ncols) continue;  // a short last tile
      const int64_t j = j0 + ((idx & (np - 1)) >> lgtc);
      const int co = (c >> lgrun) * blk + (c & (run - 1));
      const int64_t e = (q0 + c) >> lgC;
      const T* we = wcount ? sw + (whole ? (e - e0) * 2 * KK : 0) : w + e * p.w_stride;
      T ar = 0, ai = 0;
      const int i0 = SPLIT ? hp * chp : 0, i1 = SPLIT ? i0 + chp : K;
      for (int i = i0; i < i1; ++i) {
        const T wr = we[i * p.K + j], wi = we[KK + i * p.K + j];  // conj(W[i, j])
        const T br = tgr[co + i * rs], bi = tgi[co + i * rs];
        ar = madd(wr, br, ar);
        ar = madd(wi, bi, ar);
        ai = madd(wr, bi, ai);
        ai = madd(-wi, br, ai);
      }
      if (SPLIT && Hp > 1) {
        redt[idx] = ar;
        redt[THREADS + idx] = ai;
      } else {
        const int go = (c >> lgrun) * K * (int)B + (c & (run - 1)) + (int)j * (int)B;
        gpr[go] = ar;
        gpi[go] = ai;
      }
    }
    if (SPLIT && Hp > 1) {
      __syncthreads();
      for (int st = Hp / 2; st > 0; st >>= 1) {
        if (t < st * np) {
          redt[t] += redt[t + st * np];
          redt[THREADS + t] += redt[THREADS + t + st * np];
        }
        __syncthreads();
      }
      const int c = t & (tc - 1);
      if (t < np && c < ncols) {
        const int j = (int)(j0 + (t >> lgtc));
        const int go = (c >> lgrun) * K * (int)B + (c & (run - 1)) + j * (int)B;
        gpr[go] = redt[t];
        gpi[go] = redt[THREADS + t];
      }
    }

    // Gram: each owned output over its slice of this tile's columns, from
    // column lo + ij % len on, wrapping: neighbouring outputs start on
    // neighbouring columns, so a warp's reads of x[j] (and g[i]) fall on
    // different banks; the order is still a function of the shapes.
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        const int oc = o0 + r * THREADS;
        const int ge = whole ? oc >> lgKK : 0;
        const int64_t ij = whole ? oc & (KK - 1) : u * NO + oc;
        const int i = (int)(ij >> lgK), j = (int)(ij & (K - 1));
        const int lo = ge * sub + h * ch, hi = min(ncols, ge * sub + min(sub, (h + 1) * ch));
        if (lo < hi) {
          int c = lo + (int)(ij & 1023) % (hi - lo);
          T sr = accr[r], si = acci[r];
          for (int m = lo; m < hi; ++m) {
            const int co = (c >> lgrun) * blk + (c & (run - 1));
            const T gr = tgr[co + i * rs], gi = tgi[co + i * rs];
            const T xr = txr[co + j * rs], xi = txi[co + j * rs];
            sr = madd(gr, xr, sr);
            sr = madd(gi, xi, sr);
            si = madd(gi, xr, si);
            si = madd(-gr, xi, si);
            if (++c == hi) c = lo;
          }
          accr[r] = sr;
          acci[r] = si;
        }
      }
    }
  }

  if (H > 1) {  // one output a thread: its H slices in a fixed pairwise tree
    redt[t] = accr[0];
    redt[THREADS + t] = acci[0];
    __syncthreads();
    for (int st = H / 2; st > 0; st >>= 1) {
      if (h < st) {
        redt[t] += redt[t + st * NO];
        redt[THREADS + t] += redt[THREADS + t + st * NO];
      }
      __syncthreads();
    }
    accr[0] = redt[t];
    acci[0] = redt[THREADS + t];
  }

  if (whole) {
    if (h == 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const int oc = o0 + r * THREADS, ge = oc >> lgKK;
          if ((int64_t)ge * C < gcols) {
            T* out = gw + (e0 + ge) * 2 * KK + (oc & (KK - 1));
            out[0] = accr[r];
            out[KK] = acci[r];
          }
        }
      }
    }
    return;
  }
  T* dst = gw + (one_w ? 0 : grp * 2 * KK) + u * NO;  // the block's Re plane; Im at +KK
  if (p.parts == 1) {
    if (h == 0) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          dst[o0 + r * THREADS] = accr[r];
          dst[KK + o0 + r * THREADS] = acci[r];
        }
      }
    }
    return;
  }

  // A partial of gram block gb: slot (gb, s) holds [Re NO][Im NO].
  const int64_t gb = grp * p.blocks + u;
  T* slot = ws + (gb * p.parts + s) * 2 * NO;
  if (h == 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        slot[o0 + r * THREADS] = accr[r];
        slot[NO + o0 + r * THREADS] = acci[r];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(cnt + gb, 1u) == (unsigned)(p.parts - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t == 0) cnt[gb] = 0;  // ready for the next launch on this stream

  // The last CTA: out[v] = sum over the parts, in order, of the slots'
  // vector v (NV of 2*NO values each), the parts split into H2 slices.
  const VT* src = reinterpret_cast<const VT*>(ws + gb * p.parts * 2 * NO);
  const int NV = 2 * NO / V, H2 = NV >= THREADS ? 1 : THREADS / NV;
  auto store = [&](int v, VT a) {
    T* o = v * V < NO ? dst + v * V : dst + KK + (v * V - NO);
    *reinterpret_cast<VT*>(o) = a;
  };
  if (H2 == 1) {
    for (int v = t; v < NV; v += THREADS)
      store(v, sum_parts(vzero<VT>(), src + v, NV, 0, p.parts));
    return;
  }
  const int v = t % NV, h2 = t / NV;
  const int64_t per = (p.parts + H2 - 1) / H2;
  const int64_t q0 = min(p.parts, h2 * per), q1 = min(p.parts, q0 + per);
  const VT a = sum_parts(vzero<VT>(), src + v, NV, q0, q1);
  red[t] = a;
  __syncthreads();
  for (int st = H2 / 2; st > 0; st >>= 1) {
    if (h2 < st) red[t] = vadd(red[t], red[t + st * NV]);
    __syncthreads();
  }
  if (h2 == 0) store(v, red[t]);
}

template <class T>
int backward_t(const BwdGeom& p, const T* w, const T* g, const T* x, T* gp, T* gw, T* ws,
               unsigned* cnt, cudaStream_t stream) {
  const int64_t outputs = p.group ? p.group * p.K * p.K : p.K * p.K / p.blocks;
  const dim3 grid((unsigned)p.grid);
  const size_t smem = (size_t)p.smem;
  if (outputs <= THREADS)
    backward_kernel<T, 1, false><<<grid, THREADS, smem, stream>>>(w, g, x, gp, gw, ws, cnt, p);
  else if (p.K <= 32)
    backward_kernel<T, BWD_RMAX, false><<<grid, THREADS, smem, stream>>>(w, g, x, gp, gw, ws,
                                                                        cnt, p);
  else
    backward_kernel<T, BWD_RMAX, true><<<grid, THREADS, smem, stream>>>(w, g, x, gp, gw, ws,
                                                                       cnt, p);
  return (int)cudaGetLastError();
}

// geom: BwdGeom's fields; gw: (E, 2, K, K) when w_stride != 0, else
// (2, K, K); ws: parts * (grid / parts) * 2*K*K/blocks values (column mode
// with parts > 1, else unused); cnt: grid / parts zeroed counters, left
// zero; every array float32, or float64 when f64.
inline int backward(const long long* geom, const void* w, const void* g, const void* x,
                    void* gp, void* gw, void* ws, void* cnt, cudaStream_t stream) {
  const BwdGeom p = *reinterpret_cast<const BwdGeom*>(geom);
  if (p.f64)
    return backward_t(p, (const double*)w, (const double*)g, (const double*)x, (double*)gp,
                      (double*)gw, (double*)ws, (unsigned*)cnt, stream);
  return backward_t(p, (const float*)w, (const float*)g, (const float*)x, (float*)gp,
                    (float*)gw, (float*)ws, (unsigned*)cnt, stream);
}

}  // namespace
}  // namespace batch
}  // namespace qml
