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
// HBM: at FCC's 6q shapes a float32 element is 512 bytes read and 512
// written, its own W 128-512 bytes, for at most 8K flops an amplitude.
//
// The forward (forward_kernel) is one launch a call, a thread a column
// (e, a, b) of the Q = Bt*A*B columns, all K outputs from the K inputs it
// holds in registers, so each input is read from HBM once and each output
// written once.  Persistent CTAs (the card's residency, cuda_kernels'
// batch_fwd_geometry and the launcher's occupancy query) walk tiles of tc
// columns: whole blocks (e, a) of K*B contiguous values when B < tc (the
// FCC's B = 4-16, the KL's, top windows), kept K*B + pad apart so a warp's
// column reads fall on distinct banks, else K runs of tc values (stride B).
// A tile and its elements' windows are copied with 16-byte cp.async into
// one of two buffers while the CTA computes the other; a shared W is
// staged once a CTA; a W row is read from shared memory in 16-byte loads,
// the same address across a column group (a broadcast).  The outputs
// overwrite the column in shared memory and leave as 16-byte stores.  Each
// output sums its K terms in order, so a call repeats bit for bit.  K above
// the register budget (32 in float32, 16 in float64; no plan's window below
// LARGE_STATE_MIN_N) splits a column's outputs over K/4 threads that read
// through the caches (forward_wide).  The float32 and float64 CUDA cores do
// the products: at K <= 8 an amplitude costs 8K flops for 16-32 bytes.
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

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace qml {
namespace batch {
namespace {  // internal linkage: every window source includes this header

constexpr int THREADS = 256;

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// A thread holds its column's K complex inputs in registers up to K =
// fwd_kreg; above it, it computes FWD_WIDE_R of the column's outputs.
constexpr int FWD_WIDE_R = 4;
template <class T> constexpr int fwd_kreg() { return sizeof(T) == 4 ? 32 : 16; }

// The launch's geometry, as cuda_kernels.BatchFwdGeometry packs it (int64
// each, in this order).
struct FwdGeom {
  int64_t E, A, K, B;  // the batch view (2, E*A, K, B)
  int64_t w_stride;    // 0: one W; 2*K*K: one an element
  int64_t rows;        // outputs a thread: K, or FWD_WIDE_R (K above the register budget)
  int64_t tc;          // columns a tile (a power of two; one a thread), 0 when wide
  int64_t pad;         // values after each block of K*B in shared memory (tc > B)
  int64_t dim;         // values of one plane of a tile in shared memory
  int64_t wdim;        // values of a tile's windows in shared memory (0: one W, or read in place)
  int64_t tiles;       // tiles, or the wide path's work items
  int64_t threads;     // a CTA's threads
  int64_t grid;        // CTAs at most (the launcher keeps it within the card's residency)
  int64_t smem;        // dynamic shared memory, bytes
  int64_t sms;         // the card's SMs
  int64_t f64;         // float64 (else float32)
};

// N values from s into r, in 16-byte loads when they fill them.
template <class T, int N>
__device__ __forceinline__ void ld_vals(const T* s, T (&r)[N]) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  if constexpr (N % V == 0) {
#pragma unroll
    for (int v = 0; v < N; v += V) {
      const VT a = *reinterpret_cast<const VT*>(s + v);
      if constexpr (V == 4) {
        r[v] = a.x, r[v + 1] = a.y, r[v + 2] = a.z, r[v + 3] = a.w;
      } else {
        r[v] = a.x, r[v + 1] = a.y;
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v) r[v] = s[v];
  }
}

template <class T, int N>
__device__ __forceinline__ void st_vals(T* s, const T (&r)[N]) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  if constexpr (N % V == 0) {
#pragma unroll
    for (int v = 0; v < N; v += V) {
      VT a;
      if constexpr (V == 4) {
        a.x = r[v], a.y = r[v + 1], a.z = r[v + 2], a.w = r[v + 3];
      } else {
        a.x = r[v], a.y = r[v + 1];
      }
      *reinterpret_cast<VT*>(s + v) = a;
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v) s[v] = r[v];
  }
}

// A tile between device memory and shared memory, CH values a copy: nseg
// (<= 2^lgseg) segments of 2^lglen values, the first `valid` of each moved
// (a multiple of CH), segment r at g + r*gstr (the Im plane at +plane) and
// at s + r*sstr (the Im plane at +dim).  LOAD: cp.async into shared
// memory; else stores from it.
template <bool LOAD, int CH, class T>
__device__ __forceinline__ void move_tile(T* s, int sstr, int dim, T* g, int64_t gstr,
                                          int64_t plane, int nseg, int lgseg, int lglen,
                                          int valid) {
  using VT = typename Vec<T>::type;
  const int lgper = lglen - ilog2(CH), lgall = lgseg + lgper;
  const int total = 2 << lgall;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int pl = k >> lgall, r = (k >> lgper) & ((1 << lgseg) - 1);
    const int o = (k & ((1 << lgper) - 1)) * CH;
    if (r >= nseg || o >= valid) continue;
    T* sp = s + pl * dim + r * sstr + o;
    T* gp = g + pl * plane + r * gstr + o;
    if constexpr (LOAD) {
      copy_async<(int)(CH * sizeof(T))>(sp, gp);
    } else if constexpr (CH * sizeof(T) == 16) {
      *reinterpret_cast<VT*>(gp) = *reinterpret_cast<const VT*>(sp);
    } else {
      *gp = *sp;
    }
  }
}

// n values (a multiple of 16 bytes when vec) from g to s by cp.async.
template <class T>
__device__ __forceinline__ void copy_vals(T* s, const T* g, int n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int k = threadIdx.x * V; k < n; k += blockDim.x * V) copy_async<16>(s + k, g + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) copy_async<(int)sizeof(T)>(s + k, g + k);
  }
}

// Above the register budget: each of a column's K/R threads computes R of
// its outputs, reading the column and W's rows through the caches (no
// plan's window is this wide below LARGE_STATE_MIN_N: the edge shapes).
// Work item u: lane u % 32 of column group u / (32 S); slice (u / 32) % S.
template <class T>
__device__ __forceinline__ void forward_wide(const T* __restrict__ x, const T* __restrict__ w,
                                             T* __restrict__ y, const FwdGeom& p) {
  constexpr int R = FWD_WIDE_R;
  const int K = (int)p.K, lgK = ilog2(p.K), lgS = lgK - ilog2(R);
  const int B = (int)p.B, lgB = ilog2(p.B), lgA = ilog2(p.A);
  const int64_t KK = (int64_t)K * K, Q = p.E * p.A * p.B, plane = Q * K;
  for (int64_t u = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; u < p.tiles;
       u += (int64_t)gridDim.x * blockDim.x) {
    const int64_t grp = u >> 5;
    const int s = (int)(grp & ((1 << lgS) - 1));
    const int64_t q = ((grp >> lgS) << 5) | (u & 31);
    if (q >= Q) continue;
    const int64_t ea = q >> lgB;
    const int64_t base = ((ea << lgK) << lgB) + (q & (B - 1));  // x[e, a, 0, b]
    const T* we = w + (ea >> lgA) * p.w_stride + (int64_t)s * R * K;
    T ar[R], ai[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0;
    for (int j = 0; j < K; ++j) {
      const T br = x[base + (int64_t)j * B], bi = x[plane + base + (int64_t)j * B];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T wr = __ldg(we + r * K + j), wi = __ldg(we + KK + r * K + j);
        ar[r] = madd(wr, br, ar[r]);
        ar[r] = madd(-wi, bi, ar[r]);
        ai[r] = madd(wr, bi, ai[r]);
        ai[r] = madd(wi, br, ai[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t o = base + (int64_t)(s * R + r) * B;
      y[o] = ar[r];
      y[plane + o] = ai[r];
    }
  }
}

// y = W_e x on each element.  KC = K (2..fwd_kreg): a thread a column of the
// tile, its K inputs in registers; KC = 0: forward_wide.  TOP: B = 1, the
// column contiguous (window_apply_top's batch entry).
template <class T, int KC, bool TOP>
__global__ void __launch_bounds__(THREADS, 2)
forward_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               const FwdGeom p) {
  if constexpr (KC == 0) {
    forward_wide(x, w, y, p);
  } else {
    constexpr int K = KC, KK = K * K, V = 16 / sizeof(T);
    constexpr int WC = K < V ? K : V;              // W's values a load
    constexpr int OC = TOP ? (K < V ? K : V) : 1;  // outputs a store
    constexpr int IU = K <= 8 ? K / OC : 2;        // output groups unrolled
    extern __shared__ __align__(16) unsigned char batch_smem[];
    T* const sm = reinterpret_cast<T*>(batch_smem);

    // Every extent is a power of two: shifts and masks on 32-bit indices,
    // 64-bit only for a tile's offset in the batch.
    const int t = threadIdx.x;
    const bool one_w = p.w_stride == 0, w_tile = p.wdim != 0;
    const int B = (int)p.B, lgB = ilog2(p.B), lgA = ilog2(p.A);
    const int tc = (int)p.tc, lgtc = ilog2(p.tc);
    const int64_t EA = p.E * p.A, Q = EA * B, plane = Q * K;
    // A tile: tc columns.  flat (tc > B): tc / B whole blocks (e, a) of K*B
    // contiguous values, kept K*B + pad apart (with no pad, one run); else
    // K runs of tc (stride B).
    const bool flat = tc > B, contig = flat && p.pad == 0;
    const int run = flat ? B : tc, lgrun = flat ? lgB : lgtc;
    const int sstr = flat ? K * B + (int)p.pad : tc;
    const int lgblk = flat ? ilog2(K) + lgB : lgtc;  // values a block (a run)
    const int lglen = contig ? lgtc + ilog2(K) : lgblk;
    const int lgseg = contig ? 0 : flat ? lgtc - lgB : ilog2(K);
    const int64_t gstr = flat ? (int64_t)K * B : B;
    const int dim = (int)p.dim, bufsz = 2 * dim + (int)p.wdim;
    T* const sw1 = sm;                           // the one window (one_w)
    T* const buf0 = sm + (one_w ? 2 * KK : 0);   // two tile buffers: Re, Im, windows
    const bool vec_w = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) ==
                         0 && plane % V == 0 &&
                     (contig || ((1 << lglen) % V == 0 && gstr % V == 0 && sstr % V == 0));

    // Tile kt: its first value in a plane, its first block, its blocks (K
    // runs when not flat) and the values of each segment it moves.
    auto tile_at = [&](int64_t kt, int64_t& ea0, int& nseg, int& nmove, int& valid) {
      const int64_t q0 = kt << lgtc;
      ea0 = q0 >> lgB;
      nseg = flat ? (int)min((int64_t)1 << (lgtc - lgB), EA - ea0) : K;
      nmove = contig ? 1 : nseg;
      valid = contig ? nseg << lgblk : 1 << lglen;
      return ea0 * K * B + (q0 & (B - 1));
    };
    auto move = [&](auto load, T* buf, T* g, int nmove, int valid) {
      if (vec && valid % V == 0)
        move_tile<decltype(load)::value, V>(buf, sstr, dim, g, gstr, plane, nmove, lgseg, lglen,
                                            valid);
      else
        move_tile<decltype(load)::value, 1>(buf, sstr, dim, g, gstr, plane, nmove, lgseg, lglen,
                                            valid);
    };
    auto issue = [&](int64_t kt, T* buf) {
      int64_t ea0;
      int nseg, nmove, valid;
      const int64_t g0 = tile_at(kt, ea0, nseg, nmove, valid);
      move(std::true_type{}, buf, const_cast<T*>(x) + g0, nmove, valid);
      if (w_tile) {  // the windows of the tile's elements
        const int64_t e0 = ea0 >> lgA, e1 = (ea0 + (flat ? nseg : 1) - 1) >> lgA;
        copy_vals(buf + 2 * dim, w + e0 * 2 * KK, (int)(e1 - e0 + 1) * 2 * KK, vec_w);
      }
    };

    const int64_t G = gridDim.x;
    int64_t kt = blockIdx.x;
    if (one_w) copy_vals(sw1, w, 2 * KK, vec_w);
    if (kt < p.tiles) issue(kt, buf0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int it = 0; kt < p.tiles; ++it, kt += G) {
      T* const cur = buf0 + (it & 1) * bufsz;
      if (kt + G < p.tiles) issue(kt + G, buf0 + ((it + 1) & 1) * bufsz);  // in flight meanwhile
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();

      int64_t ea0;
      int nseg, nmove, valid;
      const int64_t g0 = tile_at(kt, ea0, nseg, nmove, valid);
      const int ncols = (int)min((int64_t)tc, Q - (kt << lgtc));
      if (t < ncols) {
        // Column t: value j at off + j * run; its outputs overwrite it there.
        T* const sr = cur + (t >> lgrun) * sstr + (t & (run - 1));
        T* const si = sr + dim;
        const int64_t ea = ea0 + (t >> lgrun);  // the column's block (e, a)
        const T* we = sw1;
        if (w_tile)
          we = cur + 2 * dim + (int)((ea >> lgA) - (ea0 >> lgA)) * 2 * KK;
        else if (!one_w)
          we = w + (ea >> lgA) * p.w_stride;  // read in place, through L1
        T xr[K], xi[K];
        if constexpr (TOP) {
          ld_vals(sr, xr);
          ld_vals(si, xi);
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j) xr[j] = sr[j * run], xi[j] = si[j * run];
        }
        // Each output's K terms in order j = 0..K-1: a call repeats bit for bit.
#pragma unroll IU
        for (int i0 = 0; i0 < K; i0 += OC) {
          T yr[OC], yi[OC];
#pragma unroll
          for (int o = 0; o < OC; ++o) {
            const T* wrow = we + (i0 + o) * K;
            T ar = 0, ai = 0;
#pragma unroll
            for (int j0 = 0; j0 < K; j0 += WC) {
              T wr[WC], wi[WC];
              if (one_w || w_tile) {
                ld_vals(wrow + j0, wr);
                ld_vals(wrow + KK + j0, wi);
              } else {
#pragma unroll
                for (int v = 0; v < WC; ++v)
                  wr[v] = __ldg(wrow + j0 + v), wi[v] = __ldg(wrow + KK + j0 + v);
              }
#pragma unroll
              for (int v = 0; v < WC; ++v) {
                ar = madd(wr[v], xr[j0 + v], ar);
                ar = madd(-wi[v], xi[j0 + v], ar);
                ai = madd(wr[v], xi[j0 + v], ai);
                ai = madd(wi[v], xr[j0 + v], ai);
              }
            }
            yr[o] = ar, yi[o] = ai;
          }
          if constexpr (TOP) {
            st_vals(sr + i0, yr);
            st_vals(si + i0, yi);
          } else {
            sr[i0 * run] = yr[0], si[i0 * run] = yi[0];
          }
        }
      }
      __syncthreads();
      move(std::false_type{}, cur, y + g0, nmove, valid);
      __syncthreads();  // the buffer is free for the tile after next
    }
  }
}

// CTAs of `fn` an SM at (threads, smem) on the current device, asked of the
// runtime once, after allowing `fn` all the shared memory the card offers
// (a smaller limit set for one geometry would refuse a larger one's launch).
// cudaFuncSetAttribute acts on the current device only, so the entries are
// keyed by device: a card first seen sets its own limit.  The sharded route
// runs one process a card (one NCCL rank), whose current card never changes.
inline int fwd_residency(const void* fn, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    int device, threads;
    size_t smem;
    int ctas;
  };
  static std::mutex lock;
  static Entry seen[256];
  static int count = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < count; ++i)
    if (seen[i].fn == fn && seen[i].device == device && seen[i].threads == threads &&
        seen[i].smem == smem)
      return seen[i].ctas;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      (size_t)optin < smem ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess)
    return -1;
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, smem) != cudaSuccess ||
      ctas < 1)
    return -1;
  if (count < 256) seen[count++] = Entry{fn, device, threads, smem, ctas};
  return ctas;
}

template <class T, int KC, bool TOP>
int forward_launch(const FwdGeom& p, const T* x, const T* w, T* y, cudaStream_t stream) {
  const auto fn = forward_kernel<T, KC, TOP>;
  const int ctas = fwd_residency((const void*)fn, (int)p.threads, (size_t)p.smem);
  if (ctas < 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = std::min(p.grid, (int64_t)ctas * p.sms);
  fn<<<(unsigned)grid, (unsigned)p.threads, (size_t)p.smem, stream>>>(x, w, y, p);
  return (int)cudaGetLastError();
}

template <class T, bool TOP>
int forward_t(const FwdGeom& p, const T* x, const T* w, T* y, cudaStream_t stream) {
  const bool wide = p.K > fwd_kreg<T>();
  if (p.rows != (wide ? FWD_WIDE_R : p.K) || (wide && p.tc != 0) || (TOP != (p.B == 1)))
    return (int)cudaErrorInvalidValue;  // a geometry for another path
  switch (p.K) {
    case 2: return forward_launch<T, 2, TOP>(p, x, w, y, stream);
    case 4: return forward_launch<T, 4, TOP>(p, x, w, y, stream);
    case 8: return forward_launch<T, 8, TOP>(p, x, w, y, stream);
    case 16: return forward_launch<T, 16, TOP>(p, x, w, y, stream);
    case 32:
      if constexpr (fwd_kreg<T>() >= 32) return forward_launch<T, 32, TOP>(p, x, w, y, stream);
  }
  return forward_launch<T, 0, TOP>(p, x, w, y, stream);
}

// geom: FwdGeom's fields; x, y: (2, E*A*K*B); w: one (2, K, K) window
// (w_stride 0) or E of them; every array float32, or float64 when f64.
template <bool TOP>
inline int forward(const long long* geom, const void* x, const void* w, void* y,
                   cudaStream_t stream) {
  const FwdGeom p = *reinterpret_cast<const FwdGeom*>(geom);
  if (p.f64)
    return forward_t<double, TOP>(p, (const double*)x, (const double*)w, (double*)y, stream);
  return forward_t<float, TOP>(p, (const float*)x, (const float*)w, (float*)y, stream);
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
