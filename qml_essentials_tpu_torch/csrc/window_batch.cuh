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
// HBM; the products run on the float32 CUDA cores, one output amplitude a
// thread, W_e's row read through the read-only cache (it is shared by the
// K*B threads of its element).  The gram is a fixed-order reduction: each
// (element, split, i, j) thread sums its column chunk in order, then one
// thread per output sums the splits (and, for a shared W, the elements)
// in order — no atomics, so a gradient repeats bit for bit.
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

// Partial grams: ws[(e*S + s)][2][K][K] over columns [s*chunk, (s+1)*chunk).
template <class T>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    T* __restrict__ ws, int64_t plane, int64_t E, int64_t A, int64_t K,
                    int64_t B, int64_t S, int64_t chunk) {
  const int64_t KK = K * K, C = A * B, D = A * K * B;
  const int64_t total = E * S * KK;
  for (int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t ij = t % KK, es = t / KK;
    const int64_t i = ij / K, j = ij % K;
    const int64_t e = es / S, s = es % S;
    const int64_t c0 = s * chunk, c1 = c0 + chunk < C ? c0 + chunk : C;
    const T* ge = g + e * D + i * B;
    const T* xe = x + e * D + j * B;
    T sr = 0, si = 0;
    for (int64_t c = c0; c < c1; ++c) {
      const int64_t off = (c / B) * K * B + (c % B);
      const T gr = ge[off], gi = ge[off + plane];
      const T xr = xe[off], xi = xe[off + plane];
      sr = madd(gr, xr, sr);
      sr = madd(gi, xi, sr);
      si = madd(gi, xr, si);
      si = madd(-gr, xi, si);
    }
    T* out = ws + es * 2 * KK;
    out[ij] = sr;
    out[KK + ij] = si;
  }
}

// gw[o][2][K][K] = sum over (the elements of o, then) the splits, in order:
// per element (O = E, R = 1) or summed over the batch (O = 1, R = E).
template <class T>
__global__ void __launch_bounds__(THREADS)
gram_reduce_kernel(const T* __restrict__ ws, T* __restrict__ gw, int64_t O, int64_t R,
                   int64_t S, int64_t K) {
  const int64_t KK2 = 2 * K * K;
  const int64_t total = O * KK2;
  for (int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t o = t / KK2, q = t % KK2;
    const T* src = ws + o * R * S * KK2 + q;
    T acc = 0;
    for (int64_t r = 0; r < R * S; ++r) acc += src[r * KK2];
    gw[t] = acc;
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

// Column splits of the gram: enough (element, split, i, j) threads to fill
// the card, each chunk at least 16 columns.
inline int64_t gram_splits(int64_t E, int64_t K, int64_t C) {
  int64_t S = 1;
  while (E * S * K * K < (1 << 17) && C / (S * 2) >= 16) S *= 2;
  return S;
}

template <class T>
int backward_t(const T* w, const T* g, const T* x, T* gp, T* gw, T* ws, int64_t E, int64_t A,
               int64_t K, int64_t B, int64_t w_stride, int per_element, cudaStream_t stream) {
  const int64_t D = A * K * B, plane = E * D, C = A * B;
  window_kernel<true, T><<<blocks_for(plane), THREADS, 0, stream>>>(g, w, gp, plane, D, K, B,
                                                                     w_stride);
  const int64_t S = gram_splits(E, K, C);
  const int64_t chunk = (C + S - 1) / S;
  gram_partial_kernel<T><<<blocks_for(E * S * K * K), THREADS, 0, stream>>>(
      g, x, ws, plane, E, A, K, B, S, chunk);
  const int64_t O = per_element ? E : 1, R = per_element ? 1 : E;
  gram_reduce_kernel<T><<<blocks_for(O * 2 * K * K), THREADS, 0, stream>>>(ws, gw, O, R, S, K);
  return (int)cudaGetLastError();
}

// ws: E * S * 2*K*K elements (S = gram_splits(E, K, A*B)); gw: (E, 2, K, K)
// when per_element, else (2, K, K); every array float32, or float64 when f64.
inline int backward(const void* w, const void* g, const void* x, void* gp, void* gw, void* ws,
                    int64_t E, int64_t A, int64_t K, int64_t B, int64_t w_stride,
                    int per_element, int f64, cudaStream_t stream) {
  if (f64)
    return backward_t((const double*)w, (const double*)g, (const double*)x, (double*)gp,
                      (double*)gw, (double*)ws, E, A, K, B, w_stride, per_element, stream);
  return backward_t((const float*)w, (const float*)g, (const float*)x, (float*)gp, (float*)gw,
                    (float*)ws, E, A, K, B, w_stride, per_element, stream);
}

}  // namespace
}  // namespace batch
}  // namespace qml
