// adjoint_chain: the adjoint-state backward of one chain step in one launch,
// plus a fixed-order reduction.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:adjoint_chain_ri (the
// launcher of _make_chain_adj_kernel).  From the step's output state psi and
// its cotangent lam it walks the step's descriptors in reverse on every block
// (chain_block.cuh), taking each descriptor's gram on the pair it receives
// and then undoing the descriptor on both:
//
//     window    G0 += sum over the window's columns of lam conj(psi)^T,
//               psi <- W^dagger psi, lam <- W^dagger lam;
//     diagonal  G0[v] += sum_{v(f) = v} lam[f] conj(psi[f]),
//               psi <- conj(d) psi, lam <- conj(d) lam,
//
// and returns the step's input state, its cotangent and one cotangent per
// descriptor: gw = G0 W for a window, gd = d G0 for a diagonal (the gram on
// the output side, as the TPU kernel takes it; G0 W = sum lam x^dagger).
//
// The TPU kernel carries G0 in VMEM across its sequential grid.  Here blocks
// run in parallel, so a fixed number of clusters each walk a fixed set of
// blocks (cluster c: blocks c, c + clusters, ...) and add every block's gram
// into the cluster's own slot, a window's K x K tiles each owned by one CTA
// and a diagonal's partial sums by CTA rank; a second pass sums the slots in
// cluster order.  No atomics, so gradients repeat bit for bit; the wrapper
// takes as many clusters as the card holds at once, within 64 MB of slots
// (a count that divided the blocks would leave half the card idle: some
// clusters walk one block more).  Then
// gw = G0 W on cgemm_tile.cuh (SquareMap) and gd = d G0 in a one-warp
// kernel.
//
// What bounds it on an H100: arithmetic, three products of K complex
// multiply-adds per amplitude and window against 32 bytes of state in and
// out; in split TF32 with a float32 lam nine passes of 8K flops an
// amplitude on the tensor cores.  The gram runs chain_block.cuh's wgmma
// gram (lam the register operand, psi split into planes by the CTA), both
// pullbacks its wgmma product on conj(W)^T's split planes (split_windows,
// once a launch), so a pullback is a forward product; the pullbacks' tiles
// start at the rank after the gram's last, so the cluster's CTAs share the
// three products' work.  Windows under the wgmma rule take the mma.sync
// products (the gram with 16-byte copies where tc_vec_shape allows).  psi
// and lam ping-pong through the outputs and two state-sized workspaces as in
// chain_apply.cu.
#include "chain_block.cuh"

namespace {

using namespace qml::chain;

// The wgmma gram and product as functions of their own, though a call makes
// ptxas serialize their wgmma (C7510): inlined, they need over 255
// registers and spill, in a kernel of both window views (51.6 ms a 24q
// chain gradient, against 43.5 called) and of one (H steps 15.9 ms,
// against 12.5).  Called, they leave the kernel room for tc_product too.
template <bool MINOR_VIEW>
__device__ __noinline__ void gram_call(const float* lam, const float* psi, float* gram,
                                       int64_t plane, const Win& win, int64_t C, bool add,
                                       int rank, int ranks, unsigned char* smem) {
  wgmma_gram<MINOR_VIEW>(lam, psi, gram, plane, win, C, add, rank, ranks, smem);
}
template <bool MINOR_VIEW>
__device__ __noinline__ void product_call(const float* x, float* y, const float* vs,
                                          int64_t plane, const Win& win, int64_t C, int first,
                                          int rank, int ranks, unsigned char* smem) {
  wgmma_product<MINOR_VIEW>(x, y, vs, plane, win, C, first, rank, ranks, smem);
}

// The window step of block g: the gram into the slot, then both pullbacks.
template <bool MINOR_VIEW>
__device__ __forceinline__ void window_step(const float* psrc, const float* lsrc, float* pdst,
                                            float* ldst, const float* w, const float* vs,
                                            float* gram, int64_t plane, const Win& win,
                                            int64_t run, bool add, int rank, int ranks,
                                            unsigned char* smem) {
  using Gram = std::conditional_t<MINOR_VIEW, MinorGram, RowsGram>;
  using Pull = std::conditional_t<MINOR_VIEW, MinorPull, RowsPull>;
  const int64_t K = win.K, C = win.b.size / K;
  if (qml::forward_wgmma_shape(K, run)) {
    gram_call<MINOR_VIEW>(lsrc, psrc, gram, plane, win, C, add, rank, ranks, smem);
    const int first = (int)(gram_tiles(K) % ranks);
    const int next = (int)((first + wgmma_tiles(K, C)) % ranks);
    product_call<MINOR_VIEW>(psrc, pdst, vs, plane, win, C, first, rank, ranks, smem);
    product_call<MINOR_VIEW>(lsrc, ldst, vs, plane, win, C, next, rank, ranks, smem);
  } else {
    const Gram gmap{win};
    if (qml::tc_vec_shape(K, run))
      tc_product<Gram, true>(lsrc, plane, psrc, plane, gram, K * K, K, K, C, gmap, add, 0, rank,
                             ranks, smem);
    else
      tc_product<Gram, false>(lsrc, plane, psrc, plane, gram, K * K, K, K, C, gmap, add, 0,
                              rank, ranks, smem);
    const Pull pull{win};
    const int64_t M = MINOR_VIEW ? C : K, N = MINOR_VIEW ? K : C;
    const int first = (int)(tc_tiles(K, K) % ranks);
    const int next = (int)((first + tc_tiles(M, N)) % ranks);
    if constexpr (MINOR_VIEW) {
      tc_product<Pull, false>(psrc, plane, w, K * K, pdst, plane, M, N, K, pull, false, first,
                              rank, ranks, smem);
      tc_product<Pull, false>(lsrc, plane, w, K * K, ldst, plane, M, N, K, pull, false, next,
                              rank, ranks, smem);
    } else {
      tc_product<Pull, false>(w, K * K, psrc, plane, pdst, plane, M, N, K, pull, false, first,
                              rank, ranks, smem);
      tc_product<Pull, false>(w, K * K, lsrc, plane, ldst, plane, M, N, K, pull, false, next,
                              rank, ranks, smem);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
adjoint_chain_kernel(const float* psi, const float* lam, float* psi_out, float* lam_out,
                     float* ws_psi, float* ws_lam, const float* pay, const float* vs,
                     const long long* desc, int nd, int64_t plane, Blocks blk, float* slots,
                     int64_t slot_size) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __shared__ float warp_sums[NT / 32][8];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int64_t first = blockIdx.x / ranks, step = gridDim.x / ranks;
  float* slot = slots + first * slot_size;
  for (int64_t g = first; g < blk.count; g += step) {
    const bool add = g != first;
    for (int s = 0; s < nd; ++s) {
      const long long* e = desc + (nd - 1 - s) * DESC;
      const float* psrc = s == 0 ? psi : out_of(s - 1, nd, psi_out, ws_psi);
      const float* lsrc = s == 0 ? lam : out_of(s - 1, nd, lam_out, ws_lam);
      float* pdst = out_of(s, nd, psi_out, ws_psi);
      float* ldst = out_of(s, nd, lam_out, ws_lam);
      const float* w = pay + e[POFF];
      float* gram = slot + e[GOFF];
      if (e[KIND] == DIAG) {
        const int V = 1 << e[NBITS];
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // Re[0..3], Im[0..3]
        for (int64_t l = (int64_t)rank * NT + threadIdx.x; l < blk.size;
             l += (int64_t)ranks * NT) {
          const int64_t f = blk.flat(g, l);
          const int v = diag_index(e, f);
          const float dr = w[v], di = w[V + v];
          const float pr = __ldcg(psrc + f), pi = __ldcg(psrc + f + plane);
          const float lr = __ldcg(lsrc + f), li = __ldcg(lsrc + f + plane);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q == v) {
              acc[q] += lr * pr + li * pi;
              acc[4 + q] += li * pr - lr * pi;
            }
          pdst[f] = dr * pr + di * pi;
          pdst[f + plane] = dr * pi - di * pr;
          ldst[f] = dr * lr + di * li;
          ldst[f + plane] = dr * li - di * lr;
        }
        // The CTA's partial sums, in a fixed order: within each warp by
        // shuffles, then over the warps in order; added to this rank's part
        // of the slot.
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float x = acc[q];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
          if (lane == 0) warp_sums[warp][q] = x;
        }
        __syncthreads();
        if (threadIdx.x < 2 * V) {
          const int q = threadIdx.x < V ? threadIdx.x : 4 + threadIdx.x - V;
          float x = 0.f;
          for (int k = 0; k < NT / 32; ++k) x += warp_sums[k][q];
          float* dst = gram + rank * 2 * V + threadIdx.x;
          *dst = add ? *dst + x : x;
        }
        __syncthreads();
      } else {
        const Win win{blk, g, int64_t(1) << e[WIDTH], (int)e[LLO]};
        if (e[KIND] == MINOR)
          window_step<true>(psrc, lsrc, pdst, ldst, w, vs + e[SOFF], gram, plane, win, e[RUN],
                            add, rank, ranks, smem);
        else
          window_step<false>(psrc, lsrc, pdst, ldst, w, vs + e[SOFF], gram, plane, win, e[RUN],
                             add, rank, ranks, smem);
      }
      descriptor_done(cluster);
    }
  }
}

// gd = d G0 for one diagonal of V entries, G0 the sum of `ranks` partials
// (Re[V], Im[V] each) in rank order.
__global__ void diag_cotangent(const float* parts, int ranks, int V, const float* d, float* gd) {
  const int v = threadIdx.x;
  if (v >= V) return;
  float gr = 0.f, gi = 0.f;
  for (int r = 0; r < ranks; ++r) {
    gr += parts[r * 2 * V + v];
    gi += parts[r * 2 * V + V + v];
  }
  gd[v] = d[v] * gr - d[V + v] * gi;
  gd[V + v] = d[v] * gi + d[V + v] * gr;
}

}  // namespace

// psi, lam (float32): the step's output and its cotangent, (2, plane) each;
// psi_out, lam_out: the step's input and its cotangent; ws_psi, ws_lam: two
// more (2, plane) buffers (unused with one descriptor); pay: the packed
// payloads, grads: the same layout for their cotangents; vs: the split
// workspace (the table's SOFF; max_kk the largest window's K^2, 0 without a
// window); desc: nd descriptors in device memory and desc_host the same
// table on the host (chain_block.cuh).  The blocks: count, size, stride,
// hi_stride, split; `clusters` clusters of `ranks` CTAs; slots: clusters *
// slot_size floats, red: slot_size floats (the summed slots).  Launches on
// `stream`; returns the first CUDA error, or 0.
extern "C" int qml_adjoint_chain(const float* psi, const float* lam, float* psi_out,
                                 float* lam_out, float* ws_psi, float* ws_lam, const float* pay,
                                 float* vs, float* grads, const long long* desc,
                                 const long long* desc_host, long long nd, long long plane,
                                 long long count, long long size, long long stride,
                                 long long hi_stride, long long split, long long ranks,
                                 long long clusters, float* slots, float* red,
                                 long long slot_size, long long max_kk, void* stream) {
  using qml::chain::DESC;
  const cudaStream_t st = (cudaStream_t)stream;
  int code = qml::chain::launch_split(pay, desc, nd, vs, max_kk, true, st);
  if (code != 0) return code;
  const qml::chain::Blocks blk{count, size, stride, hi_stride, split};
  code = qml::chain::launch_clusters(adjoint_chain_kernel, clusters, (int)ranks, st, psi, lam,
                                     psi_out, lam_out, ws_psi, ws_lam, pay, (const float*)vs,
                                     desc, (int)nd, (int64_t)plane, blk, slots,
                                     (int64_t)slot_size);
  if (code != 0) return code;
  code = qml::launch_reduce(slots, red, slot_size, clusters, st);
  if (code != 0) return code;
  for (long long j = 0; j < nd; ++j) {
    const long long* e = desc_host + j * DESC;
    const float* g0 = red + e[qml::chain::GOFF];
    const float* w = pay + e[qml::chain::POFF];
    float* gout = grads + e[qml::chain::POFF];
    if (e[qml::chain::KIND] == qml::chain::DIAG) {
      diag_cotangent<<<1, 32, 0, st>>>(g0, (int)ranks, 1 << e[qml::chain::NBITS], w, gout);
      code = (int)cudaGetLastError();
    } else {
      const int64_t K = int64_t(1) << e[qml::chain::WIDTH];
      code = qml::launch_cgemm(g0, K * K, w, K * K, gout, K * K, 0, K, K, K, 1,
                               qml::SquareMap{K}, st);
    }
    if (code != 0) return code;
  }
  return 0;
}

// Clusters of `ranks` CTAs of adjoint_chain's kernel the card holds at once,
// or minus a CUDA error.
extern "C" int qml_adjoint_chain_clusters(long long ranks) {
  return qml::chain::active_clusters(adjoint_chain_kernel, (int)ranks);
}
