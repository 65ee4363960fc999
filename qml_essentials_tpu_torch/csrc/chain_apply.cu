// chain_apply: one chain step (a list of windows and diagonals) in one launch.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:chain_apply_ri (the
// launcher of _make_chain_fwd_kernel), the TPU kernel that applies a whole
// group of ops/chains.py descriptors to a block of the state kept in VMEM:
//
//     ("win", lo, hi)   y = W x on state bits [lo, hi)  (wires [n-hi, n-lo))
//     ("diag", bits)    y[f] = d[v(f)] x[f], v = the pattern bits of f, MSB first
//
// applied in order.  Blocks (chain_block.cuh) never exchange data, so the
// launch has no grid-wide barrier: a cluster of CTAs takes one block, shares
// each descriptor's output tiles, and waits at a cluster barrier before the
// next descriptor.  One cluster per block: at 24 qubits 128 L blocks or 256
// H blocks of 2^16 amplitudes, 8 CTAs each.
//
// What bounds it on an H100: arithmetic.  A window costs 8K flops per
// amplitude (K = 128..512 on the main path's chain plans) for 16 bytes of
// state in and out; in split TF32 it issues three passes of that on the
// tensor cores, 24K flops an amplitude against ~150 flop/byte of TF32
// balance, so the descriptors still ping-pong through the output and a
// state-sized workspace (an L block is 1 MiB, more than a CTA's shared
// memory) and keeping the block on chip would save little.  The windows run
// chain_block.cuh's wgmma product on W's split planes, written once a launch
// by split_windows; windows under the wgmma shape rule (K < 8 or a state run
// under 32) its mma.sync product with scalar staging.  A diagonal is one
// elementwise pass over the block.  About 205 KB of shared memory a CTA: one
// CTA an SM.
#include "chain_block.cuh"

namespace {

using namespace qml::chain;

// TC: the step has a window under the wgmma rule (any_tc), whose product
// runs tc_product, a call; the other steps' kernel makes no call, so ptxas
// keeps its wgmma pipelined (a call between them serializes every wgmma).
template <bool TC>
__global__ void __launch_bounds__(NT, 1)
chain_apply_kernel(const float* x, float* y, float* ws, const float* pay, const float* vs,
                   const long long* desc, int nd, int64_t plane, Blocks blk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int64_t first = blockIdx.x / ranks, step = gridDim.x / ranks;
  for (int64_t g = first; g < blk.count; g += step) {
    for (int s = 0; s < nd; ++s) {
      const long long* e = desc + s * DESC;
      const float* src = s == 0 ? x : out_of(s - 1, nd, y, ws);
      float* dst = out_of(s, nd, y, ws);
      const float* w = pay + e[POFF];
      if (e[KIND] == DIAG) {
        const int64_t V = int64_t(1) << e[NBITS];
        for (int64_t l = (int64_t)rank * NT + threadIdx.x; l < blk.size;
             l += (int64_t)ranks * NT) {
          const int64_t f = blk.flat(g, l);
          const int v = diag_index(e, f);
          const float dr = w[v], di = w[V + v];
          const float xr = __ldcg(src + f), xi = __ldcg(src + f + plane);
          dst[f] = dr * xr - di * xi;
          dst[f + plane] = dr * xi + di * xr;
        }
      } else {
        const int64_t K = int64_t(1) << e[WIDTH], C = blk.size / K;
        const Win win{blk, g, K, (int)e[LLO]};
        const bool minor = e[KIND] == MINOR;
        if (!TC || qml::forward_wgmma_shape(K, e[RUN])) {
          if (minor)
            wgmma_product<true>(src, dst, vs + e[SOFF], plane, win, C, 0, rank, ranks, smem);
          else
            wgmma_product<false>(src, dst, vs + e[SOFF], plane, win, C, 0, rank, ranks, smem);
        } else if constexpr (TC) {
          if (minor)
            tc_product<MinorApply, false>(src, plane, w, K * K, dst, plane, C, K, K,
                                          MinorApply{win}, false, 0, rank, ranks, smem);
          else
            tc_product<RowsApply, false>(w, K * K, src, plane, dst, plane, K, C, K,
                                         RowsApply{win}, false, 0, rank, ranks, smem);
        }
      }
      descriptor_done(cluster);
    }
  }
}

}  // namespace

// x, y: (2, plane) float32 states; ws: a second (2, plane) buffer (unused
// with one descriptor); pay: the packed payloads; vs: the split workspace
// (the table's SOFF; max_kk the largest window's K^2, 0 without a window);
// desc: nd descriptors in device memory and desc_host the same table on the
// host (chain_block.cuh).  The blocks: count, size, stride, hi_stride,
// split; `ranks` CTAs a cluster, one cluster a block.  Launches on `stream`;
// returns the first CUDA error, or 0.
extern "C" int qml_chain_apply(const float* x, float* y, float* ws, const float* pay, float* vs,
                               const long long* desc, const long long* desc_host, long long nd,
                               long long plane,
                               long long count, long long size, long long stride,
                               long long hi_stride, long long split, long long ranks,
                               long long max_kk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int code = qml::chain::launch_split(pay, desc, nd, vs, max_kk, false, st);
  if (code != 0) return code;
  const qml::chain::Blocks blk{count, size, stride, hi_stride, split};
  auto kernel = qml::chain::any_tc(desc_host, nd) ? chain_apply_kernel<true>
                                                  : chain_apply_kernel<false>;
  return qml::chain::launch_clusters(kernel, count, (int)ranks, st, x, y, ws, pay,
                                     (const float*)vs, desc, (int)nd, (int64_t)plane, blk);
}

// Clusters of `ranks` CTAs of chain_apply's kernel the card holds at once,
// or minus a CUDA error.
extern "C" int qml_chain_apply_clusters(long long ranks) {
  return qml::chain::active_clusters(chain_apply_kernel<false>, (int)ranks);
}
