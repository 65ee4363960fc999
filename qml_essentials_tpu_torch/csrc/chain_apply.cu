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
// state in and out, far above the ~20 flop/byte balance of fp32 CUDA-core
// work, so keeping the block on chip between descriptors would save little:
// the descriptors ping-pong through the output and a state-sized workspace
// (an L block is 1 MiB, more than a CTA's shared memory; the ~33 clusters
// resident at two CTAs an SM hold ~33 MiB of source and ~33 MiB of
// destination blocks, so the ping-pong lives partly in the 50 MB L2), and the
// products run on cgemm_tile.cuh's fp32-FMA tiles.  A diagonal is one
// elementwise pass over the block.  Tensor cores, and blocks resident in a
// cluster's distributed shared memory, are later work.
#include "chain_block.cuh"

namespace {

using namespace qml::chain;
using qml::coherent_f32;

__global__ void __launch_bounds__(qml::NT, MIN_BLOCKS)
chain_apply_kernel(const float* x, float* y, float* ws, const float* pay, const long long* desc,
                   int nd, int64_t plane, Blocks blk) {
  __shared__ __align__(16) Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int64_t first = blockIdx.x / ranks, step = gridDim.x / ranks;
  for (int64_t g = first; g < blk.count; g += step) {
    for (int s = 0; s < nd; ++s) {
      const long long* e = desc + s * DESC;
      const coherent_f32* src =
          reinterpret_cast<const coherent_f32*>(s == 0 ? x : out_of(s - 1, nd, y, ws));
      float* dst = out_of(s, nd, y, ws);
      const float* w = pay + e[POFF];
      if (e[KIND] == DIAG) {
        const int64_t V = int64_t(1) << e[NBITS];
        for (int64_t l = (int64_t)rank * qml::NT + threadIdx.x; l < blk.size;
             l += (int64_t)ranks * qml::NT) {
          const int64_t f = blk.flat(g, l);
          const int v = diag_index(e, f);
          const float dr = w[v], di = w[V + v];
          const float xr = qml::load_f32(src, f), xi = qml::load_f32(src, f + plane);
          dst[f] = dr * xr - di * xi;
          dst[f + plane] = dr * xi + di * xr;
        }
      } else {
        const int64_t K = int64_t(1) << e[WIDTH];
        const Win win{blk, g, K, (int)e[LLO]};
        if (e[KIND] == ROWS)
          product(w, K * K, src, plane, dst, plane, K, blk.size / K, K, RowsApply{win}, false,
                  rank, ranks, sm);
        else
          product(src, plane, w, K * K, dst, plane, blk.size / K, K, K, MinorApply{win}, false,
                  rank, ranks, sm);
      }
      descriptor_done(cluster);
    }
  }
}

}  // namespace

// x, y: (2, plane) float32 states; ws: a second (2, plane) buffer (unused
// with one descriptor); pay: the packed payloads; desc: nd descriptors in
// device memory (chain_block.cuh).  The blocks: count, size, stride,
// hi_stride, split; `ranks` CTAs a cluster, one cluster a block.  Launches on
// `stream`; returns the first CUDA error, or 0.
extern "C" int qml_chain_apply(const float* x, float* y, float* ws, const float* pay,
                               const long long* desc, long long nd, long long plane,
                               long long count, long long size, long long stride,
                               long long hi_stride, long long split, long long ranks,
                               void* stream) {
  const qml::chain::Blocks blk{count, size, stride, hi_stride, split};
  return qml::chain::launch_clusters(chain_apply_kernel, count, (int)ranks,
                                     (cudaStream_t)stream, x, y, ws, pay, desc, (int)nd,
                                     (int64_t)plane, blk);
}
