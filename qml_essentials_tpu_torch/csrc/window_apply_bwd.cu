// window_apply_bwd: backward of one fused gate window (window_apply.cu).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_apply_bwd (the launcher
// of _bwd_kernel).  For y = W x on the (2, A, K, B) view, given the output
// cotangent g and the saved input x, it computes
//
//     gp = W^dagger g                      gp[a, j, b] = sum_i conj(W[i, j]) g[a, i, b]
//     gw = sum over the A*B columns of g conj(x)^T     gw[i, j] = sum_c g[i, c] conj(x[j, c])
//
// g is float32 or bfloat16 (the saved-residual backward carries the
// cotangent in bfloat16 between steps), gp is written as float32 or
// bfloat16, gw is always float32.
//
// What bounds it on an H100: arithmetic, as the forward.  Both products are
// K complex multiply-adds per amplitude (8K flops each, 16K in all: twice the
// forward); on the float32 CUDA cores (67 TFLOP/s) that is the ceiling
// whatever the tile, so both run on the tensor cores in split TF32
// (adjoint_tc.cuh, the tile of adjoint_step.cu, whose pullback and gram these
// are): float32-grade, whatever the caller's TF32 setting, staged through a
// cp.async ring.
//
// * the pullback is the forward's product with A = W^dagger: W is read along
//   its row index (A_M_CONTIG) with the Im part negated, g is the right
//   operand, float32 (three passes) or bfloat16 (exact in TF32: two);
// * the matrix cotangent is a (K x C) * (C x K) product with C = A*B = 2^n/K
//   columns (2^14..2^16 at 24 qubits), so a K x K output has too few 64 x 64
//   tiles to fill 132 SMs.  The TPU kernel kept one (2, K, K) accumulator in
//   VMEM across a sequential grid; CUDA blocks cannot share one, so the
//   reduction over C is split: each of `splits` blocks per output tile sums
//   its chunk of columns into its own (2, K, K) partial in a workspace the
//   caller allocates, and a second pass adds the partials in a fixed order
//   (deterministic: no atomics).  Within a block each 32-deep stage's sum
//   joins the running sum in a float32 add (the tensor cores truncate).
//
// Unlike the TPU kernel, which reads (g, x) once for both outputs, this is
// three launches (pullback, split gram, reduction): g is read twice and x
// once, plus the workspace (at most 64 MB, chosen by the caller) written and
// read once.  One fused pass is later work.
#include "adjoint_tc.cuh"
#include "window_batch.cuh"

namespace {

template <class TG, class TP>
int run(const float* w, const TG* g, const float* x, TP* gp, float* gw, float* ws,
        int64_t A, int64_t K, int64_t B, int64_t splits, cudaStream_t stream) {
  const qml::WindowCols cols = qml::window_cols(K, B);
  const int64_t C = A * B;
  return qml::launch_fused_bwd_tc(w, g, x, gp, gw, ws, A * K * B, K, K, C, C, splits,
                                  qml::tc_vec_shape(K, B), qml::WindowPullbackMap{cols},
                                  qml::WindowGramMap{cols}, stream);
}

}  // namespace

// w: (2, K, K) float32; g: (2, A*K*B) float32 (g_bf16 = 0) or bfloat16;
// x: (2, A*K*B) float32; gp: (2, A*K*B) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply_bwd(const float* w, const void* g, const float* x,
                                    void* gp, float* gw, float* ws,
                                    long long A, long long K, long long B,
                                    long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return run(w, gt, x, pt, gw, ws, A, K, B, splits, (cudaStream_t)stream);
  });
}

// The batch entry (window_batch.cuh): one launch a call.  w: one (2, K, K)
// window (w_stride = 0; gw (2, K, K), the grams summed over the batch) or E
// of them (w_stride = 2*K*K; gw (E, 2, K, K), one gram an element); g, x,
// gp: (2, E*A*K*B); geom: the launch's geometry (qml::batch::BwdGeom, from
// cuda_kernels.batch_bwd_geometry); ws: its partial grams; cnt: its
// counters (zero, and left zero); every array float32, or float64 when
// geom's f64.
extern "C" int qml_window_apply_bwd_batch(const long long* geom, const void* w, const void* g,
                                          const void* x, void* gp, void* gw, void* ws,
                                          void* cnt, void* stream) {
  return qml::batch::backward(geom, w, g, x, gp, gw, ws, cnt, (cudaStream_t)stream);
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel through the same ctypes path: the launch floor that
// chip_smoke.py prints beside the batch entries' times (no wrapper calls it).
extern "C" int qml_batch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
