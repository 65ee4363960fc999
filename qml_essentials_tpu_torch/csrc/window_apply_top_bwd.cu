// window_apply_top_bwd: backward of a window on the top of the register
// (window_apply_top.cu).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_apply_top_bwd (the
// launcher of _top_bwd_kernel).  For Y = X W^T on the row-major (A, K) view
// (A = 2^(n-k) rows), given the output cotangent g and the saved input x:
//
//     gp = g conj(W)                   gp[t, j] = sum_i g[t, i] conj(W[i, j])
//     gw[i, j] = sum_t g[t, i] conj(x[t, j])      (over all A rows)
//
// g is float32 or bfloat16, gp float32 or bfloat16, gw float32.
//
// What bounds it on an H100: at the 22q plan's K = 64, bytes and tensor-core
// arithmetic about equally (g, x and gp moved once; 16K flops per amplitude
// in split TF32); above K = 64, arithmetic.  So both products run on the
// split-TF32 tensor-core tile of adjoint_tc.cuh through
// launch_fused_bwd_tc, with adjoint_step_top.cu's maps: the pullback with
// conj(W) as the column operand (TopPullbackMap: rows t, depth i, columns
// j), g read along its contiguous i and gp stored along j; the gram
// (TopGramMap: rows i, depth t, columns j) split over the A rows
// (gram_splits) into a caller-owned workspace, each split writing its own
// (2, K, K) partial, and summed in a fixed order (no atomics: gradients
// repeat bit for bit).  3 passes a product with a float32 g, 2 with a
// bfloat16 one.  Three launches, where the TPU kernel read (g, x) once for
// both outputs.
//
// The 16-byte copies (tc_vec_shape(K, K)).  Every operand runs along the
// window index: the pullback reads g along i and conj(W) along its rows j,
// the gram g along i and x along j, all in runs of K, never along t.  So
// the copies need K >= 8 (a bfloat16 g's 16 bytes are 8 elements),
// whatever A is; K = 2 and 4 take the tile's scalar staging.
#include "adjoint_tc.cuh"
#include "window_batch.cuh"

// w: (2, K, K) float32; g: (2, A*K) float32 (g_bf16 = 0) or bfloat16;
// x: (2, A*K) float32; gp: (2, A*K) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_window_apply_top_bwd(const float* w, const void* g, const float* x,
                                        void* gp, float* gw, float* ws,
                                        long long A, long long K, long long splits,
                                        int g_bf16, int gp_bf16, void* stream) {
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return qml::launch_fused_bwd_tc(w, gt, x, pt, gw, ws, A * K, K, A, K, A, splits,
                                    qml::tc_vec_shape(K, K), qml::TopPullbackMap{K},
                                    qml::TopGramMap{K}, (cudaStream_t)stream);
  });
}

// The batch entry (window_batch.cuh): the top window's backward on E
// elements in one launch; arguments as qml_window_apply_bwd_batch's, with
// B = 1 in geom.
extern "C" int qml_window_apply_top_bwd_batch(const long long* geom, const void* w,
                                              const void* g, const void* x, void* gp, void* gw,
                                              void* ws, void* cnt, void* stream) {
  return qml::batch::backward(geom, w, g, x, gp, gw, ws, cnt, (cudaStream_t)stream);
}
