// rotwin_apply: a layout rotation by r and a window on [0, k), k > r, in one
// pass.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:rotwin_apply_ri (the
// _rotwin_apply launcher and _rotwin_kernel).  After the rotation the
// window's top r wires are the pre-rotation state's bottom r bits l
// (L = 2^r) and its other e = k - r wires (e <= 2 on the main path) are the
// pre-rotation top bits a (A = 2^e).  With W's columns permuted by the
// caller to j' = a*L + l (the reference's _rotwin_wperm, a K x K op),
//
//     y[i, x] = sum_j' W'[i, j'] x_pre[a, x, l]       (x < X = 2^(n-k))
//
// written in the post-rotation (K, X) layout.
//
// What bounds it on an H100: arithmetic (8K flops per amplitude; K = 256,
// 512 and 1024 on the main path), so it runs rotmat_apply.cu's split-TF32
// wgmma kernel (forward_wgmma.cuh, bounded by 3 x 8K flops / 495 TFLOP/s)
// with the depth index split in two: RotWindowMap reads x_pre along l, in A
// runs of L, through the kernel's 4-D depth-contiguous view (L, X, A, 2), a
// stage issued at (k0 mod L, c0, k0 / L, 0).  With L >= 32 a 32-deep stage
// lies inside one a-group and lands as rotmat's does; the store runs along
// x.  Where the TPU kernel looped over a with one matmul each, the depth
// loop here crosses the a-groups without a break.  Shapes under the rule
// (K < 8, X < 32 or L < 32: forward_wgmma_shape(K, min(X, L))) take
// adjoint_tc.cuh's split-TF32 mma.sync tile, with 16-byte copies when
// K >= 8, X >= 8 and L >= 8 (x_pre is read along j', contiguous in runs of
// L), as rotwin_apply_bwd.cu's.
#include "forward_wgmma.cuh"

// x, y: (2, 2^n) float32 real-split states, K * X = 2^n; w: (2, K, K)
// float32, columns permuted to j' = a*L + l; ws: 4*K*K float32 scratch (W's
// split planes).  Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_rotwin_apply(const float* x, const float* w, float* ws, float* y,
                                long long K, long long X, long long L, void* stream) {
  const int64_t plane = (int64_t)K * X;
  const qml::RotWindowMap map{qml::rot_cols(K, X, L)};
  if (qml::forward_wgmma_shape(K, X < L ? X : L))
    return qml::launch_forward_wgmma(x, w, ws, y, plane, K, X, L, map, (cudaStream_t)stream);
  return qml::launch_tc_cgemm(w, K * K, x, plane, y, plane, 0, K, X, K, 1,
                              qml::tc_vec_shape(K, X) && L >= 8, map, (cudaStream_t)stream);
}
