// rotmat_apply: a layout rotation and the window on the wires it rotated in,
// in one pass.
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:rotmat_apply_ri (the
// _rotmat_apply launcher and _rotmat_kernel).  The layout scheduler fuses a
// rotation by r with the next window when that window is [0, r): the rotated
// state viewed (K, X), K = 2^r, X = 2^(n-r), is the transpose of the
// pre-rotation (X, K) view, so
//
//     y[i, x] = sum_j W[i, j] x_pre[x, j]      y = W x_pre^T
//
// replaces one rotation pass and one window pass.
//
// What bounds it on an H100: arithmetic, as the window kernel (8K flops per
// amplitude against 16 bytes read and written; K = 256 on the main path), so
// it runs window_apply.cu's split-TF32 wgmma kernel (forward_wgmma.cuh,
// bounded by 3 x 8K flops / 495 TFLOP/s) with the transpose put into the
// loads of x_pre: RotWindowMap with L = K reads it along its contiguous
// window index j, the depth, which is the layout wgmma's register A operand
// is read from as well as any other; the output is stored along its
// contiguous index x.  Shapes under forward_wgmma_shape (K < 8 or X < 32)
// take adjoint_tc.cuh's split-TF32 mma.sync tile.
#include "forward_wgmma.cuh"

// x, y: (2, X*K) float32 real-split states; w: (2, K, K) float32 Re/Im;
// ws: 4*K*K float32 scratch (W's split planes).  Launches on `stream`;
// returns the first CUDA error, or 0.
extern "C" int qml_rotmat_apply(const float* x, const float* w, float* ws, float* y,
                                long long K, long long X, void* stream) {
  const int64_t plane = (int64_t)K * X;
  const qml::RotWindowMap map{qml::rot_cols(K, X, K)};
  if (qml::forward_wgmma_shape(K, X))
    return qml::launch_forward_wgmma(x, w, ws, y, plane, K, X, K, map, (cudaStream_t)stream);
  return qml::launch_tc_cgemm(w, K * K, x, plane, y, plane, 0, K, X, K, 1, qml::tc_vec_shape(K, X),
                              map, (cudaStream_t)stream);
}
