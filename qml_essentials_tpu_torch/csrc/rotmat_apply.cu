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
// amplitude against 16 bytes read and written; K = 256 on the main path).
// The design is window_apply.cu's tile (cgemm_tile.cuh) with the transpose
// put into the loads of x_pre: its 16-deep stages are read along the
// contiguous window index j (RotWindowMap with L = K), and the output is
// stored along its contiguous index x, as the window kernel's is.
#include "cgemm_tile.cuh"

// x, y: (2, X*K) float32 real-split states; w: (2, K, K) float32 Re/Im.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int qml_rotmat_apply(const float* x, const float* w, float* y, long long K,
                                long long X, void* stream) {
  const int64_t plane = (int64_t)K * X;
  return qml::launch_cgemm(w, K * K, x, plane, y, plane, 0, K, X, K, 1,
                           qml::RotWindowMap{qml::rot_cols(K, X, K)}, (cudaStream_t)stream);
}
