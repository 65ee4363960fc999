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
// 512 and 1024 on the main path).  The design is rotmat_apply.cu's with the
// depth index split in two: RotWindowMap reads x_pre along l in runs of
// L >= 128, so each 16-deep stage is one contiguous run, and the store runs
// along x.  Where the TPU kernel looped over a with one matmul each, the
// depth loop here crosses the a-groups without a break.
#include "cgemm_tile.cuh"

// x, y: (2, 2^n) float32 real-split states, K * X = 2^n; w: (2, K, K)
// float32, columns permuted to j' = a*L + l.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int qml_rotwin_apply(const float* x, const float* w, float* y, long long K,
                                long long X, long long L, void* stream) {
  const int64_t plane = (int64_t)K * X;
  return qml::launch_cgemm(w, K * K, x, plane, y, plane, 0, K, X, K, 1,
                           qml::RotWindowMap{qml::rot_cols(K, X, L)}, (cudaStream_t)stream);
}
