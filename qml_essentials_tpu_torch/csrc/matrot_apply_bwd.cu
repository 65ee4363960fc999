// matrot_apply_bwd: backward of matrot_apply.cu (a window on [0, k) and the
// rotation by r = n - k in one pass).
//
// Replaces qml_essentials_tpu/ops/pallas_kernels.py:_matrot_apply_bwd (the
// launcher of _matrot_bwd_kernel).  For y = (W x)^T (x viewed (K, B), y
// (B, K), K = 2^k, B = 2^r), given the output cotangent g and the saved
// input x:
//
//     gp[j, b] = sum_i conj(W[i, j]) g[b, i]     (W^dagger of g rotated back)
//     gw[i, j] = sum_b g[b, i] conj(x[j, b])
//
// g is float32 or bfloat16, gp float32 or bfloat16, gw float32.
//
// What bounds it on an H100: arithmetic, 16K flops per amplitude (two
// products), as rotmat_apply_bwd.cu, so both run on the split-TF32 tensor
// cores of adjoint_tc.cuh (3 passes with a float32 g, 2 with a bfloat16
// one), oriented so every store is contiguous: the pullback has rows j,
// columns b and reads g along its contiguous i (the inverse rotation as a
// transposed load, MatrotPullbackMap, adjoint_matrot.cu's); the gram has
// rows i, columns j, depth b, reads g along i and x along b, and is split
// over the B columns (gram_splits) into a caller-owned workspace summed in a
// fixed order (no atomics).
//
// The gram's mixed layout.  Its A operand g runs along the rows i
// (A_M_CONTIG) and is staged [depth][row] with a row of 72 elements; its B
// operand x runs along the depth b (B_K_CONTIG) and is staged
// [column][depth] with a row of 36 floats.  A warp's fragment reads then
// fall on banks 8 tig + gid (a float32 g; a bfloat16 one: 4 tig + gid / 2,
// two lanes a word) and 4 gid + tig, all distinct, so the tile's padding
// keeps them free of conflicts in this layout too (not measured: the card's
// tools read no shared-memory counters).
//
// The 16-byte copies (tc_vec_shape(K, B)).  The pullback reads W along j and
// g along i, both in runs of K; the gram reads g along i and x along b, in
// runs of B (the rows of the (K, B) view).  So the copies need K >= 8 and
// B >= 8 (a bfloat16 g's 16 bytes are 8 elements); K or B = 2 or 4 take
// the tile's scalar staging.
#include "adjoint_tc.cuh"

namespace {

struct MatrotGramMap {
  static constexpr bool A_M_CONTIG = true, B_K_CONTIG = true;
  static constexpr bool CONJ_A = false, CONJ_B = true, INNER_M = true;
  int64_t K, B;
  __device__ __forceinline__ int64_t a_off(int64_t i, int64_t b) const { return b * K + i; }
  __device__ __forceinline__ int64_t b_off(int64_t b, int64_t j) const { return j * B + b; }
  __device__ __forceinline__ int64_t c_off(int64_t i, int64_t j) const { return i * K + j; }
};

}  // namespace

// w: (2, K, K) float32; g: (2, B*K) float32 (g_bf16 = 0) or bfloat16;
// x: (2, K*B) float32; gp: (2, K*B) float32 (gp_bf16 = 0) or bfloat16;
// gw: (2, K, K) float32; ws: splits * 2*K*K float32 scratch.
// Launches on `stream`; returns the first CUDA error, or 0.
extern "C" int qml_matrot_apply_bwd(const float* w, const void* g, const float* x, void* gp,
                                    float* gw, float* ws, long long K, long long B,
                                    long long splits, int g_bf16, int gp_bf16,
                                    void* stream) {
  return qml::with_cotangent_types(g, gp, g_bf16, gp_bf16, [&](auto gt, auto pt) {
    return qml::launch_fused_bwd_tc(w, gt, x, pt, gw, ws, K * B, K, K, B, B, splits,
                                    qml::tc_vec_shape(K, B), qml::MatrotPullbackMap{K, B},
                                    MatrotGramMap{K, B}, (cudaStream_t)stream);
  });
}
