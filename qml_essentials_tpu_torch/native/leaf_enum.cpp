// Native FourierTree leaf enumerator.
//
// Depth-first enumeration of the sine-cosine tree of Nemkov et al. over
// bit-packed symplectic Pauli words (x/z bits in one uint64_t each, so up
// to 64 qubits), with the same commute-skip and light-cone pruning as the
// Python implementation in analysis/coefficients.py.  This is the
// exponential host-side hot loop of the analytic Fourier pipeline; the
// C++ version removes all Python object and numpy-array overhead from the
// recursion (typically two orders of magnitude faster on deep circuits).
//
// Exposed via a C ABI for ctypes.  Leaves are appended to growable
// buffers; ownership passes to the caller via leaf_result, released with
// qml_free_leaves.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Word {
  uint64_t x;
  uint64_t z;
  int phase;  // exponent of i, mod 4
};

inline int parity(uint64_t v) { return __builtin_parityll(v); }

// (X^{x1}Z^{z1})(X^{x2}Z^{z2}) = (-1)^{z1·x2} X^{x1^x2} Z^{z1^z2}
inline Word compose(const Word& a, const Word& b) {
  Word out;
  out.x = a.x ^ b.x;
  out.z = a.z ^ b.z;
  out.phase = (a.phase + b.phase + 2 * parity(a.z & b.x)) & 3;
  return out;
}

inline bool commutes(const Word& a, const Word& b) {
  return (parity(a.x & b.z) ^ parity(a.z & b.x)) == 0;
}

struct Enumerator {
  const Word* paulis;
  const uint64_t* cum_xy;
  int n_params;
  std::vector<uint8_t> S;      // n_leaves * n_params sine counts
  std::vector<uint8_t> C;      // n_leaves * n_params cosine counts
  std::vector<double> term_re;
  std::vector<double> term_im;
  std::vector<uint8_t> s_path;  // current path counts
  std::vector<uint8_t> c_path;

  void recurse(Word obs, int idx) {
    // Light cone: an X/Y on the observable must be coverable by the
    // remaining rotations' X support, else every reachable leaf is zero.
    if (idx >= 0 && (obs.x & ~cum_xy[idx])) return;

    // Skip trailing rotations that commute with the observable.
    while (idx >= 0 && commutes(obs, paulis[idx])) idx--;

    if (idx < 0) {  // leaf: <0|P|0> = i^phase for diagonal words
      if (obs.x != 0) return;
      static const double RE[4] = {1.0, 0.0, -1.0, 0.0};
      static const double IM[4] = {0.0, 1.0, 0.0, -1.0};
      S.insert(S.end(), s_path.begin(), s_path.end());
      C.insert(C.end(), c_path.begin(), c_path.end());
      term_re.push_back(RE[obs.phase]);
      term_im.push_back(IM[obs.phase]);
      return;
    }

    // Cosine child: same observable.
    c_path[idx]++;
    recurse(obs, idx - 1);
    c_path[idx]--;

    // Sine child: observable becomes P . O.
    s_path[idx]++;
    recurse(compose(paulis[idx], obs), idx - 1);
    s_path[idx]--;
  }
};

}  // namespace

extern "C" {

struct LeafResult {
  uint8_t* S;
  uint8_t* C;
  double* term_re;
  double* term_im;
  int64_t n_leaves;
};

// paulis_x/z/phase: per-rotation generator words (length n_params).
// obs_x/z/phase: the root observable word.
// Returns 0 on success; fills *out.
int qml_enumerate_leaves(
    const uint64_t* paulis_x,
    const uint64_t* paulis_z,
    const int32_t* paulis_phase,
    int32_t n_params,
    uint64_t obs_x,
    uint64_t obs_z,
    int32_t obs_phase,
    LeafResult* out) {
  std::vector<Word> paulis(n_params);
  std::vector<uint64_t> cum_xy(n_params > 0 ? n_params : 1, 0);
  uint64_t running = 0;
  for (int i = 0; i < n_params; ++i) {
    paulis[i] = {paulis_x[i], paulis_z[i], static_cast<int>(paulis_phase[i] & 3)};
    running |= paulis[i].x;
    cum_xy[i] = running;
  }

  Enumerator e;
  e.paulis = paulis.data();
  e.cum_xy = cum_xy.data();
  e.n_params = n_params;
  e.s_path.assign(n_params, 0);
  e.c_path.assign(n_params, 0);

  Word obs{obs_x, obs_z, static_cast<int>(obs_phase & 3)};
  e.recurse(obs, n_params - 1);

  const int64_t n_leaves = static_cast<int64_t>(e.term_re.size());
  out->n_leaves = n_leaves;
  const size_t nm = static_cast<size_t>(n_leaves) * n_params;
  out->S = static_cast<uint8_t*>(std::malloc(nm ? nm : 1));
  out->C = static_cast<uint8_t*>(std::malloc(nm ? nm : 1));
  out->term_re = static_cast<double*>(std::malloc(sizeof(double) * (n_leaves ? n_leaves : 1)));
  out->term_im = static_cast<double*>(std::malloc(sizeof(double) * (n_leaves ? n_leaves : 1)));
  if (!out->S || !out->C || !out->term_re || !out->term_im) return 1;
  if (nm) {
    std::memcpy(out->S, e.S.data(), nm);
    std::memcpy(out->C, e.C.data(), nm);
  }
  if (n_leaves) {
    std::memcpy(out->term_re, e.term_re.data(), sizeof(double) * n_leaves);
    std::memcpy(out->term_im, e.term_im.data(), sizeof(double) * n_leaves);
  }
  return 0;
}

void qml_free_leaves(LeafResult* out) {
  std::free(out->S);
  std::free(out->C);
  std::free(out->term_re);
  std::free(out->term_im);
  out->S = nullptr;
  out->C = nullptr;
  out->term_re = nullptr;
  out->term_im = nullptr;
  out->n_leaves = 0;
}

}  // extern "C"
