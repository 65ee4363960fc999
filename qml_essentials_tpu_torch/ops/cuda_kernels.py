"""Hand-written CUDA kernels of the statevector hot path, and their wrappers.

Eighteen kernels, compiled for Hopper (``sm_90a``) from ``csrc/`` with plain
``nvcc`` (one process per source, all started together, then one link) into
one shared library with a C interface, loaded with ``ctypes``:

=====================  ============================  ======================================
wrapper                source                        replaces (JAX package)
=====================  ============================  ======================================
window_apply           csrc/window_apply.cu          pallas_kernels.window_apply_ri
window_apply_bwd       csrc/window_apply_bwd.cu      pallas_kernels._apply_bwd
window_apply_top       csrc/window_apply_top.cu      pallas_kernels.window_apply_top_ri
window_apply_top_bwd   csrc/window_apply_top_bwd.cu  pallas_kernels._apply_top_bwd
rotate                 csrc/rotate.cu                pallas_kernels.rotate_ri
rotmat_apply           csrc/rotmat_apply.cu          pallas_kernels.rotmat_apply_ri
rotmat_apply_bwd       csrc/rotmat_apply_bwd.cu      pallas_kernels._rotmat_apply_bwd
matrot_apply           csrc/matrot_apply.cu          pallas_kernels.matrot_apply_ri
matrot_apply_bwd       csrc/matrot_apply_bwd.cu      pallas_kernels._matrot_apply_bwd
rotwin_apply           csrc/rotwin_apply.cu          pallas_kernels.rotwin_apply_ri
rotwin_apply_bwd       csrc/rotwin_apply_bwd.cu      pallas_kernels._rotwin_apply_bwd
adjoint_step           csrc/adjoint_step.cu          pallas_kernels.adjoint_step_ri
adjoint_step_top       csrc/adjoint_step_top.cu      pallas_kernels.adjoint_step_top_ri
adjoint_rotmat         csrc/adjoint_rotmat.cu        pallas_kernels.adjoint_rotmat_ri
adjoint_matrot         csrc/adjoint_matrot.cu        pallas_kernels.adjoint_matrot_ri
rotate_pair            csrc/rotate_pair.cu           pallas_kernels.rotate_pair_ri
chain_apply            csrc/chain_apply.cu           pallas_kernels.chain_apply_ri
adjoint_chain          csrc/adjoint_chain.cu         pallas_kernels.adjoint_chain_ri
=====================  ============================  ======================================

Sixteen kernels run their products on the tensor cores in split TF32
(float32-grade, whatever ``torch.backends.cuda.matmul.allow_tf32`` says):
``window_apply``, ``rotmat_apply``, ``rotwin_apply``, ``matrot_apply`` and
``window_apply_top`` on warpgroup ``wgmma`` (``csrc/forward_wgmma.cuh``, W
split once a call into a workspace the wrapper allocates; shapes under
:func:`forward_path` on the tile below), ``window_apply_bwd``,
``window_apply_top_bwd``, ``rotmat_apply_bwd``, ``matrot_apply_bwd`` and
``rotwin_apply_bwd`` (pullback and gram) and ``adjoint_step``,
``adjoint_step_top``, ``adjoint_rotmat`` and ``adjoint_matrot`` (two
pullbacks and the gram) on ``mma.sync`` (``csrc/adjoint_tc.cuh``), and the
chain kernels ``chain_apply`` and ``adjoint_chain`` (``csrc/chain_block.cuh``:
their window products, pullbacks and grams on ``wgmma``, W split once a
launch into a workspace the wrapper allocates; ``mma.sync`` for windows
under the wgmma shape rule); the adjoint
steps' ``gw = G0 W`` multiplies in float32 on the CUDA cores
(``csrc/cgemm_tile.cuh``).

B1-B4 also have batch entries (``csrc/window_batch.cuh``, compiled into
their sources; launch counts ``window_apply_batch``,
``window_apply_bwd_batch``, ``window_apply_top_batch``,
``window_apply_top_bwd_batch``): the same wrappers given a batched ``(2, Bt,
2**n)`` state launch one kernel for the whole batch, with a shared ``(2, K,
K)`` window or one per element ``(Bt, 2, K, K)``, in float32 or float64 on
the CUDA cores; ``rotate`` takes a batched state as ``2 * Bt`` planes.  The
forward batch entries are a thread a column, its K inputs in registers,
tiles of columns and their windows double-buffered in shared memory by
persistent CTAs (:func:`batch_fwd_geometry` chooses the tiles); without
a gradient to record they launch without an autograd Function.  The
backward batch entries are one launch a call: tiles staged in shared
memory, the gram per element, or summed over the batch for a shared window
(the last CTA of a gram sums its partials in a fixed order, counted on an
integer counter per device and stream; :func:`batch_bwd_geometry` chooses
the tiles).  A float64 state without a batch axis runs the batch
entries as a batch of one.

The library is built at first use into ``build/kernels/`` at the repository
root and rebuilt whenever a source (or the compiler flags) changes: its file
name carries a hash of both.  Nothing is compiled or loaded at import time.

Each wrapper takes the plain PyTorch version in
:mod:`qml_essentials_tpu_torch.ops.kernels` for a tensor on the CPU, and only
then.  For a CUDA tensor it checks device, dtype, shape and contiguity,
allocates outputs (and the forward's split-W and the backward's
split-reduction workspaces) with ``torch.empty`` (the batch backward's
partial grams and counters are cached per device, stream and dtype),
launches on the current stream, raises if the launch reports an error, and
adds one to its launch count.  It never falls back to
the plain version on the card.

Gradients: on the card the forward wrappers run through
``torch.autograd.Function``s whose backwards are kernels too, mirroring the
JAX package's per-kernel VJPs — each window's backward is its ``*_bwd``
kernel (``window_apply_bwd``, ``window_apply_top_bwd``, ``rotmat_apply_bwd``,
``matrot_apply_bwd``, ``rotwin_apply_bwd``), and the rotation's is the
rotation by ``(n - r) % n``.  The adjoint-state backward
(:mod:`qml_essentials_tpu_torch.ops.adjoint`) calls ``adjoint_step``,
``adjoint_step_top``, ``adjoint_rotmat``, ``adjoint_matrot``,
``rotate_pair`` and ``adjoint_chain`` inside its own backward; they need no
autograd Functions.  ``chain_apply`` has none either: it runs where no
gradient flows through it (a gradient through a chain step runs the
adjoint's ``adjoint_chain`` or the step's expansion), and raises otherwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from qml_essentials_tpu_torch.ops import kernels

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "window_apply.cu", "window_apply_bwd.cu", "window_apply_top.cu",
    "window_apply_top_bwd.cu", "rotate.cu", "rotmat_apply.cu", "rotmat_apply_bwd.cu",
    "matrot_apply.cu", "matrot_apply_bwd.cu", "rotwin_apply.cu", "rotwin_apply_bwd.cu",
    "adjoint_step.cu", "adjoint_step_top.cu", "adjoint_rotmat.cu", "adjoint_matrot.cu",
    "rotate_pair.cu", "chain_apply.cu", "adjoint_chain.cu",
)
HEADERS = ("cgemm_tile.cuh", "adjoint_tc.cuh", "forward_wgmma.cuh", "transpose_tile.cuh",
           "chain_block.cuh", "window_batch.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The batch entries of B1-B4 (``csrc/window_batch.cuh``, compiled into their
# kernels' sources): a batched ``(2, Bt, 2**n)`` state in one launch, with a
# shared or a per-element window; each counts its own launches.
BATCH_KERNELS = ("window_apply_batch", "window_apply_bwd_batch", "window_apply_top_batch",
                 "window_apply_top_bwd_batch")

# Launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {name: 0 for name in (*(Path(s).stem for s in SOURCES),
                                                 *BATCH_KERNELS)}

# Compiler output (ptxas register and shared-memory use) of the last build.
BUILD_LOG: str = ""

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqml_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands in parallel; wait for every one, then raise if any
    failed.  Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Tuple[Path, float]:
    """Compile the kernels if the library for the current sources is missing.

    Returns ``(path, seconds spent compiling)`` (0.0 when it was up to date);
    the compiler's output is kept in ``BUILD_LOG`` and beside the library
    (``<library>.log``), so an up-to-date build still reports it.
    """
    global BUILD_LOG
    path = library_path()
    log_path = path.with_name(path.name + ".log")
    if path.exists():
        BUILD_LOG = log_path.read_text() if log_path.exists() else ""
        return path, 0.0
    objdir = BUILD_DIR / f"obj.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [objdir / (Path(s).stem + ".o") for s in SOURCES]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    log += _run_all([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                      "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)
    shutil.rmtree(objdir, ignore_errors=True)
    BUILD_LOG = log
    return path, seconds


def _argtypes() -> Dict[str, list]:
    """C signature of each entry point: pointers and the stream as
    ``c_void_p`` (a plain int would cut them to 32 bits), sizes as 64-bit."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    bwd = [ptr] * 6  # w, g, x, gp, gw, ws
    adj = [ptr] * 7  # w, psi, lam, psi_prev, lam_prev, gw, ws
    flags = [i32, i32, ptr]  # bf16 in, bf16 out, stream
    return {
        "window_apply": [ptr] * 4 + [i64] * 3 + [ptr],  # x, w, ws, y, A, K, B, stream
        "window_apply_bwd": bwd + [i64] * 4 + flags,
        "window_apply_top": [ptr] * 4 + [i64] * 2 + [ptr],  # x, w, ws, y, A, K, stream
        "window_apply_top_tile": [ptr] * 3 + [i64] * 2 + [ptr],  # x, w, y, A, K, stream
        "window_apply_top_bwd": bwd + [i64] * 3 + flags,
        # geometry, x, w, y, stream
        "window_apply_batch": [ctypes.POINTER(i64)] + [ptr] * 4,
        "window_apply_top_batch": [ctypes.POINTER(i64)] + [ptr] * 4,
        # geometry, w, g, x, gp, gw, ws, counters, stream
        "window_apply_bwd_batch": [ctypes.POINTER(i64)] + [ptr] * 8,
        "window_apply_top_bwd_batch": [ctypes.POINTER(i64)] + [ptr] * 8,
        "batch_empty": [ptr],  # stream: the launch floor, for chip_smoke.py
        "rotate": [ptr, ptr, i64, i64, ptr],
        "rotate_batch": [ptr, ptr, i64, i64, i64, i32, ptr],
        "rotate_b16": [ptr, ptr, i64, i64, ptr],
        "rotmat_apply": [ptr] * 4 + [i64] * 2 + [ptr],  # x, w, ws, y, K, X, stream
        "rotmat_apply_bwd": bwd + [i64] * 3 + flags,
        "matrot_apply": [ptr] * 4 + [i64] * 2 + [ptr],  # x, w, ws, y, K, B, stream
        "matrot_apply_bwd": bwd + [i64] * 3 + flags,
        "rotwin_apply": [ptr] * 4 + [i64] * 3 + [ptr],  # x, w, ws, y, K, X, L, stream
        "rotwin_apply_bwd": bwd + [i64] * 4 + flags,
        "adjoint_step": adj + [i64] * 4 + flags,
        "adjoint_step_top": adj + [i64] * 3 + flags,
        "adjoint_rotmat": adj + [i64] * 3 + flags,
        "adjoint_matrot": adj + [i64] * 3 + flags,
        "rotate_pair": [ptr, ptr, ptr, ptr, i64, i64, i32, ptr],
        "forward_path": [i64, i64],
        # x, y, ws, payloads, split workspace, descriptors (device, host),
        # nd, plane, the blocks (5), ranks, largest K^2, stream
        "chain_apply": [ptr] * 7 + [i64] * 9 + [ptr],
        # psi, lam, psi_out, lam_out, ws_psi, ws_lam, payloads, split
        # workspace, grads, descriptors (device, host), nd, plane, the blocks
        # (5), ranks, clusters, slots, red, slot size, largest K^2, stream
        "adjoint_chain": [ptr] * 11 + [i64] * 9 + [ptr, ptr, i64, i64, ptr],
        "chain_apply_clusters": [i64],  # ranks
        "adjoint_chain_clusters": [i64],
    }


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, args in _argtypes().items():
                fn = getattr(lib, f"qml_{name}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain version), False
    when they all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {device}")
    return False


_COTANGENT_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, label: str, t: torch.Tensor, shape: tuple, dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes:
        allowed = " or ".join(str(d) for d in dtypes)
        raise TypeError(f"{name}: {label} must be {allowed}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {label} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != {shape}")


def _check_out_dtype_batch(name: str, x: torch.Tensor, out_dtype: torch.dtype) -> None:
    if out_dtype != x.dtype:
        raise TypeError(f"{name}: the batch entries give the cotangent in the state's dtype "
                        f"{x.dtype}, not {out_dtype}")


def _single(x: torch.Tensor) -> bool:
    """A float64 state on the card without a batch axis: it runs the batch
    entries as a batch of one (the single-state kernels take float32)."""
    return x.dtype == torch.float64 and not kernels.is_batched(x)


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in _COTANGENT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")


def _stream(t: torch.Tensor) -> int:
    """The handle of the current stream on t's device (without building a
    ``torch.cuda.Stream``: microseconds of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}")


# Matrix-cotangent split: enough blocks to fill the card several times over,
# each summing at least _GRAM_MIN_CHUNK columns, and a workspace of at most
# _GRAM_MAX_WS bytes.
_GRAM_BLOCKS = 1024
_GRAM_MIN_CHUNK = 256
_GRAM_MAX_WS = 64 * 1024 * 1024


def gram_splits(K: int, C: int) -> int:
    """Number of column chunks the backward kernels reduce ``gw`` over, for a
    ``K x K`` output and ``C`` columns (a power of two)."""
    tiles = (-(-K // 64)) ** 2
    splits = max(1, _GRAM_BLOCKS // tiles)
    splits = min(splits, max(1, C // _GRAM_MIN_CHUNK), max(1, _GRAM_MAX_WS // (8 * K * K)))
    return splits


# ---------------------------------------------------------------------------
# Launchers (CUDA tensors only)
# ---------------------------------------------------------------------------


def forward_path(K: int, run: int) -> bool:
    """True when ``window_apply`` / ``rotmat_apply`` / ``rotwin_apply`` /
    ``matrot_apply`` / ``window_apply_top`` with ``K`` rows and a state column
    run ``run`` (``B`` of the window view and of matrot's ``(K, B)`` view,
    ``X`` of the rotmat view, ``min(X, L)`` of rotwin's, ``A`` of the top
    window's ``(A, K)`` view) take the wgmma kernel, False when they take the
    split-TF32 ``mma.sync`` tile: the C launchers' shape rule, asked of the
    library."""
    return bool(_load().qml_forward_path(K, run))


def _launch_window(name, psi2, w2, K, n, geometry, split_w=False):
    """One forward window kernel ``qml_<name>(x, w, [ws,] y, *geometry,
    stream)`` on a float32 state and ``(2, K, K)`` window; returns the new
    state.  *split_w*: the kernel takes a ``4*K*K`` float32 workspace for
    W's split-TF32 planes (``window_apply``, ``rotmat_apply``,
    ``rotwin_apply``, ``matrot_apply``, ``window_apply_top``)."""
    _check(name, "state", psi2, (2, 2**n))
    _check(name, "window", w2, (2, K, K))
    lib = _load()
    y = torch.empty_like(psi2)
    ws = [torch.empty((4, K, K), dtype=torch.float32, device=psi2.device)] if split_w else []
    with torch.cuda.device(psi2.device):
        code = getattr(lib, f"qml_{name}")(
            psi2.data_ptr(), w2.data_ptr(), *(t.data_ptr() for t in ws), y.data_ptr(),
            *geometry, _stream(psi2))
    _raise_on(name, code)
    LAUNCHES[name] += 1
    return y


def _launch_window_apply(psi2, w2, a, k, n):
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"window_apply: support [{a}, {a + k}) needs B > 1 in n={n}")
    return _launch_window("window_apply", psi2, w2, 2**k, n, (2**a, 2**k, 2 ** (n - a - k)),
                          split_w=True)


def _launch_window_apply_top(psi2, w2, k, n):
    if not 1 <= k <= n:
        raise ValueError(f"window_apply_top: k={k} out of range for n={n}")
    return _launch_window("window_apply_top", psi2, w2, 2**k, n, (2 ** (n - k), 2**k),
                          split_w=True)


_BATCH_DTYPES = (torch.float32, torch.float64)


def _batch_window(name: str, psi2: torch.Tensor, w2: torch.Tensor, K: int, n: int) -> int:
    """Checks a batch entry's state ``(2, Bt, 2**n)`` and window (shared
    ``(2, K, K)`` or per element ``(Bt, 2, K, K)``), float32 or float64 both;
    returns the window's stride between elements (0 when shared)."""
    E = psi2.shape[1]
    _check(name, "state", psi2, (2, E, 2**n), _BATCH_DTYPES)
    if w2.dim() == 4:
        _check(name, "window", w2, (E, 2, K, K), (psi2.dtype,))
        return 2 * K * K
    _check(name, "window", w2, (2, K, K), (psi2.dtype,))
    return 0


def _f64(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float64)


# The batch forward (``csrc/window_batch.cuh``, one launch a call): a thread
# a column, tiles of at most _FWD_TC columns (one a thread; fewer when the
# batch makes under _FWD_TILES_AN_SM tiles an SM), two tile buffers of a
# CTA within _FWD_SMEM bytes of shared memory (two CTAs an SM at least);
# above _FWD_KREG[f64] rows a column's outputs are split over threads of
# _FWD_WIDE_R each (``forward_wide``).
_FWD_TC = 256
_FWD_TILES_AN_SM = 4
_FWD_SMEM = 96 * 1024
_FWD_KREG = {False: 32, True: 16}
_FWD_WIDE_R = 4
_FWD_WIDE_THREADS = 256
_H100_SMS = 132


class BatchFwdGeometry(NamedTuple):
    """One batch forward launch, in the order of the kernel's ``FwdGeom``.

    Columns are the ``Q = E*A*B`` columns of the batch view ``(2, E*A, K,
    B)``.  Staged (``rows == K``): tile ``kt`` is columns ``[kt*tc,
    (kt+1)*tc)``; CTA ``b`` walks tiles ``b, b + grid, ...``, thread ``t``
    taking column ``t`` of each.  In shared memory a tile's plane is
    ``dim`` values: when ``tc > B`` its ``tc / B`` blocks ``(e, a)`` of
    ``K*B`` values, ``K*B + pad`` apart, else ``K`` runs of ``tc`` values;
    after both planes, ``wdim`` values of its elements' windows (per-element
    W; 0 when they are read in place; a shared W is staged once a CTA,
    before the two buffers).  Wide
    (``rows == _FWD_WIDE_R``, ``tc == 0``): ``tiles`` work items, item ``u``
    the outputs ``[s*rows, (s+1)*rows)`` of column ``u // (32*S) * 32 + u %
    32``, ``s = u // 32 % S``, ``S = K / rows``.  ``grid`` is an upper
    bound: the launcher keeps it within the card's residency."""

    E: int
    A: int
    K: int
    B: int
    w_stride: int
    rows: int
    tc: int
    pad: int
    dim: int
    wdim: int
    tiles: int
    threads: int
    grid: int
    smem: int
    sms: int
    f64: int

    @property
    def columns(self) -> int:
        return self.E * self.A * self.B


def _pow2ceil(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _fwd_layout(A, K, B, per_element, esize, tc, pad, stage_w) -> Tuple[int, int, int]:
    """A tile's ``dim`` and ``wdim`` (values) and the CTA's shared memory
    (bytes) at ``tc`` columns a tile; per-element windows staged with the
    tile when *stage_w*, else read in place (``wdim`` 0)."""
    V, KK = 16 // esize, K * K
    dim = (tc // B) * (K * B + pad) if tc > B else K * tc
    dim = -(-dim // V) * V
    wdim = max(1, tc // (A * B)) * 2 * KK if per_element and stage_w else 0
    return dim, wdim, esize * ((0 if per_element else 2 * KK) + 2 * (2 * dim + wdim))


@functools.lru_cache(maxsize=None)
def batch_fwd_geometry(E: int, A: int, K: int, B: int, per_element: bool, f64: bool,
                       sms: int = _H100_SMS) -> BatchFwdGeometry:
    """The batch forward's launch for ``E`` elements of the ``(2, A, K, B)``
    window view on a card of ``sms`` SMs: a pure function of the shapes."""
    esize = 8 if f64 else 4
    V, KK, Q = 16 // esize, K * K, E * A * B
    w_stride = 2 * KK if per_element else 0
    if K > _FWD_KREG[f64]:
        items = -(-Q // 32) * 32 * (K // _FWD_WIDE_R)
        return BatchFwdGeometry(E, A, K, B, w_stride, _FWD_WIDE_R, 0, 0, 0, 0, items,
                                _FWD_WIDE_THREADS,
                                min(-(-items // _FWD_WIDE_THREADS),
                                    sms * (2048 // _FWD_WIDE_THREADS)),
                                0, sms, int(f64))
    # Blocks K*B + pad apart: a warp's (a half-warp's in float64) reads of
    # one row j fall on distinct banks when the stride is B modulo 128 bytes
    # (B = 1: an odd number of 16-byte units, the column read in 16-byte
    # loads); a pad of whole 16-byte units keeps the copies 16-byte.
    if B == 1:
        pad = V if K >= V and (K // V) % 2 == 0 else 0
    elif B * esize % 16 == 0:
        pad = (B - K * B) % (128 // esize)
    else:
        pad = 0
    # The largest tile within the budget; per-element windows that do not
    # fit even beside 32 columns (K = 32 over few columns an element) are
    # read in place instead.
    stage_w = per_element and _fwd_layout(A, K, B, True, esize, 32, pad, True)[2] <= _FWD_SMEM
    tc = _FWD_TC
    while tc > 32 and _fwd_layout(A, K, B, per_element, esize, tc, pad, stage_w)[2] > _FWD_SMEM:
        tc //= 2
    # A small batch: tiles enough for _FWD_TILES_AN_SM an SM (the KL's 10,000
    # 4q elements: 625 tiles of 128 columns rather than 313 of 256).
    while tc > 32 and -(-Q // tc) < _FWD_TILES_AN_SM * sms:
        tc //= 2
    dim, wdim, smem = _fwd_layout(A, K, B, per_element, esize, tc, pad, stage_w)
    tiles = -(-Q // tc)
    return BatchFwdGeometry(E, A, K, B, w_stride, K, tc, pad, dim, wdim, tiles, tc,
                            min(tiles, sms * (2048 // tc)), smem, sms, int(f64))


@functools.lru_cache(maxsize=None)
def _fwd_args(E: int, A: int, K: int, B: int, per_element: bool, f64: bool,
              sms: int) -> ctypes.Array:
    geom = batch_fwd_geometry(E, A, K, B, per_element, f64, sms)
    return (ctypes.c_longlong * len(geom))(*geom)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def _launch_fwd_batch(name, psi2, w2, A, K, B, n):
    """One batched forward ``qml_<name>(geometry, x, w, y, stream)`` (float32
    or float64); returns y, the one allocation."""
    stride = _batch_window(name, psi2, w2, K, n)
    args = _fwd_args(psi2.shape[1], A, K, B, stride != 0, psi2.dtype == torch.float64,
                     _sm_count(psi2.device))
    lib = _load()
    y = torch.empty_like(psi2)
    with _on_device(psi2):
        code = getattr(lib, f"qml_{name}")(args, psi2.data_ptr(), w2.data_ptr(), y.data_ptr(),
                                           _stream(psi2))
    _raise_on(name, code)
    LAUNCHES[name] += 1
    return y


def _launch_window_apply_batch(psi2, w2, a, k, n):
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"window_apply: support [{a}, {a + k}) needs B > 1 in n={n}")
    return _launch_fwd_batch("window_apply_batch", psi2, w2, 2**a, 2**k, 2 ** (n - a - k), n)


def _launch_window_apply_top_batch(psi2, w2, k, n):
    if not 1 <= k <= n:
        raise ValueError(f"window_apply_top: k={k} out of range for n={n}")
    return _launch_fwd_batch("window_apply_top_batch", psi2, w2, 2 ** (n - k), 2**k, 1, n)


# The batch backward (``csrc/window_batch.cuh``, one launch a call): CTAs of
# _BWD_THREADS threads, about _BWD_TARGET of them when the batch allows (one
# an SM on an H100's 132: at the 6q gradient's shapes fewer, fatter CTAs ran
# faster than two an SM, PERF.md), each with at most _BWD_TILE_BYTES of g
# and x tiles and _BWD_W_BYTES of windows in shared memory (under the 48 KB
# a launch may take without asking), at most _BWD_BLOCK gram outputs (4 a
# thread, in registers), and at most _BWD_FINAL values for the last CTA of
# a gram block to sum.
_BWD_THREADS = 256
_BWD_TARGET = 128
_BWD_TILE_BYTES = 32 * 1024
_BWD_W_BYTES = 8 * 1024
_BWD_BLOCK = 1024
_BWD_FINAL = 131072
_BWD_COUNTERS = 256  # counters a device and stream: more than any geometry takes


class BatchBwdGeometry(NamedTuple):
    """One batch backward launch, in the order of the kernel's ``BwdGeom``.

    Columns are the ``Q = E*A*B`` columns of the batch view ``(2, E*A, K,
    B)``.  Whole-element mode (``group`` > 0, a per-element window): CTA
    ``b`` takes the ``group`` elements from ``b * group`` (its tile of
    ``tc = group * A * B`` columns) and writes their grams.  Column mode
    (``group`` = 0): a gram (the batch's for a shared window, an element's
    otherwise) is split into ``blocks`` output blocks and its tiles of
    ``tc`` columns into ``parts`` runs of ``tpc``; CTA ``b`` is (gram ``b //
    (blocks * parts)``, block ``b // parts % blocks``, part ``b % parts``);
    with ``parts`` > 1 each writes a partial and the last to arrive sums
    them."""

    E: int
    A: int
    K: int
    B: int
    w_stride: int
    tc: int
    tpc: int
    parts: int
    blocks: int
    group: int
    stage: int
    w_smem: int
    grid: int
    smem: int
    f64: int

    @property
    def block(self) -> int:
        """Complex gram outputs a CTA computes (column mode)."""
        return self.K**2 // self.blocks

    @property
    def slots(self) -> int:
        """Partial grams in the workspace (0: none)."""
        return self.grid if self.parts > 1 else 0

    @property
    def counters(self) -> int:
        """Arrival counters the launch uses (one a gram block, 0: none)."""
        return self.grid // self.parts if self.parts > 1 else 0


def _pow2floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def batch_bwd_geometry(E: int, A: int, K: int, B: int, per_element: bool,
                       f64: bool) -> BatchBwdGeometry:
    """The batch backward's launch for ``E`` elements of the ``(2, A, K, B)``
    window view: a pure function of the shapes, so the order of every sum,
    and the gradient's bits, are too."""
    esize = 8 if f64 else 4
    C, KK = A * B, K * K
    Q = E * C
    wbytes = 2 * KK * esize  # one window
    col = 4 * (K + 1) * esize  # one column of g and x, Re and Im, with the kernel's pad
    tc_fit = _pow2floor(_BWD_TILE_BYTES // col) if col <= _BWD_TILE_BYTES else 0
    tc_par = _pow2floor(Q // _BWD_TARGET)  # tiles enough to fill the card
    w_stride = 2 * KK if per_element else 0
    if per_element and KK <= _BWD_BLOCK and C <= tc_fit and wbytes <= _BWD_W_BYTES:
        group = min(_BWD_BLOCK // KK, tc_fit // C, _pow2floor(_BWD_W_BYTES // wbytes),
                    max(1, tc_par // C))
        tc = group * C
        return BatchBwdGeometry(E, A, K, B, w_stride, tc, 1, 1, 1, group, 1, 1, -(-E // group),
                                group * wbytes + col * tc, int(f64))
    stage = int(tc_fit > 0)
    tc = min(tc_fit, tc_par) if stage else min(tc_par, C)
    groups, cols = (E, C) if per_element else (1, Q)
    tc = min(tc, C) if per_element else tc
    blocks = max(1, KK // _BWD_BLOCK)
    ntiles = -(-cols // tc)
    parts = min(ntiles, _BWD_TARGET, max(1, _BWD_FINAL // (2 * KK // blocks)),
                -(-_BWD_TARGET // (groups * blocks)))
    tpc = -(-ntiles // parts)
    parts = -(-ntiles // tpc)
    w_smem = int(wbytes <= _BWD_W_BYTES)
    return BatchBwdGeometry(E, A, K, B, w_stride, tc, tpc, parts, blocks, 0, stage, w_smem,
                            groups * blocks * parts, w_smem * wbytes + stage * col * tc,
                            int(f64))


_GEOM_ARGS: Dict[BatchBwdGeometry, ctypes.Array] = {}
# Partial grams and arrival counters of the batch backward, per (device,
# stream, dtype): launches on one stream run in order, so they share them.
_BWD_WORKSPACES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _bwd_workspace(device: torch.device, stream: int, dtype: torch.dtype,
                   numel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device, stream, dtype)
    ws, cnt = _BWD_WORKSPACES.get(key, (None, None))
    if cnt is None:
        cnt = torch.zeros(_BWD_COUNTERS, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < numel:
        ws = torch.empty(max(numel, 1), dtype=dtype, device=device)
    _BWD_WORKSPACES[key] = ws, cnt
    return ws, cnt


def _on_device(t: torch.Tensor):
    """``torch.cuda.device(t.device)``, or nothing when it is current."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _launch_bwd_batch(name, w2, g, x, a, k, n):
    """One batched backward ``qml_<name>(geometry, w, g, x, gp, gw, ws,
    counters, stream)`` (float32 or float64 throughout): ``gp`` and ``gw``
    (one gram an element for a per-element window, their sum for a shared
    one)."""
    K = 2**k
    stride = _batch_window(name, x, w2, K, n)
    _check(name, "cotangent", g, tuple(x.shape), (x.dtype,))
    geom = batch_bwd_geometry(x.shape[1], 2**a, K, 2 ** (n - a - k), stride != 0,
                              x.dtype == torch.float64)
    args = _GEOM_ARGS.get(geom)
    if args is None:
        args = _GEOM_ARGS[geom] = (ctypes.c_longlong * len(geom))(*geom)
    lib = _load()
    gp = torch.empty_like(x)
    gw = torch.empty_like(w2)
    with _on_device(x):
        stream = _stream(x)
        ws, cnt = _bwd_workspace(x.device, stream, x.dtype, geom.slots * 2 * geom.block)
        code = getattr(lib, f"qml_{name}")(
            args, w2.data_ptr(), g.data_ptr(), x.data_ptr(), gp.data_ptr(), gw.data_ptr(),
            ws.data_ptr(), cnt.data_ptr(), stream)
    _raise_on(name, code)
    LAUNCHES[name] += 1
    return gp, gw


def _check_rotation(name, r, n):
    if not 1 <= r < n:
        raise ValueError(f"{name}: r={r} out of range for n={n}")


def _launch_rotmat_apply(psi2, w2, r, n):
    _check_rotation("rotmat_apply", r, n)
    return _launch_window("rotmat_apply", psi2, w2, 2**r, n, (2**r, 2 ** (n - r)), split_w=True)


def _launch_matrot_apply(psi2, w2, r, n):
    _check_rotation("matrot_apply", r, n)
    K = 2 ** (n - r)
    return _launch_window("matrot_apply", psi2, w2, K, n, (K, 2**r), split_w=True)


def _check_rotwin(name, w2, r, k, n):
    if not 1 <= r < k < n:
        raise ValueError(f"{name}: needs 1 <= r < k < n, got r={r} k={k} n={n}")
    _check(name, "window", w2, (2, 2**k, 2**k))


def _rotwin_wperm(w2, r, k):
    """``(2, K, K)`` -> the same window with column ``l*A + a`` moved to
    ``a*L + l`` (``L = 2**r``, ``A = 2**(k-r)``): the order in which the
    rotwin kernels walk the pre-rotation state (reference ``_rotwin_wperm``)."""
    K, L = 2**k, 2**r
    return w2.reshape(2, K, L, K // L).transpose(2, 3).reshape(2, K, K).contiguous()


def _rotwin_wunperm(wp, r, k):
    """Inverse of :func:`_rotwin_wperm` (reference ``_rotwin_wunperm``)."""
    K, L = 2**k, 2**r
    return wp.reshape(2, K, K // L, L).transpose(2, 3).reshape(2, K, K)


def _launch_rotwin_apply(psi2, w2, r, k, n):
    _check_rotwin("rotwin_apply", w2, r, k, n)
    return _launch_window("rotwin_apply", psi2, _rotwin_wperm(w2, r, k), 2**k, n,
                          (2**k, 2 ** (n - k), 2**r), split_w=True)


def _launch_rotate(psi2, r, n):
    _check_rotation("rotate", r, n)
    if kernels.is_batched(psi2):
        _check("rotate", "state", psi2, (2, psi2.shape[1], 2**n), _BATCH_DTYPES)
        y = torch.empty_like(psi2)
        with torch.cuda.device(psi2.device):
            code = _load().qml_rotate_batch(psi2.data_ptr(), y.data_ptr(), 2 * psi2.shape[1],
                                            2 ** (n - r), 2**r, _f64(psi2), _stream(psi2))
        _raise_on("rotate", code)
        LAUNCHES["rotate"] += 1
        return y
    _check("rotate", "state", psi2, (2, 2**n), _COTANGENT_DTYPES)
    lib = _load()
    fn = lib.qml_rotate if psi2.dtype == torch.float32 else lib.qml_rotate_b16
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = fn(psi2.data_ptr(), y.data_ptr(), 2 ** (n - r), 2**r, _stream(psi2))
    _raise_on("rotate", code)
    LAUNCHES["rotate"] += 1
    return y


def _launch_bwd(name, w2, g, x, K, n, splits, out_dtype, geometry):
    """One backward window kernel ``qml_<name>(w, g, x, gp, gw, ws,
    *geometry, splits, g_bf16, gp_bf16, stream)``: allocates ``gp`` (in
    *out_dtype*), ``gw`` and the split-gram workspace; returns ``(gp, gw)``."""
    _check(name, "window", w2, (2, K, K))
    _check(name, "cotangent", g, (2, 2**n), _COTANGENT_DTYPES)
    _check(name, "saved state", x, (2, 2**n))
    _check_out_dtype(name, out_dtype)
    lib = _load()
    gp = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    gw = torch.empty_like(w2)
    ws = torch.empty((splits, 2, K, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = getattr(lib, f"qml_{name}")(
            w2.data_ptr(), g.data_ptr(), x.data_ptr(), gp.data_ptr(), gw.data_ptr(),
            ws.data_ptr(), *geometry, splits,
            int(g.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), _stream(x),
        )
    _raise_on(name, code)
    LAUNCHES[name] += 1
    return gp, gw


# ---------------------------------------------------------------------------
# Autograd: per-kernel backwards, as the JAX package's custom VJPs
# ---------------------------------------------------------------------------


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors (else the batch
    forward launches without an autograd Function around it)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _WindowFn(torch.autograd.Function):
    """``y = launch(psi2, w2, *geom)`` whose backward is the backward kernel
    ``bwd(w2, g, psi2, *geom, float32)``."""

    @staticmethod
    def forward(ctx, psi2, w2, launch, bwd, *geom):
        ctx.save_for_backward(psi2, w2)
        ctx.bwd, ctx.geom = bwd, geom
        return launch(psi2, w2, *geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psi2, w2 = ctx.saved_tensors
        out = torch.float64 if psi2.dtype == torch.float64 else torch.float32
        gp, gw = ctx.bwd(w2, g.to(psi2.dtype).contiguous(), psi2, *ctx.geom, out)
        return (gp, gw, None, None) + (None,) * len(ctx.geom)


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi2, r, n):
        ctx.geom = (r, n)
        return _launch_rotate(psi2, r, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        r, n = ctx.geom
        return rotate(g.contiguous(), (n - r) % n, n), None, None


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def window_apply(psi2: torch.Tensor, w2: torch.Tensor, a: int, k: int, n: int) -> torch.Tensor:
    """``y[a,i,b] = sum_j W[i,j] x[a,j,b]`` on the ``(2, A, K, B)`` view of the
    real-split state, support ``[a, a+k)`` with ``B = 2**(n-a-k) > 1``."""
    if _on_cpu(psi2, w2):
        return kernels.window_apply_plain(psi2, w2, a, k, n)
    if _single(psi2):
        return window_apply(psi2.unsqueeze(1), w2, a, k, n).squeeze(1)
    if kernels.is_batched(psi2):
        if not _needs_grad(psi2, w2):
            return _launch_window_apply_batch(psi2, w2, a, k, n)
        return _WindowFn.apply(psi2, w2, _launch_window_apply_batch, window_apply_bwd, a, k, n)
    return _WindowFn.apply(psi2, w2, _launch_window_apply, window_apply_bwd, a, k, n)


def window_apply_top(psi2: torch.Tensor, w2: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``y[a,i] = sum_j x[a,j] W[i,j]`` for a window on ``[n-k, n)``."""
    if _on_cpu(psi2, w2):
        return kernels.window_apply_top_plain(psi2, w2, k, n)
    if _single(psi2):
        return window_apply_top(psi2.unsqueeze(1), w2, k, n).squeeze(1)
    if kernels.is_batched(psi2):
        if not _needs_grad(psi2, w2):
            return _launch_window_apply_top_batch(psi2, w2, k, n)
        return _WindowFn.apply(psi2, w2, _launch_window_apply_top_batch, window_apply_top_bwd,
                               k, n)
    return _WindowFn.apply(psi2, w2, _launch_window_apply_top, window_apply_top_bwd, k, n)


def rotate(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation q -> (q + r) mod n, ``1 <= r < n``: the
    transpose ``(2, X, R) -> (2, R, X)`` with ``R = 2**r``.  On the card the
    state is float32 or bfloat16 (a cotangent of the saved backward)."""
    if _on_cpu(psi2):
        return kernels.rotate_plain(psi2, r, n)
    if _single(psi2):
        return rotate(psi2.unsqueeze(1), r, n).squeeze(1)
    return _Rotate.apply(psi2, r, n)


def rotmat_apply(psi2: torch.Tensor, w2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """The rotation by ``r``, then the window on ``[0, r)``, in one pass:
    ``y (2, K, X) = W x_pre (2, X, K)^T``, ``K = 2**r``."""
    if _on_cpu(psi2, w2):
        return kernels.rotmat_apply_plain(psi2, w2, r, n)
    return _WindowFn.apply(psi2, w2, _launch_rotmat_apply, rotmat_apply_bwd, r, n)


def matrot_apply(psi2: torch.Tensor, w2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """The window on ``[0, n-r)``, then the rotation by ``r``, in one pass:
    ``y (2, B, K) = (W x (2, K, B))^T``, ``K = 2**(n-r)``, ``B = 2**r``."""
    if _on_cpu(psi2, w2):
        return kernels.matrot_apply_plain(psi2, w2, r, n)
    return _WindowFn.apply(psi2, w2, _launch_matrot_apply, matrot_apply_bwd, r, n)


def rotwin_apply(psi2: torch.Tensor, w2: torch.Tensor, r: int, k: int, n: int) -> torch.Tensor:
    """The rotation by ``r``, then the window on ``[0, k)``, ``k > r``, in one
    pass."""
    if _on_cpu(psi2, w2):
        return kernels.rotwin_apply_plain(psi2, w2, r, k, n)
    return _WindowFn.apply(psi2, w2, _launch_rotwin_apply, rotwin_apply_bwd, r, k, n)


def window_apply_bwd(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, a: int, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`window_apply`: ``(gp, gw)`` with ``gp = W^† g`` in
    *out_dtype* and ``gw = sum g conj(x)^T`` over the ``A*B`` columns in
    float32.  ``g`` may be bfloat16."""
    if _on_cpu(w2, g, x):
        return kernels.window_apply_bwd_plain(w2, g, x, a, k, n, out_dtype)
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"window_apply_bwd: support [{a}, {a + k}) needs B > 1 in n={n}")
    if _single(x):
        gp, gw = window_apply_bwd(w2, g.unsqueeze(1), x.unsqueeze(1), a, k, n, out_dtype)
        return gp.squeeze(1), gw
    if kernels.is_batched(x):
        _check_out_dtype_batch("window_apply_bwd_batch", x, out_dtype)
        return _launch_bwd_batch("window_apply_bwd_batch", w2, g, x, a, k, n)
    K = 2**k
    return _launch_bwd("window_apply_bwd", w2, g, x, K, n, gram_splits(K, 2**n // K),
                       out_dtype, (2**a, K, 2 ** (n - a - k)))


def window_apply_top_bwd(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`window_apply_top`: ``gp = g conj(W)`` in
    *out_dtype* and ``gw[i,j] = sum_t g[t,i] conj(x[t,j])`` in float32."""
    if _on_cpu(w2, g, x):
        return kernels.window_apply_top_bwd_plain(w2, g, x, k, n, out_dtype)
    if not 1 <= k <= n:
        raise ValueError(f"window_apply_top_bwd: k={k} out of range for n={n}")
    if _single(x):
        gp, gw = window_apply_top_bwd(w2, g.unsqueeze(1), x.unsqueeze(1), k, n, out_dtype)
        return gp.squeeze(1), gw
    if kernels.is_batched(x):
        _check_out_dtype_batch("window_apply_top_bwd_batch", x, out_dtype)
        return _launch_bwd_batch("window_apply_top_bwd_batch", w2, g, x, n - k, k, n)
    A = 2 ** (n - k)
    return _launch_bwd("window_apply_top_bwd", w2, g, x, 2**k, n, gram_splits(2**k, A),
                       out_dtype, (A, 2**k))


def rotmat_apply_bwd(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`rotmat_apply` from the saved pre-rotation input
    ``x``: ``gp`` (pre-rotation layout, *out_dtype*) and ``gw`` (float32)."""
    if _on_cpu(w2, g, x):
        return kernels.rotmat_apply_bwd_plain(w2, g, x, r, n, out_dtype)
    _check_rotation("rotmat_apply_bwd", r, n)
    K, X = 2**r, 2 ** (n - r)
    return _launch_bwd("rotmat_apply_bwd", w2, g, x, K, n, gram_splits(K, X), out_dtype, (K, X))


def matrot_apply_bwd(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`matrot_apply` from the saved input ``x``."""
    if _on_cpu(w2, g, x):
        return kernels.matrot_apply_bwd_plain(w2, g, x, r, n, out_dtype)
    _check_rotation("matrot_apply_bwd", r, n)
    K, B = 2 ** (n - r), 2**r
    return _launch_bwd("matrot_apply_bwd", w2, g, x, K, n, gram_splits(K, B), out_dtype, (K, B))


def rotwin_apply_bwd(
    w2: torch.Tensor, g: torch.Tensor, x: torch.Tensor, r: int, k: int, n: int,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`rotwin_apply` from the saved pre-rotation input
    ``x``; the kernel's matrix cotangent is unpermuted here."""
    if _on_cpu(w2, g, x):
        return kernels.rotwin_apply_bwd_plain(w2, g, x, r, k, n, out_dtype)
    _check_rotwin("rotwin_apply_bwd", w2, r, k, n)
    K, X = 2**k, 2 ** (n - k)
    gp, gw = _launch_bwd("rotwin_apply_bwd", _rotwin_wperm(w2, r, k), g, x, K, n,
                         gram_splits(K, X), out_dtype, (K, X, 2**r))
    return gp, _rotwin_wunperm(gw, r, k)


# ---------------------------------------------------------------------------
# The adjoint-state backward's kernels (no autograd: called inside a backward)
# ---------------------------------------------------------------------------


def _launch_adjoint(name, w2, psi2, lam2, K, n, lam_dtype, splits, geometry):
    """One adjoint step ``qml_<name>(w, psi, lam, psi_prev, lam_prev, gw,
    ws, *geometry, splits, lam_bf16, out_bf16, stream)``: checks, allocates
    (psi_prev, lam_prev, gw) and the gram workspace (the split partials, then
    G0), launches, counts; returns the three outputs."""
    _check(name, "window", w2, (2, K, K))
    _check(name, "state", psi2, (2, 2**n))
    _check(name, "cotangent", lam2, (2, 2**n), _COTANGENT_DTYPES)
    _check_out_dtype(name, lam_dtype)
    lib = _load()
    psi_prev = torch.empty_like(psi2)
    lam_prev = torch.empty(psi2.shape, dtype=lam_dtype, device=psi2.device)
    gw = torch.empty_like(w2)
    ws = torch.empty((splits + 1, 2, K, K), dtype=torch.float32, device=psi2.device)
    with torch.cuda.device(psi2.device):
        code = getattr(lib, f"qml_{name}")(
            w2.data_ptr(), psi2.data_ptr(), lam2.data_ptr(), psi_prev.data_ptr(),
            lam_prev.data_ptr(), gw.data_ptr(), ws.data_ptr(), *geometry, splits,
            int(lam2.dtype == torch.bfloat16), int(lam_dtype == torch.bfloat16), _stream(psi2),
        )
    _raise_on(name, code)
    LAUNCHES[name] += 1
    return psi_prev, lam_prev, gw


def adjoint_step(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, a: int, k: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One adjoint-state backward step on the window ``[a, a+k)``, ``a + k <
    n``: from the step's output state ``psi2`` and its cotangent ``lam2``
    (float32 or bfloat16) returns ``psi_prev = W^† psi``, ``lam_prev = W^†
    lam`` in *lam_dtype* and ``gw = sum lam psi_prev^†`` in float32."""
    if _on_cpu(w2, psi2, lam2):
        return kernels.adjoint_step_plain(w2, psi2, lam2, a, k, n, lam_dtype)
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"adjoint_step: support [{a}, {a + k}) needs B > 1 in n={n}")
    K = 2**k
    return _launch_adjoint("adjoint_step", w2, psi2, lam2, K, n, lam_dtype,
                           gram_splits(K, 2**n // K), (2**a, K, 2 ** (n - a - k)))


def adjoint_step_top(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, k: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One adjoint-state backward step on the top window ``[n-k, n)``:
    ``psi_prev = psi conj(W)``, ``lam_prev = lam conj(W)`` in *lam_dtype*,
    ``gw[i, j] = sum_t lam[t, i] conj(psi_prev[t, j])`` in float32."""
    if _on_cpu(w2, psi2, lam2):
        return kernels.adjoint_step_top_plain(w2, psi2, lam2, k, n, lam_dtype)
    if not 1 <= k <= n:
        raise ValueError(f"adjoint_step_top: k={k} out of range for n={n}")
    K, A = 2**k, 2 ** (n - k)
    return _launch_adjoint("adjoint_step_top", w2, psi2, lam2, K, n, lam_dtype,
                           gram_splits(K, A), (A, K))


def adjoint_rotmat(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint-state step of a rotmat step (rotation by ``r``, window on
    ``[0, r)``): from its output ``psi2`` and cotangent ``lam2`` (post-rotation
    layout) returns the step's input ``psi_in``, ``lam_in`` in *lam_dtype*
    (pre-rotation layout) and ``gw = sum lam psi_mid^†`` in float32."""
    if _on_cpu(w2, psi2, lam2):
        return kernels.adjoint_rotmat_plain(w2, psi2, lam2, r, n, lam_dtype)
    _check_rotation("adjoint_rotmat", r, n)
    K, X = 2**r, 2 ** (n - r)
    return _launch_adjoint("adjoint_rotmat", w2, psi2, lam2, K, n, lam_dtype,
                           gram_splits(K, X), (K, X))


def adjoint_matrot(
    w2: torch.Tensor, psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int,
    lam_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint-state step of a matrot step (window on ``[0, n-r)``, then
    the rotation by ``r``): the step's input ``psi_in``, ``lam_in`` in
    *lam_dtype* and ``gw`` in float32 from its output and cotangent."""
    if _on_cpu(w2, psi2, lam2):
        return kernels.adjoint_matrot_plain(w2, psi2, lam2, r, n, lam_dtype)
    _check_rotation("adjoint_matrot", r, n)
    K, B = 2 ** (n - r), 2**r
    return _launch_adjoint("adjoint_matrot", w2, psi2, lam2, K, n, lam_dtype,
                           gram_splits(K, B), (K, B))


def rotate_pair(
    psi2: torch.Tensor, lam2: torch.Tensor, r: int, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate a state (float32) and its cotangent (float32 or bfloat16) by
    ``q -> (q + r) mod n``, ``1 <= r < n``, in one launch; each keeps its
    dtype and every bit."""
    if _on_cpu(psi2, lam2):
        return kernels.rotate_pair_plain(psi2, lam2, r, n)
    _check_rotation("rotate_pair", r, n)
    _check("rotate_pair", "state", psi2, (2, 2**n))
    _check("rotate_pair", "cotangent", lam2, (2, 2**n), _COTANGENT_DTYPES)
    lib = _load()
    psi_out, lam_out = torch.empty_like(psi2), torch.empty_like(lam2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_rotate_pair(
            psi2.data_ptr(), psi_out.data_ptr(), lam2.data_ptr(), lam_out.data_ptr(),
            2 ** (n - r), 2**r, int(lam2.dtype == torch.bfloat16), _stream(psi2),
        )
    _raise_on("rotate_pair", code)
    LAUNCHES["rotate_pair"] += 1
    return psi_out, lam_out


# ---------------------------------------------------------------------------
# Chain steps (``ops/chains.py``): one launch per step, B17 and B18
# ---------------------------------------------------------------------------

# CTAs in the thread-block cluster that takes one block of a chain step, by
# kernel.  One CTA an SM (~205 KB of shared memory): an H100 holds 15
# clusters of 8 or 30 of 4.  On the 24q chain plan B17, one cluster a block,
# ran 3-5 % faster with 8; B18, whose clusters each walk their set of
# blocks, 3-5 % faster with 4 (a CTA takes twice a descriptor's tiles).
_CHAIN_RANKS = {"chain_apply": 8, "adjoint_chain": 4}

# Columns of an H-geometry block (its rows are the 256 values of state bits
# [n-8, n)): 2^16 amplitudes, as many as 16 tiles of a K = 256 window.
_CHAIN_COLS = 256

# Descriptor table fields (``csrc/chain_block.cuh``).
_CHAIN_DESC = 8
_ROWS, _MINOR, _DIAG = 0, 1, 2


class _ChainTable(NamedTuple):
    """A step's descriptor table on the device and the host, the floats of a
    cluster's gram slot and of the split workspace, and the largest K^2."""
    dev: torch.Tensor
    host: torch.Tensor
    slot: int
    split: int
    max_kk: int


# Descriptor tables already on a device, by (geom, descs, n, device).
_chain_tables: Dict[tuple, _ChainTable] = {}

# Clusters of each chain kernel the card holds at once, by (kernel, device).
_chain_active: Dict[tuple, int] = {}


def chain_active_clusters(name: str, device: torch.device) -> int:
    """Clusters of ``_CHAIN_RANKS[name]`` CTAs of the chain kernel *name*
    (``chain_apply`` or ``adjoint_chain``) that the card holds at once, at
    the kernel's shared memory (``cudaOccupancyMaxActiveClusters``); raises
    when the card holds none."""
    key = (name, torch.device(device))
    ranks = _CHAIN_RANKS[name]
    if key not in _chain_active:
        with torch.cuda.device(key[1]):
            count = getattr(_load(), f"qml_{name}_clusters")(ranks)
        if count <= 0:
            raise RuntimeError(f"{name}: the card holds no cluster of {ranks} CTAs at the "
                               f"kernel's shared memory (code {count})")
        _chain_active[key] = count
    return _chain_active[key]


def chain_geometry_fits(geom: tuple, n: int) -> bool:
    """Whether the chain kernels take a step of geometry *geom* at *n*
    qubits: an L block of 10 or more low bits, short of the whole state, or
    H rows of 8 bits over at least 128 columns."""
    kind, span = geom
    if kind == "L":
        return 10 <= span < n
    return kind == "H" and span == 8 and n - span >= 7


def _chain_blocks(name: str, geom: tuple, n: int) -> Tuple[int, int, int, int, int]:
    """The step's blocks as ``(count, size, stride, hi_stride, split)``: a
    block-local index l lies at flat ``g * stride + (l >> split) * hi_stride
    + (l & (2**split - 1))``."""
    if not chain_geometry_fits(geom, n):
        raise ValueError(f"{name}: geometry {geom} does not apply at n={n}")
    span = geom[1]
    if geom[0] == "L":
        return 2 ** (n - span), 2**span, 2**span, 0, span
    cols = min(_CHAIN_COLS, 2 ** (n - span))
    split = cols.bit_length() - 1
    return 2 ** (n - span) // cols, 2**span * cols, cols, 2 ** (n - span), split


def _chain_table(name: str, geom: tuple, descs: tuple, n: int) -> Tuple[list, int, int, int]:
    """The descriptor table rows (``csrc/chain_block.cuh``), the size of a
    cluster's gram slot and of the split workspace in floats, and the
    largest window's K^2; raises on a descriptor the kernels do not take.  A
    window's RUN is the state's contiguous run along its columns (along its
    depth for a minor window, llo = 0), which picks its product by the
    kernels' shape rule."""
    count, size, stride, hi_stride, split = _chain_blocks(name, geom, n)
    low = 0 if geom[0] == "L" else n - geom[1]  # the state bit at the block's local bit `split`
    top = geom[1] if geom[0] == "L" else n
    rows, poff, goff, soff, max_kk = [], 0, 0, 0, 0
    for d in descs:
        if d[0] == "win":
            lo, hi = int(d[1]), int(d[2])
            if not low <= lo < hi <= top:
                raise ValueError(f"{name}: window on bits [{lo}, {hi}) outside geometry {geom}")
            llo = lo if geom[0] == "L" else lo - low + split
            K = 2 ** (hi - lo)
            run = 2 ** min(hi - lo if llo == 0 else llo, split)
            rows.append([_MINOR if llo == 0 else _ROWS, llo, hi - lo, 0, poff, goff, soff, run])
            poff += 2 * K * K
            goff += 2 * K * K
            soff += 4 * K * K
            max_kk = max(max_kk, K * K)
        elif d[0] == "diag":
            bits = [int(b) for b in d[1]]
            if not (1 <= len(bits) <= 2 and all(0 <= b < n for b in bits)
                    and bits == sorted(set(bits), reverse=True)):
                raise ValueError(f"{name}: diagonal on bits {tuple(bits)} (1-2 bits, descending)")
            V = 2 ** len(bits)
            rows.append([_DIAG, len(bits), bits[0], bits[-1], poff, goff, 0, 0])
            poff += 2 * V
            goff += _CHAIN_RANKS["adjoint_chain"] * 2 * V
        else:
            raise ValueError(f"{name}: unknown descriptor {d!r}")
    if not rows:
        raise ValueError(f"{name}: a chain step needs at least one descriptor")
    return rows, goff, soff, max_kk


def _chain_operands(name, psi2, payloads, geom, descs, n):
    """Checks the state and payloads; returns (table, packed payloads,
    blocks)."""
    _check(name, "state", psi2, (2, 2**n))
    if len(payloads) != len(descs):
        raise ValueError(f"{name}: {len(payloads)} payloads for {len(descs)} descriptors")
    for d, p in zip(descs, payloads):
        side = 2 ** (d[2] - d[1]) if d[0] == "win" else None
        shape = (2, side, side) if d[0] == "win" else (2, 2 ** len(d[1]))
        _check(name, f"payload of {d}", p, shape)
        if p.device != psi2.device:
            raise ValueError(f"{name}: payload of {d} on {p.device}, state on {psi2.device}")
    key = (geom, descs, n, psi2.device)
    if key not in _chain_tables:
        rows, slot, split, max_kk = _chain_table(name, geom, descs, n)
        host = torch.tensor(rows, dtype=torch.int64)
        _chain_tables[key] = _ChainTable(host.to(psi2.device), host, slot, split, max_kk)
    packed = torch.cat([p.reshape(-1) for p in payloads])
    return _chain_tables[key], packed, _chain_blocks(name, geom, n)


def _refuse_gradient(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no autograd backward: a gradient through a chain step "
                           "runs adjoint_chain (the adjoint executor) or the step's expansion")


def chain_apply(
    psi2: torch.Tensor, payloads, geom: tuple, descs: tuple, n: int
) -> torch.Tensor:
    """One chain step (``ops/chains.py``): the descriptors ``("win", lo,
    hi)`` (a ``(2, K, K)`` payload on state bits ``[lo, hi)``) and ``("diag",
    bits)`` (a ``(2, 2**len(bits))`` payload indexed by the bits, MSB first)
    applied in order, in one launch on the card."""
    if _on_cpu(psi2, *payloads):
        return kernels.chain_apply_plain(psi2, payloads, geom, descs, n)
    _refuse_gradient("chain_apply", psi2, *payloads)
    tab, packed, blocks = _chain_operands("chain_apply", psi2, payloads, geom, descs, n)
    lib = _load()
    y = torch.empty_like(psi2)
    ws = torch.empty_like(psi2) if len(descs) > 1 else y
    vs = torch.empty(max(tab.split, 1), dtype=torch.float32, device=psi2.device)
    with torch.cuda.device(psi2.device):
        code = lib.qml_chain_apply(
            psi2.data_ptr(), y.data_ptr(), ws.data_ptr(), packed.data_ptr(), vs.data_ptr(),
            tab.dev.data_ptr(), tab.host.data_ptr(), len(descs), 2**n, *blocks,
            _CHAIN_RANKS["chain_apply"], tab.max_kk, _stream(psi2))
    _raise_on("chain_apply", code)
    LAUNCHES["chain_apply"] += 1
    return y


def chain_clusters(blocks: int, slot_floats: int, active: int) -> int:
    """Clusters of the chain adjoint: as many as the card holds at once
    (*active*), within ``_GRAM_MAX_WS`` bytes of gram slots and at most one
    a block.  Cluster c walks blocks c, c + clusters, ...: a count that
    divided the blocks would leave up to half the card idle (an H100 holds
    30 clusters of 4 CTAs at the kernel's shared memory, 16 of which divide
    128 and 256 blocks), so some clusters walk one block more.  The gram's
    order of sums follows from the count: fixed for a card."""
    return max(1, min(blocks, active, _GRAM_MAX_WS // (4 * slot_floats)))


def adjoint_chain(
    psi2: torch.Tensor, lam2: torch.Tensor, payloads, geom: tuple, descs: tuple, n: int
) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """The adjoint-state backward of a chain step: from its output ``psi2``
    and cotangent ``lam2`` (float32 on the card) returns the step's input,
    its cotangent (float32) and one cotangent per descriptor, ``gw = G0 W``
    for a window and ``gd = d G0`` for a diagonal (``G0`` the gram on the
    output side), in one launch and a fixed-order reduction."""
    if _on_cpu(psi2, lam2, *payloads):
        return kernels.adjoint_chain_plain(psi2, lam2, payloads, geom, descs, n)
    _check("adjoint_chain", "cotangent", lam2, (2, 2**n))
    tab, packed, blocks = _chain_operands("adjoint_chain", psi2, payloads, geom, descs, n)
    clusters = chain_clusters(blocks[0], tab.slot,
                              chain_active_clusters("adjoint_chain", psi2.device))
    lib = _load()
    psi_out, lam_out = torch.empty_like(psi2), torch.empty_like(psi2)
    two = len(descs) > 1
    ws_psi = torch.empty_like(psi2) if two else psi_out
    ws_lam = torch.empty_like(psi2) if two else lam_out
    grads = torch.empty_like(packed)
    vs = torch.empty(max(tab.split, 1), dtype=torch.float32, device=psi2.device)
    slots = torch.empty(clusters * tab.slot, dtype=torch.float32, device=psi2.device)
    red = torch.empty(tab.slot, dtype=torch.float32, device=psi2.device)
    with torch.cuda.device(psi2.device):
        code = lib.qml_adjoint_chain(
            psi2.data_ptr(), lam2.data_ptr(), psi_out.data_ptr(), lam_out.data_ptr(),
            ws_psi.data_ptr(), ws_lam.data_ptr(), packed.data_ptr(), vs.data_ptr(),
            grads.data_ptr(), tab.dev.data_ptr(), tab.host.data_ptr(), len(descs), 2**n,
            *blocks, _CHAIN_RANKS["adjoint_chain"], clusters, slots.data_ptr(), red.data_ptr(),
            tab.slot,
            tab.max_kk, _stream(psi2))
    _raise_on("adjoint_chain", code)
    LAUNCHES["adjoint_chain"] += 1
    parts = torch.split(grads, [p.numel() for p in payloads])
    return psi_out, lam_out, tuple(g.view(p.shape) for g, p in zip(parts, payloads))
