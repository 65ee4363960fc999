"""Hand-written CUDA kernels of the statevector hot path, and their wrappers.

Five kernels, compiled for Hopper (``sm_90a``) from ``csrc/`` with plain
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
=====================  ============================  ======================================

The library is built at first use into ``build/kernels/`` at the repository
root and rebuilt whenever a source (or the compiler flags) changes: its file
name carries a hash of both.  Nothing is compiled or loaded at import time.

Each wrapper takes the plain PyTorch version in
:mod:`qml_essentials_tpu_torch.ops.kernels` for a tensor on the CPU, and only
then.  For a CUDA tensor it checks device, dtype, shape and contiguity,
allocates outputs (and the backward's split-reduction workspace) with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and adds one to its launch count.  It never falls back to
the plain version on the card.

Gradients: on the card the forward wrappers run through
``torch.autograd.Function``s whose backwards are kernels too, mirroring the
JAX package's per-kernel VJPs — the window's backward is
``window_apply_bwd``, the top window's ``window_apply_top_bwd``, and the
rotation's is the rotation by ``(n - r) % n``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from qml_essentials_tpu_torch.ops import kernels

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "window_apply.cu", "window_apply_bwd.cu", "window_apply_top.cu",
    "window_apply_top_bwd.cu", "rotate.cu",
)
HEADERS = ("cgemm_tile.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    "window_apply": 0, "window_apply_bwd": 0, "window_apply_top": 0,
    "window_apply_top_bwd": 0, "rotate": 0,
}

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
    the compiler's output is kept in ``BUILD_LOG``.
    """
    global BUILD_LOG
    path = library_path()
    if path.exists():
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
    os.replace(tmp, path)
    shutil.rmtree(objdir, ignore_errors=True)
    BUILD_LOG = log
    return path, seconds


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.qml_window_apply.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
            lib.qml_window_apply_bwd.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i32, i32, ptr]
            lib.qml_window_apply_top.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
            lib.qml_window_apply_top_bwd.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, ptr]
            lib.qml_rotate.argtypes = [ptr, ptr, i64, i64, ptr]
            lib.qml_rotate_b16.argtypes = [ptr, ptr, i64, i64, ptr]
            for fn in (lib.qml_window_apply, lib.qml_window_apply_bwd,
                       lib.qml_window_apply_top, lib.qml_window_apply_top_bwd,
                       lib.qml_rotate, lib.qml_rotate_b16):
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


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in _COTANGENT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def _launch_window_apply(psi2, w2, a, k, n):
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"window_apply: support [{a}, {a + k}) needs B > 1 in n={n}")
    K = 2**k
    _check("window_apply", "state", psi2, (2, 2**n))
    _check("window_apply", "window", w2, (2, K, K))
    lib = _load()
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_window_apply(
            psi2.data_ptr(), w2.data_ptr(), y.data_ptr(),
            2**a, K, 2 ** (n - a - k), _stream(psi2),
        )
    _raise_on("window_apply", code)
    LAUNCHES["window_apply"] += 1
    return y


def _launch_window_apply_top(psi2, w2, k, n):
    if not 1 <= k <= n:
        raise ValueError(f"window_apply_top: k={k} out of range for n={n}")
    K = 2**k
    _check("window_apply_top", "state", psi2, (2, 2**n))
    _check("window_apply_top", "window", w2, (2, K, K))
    lib = _load()
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_window_apply_top(
            psi2.data_ptr(), w2.data_ptr(), y.data_ptr(), 2 ** (n - k), K, _stream(psi2),
        )
    _raise_on("window_apply_top", code)
    LAUNCHES["window_apply_top"] += 1
    return y


def _launch_rotate(psi2, r, n):
    if not 1 <= r < n:
        raise ValueError(f"rotate: r={r} out of range for n={n}")
    _check("rotate", "state", psi2, (2, 2**n), _COTANGENT_DTYPES)
    lib = _load()
    fn = lib.qml_rotate if psi2.dtype == torch.float32 else lib.qml_rotate_b16
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = fn(psi2.data_ptr(), y.data_ptr(), 2 ** (n - r), 2**r, _stream(psi2))
    _raise_on("rotate", code)
    LAUNCHES["rotate"] += 1
    return y


def _check_bwd(name, w2, g, x, K, n, out_dtype):
    _check(name, "window", w2, (2, K, K))
    _check(name, "cotangent", g, (2, 2**n), _COTANGENT_DTYPES)
    _check(name, "saved state", x, (2, 2**n))
    _check_out_dtype(name, out_dtype)


# ---------------------------------------------------------------------------
# Autograd: per-kernel backwards, as the JAX package's custom VJPs
# ---------------------------------------------------------------------------


class _WindowApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi2, w2, a, k, n):
        ctx.save_for_backward(psi2, w2)
        ctx.geom = (a, k, n)
        return _launch_window_apply(psi2, w2, a, k, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psi2, w2 = ctx.saved_tensors
        gp, gw = window_apply_bwd(w2, g.contiguous(), psi2, *ctx.geom, torch.float32)
        return gp, gw, None, None, None


class _WindowApplyTop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi2, w2, k, n):
        ctx.save_for_backward(psi2, w2)
        ctx.geom = (k, n)
        return _launch_window_apply_top(psi2, w2, k, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psi2, w2 = ctx.saved_tensors
        gp, gw = window_apply_top_bwd(w2, g.contiguous(), psi2, *ctx.geom, torch.float32)
        return gp, gw, None, None


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
    return _WindowApply.apply(psi2, w2, a, k, n)


def window_apply_top(psi2: torch.Tensor, w2: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``y[a,i] = sum_j x[a,j] W[i,j]`` for a window on ``[n-k, n)``."""
    if _on_cpu(psi2, w2):
        return kernels.window_apply_top_plain(psi2, w2, k, n)
    return _WindowApplyTop.apply(psi2, w2, k, n)


def rotate(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation q -> (q + r) mod n, ``1 <= r < n``: the
    transpose ``(2, X, R) -> (2, R, X)`` with ``R = 2**r``.  On the card the
    state is float32 or bfloat16 (a cotangent of the saved backward)."""
    if _on_cpu(psi2):
        return kernels.rotate_plain(psi2, r, n)
    return _Rotate.apply(psi2, r, n)


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
    K = 2**k
    _check_bwd("window_apply_bwd", w2, g, x, K, n, out_dtype)
    C = 2**n // K
    splits = gram_splits(K, C)
    lib = _load()
    gp = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    gw = torch.empty_like(w2)
    ws = torch.empty((splits, 2, K, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.qml_window_apply_bwd(
            w2.data_ptr(), g.data_ptr(), x.data_ptr(), gp.data_ptr(), gw.data_ptr(),
            ws.data_ptr(), 2**a, K, 2 ** (n - a - k), splits,
            int(g.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), _stream(x),
        )
    _raise_on("window_apply_bwd", code)
    LAUNCHES["window_apply_bwd"] += 1
    return gp, gw


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
    K = 2**k
    _check_bwd("window_apply_top_bwd", w2, g, x, K, n, out_dtype)
    A = 2 ** (n - k)
    splits = gram_splits(K, A)
    lib = _load()
    gp = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    gw = torch.empty_like(w2)
    ws = torch.empty((splits, 2, K, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.qml_window_apply_top_bwd(
            w2.data_ptr(), g.data_ptr(), x.data_ptr(), gp.data_ptr(), gw.data_ptr(),
            ws.data_ptr(), A, K, splits,
            int(g.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), _stream(x),
        )
    _raise_on("window_apply_top_bwd", code)
    LAUNCHES["window_apply_top_bwd"] += 1
    return gp, gw
