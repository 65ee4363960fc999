"""Hand-written CUDA kernels of the statevector hot path, and their wrappers.

Three kernels, compiled for Hopper (``sm_90a``) from ``csrc/`` with plain
``nvcc`` into one shared library with a C interface, loaded with ``ctypes``:

=================  ==========================  ===================================
wrapper            source                      replaces (JAX package)
=================  ==========================  ===================================
window_apply       csrc/window_apply.cu        pallas_kernels.window_apply_ri
window_apply_top   csrc/window_apply_top.cu    pallas_kernels.window_apply_top_ri
rotate             csrc/rotate.cu              pallas_kernels.rotate_ri
=================  ==========================  ===================================

The library is built at first use into ``build/kernels/`` at the repository
root and rebuilt whenever a source (or the compiler flags) changes: its file
name carries a hash of both.  Nothing is compiled or loaded at import time.

Each wrapper takes the plain PyTorch version in
:mod:`qml_essentials_tpu_torch.ops.kernels` for a tensor on the CPU, and only
then.  For a CUDA tensor it checks device, dtype (float32), shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to its
launch count.  It never falls back to the plain version on the card.  The
kernels have no backward yet, so a CUDA call that would need a gradient
raises ``NotImplementedError``: run forward passes on the card under
``torch.no_grad()`` / ``torch.inference_mode()``.
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

from qml_essentials_tpu_torch.ops import kernels

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("window_apply.cu", "window_apply_top.cu", "rotate.cu")
HEADERS = ("cgemm_tile.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"window_apply": 0, "window_apply_top": 0, "rotate": 0}

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


def build() -> Tuple[Path, float]:
    """Compile the kernels if the library for the current sources is missing.

    Returns ``(path, seconds spent compiling)`` (0.0 when it was up to date).
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, seconds


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.qml_window_apply.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
            lib.qml_window_apply_top.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
            lib.qml_rotate.argtypes = [ptr, ptr, i64, i64, ptr]
            for fn in (lib.qml_window_apply, lib.qml_window_apply_top, lib.qml_rotate):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Wrappers
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


def _check_cuda(name: str, psi2: torch.Tensor, n: int, w2: Optional[torch.Tensor] = None,
                K: Optional[int] = None) -> None:
    if torch.is_grad_enabled() and (
        psi2.requires_grad or (w2 is not None and w2.requires_grad)
    ):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; run forward passes "
            "on the card under torch.no_grad() or torch.inference_mode()"
        )
    for label, t in (("state", psi2), ("window", w2)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if tuple(psi2.shape) != (2, 2**n):
        raise ValueError(f"{name}: state shape {tuple(psi2.shape)} != (2, 2**{n})")
    if w2 is not None and tuple(w2.shape) != (2, K, K):
        raise ValueError(f"{name}: window shape {tuple(w2.shape)} != (2, {K}, {K})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}")


def window_apply(psi2: torch.Tensor, w2: torch.Tensor, a: int, k: int, n: int) -> torch.Tensor:
    """``y[a,i,b] = sum_j W[i,j] x[a,j,b]`` on the ``(2, A, K, B)`` view of the
    real-split state, support ``[a, a+k)`` with ``B = 2**(n-a-k) > 1``."""
    if _on_cpu(psi2, w2):
        return kernels.window_apply_plain(psi2, w2, a, k, n)
    if not (0 <= a and 1 <= k and a + k < n):
        raise ValueError(f"window_apply: support [{a}, {a + k}) needs B > 1 in n={n}")
    _check_cuda("window_apply", psi2, n, w2, 2**k)
    lib = _load()
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_window_apply(
            psi2.data_ptr(), w2.data_ptr(), y.data_ptr(),
            2**a, 2**k, 2 ** (n - a - k), _stream(psi2),
        )
    _raise_on("window_apply", code)
    LAUNCHES["window_apply"] += 1
    return y


def window_apply_top(psi2: torch.Tensor, w2: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``y[a,i] = sum_j x[a,j] W[i,j]`` for a window on ``[n-k, n)``."""
    if _on_cpu(psi2, w2):
        return kernels.window_apply_top_plain(psi2, w2, k, n)
    if not 1 <= k <= n:
        raise ValueError(f"window_apply_top: k={k} out of range for n={n}")
    _check_cuda("window_apply_top", psi2, n, w2, 2**k)
    lib = _load()
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_window_apply_top(
            psi2.data_ptr(), w2.data_ptr(), y.data_ptr(),
            2 ** (n - k), 2**k, _stream(psi2),
        )
    _raise_on("window_apply_top", code)
    LAUNCHES["window_apply_top"] += 1
    return y


def rotate(psi2: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Cyclic qubit rotation q -> (q + r) mod n, ``1 <= r < n``: the
    transpose ``(2, X, R) -> (2, R, X)`` with ``R = 2**r``."""
    if _on_cpu(psi2):
        return kernels.rotate_plain(psi2, r, n)
    if not 1 <= r < n:
        raise ValueError(f"rotate: r={r} out of range for n={n}")
    _check_cuda("rotate", psi2, n)
    lib = _load()
    y = torch.empty_like(psi2)
    with torch.cuda.device(psi2.device):
        code = lib.qml_rotate(
            psi2.data_ptr(), y.data_ptr(), 2 ** (n - r), 2**r, _stream(psi2)
        )
    _raise_on("rotate", code)
    LAUNCHES["rotate"] += 1
    return y
