"""Native (C++) host-side components, loaded via ctypes.

The pieces of the analysis stack that live on the *host* and are
combinatorial rather than numeric — the FourierTree leaf enumerator
(``leaf_enum.cpp``) — are compiled on first use with the system ``g++``
into ``build/native/`` at the repository root, never next to the source.
The library's file name carries a hash of the source and the flags, so an
edit rebuilds it; the compiler writes to a temporary file that is renamed
into place, so concurrent first uses do not read a half-written library.
Every native entry point has a pure-Python fallback (the FourierTree's own
walk), so a missing toolchain only costs speed.

Counterpart of ``qml_essentials_tpu/native/__init__.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "leaf_enum.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# Generic x86-64 code (no -march=native): the library may be built on one
# host and loaded on another that shares the checkout.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _LeafResult(ctypes.Structure):
    _fields_ = [
        ("S", ctypes.POINTER(ctypes.c_uint8)),
        ("C", ctypes.POINTER(ctypes.c_uint8)),
        ("term_re", ctypes.POINTER(ctypes.c_double)),
        ("term_im", ctypes.POINTER(ctypes.c_double)),
        ("n_leaves", ctypes.c_int64),
    ]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libleaf_enum_{digest[:16]}.so"


def _compile(path: Path) -> bool:
    """Build the shared library at *path* (no-op if present); returns success."""
    if path.is_file():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        log.info(f"native build unavailable ({exc}); using the Python enumeration")
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if not _compile(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            log.info(f"native load failed ({exc}); using the Python enumeration")
            _load_failed = True
            return None
        lib.qml_enumerate_leaves.argtypes = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.POINTER(_LeafResult),
        ]
        lib.qml_enumerate_leaves.restype = ctypes.c_int
        lib.qml_free_leaves.argtypes = [ctypes.POINTER(_LeafResult)]
        lib.qml_free_leaves.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the C++ leaf enumerator can be used on this host."""
    return _load() is not None


def enumerate_leaves(
    pauli_words,
    observable_word,
    n_qubits: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Run the native leaf enumeration for one observable root.

    Args:
        pauli_words: list of PauliWord rotation generators (tape order).
        observable_word: PauliWord of the root observable.
        n_qubits: register width (must be <= 64 for the packed encoding).

    Returns:
        ``(S, C, terms)`` with shapes ``(n_leaves, n_params)`` (int64) and
        ``(n_leaves,)`` complex128 — or ``None`` if the native path is
        unavailable/ineligible and the Python enumeration should run.
    """
    if n_qubits > 64:
        return None
    lib = _load()
    if lib is None:
        return None

    n_params = len(pauli_words)
    px = np.zeros(max(n_params, 1), dtype=np.uint64)
    pz = np.zeros(max(n_params, 1), dtype=np.uint64)
    pp = np.zeros(max(n_params, 1), dtype=np.int32)
    for i, w in enumerate(pauli_words):
        px[i], pz[i], pp[i] = w.xm, w.zm, w.phase
    ow = observable_word

    res = _LeafResult()
    rc = lib.qml_enumerate_leaves(
        px, pz, pp, np.int32(n_params),
        ctypes.c_uint64(ow.xm), ctypes.c_uint64(ow.zm), np.int32(ow.phase),
        ctypes.byref(res),
    )
    try:
        if rc != 0:  # allocation failure
            return None
        n_leaves = int(res.n_leaves)
        if n_leaves == 0:
            S = np.zeros((0, n_params), dtype=np.int64)
            C = np.zeros((0, n_params), dtype=np.int64)
            terms = np.zeros(0, dtype=np.complex128)
        else:
            shape = (n_leaves, n_params)
            S = np.ctypeslib.as_array(res.S, shape=shape).astype(np.int64)
            C = np.ctypeslib.as_array(res.C, shape=shape).astype(np.int64)
            re = np.ctypeslib.as_array(res.term_re, shape=(n_leaves,)).copy()
            im = np.ctypeslib.as_array(res.term_im, shape=(n_leaves,)).copy()
            terms = re + 1j * im
        return S, C, terms
    finally:
        lib.qml_free_leaves(ctypes.byref(res))
