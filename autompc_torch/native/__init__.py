"""Native (C++) random-forest surrogate with ctypes bindings (port of
``autompc_tpu/native/__init__.py``; ``rf.cpp`` is the port's own copy of
the same source).

The forest is host code: the batched BO tuner refits it between device
batches (``tuning/bo.py``). The shared library is built with ``g++`` at
first use into ``autompc_torch/_build/librf_<hash>.so`` (the hash of
the source and the flags, so a change rebuilds; written to a temporary
name and renamed, so concurrent processes never load a half-written
file), never next to the sources. ``make_forest`` falls back to the
pure-Python forest when no compiler is available, as the reference
does; ``NativeRandomForest.available()`` and ``build_error()`` say
which one a caller gets and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "rf.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librf_{h}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _error
    with _lock:
        if _lib_handle is not None or _error is not None:
            return _lib_handle
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
            return None
        lib.ampc_rf_fit.restype = ctypes.c_void_p
        lib.ampc_rf_fit.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_ulong,
        ]
        lib.ampc_rf_predict.restype = None
        lib.ampc_rf_predict.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.ampc_rf_free.restype = None
        lib.ampc_rf_free.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def build_error() -> Optional[str]:
    """Why the native forest is unavailable (None when it loaded or has
    not been tried)."""
    return _error


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeRandomForest:
    """ctypes wrapper over the C++ forest; API-compatible with
    ``tuning.bo.RandomForestSurrogate``."""

    def __init__(self, n_trees=24, max_depth=10, min_leaf=2, rng=None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        rng = rng or np.random.default_rng()
        self._seed = int(rng.integers(1 << 62))
        self._handle = None
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError(f"native RF library unavailable: {_error}")

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.ascontiguousarray(X, dtype=np.float64)
        y = np.ascontiguousarray(y, dtype=np.float64)
        n, d = X.shape
        self._free()
        self._handle = self._lib.ampc_rf_fit(
            _as_c(X), _as_c(y), n, d,
            self.n_trees, self.max_depth, self.min_leaf,
            ctypes.c_ulong(self._seed),
        )
        self._d = d
        return self

    def predict(self, X: np.ndarray):
        if self._handle is None:
            raise RuntimeError("fit before predict")
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, d = X.shape
        mean = np.empty(n, dtype=np.float64)
        std = np.empty(n, dtype=np.float64)
        self._lib.ampc_rf_predict(
            ctypes.c_void_p(self._handle), _as_c(X), n, d, _as_c(mean), _as_c(std)
        )
        return mean, std

    def _free(self):
        if self._handle is not None and self._lib is not None:
            self._lib.ampc_rf_free(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        try:
            self._free()
        except Exception:
            pass


def make_forest(n_trees=24, max_depth=10, min_leaf=2, rng=None, prefer_native=True):
    """Factory: the native C++ forest when buildable, the Python forest
    otherwise."""
    if prefer_native and NativeRandomForest.available():
        return NativeRandomForest(n_trees, max_depth, min_leaf, rng)
    from ..tuning.bo import RandomForestSurrogate

    return RandomForestSurrogate(n_trees, max_depth, min_leaf, rng)
