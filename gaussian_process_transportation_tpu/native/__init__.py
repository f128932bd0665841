"""Native (C++) host-runtime kernels with pure-numpy fallbacks.

The reference repo ships no native code (SURVEY.md §0: its CMakeLists.txt
is ROS packaging only), so there is nothing to port — these kernels
accelerate THIS framework's own host-side sequential paths that are a poor
fit for XLA.  Current kernels:

- ``cart_best_split``: the greedy variance-reduction split search driving
  ``models/random_forest.py`` (reference parity target:
  ``models/ensemble_random_forest.py:6-31``'s sklearn CART).

The shared library is built lazily with ``g++`` on first use and cached
next to the source; every caller must keep a numpy fallback (``available()``
is False when no toolchain exists or ``GPT_DISABLE_NATIVE=1``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cart.cpp")
_SO = os.path.join(_HERE, "_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str:
    newest_input = max(os.path.getmtime(_SRC), os.path.getmtime(__file__))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_input:
        return _SO
    tmp = _SO + f".tmp.{os.getpid()}"
    # -ffp-contract=off: no FMA contraction — scores must round exactly like
    # the numpy fallback so near-tie argmin decisions agree bit-for-bit.
    base = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(
            base[:1] + ["-march=native"] + base[1:], check=True, capture_output=True
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        subprocess.run(base, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        lib = None
        if os.environ.get("GPT_DISABLE_NATIVE", "0") != "1":
            try:
                lib = ctypes.CDLL(_build())
                lib.gpt_best_split.restype = ctypes.c_int
                lib.gpt_best_split.argtypes = [
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_double),
                ]
            except Exception:
                lib = None
        _lib = lib
        _tried = True
    return _lib


def available() -> bool:
    """True iff the compiled kernels are usable in this process."""
    return _load() is not None


def cart_best_split(X: np.ndarray, y: np.ndarray) -> Optional[Tuple[int, float]]:
    """Best (feature, midpoint threshold) by SSE reduction, or None when no
    valid split exists.  Raises RuntimeError if the library is unavailable —
    callers gate on ``available()``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native kernels unavailable; use the numpy path")
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, d = X.shape
    P = y.shape[1]
    out_f = ctypes.c_int64(-1)
    out_t = ctypes.c_double(0.0)
    ok = lib.gpt_best_split(
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        P,
        ctypes.byref(out_f),
        ctypes.byref(out_t),
    )
    if not ok:
        return None
    return int(out_f.value), float(out_t.value)
