"""ctypes binding for the native C++ dataset loader (native/png_loader.cpp).

Provides a prefetching RGB-D frame source: PNG decode + gray conversion + depth
scaling run in C++ worker threads ahead of the device pipeline.  Falls back to the
PIL path in :mod:`rgbd_slam.io.datasets` when the shared library is missing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libpng_loader.so"),
]

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_float]
            lib.loader_get.restype = ctypes.c_int
            lib.loader_get.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int]
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            lib.decode_png_file.restype = ctypes.c_int
            lib.decode_png_file.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            _lib = lib
            return lib
    return None


def available() -> bool:
    return _load_lib() is not None


def decode_png(path: str, height: int, width: int, to_gray: bool = True,
               scale: float = 1.0) -> np.ndarray | None:
    """Single-image decode through the native library; None on failure."""
    lib = _load_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.float32)
    ok = lib.decode_png_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, int(to_gray), ctypes.c_float(scale))
    return out if ok else None


class NativeFrameLoader:
    """Prefetching loader over (rgb_path, depth_path) pairs.

    Iterate with ``get(i) -> (gray, depth_mm)``; frames i+1..i+8 are decoded in
    background C++ threads while the device consumes frame i."""

    def __init__(self, rgb_paths, depth_paths, height: int, width: int,
                 depth_scale: float = 0.2, workers: int = 3):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader library not built "
                               "(run make in native/)")
        self._lib = lib
        self._h, self._w = height, width
        n = len(rgb_paths)
        self._n = n
        rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        depth_arr = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        self._handle = lib.loader_create(rgb_arr, depth_arr, n, workers,
                                         ctypes.c_float(depth_scale))

    def __len__(self):
        return self._n

    def get(self, idx: int):
        gray = np.empty((self._h, self._w), dtype=np.float32)
        depth = np.empty((self._h, self._w), dtype=np.float32)
        ok = self._lib.loader_get(
            self._handle, idx,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._h, self._w)
        if not ok:
            raise IOError(f"native loader failed on frame {idx}")
        return gray, depth

    def __iter__(self):
        for i in range(self._n):
            yield self.get(i)

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
