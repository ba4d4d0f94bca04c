"""ctypes binding to the native host warp library (``native/warp.cc``), the
JAX package's ``data/native_warp.py`` with a loader of its own.

It gives the host input pipeline a perspective crop without cv2: a
homography solve and a bilinear warp with BORDER_REPLICATE semantics, in
C++. The library is ``native/libvgm_host.so`` at the repo root; when it is
missing, the first use builds it with ``g++ -O3 -march=native -shared -fPIC
-std=c++17`` (the command of ``tools/build_native.py``) into a temporary
file that then replaces the target, so concurrent builds cannot leave a
torn library. Callers check ``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvgm_host.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "warp.cc")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def build() -> str:
    """Compile ``native/warp.cc`` into ``native/libvgm_host.so``."""
    fd, tmp = tempfile.mkstemp(suffix=".so",
                               dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", _SRC_PATH, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            build()
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
        return None
    lib.vgm_solve_homography.restype = ctypes.c_int
    lib.vgm_solve_homography.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double)]
    lib.vgm_warp_u8.restype = None
    lib.vgm_warp_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def solve_homography(src_quad: np.ndarray,
                     dst_quad: np.ndarray) -> np.ndarray:
    """3x3 homography mapping src -> dst (double-precision solve)."""
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src_quad, np.float32).reshape(8)
    dst = np.ascontiguousarray(dst_quad, np.float32).reshape(8)
    out = np.zeros(9, np.float64)
    rc = lib.vgm_solve_homography(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise ValueError("degenerate quad")
    return out.reshape(3, 3)


def perspective_crop(img: np.ndarray, quad: np.ndarray, out_w: int,
                     out_h: int) -> np.ndarray:
    """uint8 (H, W, C) or (H, W) -> warped uint8 (out_h, out_w[, C])."""
    lib = _load()
    assert lib is not None
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    rect = np.array([[0, 0], [out_w - 1, 0], [out_w - 1, out_h - 1],
                     [0, out_h - 1]], np.float32)
    m = solve_homography(rect, np.asarray(quad, np.float32))
    dst = np.empty((out_h, out_w, c), np.uint8)
    lib.vgm_warp_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(out_h), ctypes.c_int(out_w))
    return dst[..., 0] if squeeze else dst
