"""ctypes bindings for the native frame pipeline (csrc/framepipe.cpp, a
host library: plain C++, no CUDA).

Builds the shared library on demand with g++ into the package's `_build/`
and exposes numpy-array wrappers. Where no compiler is at hand
`available()` is false and the callers take their numpy / cv2 path, as in
gava_clip_tpu/data/native.py.
"""

import ctypes
import functools
import os
import os.path as osp
import subprocess
from typing import Optional

import numpy as np

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_LIB_PATH = osp.join(_PKG, "_build", "libframepipe.so")
_SRC_PATH = osp.join(_PKG, "csrc", "framepipe.cpp")

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> bool:
    if not osp.isfile(_SRC_PATH):
        return False
    os.makedirs(osp.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-o", tmp, _SRC_PATH],
            check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


@functools.lru_cache()
def _lib() -> Optional[ctypes.CDLL]:
    if not osp.isfile(_LIB_PATH) or \
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.fp_resize_bilinear_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fp_crop_resize_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fp_center_crop_u8.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8p, ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def resize_bilinear(frames: np.ndarray, new_h: int, new_w: int,
                    num_threads: int = 4) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, new_h, new_w, C), half-pixel bilinear."""
    lib = _lib()
    assert lib is not None and frames.dtype == np.uint8
    frames = np.ascontiguousarray(frames)
    T, H, W, C = frames.shape
    out = np.empty((T, new_h, new_w, C), np.uint8)
    lib.fp_resize_bilinear_u8(_ptr(frames), T, H, W, C, _ptr(out),
                              new_h, new_w, num_threads)
    return out


def crop_resize(frames: np.ndarray, top: int, left: int, h: int, w: int,
                new_h: int, new_w: int, num_threads: int = 4) -> np.ndarray:
    lib = _lib()
    assert lib is not None and frames.dtype == np.uint8
    frames = np.ascontiguousarray(frames)
    T, H, W, C = frames.shape
    out = np.empty((T, new_h, new_w, C), np.uint8)
    lib.fp_crop_resize_u8(_ptr(frames), T, H, W, C, top, left, h, w,
                          _ptr(out), new_h, new_w, num_threads)
    return out


def center_crop(frames: np.ndarray, size: int, num_threads: int = 4) -> np.ndarray:
    lib = _lib()
    assert lib is not None and frames.dtype == np.uint8
    frames = np.ascontiguousarray(frames)
    T, H, W, C = frames.shape
    out = np.empty((T, size, size, C), np.uint8)
    lib.fp_center_crop_u8(_ptr(frames), T, H, W, C, _ptr(out), size, num_threads)
    return out
