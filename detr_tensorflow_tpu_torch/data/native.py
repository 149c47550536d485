"""ctypes bindings of the host data plane's C++ kernels (port of
``detr_tensorflow_tpu/data/native.py``).

The repository's ``native/image_ops.cpp`` (fused uint8 -> float
normalization, and normalization into a zero-padded bucket) is compiled
with g++ on first use into ``build/native/`` at the repository root, under
a name that carries a hash of the source and the flags, and loaded with
ctypes; nothing is built at import. The flags are the JAX package's, so
both packages run the same code. Where the JAX loader returns None on a
failed build and falls back to numpy, this one raises: the numpy versions
(``processing.normalize_torch_numpy`` and friends) are the plain versions
the tests hold these against, not a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .processing import CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    content = SOURCE.read_bytes()
    digest = hashlib.sha256(content + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"libimage_ops_{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.normalize_torch_u8.argtypes = [u8p, f32p, ctypes.c_int64, f32p, f32p]
            lib.normalize_caffe_u8.argtypes = [u8p, f32p, ctypes.c_int64, f32p]
            lib.normalize_torch_u8_into_bucket.argtypes = [
                u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _check(image_u8: np.ndarray) -> np.ndarray:
    if image_u8.dtype != np.uint8 or image_u8.ndim != 3 or image_u8.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image_u8.dtype} "
                         f"{image_u8.shape}")
    return np.ascontiguousarray(image_u8)


def normalize_torch(image_u8: np.ndarray) -> np.ndarray:
    """(x / 255 - mean) / std of an (H, W, 3) uint8 RGB image, in one pass."""
    image_u8 = _check(image_u8)
    out = np.empty(image_u8.shape, np.float32)
    get_lib().normalize_torch_u8(_ptr(image_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                                 ctypes.c_int64(image_u8.size // 3),
                                 _ptr(IMAGENET_MEAN, ctypes.c_float),
                                 _ptr(IMAGENET_STD, ctypes.c_float))
    return out


def normalize_caffe(image_u8: np.ndarray) -> np.ndarray:
    """RGB -> BGR and caffe mean subtraction, in one pass."""
    image_u8 = _check(image_u8)
    out = np.empty(image_u8.shape, np.float32)
    get_lib().normalize_caffe_u8(_ptr(image_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                                 ctypes.c_int64(image_u8.size // 3),
                                 _ptr(CAFFE_MEAN, ctypes.c_float))
    return out


def normalize_torch_into_bucket(image_u8: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """``normalize_torch`` written into a zeroed (pad_h, pad_w, 3) buffer."""
    image_u8 = _check(image_u8)
    h, w = image_u8.shape[:2]
    if pad_h < h or pad_w < w:
        raise ValueError(f"bucket {pad_h}x{pad_w} smaller than the image {h}x{w}")
    out = np.empty((pad_h, pad_w, 3), np.float32)
    get_lib().normalize_torch_u8_into_bucket(
        _ptr(image_u8, ctypes.c_uint8), _ptr(out, ctypes.c_float), h, w, pad_h, pad_w,
        _ptr(IMAGENET_MEAN, ctypes.c_float), _ptr(IMAGENET_STD, ctypes.c_float))
    return out
