"""JPEG decoding without imageio, Pillow or OpenCV: ctypes binding of
``data/jpeg.cpp``.

The JAX package reads JPEG files with ``imageio.v2.imread`` (Pillow over
libjpeg-turbo; ``detr_tensorflow_tpu/data/coco.py:46``) and, in the panoptic
loader, with ``cv2.imread``. The machine the port runs on has none of them, so
the port decodes JPEG itself: baseline and progressive Huffman-coded files,
gray and YCbCr, every integral sampling factor, with libjpeg-turbo's default
arithmetic, so an image equals imageio's to the bit. The source's header
lists what it refuses (arithmetic coding, 12-bit, lossless, CMYK, truncated
files).

The library is compiled with g++ on first use into ``build/native/`` under a
hash of source and flags (``native.build_library``); a failed build raises,
and so does a file the decoder refuses: there is no other route. A ctypes
call releases the GIL, so ``HostDataset``'s worker threads decode at once.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .native import build_library

SOURCE = Path(__file__).with_name("jpeg.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
JPEG_SIGNATURE = b"\xff\xd8\xff"

_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded decoder, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SOURCE, GXX_FLAGS)))
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p, i32p,
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_info.restype = lib.jpeg_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """The image in ``data``: (H, W) uint8 for gray, (H, W, 3) RGB uint8
    otherwise, as ``imageio.v2.imread`` returns it. Raises ValueError, naming
    ``name`` and the reason, on a file the decoder refuses."""
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                     err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value) if c.value == 1 else (h.value, w.value, c.value), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, out.size, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """``decode_jpeg`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))
