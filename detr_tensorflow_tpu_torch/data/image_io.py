"""Image files without OpenCV or Pillow.

The JAX package reads images with ``imageio`` (``data/coco.py:46``). The
card's machine has neither imageio, OpenCV nor Pillow, so PNG is decoded
here with ``zlib`` and numpy: 8- and 16-bit gray, gray+alpha, RGB and RGBA,
all five row filters, non-interlaced. ``.npy`` files hold an
array as it is. Any other format (JPEG) goes through ``imageio`` where it
is installed. ``write_png`` writes 8-bit PNGs (the synthetic datasets).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> samples per pixel (gray, RGB, gray+alpha, RGBA).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: (height, stride) uint8 bytes.

    Rows of filter None, Sub and Up alone are undone row by row. Average and
    Paeth read the reconstructed left, upper and upper-left bytes, so a file
    holding them is reconstructed one anti-diagonal of pixels at a time (a
    pixel depends only on pixels of earlier anti-diagonals), all rows of a
    diagonal at once, each by its own row's filter.
    """
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    kinds, filtered = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    if not kinds.any():
        return filtered.copy()
    width = stride // bpp
    if kinds.max() <= 2:
        out = np.empty_like(filtered)
        prev = np.zeros(stride, np.uint8)
        for r in range(height):
            row = filtered[r]
            if kinds[r] == 1:
                row = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif kinds[r] == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    f = filtered.reshape(height, width, bpp).astype(np.int32)
    out = np.zeros((height + 1, width + 1, bpp), np.int32)  # a zero row above, column left
    kind = kinds.astype(np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        k = kind[r][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, ul), 0))))
        out[r + 1, c + 1] = (f[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(height, stride)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as ``imageio`` does: (H, W) for gray, (H, W, C)
    otherwise; uint8, except a 16-bit gray file (uint16): a 16-bit file of
    more channels gives each sample's high byte, as imageio's Pillow reader
    does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG color type {color} at bit depth {depth} is not supported "
                         "(8/16-bit gray, gray+alpha, RGB and RGBA are)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    channels, nbytes = _CHANNELS[color], depth // 8
    stride = width * channels * nbytes
    raw = _unfilter(zlib.decompress(b"".join(idat)), height, stride, channels * nbytes)
    if nbytes == 2:
        image = raw.view(">u2").astype(np.uint16).reshape(height, width, channels)
        if color != 0:  # imageio (Pillow) keeps 16 bits for gray only: the high byte here
            image = (image >> 8).astype(np.uint8)
    else:
        image = raw.reshape(height, width, channels)
    return image[..., 0] if channels == 1 else image


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 image as
    an 8-bit PNG (no row filter)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {image.dtype}")
    color = {2: 0, 3: {1: 0, 3: 2, 4: 6}.get(image.shape[-1])}.get(image.ndim)
    if color is None:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), got {image.shape}")
    height, width = image.shape[:2]
    rows = image.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 3)) + chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """An image file as an array: PNG and ``.npy`` here, any other format
    through ``imageio``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".npy":
        return np.load(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"{path}: decoding {ext or 'this format'} needs imageio, which is not "
                          "installed (PNG and .npy are decoded without it)") from e
    return imageio.imread(path)


def read_image(path: str) -> np.ndarray:
    """An image as (H, W, 3): gray repeated to three channels, alpha
    dropped (the JAX package's ``data/coco.py:_read_image``)."""
    image = imread(path)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    return image
