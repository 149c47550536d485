#!/usr/bin/env python3
"""Write the JPEG fixtures of ``tests/data/jpeg/`` and their expected decodings.

  python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg]

Needs Pillow, OpenCV and imageio (the machine the tests are written on, not the
card's). The images are drawn from a numpy seed (smooth gradients, filled
shapes and noise, so every frequency band carries data), then encoded by
Pillow's libjpeg-turbo or, for the sampling factors Pillow does not write, by
OpenCV's. ``expected.json`` holds each file's encoding, the shape of
``imageio.v2.imread``'s array and the SHA-256 of its bytes: the card's
machine has no imageio, so ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold ``data/jpeg.py`` to these hashes there.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "tests" / "data" / "jpeg"


def picture(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """An (h, w, 3) uint8 scene, or (h, w) for ``gray``, from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / max(w - 1, 1), y / max(h - 1, 1), (x + y) / max(h + w - 2, 1)], -1)
    img = 40 + 170 * img[..., rng.permutation(3)]
    for _ in range(12):  # filled rectangles and discs of random colours
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.03, 0.25) * h + 1, rng.uniform(0.03, 0.25) * w + 1
        inside = (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1 if rng.random() < 0.5
                  else (abs(y - cy) <= ry) & (abs(x - cx) <= rx))
        img[inside] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img.mean(-1).astype(np.uint8) if gray else img


def pillow(img, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def opencv(img, **flags) -> bytes:
    import cv2

    params = []
    for name, value in flags.items():
        params += [getattr(cv2, name), value]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), params)
    assert ok
    return enc.tobytes()


def exif_rotated() -> bytes:
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 CW to display; imageio does not apply it
    return pillow(picture(120, 160, 9), quality=80, exif=exif.tobytes())


# name -> (how it was encoded, bytes): 4:2:0 at 640x480 and 1333x800 (the
# decode-rate shapes), odd sizes in 4:4:4, 4:2:2 and 4:2:0, OpenCV's 4:4:0
# and 4:1:1, gray, progressive, optimised Huffman tables, restart intervals
# (sequential and progressive) and an EXIF orientation tag.
def fixtures() -> dict:
    return {
        "q75_420_640x480.jpg": ("Pillow q75 4:2:0", lambda: pillow(
            picture(480, 640, 1), quality=75, subsampling=2)),
        "q85_420_1333x800.jpg": ("Pillow q85 4:2:0", lambda: pillow(
            picture(800, 1333, 2), quality=85, subsampling=2)),
        "q90_444_333x251.jpg": ("Pillow q90 4:4:4", lambda: pillow(
            picture(251, 333, 3), quality=90, subsampling=0)),
        "q60_422_333x251.jpg": ("Pillow q60 4:2:2", lambda: pillow(
            picture(251, 333, 4), quality=60, subsampling=1)),
        "q75_420_333x251.jpg": ("Pillow q75 4:2:0", lambda: pillow(
            picture(251, 333, 5), quality=75, subsampling=2)),
        "q95_444_17x9.jpg": ("Pillow q95 4:4:4", lambda: pillow(
            picture(9, 17, 6), quality=95, subsampling=0)),
        "q75_422_17x9.jpg": ("Pillow q75 4:2:2", lambda: pillow(
            picture(9, 17, 7), quality=75, subsampling=1)),
        "q50_420_17x9.jpg": ("Pillow q50 4:2:0", lambda: pillow(
            picture(9, 17, 8), quality=50, subsampling=2)),
        "cv2_q80_440_321x239.jpg": ("OpenCV q80 4:4:0", lambda: opencv(
            picture(239, 321, 10), IMWRITE_JPEG_QUALITY=80,
            IMWRITE_JPEG_SAMPLING_FACTOR=0x121111)),
        "cv2_q80_411_321x239.jpg": ("OpenCV q80 4:1:1", lambda: opencv(
            picture(239, 321, 11), IMWRITE_JPEG_QUALITY=80,
            IMWRITE_JPEG_SAMPLING_FACTOR=0x411111)),
        "gray_q75_300x200.jpg": ("Pillow q75 gray", lambda: pillow(
            picture(200, 300, 12, gray=True), quality=75)),
        "progressive_q80_420_400x300.jpg": ("Pillow q80 4:2:0 progressive", lambda: pillow(
            picture(300, 400, 13), quality=80, subsampling=2, progressive=True)),
        "optimized_q70_444_260x190.jpg": ("Pillow q70 4:4:4 optimised Huffman", lambda: pillow(
            picture(190, 260, 14), quality=70, subsampling=0, optimize=True)),
        "restart_q75_420_257x183.jpg": ("OpenCV q75 4:2:0 restart interval 5", lambda: opencv(
            picture(183, 257, 15), IMWRITE_JPEG_QUALITY=75, IMWRITE_JPEG_RST_INTERVAL=5)),
        "restart_progressive_q75_201x157.jpg": (
            "OpenCV q75 4:2:0 progressive, restart interval 3", lambda: opencv(
                picture(157, 201, 16), IMWRITE_JPEG_QUALITY=75, IMWRITE_JPEG_RST_INTERVAL=3,
                IMWRITE_JPEG_PROGRESSIVE=1)),
        "exif_orientation6_160x120.jpg": ("Pillow q80 4:2:0 EXIF orientation 6", exif_rotated),
    }


def digest(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def main() -> None:
    import imageio.v2 as imageio

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=OUT)
    out = parser.parse_args().out
    out.mkdir(parents=True, exist_ok=True)
    expected = {}
    for name, (how, encode) in fixtures().items():
        (out / name).write_bytes(encode())
        image = imageio.imread(out / name)
        expected[name] = {"encoded": how, "shape": list(image.shape), "sha256": digest(image)}
    (out / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    total = sum((out / n).stat().st_size for n in expected)
    print(f"wrote {len(expected)} JPEG files, {total} bytes, and expected.json to {out}")


if __name__ == "__main__":
    main()
