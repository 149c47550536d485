"""Synthetic COCO-format dataset (port of ``detr_tensorflow_tpu/data/synthetic.py``).

Writes images of bright filled rectangles on dark noise and their
``ann.json``, so every workflow runs with no network, weights or real
data. The JAX generator draws with cv2 and stores the array with
``cv2.imwrite``, which takes it as BGR: its "red" box is read back blue.
This one writes the pixels that file decodes to (the drawn array with its
channels reversed) with ``image_io.write_png``, and the same ``ann.json``.
``sizes`` and ``boxes_per_image`` add COCO-like image sizes and several
boxes an image; left at None the draws are the JAX generator's.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .image_io import write_png


def _fill(img: np.ndarray, x: int, y: int, bw: int, bh: int, color) -> None:
    """``cv2.rectangle(img, (x, y), (x + bw, y + bh), color, -1)``: both
    end rows and columns filled, clipped to the image."""
    img[max(y, 0):y + bh + 1, max(x, 0):x + bw + 1] = color


def make_synthetic_coco(root: str, n_images: int = 8, seed: int = 0, image_size: int = 128,
                        masks: bool = False,
                        sizes: Optional[Sequence[Tuple[int, int]]] = None,
                        boxes_per_image: Optional[Tuple[int, int]] = None):
    """Generate ``n_images`` images with filled rectangles.

    Args:
      root: output directory (``images/`` and ``ann.json`` are created).
      masks: also write polygon segmentations (the rectangles' outlines).
      sizes: (H, W) of each image in turn, cycled; None: square images of
        ``image_size``.
      boxes_per_image: (lo, hi): each image holds lo..hi boxes (drawn);
        None: one box an image, the JAX generator's draws.

    Image i's boxes are white (category 1) when i is even, else blue
    (category 2, named "red-box" as in the JAX generator).
    Returns (img_dir, ann_file) paths.
    """
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)] if sizes else (image_size, image_size)
        img = rng.integers(0, 60, size=(h, w, 3)).astype(np.uint8)
        n_boxes = (1 if boxes_per_image is None
                   else int(rng.integers(boxes_per_image[0], boxes_per_image[1] + 1)))
        color = (255, 255, 255) if i % 2 == 0 else (255, 0, 0)
        cat = 1 if i % 2 == 0 else 2
        for _ in range(n_boxes):
            if boxes_per_image is None:
                bw = int(rng.integers(image_size // 4, image_size // 2))
                bh = int(rng.integers(image_size // 4, image_size // 2))
            else:
                bw = int(rng.integers(max(4, w // 16), max(5, w // 3)))
                bh = int(rng.integers(max(4, h // 16), max(5, h // 3)))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            _fill(img, x, y, bw, bh, color)
            ann = {"id": len(annotations), "image_id": i, "category_id": cat,
                   "bbox": [float(x), float(y), float(bw), float(bh)], "iscrowd": 0,
                   "area": float(bw * bh)}
            if masks:
                ann["segmentation"] = [[float(x), float(y), float(x + bw), float(y),
                                        float(x + bw), float(y + bh), float(x), float(y + bh)]]
            annotations.append(ann)
        # cv2.imwrite takes the array as BGR: the file decodes to the reverse.
        write_png(os.path.join(img_dir, f"img{i}.png"), img[..., ::-1])
        images.append({"id": i, "file_name": f"img{i}.png", "height": h, "width": w})
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "white-box"},
                                  {"id": 2, "name": "red-box"}]}, f)
    return img_dir, ann_file
