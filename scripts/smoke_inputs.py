"""Seeded inputs that ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``) share: kernel B's problems at the widths of
wider query sets, and COCO, VOC and CSV (hard-hat) sets of JPEG files made
from copies of the committed fixtures (``tests/data/jpeg``).

Both load this file by its path, so it needs nothing but numpy.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

JPEG_DIR = Path(__file__).resolve().parent.parent / "tests" / "data" / "jpeg"
HARDHAT_CLASSES = ("head", "helmet", "vest", "person")  # "person" is excluded by the recipe
# B's generic instance: (label, problems, columns = target slots, real rows
# a problem (fewest, most), the real rows of one problem or None); the
# widths of Deformable-DETR's 300 queries, DINO's 900 and H-DETR's 1800
# (rounded up), one past the rows shared memory stages (its state fits,
# one row is staged) and one whose state does not fit (in device memory).
# The one problem of many real rows gives the augmenting paths a serial
# chain of thousands of Dijkstra steps; the others leave the auction little.
LAP_GENERIC = (("Deformable-DETR's 300 queries", 6, 300, (0, 60), None),
               ("DINO's 900", 12, 900, (0, 100), 900),
               ("H-DETR's 1800, rounded up", 2, 2000, (200, 400), None),
               ("4097: past the rows shared memory stages", 1, 4097, (100, 100), 3900),
               ("5000: the state in device memory", 1, 5000, (100, 100), 4800))


def generic_lap_problems(seed, problems, cols, real, many, ties=False):
    """``problems`` of cols x cols costs, each with a number of real rows in
    ``real`` scattered over the slots, and (``many``) problem 1, or the
    only one, with that many."""
    rng = np.random.default_rng(seed)
    shape = (problems, cols, cols)
    cost = (rng.integers(0, 4, size=shape) if ties else rng.normal(size=shape)).astype(np.float32)
    n_real = rng.integers(real[0], real[1] + 1, size=problems)
    if many is not None:
        n_real[min(1, problems - 1)] = many
    mask = np.stack([rng.permutation(np.arange(cols) < n) for n in n_real])
    return cost, mask, n_real


def jpeg_sources():
    """The fixtures a training set copies: every one of at least 120 rows,
    with its (H, W)."""
    expected = json.loads((JPEG_DIR / "expected.json").read_text())
    return [(JPEG_DIR / n, tuple(v["shape"][:2])) for n, v in expected.items()
            if v["shape"][0] >= 120]


def write_jpeg_sets(root, seed, images, eval_images, ft_images):
    """From copies of the fixtures: a COCO layout of ``images`` images with
    1-20 boxes each (``ann.json``; ``ann_eval.json`` its first
    ``eval_images``), a VOC layout and a CSV (hard-hat) layout of the first
    ``ft_images``, the same boxes, the CSV's in HARDHAT_CLASSES."""
    rng = np.random.default_rng(seed)
    sources = jpeg_sources()
    for d in ("coco/images", "voc/JPEGImages", "voc/Annotations", "hardhat/train"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    entries, anns, rows = [], [], []
    for i in range(images):
        src, (h, w) = sources[i % len(sources)]
        name = f"{i:05d}.jpg"
        shutil.copy(src, os.path.join(root, "coco/images", name))
        entries.append({"id": i, "file_name": name, "height": h, "width": w})
        objects = ""
        for k in range(int(rng.integers(1, 21))):
            bw, bh = int(rng.integers(w // 16, w // 2)), int(rng.integers(h // 16, h // 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            anns.append({"id": len(anns), "image_id": i, "category_id": 1 + (i + k) % 3,
                         "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
            label = HARDHAT_CLASSES[(i + k) % len(HARDHAT_CLASSES)]
            objects += (f"<object><name>{label}</name><bndbox><xmin>{x + 1}</xmin><ymin>{y + 1}"
                        f"</ymin><xmax>{x + bw}</xmax><ymax>{y + bh}</ymax></bndbox></object>")
            rows.append(f"{name},{w},{h},{label},{x},{y},{x + bw},{y + bh}")
        if i < ft_images:
            shutil.copy(src, os.path.join(root, "voc/JPEGImages", name))
            shutil.copy(src, os.path.join(root, "hardhat/train", name))
            with open(os.path.join(root, "voc/Annotations", f"{i:05d}.xml"), "w") as f:
                f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>"
                        f"{objects}</annotation>")
    categories = [{"id": c, "name": f"class{c}"} for c in (1, 2, 3)]
    for ann_file, n in (("ann.json", images), ("ann_eval.json", eval_images)):
        with open(os.path.join(root, "coco", ann_file), "w") as f:
            json.dump({"images": entries[:n], "categories": categories,
                       "annotations": [a for a in anns if a["image_id"] < n]}, f)
    ft_rows = [r for r in rows if int(r.split(".")[0]) < ft_images]
    with open(os.path.join(root, "hardhat/train/_annotations.csv"), "w") as f:
        f.write("filename,width,height,class,xmin,ymin,xmax,ymax\n" + "\n".join(ft_rows) + "\n")
