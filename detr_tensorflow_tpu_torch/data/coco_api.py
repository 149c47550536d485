"""Minimal COCO annotation index (copy of ``detr_tensorflow_tpu/data/coco_api.py``).

A dependency-free replacement for the pycocotools ``COCO`` class (which
the reference requires, detr_tf/data/coco.py:1) covering exactly what
the data pipeline needs: image records, per-image annotation lookup, and
category metadata. COCO annotation files are plain JSON.
"""

from __future__ import annotations

import json
from typing import Dict, List


class CocoIndex:
    """Index over a COCO-format annotation JSON."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images: Dict[int, dict] = {img["id"]: img for img in data.get("images", [])}
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in data.get("categories", [])
        }
        self.anns_by_image: Dict[int, List[dict]] = {i: [] for i in self.images}
        for ann in data.get("annotations", []):
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)

    # pycocotools-compatible accessors (subset)
    def getImgIds(self) -> List[int]:
        return list(self.images.keys())

    def getCatIds(self) -> List[int]:
        return list(self.cats.keys())

    def loadImgs(self, ids) -> List[dict]:
        return [self.images[i] for i in ids]

    def loadCats(self, ids) -> List[dict]:
        return [self.cats[i] for i in ids]

    def getAnnIds(self, imgIds) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        return [a["id"] for i in imgIds for a in self.anns_by_image.get(i, [])]

    def loadAnnsForImage(self, img_id: int) -> List[dict]:
        return self.anns_by_image.get(img_id, [])
