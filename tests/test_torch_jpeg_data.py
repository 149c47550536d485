"""The port's loaders on sets of JPEG files, against the JAX package's, on
the CPU, with imageio, Pillow, OpenCV and pandas unimportable while the port
runs (``reference_libraries_blocked``): the port decodes its JPEGs with
``data/jpeg.py`` and reads CSV with the standard library, so it needs none of
them; the JAX loaders read the same files with imageio (panoptic: cv2) and
pandas.

COCO, VOC and the CSV (hard-hat) loader: batches equal, augmented images
within one uint8 level after normalization (``NORMALIZED_LEVEL``, as the
PNG-set tests of ``test_torch_data.py`` hold); the panoptic loaders on JPEG
images within cv2's bound against imageio (``CV2_IMAGEIO_LEVELS``: equal);
``finetune_hardhat.main`` for one step at reduced depth; and the CSV
loader's class list against the JAX loader's.
"""

import contextlib
import json
import shutil
import sys

import numpy as np
import pytest

from detr_tensorflow_tpu.data import coco as jax_coco
from detr_tensorflow_tpu.data import panoptic as jax_panoptic
from detr_tensorflow_tpu.data import tfcsv as jax_tfcsv
from detr_tensorflow_tpu.data import voc as jax_voc
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch import finetune_hardhat
from detr_tensorflow_tpu_torch.data import coco, image_io, load_tfcsv_dataset, panoptic, voc
from detr_tensorflow_tpu_torch.train import DataConfig, TrainingConfig
from test_torch_data import NORMALIZED_LEVEL
from test_torch_data_loaders import _compare_batches
from test_torch_entry_points import TINY as ENTRY_TINY
from test_torch_jpeg import CV2_IMAGEIO_LEVELS, fixtures
from test_torch_panoptic import _assert_batches_equal, _id_png
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

REFERENCE_LIBRARIES = ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2", "pandas")
SIZES = [(70, 90), (64, 96), (90, 70), (57, 83)]
HARDHAT_CLASSES = ["head", "helmet", "person", "vest"]


@contextlib.contextmanager
def reference_libraries_blocked():
    """``import imageio`` (and PIL, cv2, pandas) raises inside the block."""
    saved = {m: sys.modules.get(m) for m in REFERENCE_LIBRARIES}
    try:
        for m in REFERENCE_LIBRARIES:
            sys.modules[m] = None
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def _jpeg(path, i, h, w):
    """Picture i as a JPEG, the codings in turn: 4:2:0, 4:4:4, progressive
    4:2:0, 4:2:2 with a restart interval; every fifth one gray."""
    gray = i % 5 == 4
    img = fixtures.picture(h, w, 100 + i, gray=gray)
    kw = [dict(subsampling=2), dict(subsampling=0), dict(subsampling=2, progressive=True),
          dict(subsampling=1, restart_marker_blocks=3)][i % 4]
    path.write_bytes(fixtures.pillow(img, quality=80, **({} if gray else kw)))


def _boxes(rng, h, w, n):
    out = []
    for _ in range(n):
        bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        out.append((x, y, bw, bh))
    return out


@pytest.fixture(scope="module")
def jpeg_sets(tmp_path_factory):
    """A COCO, a VOC, a hard-hat CSV and a COCO panoptic layout, every
    image a JPEG file (gray among them), 1-4 boxes an image."""
    root = tmp_path_factory.mktemp("jpeg_sets")
    rng = np.random.default_rng(0)
    for d in ("coco/images", "voc/JPEGImages", "voc/Annotations", "csv/train",
              "panoptic/images", "panoptic/segments"):
        (root / d).mkdir(parents=True)
    images, anns, rows = [], [], []
    pan_images, pan_anns = [], []
    for i in range(8):
        h, w = SIZES[i % len(SIZES)]
        _jpeg(root / "coco/images" / f"{i}.jpg", i, h, w)
        for d in ("voc/JPEGImages", "csv/train", "panoptic/images"):
            shutil.copy(root / "coco/images" / f"{i}.jpg", root / d / f"{i}.jpg")
        boxes = _boxes(rng, h, w, 1 + i % 4)
        images.append({"id": i, "file_name": f"{i}.jpg", "height": h, "width": w})
        objects, id_map, segments = "", np.zeros((h, w), np.int32), []
        for k, (x, y, bw, bh) in enumerate(boxes):
            cat = [1, 2, 5][(i + k) % 3]
            anns.append({"id": len(anns), "image_id": i, "category_id": cat,
                         "bbox": [float(x), float(y), float(bw), float(bh)], "iscrowd": 0,
                         "area": float(bw * bh)})
            name = HARDHAT_CLASSES[(i + k) % 4]
            objects += (f"<object><name>{name}</name><bndbox><xmin>{x + 1}</xmin><ymin>{y + 1}"
                        f"</ymin><xmax>{x + bw}</xmax><ymax>{y + bh}</ymax></bndbox></object>")
            rows.append(f"{i}.jpg,{w},{h},{name},{x},{y},{x + bw},{y + bh}")
            id_map[y:y + bh, x:x + bw] = 10 + k
            segments.append({"id": 10 + k, "category_id": cat, "iscrowd": 0,
                             "bbox": [x, y, bw, bh], "area": bw * bh})
        id_map[h - 6:, :] = 300  # a stuff band along the bottom
        segments.append({"id": 300, "category_id": 12, "iscrowd": 0, "bbox": [0, h - 6, w, 6],
                         "area": 6 * w})
        (root / "voc/Annotations" / f"{i}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>{objects}"
            "</annotation>")
        image_io.write_png(str(root / "panoptic/segments" / f"{i}.png"), _id_png(id_map))
        pan_images.append({"id": i, "file_name": f"{i}.jpg", "height": h, "width": w})
        pan_anns.append({"image_id": i, "file_name": f"{i}.png", "segments_info": segments})
    categories = [{"id": c, "name": f"c{c}"} for c in (1, 2, 5)]
    (root / "coco/ann.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": categories}))
    (root / "csv/train/_annotations.csv").write_text(
        "filename,width,height,class,xmin,ymin,xmax,ymax\n" + "\n".join(rows) + "\n")
    (root / "panoptic/panoptic.json").write_text(json.dumps({
        "images": pan_images, "annotations": pan_anns,
        "categories": [dict(c, isthing=1) for c in categories]
        + [{"id": 12, "name": "band", "isthing": 0}]}))
    return root


def _configs(root, img_dir, ann_file="", ann_dir="", **kw):
    data = dict(data_dir=str(root), img_dir=img_dir, ann_file=ann_file, ann_dir=ann_dir)
    return (TrainingConfig(data=DataConfig(**data), **kw),
            JaxConfig(data=JaxDataConfig(**data), **kw))


def _port(load, *args, **kw):
    """The port's loader built and drained, twice (two epochs), with the
    reference libraries unimportable."""
    with reference_libraries_blocked():
        dataset, names = load(*args, **kw)
        return [list(dataset), list(dataset)], names, dataset


LOADER_CASES = [(None, 1), (False, 2), (True, 2)]
LOADER_IDS = ["original_size_b1", "resize", "augment"]


@pytest.mark.parametrize("augmentation, batch", LOADER_CASES, ids=LOADER_IDS)
def test_coco_loader_on_jpeg_equals_jax(jpeg_sets, augmentation, batch):
    """``load_coco_dataset`` on JPEG files against the JAX loader (imageio)."""
    ours_cfg, ref_cfg = _configs(jpeg_sets / "coco", "images", "ann.json",
                                 image_size=(48, 80), num_queries=10)
    kw = dict(augmentation=augmentation, bucket_divisor=64, num_workers=1, seed=1)
    epochs, names, ours = _port(coco.load_coco_dataset, ours_cfg, batch, **kw)
    ref, ref_names = jax_coco.load_coco_dataset(ref_cfg, batch, **kw)
    assert names == ref_names and ours.background_class == ref.background_class
    for got in epochs:
        _compare_batches(got, ref, NORMALIZED_LEVEL if augmentation else 0)


@pytest.mark.parametrize("augmentation, batch", LOADER_CASES, ids=LOADER_IDS)
def test_voc_loader_on_jpeg_equals_jax(jpeg_sets, augmentation, batch):
    """``load_voc_dataset`` on its ``.jpg`` files against the JAX loader."""
    ours_cfg, ref_cfg = _configs(jpeg_sets / "voc", "JPEGImages", ann_dir="Annotations",
                                 image_size=(48, 56), num_queries=10)
    kw = dict(augmentation=augmentation, num_workers=1, bucket_divisor=64, seed=2)
    epochs, names, _ = _port(voc.load_voc_dataset, ours_cfg, batch, **kw)
    ref, ref_names = jax_voc.load_voc_dataset(ref_cfg, batch, **kw)
    assert names == ref_names
    for got in epochs:
        _compare_batches(got, ref, NORMALIZED_LEVEL if augmentation else 0)


@pytest.mark.parametrize("augmentation, batch", LOADER_CASES, ids=LOADER_IDS)
def test_csv_loader_equals_jax(jpeg_sets, augmentation, batch):
    """``load_tfcsv_dataset`` (the standard library's csv) against the JAX
    loader (pandas) with "person" excluded: the same class names, sorted
    with background at 0, files in first-appearance order, and batches."""
    ours_cfg, ref_cfg = _configs(jpeg_sets / "csv", "train", "train/_annotations.csv",
                                 image_size=(48, 72), num_queries=10)
    kw = dict(augmentation=augmentation, exclude=["person"], num_workers=1, seed=3,
              shuffle=augmentation is True)
    epochs, names, ours = _port(load_tfcsv_dataset, ours_cfg, batch, **kw)
    ref, ref_names = jax_tfcsv.load_tfcsv_dataset(ref_cfg, batch, **kw)
    assert names == ref_names == ["background", "head", "helmet", "vest"]
    assert ours.indices == ref.indices and ours.background_class == ref.background_class == 0
    for got in epochs:
        _compare_batches(got, ref, NORMALIZED_LEVEL if augmentation else 0)


def test_panoptic_loaders_on_jpeg_equal_jax(jpeg_sets):
    """The panoptic train (augmented) and eval loaders on JPEG images with
    PNG segment maps against the JAX loaders, which read the images with
    cv2: within ``CV2_IMAGEIO_LEVELS`` (cv2 and imageio agree on untagged
    files) plus one level where the augmentation resamples."""
    root = jpeg_sets / "panoptic"
    paths = dict(ann_file=str(root / "panoptic.json"), png_dir=str(root / "segments"),
                 img_dir=str(root / "images"))
    ours_cfg, ref_cfg = _configs(root, "images", "panoptic.json", image_size=(64, 96),
                                 num_queries=8)
    level = CV2_IMAGEIO_LEVELS / 255.0 / 0.224  # a uint8 level after the torch normalization
    epochs, _, train = _port(panoptic.load_coco_panoptic_train, ours_cfg, 2, num_workers=1,
                             seed=4, **paths)
    want, _ = jax_panoptic.load_coco_panoptic_train(ref_cfg, 2, num_workers=1, seed=4, **paths)
    assert train.stuff_classes == [12]
    _assert_batches_equal(epochs[0], list(want), NORMALIZED_LEVEL + level)
    epochs, _, _ = _port(panoptic.load_coco_panoptic, ours_cfg, 1, num_workers=1, **paths)
    want, _ = jax_panoptic.load_coco_panoptic(ref_cfg, 1, num_workers=1, **paths)
    _assert_batches_equal(epochs[0], list(want), 1e-6 + level)


def test_finetune_hardhat_main_one_step(jpeg_sets):
    """``finetune_hardhat.main`` on the CSV set of JPEGs at reduced depth on
    the CPU, with imageio, Pillow, OpenCV and pandas unimportable: one
    validation batch, one training step; its heads sized to the JAX
    loader's class list (person excluded: background, head, helmet,
    vest)."""
    argv = ["--data_dir", str(jpeg_sets / "csv"), "--img_dir", "train", "--ann_file",
            "train/_annotations.csv", "--device", "cpu", "--batch_size", "2",
            "--target_batch", "2", "--image_size", "64", "96", "--epochs", "1",
            "--steps_per_epoch", "1", "--evaluation_steps", "1", "--num_workers", "2"]
    _, ref_cfg = _configs(jpeg_sets / "csv", "train", "train/_annotations.csv")
    _, ref_names = jax_tfcsv.load_tfcsv_dataset(ref_cfg, 2, exclude=["person"])
    with reference_libraries_blocked():
        trainer = finetune_hardhat.main(argv, dropout=0.0, **ENTRY_TINY)
    assert trainer.steps == 1
    assert trainer.model.cls_layer.weight.shape[0] == len(ref_names) == 4  # the finetune head
    assert trainer.config.image_size == (64, 96) and trainer.config.background_class == 0
