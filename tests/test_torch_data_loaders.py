"""The port's loaders (``detr_tensorflow_tpu_torch/data``) against the JAX
package's, on the CPU: the COCO index and labels, the synthetic set, the
threaded ``HostDataset``, the multi-scale plan and the COCO and VOC
loaders. Images are small (at most 128 px); every comparison states its
tolerance (the image-level helpers are held in ``tests/test_torch_data.py``).
"""

import json
import threading
import time

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from detr_tensorflow_tpu.data import coco as jax_coco
from detr_tensorflow_tpu.data import coco_api as jax_coco_api
from detr_tensorflow_tpu.data import multiscale as jax_ms
from detr_tensorflow_tpu.data import pipeline as jax_pipeline
from detr_tensorflow_tpu.data import synthetic as jax_synthetic
from detr_tensorflow_tpu.data import voc as jax_voc
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch.data import coco, coco_api, image_io, multiscale, pipeline
from detr_tensorflow_tpu_torch.data import synthetic, voc
from detr_tensorflow_tpu_torch.train import DataConfig, TrainingConfig
from test_torch_data import NORMALIZED_LEVEL
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)


# --------------------------------------------------------------------- files


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """A COCO set written with cv2: three image sizes, sparse category ids
    (1, 3, 7), a crowd image, an image without annotations and an
    annotation whose image id has no image record."""
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    sizes = [(70, 90), (64, 96), (90, 70), (70, 90), (64, 96), (90, 70), (70, 90), (56, 72)]
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        for _ in range(3):
            x, y = int(rng.integers(0, w - 24)), int(rng.integers(0, h - 24))
            bw, bh = int(rng.integers(8, 24)), int(rng.integers(8, 24))
            img[y:y + bh, x:x + bw] = rng.integers(120, 255, 3)
            if i != 5:  # image 5 has no annotation
                anns.append({"id": len(anns), "image_id": i, "category_id": [1, 3, 7][i % 3],
                             "bbox": [float(x), float(y), float(bw), float(bh)],
                             "iscrowd": int(i == 6), "area": float(bw * bh)})
        cv2.imwrite(str(root / "images" / f"i{i}.png"), img)
        images.append({"id": i, "file_name": f"i{i}.png", "height": h, "width": w})
    anns.append({"id": len(anns), "image_id": 99, "category_id": 3, "bbox": [1.0, 1.0, 4.0, 4.0],
                 "iscrowd": 0})
    (root / "ann.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "a"}, {"id": 3, "name": "c"}, {"id": 7, "name": "g"}]}))
    return root


def test_coco_index_and_labels_equal_jax(coco_root):
    """``CocoIndex`` and ``get_coco_labels`` equal the JAX package's on a
    file with crowd, empty and sparse category ids (boxes bit-equal); with
    ``include_masks`` the instance masks too (empty where an annotation has
    no segmentation)."""
    ann = str(coco_root / "ann.json")
    ours, ref = coco_api.CocoIndex(ann), jax_coco_api.CocoIndex(ann)
    assert ours.getImgIds() == ref.getImgIds() and ours.getCatIds() == ref.getCatIds()
    assert ours.loadCats(ours.getCatIds()) == ref.loadCats(ref.getCatIds())
    assert ours.getAnnIds(ours.getImgIds()) == ref.getAnnIds(ref.getImgIds())
    assert ours.getAnnIds(99) == ref.getAnnIds(99) and ours.loadAnnsForImage(5) == []
    for img in ref.loadImgs(ref.getImgIds()):
        shape = (img["height"], img["width"], 3)
        got, want = coco.get_coco_labels(ours, img["id"], shape), jax_coco.get_coco_labels(
            ref, img["id"], shape)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        got, want = (fn(index, img["id"], shape, include_masks=True) for fn, index in (
            (coco.get_coco_labels, ours), (jax_coco.get_coco_labels, ref)))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_synthetic_set_equals_jax(tmp_path):
    """``make_synthetic_coco``: the same ``ann.json`` and, decoded, the same
    pixels as the JAX generator's cv2-written files (its "red" box blue);
    with sizes and several boxes an image, each box filled with both end
    rows and columns, as cv2.rectangle fills."""
    for masks in (False, True):
        j, p = tmp_path / f"j{masks}", tmp_path / f"p{masks}"
        jax_synthetic.make_synthetic_coco(str(j), n_images=4, seed=3, image_size=64, masks=masks)
        synthetic.make_synthetic_coco(str(p), n_images=4, seed=3, image_size=64, masks=masks)
        assert json.loads((j / "ann.json").read_text()) == json.loads((p / "ann.json").read_text())
        for i in range(4):
            np.testing.assert_array_equal(imageio.imread(str(j / "images" / f"img{i}.png")),
                                          image_io.read_png(str(p / "images" / f"img{i}.png")))
    root = tmp_path / "sized"
    synthetic.make_synthetic_coco(str(root), n_images=3, sizes=[(48, 64), (40, 56)],
                                  boxes_per_image=(2, 4))
    ann = json.loads((root / "ann.json").read_text())
    assert [(im["height"], im["width"]) for im in ann["images"]] == [(48, 64), (40, 56), (48, 64)]
    for im in ann["images"]:
        boxes = [a["bbox"] for a in ann["annotations"] if a["image_id"] == im["id"]]
        assert 2 <= len(boxes) <= 4
        pixels = image_io.read_png(str(root / "images" / im["file_name"]))
        assert pixels.shape == (im["height"], im["width"], 3)
        for x, y, bw, bh in boxes:
            box = pixels[int(y):int(y + bh) + 1, int(x):int(x + bw) + 1]
            assert (box.max(axis=-1) == 255).all()


# ------------------------------------------------------------------ pipeline


def _examples(i):
    if i % 5 == 4:
        return None  # dropped, as load_fn may
    return {"images": np.full((2, 3, 3), i, np.float32), "boxes": np.full((3, 4), i),
            "classes": np.array([i, 0, 0]), "mask": np.array([True, False, False])}


def _run(cls, **kw):
    ds = cls(list(range(23)), _examples, num_workers=1, **kw)
    return [list(ds) for _ in range(2)]  # two epochs: the shuffle moves on


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, shuffle=False),
    dict(batch_size=3, bucket_key=lambda ex: int(ex["classes"][0]) % 3),
    dict(batch_size=3, bucket_key=lambda ex: int(ex["classes"][0]) % 3, pad_remainder=True),
    dict(batch_size=4, pad_remainder=True, seed=5,
         batch_transform=lambda b, i: dict(b, index=np.array(i)),
         on_epoch_start=lambda e: None),
], ids=["shuffled", "in_order", "bucketed", "bucketed_padded", "transformed"])
def test_host_dataset_equals_jax(kw):
    """``HostDataset`` with one worker: the same batches in the same order
    as the JAX package's over two epochs (shuffle, dropped examples,
    buckets, padded remainders with ``batch_valid``, batch transforms)."""
    ours, ref = _run(pipeline.HostDataset, **kw), _run(jax_pipeline.HostDataset, **kw)
    assert [len(e) for e in ours] == [len(e) for e in ref] and len(ours[0]) > 0
    for got, want in zip(sum(ours, []), sum(ref, [])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_host_dataset_errors_and_early_break():
    """A failing ``load_fn`` raises its error in the consumer, as in the JAX
    package; a consumer that breaks early leaves no producer running."""
    def bad(i):
        if i == 7:
            raise KeyError("image 7")
        return _examples(i)

    for cls in (pipeline.HostDataset, jax_pipeline.HostDataset):
        with pytest.raises(KeyError, match="image 7"):
            list(cls(list(range(12)), bad, 2, shuffle=False, num_workers=1))
    before = threading.active_count()
    for _ in range(3):
        for batch in pipeline.HostDataset(list(range(200)), _examples, 2, num_workers=2,
                                          prefetch=1):
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("fails", [False, True], ids=["end", "error"])
def test_host_dataset_slow_consumer_gets_the_end(fails):
    """A consumer that takes longer than a second over a batch while the
    queue is full at the end of the epoch still gets the end of the epoch,
    or the load error, after the last batch: it neither hangs nor loses
    the error."""
    def load(i):
        if fails and i == 2:
            raise KeyError("image 2")
        return _examples(i)

    seen, raised = [], []

    def consume():
        try:
            for batch in pipeline.HostDataset(list(range(3 if fails else 2)), load, 1,
                                              shuffle=False, num_workers=1, prefetch=1):
                seen.append(int(batch["classes"][0, 0]))
                if len(seen) == 1:
                    time.sleep(1.5)  # batch 1 fills the queue; the end waits behind it
        except KeyError as e:
            raised.append(e)

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive(), "the consumer hangs after the last batch"
    assert seen == [0, 1] and len(raised) == int(fails)


def test_multiscale_plan_equals_jax():
    """Rungs per example and per batch equal the JAX package's;
    ``resize_batch_to_rung`` within 2e-5 of cv2's float bilinear."""
    scales = ((32, 48), (40, 64), (48, 80))
    for key in (0, 7, "a/b.png", 123456789):
        for epoch in range(3):
            assert multiscale.example_rung(5, key, 3, epoch) == jax_ms.example_rung(5, key, 3,
                                                                                    epoch)
    assert [multiscale.batch_rung(5, b, 3) for b in range(20)] == [
        jax_ms.batch_rung(5, b, 3) for b in range(20)]
    ours, ref = multiscale.MultiScalePlan(scales, 5), jax_ms.MultiScalePlan(scales, 5, sync=False)
    assert ours.sync is False and ours.top == ref.top
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert [ours.size_for(k) for k in range(10)] == [ref.size_for(k) for k in range(10)]
    batch = {"images": np.random.default_rng(0).normal(size=(2, 48, 80, 3)).astype(np.float32),
             "boxes": np.zeros((2, 3, 4), np.float32)}
    got, want = multiscale.resize_batch_to_rung(batch, 32, 48), jax_ms.resize_batch_to_rung(
        batch, 32, 48)
    np.testing.assert_allclose(got["images"], want["images"], atol=2e-5)
    synced = multiscale.MultiScalePlan(scales, 5, sync=True)
    assert synced.bucket_key is None and synced.size_for(3) == (48, 80)
    assert synced.batch_transform(batch, 4)["images"].shape[1:3] == scales[
        jax_ms.batch_rung(5, 4, 3)]


# ------------------------------------------------------------------- loaders


def _configs(root, **kw):
    data = dict(data_dir=str(root), img_dir="images", ann_file="ann.json", ann_dir="ann")
    return (TrainingConfig(data=DataConfig(**data), **kw),
            JaxConfig(data=JaxDataConfig(**data), **kw))


def _compare_batches(ours, ref, image_atol):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for got, want in zip(ours, ref):
        assert got.keys() == want.keys()
        for k in want:
            if k == "images" and image_atol:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=image_atol)
            elif k == "boxes":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("augmentation, batch", [(None, 1), (None, 3), (False, 2), (True, 2)],
                         ids=["eval_b1", "eval_b3_bucketed", "resize", "augment"])
def test_coco_loader_equals_jax(coco_root, augmentation, batch):
    """``load_coco_dataset`` against the JAX loader on the same files, one
    worker, two epochs: the same class names, background class and batches
    in the same order. Original size (None, batch 1 and bucketed batch 3
    with ``batch_valid``) and resize-only (False: the height shrinks, where
    the linear resize is OpenCV's) are bit-equal; augmented images within
    one uint8 level after normalization, boxes within 1e-6."""
    ours_cfg, ref_cfg = _configs(coco_root, image_size=(48, 80), num_queries=10)
    kw = dict(augmentation=augmentation, bucket_divisor=64, num_workers=1, seed=1)
    ours, names = coco.load_coco_dataset(ours_cfg, batch, **kw)
    ref, ref_names = jax_coco.load_coco_dataset(ref_cfg, batch, **kw)
    assert names == ref_names and ours.background_class == ref.background_class == 8
    for _ in range(2):
        _compare_batches(ours, ref, NORMALIZED_LEVEL if augmentation else 0)
    # With instance masks (empty here: no annotation has a segmentation),
    # the same batches and t_masks.
    _compare_batches(coco.load_coco_dataset(ours_cfg, batch, include_masks=True, **kw)[0],
                     jax_coco.load_coco_dataset(ref_cfg, batch, include_masks=True, **kw)[0],
                     NORMALIZED_LEVEL if augmentation else 0)


def test_coco_loader_multi_scale_and_paper_protocol(coco_root):
    """Multi-scale batches bucketed by rung as the JAX loader buckets them
    (the same rungs, each batch one shape; images within one level), and
    the paper protocol's original-size examples within one level."""
    ladder = ((32, 48), (48, 80))
    ours_cfg, ref_cfg = _configs(coco_root, multi_scale=ladder, num_queries=10)
    kw = dict(augmentation=True, num_workers=1, seed=2)
    _compare_batches(coco.load_coco_dataset(ours_cfg, 2, **kw)[0],
                     jax_coco.load_coco_dataset(ref_cfg, 2, **kw)[0], NORMALIZED_LEVEL)
    kw = dict(augmentation=None, num_workers=1, paper_protocol=(100, 150), bucket_divisor=64)
    _compare_batches(coco.load_coco_dataset(ours_cfg, 1, **kw)[0],
                     jax_coco.load_coco_dataset(ref_cfg, 1, **kw)[0], NORMALIZED_LEVEL)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """A VOC set: JPEG images (cv2), XML annotations with three classes, an
    image without objects and an image without annotation file."""
    root = tmp_path_factory.mktemp("voc")
    (root / "images").mkdir()
    (root / "ann").mkdir()
    rng = np.random.default_rng(1)
    for i in range(7):
        h, w = (60, 80) if i % 2 else (72, 64)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        if i == 6:
            continue
        objs = "".join(
            f"<object><name> {['Dog', 'cat', 'bird'][(i + k) % 3]} </name><bndbox>"
            f"<xmin>{5 + k}</xmin><ymin>{6 + k}</ymin><xmax>{30 + k}</xmax>"
            f"<ymax>{40 + k}</ymax></bndbox></object>" for k in range(0 if i == 4 else 2))
        (root / "ann" / f"im{i}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>{objs}"
            "</annotation>")
    return root


@pytest.mark.parametrize("augmentation", [None, False, True], ids=["eval", "resize", "augment"])
def test_voc_loader_equals_jax(voc_root, augmentation):
    """``load_voc_dataset`` against the JAX loader: the same class names and
    labels, and batches as in the COCO loader's test (bit-equal but for
    augmentation, within one level there)."""
    ours_cfg, ref_cfg = _configs(voc_root, image_size=(48, 56), num_queries=10)
    kw = dict(augmentation=augmentation, num_workers=1, bucket_divisor=64)
    batch = 1 if augmentation is None else 2
    ours, names = voc.load_voc_dataset(ours_cfg, batch, **kw)
    ref, ref_names = jax_voc.load_voc_dataset(ref_cfg, batch, **kw)
    assert names == ref_names and ours.background_class == ref.background_class == 0
    for got, want in zip(voc.load_voc_labels(str(voc_root / "ann" / "im1.xml"), names),
                         jax_voc.load_voc_labels(str(voc_root / "ann" / "im1.xml"), names)):
        np.testing.assert_array_equal(got, want)
    _compare_batches(ours, ref, NORMALIZED_LEVEL if augmentation else 0)
