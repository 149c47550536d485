"""The port's panoptic path against the JAX package's, on the CPU: the COCO
panoptic loaders (``data/panoptic.py``), panoptic quality
(``metrics/pq.py``), the full-resolution merge on the model's device
(``inference.merge_full_res``), ``eval --masks --pq --panoptic_ann`` and
``finetune_coco_masks --panoptic_ann``, the 250-query things+stuff
training recipe of ``tests/test_panoptic.py``, and the plain LAP at the
recipe's 250 columns.

The data is a PNG-only twin of ``tests/test_panoptic.py``'s ``panoptic_root``
(odd sizes, a thing, a stuff strip with id 265, VOID, and here a crowd
segment with id 70000 in the B channel): JAX reads it with cv2, the port
with its own PNG decoder, and two PNG decoders agree bit for bit where two
JPEG decoders need not. Both sides get the same variables and numpy
inputs; tolerances are stated at each comparison.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import inference as jax_inference
from detr_tensorflow_tpu.data import panoptic as jax_panoptic
from detr_tensorflow_tpu.metrics import pq as jax_pq
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.ops import matcher as jax_matcher
from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch import eval as port_eval
from detr_tensorflow_tpu_torch import finetune_coco_masks, inference
from detr_tensorflow_tpu_torch.data import image_io
from detr_tensorflow_tpu_torch.data import panoptic
from detr_tensorflow_tpu_torch.metrics import pq
from detr_tensorflow_tpu_torch.models import api
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops import lap
from detr_tensorflow_tpu_torch.train import DataConfig, Trainer, TrainingConfig
from detr_tensorflow_tpu_torch.train.checkpoint import restore_latest, save_checkpoint
from test_torch_data import NORMALIZED_LEVEL
from test_torch_training import random_variables

H, W = 61, 77  # odd sizes on purpose
# The JAX panoptic test's tiny segmentation model (tests/test_panoptic.py).
TINY = dict(backbone_stage_sizes=(1, 1, 1, 1), masks=True, model_dim=16, num_heads=2,
            num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32)
PQ_ATOL = 1e-12  # the same numpy arithmetic on both sides
TABLE_ATOL = 1e-6  # AP and PQ of the eval entry points (eval --masks's bound)
LOSS_RTOL = 1e-4  # a fp32 step's loss, port against JAX


def _id_png(id_map):
    return np.stack([id_map % 256, (id_map // 256) % 256, id_map // 65536], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """Two 61x77 PNG images with segment-id PNGs: a thing (id 7, class 1),
    a stuff strip (id 265, class 12), VOID (id 0); the second image also
    holds a crowd thing (id 70000, class 1) and gives the stuff strip no
    ``bbox`` (its box comes from its mask)."""
    root = tmp_path_factory.mktemp("panoptic_png")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    (root / "panoptic").mkdir()
    images, annotations = [], []
    for i in range(2):
        image_io.write_png(str(root / "images" / f"{i}.png"),
                           rng.integers(0, 255, (H, W, 3), np.uint8))
        id_map = np.zeros((H, W), np.int32)
        id_map[5:30, 5:40] = 7
        id_map[35:61, :] = 265
        segments = [{"id": 7, "category_id": 1, "iscrowd": 0, "bbox": [5, 5, 35, 25],
                     "area": 875},
                    {"id": 265, "category_id": 12, "iscrowd": 0, "bbox": [0, 35, 77, 26],
                     "area": 77 * 26}]
        if i == 1:
            id_map[8:20, 50:70] = 70000
            segments.append({"id": 70000, "category_id": 1, "iscrowd": 1,
                             "bbox": [50, 8, 20, 12], "area": 240})
            del segments[1]["bbox"]
        image_io.write_png(str(root / "panoptic" / f"{i}.png"), _id_png(id_map))
        images.append({"id": i, "file_name": f"{i}.png", "height": H, "width": W})
        annotations.append({"image_id": i, "file_name": f"{i}.png", "segments_info": segments})
    (root / "panoptic.json").write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "thing_a", "isthing": 1},
                       {"id": 12, "name": "stuff_b", "isthing": 0}]}))
    return root


def _paths(root):
    return dict(ann_file=str(root / "panoptic.json"), png_dir=str(root / "panoptic"),
                img_dir=str(root / "images"))


def _configs(root, **kw):
    data = dict(data_dir=str(root), img_dir="images", ann_file="panoptic.json")
    return JaxConfig(data=JaxDataConfig(**data), **kw), TrainingConfig(data=DataConfig(**data),
                                                                       **kw)


def _assert_batches_equal(got, want, image_atol=1e-6):
    """Batches key for key: images within ``image_atol`` (the C++ normalizer
    against numpy's float32 arithmetic, 1e-6; one uint8 level where the
    augmentation resamples, as the detection loaders' tests allow), boxes
    within 1e-6, every other key equal."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("images", "boxes"):
                np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=0, err_msg=k,
                                           atol=image_atol if k == "images" else 1e-6)
            else:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_segments_match_jax(seed):
    """``decode_segment_png`` and ``segments_to_masks`` bit-equal to JAX's on
    random 24-bit ids, segments_info naming known and unknown ids, crowd
    flags given and missing."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 ** 24, size=6)
    id_map = ids[rng.integers(0, 6, size=(13, 17))].astype(np.int32)
    id_map[0, 0] = 0
    png = _id_png(id_map)
    np.testing.assert_array_equal(panoptic.decode_segment_png(png), id_map)
    np.testing.assert_array_equal(panoptic.decode_segment_png(png),
                                  jax_panoptic.decode_segment_png(png))
    info = [{"id": int(i), "category_id": int(c)} for i, c in zip(ids[:4], rng.integers(1, 99, 4))]
    info[1]["iscrowd"] = 1
    info.append({"id": 2 ** 24 + 5, "category_id": 3, "iscrowd": 0})  # in no pixel
    for got, want in zip(panoptic.segments_to_masks(id_map, info),
                         jax_panoptic.segments_to_masks(id_map, info)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    empty = panoptic.segments_to_masks(id_map, [])
    assert empty[0].shape == (0, 13, 17) and empty[3].all()


@pytest.mark.parametrize("bucket", [32, 128])
def test_eval_loader_matches_jax(png_root, bucket):
    """``load_coco_panoptic``'s examples equal JAX's key for key (images and
    boxes to 1e-6), ``t_masks_full``, ``gt_is_crowd`` and
    ``void_mask`` included; the set's attributes and class names equal."""
    jconfig, config = _configs(png_root, num_queries=6)
    want, jnames = jax_panoptic.load_coco_panoptic(jconfig, 1, bucket_divisor=bucket,
                                                   num_workers=1, **_paths(png_root))
    got, names = panoptic.load_coco_panoptic(config, 1, bucket_divisor=bucket, num_workers=1,
                                             **_paths(png_root))
    assert names == jnames and names[1] == "thing_a" and names[12] == "stuff_b"
    for attr in ("background_class", "stuff_classes", "thing_classes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert (got.background_class, got.stuff_classes, got.thing_classes) == (13, [12], [1])
    batches = list(got)
    _assert_batches_equal(batches, list(want))
    crowd = batches[1]
    assert crowd["gt_is_crowd"][0].tolist() == [False, False, True]
    assert crowd["void_mask"][0][0, 0] and not crowd["void_mask"][0][H:].any()
    with pytest.raises(ValueError):
        panoptic.load_coco_panoptic(config, 2, **_paths(png_root))


@pytest.mark.parametrize("seed", [0, 3])
def test_train_loader_matches_jax(png_root, seed):
    """``load_coco_panoptic_train`` at one ``WorkerRNG`` seed: the augmented
    batches equal JAX's (images within one uint8 level after normalization,
    boxes within 1e-6; classes, slots and the stride-4 ``t_masks``
    exactly), the crowd segment dropped and the stuff class among the
    targets."""
    jconfig, config = _configs(png_root, image_size=(64, 96), num_queries=6)
    want, _ = jax_panoptic.load_coco_panoptic_train(jconfig, 2, num_workers=1, seed=seed,
                                                    **_paths(png_root))
    got, names = panoptic.load_coco_panoptic_train(config, 2, num_workers=1, seed=seed,
                                                   **_paths(png_root))
    assert got.stuff_classes == [12] and got.background_class == len(names) - 1
    batches = list(got)
    _assert_batches_equal(batches, list(want), NORMALIZED_LEVEL)
    b = batches[0]
    assert b["t_masks"].shape == (2, 6, 16, 24)
    classes = b["classes"][b["mask"]]
    assert (classes == 12).any() and (classes == 1).any()


def _rects(h, w, rects):
    masks = np.zeros((len(rects), h, w), bool)
    for m, (y0, y1, x0, x1) in zip(masks, rects):
        m[y0:y1, x0:x1] = True
    return masks


def _seg_map(masks):
    seg = np.full(masks.shape[1:], -1, np.int32)
    for i, m in enumerate(masks):
        seg[m] = i
    return seg


def _protocol_case(name):
    """The cases of ``tests/test_panoptic.py``'s ``TestPQProtocol`` as
    ``panoptic_quality`` arguments, and random maps with crowd, VOID and
    stuff."""
    void = np.zeros((20, 20), bool)
    if name == "void_overlap":
        void[10:, :] = True
        preds = _rects(20, 20, [(0, 10, 0, 10), (12, 18, 2, 18)])
        return dict(pred_seg_maps=[_seg_map(preds)], pred_labels=[np.asarray([1, 1])],
                    gt_masks=[_rects(20, 20, [(0, 10, 0, 10)])], gt_classes=[np.asarray([1])],
                    void_masks=[void])
    if name == "union_void":
        void[6:10, :] = True
        return dict(pred_seg_maps=[_seg_map(_rects(20, 20, [(0, 10, 0, 10)]))],
                    pred_labels=[np.asarray([7])], gt_masks=[_rects(20, 20, [(0, 6, 0, 10)])],
                    gt_classes=[np.asarray([7])], void_masks=[void])
    if name == "crowd":
        crowd = _rects(20, 20, [(0, 20, 0, 10)])
        preds = [_rects(20, 20, [(2, 18, 1, 9)]), _rects(20, 20, [(2, 18, 12, 19)])]
        return dict(pred_seg_maps=[_seg_map(p) for p in preds],
                    pred_labels=[np.asarray([4]), np.asarray([5])], gt_masks=[crowd, crowd],
                    gt_classes=[np.asarray([4])] * 2, gt_iscrowd=[np.asarray([True])] * 2)
    if name == "stuff_split":
        gt = _rects(16, 16, [(0, 8, 0, 16), (8, 16, 0, 16)])
        return dict(pred_seg_maps=[_seg_map(gt)], pred_labels=[np.asarray([1, 30])],
                    gt_masks=[gt], gt_classes=[np.asarray([1, 30])], stuff_classes=[30])
    rng = np.random.default_rng(int(name.split()[-1]))
    args = {k: [] for k in ("pred_seg_maps", "pred_labels", "gt_masks", "gt_classes",
                            "gt_iscrowd", "void_masks")}
    for _ in range(3):
        h, w = rng.integers(20, 40, size=2)
        gt_ids = rng.integers(0, 6, size=(h, w))
        noise = rng.random((h, w)) < 0.2  # predictions: the ground truth, 20% scrambled
        pred = np.where(noise, rng.integers(-1, 7, size=(h, w)), gt_ids - 1).astype(np.int32)
        args["pred_seg_maps"].append(pred)
        args["pred_labels"].append(rng.integers(1, 5, size=7))
        args["gt_masks"].append(np.stack([gt_ids == i for i in range(1, 6)]))
        args["gt_classes"].append(rng.integers(1, 5, size=5))
        args["gt_iscrowd"].append(rng.random(5) < 0.2)
        args["void_masks"].append(gt_ids == 0)
    return dict(args, stuff_classes=[3, 4])


def _assert_tables_close(got, want, atol, path="pq"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tables_close(got[k], want[k], atol, f"{path}.{k}")
    else:
        assert abs(got - want) <= atol, (path, got, want)


@pytest.mark.parametrize("case", ["void_overlap", "union_void", "crowd", "stuff_split",
                                  "random 0", "random 1", "random 2"])
def test_panoptic_quality_matches_jax(case):
    """``panoptic_quality`` on the four protocol cases of the JAX tests and on
    random maps with crowd, VOID and stuff: the whole table (per class
    tp/fp/fn, sq, rq, pq, the things and stuff sub-tables) equal to JAX's to
    1e-12."""
    args = _protocol_case(case)
    want = jax_pq.panoptic_quality(**args)
    got = pq.panoptic_quality(**args)
    _assert_tables_close(got, want, PQ_ATOL)
    if case == "void_overlap":
        assert (got["per_class"][1]["tp"], got["per_class"][1]["fp"]) == (1, 0)
    if case.startswith("random"):
        assert got["n_classes"] > 0 and {"things", "stuff"} <= set(got)


def test_panoptic_quality_from_outputs_matches_jax():
    """``panoptic_quality_from_outputs`` on the same logits and mask logits:
    the stride-4 merge and its table equal JAX's."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 8, 6)).astype(np.float32)
    logits[..., 2] += 1.0
    masks = (3 * rng.normal(size=(2, 8, 12, 14))).astype(np.float32)
    gt = [rng.random((3, 12, 14)) < 0.4 for _ in range(2)]
    classes = [np.asarray([1, 2, 3])] * 2
    want = jax_pq.panoptic_quality_from_outputs(
        {"pred_logits": jnp.asarray(logits), "pred_masks": jnp.asarray(masks)}, gt, classes, 5)
    got = pq.panoptic_quality_from_outputs(
        {"pred_logits": torch.from_numpy(logits), "pred_masks": torch.from_numpy(masks)}, gt,
        classes, 5)
    _assert_tables_close(got, want, PQ_ATOL)


@pytest.mark.parametrize("hw,kept", [((61, 77), 5), ((45, 130), 12), ((33, 30), 0)])
def test_device_merge_matches_jax_np_merge_full_res(hw, kept):
    """``kept_probs`` then ``merge_full_res`` (the eval's full-resolution
    merge on the model's device, here the CPU) against JAX's
    ``np_merge_full_res(upsample_mask_probs(...))`` (cv2's resize): the
    winning query equal wherever the two best weighted scores lie further
    apart than 1e-5 and the winner's probability further than 1e-5 from the
    threshold; no kept query gives -1 everywhere."""
    h, w = hw
    rng = np.random.default_rng(h * w + kept)
    q, hs, ws = 20, -(-h // 32) * 8, -(-w // 32) * 8
    probs = rng.random((q, hs, ws)).astype(np.float32)
    keep = np.zeros(q, bool)
    keep[rng.permutation(q)[:kept]] = True
    scores = rng.random(q).astype(np.float32)
    up = inference.kept_probs(torch.from_numpy(probs), keep, h, w)
    got = inference.merge_full_res(up, scores[keep])
    assert got.dtype == np.int32 and got.shape == (h, w)
    jax_up = jax_inference.upsample_mask_probs(probs[keep], (h, w))
    want = jax_inference.np_merge_full_res(jax_up, scores[keep], np.ones(kept, bool)) if kept \
        else np.full((h, w), -1, np.int32)
    if not kept:
        np.testing.assert_array_equal(got, want)
        return
    weighted = jax_up * scores[keep]
    top2 = np.sort(weighted, axis=-1)[..., -2:]
    best = np.take_along_axis(jax_up, weighted.argmax(-1)[..., None], -1)[..., 0]
    far = (top2[..., 1] - top2[..., 0] > 1e-5) & (np.abs(best - 0.5) > 1e-5)
    assert far.mean() > 0.9
    np.testing.assert_array_equal(got[far], want[far])


@pytest.fixture(scope="module")
def tiny_npz(png_root, tmp_path_factory):
    """A tiny segmentation model over the set's 14 classes and 100 queries,
    seeded JAX variables saved as the JAX ``.npz``."""
    module = JaxDETR(dropout=0.0, attn_impl="xla", num_classes=14, num_queries=100, **TINY)
    variables = random_variables(module, jnp.zeros((1, 64, 64, 3)), seed=21)
    path = str(tmp_path_factory.mktemp("panoptic_npz") / "segm.npz")
    JaxDetrModel(module, variables).save(path)
    return JaxDetrModel(module, variables), path


@pytest.mark.parametrize("lattice", ["full", "stride4"])
def test_eval_pq_matches_jax_eval_model(png_root, tiny_npz, lattice):
    """``eval --masks --pq --panoptic_ann`` through ``main`` on the tiny
    model loaded from the JAX ``.npz``: the box, mask and PQ tables (with
    the things and stuff splits) equal to the JAX ``eval_model``'s on the
    same weights and set, to 1e-6, at either mask lattice."""
    jax_model, path = tiny_npz
    jax_eval = importlib.import_module("eval")
    jconfig, _ = _configs(png_root)
    valid_dt, class_names = jax_panoptic.load_coco_panoptic(jconfig, 1, num_workers=1,
                                                            **_paths(png_root))
    jconfig = jconfig.replace(background_class=valid_dt.background_class)
    want = jax_eval.eval_model(jax_model, jconfig, class_names, valid_dt, report_pq=True,
                               mask_lattice=lattice, stuff_classes=valid_dt.stuff_classes)
    got = port_eval.main(
        ["--data_dir", str(png_root), "--img_dir", "images", "--ann_file", "panoptic.json",
         "--device", "cpu", "--num_workers", "1", "--weights", path, "--masks", "--pq",
         "--panoptic_ann", str(png_root / "panoptic.json"), "--panoptic_png_dir",
         str(png_root / "panoptic"), "--mask_lattice", lattice],
        dropout=0.0, num_classes=14, **{k: v for k, v in TINY.items() if k != "masks"})
    assert set(got) == set(want) == {"box", "mask", "pq"}
    assert {"things", "stuff", "per_class"} <= set(got["pq"])
    for kind in ("box", "mask"):
        _assert_tables_close(got[kind], want[kind], TABLE_ATOL, kind)
    _assert_tables_close(got["pq"], want["pq"], TABLE_ATOL)


def test_eval_pq_panoptic_is_batch_one(png_root, tiny_npz, capsys):
    """``eval --pq --panoptic_ann`` refuses a batch, as JAX's eval.py does."""
    _, path = tiny_npz
    argv = ["--data_dir", str(png_root), "--img_dir", "images", "--ann_file", "panoptic.json",
            "--device", "cpu", "--num_workers", "1", "--weights", path, "--masks", "--pq",
            "--panoptic_ann", str(png_root / "panoptic.json"), "--batch", "2"]
    with pytest.raises(SystemExit):
        port_eval.main(argv, num_classes=14, **{k: v for k, v in TINY.items() if k != "masks"})
    assert "panoptic eval is batch-1" in capsys.readouterr().err


@pytest.mark.parametrize("lattice", ["full", "stride4"])
def test_eval_things_only_pq_matches_jax(tmp_path, lattice):
    """``eval --masks --pq`` without panoptic ground truth, on a synthetic
    COCO set with polygon masks: the things-only PQ (stride 4: the merge of
    every query's unmasked mask logits, as JAX scores it; full: the kept
    queries merged at each image's size) and the AP tables equal to the JAX
    ``eval_model``'s to 1e-6."""
    from detr_tensorflow_tpu.data import load_coco_dataset as jax_load_coco
    from detr_tensorflow_tpu_torch.data import synthetic

    synthetic.make_synthetic_coco(str(tmp_path), n_images=3, seed=8, masks=True,
                                  sizes=[(70, 90), (57, 101)], boxes_per_image=(1, 3))
    module = JaxDETR(dropout=0.0, attn_impl="xla", num_classes=4, num_queries=100, **TINY)
    variables = random_variables(module, jnp.zeros((1, 64, 64, 3)), seed=23)
    path = str(tmp_path / "segm.npz")
    JaxDetrModel(module, variables).save(path)
    jconfig = JaxConfig(data=JaxDataConfig(data_dir=str(tmp_path), img_dir="images",
                                           ann_file="ann.json"))
    valid_dt, class_names = jax_load_coco(jconfig, 1, augmentation=None, num_workers=1,
                                          include_masks=True, full_res_masks=lattice == "full")
    jconfig = jconfig.replace(background_class=valid_dt.background_class)
    want = importlib.import_module("eval").eval_model(
        JaxDetrModel(module, variables), jconfig, class_names, valid_dt, report_pq=True,
        mask_lattice=lattice)
    got = port_eval.main(
        ["--data_dir", str(tmp_path), "--img_dir", "images", "--ann_file", "ann.json",
         "--device", "cpu", "--num_workers", "1", "--weights", path, "--masks", "--pq",
         "--mask_lattice", lattice], dropout=0.0, num_classes=4,
        **{k: v for k, v in TINY.items() if k != "masks"})
    assert set(got) == set(want) == {"box", "mask", "pq"} and "things" not in got["pq"]
    for kind in want:
        _assert_tables_close(got[kind], want[kind], TABLE_ATOL, kind)


def _jax_first_loss(jmodel, variables, batch, background):
    """The JAX fp32 loss of the model on the batch (its train forward at
    dropout 0, Hungarian matching by the JAX matcher, mask losses)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def loss(params):
        out = jmodel.apply({"params": params, "frozen": variables["frozen"]}, jb["images"],
                           train=True)
        return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], background,
                             t_masks=jb["t_masks"])[0]

    return float(loss(variables["params"]))


def test_250query_things_stuff_end_to_end(png_root, tmp_path):
    """The JAX package's panoptic training recipe (tests/test_panoptic.py:
    250 queries and 250 target slots over things+stuff, every group
    training) on the port: the first step's loss within 1e-4 relative of the
    JAX loss on the same weights and batch, the loss falling over four
    steps, the train state round-tripping through ``train/checkpoint.py``
    bit for bit mid-run, and PQ computing from the trained weights with the
    things and stuff split."""
    _, config = _configs(png_root, image_size=(64, 96), num_queries=250, batch_size=2,
                         target_batch=None, train_backbone=True, train_transformers=True,
                         train_nlayers=True, backbone_lr=1e-3, transformers_lr=1e-3,
                         nlayers_lr=1e-3)
    dataset, class_names = panoptic.load_coco_panoptic_train(config, 2, num_workers=1,
                                                             **_paths(png_root))
    config = config.replace(background_class=dataset.background_class)
    batch = next(iter(dataset))
    assert batch["boxes"].shape[1] == 250 and batch["t_masks"].shape[1] == 250

    kw = dict(num_classes=len(class_names), num_queries=250, **TINY)
    jmodule = JaxDETR(dropout=0.0, attn_impl="xla", **kw)
    variables = random_variables(jmodule, jnp.zeros((1, 64, 96, 3)), seed=22)
    model = api.build_detr(device="cpu", dropout=0.0, **kw)
    model.module.load_state_dict(from_jax_variables(variables), strict=True)
    assert model.module.query_embed.shape[0] == 250
    trainer = Trainer(model.module, config, seed=0)
    first = float(trainer.step(batch)["total_loss"])
    want = _jax_first_loss(jmodule, variables, batch, config.background_class)
    np.testing.assert_allclose(first, want, rtol=LOSS_RTOL)
    for _ in range(3):
        trainer.step(batch)

    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(trainer, ckpt)
    restored = restore_latest(Trainer(api.build_detr(device="cpu", dropout=0.0, **kw).module,
                                      config, seed=5), ckpt)
    assert restored.steps == trainer.steps == 4
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    last = float(restored.step(batch)["total_loss"])
    assert np.isfinite(last) and last < first

    eval_dt, _ = panoptic.load_coco_panoptic(config, 1, bucket_divisor=32, num_workers=1,
                                             **_paths(png_root))
    table = port_eval.eval_model(api.DetrModel(restored.model), config, class_names, eval_dt,
                                 report_pq=True, stuff_classes=eval_dt.stuff_classes)
    assert 0.0 <= table["pq"]["pq"] <= 1.0 and {"things", "stuff"} <= set(table["pq"])
    assert np.isfinite(table["box"]["all"])


def test_finetune_coco_masks_panoptic_main(png_root, tiny_npz):
    """``finetune_coco_masks --panoptic_ann`` through ``main``: two
    frozen-detector steps on the panoptic train loader (no evaluation set),
    only the mask head and the attention-map projections move, and the
    step logs the mask losses."""
    _, path = tiny_npz
    kw = dict(num_classes=14, **{k: v for k, v in TINY.items() if k != "masks"})
    argv = ["--data_dir", str(png_root), "--img_dir", "images", "--ann_file", "panoptic.json",
            "--device", "cpu", "--num_workers", "1", "--weights", path,
            "--panoptic_ann", str(png_root / "panoptic.json"), "--panoptic_png_dir",
            str(png_root / "panoptic"), "--epochs", "2", "--steps_per_epoch", "1",
            "--batch_size", "2", "--target_batch", "2", "--image_size", "64", "96"]
    before = api.build_detr(device="cpu", masks=True, weights=path, **kw).module.state_dict()
    trainer = finetune_coco_masks.main(argv, **kw)
    assert trainer.steps == 2
    for name, value in trainer.model.state_dict().items():
        moved = not torch.equal(value, before[name])
        assert moved == name.startswith(("mask_head.", "bbox_attention.")), name
    dataset, _ = panoptic.load_coco_panoptic_train(trainer.config, 2, num_workers=1,
                                                   **_paths(png_root))
    log = trainer.step(next(iter(dataset)))
    assert {"mask_loss", "dice_loss"} <= set(log) and np.isfinite(float(log["total_loss"]))


def test_plain_lap_at_250_columns_matches_jax_solver():
    """The plain LAP at the panoptic recipe's (6, 250, 250), scattered row
    masks with 0-250 real rows, against the JAX ``matcher.solve_lap_masked``
    (its default ``lax.while_loop`` solver): equal assignments, continuous
    costs having one optimum."""
    rng = np.random.default_rng(250)
    cost = rng.normal(size=(6, 250, 250)).astype(np.float32)
    n_real = np.asarray([0, 250, 60, 17, 133, 1])
    mask = np.stack([rng.permutation(np.arange(250) < n) for n in n_real])
    got = lap.reference_solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    want = np.stack([np.asarray(jax_matcher.solve_lap_masked(jnp.asarray(c), jnp.asarray(m)))
                     for c, m in zip(cost, mask)])
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == -1).all() and all(len(set(g[m])) == n for g, m, n in
                                             zip(got, mask, n_real))
