"""Serving, training and evaluating the port's instance-segmentation model
against the JAX package's, on the CPU: ``Predictor(masks=True)`` against
the JAX ``Predictor(masks=True)``, ``mask_rle`` over HTTP, one frozen-
detector ``Trainer.step`` against the JAX mask-head gradients,
``finetune_coco_masks`` and ``eval --masks`` (both mask lattices) against
the JAX ``eval_model`` on a synthetic set with polygon masks.

Both sides get the same variables (carried by ``from_jax_variables``) and
the same numpy inputs; the JAX side runs ``attn_impl="xla"``, the port its
plain versions. Tolerances are stated at each comparison.
"""

import importlib
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.data import load_coco_dataset as jax_load_coco
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.ops.losses import single_layer_loss as jax_single_layer_loss
from detr_tensorflow_tpu.ops.losses import total_from_log as jax_total_from_log
from detr_tensorflow_tpu.predictor import Predictor as JaxPredictor
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu.train import optimizers as jax_opt
from detr_tensorflow_tpu_torch import eval as port_eval
from detr_tensorflow_tpu_torch import inference
from detr_tensorflow_tpu_torch import finetune_coco_masks, serve
from detr_tensorflow_tpu_torch.data import masks as port_masks
from detr_tensorflow_tpu_torch.data import synthetic
from detr_tensorflow_tpu_torch.models import api
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops.matcher import hungarian_match_batch
from detr_tensorflow_tpu_torch.predictor import Predictor
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
from test_torch_serving import BOX_ATOL, SCORE_ATOL
from test_torch_training import make_batch, random_variables

SEG = dict(num_classes=5, num_queries=6, model_dim=64, num_heads=2, num_encoder_layers=1,
           num_decoder_layers=1, dim_feedforward=64, backbone_stage_sizes=(1, 1, 1, 1),
           masks=True)
PROB_BAND = 1e-5  # bool masks may differ only where |p - threshold| is below this
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7  # per tensor, relative to the JAX gradient's norm


@pytest.fixture(scope="module")
def seg_models():
    """The JAX segmentation DETR (seeded variables, nonzero FrozenBN
    statistics) and the port's from the same variables."""
    module = JaxDETR(dropout=0.0, attn_impl="xla", **SEG)
    variables = random_variables(module, jnp.zeros((1, 64, 64, 3)), seed=1)
    port = api.build_detr(device="cpu", dropout=0.0, **SEG)
    port.module.load_state_dict(from_jax_variables(variables), strict=True)
    return JaxDetrModel(module, variables), port


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def _kept_probs(pred, image):
    """The port's probabilities of one image's kept queries at its own
    size, (n, H, W), resized on the host (``upsample_mask_probs``)."""
    h, w = image.shape[:2]
    bh, bw = pred._bucket(h, w)
    frames = np.zeros((1, bh, bw, 3), np.uint8)
    frames[0, :h, :w] = image
    pm = np.zeros((1, bh, bw), bool)
    pm[0, :h, :w] = True
    (_, _, _, keep), probs = pred._run(frames, None if pm.all() else pm)
    kept = probs[0].numpy()[keep[0].numpy()]
    return inference.upsample_mask_probs(kept, (h, w)).transpose(2, 0, 1)


def test_predictor_masks_match_jax(seg_models):
    """``Predictor(masks=True)`` against the JAX one on a padded and a
    bucket-exact image: detections within the serving bounds; each
    detection's mask bool at its image's size, equal to JAX's (cv2's
    resize) except where the probability lies within 1e-5 of the
    threshold; the warm-up runs the masked route."""
    jax_model, port = seg_models
    images = _images(1, [(60, 90), (64, 64)])
    ref = JaxPredictor(jax_model, background_class=0, bucket_divisor=64, masks=True)(images)
    pred = Predictor(port, background_class=0, bucket_divisor=64, masks=True)
    pred.warmup([(60, 90)])
    ours = pred(images)
    for img, a, b in zip(images, ours, ref):
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        np.testing.assert_allclose(a.boxes, np.asarray(b.boxes), atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), atol=SCORE_ATOL, rtol=0)
        assert a.masks.dtype == bool and a.masks.shape == (len(a.labels),) + img.shape[:2]
        p = _kept_probs(pred, img)
        far = np.abs(p - 0.5) >= PROB_BAND
        assert np.array_equal(a.masks[far], (p > 0.5)[far])
        assert np.array_equal(a.masks[far], np.asarray(b.masks)[far])
    with pytest.raises(ValueError):
        Predictor(api.build_detr(device="cpu", **dict(SEG, masks=False)), 0, masks=True)


def test_http_mask_rle_decodes_to_the_predictor_mask(seg_models):
    """``serve`` with a masks predictor: each detection carries
    ``mask_rle``, which the port's ``rle_to_mask`` decodes to the
    ``Predictor``'s mask."""
    _, port = seg_models
    predictor = Predictor(port, background_class=0, bucket_divisor=64, masks=True)
    service = serve.DetrService(predictor, ["back", "a", "b", "c", "d"])
    httpd = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        img = _images(5, [(60, 90)])[0]
        buf = io.BytesIO()
        np.save(buf, img)
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/detect",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = json.loads(r.read())
        det = service.detect([img])[0]
        assert len(payload["detections"]) == len(det.masks) > 0
        for d, m in zip(payload["detections"], det.masks):
            assert d["mask_rle"]["size"] == [60, 90]
            np.testing.assert_array_equal(port_masks.rle_to_mask(d["mask_rle"]), m)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(timeout=10)


def _mask_batch(seed):
    batch = make_batch(seed)
    rng = np.random.default_rng(seed)
    batch["t_masks"] = (rng.random((2, 6, 16, 16)) < 0.4).astype(np.uint8)
    return batch


def test_frozen_detector_step_matches_jax(seg_models):
    """One ``Trainer.step`` of the frozen-detector recipe (``train_backbone``
    and ``train_transformers`` off, ``train_nlayers`` on) at dropout 0:
    loss and log (with mask_loss and dice_loss) to rtol 1e-5 against the
    JAX loss on the same variables and batch; every mask-head and
    attention-map gradient, after the per-tensor clip, within 1e-4 of the
    JAX gradient's norm (+1e-7); no other parameter takes a gradient or
    moves."""
    jax_model, port = seg_models
    variables = jax_model.variables
    batch = _mask_batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # One decoder layer: the loss is the final layer's. Its matching (the
    # port's, on the port's outputs, which agree with JAX's to ~1e-6) is
    # computed once outside the gradient, which only the heads take.
    with torch.no_grad():
        out = port.module(torch.from_numpy(batch["images"]))
    match = {k: jnp.asarray(v.numpy()) for k, v in hungarian_match_batch(
        out["pred_boxes"], out["pred_logits"], *(torch.from_numpy(batch[k]) for k in
                                                 ("boxes", "classes", "mask"))).items()}

    def loss_fn(heads):
        params = dict(variables["params"], **heads)
        o = jax_model.module.apply({"params": params, "frozen": variables["frozen"]},
                                   jb["images"], train=True)
        log = jax_single_layer_loss(o["pred_logits"], o["pred_boxes"], jb["boxes"],
                                    jb["classes"], jb["mask"], 0, match=match,
                                    p_masks=o["pred_masks"], t_masks=jb["t_masks"])
        return jax_total_from_log(log), log

    heads = {k: variables["params"][k] for k in ("mask_head", "bbox_attention")}
    (jtotal, jlog), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(heads)
    jclipped = from_jax_variables({"params": jax_opt.clip_by_leaf_norm(0.1).update(
        jgrads, None)[0]})

    model = api.build_detr(device="cpu", dropout=0.0, **SEG).module
    model.load_state_dict(port.module.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    config = TrainingConfig(train_backbone=False, train_transformers=False, train_nlayers=True,
                            target_batch=None, nlayers_lr=1e-3)
    log = Trainer(model, config, seed=0).step(batch)
    np.testing.assert_allclose(float(log["total_loss"]), float(jtotal), rtol=1e-5)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(log[key]), float(value), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    assert {"mask_loss", "dice_loss"} <= set(log)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(jclipped) == {n for n, g in grads.items() if g is not None}
    for name, ref in jclipped.items():
        diff = float((grads[name] - ref).norm())
        assert diff <= GRAD_RTOL * float(ref.norm()) + GRAD_ATOL, name
    for name, value in model.state_dict().items():
        moved = not torch.equal(value, before[name])
        assert moved == (name in jclipped), name


@pytest.fixture(scope="module")
def mask_coco(tmp_path_factory):
    """A synthetic COCO set with polygon masks: 4 odd-sized images in one
    padding bucket, 1-3 boxes each."""
    root = tmp_path_factory.mktemp("mask_coco")
    synthetic.make_synthetic_coco(str(root), n_images=4, seed=6, masks=True,
                                  sizes=[(70, 90), (57, 101)], boxes_per_image=(1, 3))
    return root


def _data_argv(root, *extra):
    return ["--data_dir", str(root), "--img_dir", "images", "--ann_file", "ann.json",
            "--device", "cpu", "--num_workers", "1", *extra]


# The entry points pad targets to the config's 100 queries.
ENTRY = dict(SEG, num_queries=100, model_dim=16, dim_feedforward=32)


@pytest.mark.parametrize("lattice", ["full", "stride4"])
def test_eval_masks_equals_jax_eval_model(mask_coco, lattice, tmp_path):
    """``eval --masks`` on a tiny masks model loaded from the JAX ``.npz``:
    the box and mask AP tables equal to the JAX ``eval_model``'s on the same
    weights and images, to 1e-6, at either mask lattice."""
    module = JaxDETR(dropout=0.0, attn_impl="xla", **dict(ENTRY, num_classes=4))
    variables = random_variables(module, jnp.zeros((1, 64, 64, 3)), seed=7)
    path = str(tmp_path / "segm.npz")
    JaxDetrModel(module, variables).save(path)
    jax_eval = importlib.import_module("eval")
    config = JaxConfig(data=JaxDataConfig(data_dir=str(mask_coco), img_dir="images",
                                          ann_file="ann.json"))
    valid_dt, class_names = jax_load_coco(config, 1, augmentation=None, num_workers=1,
                                          include_masks=True,
                                          full_res_masks=lattice == "full")
    config = config.replace(background_class=valid_dt.background_class)
    want = jax_eval.eval_model(JaxDetrModel(module, variables), config, class_names, valid_dt,
                               mask_lattice=lattice)
    got = port_eval.main(_data_argv(mask_coco, "--weights", path, "--masks", "--mask_lattice",
                                    lattice), dropout=0.0,
                         **{k: v for k, v in ENTRY.items() if k not in ("masks", "num_classes")},
                         num_classes=4)
    assert set(got) == set(want) == {"box", "mask"}
    for kind in want:
        for k, v in want[kind].items():
            assert abs(got[kind][k] - v) <= 1e-6, (kind, k)


def test_finetune_coco_masks_trains_the_mask_head(mask_coco):
    """``finetune_coco_masks`` for two steps on the synthetic set: the mask
    head and the attention-map projections move, the detector does not,
    and the step logs mask_loss and dice_loss; ``--panoptic_ann`` reads its
    json (tests/test_torch_panoptic.py trains on one)."""
    argv = _data_argv(mask_coco, "--epochs", "1", "--steps_per_epoch", "2",
                      "--evaluation_steps", "1", "--batch_size", "2", "--target_batch", "2",
                      "--image_size", "64", "64")
    kw = {k: v for k, v in ENTRY.items() if k != "masks"}
    before = api.build_detr(device="cpu", masks=True, **kw).module.state_dict()
    trainer = finetune_coco_masks.main(argv, **kw)
    assert trainer.steps == 2
    for name, value in trainer.model.state_dict().items():
        moved = not torch.equal(value, before[name])
        assert moved == name.startswith(("mask_head.", "bbox_attention.")), name
    batch = next(iter(trainer.prefetch(_train_batches(trainer))))
    log = trainer.step(batch)
    assert {"mask_loss", "dice_loss"} <= set(log)
    with pytest.raises(FileNotFoundError):
        finetune_coco_masks.main(argv + ["--panoptic_ann", "x.json"], **kw)


def _train_batches(trainer):
    from detr_tensorflow_tpu_torch.data import load_coco_dataset

    ds, _ = load_coco_dataset(trainer.config, 2, augmentation=True, include_masks=True,
                              num_workers=1)
    return ds
