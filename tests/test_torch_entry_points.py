"""The port's entry points and the engine pieces they run, on the CPU,
against the JAX package where it has the same thing: ``python -m
detr_tensorflow_tpu_torch.{eval,train_coco,finetune_coco,finetune_voc,
quickstart}`` on synthetic sets with tiny models, the training parser,
``PreemptionGuard`` with checkpoint and resume, and a walk over the
package's imports. The card-only checks of ``Trainer.prefetch`` are in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib
import json
import os
import pkgutil
import signal
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import detr_tensorflow_tpu_torch
from detr_tensorflow_tpu.data import load_coco_dataset as jax_load_coco
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.train import DataConfig as JaxDataConfig
from detr_tensorflow_tpu.train import Trainer as JaxTrainer
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu.train import eval_loop as jax_eval_loop
from detr_tensorflow_tpu.train import training_config_parser as jax_parser
from detr_tensorflow_tpu_torch import eval as port_eval
from detr_tensorflow_tpu_torch import finetune_coco, finetune_voc, quickstart, train_coco
from detr_tensorflow_tpu_torch.models import build_detr
from detr_tensorflow_tpu_torch.train import (
    DataConfig, PreemptionGuard, Trainer, TrainingConfig, fit, latest_step, restore_latest,
    training_config_parser, workflow,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tiny model of the JAX package's script tests (tests/test_scripts.py),
# with the config's 100 queries, to which the loaders pad the targets.
TINY = dict(num_queries=100, model_dim=16, num_heads=2, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=32, backbone_stage_sizes=(1, 1, 1, 1))
# A port forward differs from JAX's by float32 rounding: validation losses
# are held to this relative tolerance.
LOSS_RTOL = 1e-5
SIZES = [(70, 90), (70, 90), (70, 90), (40, 50), (40, 50)]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """Five cv2-written images in two padding buckets, each with two boxes,
    one of them at the same place in every image (so a model that predicts
    it scores some AP), categories 1 and 2."""
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        cv2.imwrite(str(root / "images" / f"i{i}.png"),
                    rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({"id": i, "file_name": f"i{i}.png", "height": h, "width": w})
        for bbox in ([5.0, 5.0, 20.0, 20.0], [float(rng.integers(0, 20)), 10.0, 15.0, 12.0]):
            anns.append({"id": len(anns), "image_id": i, "category_id": int(rng.integers(1, 3)),
                         "bbox": bbox, "iscrowd": 0})
    (root / "ann.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    return root


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A tiny JAX DETR's variables saved as ``.npz``: seeded, with a box head
    that predicts near the (5, 5, 20, 20) box of a 70x90 image, so AP is
    neither 0 nor 100."""
    module = JaxDETR(num_classes=4, dropout=0.0, **TINY)
    variables = jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    head = dict(variables["params"]["bbox_embed"]["layer_2"])
    box = np.array([15 / 90, 15 / 70, 20 / 90, 20 / 70])
    head["kernel"] = np.asarray(head["kernel"]) * 0.2
    head["bias"] = np.log(box / (1 - box)).astype(np.float32)
    variables["params"]["bbox_embed"]["layer_2"] = head
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    JaxDetrModel(module, variables).save(path)
    return module, variables, path


@pytest.fixture(scope="module")
def jax_seeded_weights(tmp_path_factory):
    """The tiny JAX DETR's seeded variables as they are, saved as ``.npz``:
    its queries' boxes differ, so no two matchings tie in cost."""
    module = JaxDETR(num_classes=4, dropout=0.0, **TINY)
    variables = jax.device_get(module.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    path = str(tmp_path_factory.mktemp("weights") / "seeded.npz")
    JaxDetrModel(module, variables).save(path)
    return module, variables, path


def _data_argv(root, *extra):
    return ["--data_dir", str(root), "--img_dir", "images", "--ann_file", "ann.json",
            "--device", "cpu", "--num_workers", "2", *extra]


def test_eval_main_equals_jax_eval_model(coco_root, jax_weights):
    """``eval.main`` on the tiny model loaded from the JAX ``.npz``
    (``--weights``): the AP table equal to the JAX ``eval.py:eval_model``'s
    on the same weights and images, at batch 1 and ``--batch 3`` (two
    buckets, one padded), and the COCOeval protocol's table too."""
    module, variables, path = jax_weights
    jax_eval = importlib.import_module("eval")
    config = JaxConfig(data=JaxDataConfig(data_dir=str(coco_root), img_dir="images",
                                          ann_file="ann.json"))
    valid_dt, class_names = jax_load_coco(config, 1, augmentation=None, num_workers=1)
    config = config.replace(background_class=valid_dt.background_class)
    want = jax_eval.eval_model(JaxDetrModel(module, variables), config, class_names, valid_dt,
                               protocol="cocoeval")
    assert 0 < want["box"]["all"] < 100
    for batch in ("1", "3"):
        got = port_eval.main(_data_argv(coco_root, "--weights", path, "--batch", batch,
                                        "--protocol", "cocoeval"),
                             num_classes=4, dropout=0.0, **TINY)
        assert got == want, batch
    with pytest.raises(SystemExit):  # panoptic eval is batch 1, as JAX's eval.py:299-300
        port_eval.main(_data_argv(coco_root, "--masks", "--pq", "--panoptic_ann", "p.json",
                                  "--batch", "2"), num_classes=4, **TINY)


def test_python_m_eval_runs_detr_r50(coco_root):
    """``python -m detr_tensorflow_tpu_torch.eval`` as a user runs it, on
    the CPU: DETR-R50 at full width from its seeded initialization over the
    five images prints the AP table; every other entry point answers
    ``--help``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-m", "detr_tensorflow_tpu_torch.eval",
                          *_data_argv(coco_root, "--batch", "2")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "box |" in run.stdout and "mask |" in run.stdout
    for name in ("train_coco", "finetune_coco", "finetune_voc", "finetune_hardhat", "quickstart"):
        run = subprocess.run([sys.executable, "-m", f"detr_tensorflow_tpu_torch.{name}",
                              "--help"], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0 and "--device" in run.stdout, name


def test_finetune_coco_main_validation_equals_jax(coco_root, jax_seeded_weights, monkeypatch):
    """``finetune_coco.main`` from the JAX ``.npz``: its first validation pass
    (before any step) gives the JAX trainer's ``eval_loop`` losses on the
    same weights and batches within LOSS_RTOL; then it trains two epochs of
    two steps, and every loss stays finite."""
    _, variables, path = jax_seeded_weights
    seen = []

    def recording(*args, **kw):
        logs = workflow_eval_loop(*args, **kw)
        seen.append(logs)
        return logs

    workflow_eval_loop = workflow.eval_loop
    monkeypatch.setattr(workflow, "eval_loop", recording)
    argv = _data_argv(coco_root, "--weights", path, "--batch_size", "2", "--target_batch", "2",
                      "--image_size", "64", "64", "--epochs", "2", "--steps_per_epoch", "2",
                      "--evaluation_steps", "2")
    trainer = finetune_coco.main(argv, num_classes=4, dropout=0.0, **TINY)
    assert trainer.steps == 4 and len(seen) == 2
    config = JaxConfig(data=JaxDataConfig(data_dir=str(coco_root), img_dir="images",
                                          ann_file="ann.json"),
                       image_size=(64, 64), batch_size=2, train_transformers=True,
                       auto_input_layout=False)
    valid_dt, _ = jax_load_coco(config, 2, augmentation=False, shuffle=False, num_workers=1)
    config = config.replace(background_class=valid_dt.background_class)
    jax_trainer = JaxTrainer(JaxDETR(num_classes=4, dropout=0.0, **TINY), variables,
                             config)
    want = jax_eval_loop(jax_trainer, valid_dt, config, evaluation_step=2)
    assert len(seen[0]) == len(want) == 2
    for got, ref in zip(seen[0], want):
        for key in ("total_loss", "label_cost", "giou_loss", "l1_loss"):
            np.testing.assert_allclose(got[key], float(ref[key]), rtol=LOSS_RTOL, err_msg=key)
    assert all(np.isfinite(log["total_loss"]) for logs in seen for log in logs)


def test_train_coco_main_checkpoints_and_resumes(coco_root, tmp_path):
    """``train_coco.main`` trains from scratch with augmentation through
    ``Trainer.prefetch`` (two epochs of two steps, a checkpoint after each
    epoch); ``restore_latest`` into a fresh trainer gives back its state,
    and one more step from both is the same step."""
    ckpt = str(tmp_path / "ckpt")
    argv = _data_argv(coco_root, "--batch_size", "2", "--target_batch", "2", "--image_size",
                      "64", "64", "--epochs", "2", "--steps_per_epoch", "2",
                      "--evaluation_steps", "1", "--checkpoint_dir", ckpt)
    trainer = train_coco.main(argv, dropout=0.0, **TINY)
    assert trainer.steps == 4 and latest_step(ckpt) == 4
    assert trainer.config.normalized_method == "tf_resnet" and trainer.config.train_nlayers
    fresh = Trainer(build_detr(num_classes=4, head="finetune", nb_class=4, dropout=0.0,
                               device="cpu", **TINY).module, trainer.config)
    restore_latest(fresh, ckpt)
    assert fresh.steps == 4
    batch = next(iter(trainer.prefetch([_batch(0)])))
    a, b = trainer.step(batch), fresh.step(batch)
    assert float(a["total_loss"]) == float(b["total_loss"])
    for (name, p), q in zip(trainer.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), name


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    (root / "JPEGImages").mkdir()
    (root / "Annotations").mkdir()
    rng = np.random.default_rng(2)
    for i in range(4):
        cv2.imwrite(str(root / "JPEGImages" / f"{i:04d}.jpg"),
                    rng.integers(0, 255, (60, 80, 3)).astype(np.uint8))
        (root / "Annotations" / f"{i:04d}.xml").write_text(
            "<annotation><size><width>80</width><height>60</height></size>"
            f"<object><name>{['dog', 'cat'][i % 2]}</name><bndbox><xmin>10</xmin><ymin>12"
            "</ymin><xmax>40</xmax><ymax>45</ymax></bndbox></object></annotation>")
    return root


def test_finetune_voc_main_unfreezes_at_epoch_one(voc_root):
    """``finetune_voc.main`` on a VOC set of JPEG images: epoch 0 trains the
    heads only, epoch 1 the transformer too at 1e-4 (the staged unfreeze);
    backbone weights never move."""
    argv = ["--data_dir", str(voc_root), "--img_dir", "JPEGImages", "--ann_dir", "Annotations",
            "--device", "cpu", "--batch_size", "2", "--target_batch", "2", "--image_size", "64",
            "64", "--epochs", "2", "--evaluation_steps", "1", "--num_workers", "2"]
    torch.manual_seed(0)
    trainer = finetune_voc.main(argv, dropout=0.0, **TINY)
    assert trainer.steps == 4
    assert trainer.config.train_transformers and trainer._lrs["transformers"] == 1e-4
    assert not any(p.requires_grad for n, p in trainer.model.named_parameters()
                   if n.startswith("backbone."))


def test_quickstart_main_runs(tmp_path):
    """``quickstart.main`` on the CPU for two epochs: the AP table's rows."""
    table = quickstart.main(["--device", "cpu", "--epochs", "2", "--root", str(tmp_path)])
    assert set(table) == {"box", "mask"} and np.isfinite(table["box"]["all"])


@pytest.mark.parametrize("argv", [
    [],
    ["--data_dir", "/d", "--img_dir", "im", "--ann_file", "a.json", "--batch_size", "4",
     "--image_size", "320", "480", "--train_backbone", "--transformers_lr", "3e-4",
     "--target_batch", "16", "--log", "--compute_dtype", "bfloat16", "--checkpoint_dir", "c"],
    ["--ann_dir", "ann", "--multi_scale", "320", "576", "376", "672", "--train_nlayers",
     "--finetuning", "--backbone_depth", "101", "--background_class", "0",
     "--gradient_norm_clipping", "0.5", "--nlayers_lr", "1e-3", "--backbone_lr", "2e-5"],
    ["--data_parallel", "2", "--batch_size", "8"],
], ids=["defaults", "coco_train", "voc_multi_scale", "data_parallel"])
def test_parser_gives_jax_fields(argv):
    """The same argv through both parsers and ``update_from_args``: every
    field the two configs share is equal, and the data paths too."""
    ours = TrainingConfig().update_from_args(training_config_parser().parse_args(argv))
    ref = JaxConfig().update_from_args(jax_parser().parse_args(argv))
    shared = {f.name for f in dataclasses.fields(ours)} & {f.name for f in dataclasses.fields(ref)}
    assert len(shared) >= 20
    for name in sorted(shared - {"data", "attn_impl", "lap_impl"}):
        assert getattr(ours, name) == getattr(ref, name), name
    assert dataclasses.asdict(ours.data) == dataclasses.asdict(ref.data)
    assert ours.data.full_ann_file == ref.data.full_ann_file
    port_only = training_config_parser().parse_args(["--attn_impl", "kernel", "--lap_impl",
                                                     "plain", "--weights", "w.npz"])
    cfg = TrainingConfig().update_from_args(port_only)
    assert (cfg.attn_impl, cfg.lap_impl, cfg.weights) == ("kernel", "plain", "w.npz")
    with pytest.raises(SystemExit):
        TrainingConfig().update_from_args(training_config_parser().parse_args(
            ["--multi_scale", "1", "2", "3"]))


def _batch(seed):
    from test_torch_training import make_batch

    return make_batch(seed, t=6)


def test_preemption_guard_checkpoints_and_resumes(tmp_path):
    """SIGTERM during ``fit`` under a ``PreemptionGuard``: the step in flight
    finishes, a checkpoint is written and ``fit`` returns False; restored
    into a fresh trainer, the rest of the epoch gives the parameters of an
    uninterrupted run. The guard restores the previous handler on exit."""
    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None,
                            backbone_lr=1e-3, transformers_lr=1e-3, checkpoint_dir=str(tmp_path))
    batches = [_batch(s) for s in range(4)]

    def trainer():
        return Trainer(build_detr(num_classes=5, dropout=0.1, device="cpu", seed=3,
                                  **TINY).module, config, seed=1)

    reference = trainer()
    assert fit(reference, batches, config.replace(checkpoint_dir=None), 0)
    interrupted = trainer()
    previous = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        done = fit(interrupted, batches, config, 0, preemption_guard=guard, log_every=1,
                   log_fn=lambda log, step: step == 2 and os.kill(os.getpid(), signal.SIGTERM))
    assert signal.getsignal(signal.SIGTERM) is previous
    # The signal lands while step 2 is logged: step 3, in flight, finishes.
    assert done is False and guard.requested and interrupted.steps == 3
    assert latest_step(str(tmp_path)) == 3
    resumed = trainer()
    restore_latest(resumed, str(tmp_path))
    assert resumed.steps == 3
    assert fit(resumed, batches[3:], config.replace(checkpoint_dir=None), 0)
    for (name, p), q in zip(reference.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name


def test_package_imports_no_jax_cv2_or_pil():
    """Every module of ``detr_tensorflow_tpu_torch`` and ``chip_smoke.py``
    imported in a fresh process: none of jax, flax, ml_dtypes, cv2, PIL,
    imageio, pandas or ``detr_tensorflow_tpu`` is loaded."""
    names = [m.name for m in pkgutil.walk_packages(detr_tensorflow_tpu_torch.__path__,
                                                   "detr_tensorflow_tpu_torch.")]
    assert {"detr_tensorflow_tpu_torch.eval", "detr_tensorflow_tpu_torch.data.image_io",
            "detr_tensorflow_tpu_torch.metrics.ap", "detr_tensorflow_tpu_torch.data.panoptic",
            "detr_tensorflow_tpu_torch.metrics.pq", "detr_tensorflow_tpu_torch.data.jpeg",
            "detr_tensorflow_tpu_torch.data.tfcsv",
            "detr_tensorflow_tpu_torch.finetune_hardhat"} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names + ['chip_smoke']!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'cv2', 'PIL', 'imageio', 'pandas', "
            "'detr_tensorflow_tpu'))\n"
            "print(bad)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"
