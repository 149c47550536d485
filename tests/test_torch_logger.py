"""The port's logger (``detr_tensorflow_tpu_torch/logger``) and
``eval_loop(..., class_names, evaluation_step, log_fn, visual_log)`` against
the JAX package's.

``wandb`` is not installed: both packages' senders are then silent, and a
fake module patched into both ``wandb_logging`` modules records what would
be sent. Tables are held equal, drawn images bit-equal (cv2 draws both),
losses to 1e-4 relative (fp32 in two frameworks).
"""

import jax
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import logger as jax_logger
from detr_tensorflow_tpu.logger import wandb_logging as jax_wandb_logging
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu.train import Trainer as JaxTrainer
from detr_tensorflow_tpu.train import eval_loop as jax_eval_loop
from detr_tensorflow_tpu_torch import inference, logger
from detr_tensorflow_tpu_torch.logger import wandb_logging
from detr_tensorflow_tpu_torch.metrics import MeanAPEvaluator
from detr_tensorflow_tpu_torch.ops import boxes
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig, eval_loop, fit
from test_torch_training import jax_model_and_variables, make_batch, port_model  # noqa: F401
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

CLASS_NAMES = ("zero", "one", "two", "three", "four")
BACKGROUND = 4
LOSS_RTOL = 1e-4


class FakeWandb:
    """What the senders call of ``wandb``: ``Image``, ``log`` and
    ``run.summary.update``, recorded."""

    class Image:
        def __init__(self, image, caption=""):
            self.image, self.caption = np.array(image), caption

    class _Run:
        def __init__(self):
            self.summary = {}

    def __init__(self):
        self.logged = []
        self.run = self._Run()

    def log(self, data, step=None):
        self.logged.append((data, step))


@pytest.fixture
def fake_wandb(monkeypatch):
    """A fresh FakeWandb in each package's ``wandb_logging``."""
    fakes = FakeWandb(), FakeWandb()
    monkeypatch.setattr(wandb_logging, "wandb", fakes[0])
    monkeypatch.setattr(jax_wandb_logging, "wandb", fakes[1])
    return fakes


@pytest.fixture
def flushed_tables(monkeypatch):
    """Every table ``send_ap_data`` flushes, per package (``valid_log``
    drops it)."""
    tables = {"port": [], "jax": []}
    for key, cls in (("port", wandb_logging.WandbSender), ("jax", jax_wandb_logging.WandbSender)):
        send = cls.send_ap_data

        def recording(step, prefix="val/", send=send, key=key):
            table = send(step, prefix=prefix)
            tables[key].append(table)
            return table

        monkeypatch.setattr(cls, "send_ap_data", recording)
    return tables


def _outputs(seed, batch=None, b=2, q=6, masks=False):
    """Seeded outputs; given a batch, each real target's query predicts its
    box (jittered) and leans to its class, so the AP is neither 0 nor 100."""
    rng = np.random.default_rng(seed)
    out = {"pred_logits": rng.normal(size=(b, q, len(CLASS_NAMES))).astype(np.float32),
           "pred_boxes": np.concatenate([rng.uniform(0.3, 0.7, (b, q, 2)),
                                         rng.uniform(0.1, 0.4, (b, q, 2))], -1).astype(np.float32)}
    if batch is not None:
        real = batch["mask"]
        jitter = rng.normal(scale=0.03, size=real.shape + (4,))
        out["pred_boxes"][real] = (batch["boxes"] + jitter)[real].clip(0.05, 0.95)
        out["pred_logits"][real, batch["classes"][real]] += 2.0
    if masks:
        out["pred_masks"] = rng.normal(size=(b, q, 16, 16)).astype(np.float32)
    return out


def test_valid_log_gives_jax_table(flushed_tables):
    """Three validation batches through both ``valid_log``s on the same
    numpy outputs (the port's as torch tensors): one flush each, on the
    third batch, with equal tables."""
    config = TrainingConfig(background_class=BACKGROUND)
    jax_config = JaxConfig(background_class=BACKGROUND)
    for step in range(3):
        batch = make_batch(10 + step)
        out = _outputs(step, batch)
        logger.valid_log(batch, {k: torch.from_numpy(v) for k, v in out.items()}, config, step,
                         7, CLASS_NAMES, evaluation_step=3)
        jax_logger.valid_log(batch, out, jax_config, step, 7, CLASS_NAMES, evaluation_step=3)
        assert len(flushed_tables["port"]) == len(flushed_tables["jax"]) == (step == 2)
    assert len(flushed_tables["port"]) == len(flushed_tables["jax"]) == 1
    ours, ref = flushed_tables["port"][0], flushed_tables["jax"][0]
    assert ours == ref and 0 < ours["box"]["all"] < 100
    assert logger.WandbSender._ap_evaluator is None  # flushed and reset


@pytest.mark.parametrize("masks", [False, True])
def test_train_log_and_scalars_send_what_jax_sends(fake_wandb, masks):
    """``train_log`` on its cadence (a step off it sends nothing), with a
    segmentation model's masks blended under the boxes, ``send_scalars``
    and ``send_ap_data``: the same keys, steps, captions and images."""
    ours, ref = fake_wandb
    batch = make_batch(3)
    out = _outputs(4, batch, masks=masks)
    batch["images"] = np.random.default_rng(5).normal(size=(2, 16, 16, 3)).astype(np.float32)
    config = TrainingConfig(background_class=BACKGROUND)
    jax_config = JaxConfig(background_class=BACKGROUND)
    for step in (0, 5, 10):
        logger.train_log(batch, {k: torch.from_numpy(v) for k, v in out.items()}, config, step,
                         CLASS_NAMES, log_every=10)
        jax_logger.train_log(batch, out, jax_config, step, CLASS_NAMES, log_every=10)
    logger.WandbSender.send_scalars({"loss": 1.5, "giou": 0.25}, 10, prefix="train/")
    jax_logger.WandbSender.send_scalars({"loss": 1.5, "giou": 0.25}, 10, prefix="train/")
    for sender in (logger.WandbSender, jax_logger.WandbSender):
        sender.compute_map_on_batch(np.array([[0.1, 0.1, 0.5, 0.5]]), np.array([1]),
                                    np.array([0.9]), np.array([[0.1, 0.1, 0.5, 0.5]]),
                                    np.array([1]), len(CLASS_NAMES))
        sender.send_ap_data(11)
    assert len(ours.logged) == len(ref.logged) == 4
    for (got, step), (want, want_step) in zip(ours.logged, ref.logged):
        assert step == want_step and sorted(got) == sorted(want)
        for key, value in got.items():
            if isinstance(value, list):  # the images: prediction then target, step 0 and 10
                assert [i.caption for i in value] == [i.caption for i in want[key]]
                for a, b in zip(value, want[key]):
                    np.testing.assert_array_equal(a.image, b.image)
            else:
                assert value == want[key], key
    assert [s for _, s in ours.logged] == [0, 10, 10, 11]
    assert ours.run.summary == ref.run.summary and "val/map_box_50" in ours.run.summary


@pytest.mark.parametrize("installed", [False, True])
def test_senders_are_silent_without_wandb_or_its_run(monkeypatch, installed):
    """No wandb, or wandb without a started run (its ``log`` raises before
    ``init``): images and scalars go nowhere, ``train_log`` draws nothing
    (so it needs no cv2), and the mAP table is still returned."""
    fake = FakeWandb()
    fake.run = None
    fake.log = None  # would raise if called
    monkeypatch.setattr(wandb_logging, "wandb", fake if installed else None)
    monkeypatch.setattr(inference, "numpy_bbox_to_image", None)  # would raise if called
    sender = logger.WandbSender()
    sender.gather_inference_image(np.zeros((4, 4, 3), np.uint8))
    assert sender.images == []
    sender.send_images("x", 0)
    logger.WandbSender.send_scalars({"a": 1.0}, 0)
    logger.train_log(make_batch(1), {k: torch.from_numpy(v) for k, v in _outputs(1).items()},
                     TrainingConfig(), 0, CLASS_NAMES)
    logger.WandbSender.compute_map_on_batch(np.zeros((0, 4)), np.zeros(0), np.zeros(0),
                                            np.array([[0.1, 0.1, 0.5, 0.5]]), np.array([1]), 3)
    table = logger.WandbSender.send_ap_data(0)
    assert table["box"]["all"] == 0.0 and logger.WandbSender.send_ap_data(0) is None


@pytest.fixture(scope="module")
def trainers(jax_model_and_variables):  # noqa: F811
    """The port's and JAX's trainers on the same reduced model, and three
    validation batches."""
    module, variables = jax_model_and_variables
    kw = dict(background_class=BACKGROUND, target_batch=None, train_backbone=True,
              train_transformers=True)
    config, jax_config = TrainingConfig(**kw), JaxConfig(**kw)
    port = Trainer(port_model(variables), config, seed=0)
    ref = JaxTrainer(module, jax.device_get(variables), jax_config)
    return port, config, ref, jax_config, [make_batch(20 + i) for i in range(3)]


def test_eval_loop_visual_log_matches_jax(trainers, flushed_tables):
    """``eval_loop(trainer, ds, config, class_names, evaluation_step=2,
    visual_log=True)``, positionally as the JAX entry points call it, on a
    set of three batches: two batches run, their losses are JAX's, the
    table flushed on the second equals a ``MeanAPEvaluator`` fed the
    port's outputs, and JAX's."""
    port, config, ref, jax_config, batches = trainers
    logs = eval_loop(port, batches, config, CLASS_NAMES, evaluation_step=2, visual_log=True)
    want = jax_eval_loop(ref, batches, jax_config, CLASS_NAMES, evaluation_step=2,
                         visual_log=True)
    assert len(logs) == len(want) == 2
    for got, exp in zip(logs, want):
        for key in ("total_loss", "label_cost", "giou_loss", "l1_loss"):
            np.testing.assert_allclose(got[key], float(exp[key]), rtol=LOSS_RTOL, err_msg=key)
    evaluator = MeanAPEvaluator(len(CLASS_NAMES))
    for batch in batches[:2]:
        outputs, _ = port.evaluate(batch)
        for b in range(len(batch["images"])):
            p_box, p_label, p_score = inference.get_model_inference(
                {k: outputs[k][b:b + 1] for k in ("pred_logits", "pred_boxes")}, BACKGROUND,
                bbox_format="xyxy")
            n = int(batch["mask"][b].sum())
            evaluator.add_image(p_box, p_label, p_score,
                                boxes.np_xcycwh_to_xyxy(batch["boxes"][b][:n]),
                                batch["classes"][b][:n])
    assert flushed_tables["port"] == [evaluator.compute()]
    assert flushed_tables["jax"] == flushed_tables["port"]


def test_eval_loop_takes_class_names_positionally_as_jax(trainers):
    """The JAX entry points' calls, ``eval_loop(trainer, ds, config,
    class_names, evaluation_step=N)`` and ``fit(trainer, ds, config, epoch,
    class_names)``: the fourth and fifth arguments are the class names, not
    ``evaluation_step`` or ``log_fn``."""
    port, config, _, _, batches = trainers
    assert len(eval_loop(port, batches, config, CLASS_NAMES, evaluation_step=1)) == 1
    assert len(eval_loop(port, batches, config, list(CLASS_NAMES))) == 3
    steps = port.steps
    assert fit(port, batches[:1], config, 0, CLASS_NAMES, log_every=1) is True
    assert port.steps == steps + 1
