"""Train and validation logging hooks (port of
``detr_tensorflow_tpu/logger/training_logging.py``).

Every ``log_every`` training steps ``train_log`` draws the predicted and
the target boxes on the first image of the batch and sends both to wandb;
each validation batch ``valid_log`` adds its detections to the mAP
accumulator and flushes it on the pass's last batch. Host work: the
model's outputs are copied off the device once a batch. Without wandb or
its run (``wandb_logging.enabled``) the overlays are not drawn (nothing
would receive them), so ``train_log`` needs no cv2 there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import inference as inference_lib
from ..ops import boxes as bbox_ops
from . import wandb_logging
from .wandb_logging import WandbSender


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_tensor(x) -> torch.Tensor:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _first_image_overlays(images, batch, m_outputs, config, class_names, max_images=1):
    sender = WandbSender()
    logits, boxes = _host_tensor(m_outputs["pred_logits"]), _host_tensor(m_outputs["pred_boxes"])
    for b in range(min(max_images, images.shape[0])):
        img = _host(images[b])
        outputs_b = {"pred_logits": logits[b:b + 1], "pred_boxes": boxes[b:b + 1]}
        p_bbox, p_labels, p_scores = inference_lib.get_model_inference(
            outputs_b, config.background_class)
        base = img.copy()
        if "pred_masks" in m_outputs:  # blend the instance masks under the boxes
            probs = 1.0 / (1.0 + np.exp(-_host(m_outputs["pred_masks"][b])))
            keep = np.argmax(logits[b].numpy(), axis=-1) != config.background_class
            base = inference_lib.numpy_masks_to_image(base, (probs > 0.5)[keep], labels=None,
                                                      config=config)
        sender.gather_inference_image(inference_lib.numpy_bbox_to_image(
            base, p_bbox, p_labels, p_scores, class_names, config), caption="prediction")
        n = int(_host(batch["mask"][b]).sum())
        sender.gather_inference_image(inference_lib.numpy_bbox_to_image(
            img.copy(), _host(batch["boxes"][b])[:n], _host(batch["classes"][b])[:n], None,
            class_names, config), caption="target")
    return sender


def train_log(batch, m_outputs, config, step, class_names, prefix="train/",
              log_every: int = 100) -> None:
    """Every ``log_every`` steps, the first image's predicted and target
    boxes to wandb under ``{prefix}images``."""
    if step % log_every != 0 or not wandb_logging.enabled():
        return
    sender = _first_image_overlays(batch["images"], batch, m_outputs, config, class_names)
    sender.send_images(f"{prefix}images", step)


def valid_log(batch, m_outputs, config, val_step, global_step, class_names,
              evaluation_step: int = 200, prefix="val/") -> None:
    """Add one validation batch's detections (corner boxes, through
    ``inference.get_model_inference``) against its real targets to the mAP
    accumulator; on batch ``evaluation_step - 1`` flush it
    (``WandbSender.send_ap_data``)."""
    logits, boxes = _host_tensor(m_outputs["pred_logits"]), _host_tensor(m_outputs["pred_boxes"])
    t_mask, t_boxes = _host(batch["mask"]), _host(batch["boxes"])
    t_classes = _host(batch["classes"])
    num_classes = logits.shape[-1]
    for b in range(logits.shape[0]):
        p_bbox, p_labels, p_scores = inference_lib.get_model_inference(
            {"pred_logits": logits[b:b + 1], "pred_boxes": boxes[b:b + 1]},
            config.background_class, bbox_format="xyxy")
        n = int(t_mask[b].sum())
        WandbSender.compute_map_on_batch(p_bbox, p_labels, p_scores,
                                         bbox_ops.np_xcycwh_to_xyxy(t_boxes[b][:n]),
                                         t_classes[b][:n], num_classes)
    if val_step + 1 >= evaluation_step:
        WandbSender.send_ap_data(global_step, prefix=prefix)
