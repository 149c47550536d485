"""Weights & Biases sender (port of
``detr_tensorflow_tpu/logger/wandb_logging.py``).

Buffered box-overlay images, the validation mAP accumulated over the
batches of an evaluation pass and flushed once, and scalars. ``wandb`` is
optional and imported behind a guard. Without it, or without a run that
``wandb.init`` started (``enabled``), every image and scalar send does
nothing, while the mAP is still accumulated and ``send_ap_data`` still
returns its table. (The JAX package sends whenever wandb imports, and
wandb raises in ``log`` before ``init``.)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..metrics import MeanAPEvaluator

_UNLOADED = object()
# The wandb module, None where it does not import; imported at the first
# send, so importing the package does not pay for it.
wandb = _UNLOADED


def enabled() -> bool:
    """Whether sends go anywhere: wandb imported and a run started."""
    global wandb
    if wandb is _UNLOADED:
        try:  # optional: not a dependency of the package
            import wandb as module
        except Exception:  # wandb is absent or broken
            module = None
        wandb = module
    return wandb is not None and wandb.run is not None


class WandbSender:
    """Buffers images and metrics and pushes them to wandb when present."""

    # One evaluator for the class, as the reference's static AP_DATA: the
    # validation batches accumulate into it until ``send_ap_data``.
    _ap_evaluator: Optional[MeanAPEvaluator] = None

    def __init__(self):
        self.images = []

    def gather_inference_image(self, image: np.ndarray, caption: str = "") -> None:
        if not enabled():
            return
        self.images.append(wandb.Image(image, caption=caption))

    def send_images(self, key: str, step: int) -> None:
        if not enabled() or not self.images:
            self.images = []
            return
        wandb.log({key: self.images}, step=step)
        self.images = []

    @staticmethod
    def send_scalars(scalars: dict, step: int, prefix: str = "") -> None:
        if not enabled():
            return
        wandb.log({f"{prefix}{k}": v for k, v in scalars.items()}, step=step)

    @classmethod
    def init_ap_data(cls, num_classes: int, class_names: Optional[Sequence[str]] = None) -> None:
        cls._ap_evaluator = MeanAPEvaluator(num_classes, class_names=class_names)

    @classmethod
    def compute_map_on_batch(cls, p_boxes, p_labels, p_scores, t_boxes, t_labels,
                             num_classes: int) -> None:
        """Accumulate one image's detections (corner-format boxes)."""
        if cls._ap_evaluator is None or cls._ap_evaluator.num_classes != num_classes:
            cls.init_ap_data(num_classes)
        cls._ap_evaluator.add_image(p_boxes, p_labels, p_scores, t_boxes, t_labels)

    @classmethod
    def send_ap_data(cls, step: int, prefix: str = "val/") -> Optional[dict]:
        """Log the accumulated mAP to wandb, reset the accumulator and
        return the table (None when nothing was accumulated)."""
        if cls._ap_evaluator is None:
            return None
        table = cls._ap_evaluator.compute()
        if enabled():
            scalars = {
                f"{prefix}map_box_all": table["box"]["all"],
                f"{prefix}map_box_50": table["box"][50],
                f"{prefix}map_mask_all": table["mask"]["all"],
                f"{prefix}map_mask_50": table["mask"][50],
            }
            wandb.log(scalars, step=step)
            wandb.run.summary.update(scalars)
        cls._ap_evaluator = None
        return table
