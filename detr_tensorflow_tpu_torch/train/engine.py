"""Training engine (port of ``detr_tensorflow_tpu/train/engine.py``).

One step is: forward with dropout, Hungarian matching of the final and
every auxiliary decoder layer in one LAP solve, the set loss, backward,
and the three-group Adam with per-tensor clipnorm and accumulation. On
the card the attention runs through kernels A and A' and the matching
through kernel B; matching and loss never synchronise with the host, and
the step returns its log as device tensors, so consecutive steps queue
back to back. ``fit`` reads the log on its logging cadence only.

``Trainer`` owns the model's optimizer state and the dropout generator,
a ``torch.Generator`` on the model's device seeded from an explicit seed:
every dropout mask and every attention-kernel seed is drawn from it, on
the device. Left out of this port: the AUTO-layout AOT step, meshes and
the 1F1B schedule, and the preemption guard (it comes with the data
entry points).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..ops.losses import detr_loss
from . import optimizers as opt_lib

_TARGET_KEYS = ("images", "boxes", "classes", "mask", "pixel_mask")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A native batch ('images' (B, H, W, 3), 'boxes' (B, T, 4), 'classes'
    (B, T), 'mask' (B, T), optional 'pixel_mask' (B, H, W)) of numpy
    arrays or tensors, as tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in _TARGET_KEYS if k in batch}


def forward_loss(model, batch, config, train: bool, generator=None, match=None):
    """Forward and set loss of one batch already on the device:
    (total, log, outputs)."""
    out = model(batch["images"], batch.get("pixel_mask"), train=train, generator=generator)
    total, log = detr_loss(out, batch["boxes"], batch["classes"], batch["mask"],
                           int(config.background_class), lap_impl=config.lap_impl,
                           match=match)
    return total, log, out


def make_train_step(model, optimizer: opt_lib.GroupOptimizer, config) -> Callable:
    """The train step: (batch, lrs, generator) -> log. The gradients of the
    step stay in the parameters' ``.grad`` until the next step."""

    def step_fn(batch, lrs: Dict[str, float], generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        total, log, _ = forward_loss(model, batch, config, True, generator)
        total.backward()
        optimizer.step(lrs)
        log = {k: v.detach() for k, v in log.items()}
        log["total_loss"] = total.detach()
        log["backbone_lr"] = lrs["backbone"]
        log["transformers_lr"] = lrs["transformers"]
        log["nlayers_lr"] = lrs["nlayers"]
        return log

    return step_fn


def make_eval_step(model, config) -> Callable:
    """The validation step: batch -> (outputs, log), no dropout, no grad."""

    def step_fn(batch):
        with torch.no_grad():
            total, log, out = forward_loss(model, batch, config, False)
        log = dict(log)
        log["total_loss"] = total
        return out, log

    return step_fn


class Trainer:
    """Model, optimizer state, dropout generator and step count.

    ``model`` is a ``models.detr.DETR`` (float32) on its device; the trainer
    sets which of its parameters require gradients from the config's
    train_* flags.
    """

    def __init__(self, model: torch.nn.Module, config, seed: int = 0):
        if getattr(model, "dtype", torch.float32) != torch.float32:
            raise NotImplementedError("training is float32 only: bf16 with fp32 master "
                                      "weights is not ported yet")
        if getattr(model, "fuse_residual", False) or getattr(model, "fuse_bottleneck", False):
            raise ValueError("the fused backbone kernels (fuse_residual, fuse_bottleneck) "
                             "are inference only, as in the JAX package: train the unfused "
                             "model and load its weights into a fused one to serve")
        self.model = model
        self.config = config
        self.device = model.query_embed.device
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.steps = 0
        self.optimizer = opt_lib.make_optimizer(config, model)
        self.train_step = make_train_step(model, self.optimizer, config)
        self.eval_step = make_eval_step(model, config)
        self._lrs = opt_lib.lr_dict(config)

    def set_learning_rates(self, **kw) -> None:
        """Change group learning rates; the next step uses them."""
        for k, v in kw.items():
            if k not in self._lrs:
                raise KeyError(f"unknown optimizer group {k!r}")
            self._lrs[k] = float(v)

    def set_trainable(self, **kw) -> None:
        """Flip train_{backbone,transformers,nlayers}: the optimizer is
        rebuilt with fresh moments; parameters and step count stay."""
        self.config = self.config.replace(**kw)
        self.optimizer = opt_lib.make_optimizer(self.config, self.model)
        self.train_step = make_train_step(self.model, self.optimizer, self.config)
        self._lrs = opt_lib.lr_dict(self.config)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        log = self.train_step(batch_to_device(batch, self.device), self._lrs, self.generator)
        self.steps += 1
        return log

    def evaluate(self, batch):
        return self.eval_step(batch_to_device(batch, self.device))

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """Parameters and FrozenBN statistics (the model's state_dict)."""
        return self.model.state_dict()

    def state_dict(self) -> dict:
        """The full training state: parameters, FrozenBN buffers, the Adam
        moments of every group, accumulation buffers, step count and the
        dropout generator's state."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "steps": self.steps, "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps = int(state["steps"])
        self.generator.set_state(state["generator"])


def _host_log(log) -> Dict[str, float]:
    return {k: float(v) for k, v in log.items()}


def fit(trainer: Trainer, train_dataset, config, epoch_nb: int, log_fn=None,
        log_every: int = 100, checkpoint_every: Optional[int] = None) -> bool:
    """One epoch over ``train_dataset``, an iterable of native batches. The
    log is read back (a host sync) only every ``log_every`` steps; with
    ``checkpoint_every`` and ``config.checkpoint_dir`` the full state is
    saved periodically. Returns True when the epoch completed."""
    t0 = time.time()
    for epoch_step, batch in enumerate(train_dataset):
        log = trainer.step(batch)
        if checkpoint_every and config.checkpoint_dir and (epoch_step + 1) % checkpoint_every == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(trainer, config.checkpoint_dir)
        if epoch_step % log_every == 0:
            host = _host_log(log)
            if log_fn is not None:
                log_fn(host, trainer.steps)
            print(f"Epoch: [{epoch_nb}], \t Step: [{epoch_step}], \t "
                  f"ce: [{host['label_cost']:.2f}] \t giou: [{host['giou_loss']:.2f}] \t "
                  f"l1: [{host['l1_loss']:.2f}] \t time: [{time.time() - t0:.2f}]")
            t0 = time.time()
    return True


def eval_loop(trainer: Trainer, valid_dataset, config, evaluation_step: int = 200,
              log_fn=None):
    """Validation loss over at most ``evaluation_step`` batches; returns the
    per-batch logs as host floats."""
    logs = []
    for val_step, batch in enumerate(valid_dataset):
        _, log = trainer.evaluate(batch)
        host = _host_log(log)
        logs.append(host)
        if val_step % 10 == 0:
            print(f"Validation step: [{val_step}], \t ce: [{host['label_cost']:.2f}] \t "
                  f"giou: [{host['giou_loss']:.2f}] \t l1: [{host['l1_loss']:.2f}]")
        if log_fn is not None and val_step == 0:
            log_fn(host, trainer.steps)
        if val_step + 1 >= evaluation_step:
            break
    return logs
