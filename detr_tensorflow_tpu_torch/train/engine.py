"""Training engine (port of ``detr_tensorflow_tpu/train/engine.py``).

One step is: forward with dropout, Hungarian matching of the final and
every auxiliary decoder layer in one LAP solve, the set loss, backward,
and the three-group Adam with per-tensor clipnorm and accumulation. On
the card the attention runs through kernels A and A' and the matching
through kernel B; matching and loss never synchronise with the host, and
the step returns its log as device tensors, so consecutive steps queue
back to back. ``fit`` reads the log on its logging cadence only.

A bf16 step (``build_detr(dtype="bfloat16")``, or ``TrainingConfig(
compute_dtype="bfloat16")`` through ``get_detr_model``) is the JAX
package's: the parameters, their gradients, the clip and the Adam moments
are float32, and only the forward and backward compute in bf16: each layer
casts its float32 parameters at its use, so the gradient of every cast
lands in the float32 ``.grad``, and an update below a bf16 ulp of a weight
still moves it. On the card its attention runs A-mma (with dropout) and
A'-bf16 (``ops/flash_attention.py``). A float64 model
(``DETR(dtype=torch.float64)`` with ``.double()`` parameters) takes the
same step on the CPU, for diagnosis against the JAX package at float64.

``Trainer`` owns the model's optimizer state and the dropout generator,
a ``torch.Generator`` on the model's device seeded from an explicit seed:
every dropout mask and every attention-kernel seed is drawn from it, on
the device. Left out of this port: the AUTO-layout AOT step, meshes and
the 1F1B schedule.

``Trainer.prefetch`` copies batches to the card ``depth`` steps ahead:
from pinned host memory on a side CUDA stream, which the step's stream
waits on. ``fit`` runs an epoch through it; under a ``PreemptionGuard``
a SIGTERM or SIGINT makes it save a checkpoint and return False.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from ..ops.losses import detr_loss
from . import optimizers as opt_lib

_TARGET_KEYS = ("images", "boxes", "classes", "mask", "pixel_mask", "t_masks")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A native batch ('images' (B, H, W, 3), 'boxes' (B, T, 4), 'classes'
    (B, T), 'mask' (B, T), optional 'pixel_mask' (B, H, W) and instance
    masks 't_masks' (B, T, H/4, W/4)) of numpy arrays or tensors, as
    tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in _TARGET_KEYS if k in batch}


def forward_loss(model, batch, config, train: bool, generator=None, match=None):
    """Forward and set loss of one batch already on the device:
    (total, log, outputs)."""
    out = model(batch["images"], batch.get("pixel_mask"), train=train, generator=generator)
    total, log = detr_loss(out, batch["boxes"], batch["classes"], batch["mask"],
                           int(config.background_class), lap_impl=config.lap_impl,
                           match=match, t_masks=batch.get("t_masks"))
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

    ``model`` is a ``models.detr.DETR`` on its device whose compute dtype
    is float32 or bfloat16 and whose parameters are float32 (every model
    ``build_detr`` makes): the float32 parameters are the master weights of
    a bf16 step. A float64 model with float64 parameters trains on the CPU
    only. The trainer sets which parameters require gradients from the
    config's train_* flags.
    """

    def __init__(self, model: torch.nn.Module, config, seed: int = 0):
        compute = getattr(model, "dtype", torch.float32)
        master = torch.float64 if compute == torch.float64 else torch.float32
        dtypes = {p.dtype for p in model.parameters()}
        if dtypes != {master}:
            raise ValueError(f"a {compute} model trains on {master} parameters, got "
                             f"{sorted(map(str, dtypes))}: the model's dtype is its compute "
                             "dtype, and its parameters stay float32 (build_detr keeps them so)")
        if master == torch.float64 and model.query_embed.device.type != "cpu":
            raise ValueError("a float64 model trains on the CPU only (the kernels take float32 "
                             "and bfloat16)")
        if getattr(model, "fuse_residual", False) or getattr(model, "fuse_bottleneck", False):
            raise ValueError("the fused backbone kernels (fuse_residual, fuse_bottleneck) "
                             "are inference only, as in the JAX package: train the unfused "
                             "model and load its weights into a fused one to serve")
        self.model = model
        self.config = config
        self.device = model.query_embed.device
        # A bf16 model's first op casts its images to bf16: ``prefetch`` does
        # it on the host (round to nearest even, the same values) and copies
        # half the bytes.
        self.image_dtype = torch.bfloat16 if compute == torch.bfloat16 else None
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

    def prefetch(self, iterator, depth: int = 2):
        """Yield ``iterator``'s batches on the model's device, ``depth``
        batches copied ahead of the one being consumed.

        On the card each batch is staged in pinned host memory (a bf16
        model's images cast to bf16 first) and copied on a side CUDA stream;
        the consumer's stream waits on the copy's event before it gets the
        batch, and ``record_stream`` keeps the allocator from reusing the
        batch's memory while that stream may still read it. A tensor already
        on the device passes through. On the CPU this is a plain generator."""
        if self.device.type != "cuda":
            for batch in iterator:
                yield batch_to_device(batch, self.device)
            return
        stream = torch.cuda.Stream(self.device)
        pending = collections.deque()
        for batch in iterator:
            staged = {}
            for k in _TARGET_KEYS:
                if k in batch:
                    t = torch.as_tensor(batch[k])
                    if k == "images" and self.image_dtype is not None:
                        t = t.to(self.image_dtype)
                    staged[k] = t if t.device == self.device else t.pin_memory()
            with torch.cuda.stream(stream):
                dev = {k: t.to(self.device, non_blocking=True) for k, t in staged.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
            pending.append((dev, ready))
            if len(pending) >= depth:
                yield self._consume(*pending.popleft())
        while pending:
            yield self._consume(*pending.popleft())

    def _consume(self, dev, ready):
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)
        for t in dev.values():
            t.record_stream(consumer)
        return dev

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


class PreemptionGuard:
    """Graceful stop: while entered (in the main thread), SIGTERM and SIGINT
    only set ``requested``; ``fit`` checks it between steps, saves a
    checkpoint and returns False. A run resumes with
    ``checkpoint.restore_latest``. Outside the main thread it stays passive."""

    def __init__(self):
        self.requested = False
        self._previous = {}

    def __enter__(self):
        import signal

        def handler(signum, frame):
            del signum, frame
            self.requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous = {}
        return False


def fit(trainer: Trainer, train_dataset, config, epoch_nb: int, log_fn=None,
        log_every: int = 100, checkpoint_every: Optional[int] = None,
        preemption_guard: Optional[PreemptionGuard] = None) -> bool:
    """One epoch over ``train_dataset``, an iterable of native batches, fed
    through ``trainer.prefetch``. The log is read back (a host sync) only
    every ``log_every`` steps; with ``checkpoint_every`` and
    ``config.checkpoint_dir`` the full state is saved periodically. A
    ``PreemptionGuard`` (the caller's, or a fresh one when
    ``config.checkpoint_dir`` is set) turns SIGTERM/SIGINT into
    checkpoint-and-return. Returns True when the epoch completed, False
    when it was preempted."""
    own_guard = (PreemptionGuard() if preemption_guard is None and config.checkpoint_dir
                 else None)
    guard = preemption_guard or own_guard
    with own_guard if own_guard is not None else contextlib.nullcontext():
        return _fit_inner(trainer, train_dataset, config, epoch_nb, log_fn, log_every,
                          checkpoint_every, guard)


def _fit_inner(trainer, train_dataset, config, epoch_nb, log_fn, log_every, checkpoint_every,
               guard) -> bool:
    from .checkpoint import save_checkpoint

    t0 = time.time()
    for epoch_step, batch in enumerate(trainer.prefetch(train_dataset)):
        log = trainer.step(batch)
        if guard is not None and guard.requested:
            if config.checkpoint_dir:
                save_checkpoint(trainer, config.checkpoint_dir)
                print(f"Preemption signal received: checkpoint saved at step {trainer.steps}; "
                      f"stopping epoch {epoch_nb}.")
            return False
        if checkpoint_every and config.checkpoint_dir and (epoch_step + 1) % checkpoint_every == 0:
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
