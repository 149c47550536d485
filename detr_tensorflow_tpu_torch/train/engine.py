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
the device. Left out of this port: the AUTO-layout AOT step and the 1F1B
schedule.

``Trainer(model, config, seed, mesh=)`` trains across processes on a
``parallel.make_mesh`` mesh. Its ``data`` axis is DDP (at any size, one
rank included): each rank steps on
its slice of the global batch (``parallel.shard_batch``), the loss
normalizers (matched count, eos-weighted sum of weights) are all-reduced
first so each rank's loss is its share of the global batch's, the loss is
scaled by the data size so that DDP's mean of gradients is the global
batch's gradient, and the step's log is all-reduced: every rank's log is
the global batch's. DDP runs with ``broadcast_buffers=False`` (the FrozenBN
buffers never change). Its ``model`` axis is Megatron tensor parallelism
(``parallel/tp.py``), under DDP when both are present. The clip reads the
norm of each split tensor whole.

``Trainer.prefetch`` copies batches to the card ``depth`` steps ahead:
from pinned host memory on a side CUDA stream, which the step's stream
waits on. ``fit`` runs an epoch through it; under a ``PreemptionGuard``
a SIGTERM or SIGINT makes it save a checkpoint and return False.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import time
from typing import Callable, Dict, Optional

import torch

from ..ops.losses import detr_loss, global_loss_normalizers
from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from ..parallel import tp as tp_lib
from . import optimizers as opt_lib

_TARGET_KEYS = ("images", "boxes", "classes", "mask", "pixel_mask", "t_masks")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A native batch ('images' (B, H, W, 3), 'boxes' (B, T, 4), 'classes'
    (B, T), 'mask' (B, T), optional 'pixel_mask' (B, H, W) and instance
    masks 't_masks' (B, T, H/4, W/4)) of numpy arrays or tensors, as
    tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in _TARGET_KEYS if k in batch}


def forward_loss(model, batch, config, train: bool, generator=None, match=None,
                 data_group=None):
    """Forward and set loss of one batch already on the device:
    (total, log, outputs). With a ``data_group`` the batch is one rank's
    slice and the loss is its share of the global batch's
    (``global_loss_normalizers(group=)``)."""
    out = model(batch["images"], batch.get("pixel_mask"), train=train, generator=generator)
    norm = None
    if data_group is not None:
        norm = global_loss_normalizers(batch["mask"], out["pred_logits"].shape[-2],
                                       group=data_group)
    total, log = detr_loss(out, batch["boxes"], batch["classes"], batch["mask"],
                           int(config.background_class), lap_impl=config.lap_impl,
                           match=match, t_masks=batch.get("t_masks"), norm=norm)
    return total, log, out


def all_reduce_log(log: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Sum a log of per-rank shares over ``group`` (one all-reduce, in
    float64): the global batch's log on every rank."""
    import torch.distributed as dist

    keys = [k for k, v in log.items() if torch.is_tensor(v)]
    flat = torch.stack([log[k].detach().double() for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(log, **{k: flat[i].to(log[k].dtype) for i, k in enumerate(keys)})


def make_train_step(model, optimizer: opt_lib.GroupOptimizer, config, data_group=None,
                    data_size: int = 1) -> Callable:
    """The train step: (batch, lrs, generator) -> log. The gradients of the
    step stay in the parameters' ``.grad`` until the next step. Under DDP
    (``model`` the wrapper, ``data_group`` its group) the loss is the rank's
    share, scaled by ``data_size`` before the backward: DDP averages the
    ranks' gradients, and the mean of the scaled shares is the global
    batch's gradient."""

    def step_fn(batch, lrs: Dict[str, float], generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        total, log, _ = forward_loss(model, batch, config, True, generator,
                                     data_group=data_group)
        (total * data_size if data_size > 1 else total).backward()
        optimizer.step(lrs)
        log = {k: v.detach() for k, v in log.items()}
        log["total_loss"] = total.detach()
        if data_group is not None:
            log = all_reduce_log(log, data_group)
        log["backbone_lr"] = lrs["backbone"]
        log["transformers_lr"] = lrs["transformers"]
        log["nlayers_lr"] = lrs["nlayers"]
        return log

    return step_fn


def make_eval_step(model, config, data_group=None) -> Callable:
    """The validation step: batch -> (outputs, log), no dropout, no grad.
    With a ``data_group`` the outputs are the rank's and the log is the
    global batch's."""

    def step_fn(batch):
        with torch.no_grad():
            total, log, out = forward_loss(model, batch, config, False, data_group=data_group)
        log = dict(log)
        log["total_loss"] = total
        if data_group is not None:
            log = all_reduce_log(log, data_group)
        return out, log

    return step_fn


def rank_generator_state(state: torch.Tensor, data_rank: int, device) -> torch.Tensor:
    """The dropout generator state of data rank ``data_rank`` given data
    rank 0's: rank 0 keeps it; rank r > 0 seeds a fresh generator on
    ``device`` with 63 bits of SHA-256 over that state's bytes and r. So
    the ranks draw apart, and every rank's generator follows from rank 0's
    alone: from the seed at the start, and from the state a checkpoint
    holds (rank 0's) at a resume, at any world size."""
    if data_rank == 0:
        return state
    digest = hashlib.sha256(state.cpu().numpy().tobytes()
                            + int(data_rank).to_bytes(8, "little")).digest()
    seed = int.from_bytes(digest[:8], "little") >> 1
    return torch.Generator(device=device).manual_seed(seed).get_state()


class Trainer:
    """Model, optimizer state, dropout generator and step count.

    ``model`` is a ``models.detr.DETR`` on its device whose compute dtype
    is float32 or bfloat16 and whose parameters are float32 (every model
    ``build_detr`` makes): the float32 parameters are the master weights of
    a bf16 step. A float64 model with float64 parameters trains on the CPU
    only. The trainer sets which parameters require gradients from the
    config's train_* flags.

    With a ``mesh`` (``parallel.make_mesh``) every rank builds the same
    model and trainer: the trainer gives every rank rank 0's weights, splits
    the transformer over the ``model`` axis (in place: ``model`` becomes
    this rank's part), and wraps it in DDP over the ``data`` axis. Each data
    rank's dropout generator follows from ``seed`` and its data rank
    (``rank_generator_state``); the ranks of one model group share it.
    ``model`` stays the unwrapped module; ``variables`` and
    ``state_dict`` hold its names and the whole (gathered) tensors, so a
    checkpoint written at one world size loads at any other.
    """

    def __init__(self, model: torch.nn.Module, config, seed: int = 0, mesh=None):
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
        self.mesh = mesh
        self.data_group, self.data_rank, self.data_size = mesh_lib.axis(mesh, "data")
        group, rank, size = mesh_lib.axis(mesh, "model")
        self.model_group = tp_lib.ModelGroup(group, rank, size) if size > 1 else None
        if mesh is not None:
            mesh_lib.replicate(model, mesh)
        if self.model_group is not None:
            tp_lib.parallelize(model, group, rank, size)
        self.generator = torch.Generator(device=self.device)
        self.generator.set_state(rank_generator_state(
            torch.Generator(device=self.device).manual_seed(int(seed)).get_state(),
            self.data_rank, self.device))
        self.steps = 0
        self.ddp = None
        self._build(config)
        self.eval_step = make_eval_step(model, config, self.data_group)

    def _build(self, config) -> None:
        """The optimizer (which sets ``requires_grad``), then the DDP wrapper,
        which fixes its parameter set when it is built, and the step."""
        self.config = config
        self.optimizer = opt_lib.make_optimizer(config, self.model, self.model_group)
        self.ddp = None  # the old wrapper's gradient hooks go with it
        forward = self.model
        if self.data_group is not None and self.optimizer.params:
            import inspect

            from torch.nn.parallel import DistributedDataParallel

            # The FrozenBN buffers never change: no broadcast before each
            # forward (``forward_sync_buffers`` where torch has renamed it).
            no_sync = ("forward_sync_buffers" if "forward_sync_buffers" in
                       inspect.signature(DistributedDataParallel).parameters
                       else "broadcast_buffers")
            # A masks model's head takes no gradient from a batch without
            # t_masks: DDP must look for parameters the step left unused.
            self.ddp = forward = DistributedDataParallel(
                self.model, process_group=self.data_group, **{no_sync: False},
                find_unused_parameters=bool(getattr(self.model, "masks", False)))
        self.train_step = make_train_step(forward, self.optimizer, config, self.data_group,
                                          self.data_size)
        self._lrs = opt_lib.lr_dict(config)

    def set_learning_rates(self, **kw) -> None:
        """Change group learning rates; the next step uses them."""
        for k, v in kw.items():
            if k not in self._lrs:
                raise KeyError(f"unknown optimizer group {k!r}")
            self._lrs[k] = float(v)

    def set_trainable(self, **kw) -> None:
        """Flip train_{backbone,transformers,nlayers}: the optimizer is
        rebuilt with fresh moments, and the DDP wrapper over the new set of
        trained parameters; parameters and step count stay."""
        self._build(self.config.replace(**kw))

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
        """Parameters and FrozenBN statistics (the model's state_dict, its
        split tensors gathered whole: a collective under tensor
        parallelism)."""
        return tp_lib.gather_params(self.model.state_dict(), self.model_group)

    def _map_optimizer(self, state: dict, fn) -> dict:
        """``state`` (an optimizer state_dict) with ``fn(dim, tensor)``
        applied to each per-parameter tensor of a split parameter (Adam's
        moments, the accumulation buffers), ``dim`` its split dim."""
        if self.model_group is None:
            return state
        dims = [tp_lib.split_dim(n, p.dim()) for n, p in
                zip(self.optimizer.names, self.optimizer.params)]
        state = dict(state, acc=[a if d is None else fn(d, a) for a, d in zip(state["acc"], dims)])
        if state["adam"] is not None:
            adam = dict(state["adam"], state={})
            for i, entry in state["adam"]["state"].items():
                adam["state"][i] = {k: fn(dims[i], v) if dims[i] is not None and k != "step"
                                    else v for k, v in entry.items()}
            state["adam"] = adam
        return state

    def state_dict(self) -> dict:
        """The full training state: parameters, FrozenBN buffers, the Adam
        moments of every group, accumulation buffers, step count and the
        dropout generator's state. Logical and unsharded, as the JAX
        package's: split tensors are gathered whole (every rank of the model
        group must call this), and the generator is this rank's (the
        checkpoint keeps data rank 0's)."""
        mg = self.model_group
        optimizer = self._map_optimizer(self.optimizer.state_dict(),
                                        lambda d, t: tp_lib.gather_tensor(t, d, mg))
        return {"model": self.variables, "optimizer": optimizer, "steps": self.steps,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        """Load a ``state_dict`` written at any world size: split tensors
        are sliced for this rank, and the generator is data rank 0's state
        as saved, or for data rank r > 0 the one ``rank_generator_state``
        derives from it."""
        mg = self.model_group
        rank, size = (0, 1) if mg is None else (mg.rank, mg.size)
        self.model.load_state_dict(tp_lib.shard_params(state["model"], rank, size))

        def slice_(dim, t):
            n = t.shape[dim] // size
            return t.narrow(dim, rank * n, n).contiguous()

        self.optimizer.load_state_dict(self._map_optimizer(state["optimizer"], slice_))
        self.steps = int(state["steps"])
        self.generator.set_state(rank_generator_state(state["generator"], self.data_rank,
                                                      self.device))


def _host_log(log) -> Dict[str, float]:
    return {k: float(v) for k, v in log.items()}


class PreemptionGuard:
    """Graceful stop: while entered (in the main thread), SIGTERM and SIGINT
    only set ``requested``; ``fit`` checks it between steps, saves a
    checkpoint and returns False. A run resumes with
    ``checkpoint.restore_latest``. Outside the main thread it stays passive.
    Across processes the signal must reach every rank (torchrun and the
    elastic launcher signal them all): the checkpoint is a collective."""

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

    # Across processes every rank steps and joins the checkpoint (a collective
    # under tensor parallelism), and only the primary logs and prints.
    primary = multihost.is_primary()
    t0 = time.time()
    for epoch_step, batch in enumerate(trainer.prefetch(train_dataset)):
        log = trainer.step(batch)
        if guard is not None and guard.requested:
            if config.checkpoint_dir:
                save_checkpoint(trainer, config.checkpoint_dir)
                if primary:
                    print(f"Preemption signal received: checkpoint saved at step "
                          f"{trainer.steps}; stopping epoch {epoch_nb}.")
            return False
        if checkpoint_every and config.checkpoint_dir and (epoch_step + 1) % checkpoint_every == 0:
            save_checkpoint(trainer, config.checkpoint_dir)
        if epoch_step % log_every == 0 and primary:
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
    per-batch logs as host floats. Across processes each rank evaluates its
    slice, the logs are the global batch's, and only the primary prints and
    calls ``log_fn``."""
    primary = multihost.is_primary()
    logs = []
    for val_step, batch in enumerate(valid_dataset):
        _, log = trainer.evaluate(batch)
        host = _host_log(log)
        logs.append(host)
        if val_step % 10 == 0 and primary:
            print(f"Validation step: [{val_step}], \t ce: [{host['label_cost']:.2f}] \t "
                  f"giou: [{host['giou_loss']:.2f}] \t l1: [{host['l1_loss']:.2f}]")
        if log_fn is not None and val_step == 0 and primary:
            log_fn(host, trainer.steps)
        if val_step + 1 >= evaluation_step:
            break
    return logs
