"""Three-group Adam with per-tensor clipnorm, runtime learning rates and
gradient accumulation (port of ``detr_tensorflow_tpu/train/optimizers.py``).

  * three groups by top-level module name: backbone, input_proj and
    query_embed are "backbone"; the fresh finetuning heads are "nlayers";
    everything else (transformer, detection heads) is "transformers";
  * each gradient tensor is clipped by its own L2 norm to
    ``gradient_norm_clipping`` (Keras ``clipnorm``), not by the global norm
    as ``clip_grad_norm_`` does;
  * Adam with b1 0.9, b2 0.999, eps 1e-8 (optax's ``scale_by_adam``), each
    group at its own learning rate, read at every step;
  * a disabled group neither moves nor drifts its moments: its parameters
    stop requiring gradients and Adam never sees them (``optax.set_to_zero``);
  * ``gradient_aggregate`` = k > 1: the mean of k gradients is applied on
    every k-th call only (``optax.MultiSteps``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

GROUPS = ("backbone", "transformers", "nlayers")
_BACKBONE_TOPLEVEL = {"backbone", "input_proj", "query_embed"}
_NLAYERS_TOPLEVEL = {"cls_layer", "pos_layer", "mask_head", "bbox_attention"}


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """Optimizer group of every parameter, by its top-level module name."""

    def label_for(top: str) -> str:
        if top in _BACKBONE_TOPLEVEL:
            return "backbone"
        if top in _NLAYERS_TOPLEVEL:
            return "nlayers"
        return "transformers"

    return {name: label_for(name.split(".")[0]) for name, _ in model.named_parameters()}


def clip_by_leaf_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale each tensor in place to an L2 norm of at most ``max_norm``,
    without reading anything back to the host."""
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    scales = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, list(scales.unbind()))


def lr_dict(config) -> Dict[str, float]:
    return {"backbone": float(config.backbone_lr),
            "transformers": float(config.transformers_lr),
            "nlayers": float(config.nlayers_lr)}


class GroupOptimizer:
    """The composite optimizer of one model: ``step(lrs)`` after each
    backward pass; it returns whether an update was applied."""

    def __init__(self, model: torch.nn.Module, config):
        enabled = {"backbone": config.train_backbone,
                   "transformers": config.train_transformers,
                   "nlayers": config.train_nlayers}
        labels = param_labels(model)
        self.groups: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            p.requires_grad_(bool(enabled[labels[name]]))
            if p.requires_grad:
                self.groups[labels[name]].append(p)
        self.max_norm = float(config.gradient_norm_clipping)
        self.k = config.gradient_aggregate
        self.params = [p for g in GROUPS for p in self.groups[g]]
        self.adam = None
        if self.params:
            self.adam = torch.optim.Adam(
                [{"params": self.groups[g], "lr": 0.0, "name": g}
                 for g in GROUPS if self.groups[g]],
                betas=(0.9, 0.999), eps=1e-8, foreach=True)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else []

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, lrs: Dict[str, float]) -> bool:
        if self.adam is None:
            return False
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.k > 1:
            n = self.mini_step
            # Running mean, (g + n * acc) / (n + 1), as optax.MultiSteps.
            torch._foreach_mul_(self.acc, n / (n + 1))
            torch._foreach_add_(self.acc, grads, alpha=1.0 / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads, self.acc = self.acc, [torch.zeros_like(p) for p in self.params]
        clip_by_leaf_norm_(grads, self.max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = float(lrs[group["name"]])
        self.adam.step()
        return True

    def state_dict(self) -> dict:
        return {"adam": None if self.adam is None else self.adam.state_dict(),
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        if self.adam is not None:
            self.adam.load_state_dict(state["adam"])
        self.mini_step = int(state["mini_step"])
        self.acc = [a.to(p.device) for a, p in zip(state["acc"], self.params)]


def make_optimizer(config, model: torch.nn.Module) -> GroupOptimizer:
    return GroupOptimizer(model, config)
