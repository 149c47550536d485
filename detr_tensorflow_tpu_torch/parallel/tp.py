"""Megatron tensor parallelism for the DETR transformer (port of
``detr_tensorflow_tpu/parallel/tp.py``).

The JAX package states the split as shardings and lets GSPMD insert the
collectives; here the same split is applied to the modules and the two
all-reduces of each block are written out (Megatron's ``f`` and ``g``):

  * in every encoder and decoder layer, the attention's q/k/v projections
    and the FFN's ``linear1`` are split by output (their rows, with their
    biases): each rank of the ``model`` group holds ``num_heads / m``
    heads and ``dim_feedforward / m`` hidden units, and the attention
    kernels see plain local tensors with those heads;
  * ``out_proj`` and ``linear2`` are split by input (their columns): each
    rank's product is a partial sum, all-reduced (``g``) before the
    replicated bias is added;
  * the inputs of the split projections pass through ``f``: the identity
    forward, an all-reduce of their gradient backward;
  * everything else (backbone, norms, embeddings, heads) is replicated.
    Its gradients need no collective: every rank computes them from the
    same replicated activations.

Dropout: the residual dropouts act on replicated tensors, so every rank of
a model group draws them from the same generator state (the ``Trainer``
seeds by data rank only). The dropouts inside the split regions draw
apart: the FFN's hidden dropout draws the whole layer's mask and keeps the
rank's columns (the unsplit model's mask), and each attention call draws
one seed per model rank and takes its own, so heads on different ranks get
independent masks while every rank's generator advances alike.

``detr_param_shardings`` names the split dim of each state_dict entry (the
JAX ``_spec_for`` assignment, with torch's (out, in) Linear layout: a JAX
kernel split on its output is a torch weight split on dim 0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

_COL_SHARDED = ("linear1.weight", "q_proj.weight", "k_proj.weight", "v_proj.weight")
_ROW_SHARDED = ("linear2.weight", "out_proj.weight")
_COL_BIAS = ("linear1.bias", "q_proj.bias", "k_proj.bias", "v_proj.bias")


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A rank's place in its ``model`` group."""

    group: object
    rank: int
    size: int


def split_dim(name: str, ndim: int) -> Optional[int]:
    """The dim a state_dict entry is split on, or None (replicated)."""
    if not name.startswith("transformer."):
        return None
    if ndim == 2:
        if any(name.endswith(k) for k in _COL_SHARDED):
            return 0
        if any(name.endswith(k) for k in _ROW_SHARDED):
            return 1
    if ndim == 1 and any(name.endswith(k) for k in _COL_BIAS):
        return 0
    return None


def detr_param_shardings(state: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """Split dim (or None) of every entry of a DETR state_dict."""
    return {name: split_dim(name, t.dim()) for name, t in state.items()}


def shard_params(state: Mapping[str, torch.Tensor], rank: int, size: int
                 ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of a full (logical) state_dict."""
    out = {}
    for name, t in state.items():
        dim = split_dim(name, t.dim())
        if dim is None or size == 1:
            out[name] = t
            continue
        n = t.shape[dim]
        if n % size:
            raise ValueError(f"{name}: dim {dim} of {n} does not split over {size} ranks")
        out[name] = t.narrow(dim, rank * (n // size), n // size).contiguous()
    return out


def gather_tensor(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The whole tensor from each rank's slice along ``dim`` (gathered
    through host memory: Gloo gathers CPU tensors only)."""
    parts = [torch.empty_like(t, device="cpu") for _ in range(mg.size)]
    dist.all_gather(parts, t.detach().cpu().contiguous(), group=mg.group)
    return torch.cat(parts, dim=dim).to(t.device)


def gather_params(state: Mapping[str, torch.Tensor], mg: Optional[ModelGroup]
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the full state_dict from every
    rank's slice (a collective over the model group)."""
    if mg is None:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = split_dim(name, t.dim())
        out[name] = t if dim is None else gather_tensor(t, dim, mg)
    return out


class _CopyToModelGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, gradient all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModelGroup(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _CopyToModelGroup.apply(x, mg.group)


def reduce_from(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    return x if mg is None else _ReduceFromModelGroup.apply(x, mg.group)


def row_parallel(linear, x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """``linear(x)`` for a Linear split by input: the partial product
    all-reduced, then the replicated bias."""
    if mg is None:
        return linear(x)
    y = torch.nn.functional.linear(x, linear.cast("weight", x.dtype))
    return reduce_from(y, mg) + linear.cast("bias", x.dtype)


def parallelize(model: torch.nn.Module, group, rank: int, size: int) -> torch.nn.Module:
    """Split ``model``'s transformer over a model group in place: slice the
    parameters (``shard_params``) and give each attention and each layer
    its ``ModelGroup``. Call before an optimizer sees the parameters."""
    from ..models.transformer import DecoderLayer, EncoderLayer, MultiHeadAttention

    if size == 1:
        return model
    mg = ModelGroup(group, int(rank), int(size))
    for name, module in model.named_modules():
        if not name.startswith("transformer."):
            continue
        if isinstance(module, MultiHeadAttention):
            if module.num_heads % size:
                raise ValueError(f"{name}: {module.num_heads} heads over {size} ranks")
            module.tp = mg
        elif isinstance(module, (EncoderLayer, DecoderLayer)):
            module.tp = mg
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = split_dim(name, p.dim())
            if dim is not None:
                p.data = shard_params({name: p.data}, rank, size)[name]
    return model
