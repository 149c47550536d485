"""Model construction API (port of ``detr_tensorflow_tpu/models/api.py``).

``build_detr`` makes a ``DETR`` on a device (the card unless the caller
asks for another), with weights drawn from a ``torch.Generator`` seeded by
``seed`` or loaded from a JAX-format ``.npz``; ``get_detr_model`` keeps the
reference's signature and its three head variants.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import weights as weights_lib
from .detr import DETR

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DETR_HEAD_PREFIXES = ("class_embed.", "bbox_embed.")


class DetrModel:
    """A model bundle: the ``DETR`` module, its input normalization
    (``"torch_resnet"`` or ``"tf_resnet"``) and its device. Calling it runs
    the forward under ``torch.inference_mode``."""

    def __init__(self, module: DETR, normalized_method: str = "torch_resnet"):
        self.module = module.eval()
        self.normalized_method = normalized_method

    @property
    def device(self) -> torch.device:
        return self.module.query_embed.device

    def __call__(self, images, pixel_mask=None):
        with torch.inference_mode():
            return self.module(images, pixel_mask)


def init_weights(module: DETR, generator: torch.Generator) -> None:
    """Seeded initialisation, in parameter order: Linear and Conv weights
    normal with variance 1/fan_in (flax's lecun normal, untruncated),
    biases zero, LayerNorm one/zero, ``query_embed`` standard normal.
    FrozenBN buffers keep their identity statistics."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        module.query_embed.normal_(0.0, 1.0, generator=generator)


def _load_npz(module: DETR, path: str, head: str) -> None:
    tree = weights_lib.load_variables_npz(path)
    quant = tree.pop("quant", None)
    state = weights_lib.from_jax_variables(tree)
    if head != "detr":
        # Pretrained trunk, fresh heads (the JAX build_detr does the same).
        state = {k: v for k, v in state.items() if not k.startswith(_DETR_HEAD_PREFIXES)}
    missing, unexpected = module.load_state_dict(state, strict=head == "detr")
    fresh = tuple(n + "." for n in ("cls_layer", "pos_layer"))
    if unexpected or any(not k.startswith(fresh) for k in missing):
        raise ValueError(f"{path}: missing {missing}, unexpected {unexpected}")
    if module.backbone_quant is not None and quant is not None:
        module.backbone_quant.load(weights_lib.from_jax_quant(quant["backbone"]))


def build_detr(num_classes: int = 92, num_queries: int = 100, head: str = "detr",
               nb_class: Optional[int] = None, num_encoder_layers: int = 6,
               num_decoder_layers: int = 6, backbone_depth: int = 50,
               backbone_stage_sizes=None, dtype: str = "float32",
               attn_impl: str = "auto", weights: Optional[str] = None,
               seed: int = 42, normalized_method: str = "torch_resnet",
               device="cuda", **model_kwargs) -> DetrModel:
    """Construct a DETR bundle on ``device`` (the card by default; the CPU
    only when asked, ``device="cpu"``).

    ``weights`` is a local ``.npz`` in the JAX package's format; with
    ``backbone_quant=True`` its "quant" collection, when present, fills the
    int8 backbone. Extra keyword args (model_dim, num_heads,
    dim_feedforward, dropout, backbone_quant, fuse_residual,
    fuse_bottleneck) go to ``DETR``. With ``backbone_quant=True`` the fp32
    backbone stays float32 whatever ``dtype`` is:
    ``quantized.quantize_model`` calibrates from it.

    ``fuse_residual=True, fuse_bottleneck=True`` is the JAX package's
    fused-backbone serving configuration (kernels D and E, inference
    only); its weights load as the unfused model's do, and its backbone's
    conv weights stay float32 whatever ``dtype`` is.
    """
    module = DETR(
        num_classes=num_classes, num_queries=num_queries, head=head,
        nb_class=nb_class, num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers, backbone_depth=backbone_depth,
        backbone_stage_sizes=backbone_stage_sizes, dtype=DTYPES[dtype],
        attn_impl=attn_impl, **model_kwargs,
    )
    init_weights(module, torch.Generator().manual_seed(seed))
    if weights is not None:
        _load_npz(module, weights, head)
    module.to(device)
    # The int8 model's fp32 backbone stays fp32 for calibration; a fused
    # backbone keeps fp32 conv weights, from which E folds its operands and
    # casts them once, as JAX folds its fp32 parameters (its other convs
    # read cached copies in the compute dtype, models/resnet.py).
    keep_fp32 = set()
    if module.backbone_quant is not None or module.fuse_residual or module.fuse_bottleneck:
        keep_fp32 = set(module.backbone.modules())
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.LayerNorm)) and m not in keep_fp32:
            m.to(DTYPES[dtype])
    return DetrModel(module, normalized_method=normalized_method)


def get_detr_model(config=None, include_top: bool = False,
                   nb_class: Optional[int] = None, weights: Optional[str] = None,
                   tf_backbone: bool = False, num_decoder_layers: int = 6,
                   num_encoder_layers: int = 6, **kwargs) -> DetrModel:
    """Reference-signature factory.

    * ``include_top=True``: 92-class heads;
    * ``include_top=False, nb_class=None``: headless (returns ``hs``);
    * ``include_top=False, nb_class=N``: fresh finetuning heads.

    ``tf_backbone=True`` selects the caffe-style ``tf_resnet`` input
    normalization.
    """
    head = "detr" if include_top else ("finetune" if nb_class is not None else "none")
    kwargs.setdefault("dtype", getattr(config, "compute_dtype", "float32"))
    kwargs.setdefault("attn_impl", getattr(config, "attn_impl", "auto"))
    kwargs.setdefault("num_queries", getattr(config, "num_queries", 100))
    kwargs.setdefault("backbone_depth", getattr(config, "backbone_depth", 50))
    return build_detr(
        head=head, nb_class=nb_class, weights=weights,
        num_encoder_layers=num_encoder_layers, num_decoder_layers=num_decoder_layers,
        normalized_method="tf_resnet" if tf_backbone else "torch_resnet", **kwargs,
    )
