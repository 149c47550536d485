"""int8 post-training-quantized ResNet backbone (port of
``detr_tensorflow_tpu/models/quantized.py``).

  1. ``calibrate_backbone(backbone, images)`` runs an instrumented fp32
     forward of the port's ``ResNetBackbone`` and records the abs-max of
     every activation the int8 graph carries (per tensor, symmetric);
  2. ``quantize_backbone(backbone, calib)`` folds FrozenBatchNorm into
     per-channel multipliers, quantizes the conv weights per output
     channel to int8 and returns the "qtree": a flat dict of tensors named
     after the JAX qtree (``stem.kernel``, ``layer1.block_0.w1``, ...);
  3. ``quant_backbone_forward(qtree, images)`` is the int8 forward: the stem
     in the compute dtype, then per bottleneck conv1 on kernel F
     (``ops/int8_matmul.qmatmul``), conv2 on kernel G
     (``ops/int8_conv.conv3x3_int8``, stride 1 or 2) and conv3 with the
     residual join on kernel F (``qmatmul_residual`` /
     ``qmatmul_residual2``), int8 between them.

Scheme (the JAX package's): symmetric per-tensor activation scales with
zero-point 0, so SAME zero padding and validity masking stay exact, and
per-output-channel weight scales. Layouts: activations NHWC flattened to
(M, C) rows, weights K-major ((K, C) for 1x1, (K, 3, 3, C) for 3x3).
``QuantizedBackbone`` holds a qtree as buffers for ``DETR(backbone_quant=
True)``; ``quantize_model`` fills it from the model's own fp32 backbone.

Not ported: ``return_interm`` (feeds the segmentation head, not ported)
and the DC5 ``dilation`` option (the port's fp32 backbone lacks it too).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.int8_conv import conv3x3_int8, reference_conv3x3_int8
from ..ops.int8_matmul import (
    qmatmul,
    qmatmul_residual,
    qmatmul_residual2,
    reference_qmatmul,
    reference_qmatmul_residual,
    reference_qmatmul_residual2,
)
from .layers import feature_valid_mask

QTree = Dict[str, torch.Tensor]

_BN_EPS = 1e-5
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _bn_affine(bn: Mapping[str, torch.Tensor]):
    """FrozenBatchNorm -> (scale, shift), fp32."""
    scale = bn["weight"].float() * torch.rsqrt(bn["running_var"].float() + _BN_EPS)
    shift = bn["bias"].float() - bn["running_mean"].float() * scale
    return scale, shift


def _bn_of(module) -> Dict[str, torch.Tensor]:
    return {k: getattr(module, k) for k in _BN_KEYS}


def _stage_plan(stage_sizes: Sequence[int]):
    """(name, n_blocks, dim1, dim2, stride) per stage, as ``ResNetBackbone``."""
    dims = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
    return [(f"layer{s + 1}", n, d1, d2, 1 if s == 0 else 2)
            for s, (n, (d1, d2)) in enumerate(zip(stage_sizes, dims))]


def _stem_float(kernel, bn, x, pixel_mask):
    """7x7/s2 conv + FrozenBN + ReLU + validity mask + 3x3/s2 max pool in
    x's dtype: NHWC in, NCHW out. The max pool pads with -inf, as the JAX
    package's ``reduce_window``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype), stride=2, padding=3)
    scale, shift = _bn_affine(bn)
    y = torch.relu(y * scale.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None])
    if pixel_mask is not None:
        y = y * feature_valid_mask(pixel_mask, *y.shape[2:], dtype=y.dtype)[:, None]
    return F.max_pool2d(y, 3, stride=2, padding=1)


def _stage_sizes_of(backbone) -> tuple:
    return tuple(getattr(backbone, f"layer{s}").num_blocks for s in range(1, 5))


def _require_fp32(backbone):
    dtypes = {p.dtype for p in backbone.parameters()}
    if dtypes != {torch.float32}:
        raise ValueError(
            f"calibration and quantization read the fp32 backbone, got {sorted(map(str, dtypes))}:"
            " build the model in float32, or with backbone_quant=True, which keeps the"
            " backbone's weights in float32 whatever the compute dtype")


@torch.no_grad()
def calibrate_backbone(backbone, images: torch.Tensor,
                       pixel_mask: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """Per-tensor abs-max of every int8-carried activation of an fp32
    forward of ``backbone`` (a ``models.resnet.ResNetBackbone``) over
    ``images`` (normalized, NHWC): ``{"stem_out": t, "layerN": {"block_i":
    {"a1", "a2", "out"}}}``, 0-d float32 tensors on the backbone's device."""
    _require_fp32(backbone)
    x = _stem_float(backbone.conv1.weight, _bn_of(backbone.bn1), images.float(), pixel_mask)
    calib: Dict[str, object] = {"stem_out": x.abs().amax()}
    for name, n_blocks, _, _, _ in _stage_plan(_stage_sizes_of(backbone)):
        stage = {}
        for b in range(n_blocks):
            blk = getattr(getattr(backbone, name), f"block_{b}")
            v_in = None if pixel_mask is None else feature_valid_mask(
                pixel_mask, *x.shape[2:])[:, None]
            out = F.relu(blk.bn1(blk.conv1(x)))
            if v_in is not None:
                out = out * v_in
            a1 = out.abs().amax()
            out = F.relu(blk.bn2(blk.conv2(out)))
            a2 = out.abs().amax()
            out = blk.bn3(blk.conv3(out))
            identity = x if b else blk.downsample_bn(blk.downsample_conv(x))
            x = F.relu(out + identity)
            stage[f"block_{b}"] = {"a1": a1, "a2": a2, "out": x.abs().amax()}
        calib[name] = stage
    return calib


def _quant_w(weight: torch.Tensor):
    """Per-output-channel symmetric int8 weights: OIHW fp32 -> (OHWI int8,
    fp32 scale per output channel)."""
    w = weight.float()
    ws = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    q = torch.round(w / ws[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous(), ws


def _act_scale(absmax: torch.Tensor) -> torch.Tensor:
    return absmax.float().clamp_min(1e-12) / 127.0


@torch.no_grad()
def quantize_backbone(backbone, calib: Mapping) -> QTree:
    """Fold and quantize the fp32 ``backbone`` into a qtree: per conv one
    per-channel multiplier and bias that take the int32 accumulator through
    dequantization, BatchNorm and requantization, in the JAX package's
    order of operations. 1x1 weights come out (K, C), 3x3 (K, 3, 3, C)."""
    _require_fp32(backbone)
    qt: QTree = {"stem.kernel": backbone.conv1.weight.detach().float().clone(),
                 "stem.out_scale": _act_scale(calib["stem_out"])}
    for k, v in _bn_of(backbone.bn1).items():
        qt[f"stem.bn.{k}"] = v.detach().float().clone()
    in_scale = qt["stem.out_scale"]
    for name, n_blocks, _, _, _ in _stage_plan(_stage_sizes_of(backbone)):
        for b in range(n_blocks):
            blk = getattr(getattr(backbone, name), f"block_{b}")
            cb = calib[name][f"block_{b}"]
            prev = in_scale
            s_a1, s_a2, s_out = (_act_scale(cb[k]) for k in ("a1", "a2", "out"))
            q1, ws1 = _quant_w(blk.conv1.weight)
            bs1, bh1 = _bn_affine(_bn_of(blk.bn1))
            q2, ws2 = _quant_w(blk.conv2.weight)
            bs2, bh2 = _bn_affine(_bn_of(blk.bn2))
            q3, ws3 = _quant_w(blk.conv3.weight)
            bs3, bh3 = _bn_affine(_bn_of(blk.bn3))
            p = f"{name}.block_{b}."
            qt.update({
                # conv1: acc * m1 + b1 -> relu -> int8 at scale s_a1
                p + "w1": q1.flatten(1), p + "m1": prev * ws1 * bs1 / s_a1, p + "b1": bh1 / s_a1,
                # conv2: the same chain
                p + "w2": q2, p + "m2": s_a1 * ws2 * bs2 / s_a2, p + "b2": bh2 / s_a2,
                # conv3: back to the fp32 domain for the residual join
                p + "w3": q3.flatten(1), p + "m3": s_a2 * ws3 * bs3, p + "b3": bh3,
                p + "in_scale": prev, p + "out_scale": s_out,
            })
            if b == 0:
                qd, wsd = _quant_w(blk.downsample_conv.weight)
                bsd, bhd = _bn_affine(_bn_of(blk.downsample_bn))
                qt.update({p + "wd": qd.flatten(1), p + "md": prev * wsd * bsd, p + "bd": bhd})
            in_scale = s_out
    return qt


def qtree_shapes(stage_sizes: Sequence[int]) -> Dict[str, tuple]:
    """The qtree's keys with their shapes and dtypes."""
    f32, i8 = torch.float32, torch.int8
    shapes = {"stem.kernel": ((64, 3, 7, 7), f32), "stem.out_scale": ((), f32)}
    shapes.update({f"stem.bn.{k}": ((64,), f32) for k in _BN_KEYS})
    cin = 64
    for name, n_blocks, d1, d2, _ in _stage_plan(stage_sizes):
        for b in range(n_blocks):
            p = f"{name}.block_{b}."
            shapes.update({
                p + "w1": ((d1, cin), i8), p + "m1": ((d1,), f32), p + "b1": ((d1,), f32),
                p + "w2": ((d1, 3, 3, d1), i8), p + "m2": ((d1,), f32), p + "b2": ((d1,), f32),
                p + "w3": ((d2, d1), i8), p + "m3": ((d2,), f32), p + "b3": ((d2,), f32),
                p + "in_scale": ((), f32), p + "out_scale": ((), f32),
            })
            if b == 0:
                shapes.update({p + "wd": ((d2, cin), i8), p + "md": ((d2,), f32),
                               p + "bd": ((d2,), f32)})
            cin = d2
    return shapes


def _requant(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(-128.0, 127.0).to(torch.int8)


_KERNELS = (qmatmul, qmatmul_residual, qmatmul_residual2, conv3x3_int8)
_PLAIN = (reference_qmatmul, reference_qmatmul_residual, reference_qmatmul_residual2,
          reference_conv3x3_int8)


def quant_backbone_forward(qtree: Mapping[str, torch.Tensor], images: torch.Tensor,
                           stage_sizes: Sequence[int] = (3, 4, 6, 3),
                           pixel_mask: Optional[torch.Tensor] = None,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           use_kernels: bool = True) -> torch.Tensor:
    """int8 backbone forward: NHWC images -> (B, H/32, W/32, 2048) NHWC in
    ``compute_dtype``, with the precise (fp32) epilogues, as the JAX
    package's DETR runs it. ``use_kernels=False`` takes the plain versions
    on any device (the JAX package's ``use_pallas=False`` route)."""
    mm, mm_res, mm_res2, conv = _KERNELS if use_kernels else _PLAIN
    q = qtree
    stem_bn = {k: q[f"stem.bn.{k}"] for k in _BN_KEYS}
    x = _stem_float(q["stem.kernel"], stem_bn, images.to(compute_dtype), pixel_mask)
    # Enter the int8 domain, NHWC.
    x = _requant(x.permute(0, 2, 3, 1).float() / q["stem.out_scale"])
    out_scale = q["stem.out_scale"]
    for name, n_blocks, _, _, stride in _stage_plan(stage_sizes):
        for b in range(n_blocks):
            p = f"{name}.block_{b}."
            st = stride if b == 0 else 1
            identity = x
            a1 = mm(x, q[p + "w1"], q[p + "m1"], q[p + "b1"], relu=True)
            if pixel_mask is not None:
                # conv2 is the only conv with a halo: zero its input at padded
                # cells (zero-point 0 makes this exact).
                v_in = feature_valid_mask(pixel_mask, x.shape[1], x.shape[2], dtype=torch.int8)
                a1 = a1 * v_in[..., None]
            a2 = conv(a1, q[p + "w2"], q[p + "m2"], q[p + "b2"], stride=st, relu=True)
            # conv3 + folded BN + residual join + ReLU + requant; 1/out_scale
            # folds into every epilogue coefficient, divided here in fp32.
            so = q[p + "out_scale"]
            if b == 0:
                xd = identity[:, ::st, ::st, :].contiguous() if st != 1 else identity
                x = mm_res2(a2, q[p + "w3"], q[p + "m3"] / so, q[p + "b3"] / so,
                            xd, q[p + "wd"], q[p + "md"] / so, q[p + "bd"] / so, relu=True)
            else:
                x = mm_res(a2, q[p + "w3"], q[p + "m3"] / so, q[p + "b3"] / so,
                           identity, q[p + "in_scale"] / so, relu=True)
            out_scale = so
    return x.to(compute_dtype) * out_scale.to(compute_dtype)


class QuantizedBackbone(nn.Module):
    """A qtree as buffers (``stem.kernel``, ``layer1.block_0.w1``, ...), so
    ``.to(device)`` and ``state_dict`` carry it. Empty until ``load``."""

    def __init__(self, stage_sizes: Sequence[int]):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.loaded = False

    def load(self, qtree: Mapping[str, torch.Tensor]) -> None:
        expected = qtree_shapes(self.stage_sizes)
        if set(qtree) != set(expected):
            raise ValueError(f"qtree keys: missing {sorted(set(expected) - set(qtree))}, "
                             f"unexpected {sorted(set(qtree) - set(expected))}")
        for key, t in qtree.items():
            shape, dtype = expected[key]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{key}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
            *path, leaf = key.split(".")
            module = self
            for part in path:
                if not hasattr(module, part):
                    module.add_module(part, nn.Module())
                module = getattr(module, part)
            module.register_buffer(leaf, t.detach().contiguous())
        self.loaded = True

    def forward(self, images, pixel_mask=None, compute_dtype=torch.bfloat16, use_kernels=True):
        if not self.loaded:
            raise ValueError("backbone_quant=True needs the quantized backbone: run "
                             "models.quantized.quantize_model, or load an .npz that carries "
                             "the 'quant' collection")
        return quant_backbone_forward(dict(self.named_buffers()), images, self.stage_sizes,
                                      pixel_mask, compute_dtype, use_kernels)


def quantize_model(model, calibration_images: torch.Tensor,
                   pixel_mask: Optional[torch.Tensor] = None):
    """Calibrate on ``calibration_images`` (normalized, NHWC, on the model's
    device) and quantize the model's fp32 backbone into its
    ``backbone_quant`` buffers. ``model`` is a ``DetrModel`` or ``DETR``
    built with ``backbone_quant=True``; its fp32 backbone stays, so the
    same weights serve both paths. Returns ``model``."""
    module = getattr(model, "module", model)
    if getattr(module, "backbone_quant", None) is None:
        raise ValueError("quantize_model needs a model built with backbone_quant=True")
    calib = calibrate_backbone(module.backbone, calibration_images, pixel_mask)
    module.backbone_quant.load(quantize_backbone(module.backbone, calib))
    return model
