"""Frozen-BN ResNet-50/101 backbone, stride 32 (16 with DC5's dilation),
2048 channels (port of ``detr_tensorflow_tpu/models/resnet.py``).

The public input is NHWC, as in the JAX package; the convolutions run on
NCHW tensors in ``torch.channels_last`` memory (NHWC in memory, which the
stem's permute of the NHWC images gives and every convolution keeps).
Submodule names follow the JAX variable tree (``conv1``, ``bn1``,
``layer1.block_0.conv2``, ...), so ``weights.from_jax_variables`` maps one
onto the other, whatever the fusion flags.

With a pixel mask, every spatial convolution's input is zeroed at padded
cells, so the valid region's features equal those of an unpadded forward.

``replace_stride_with_dilation`` (torchvision's and the JAX package's) keeps
a stage at its input's resolution: its ``block_0`` runs at stride 1,
undilated, and its later blocks run conv2 at dilation 2 and padding 2. DC5
dilates the last stage (stride-16 C5). ``remat_stages`` checkpoints the
leading stages while autograd records (``torch.utils.checkpoint``): only
their outputs are kept, the rest is recomputed in the backward.

Inference fusions, as in the JAX package (no backward; a fused block that
runs while autograd records raises):

* ``fuse_residual``: every bottleneck's tail (conv3, bn3, the residual and
  ReLU) is kernel D (``ops/fused_residual.py``);
* ``fuse_bottleneck``: every identity bottleneck (stride 1, no downsample,
  undilated) without a pixel mask is kernel E (``ops/fused_bottleneck.py``),
  with the frozen BN folded into its weights; a dilated block runs unfused
  (with D's tail under ``fuse_residual``).

Both kernels' operands (D's bn3 scale and shift, E's folded weights) are
computed once and cached until a weight or buffer changes. The conv weights
are float32 at every compute dtype, as the JAX package keeps its parameters:
every conv is a ``layers.Conv2d``, which casts its weight to its input's
dtype (differentiably while autograd records, from a cached copy
otherwise), and E's operands fold from the float32 weights and are cast
once.

The stem's max pool is kernel C on the card in every configuration.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.fused_bottleneck import fold_bn_params, fused_bottleneck, pack_weights
from ..ops.fused_residual import check_inference, conv1x1_bn_residual_relu
from ..ops.maxpool import max_pool_3x3_s2
from .layers import CachedOperands, Conv2d, FrozenBatchNorm, feature_valid_mask


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                  dilation=dilation, bias=False)


class Bottleneck(CachedOperands):
    """1x1 -> 3x3 (stride and dilation here) -> 1x1 with frozen BN and the
    residual."""

    def __init__(self, cin: int, dim1: int, dim2: int, stride: int = 1,
                 downsample: bool = False, fuse_residual: bool = False,
                 fuse_bottleneck: bool = False, dilation: int = 1):
        super().__init__()
        self.fuse_residual, self.fuse_bottleneck = fuse_residual, fuse_bottleneck
        self.conv1, self.bn1 = _conv(cin, dim1, 1), FrozenBatchNorm(dim1)
        self.conv2, self.bn2 = _conv(dim1, dim1, 3, stride, dilation), FrozenBatchNorm(dim1)
        self.conv3, self.bn3 = _conv(dim1, dim2, 1), FrozenBatchNorm(dim2)
        if downsample:
            self.downsample_conv = _conv(cin, dim2, 1, stride)
            self.downsample_bn = FrozenBatchNorm(dim2)
        else:
            self.downsample_conv = None

    def _whole_block_operands(self, dtype: torch.dtype):
        """Kernel E's operands (w1t, b1, w2t, b2, w3t, b3): the three convs
        with their BN folded in float32, then cast to ``dtype``."""
        convs, bns = (self.conv1, self.conv2, self.conv3), (self.bn1, self.bn2, self.bn3)

        def fold():
            folded = [fold_bn_params(c.weight, *bn.scale_shift()) for c, bn in zip(convs, bns)]
            w1t, w2t, w3t = pack_weights(*(w for w, _ in folded), dtype)
            (_, b1), (_, b2), (_, b3) = folded
            return w1t, b1.contiguous(), w2t, b2.contiguous(), w3t, b3.contiguous()

        tensors = [c.weight for c in convs] + [t for bn in bns for t in bn.buffers()]
        return self._folded(("block", dtype), tensors, fold)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None):
        if (self.fuse_bottleneck and valid is None and self.downsample_conv is None
                and self.conv2.stride == (1, 1) and self.conv2.dilation == (1, 1)
                and x.shape[1] == self.conv3.out_channels):
            check_inference("the fused bottleneck (kernel E)", x, *self.parameters())
            return fused_bottleneck(x, *self._whole_block_operands(x.dtype))
        out = F.relu(self.bn1(self.conv1(x)))
        if valid is not None:
            # conv2 is the block's only conv with a halo: zero its input at
            # padded cells so the halo reads the zeros of SAME padding.
            out = out * valid
        out = F.relu(self.bn2(self.conv2(out)))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        if self.fuse_residual:
            scale_shift = self._folded("tail", list(self.bn3.buffers()), self.bn3.scale_shift)
            return conv1x1_bn_residual_relu(out, self.conv3.cast("weight", out.dtype),
                                            *scale_shift, identity)
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNetStage(nn.Module):
    """A stack of bottlenecks ``block_0`` .. ``block_{n-1}``; the first
    one downsamples, or, in a dilated stage, keeps the resolution and the
    later ones dilate conv2 by 2."""

    def __init__(self, num_blocks: int, cin: int, dim1: int, dim2: int, stride: int,
                 fuse_residual: bool = False, fuse_bottleneck: bool = False,
                 dilate: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        stride, dilation = (1, 2) if dilate else (stride, 1)
        fuse = dict(fuse_residual=fuse_residual, fuse_bottleneck=fuse_bottleneck)
        self.block_0 = Bottleneck(cin, dim1, dim2, stride, downsample=True, **fuse)
        for i in range(1, num_blocks):
            self.add_module(f"block_{i}", Bottleneck(dim2, dim1, dim2, dilation=dilation, **fuse))

    def forward(self, x: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None):
        def valid_at(t):
            if pixel_mask is None:
                return None
            return feature_valid_mask(pixel_mask, *t.shape[2:], dtype=t.dtype)[:, None]

        x = self.block_0(x, valid_at(x))
        v = valid_at(x)
        for i in range(1, self.num_blocks):
            x = getattr(self, f"block_{i}")(x, v)
        return x


class ResNetBackbone(nn.Module):
    """ResNet feature extractor: (B, H, W, 3) NHWC in, NCHW
    (B, 2048, H/32, W/32) out (H/16, W/16 with the last stage dilated) in
    channels_last memory (sizes rounded up at each halving). The convs
    compute in the images' dtype; a ``dtype`` casts the images to it first.

    ``return_interm=True`` returns ``(c5, {"c2": .., "c3": .., "c4": ..})``:
    the outputs of the first three stages (strides 4, 8 and 16; with DC5
    c4 and c5 share stride 16), which the segmentation head fuses."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), fuse_residual: bool = False,
                 fuse_bottleneck: bool = False,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 remat_stages: int = 0, return_interm: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat_stages, self.return_interm = remat_stages, return_interm
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype
        dilate = (False,) + tuple(replace_stride_with_dilation)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        dims = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
        cin = 64
        for s, (n_blocks, (d1, d2)) in enumerate(zip(stage_sizes, dims)):
            self.add_module(
                f"layer{s + 1}",
                ResNetStage(n_blocks, cin, d1, d2, stride=1 if s == 0 else 2,
                            fuse_residual=fuse_residual, fuse_bottleneck=fuse_bottleneck,
                            dilate=dilate[s]),
            )
            cin = d2

    def forward(self, images: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None):
        """pixel_mask (B, H, W) bool, True = valid. The stem needs no mask:
        the image itself is zero at padded pixels."""
        if self.dtype is not None:
            images = images.to(self.dtype)
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        if pixel_mask is not None:
            # Post-relu activations are >= 0, so zeros beyond the valid
            # extent make the maxpool equal to the unpadded one (-inf pad).
            x = x * feature_valid_mask(pixel_mask, *x.shape[2:], dtype=x.dtype)[:, None]
        x = max_pool_3x3_s2(x, nonneg=True)  # post-ReLU: kernel C on the card
        interm = {}
        for s in range(1, 5):
            stage = getattr(self, f"layer{s}")
            if s <= self.remat_stages and torch.is_grad_enabled():
                x = checkpoint(stage, x, pixel_mask, use_reentrant=False,
                               preserve_rng_state=False)  # the backbone draws nothing
            else:
                x = stage(x, pixel_mask)
            if self.return_interm and s < 4:
                interm[f"c{s + 1}"] = x
        return (x, interm) if self.return_interm else x


def resnet50_backbone(dtype: torch.dtype = torch.float32, dilation: bool = False
                      ) -> ResNetBackbone:
    """DETR-R50's backbone (DC5 with ``dilation``)."""
    return ResNetBackbone((3, 4, 6, 3), replace_stride_with_dilation=(False, False, dilation),
                          dtype=dtype)


def resnet101_backbone(dtype: torch.dtype = torch.float32, dilation: bool = False
                       ) -> ResNetBackbone:
    """DETR-R101's backbone (DC5 with ``dilation``)."""
    return ResNetBackbone((3, 4, 23, 3), replace_stride_with_dilation=(False, False, dilation),
                          dtype=dtype)
