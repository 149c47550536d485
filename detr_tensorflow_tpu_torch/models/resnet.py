"""Frozen-BN ResNet-50/101 backbone, stride 32, 2048 channels (port of
``detr_tensorflow_tpu/models/resnet.py``).

The public input is NHWC, as in the JAX package; the convolutions run
NCHW inside. Submodule names follow the JAX variable tree
(``conv1``, ``bn1``, ``layer1.block_0.conv2``, ...), so
``weights.from_jax_variables`` maps one onto the other.

With a pixel mask, every spatial convolution's input is zeroed at padded
cells, so the valid region's features equal those of an unpadded forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .layers import FrozenBatchNorm, feature_valid_mask


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 with frozen BN and the residual."""

    def __init__(self, cin: int, dim1: int, dim2: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, dim1, 1), FrozenBatchNorm(dim1)
        self.conv2, self.bn2 = _conv(dim1, dim1, 3, stride), FrozenBatchNorm(dim1)
        self.conv3, self.bn3 = _conv(dim1, dim2, 1), FrozenBatchNorm(dim2)
        if downsample:
            self.downsample_conv = _conv(cin, dim2, 1, stride)
            self.downsample_bn = FrozenBatchNorm(dim2)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None):
        out = F.relu(self.bn1(self.conv1(x)))
        if valid is not None:
            # conv2 is the block's only conv with a halo: zero its input at
            # padded cells so the halo reads the zeros of SAME padding.
            out = out * valid
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNetStage(nn.Module):
    """A stack of bottlenecks ``block_0`` .. ``block_{n-1}``; the first
    one downsamples."""

    def __init__(self, num_blocks: int, cin: int, dim1: int, dim2: int, stride: int):
        super().__init__()
        self.num_blocks = num_blocks
        self.block_0 = Bottleneck(cin, dim1, dim2, stride, downsample=True)
        for i in range(1, num_blocks):
            self.add_module(f"block_{i}", Bottleneck(dim2, dim1, dim2))

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
    (B, 2048, H/32, W/32) out (sizes rounded up at each halving)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        dims = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
        cin = 64
        for s, (n_blocks, (d1, d2)) in enumerate(zip(stage_sizes, dims)):
            self.add_module(
                f"layer{s + 1}",
                ResNetStage(n_blocks, cin, d1, d2, stride=1 if s == 0 else 2),
            )
            cin = d2

    def forward(self, images: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None):
        """pixel_mask (B, H, W) bool, True = valid. The stem needs no mask:
        the image itself is zero at padded pixels."""
        x = F.relu(self.bn1(self.conv1(images.permute(0, 3, 1, 2))))
        if pixel_mask is not None:
            # Post-relu activations are >= 0, so zeros beyond the valid
            # extent make the maxpool equal to the unpadded one (-inf pad).
            x = x * feature_valid_mask(pixel_mask, *x.shape[2:], dtype=x.dtype)[:, None]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x, pixel_mask)
        return x
