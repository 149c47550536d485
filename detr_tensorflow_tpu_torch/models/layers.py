"""Frozen batch-norm, the exact feature validity mask and the box-head MLP
(port of ``detr_tensorflow_tpu/models/layers.py``)."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics and affine, over NCHW tensors.

    The four tensors are buffers, so no optimizer sees them, and they stay
    float32 whatever the model's dtype: scale and shift are computed in
    float32 and cast to the input's dtype, as the JAX package does.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def scale_shift(self):
        """The float32 (scale, shift) of the affine, for kernels that fold
        it elsewhere (the JAX package's ``scale_shift_only=True``)."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale_shift()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def feature_valid_mask(pixel_mask: torch.Tensor, h: int, w: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Validity mask at a feature resolution, by exact conv arithmetic.

    The valid region is a top-left rectangle. Every spatial downsample of
    the ResNet maps a valid extent of n cells to ``(n - 1) // 2 + 1``
    cells, so the chain is computed on the valid extents themselves; a
    resize of the mask would miss the last valid cell of odd extents.

    Args:
      pixel_mask: (B, H, W) bool, True on the valid rectangle.
      h, w: target resolution, on the ceil-halving chain of (H, W).

    Returns a (B, h, w) mask of ``dtype``.
    """
    _, ph, pw = pixel_mask.shape
    if (h, w) == (ph, pw):
        return pixel_mask.to(dtype)
    levels, hh, ww = None, ph, pw
    for k in range(1, 8):
        hh, ww = (hh - 1) // 2 + 1, (ww - 1) // 2 + 1
        if (hh, ww) == (h, w):
            levels = k
            break
    if levels is None:
        raise ValueError(f"({h}, {w}) is not on the ceil-halving chain of ({ph}, {pw})")
    vh = pixel_mask[:, :, 0].sum(dim=1, dtype=torch.int64)
    vw = pixel_mask[:, 0, :].sum(dim=1, dtype=torch.int64)
    for _ in range(levels):
        vh = torch.div(vh - 1, 2, rounding_mode="floor") + 1
        vw = torch.div(vw - 1, 2, rounding_mode="floor") + 1
    rows = torch.arange(h, device=pixel_mask.device)[None, :] < vh[:, None]
    cols = torch.arange(w, device=pixel_mask.device)[None, :] < vw[:, None]
    return (rows[:, :, None] & cols[:, None, :]).to(dtype)


class MLP(nn.Module):
    """Box head: Linear-relu twice, then Linear-sigmoid to 4 coordinates.
    Submodules are ``layer_0`` .. ``layer_{n-1}``, as in the JAX tree."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, out_dim: int = 4,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer_{i}")(x))
        return torch.sigmoid(getattr(self, f"layer_{self.num_layers - 1}")(x))
