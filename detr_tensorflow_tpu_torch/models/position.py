"""2-D sine/cosine positional embeddings (port of
``detr_tensorflow_tpu/models/position.py``)."""

from __future__ import annotations

import math

import torch


def sine_position_embedding(valid_mask: torch.Tensor, num_pos_features: int = 128,
                            temperature: float = 10000.0, eps: float = 1e-6,
                            dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 2 * num_pos_features) features of a (B, H, W) validity
    mask: cumulative sums over valid cells normalised to 2*pi, sin on even
    and cos on odd features, y features before x features."""
    not_mask = valid_mask.float()
    y_embed = not_mask.cumsum(dim=1)
    x_embed = not_mask.cumsum(dim=2)
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_features, dtype=torch.float32, device=valid_mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_features)

    def interleave(embed):
        pos = embed[..., None] / dim_t  # (B, H, W, F)
        return torch.stack(
            [pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1
        ).flatten(3)

    return torch.cat([interleave(y_embed), interleave(x_embed)], dim=-1).to(dtype)
