"""Instance-segmentation head (port of
``detr_tensorflow_tpu/models/segmentation.py``): per-query attention maps
over the encoder memory (``MHAttentionMap``), fused with the stride-16/8/4
backbone stages through a small conv trunk (``MaskHead``), one mask logit
map per query at stride 4.

The trunk holds NHWC tensors, as the JAX module does; each convolution
reads its input as an NCHW view in ``torch.channels_last`` memory, so no
layout copy happens between layers. The (batch, query) axes are merged
into one batch of B * Q rows. As in the JAX module:

* the first conv over ``concat(features, attention maps)`` is split in two
  (``lay1_feats`` with the bias, ``lay1_attn`` without): the feature half
  runs once per image and is broadcast over the queries, so the
  (B * Q, h, w, D + heads) concat never exists;
* the FPN adapters run once per image and are broadcast over the queries;
* with a pixel mask, every 3x3 conv's input is zero outside the valid
  region of its stage, and every GroupNorm's statistics cover the valid
  cells only (``MaskedGroupNorm``), so a padded canvas gives the valid
  region the masks of the image alone.

Parameters are float32 and each layer casts them at its use
(``models/layers.py``); the attention logits, the softmax and the
GroupNorm statistics are float32, and ``pred_masks`` leaves as float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .layers import Conv2d, Linear, feature_valid_mask
from .transformer import dropout as _dropout

_NEG_INF = -1e9


def nearest_upsample_floor(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Nearest resize of NHWC (N, H, W, C) to (N, sh, sw, C) by the integer
    index ``(i * H) // sh``: an index gather, never a float scale (which
    can land one cell off at ratios such as 148 -> 19 -> 10)."""
    rows = torch.arange(sh, device=x.device) * x.shape[1] // sh
    cols = torch.arange(sw, device=x.device) * x.shape[2] // sw
    return x[:, rows[:, None], cols[None, :]]


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over an NHWC tensor, through its channels_last NCHW view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MHAttentionMap(nn.Module):
    """Per-query multi-head attention score maps over the memory: the
    softmax of q k^T over heads and space jointly, with no value product.
    Output (B, Q, heads, h, w), float32."""

    def __init__(self, model_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.q_proj = Linear(model_dim, model_dim)
        self.k_proj = Linear(model_dim, model_dim)

    def forward(self, queries: torch.Tensor, memory: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """queries (B, Q, D), the last decoder layer's output; memory
        (B, h, w, D), the encoder's output; key_padding_mask (B, h * w),
        True at padded cells."""
        b, nq, d = queries.shape
        fh, fw = memory.shape[1], memory.shape[2]
        h, dh = self.num_heads, d // self.num_heads
        q = self.q_proj(queries)
        k = self.k_proj(memory.reshape(b, fh * fw, d))
        # The scale is rounded to the compute dtype first, as in the JAX model;
        # the logits are float32 (float64 products summed in float64 first).
        q = q.reshape(b, nq, h, dh) * torch.tensor(dh**-0.5, dtype=q.dtype).item()
        k = k.reshape(b, fh * fw, h, dh)
        acc = torch.promote_types(q.dtype, torch.float32)
        logits = torch.einsum("bqhd,bshd->bqhs", q.to(acc), k.to(acc)).float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        attn = torch.softmax(logits.reshape(b, nq, h * fh * fw), dim=-1)
        attn = _dropout(attn, self.dropout, train, generator)
        return attn.reshape(b, nq, h, fh, fw)


class MaskedGroupNorm(nn.Module):
    """GroupNorm over NHWC whose statistics cover the valid cells only.

    ``valid`` (N, H, W), 1 at valid cells, counts per row; None is the
    plain GroupNorm. Statistics and affine in float32 (two passes: the
    mean, then the mean square about it), the output in the input's
    dtype. ``weight`` and ``bias`` are the JAX module's ``scale`` and
    ``bias``."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, h, w, c = x.shape
        g = self.num_groups
        xg = x.float().reshape(n, h, w, g, c // g)
        dims = (1, 2, 4)
        if valid is None:
            mean = xg.mean(dim=dims, keepdim=True)
            var = (xg - mean).square().mean(dim=dims, keepdim=True)
        else:
            m = valid.float().reshape(n, h, w, 1, 1)
            count = m.sum(dim=dims, keepdim=True).clamp(min=1.0) * (c // g)
            mean = (xg * m).sum(dim=dims, keepdim=True) / count
            var = ((xg - mean) * m).square().sum(dim=dims, keepdim=True) / count
        out = (xg - mean) * torch.rsqrt(var + self.eps)
        out = out.reshape(n, h, w, c) * self.weight.float() + self.bias.float()
        return out.to(x.dtype)


def _groups(c: int) -> int:
    """8 groups at full width (every trunk width is a multiple of 8 at
    D = 256); gcd(8, c) for narrow test models."""
    return 8 if c % 8 == 0 else math.gcd(8, c)


class MaskHead(nn.Module):
    """FPN-style conv trunk over the attention maps and the projected
    features, fused with the c4/c3/c2 stages: one mask logit map per
    query at c2's resolution. Widths D + heads, D/2, D/4, D/8, D/16, 1
    (facebook's ``MaskHeadSmallConv``), GroupNorm with 8 groups."""

    STAGES = ("c4", "c3", "c2")
    FPN_CHANNELS = (1024, 512, 256)

    def __init__(self, model_dim: int = 256, num_heads: int = 8):
        super().__init__()
        d, h = model_dim, num_heads
        self.dims = dims = (d + h, max(d // 2, 1), max(d // 4, 1), max(d // 8, 1),
                            max(d // 16, 1))

        def conv(cin, cout, bias=True):
            return Conv2d(cin, cout, 3, padding=1, bias=bias)

        self.lay1_feats = conv(d, dims[0])
        self.lay1_attn = conv(h, dims[0], bias=False)
        self.lay2 = conv(dims[0], dims[1])
        for i, (cin, cout) in enumerate(zip(dims[1:4], dims[2:5]), start=3):
            self.add_module(f"lay{i}", conv(cin, cout))
        self.out_lay = conv(dims[4], 1)
        self.gn1, self.gn2 = (MaskedGroupNorm(c, _groups(c)) for c in dims[:2])
        for i, c in enumerate(dims[2:], start=3):
            self.add_module(f"gn{i}", MaskedGroupNorm(c, _groups(c)))
        for j, (cin, cout) in enumerate(zip(self.FPN_CHANNELS, dims[1:4]), start=1):
            self.add_module(f"adapter{j}", Conv2d(cin, cout, 1))

    def forward(self, proj_feats: torch.Tensor, attn_maps: torch.Tensor,
                fpn: Dict[str, torch.Tensor],
                pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """proj_feats (B, h, w, D) ``input_proj``'s output, NHWC; attn_maps
        (B, Q, heads, h, w) float32; fpn {"c4", "c3", "c2"} NHWC stage
        outputs; pixel_mask (B, H, W) bool, True = valid. Returns
        (B, Q, H4, W4) float32 logits."""
        b, nq, heads, fh, fw = attn_maps.shape
        dtype = proj_feats.dtype

        def stage_valid(sh, sw):
            return None if pixel_mask is None else feature_valid_mask(pixel_mask, sh, sw)

        def apply_gn(gn, x, valid):
            v = None
            if valid is not None:
                v = valid[:, None].expand(b, nq, *valid.shape[1:]).reshape(b * nq,
                                                                         *valid.shape[1:])
                x = x * v[..., None].to(x.dtype)
            x = torch.relu(gn(x, v))
            if v is not None:
                # GroupNorm's affine and the ReLU give the zeroed padded cells
                # a constant, which the next conv's halo would read.
                x = x * v[..., None].to(x.dtype)
            return x

        v0 = stage_valid(fh, fw)
        if v0 is not None:
            proj_feats = proj_feats * v0[..., None].to(dtype)
        mem_part = conv_nhwc(self.lay1_feats, proj_feats)  # (B, h, w, C0), once per image
        attn = attn_maps.to(dtype).permute(0, 1, 3, 4, 2).reshape(b * nq, fh, fw, heads)
        x = conv_nhwc(self.lay1_attn, attn)
        c0 = x.shape[-1]
        x = (x.reshape(b, nq, fh, fw, c0) + mem_part[:, None]).reshape(b * nq, fh, fw, c0)
        x = apply_gn(self.gn1, x, v0)
        x = apply_gn(self.gn2, conv_nhwc(self.lay2, x), v0)

        for i, stage in enumerate(self.STAGES, start=3):
            feat = fpn[stage]
            sh, sw = feat.shape[1], feat.shape[2]
            cur = x.shape[-1]
            adapter = conv_nhwc(getattr(self, f"adapter{i - 2}"), feat.to(dtype))
            x = nearest_upsample_floor(x, sh, sw).reshape(b, nq, sh, sw, cur)
            vs = stage_valid(sh, sw)
            if vs is not None:
                adapter = adapter * vs[..., None].to(dtype)
                # The nearest upsample copies a valid edge cell into padded
                # cells where the valid extent is not a clean multiple: zero
                # them, as the unpadded forward's halo reads zeros there.
                x = x * vs[:, None, :, :, None].to(dtype)
            x = (x + adapter[:, None]).reshape(b * nq, sh, sw, cur)
            x = apply_gn(getattr(self, f"gn{i}"), conv_nhwc(getattr(self, f"lay{i}"), x), vs)

        out = conv_nhwc(self.out_lay, x)
        return out.reshape(b, nq, out.shape[1], out.shape[2]).float()
