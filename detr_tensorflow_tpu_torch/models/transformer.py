"""DETR transformer: post-norm encoder-decoder over batch-first tensors
(port of ``detr_tensorflow_tpu/models/transformer.py``, inference only:
no dropout, no remat, no pipeline stages).

``attn_impl`` picks the attention of every ``MultiHeadAttention``:
  * ``"auto"``: the CUDA kernel (``ops.flash_attention.mha``) for every
    call on a CUDA tensor, the plain version for CPU tensors;
  * ``"kernel"``: always ``ops.flash_attention.mha``, which itself takes a
    CPU tensor to its plain reference;
  * ``"plain"``: materialised scores and softmax in PyTorch.
``return_weights=True`` always takes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops import flash_attention

_NEG_INF = -1e9
ATTN_IMPLS = ("auto", "kernel", "plain")


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate Q/K/V inputs and projections
    ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``."""

    def __init__(self, model_dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.model_dim, self.num_heads, self.attn_impl = model_dim, num_heads, attn_impl
        self.q_proj = nn.Linear(model_dim, model_dim)
        self.k_proj = nn.Linear(model_dim, model_dim)
        self.v_proj = nn.Linear(model_dim, model_dim)
        self.out_proj = nn.Linear(model_dim, model_dim)

    def forward(self, query, key, value, key_padding_mask: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        d, h = self.model_dim, self.num_heads
        dh = d // h
        b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
        q = self.q_proj(query).view(b, lq, h, dh)
        # The scale is rounded to the model dtype first, as in the JAX model.
        q = q * torch.tensor(dh**-0.5, dtype=q.dtype).item()
        k = self.k_proj(key).view(b, lk, h, dh)
        v = self.v_proj(value).view(b, lk, h, dh)

        impl = self.attn_impl
        if impl == "auto":
            impl = "kernel" if q.is_cuda else "plain"
        if impl == "kernel" and not return_weights:
            out, attn = flash_attention.mha(q, k, v, key_padding_mask), None
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
            attn = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = self.out_proj(out.reshape(b, lq, d))
        if return_weights:
            return out, attn.mean(dim=1)  # head-averaged weights
        return out


class EncoderLayer(nn.Module):
    """Post-norm encoder layer."""

    def __init__(self, model_dim: int, num_heads: int, dim_feedforward: int,
                 attn_impl: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttention(model_dim, num_heads, attn_impl)
        self.norm1 = _layer_norm(model_dim)
        self.linear1 = nn.Linear(model_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, model_dim)
        self.norm2 = _layer_norm(model_dim)

    def forward(self, src, pos, key_padding_mask=None):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, key_padding_mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention (no mask),
    cross-attention to the memory, FFN."""

    def __init__(self, model_dim: int, num_heads: int, dim_feedforward: int,
                 attn_impl: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttention(model_dim, num_heads, attn_impl)
        self.norm1 = _layer_norm(model_dim)
        self.cross_attn = MultiHeadAttention(model_dim, num_heads, attn_impl)
        self.norm2 = _layer_norm(model_dim)
        self.linear1 = nn.Linear(model_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, model_dim)
        self.norm3 = _layer_norm(model_dim)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               memory_key_padding_mask)
        tgt = self.norm2(tgt + attn)
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Transformer(nn.Module):
    """Encoder-decoder. Inputs: src and pos (B, S, D), query_embed (Q, D).
    Returns hs (L, B, Q, D), every decoder layer's output through the
    shared ``decoder_norm``, and the encoder memory (B, S, D)."""

    def __init__(self, model_dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, attn_impl: str = "auto"):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", EncoderLayer(
                model_dim, num_heads, dim_feedforward, attn_impl))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(
                model_dim, num_heads, dim_feedforward, attn_impl))
        self.decoder_norm = _layer_norm(model_dim)

    def forward(self, src, pos, query_embed, key_padding_mask=None):
        memory = src
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer_{i}")(memory, pos, key_padding_mask)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1).to(src.dtype)
        tgt = torch.zeros_like(query_pos)
        intermediate = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer_{i}")(
                tgt, memory, pos, query_pos, key_padding_mask)
            intermediate.append(self.decoder_norm(tgt))
        return torch.stack(intermediate, dim=0), memory
