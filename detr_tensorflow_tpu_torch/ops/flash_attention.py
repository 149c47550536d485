"""Fused multi-head attention forward: the hand-written Hopper kernel and
its plain PyTorch version.

Replaces the TPU kernel ``_fwd_kernel`` of
``detr_tensorflow_tpu/ops/pallas/flash_attention.py`` (reached through
its ``mha``). The CUDA source is ``csrc/flash_attention_fwd.cu``; its
header note says what bounds the kernel on the card and how it is laid
out. In short: one CTA per (batch * head, 16 query rows), K/V streamed
through shared memory in tiles of 64 keys with an online softmax, fp32
accumulators in registers, ragged edges masked in the kernel.

``mha`` takes CUDA tensors to the kernel and CPU tensors to
``reference_mha``; there is no fallback from one to the other. The
backward and in-kernel dropout are not ported yet: ``dropout_rate > 0``
raises.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
_SOURCE = "flash_attention_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def reference_mha(q, k, v, key_padding_mask=None):
    """Plain PyTorch attention with the kernel's numerics: fp32 scores and
    softmax, -1e30 on padded keys, probabilities cast to V's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q, k, v, key_padding_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, Dh)")
    b, _, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported (only {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: all three must be "
            "float32 or all bfloat16"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v lie on different devices")
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError("key_padding_mask must be bool (True = padded)")
        if tuple(key_padding_mask.shape) != (b, k.shape[1]):
            raise ValueError(
                f"key_padding_mask {tuple(key_padding_mask.shape)} != "
                f"{(b, k.shape[1])}"
            )
        if key_padding_mask.device != q.device:
            raise ValueError("key_padding_mask lies on another device")


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, key_padding_mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernel reads 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    if key_padding_mask is not None and not key_padding_mask.is_contiguous():
        raise ValueError("key_padding_mask must be contiguous")
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_padding_mask is None else key_padding_mask.data_ptr(),
            out.data_ptr(), b, lq, lk, h, dh, _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    mha.launches += 1
    return out


def mha(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0):
    """Fused attention over batch-first (B, L, H, Dh) tensors.

    Q must already be scaled by ``Dh ** -0.5``. ``key_padding_mask`` is an
    optional (B, Lk) bool tensor, True = padded key. Returns (B, Lq, H, Dh)
    in Q's dtype. A CUDA tensor launches the kernel (``mha.launches``
    counts those launches); a CPU tensor goes to ``reference_mha``.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    _check(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        return reference_mha(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, key_padding_mask)


mha.launches = 0
