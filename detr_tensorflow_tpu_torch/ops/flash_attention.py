"""Fused multi-head attention, forward and backward: the hand-written Hopper
kernels and their plain PyTorch version.

Replaces the TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``detr_tensorflow_tpu/ops/pallas/flash_attention.py`` (reached through its
``mha``). The CUDA sources are ``csrc/flash_attention_fwd_tf32.cu``,
``csrc/flash_attention_fwd_mma.cu`` and ``csrc/flash_attention_fwd.cu``
(forward) and ``csrc/flash_attention_bwd_mma.cu``,
``csrc/flash_attention_bwd_bf16.cu`` and ``csrc/flash_attention_bwd.cu``
(backward); their header notes say what
bounds each kernel on the card and how it is laid out. In short: the
forward streams K/V in 64-key tiles with an online softmax and, when
autograd needs it, writes the row log-sum-exp; the backward recomputes the
softmax from it in two kernels, one over key tiles for dK/dV and one over
query tiles for dQ, after a pre-pass over the rows.

The kernel is picked from the call's dtype and head dim alone.
``forward_route``: fp32, with or without dropout, runs on the
tensor cores with 3xTF32 products (the "tf32" route; each fp32 operand split
into two TF32 parts, three TF32 MMAs per product: fp32 accuracy), bf16, with
or without dropout, on the tensor cores in bf16 (``mma.sync`` bf16, the
"mma" route). The SIMT forward (fp32 FMAs) runs on no route; it stays
callable as ``launch_forward_simt``, a yardstick for the tensor-core ones.
``backward_route``: fp32 runs on the tensor cores with 3xTF32 products, bf16
on the tensor cores in bf16 (``mma.sync`` bf16, the "bf16" route). A failed
build or launch raises on every route.

Attention-weight dropout runs inside the kernels. Its keep bit is a pure
function of the call's 64-bit seed and the element's coordinates
(Philox4x32-10, ``csrc/flash_attention_common.cuh``), so the backward
replays the forward's mask without storing it. ``keep_mask`` is the same
generator in PyTorch: the plain version draws its mask from it, so both
give the same result for the same seed.

The forward is the custom op ``detr_torch::mha_forward``
(``ops/library.py``): on CUDA tensors it launches the kernel
``forward_route`` picks, on CPU tensors it runs ``reference_mha``, and an
exported program calls it on either. ``mha`` calls it; there is no
fallback from one device's implementation to the other. On a CUDA tensor
under autograd, ``_FlashAttention`` wraps the op and its backward is the
backward kernel; on a CPU tensor under autograd ``mha`` differentiates
``reference_mha`` itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import library

_NEG_INF = -1e30
_FWD_SOURCE = "flash_attention_fwd.cu"
_MMA_SOURCE = "flash_attention_fwd_mma.cu"
_TF32_SOURCE = "flash_attention_fwd_tf32.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_BWD_MMA_SOURCE = "flash_attention_bwd_mma.cu"
_BWD_BF16_SOURCE = "flash_attention_bwd_bf16.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
# CTA shapes of the tensor-core forwards, four warps each: (row groups of 16
# queries, warps sharing each row group's keys), as
# csrc/flash_attention_fwd_mma.cu and csrc/flash_attention_fwd_tf32.cu
# instantiate them.
MMA_SHAPES = ((4, 1), (1, 4))

# Philox4x32-10 constants (Salmon et al., SC'11; Random123).
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def reference_mha(q, k, v, key_padding_mask=None, keep_mask=None, dropout_rate: float = 0.0):
    """Plain PyTorch attention with the kernels' numerics: fp32 scores and
    softmax, -1e30 on padded keys, the dropout multiplier applied in fp32,
    probabilities cast to V's dtype. ``keep_mask`` is a (B, H, Lq, Lk) bool
    tensor (True = kept); kept probabilities are scaled by
    ``1 / (1 - dropout_rate)``. Differentiable."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if keep_mask is not None:
        probs = probs * (keep_mask * (1.0 / (1.0 - dropout_rate)))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def dropout_threshold(rate: float) -> int:
    """The kernels drop an element iff its 32 random bits are below this."""
    return min(_MASK32, math.ceil(rate * 2**32)) if rate > 0.0 else 0


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of ``a * b`` for 32-bit values held in
    int64 tensors (split in 16-bit halves so nothing overflows)."""
    t1 = a * (b & 0xFFFF)
    t2 = a * (b >> 16)
    mid = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcasting),
    as ``fa::philox4x32_10`` in ``csrc/flash_attention_common.cuh``."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, batch_heads: int, lq: int, lk: int, rate: float):
    """The dropout keep mask of one attention call, (batch_heads, Lq, Lk)
    bool on ``seed``'s device: bit j % 4 of Philox4x32-10 with counter
    (j // 4, i, bh, 0) and key (seed low word, seed high word), kept iff
    the bits reach ``dropout_threshold(rate)``. ``seed`` is a one-element
    int64 tensor; nothing is read back to the host."""
    dev = seed.device
    s = seed.reshape(())
    n4 = (lk + 3) // 4
    c0 = torch.arange(n4, device=dev, dtype=torch.int64)[None, None, :]
    c1 = torch.arange(lq, device=dev, dtype=torch.int64)[None, :, None]
    c2 = torch.arange(batch_heads, device=dev, dtype=torch.int64)[:, None, None]
    c3 = torch.zeros((), device=dev, dtype=torch.int64)
    words = philox4x32_10(c0, c1, c2, c3, s & _MASK32, (s >> 32) & _MASK32)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(batch_heads, lq, 4 * n4)[..., :lk]
    return bits >= dropout_threshold(rate)


def _check(q, k, v, key_padding_mask, dropout_rate, dropout_seed):
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
    library.check_device(q, "attention")
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
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 needs dropout_seed")
        if (dropout_seed.dtype != torch.int64 or dropout_seed.numel() != 1
                or dropout_seed.device != q.device):
            raise ValueError("dropout_seed must be one int64 element on q's device")


def _library(source: str) -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(source)
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    signatures = {
        "flash_attention_fwd": [vp] * 5 + [u, f, vp, vp] + [i] * 6 + [vp],
        "flash_attention_fwd_mma": [vp] * 5 + [u, f, vp, vp] + [i] * 7 + [vp],
        "flash_attention_fwd_tf32": [vp] * 5 + [u, f, vp, vp] + [i] * 7 + [vp],
        "flash_attention_keep_mask": [vp, vp, i, i, i, u, vp],
        "flash_attention_bwd": [vp] * 8 + [u, f] + [vp] * 4 + [i] * 6 + [vp],
        "flash_attention_bwd_mma": [vp] * 8 + [u, f] + [vp] * 4 + [i] * 6 + [vp],
        "flash_attention_bwd_bf16": [vp] * 8 + [u, f] + [vp] * 4 + [i] * 6 + [vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(*tensors):
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("attention kernel inputs must be contiguous")
        if t.data_ptr() % 16:  # the kernels read 16-byte vectors
            raise ValueError("attention kernel inputs must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _dropout_args(dropout_rate):
    threshold = dropout_threshold(dropout_rate)
    return threshold, (1.0 / (1.0 - dropout_rate)) if threshold else 1.0


def forward_route(dtype: torch.dtype, dropout_rate: float, head_dim: int) -> str:
    """The forward kernel a CUDA call takes: "tf32" (tensor cores, 3xTF32,
    ``csrc/flash_attention_fwd_tf32.cu``) for fp32 and "mma" (bf16 tensor
    cores, ``csrc/flash_attention_fwd_mma.cu``) for bf16, each at any
    dropout rate; "simt" (``csrc/flash_attention_fwd.cu``) for a head dim
    the tensor-core kernels do not take, which ``mha`` refuses before
    routing."""
    if head_dim in _HEAD_DIMS:
        if dtype == torch.float32:
            return "tf32"
        if dtype == torch.bfloat16:
            return "mma"
    return "simt"


def backward_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a CUDA call takes: "mma" (tensor cores, 3xTF32,
    ``csrc/flash_attention_bwd_mma.cu``) for fp32, "bf16" (tensor cores in
    bf16, ``csrc/flash_attention_bwd_bf16.cu``) for bf16; "simt"
    (``csrc/flash_attention_bwd.cu``) for a head dim the tensor-core
    kernels do not take, which ``mha`` refuses before routing."""
    if head_dim in _HEAD_DIMS:
        if dtype == torch.float32:
            return "mma"
        if dtype == torch.bfloat16:
            return "bf16"
    return "simt"


def cta_shape(batch_heads: int, lq: int, sms: int) -> tuple:
    """The CTA shape of the tensor-core forwards, (row groups, split), on a
    card of ``sms`` SMs: four row groups of 16 queries, one warp each, when
    those 64-row CTAs number at least half the SMs; otherwise one row group
    whose keys the four warps split. On an H100 the 64-row shape won at
    every DETR shape timed with 80 or more such CTAs (the bf16 kernel's
    (320, 320) at B=2 and, with and without dropout, the b8 training
    step's 100 decoder queries included), the split at 16 and 32."""
    return (4, 1) if 2 * batch_heads * -(-lq // 64) >= sms else (1, 4)


def launch_forward(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse):
    """One launch of the forward kernel that ``forward_route`` picks, on
    CUDA tensors: (out, lse or None)."""
    route = forward_route(q.dtype, dropout_rate, q.shape[-1])
    if route == "tf32":
        return launch_forward_tf32(q, k, v, key_padding_mask, dropout_seed, dropout_rate,
                                   with_lse)
    if route == "mma":
        return launch_forward_mma(q, k, v, key_padding_mask, with_lse,
                                  dropout_seed=dropout_seed, dropout_rate=dropout_rate)
    return launch_forward_simt(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse)


def _cta_shape(q, shape):
    b, lq, h, _ = q.shape
    if shape is None:
        shape = cta_shape(b * h, lq,
                          torch.cuda.get_device_properties(q.device).multi_processor_count)
    if shape not in MMA_SHAPES:
        raise ValueError(f"attention CTA shape {shape} not in {MMA_SHAPES}")
    return shape


def launch_forward_tf32(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse,
                        shape=None):
    """One launch of the tensor-core forward (3xTF32) on fp32 CUDA tensors,
    with or without dropout: (out, lse or None). ``shape``, one of
    ``MMA_SHAPES``, defaults to ``cta_shape``."""
    _check_kernel_inputs(q, k, v, key_padding_mask)
    if q.dtype != torch.float32:
        raise TypeError(f"the tf32 attention kernel takes float32, got {q.dtype}")
    b, lq, h, dh = q.shape
    shape = _cta_shape(q, shape)
    threshold, keep_scale = _dropout_args(dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, lq), device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):
        err = _library(_TF32_SOURCE).flash_attention_fwd_tf32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
            _ptr(dropout_seed) if threshold else None, threshold, keep_scale,
            out.data_ptr(), _ptr(lse), b, lq, k.shape[1], h, dh, *shape, _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_tf32 launch failed: cudaError {err}")
    mha.tf32_launches += 1
    return out, lse


def launch_forward_mma(q, k, v, key_padding_mask, with_lse, dropout_seed=None,
                       dropout_rate=0.0, shape=None):
    """One launch of the bf16 tensor-core forward on bf16 CUDA tensors, with
    or without dropout: (out, lse or None). ``shape``, one of
    ``MMA_SHAPES``, defaults to ``cta_shape``."""
    _check_kernel_inputs(q, k, v, key_padding_mask)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the mma attention kernel takes bfloat16, got {q.dtype}")
    b, lq, h, dh = q.shape
    shape = _cta_shape(q, shape)
    threshold, keep_scale = _dropout_args(dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, lq), device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):
        err = _library(_MMA_SOURCE).flash_attention_fwd_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
            _ptr(dropout_seed) if threshold else None, threshold, keep_scale,
            out.data_ptr(), _ptr(lse), b, lq, k.shape[1], h, dh, *shape, _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_mma launch failed: cudaError {err}")
    mha.mma_launches += 1
    return out, lse


def launch_forward_simt(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse):
    """One launch of the SIMT forward kernel on CUDA tensors, fp32 or bf16,
    with or without dropout: (out, lse or None). It runs on no path of
    ``mha``; a direct call times it against the tf32 kernel at fp32 and the
    mma kernel at bf16."""
    _check_kernel_inputs(q, k, v, key_padding_mask)
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    threshold, keep_scale = _dropout_args(dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, lq), device=q.device, dtype=torch.float32) if with_lse else None
    with torch.cuda.device(q.device):
        err = _library(_FWD_SOURCE).flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
            _ptr(dropout_seed) if threshold else None, threshold, keep_scale,
            out.data_ptr(), _ptr(lse), b, lq, lk, h, dh, _DTYPE_CODES[q.dtype],
            _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    mha.launches += 1
    return out, lse


def launch_backward(q, k, v, out, dout, lse, key_padding_mask, dropout_seed, dropout_rate):
    """One launch of the backward kernels that ``backward_route`` picks, on
    CUDA tensors: (dq, dk, dv)."""
    route = backward_route(q.dtype, q.shape[-1])
    if route == "mma":
        return launch_backward_mma(q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                                   dropout_rate)
    if route == "bf16":
        return launch_backward_bf16(q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                                    dropout_rate)
    return launch_backward_simt(q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                                dropout_rate)


def _launch_backward(source, q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                     dropout_rate, scratch_per_row=1):
    """One launch of a backward library; its scratch holds
    ``scratch_per_row`` 32-bit words per (batch * head, query) row, delta's
    fp32 first."""
    dout = dout.contiguous()
    _check_kernel_inputs(dout)
    b, lq, h, dh = q.shape
    threshold, keep_scale = _dropout_args(dropout_rate)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b * h * lq * scratch_per_row,), device=q.device, dtype=torch.float32)
    name = source.removesuffix(".cu")
    with torch.cuda.device(q.device):
        err = getattr(_library(source), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), _ptr(key_padding_mask),
            _ptr(dropout_seed) if threshold else None, threshold, keep_scale,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            b, lq, k.shape[1], h, dh, _DTYPE_CODES[q.dtype], _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return dq, dk, dv


def launch_backward_mma(q, k, v, out, dout, lse, key_padding_mask, dropout_seed, dropout_rate):
    """One launch of the tensor-core backward (3xTF32) on fp32 CUDA tensors:
    (dq, dk, dv). With dropout its scratch also holds the keep bits its
    pre-pass draws, a 32-bit word per 32 keys."""
    if q.dtype != torch.float32:
        raise TypeError(f"the mma attention backward takes float32, got {q.dtype}")
    keep_words = -(-k.shape[1] // 32) if dropout_threshold(dropout_rate) else 0
    grads = _launch_backward(_BWD_MMA_SOURCE, q, k, v, out, dout, lse, key_padding_mask,
                             dropout_seed, dropout_rate, scratch_per_row=1 + keep_words)
    mha.backward_mma_launches += 1
    return grads


def launch_backward_bf16(q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                         dropout_rate):
    """One launch of the bf16 tensor-core backward on bf16 CUDA tensors:
    (dq, dk, dv). ``out`` is not read: delta is summed over the keys from
    the kernel's own dP. With dropout its scratch also holds the keep bits
    its pre-pass draws, a 32-bit word per 32 keys."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 attention backward takes bfloat16, got {q.dtype}")
    keep_words = -(-k.shape[1] // 32) if dropout_threshold(dropout_rate) else 0
    grads = _launch_backward(_BWD_BF16_SOURCE, q, k, v, out, dout, lse, key_padding_mask,
                             dropout_seed, dropout_rate, scratch_per_row=1 + keep_words)
    mha.backward_bf16_launches += 1
    return grads


def launch_backward_simt(q, k, v, out, dout, lse, key_padding_mask, dropout_seed, dropout_rate):
    """One launch of the SIMT backward on CUDA tensors, fp32 or bf16: (dq,
    dk, dv). It runs on no path of ``mha``; a direct call times it beside
    the tensor-core kernels at either dtype."""
    grads = _launch_backward(_BWD_SOURCE, q, k, v, out, dout, lse, key_padding_mask,
                             dropout_seed, dropout_rate)
    mha.backward_launches += 1
    return grads


def _cpu_keep(q, k, dropout_seed, dropout_rate):
    if dropout_rate <= 0.0:
        return None
    b, lq, h, _ = q.shape
    return keep_mask(dropout_seed, b * h, lq, k.shape[1], dropout_rate).view(b, h, lq, k.shape[1])


def reference_lse(q, k, key_padding_mask=None):
    """The row log-sum-exp the forward kernels write, (B * H, Lq) float32:
    max_j s_ij + log sum_j exp(s_ij - max), -1e30 on padded keys."""
    b, lq, h, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
    return torch.logsumexp(logits, dim=-1).reshape(b * h, lq)


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


def _forward_cpu(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse):
    out = torch.empty_like(q)
    out.copy_(reference_mha(q, k, v, key_padding_mask, _cpu_keep(q, k, dropout_seed, dropout_rate),
                            dropout_rate))
    return out, reference_lse(q, k, key_padding_mask) if with_lse else _no_lse(q)


def _forward_cuda(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse):
    out, lse = launch_forward(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse)
    return out, _no_lse(q) if lse is None else lse


def _forward_fake(q, k, v, key_padding_mask, dropout_seed, dropout_rate, with_lse):
    b, lq, h, _ = q.shape
    lse = q.new_empty((b * h, lq), dtype=torch.float32) if with_lse else _no_lse(q)
    return torch.empty_like(q), lse


forward_op = library.define(
    "mha_forward",
    "(Tensor q, Tensor k, Tensor v, Tensor? key_padding_mask, Tensor? dropout_seed, "
    "float dropout_rate, bool with_lse) -> (Tensor, Tensor)",
    cpu=_forward_cpu, cuda=_forward_cuda, fake=_forward_fake)
"""``detr_torch::mha_forward``: kernel A's forward, (out, lse); lse is
(B * H, Lq) float32 with ``with_lse``, else empty."""


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward op saves its row
    log-sum-exp, the backward kernel recomputes the softmax and replays the
    dropout."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_seed, dropout_rate):
        out, lse = forward_op(q, k, v, key_padding_mask, dropout_seed, dropout_rate, True)
        ctx.save_for_backward(q, k, v, out, lse, key_padding_mask, dropout_seed)
        ctx.dropout_rate = dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, key_padding_mask, dropout_seed = ctx.saved_tensors
        dq, dk, dv = launch_backward(q, k, v, out, dout, lse, key_padding_mask, dropout_seed,
                                 ctx.dropout_rate)
        return dq, dk, dv, None, None, None


def mha(q, k, v, key_padding_mask=None, dropout_rate: float = 0.0, dropout_seed=None):
    """Fused attention over batch-first (B, L, H, Dh) tensors.

    Q must already be scaled by ``Dh ** -0.5``. ``key_padding_mask`` is an
    optional (B, Lk) bool tensor, True = padded key. ``dropout_rate`` > 0
    drops attention weights with the mask ``keep_mask(dropout_seed, ...)``,
    ``dropout_seed`` a one-element int64 tensor on Q's device. Returns
    (B, Lq, H, Dh) in Q's dtype, differentiable in q, k and v.

    A CUDA tensor launches the kernels: the forward on the route
    ``forward_route`` picks (``mha.tf32_launches`` counts launches of the
    3xTF32 tensor-core kernel, ``mha.mma_launches`` those of the bf16
    tensor-core kernel, ``mha.launches`` those of the SIMT kernel, which
    only a direct call reaches), and under
    autograd the backward on the route ``backward_route`` picks
    (``mha.backward_mma_launches`` for the 3xTF32 tensor-core kernel,
    ``mha.backward_bf16_launches`` for the bf16 tensor-core kernel,
    ``mha.backward_launches`` for the SIMT kernel). Without autograd every
    device goes through the op ``detr_torch::mha_forward``, which runs
    ``reference_mha`` on a CPU tensor and raises on any other device.
    """
    _check(q, k, v, key_padding_mask, dropout_rate, dropout_seed)
    rate = float(dropout_rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cpu":
            return reference_mha(q, k, v, key_padding_mask,
                                 _cpu_keep(q, k, dropout_seed, rate), rate)
        return _FlashAttention.apply(q, k, v, key_padding_mask, dropout_seed, rate)
    return forward_op(q, k, v, key_padding_mask, dropout_seed, rate, False)[0]


mha.launches = 0
mha.mma_launches = 0
mha.tf32_launches = 0
mha.backward_launches = 0
mha.backward_mma_launches = 0
mha.backward_bf16_launches = 0


def kernel_keep_mask(seed: torch.Tensor, batch_heads: int, lq: int, lk: int, rate: float):
    """The keep mask the CUDA kernels draw for ``seed``, written out by the
    kernel library itself, (batch_heads, Lq, Lk) bool. For tests: training
    never materialises it."""
    if seed.device.type != "cuda" or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("seed must be one int64 element on a CUDA device")
    keep = torch.empty((batch_heads, lq, lk), device=seed.device, dtype=torch.uint8)
    with torch.cuda.device(seed.device):
        err = _library(_FWD_SOURCE).flash_attention_keep_mask(
            seed.data_ptr(), keep.data_ptr(), batch_heads, lq, lk,
            dropout_threshold(rate), _stream(seed.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_keep_mask launch failed: cudaError {err}")
    return keep.bool()
