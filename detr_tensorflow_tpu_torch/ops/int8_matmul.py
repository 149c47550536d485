"""Fused int8 1x1 convolutions with requantization epilogues: the
hand-written Hopper kernel and its plain PyTorch version.

Replaces the TPU kernel built by ``_call`` in
``detr_tensorflow_tpu/ops/pallas/int8_matmul.py`` and keeps its three entry
points, over NHWC activations flattened to (M, C):

* ``qmatmul``:           y = q(relu(x @ W * s + b))                      (conv1)
* ``qmatmul_residual``:  y = q(relu(x @ W * s + b + res * rs))           (conv3 + identity)
* ``qmatmul_residual2``: y = q(relu(x @ W * s + b + xd @ Wd * sd + bd))  (conv3 + downsample)

``q`` rounds half to even and clips to int8 (to [0, 127] under ReLU), or
the result is written in bf16. ``precise=False`` is the TPU kernel's bf16
epilogue (within 1 LSB of the precise one). Weights are K-major, (K, C):
row k holds output channel k (``models/weights.py:from_jax_quant`` converts
the JAX package's HWIO kernels once). The CUDA source is
``csrc/int8_matmul.cu``, the epilogue ``csrc/int8_common.cuh``.

The three entry points call one custom op, ``detr_torch::int8_matmul``
(``ops/library.py``), on the flattened (M, C) rows; which optional
operands it gets picks the epilogue. A CUDA tensor launches the kernel (C
and Cd multiples of 64, K of 8) and a CPU tensor takes the plain version;
there is no fallback from one to the other. ``plan`` picks the kernel's
configuration from the shape alone, inside the op. ``<fn>.launches`` counts
each entry point's kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import library

_SOURCE = "int8_matmul.cu"
_CHUNK = 64  # the kernel's contraction granule (C % 64 == 0)
_PLAIN, _RESIDUAL, _RESIDUAL2 = 0, 1, 2
OUT_DTYPES = (torch.int8, torch.bfloat16)

# The kernel's one compiled tile (``csrc/int8_matmul.cu``, ``struct T``):
# rows x output channels of a CTA, 8 warps of 32 x 32, a 2-stage ring of
# KC-byte contraction chunks, and the thread-block cluster sizes it takes.
TILE = (128, 64)
KC = 64
CLUSTERS = (1, 2, 4, 8)
_STAGES = 2
# The plan splits a tile's contraction across a cluster only where the
# tiles alone are fewer than FILL, two CTAs on each of the H100's 132 SMs,
# and then until each rank sums at most DEPTH 64-byte chunks. Where the
# tiles fill the card a split only adds the exchange.
FILL = 264
DEPTH = 8
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can have on the H100


class Plan(NamedTuple):
    """The kernel's configuration at one shape: its CTA tile (rows x output
    channels), the thread-block cluster that splits each tile's
    contraction, and the CTAs it launches."""

    rows: int
    channels: int
    cluster: int
    ctas: int


def plan(m: int, c: int, k: int, cd: int = 0) -> Plan:
    """The kernel's configuration at an (M, C) x (K, C) product (plus an
    (M, Cd) x (K, Cd) one for ``qmatmul_residual2``), from the shape alone.
    Where the output tiles are fewer than ``FILL``, the cluster's ranks
    split the contraction of one tile, C and Cd each into whole 64-byte
    chunks: the smallest split that leaves each rank at most ``DEPTH``
    chunks (the largest that cuts both into whole chunks where none does).
    Raises unless C and Cd are multiples of 64 and K of 8."""
    if c <= 0 or cd < 0 or c % _CHUNK or cd % _CHUNK or k <= 0 or k % 8:
        raise ValueError(f"the int8 matmul kernel takes C and Cd multiples of {_CHUNK} and K "
                         f"a multiple of 8, got C={c}, Cd={cd}, K={k}")
    rows, channels = TILE
    tiles = -(-m // rows) * -(-k // channels)
    chunks = (c + cd) // _CHUNK
    splits = [n for n in CLUSTERS if c % (_CHUNK * n) == 0 and cd % (_CHUNK * n) == 0]
    cluster = 1 if tiles >= FILL else next((n for n in splits if chunks // n <= DEPTH),
                                           splits[-1])
    return Plan(rows, channels, cluster, tiles * cluster)


def smem_bytes(variant: str, out_dtype=torch.int8) -> int:
    """Dynamic shared memory of one CTA, the kernel's ``smem_bytes``: the
    ring (or the cluster's exchange of one set of int32 partial sums over
    the tile, two for residual2, if larger), the staged int8 tile with rows
    padded by 16 bytes, four coefficient vectors over the tile's channels,
    and the staged bf16 tile for a bf16 output."""
    bm, bn = TILE
    sets = 2 if variant == "residual2" else 1
    ring = max(_STAGES * (bm + bn) * KC, 4 * bm * bn * sets)
    out16 = bm * (2 * bn + 16) if out_dtype == torch.bfloat16 else 0
    return ring + bm * (bn + 16) + 4 * bn * 4 + out16


def _int_products(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, C) int8 @ (K, C)^T int8 as exact integers held in float64: every
    partial sum of this backbone stays below 2^53 (|acc| <= 9 * 2048 *
    128^2 < 2^29), and PyTorch has no integer product on CUDA tensors."""
    return x2d.double() @ w.double().t()


def epilogue(acc, scale, bias, *, relu, out_dtype, precise, res=None, res_scale=None,
             acc_d=None, scale_d=None, bias_d=None):
    """The TPU kernels' epilogue on integer accumulators (any float dtype
    holding exact integers), in their order of operations:
    ``(acc*s + b) [+ res*rs | + acc_d*sd + bd]``, each product and sum
    rounded in the epilogue dtype (float32, or bf16 for ``precise=False``),
    then ReLU folded into the clip, round half to even and int8, or the
    ReLU'd value in ``out_dtype``."""
    ep = torch.float32 if precise else torch.bfloat16
    # int32 -> float32 rounds to nearest even, as the kernel's conversion.
    y = acc.float().to(ep) * scale.to(ep) + bias.to(ep)
    if res is not None:
        y = y + res.to(ep) * res_scale.to(ep)
    if acc_d is not None:
        y = y + acc_d.float().to(ep) * scale_d.to(ep) + bias_d.to(ep)
    if out_dtype == torch.int8:
        if ep == torch.bfloat16 and relu:
            # The bf16 epilogue rounds half up: clip, + 0.5, truncate.
            return (y.clamp(0.0, 127.0) + 0.5).to(torch.int8)
        return torch.round(y.float()).clamp(0.0 if relu else -128.0, 127.0).to(torch.int8)
    if relu:
        y = y.clamp_min(0.0)
    return y.to(out_dtype)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _check(x, w, scale, bias, out_dtype, what="x"):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what} and its weights must be int8, got {x.dtype} and {w.dtype}")
    if w.dim() != 2 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"weights {tuple(w.shape)} are not (K, {x.shape[-1]})")
    k = w.shape[0]
    for name, v in (("scale", scale), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (k,):
            raise ValueError(f"{name} must be float32 ({k},), got {v.dtype} {tuple(v.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    devices = {t.device for t in (x, w, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {devices}")
    library.check_device(x, "int8 matmul")


def check_kernel_operands(*tensors):
    """The CUDA kernels read 16-byte vectors of contiguous rows."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("int8 kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("int8 kernel operands must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(variant, x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d, *, relu,
            out_dtype, precise):
    """One kernel launch on CUDA tensors; returns (M, K)."""
    m, c = x.shape
    k = w.shape[0]
    cd = 0 if xd is None else xd.shape[1]
    cluster = plan(m, c, k, cd).cluster
    check_kernel_operands(x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d)
    out = _matmul_output(x, w, out_dtype)
    with torch.cuda.device(x.device):
        err = _library().int8_matmul(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(res),
            _ptr(res_scale), _ptr(xd), _ptr(wd), _ptr(scale_d), _ptr(bias_d), out.data_ptr(),
            m, c, k, cd, variant, int(relu), int(out_dtype == torch.bfloat16), int(precise),
            cluster, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    return out


def _matmul_cpu(x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d, relu, out_dtype,
                precise):
    kw = dict(relu=relu, out_dtype=out_dtype, precise=precise)
    if xd is not None:
        out = reference_qmatmul_residual2(x, w, scale, bias, xd, wd, scale_d, bias_d, **kw)
    elif res is not None:
        out = reference_qmatmul_residual(x, w, scale, bias, res, res_scale, **kw)
    else:
        out = reference_qmatmul(x, w, scale, bias, **kw)
    return _matmul_output(x, w, out_dtype).copy_(out)


def _matmul_cuda(x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d, relu, out_dtype,
                 precise):
    variant, entry = ((_RESIDUAL2, qmatmul_residual2) if xd is not None else
                      (_RESIDUAL, qmatmul_residual) if res is not None else (_PLAIN, qmatmul))
    out = _launch(variant, x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d, relu=relu,
                  out_dtype=out_dtype, precise=precise)
    entry.launches += 1
    return out


def _matmul_output(x, w, out_dtype):
    return x.new_empty((x.shape[0], w.shape[0]), dtype=out_dtype)


def _matmul_fake(x, w, scale, bias, res, res_scale, xd, wd, scale_d, bias_d, relu, out_dtype,
                 precise):
    return _matmul_output(x, w, out_dtype)


matmul_op = library.define(
    "int8_matmul",
    "(Tensor x, Tensor w, Tensor scale, Tensor bias, Tensor? res, Tensor? res_scale, Tensor? xd, "
    "Tensor? wd, Tensor? scale_d, Tensor? bias_d, bool relu, ScalarType out_dtype, bool precise)"
    " -> Tensor",
    cpu=_matmul_cpu, cuda=_matmul_cuda, fake=_matmul_fake)
"""``detr_torch::int8_matmul``: kernel F on (M, C) rows, (M, K) out; ``xd``
given is ``qmatmul_residual2``'s epilogue, else ``res`` given is
``qmatmul_residual``'s, else ``qmatmul``'s."""


def reference_qmatmul(x, w, scale, bias, *, relu=True, out_dtype=torch.int8, precise=True):
    """Plain version of ``qmatmul``, on any device."""
    out = epilogue(_int_products(_flat(x), w), scale, bias, relu=relu, out_dtype=out_dtype,
                   precise=precise)
    return out.reshape(*x.shape[:-1], -1)


def reference_qmatmul_residual(x, w, scale, bias, res, res_scale, *, relu=True,
                               out_dtype=torch.int8, precise=True):
    """Plain version of ``qmatmul_residual``, on any device."""
    out = epilogue(_int_products(_flat(x), w), scale, bias, res=_flat(res),
                   res_scale=res_scale.reshape(()), relu=relu, out_dtype=out_dtype,
                   precise=precise)
    return out.reshape(*x.shape[:-1], -1)


def reference_qmatmul_residual2(x, w, scale, bias, xd, wd, scale_d, bias_d, *, relu=True,
                                out_dtype=torch.int8, precise=True):
    """Plain version of ``qmatmul_residual2``, on any device."""
    out = epilogue(_int_products(_flat(x), w), scale, bias, acc_d=_int_products(_flat(xd), wd),
                   scale_d=scale_d, bias_d=bias_d, relu=relu, out_dtype=out_dtype,
                   precise=precise)
    return out.reshape(*x.shape[:-1], -1)


def qmatmul(x, w, scale, bias, *, relu=True, out_dtype=torch.int8, precise=True):
    """q(relu(x @ w^T * scale + bias)): int8 (..., C) x (K, C) -> (..., K)."""
    _check(x, w, scale, bias, out_dtype)
    out = matmul_op(_flat(x), w, scale, bias, None, None, None, None, None, None, relu,
                    out_dtype, precise)
    return out.reshape(*x.shape[:-1], -1)


def qmatmul_residual(x, w, scale, bias, res, res_scale, *, relu=True, out_dtype=torch.int8,
                     precise=True):
    """q(relu(x @ w^T * scale + bias + res * res_scale)): the bottleneck
    tail with an int8 identity (res: (..., K) int8; res_scale a one-element
    float32 tensor on the same device, read there, so no host sync)."""
    _check(x, w, scale, bias, out_dtype)
    k = w.shape[0]
    if res.dtype != torch.int8 or res.shape != x.shape[:-1] + (k,):
        raise ValueError(f"res must be int8 {tuple(x.shape[:-1]) + (k,)}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    if res_scale.dtype != torch.float32 or res_scale.numel() != 1:
        raise ValueError("res_scale must be one float32 element")
    out = matmul_op(_flat(x), w, scale, bias, _flat(res), res_scale.reshape(()), None, None,
                    None, None, relu, out_dtype, precise)
    return out.reshape(*x.shape[:-1], -1)


def qmatmul_residual2(x, w, scale, bias, xd, wd, scale_d, bias_d, *, relu=True,
                      out_dtype=torch.int8, precise=True):
    """q(relu(x @ w^T * s + b + xd @ wd^T * s_d + b_d)): the stage-entry
    bottleneck tail with the 1x1 downsample as a second contraction (xd:
    the stride-sliced block input, (..., Cd) int8, contiguous)."""
    _check(x, w, scale, bias, out_dtype)
    _check(xd, wd, scale_d, bias_d, out_dtype, what="xd")
    if xd.shape[:-1] != x.shape[:-1] or wd.shape[0] != w.shape[0]:
        raise ValueError(f"xd {tuple(xd.shape)} / wd {tuple(wd.shape)} do not match x "
                         f"{tuple(x.shape)} / w {tuple(w.shape)}")
    out = matmul_op(_flat(x), w, scale, bias, None, None, _flat(xd), wd, scale_d, bias_d, relu,
                    out_dtype, precise)
    return out.reshape(*x.shape[:-1], -1)


qmatmul.launches = 0
qmatmul_residual.launches = 0
qmatmul_residual2.launches = 0
