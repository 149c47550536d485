"""Frozen batch-norm, the exact feature validity mask and the box-head MLP
(port of ``detr_tensorflow_tpu/models/layers.py``), and the layers that
compute in the model's dtype from float32 parameters.

Every parameter of the port stays float32, as the JAX package keeps its
parameters; the model's ``dtype`` is its compute dtype only, as flax's
``dtype=``. ``Linear`` and ``Conv2d`` cast their weight and bias to their
input's dtype at each call (flax ``Dense``/``Conv``), and ``LayerNorm``
computes its statistics and affine in float32 from float32 scale and bias
and rounds once at the end (flax ``LayerNorm(dtype=...)``). While autograd
records, a cast is a differentiable ``p.to(dtype)``, so the gradient lands
in the float32 ``.grad``; otherwise it reads a copy cast once and cached
(``CachedOperands.cast``), so a served request casts nothing after its
first call. With float64 parameters and input (``model.double()``, for
diagnosis on the CPU) every cast is a no-op.

A program exported with ``torch.export`` (``export.py``) cannot key a
cache by data pointer: it traces fake tensors. ``operands_as_buffers``
makes every cached cast and fold a buffer of its module for the time of
the export, so the program holds each one once, as its own state, and
reads it on every call without deriving it again.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
import torch.nn.functional as F


class CachedOperands(nn.Module):
    """A module that keeps operands derived from its weights and buffers
    (cast, folded) in ``_cache`` until one of them changes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cache = {}
        self._pinned = None  # name -> buffer names, inside ``operands_as_buffers``

    def _apply(self, fn, *args, **kwargs):
        self._cache = {}  # .to(), .cuda(), .double(): new tensors, derive again
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        # Loading writes the weights in place, inference tensors too (which
        # keep their data pointer and have no version counter): derive again.
        self._cache = {}
        return super()._load_from_state_dict(*args, **kwargs)

    def _folded(self, name, tensors, fold):
        """``fold()``, computed once under ``name`` and kept until one of
        ``tensors`` is replaced or written in place (an optimizer step, a
        ``load_state_dict``). An inference tensor has no version counter,
        so its data pointer alone keys it: outside inference mode it cannot
        be written in place, and inside it a ``load_state_dict`` of this
        module or a parent drops the cache (a write by other means is not
        seen). Inside ``operands_as_buffers`` it returns the buffers that
        hold the cached value, whatever the tensors."""
        if self._pinned is not None:
            if name not in self._pinned:
                raise RuntimeError(f"{type(self).__name__} has no cached operand {name}: run the "
                                   "forward once before operands_as_buffers")
            value = tuple(getattr(self, b) for b in self._pinned[name])
            return value if isinstance(self._cache[name][1], tuple) else value[0]
        key = tuple((t.data_ptr(), None if t.is_inference() else t._version) for t in tensors)
        hit = self._cache.get(name)
        if hit is None or hit[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                hit = self._cache[name] = (key, fold())
        return hit[1]

    def cast(self, name: str, dtype: torch.dtype):
        """The tensor ``name`` of this module (a parameter or buffer; None
        stays None) in ``dtype``: itself when it has that dtype; a
        differentiable cast while autograd records a gradient for it;
        otherwise a copy cast once and cached."""
        t = getattr(self, name)
        if t is None or t.dtype == dtype:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return t.to(dtype)
        return self._folded(("cast", name, dtype), [t], lambda: t.to(dtype))


@contextlib.contextmanager
def operands_as_buffers(module: nn.Module):
    """Within the block, the cached operands of every ``CachedOperands``
    in ``module`` are buffers of their module (``_operand_<i>_<j>``, the
    j-th tensor of the i-th cached value), and ``_folded`` returns them as
    they are: a program traced inside (``torch.export``) holds each cast
    and fold once, as its state, and never recomputes it. The caches must
    already hold what the traced forward reads (run it once before); a
    miss raises. On exit the buffers go and the caches work as before."""
    owners = [m for m in module.modules() if isinstance(m, CachedOperands)]
    try:
        for m in owners:
            m._pinned = {}
            for i, (name, (_, value)) in enumerate(m._cache.items()):
                tensors = value if isinstance(value, tuple) else (value,)
                m._pinned[name] = [f"_operand_{i}_{j}" for j in range(len(tensors))]
                for buffer, t in zip(m._pinned[name], tensors):
                    m.register_buffer(buffer, t)
        yield
    finally:
        for m in owners:
            for buffers in (m._pinned or {}).values():
                for buffer in buffers:
                    m._buffers.pop(buffer, None)
            m._pinned = None


class Linear(CachedOperands, nn.Linear):
    """``nn.Linear`` over float32 parameters that computes in its input's
    dtype: weight and bias cast to it, output in it (flax ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.cast("weight", x.dtype), self.cast("bias", x.dtype))


class Conv2d(CachedOperands, nn.Conv2d):
    """``nn.Conv2d`` over float32 parameters that computes in its input's
    dtype: weight and bias cast to it, output in it (flax ``Conv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.cast("weight", x.dtype), self.cast("bias", x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over float32 scale and bias whose input may be in
    another dtype: statistics and affine in float32 (or wider), one
    rounding to the input's dtype at the end, as flax's ``LayerNorm(dtype=
    ...)`` computes. ATen's CUDA layer norm takes no mixed dtypes, so the
    input is cast up and the output down (two elementwise launches at
    bf16)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


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
            self.add_module(f"layer_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"layer_{i}")(x))
        return torch.sigmoid(getattr(self, f"layer_{self.num_layers - 1}")(x))
