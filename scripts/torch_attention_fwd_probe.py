#!/usr/bin/env python3
"""The fp32 attention forward (kernel A) on one NVIDIA GPU, against float64.

  python3 scripts/torch_attention_fwd_probe.py

At DETR's served encoder shape ((1232, 1232), B=2, masked) and its
training shapes (b8, dropout 0.1: (252, 252), (100, 252) masked, (100,
100)), 8 heads, Dh 32, it prints for the tensor-core kernel (3xTF32), the
SIMT kernel and the plain fp32 version the largest error of the output and
of the row lse against a float64 plain version on the same inputs and keep
mask, relative to the largest float64 value (the lse: absolute). Then the
device time of one call of the tensor-core kernel at each CTA shape and of
the SIMT kernel, from ``torch.profiler`` over 20 calls. Needs a card;
fp32 matmuls run without TF32.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from detr_tensorflow_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (batch, Lq, Lk, masked, dropout rate)
SHAPES = [(2, 1232, 1232, True, 0.0), (8, 252, 252, False, 0.1), (8, 100, 252, True, 0.1),
          (8, 100, 100, False, 0.1)]


def inputs(b, lq, lk, masked, seed):
    rng = np.random.default_rng(seed)
    h, dh = 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v = rng.normal(size=(2, b, lk, h, dh))
    to = lambda x: torch.from_numpy(x).to("cuda", torch.float32)  # noqa: E731
    mask = None
    if masked:
        valid = rng.integers(lk // 3, lk + 1, size=b)
        mask = torch.from_numpy(np.arange(lk)[None, :] >= valid[:, None]).cuda()
    return to(q), to(k), to(v), mask


def plain(q, k, v, mask, keep, rate, dtype):
    """Output and row lse of the plain version in ``dtype``."""
    q, k, v = (t.to(dtype) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :], -1e30)
    lse = torch.logsumexp(scores, dim=-1).flatten(0, 1)
    return fa.reference_mha(q, k, v, mask, keep, rate), lse


def device_ms(fn, name, calls=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if name in evt.key:
            total += t
    return total / 1e3 / calls


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for b, lq, lk, masked, rate in SHAPES:
        q, k, v, mask = inputs(b, lq, lk, masked, lq + lk + b)
        seed = torch.tensor([lq * 17 + lk], device="cuda")
        keep = (fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk)
                if rate else None)
        ref, ref_lse = plain(q, k, v, mask, keep, rate, torch.float64)
        valid = ref_lse > -1e29
        rows = {"tensor-core": fa.launch_forward_tf32(q, k, v, mask, seed, rate, True),
                "simt": fa.launch_forward_simt(q, k, v, mask, seed, rate, True),
                "plain fp32": plain(q, k, v, mask, keep, rate, torch.float32)}
        tag = f"({lq},{lk}) b{b}{' masked' if masked else ''} dropout {rate}"
        for name, (out, lse) in rows.items():
            err = float((out.double() - ref).abs().max() / ref.abs().max())
            lse_err = float((lse.double() - ref_lse)[valid].abs().max())
            print(f"{tag} {name}: output rel err against float64 {err:.3e}, lse abs err "
                  f"{lse_err:.3e}", flush=True)
        times = {str(shape): device_ms(lambda: fa.launch_forward_tf32(
            q, k, v, mask, seed, rate, True, shape=shape), "fwd_tf32") for shape in fa.MMA_SHAPES}
        times["simt"] = device_ms(lambda: fa.launch_forward_simt(q, k, v, mask, seed, rate, True),
                                  "flash_attention_fwd_kernel")
        print(f"{tag} device ms a call (torch.profiler): "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
