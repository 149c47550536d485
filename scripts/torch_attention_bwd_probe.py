#!/usr/bin/env python3
"""The attention backward (kernel A') on one NVIDIA GPU, at DETR's training
shapes (b8, 8 heads, Dh 32, fp32, dropout 0.1).

  python3 scripts/torch_attention_bwd_probe.py

For each shape it prints, for the tensor-core kernel (3xTF32), the SIMT
kernel and the plain fp32 version, the largest error of dq, dk and dv
against a float64 plain version on the same inputs and keep mask, relative
to the largest float64 value, and the error of sum_j dK_j (zero in exact
arithmetic: it is what a projection of nearly equal keys leaves of dK),
relative to the largest |dK|. Then the device time of each kernel the
tensor-core backward launches (pre-pass, dK/dV, dQ), from
``torch.profiler`` over 20 calls. Last, the card's rate for the kernel's
instruction, ``mma.sync.m16n8k8`` TF32, from a loop of them built here:
the time of one MMA in a dependent chain, and TFLOP/s with eight
independent chains a warp at one, two and four warps per SM
sub-partition. Needs a card; fp32 matmuls run without TF32.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from detr_tensorflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from detr_tensorflow_tpu_torch.ops import nvcc_build  # noqa: E402

MMA_LOOP = r"""
#include <cuda_runtime.h>
template <int kChains>
__global__ void mma_loop(float* out, int iters) {
  const unsigned a = __float_as_uint(1.f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const unsigned b = __float_as_uint(1.f - threadIdx.x * 1e-3f) & 0xffffe000u;
  float d[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %5}, {%0, %1, %2, %3};"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a), "r"(b));
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop(void* out, int blocks, int iters, int chains, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (chains == 1) mma_loop<1><<<blocks, 128, 0, st>>>(o, iters);
  else if (chains == 8) mma_loop<8><<<blocks, 128, 0, st>>>(o, iters);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""

SHAPES = [(252, 252, False), (100, 252, True), (100, 100, False)]
RATE = 0.1


def inputs(lq, lk, masked, seed):
    rng = np.random.default_rng(seed)
    b, h, dh = 8, 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v = rng.normal(size=(2, b, lk, h, dh))
    dout = rng.normal(size=(b, lq, h, dh))
    to = lambda x: torch.from_numpy(x).to("cuda", torch.float32)  # noqa: E731
    mask = None
    if masked:
        valid = rng.integers(lk // 3, lk + 1, size=b)
        mask = torch.from_numpy(np.arange(lk)[None, :] >= valid[:, None]).cuda()
    return to(q), to(k), to(v), to(dout), mask


def plain_grads(q, k, v, dout, mask, keep, dtype):
    q, k, v = (t.detach().to(dtype).requires_grad_() for t in (q, k, v))
    out = fa.reference_mha(q, k, v, mask, keep, RATE)
    return torch.autograd.grad(out, (q, k, v), dout.to(dtype))


def errors(got, ref):
    rel = [float((g.double() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
    col = float((got[1].double().sum(1) - ref[1].sum(1)).abs().max() / ref[1].abs().max())
    return rel + [col]


def kernel_ms(fn, calls=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        for name in ("prepass_kernel", "dkdv_mma_kernel", "dq_mma_kernel"):
            if name in evt.key and total:
                out[name] = out.get(name, 0.0) + total / 1e3 / calls
    return out


def mma_rate(iters=4096):
    """(ns per MMA of a dependent chain, {warps per SM sub-partition: TFLOP/s
    with eight independent chains a warp}) of mma.sync m16n8k8 TF32."""
    nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = nvcc_build.BUILD_DIR / "mma_loop_probe.cu"
    lib_path = src.with_suffix(".so")
    src.write_text(MMA_LOOP)
    subprocess.run([nvcc_build.nvcc_path(), *nvcc_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).mma_loop
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def seconds(blocks, chains):
        out = torch.empty(blocks * 128, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):
            if fn(out.data_ptr(), blocks, iters, chains, stream):
                raise RuntimeError("mma_loop launch failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(out.data_ptr(), blocks, iters, chains, stream)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    latency_ns = 1e9 * seconds(sms, 1) / iters
    rates = {}
    for warps in (1, 2, 4):
        blocks = sms * warps
        mmas = blocks * 4 * iters * 8
        rates[warps] = mmas * 2 * 16 * 8 * 8 / seconds(blocks, 8) / 1e12
    return latency_ns, rates


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for lq, lk, masked in SHAPES:
        q, k, v, dout, mask = inputs(lq, lk, masked, lq + lk)
        seed = torch.tensor([lq * 31 + lk], device="cuda")
        keep = fa.kernel_keep_mask(seed, 64, lq, lk, RATE).view(8, 8, lq, lk)
        out, lse = fa.launch_forward(q, k, v, mask, seed, RATE, True)
        args = (q, k, v, out, dout, lse, mask, seed, RATE)
        ref = plain_grads(q, k, v, dout, mask, keep, torch.float64)
        rows = {"tensor-core": fa.launch_backward_mma(*args),
                "simt": fa.launch_backward_simt(*args),
                "plain fp32": plain_grads(q, k, v, dout, mask, keep, torch.float32)}
        tag = f"({lq},{lk}){' masked' if masked else ''}"
        for name, got in rows.items():
            dq, dk, dv, col = errors(got, ref)
            print(f"{tag} {name}: rel err against float64 dq {dq:.3e} dk {dk:.3e} dv {dv:.3e}, "
                  f"sum_j dK_j {col:.3e}", flush=True)
        times = kernel_ms(lambda: fa.launch_backward_mma(*args))
        print(f"{tag} tensor-core kernels, device ms a call (torch.profiler): "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)
    latency_ns, rates = mma_rate()
    print(f"mma.sync m16n8k8 TF32: {latency_ns:.2f} ns an MMA in a dependent chain (one warp per "
          f"SM sub-partition); with 8 independent chains a warp "
          + ", ".join(f"{w} warp(s) per sub-partition {r:.1f} TFLOP/s" for w, r in rates.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
