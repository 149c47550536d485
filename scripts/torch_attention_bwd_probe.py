#!/usr/bin/env python3
"""The attention backward (kernel A') on one NVIDIA GPU, at DETR's training
shapes (b8, 8 heads, Dh 32, dropout 0.1), fp32 and bf16.

  python3 scripts/torch_attention_bwd_probe.py [--variants] [--bf16-only]

For each shape it prints, at fp32, for the tensor-core kernel (3xTF32),
the SIMT kernel and the plain fp32 version, the largest error of dq, dk
and dv against a float64 plain version on the same inputs and keep mask,
relative to the largest float64 value, their L2 errors relative to the
float64 norms, and the error of sum_j dK_j (zero in exact arithmetic: it
is what a projection of nearly equal keys leaves of dK), relative to the
largest |dK|; then the device time of each kernel the tensor-core backward
launches (pre-pass, dK/dV, dQ), from ``torch.profiler`` over 20 calls. The
same at bf16 for A'-bf16 (``csrc/flash_attention_bwd_bf16.cu``), the SIMT
kernel and the plain bf16 version, against float64 on the same bf16
values, and the device time of each of A'-bf16's two launches.
``--variants`` also builds variants of A'-bf16's source (``VARIANTS``,
text edits that must each occur once: every design choice tried and
dropped) and prints their errors, how many of their outputs differ from
the built kernel's, and their CUDA-graph times beside the built kernel's,
in turns. Last, the card's rate for the fp32 kernel's instruction,
``mma.sync.m16n8k8`` TF32, from a loop of them built here: the time of one
MMA in a dependent chain, and TFLOP/s with eight independent chains a warp
at one, two and four warps per SM sub-partition. Needs a card; fp32
matmuls run without TF32.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from detr_tensorflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from detr_tensorflow_tpu_torch.ops import nvcc_build  # noqa: E402
from torch_probe_common import build_text, edited, registers  # noqa: E402

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
BF16_SOURCE = "flash_attention_bwd_bf16.cu"
_PRODUCTS = """    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
"""
_FRESH = """#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a, b[2 * n], b[2 * n + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * dp + n][e] += d[e];
    }
"""
_PASSES = """  passes_kernel<Dh><<<dim3(kv_blocks + row_blocks, a.batch * a.heads), kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.mask, keep, a.keep_scale, a.dq, a.dk, a.dv, a.lq,
      a.lk, a.heads, words, kv_blocks);
"""
_PASSES_APART = _PASSES.replace("kv_blocks + row_blocks", "kv_blocks") + _PASSES.replace(
    "kv_blocks + row_blocks", "row_blocks").replace("words, kv_blocks", "words, 0")
_DRAWERS = "if (kDelta && tid >= kThreads) {"
_THREADS = "const int prepass_threads = keep != nullptr ? 2 * kThreads : kThreads;"
_LOOP_LOAD = "    load_kv(tile + 1, stage ^ 1);\n    cp_async_wait<1>();"
_DRAW_FIRST = "    draw_keep(0, 0, tid - kThreads);\n"
_DRAW_NEXT = "if (tile + 1 < n_tiles) draw_keep(tile + 1, (tile + 1) & 1, tid - kThreads);"


def _ring(stages):
    """Edits giving the cp.async rings of both walks ``stages`` stages at
    Dh = 32 (two at Dh = 64, where four would pass the 48 KB of static
    shared memory): every tile of a 252-token walk in flight from the start
    at four. The key-bias rows stay double-buffered, written a tile ahead."""
    ring = "kRing<Dh>"
    return [
        ("constexpr float kLog2e = 1.4426950408889634f;\n",
         "constexpr float kLog2e = 1.4426950408889634f;\ntemplate <int Dh>\n"
         f"constexpr int kRing = Dh == 32 ? {stages} : 2;\n"),
        ("  bf16 k_tile[2][kTileK * kStride<Dh>];\n  bf16 v_tile[2][kTileK * kStride<Dh>];\n",
         f"  bf16 k_tile[{ring}][kTileK * kStride<Dh>];\n"
         f"  bf16 v_tile[{ring}][kTileK * kStride<Dh>];\n"),
        ("unsigned keep_tile[2][kQRows][2];", f"unsigned keep_tile[{ring}][kQRows][2];"),
        ("  bf16 q_tile[2][kTileQ * kStride<Dh>];\n  bf16 do_tile[2][kTileQ * kStride<Dh>];\n"
         "  float lse_tile[2][kTileQ];\n  float delta_tile[2][kTileQ];\n"
         "  unsigned keep_tile[2][2][kTileQ];",
         f"  bf16 q_tile[{ring}][kTileQ * kStride<Dh>];\n"
         f"  bf16 do_tile[{ring}][kTileQ * kStride<Dh>];\n"
         f"  float lse_tile[{ring}][kTileQ];\n  float delta_tile[{ring}][kTileQ];\n"
         f"  unsigned keep_tile[{ring}][2][kTileQ];"),
        (_DRAW_NEXT, _DRAW_NEXT.replace("(tile + 1) & 1", f"(tile + 1) % {ring}")),
        ("  load_kv(0, 0);\n", f"  for (int s = 0; s + 1 < {ring}; ++s) load_kv(s, s);\n"),
        ("    const int stage = tile & 1;\n    // The next tile's bias",
         f"    const int stage = tile % {ring};\n    // The next tile's bias"),
        (_LOOP_LOAD, f"    load_kv(tile + {ring} - 1, (tile + {ring} - 1) % {ring});\n"
                     f"    cp_async_wait<({ring} - 1)>();"),
        ("const float* bias = bias_tile[stage];", "const float* bias = bias_tile[tile & 1];"),
        ("  load_q(0, 0);\n  for (int tile = 0; tile < n_tiles; ++tile) {\n"
         "    const int stage = tile & 1;",
         f"  for (int s = 0; s + 1 < {ring}; ++s) load_q(s, s);\n"
         "  for (int tile = 0; tile < n_tiles; ++tile) {\n"
         f"    const int stage = tile % {ring};"),
        ("    load_q(tile + 1, stage ^ 1);\n    cp_async_wait<1>();",
         f"    load_q(tile + {ring} - 1, (tile + {ring} - 1) % {ring});\n"
         f"    cp_async_wait<({ring} - 1)>();"),
    ]


# (name, [(text in csrc/flash_attention_bwd_bf16.cu, replacement)]): every
# design choice tried and dropped, so that --variants measures each again.
VARIANTS = [
    ("built", []),
    # A'-mma's answer to the tensor cores' truncating adds (csrc/flash_attention_bwd_mma.cu).
    ("each MMA of dK, dV, dQ in a fresh accumulator, added in fp32", [(_PRODUCTS, _FRESH)]),
    ("the passes in two launches", [(_PASSES, _PASSES_APART)]),
    # The pre-pass without its draw warps: the walk's warps draw each tile's words.
    ("keep words drawn by the walk's own warps",
     [(_DRAWERS, "if (false) {"), (_THREADS, "const int prepass_threads = kThreads;"),
      (_LOOP_LOAD, _LOOP_LOAD.replace("\n", "\n    if (kDelta && keep != nullptr) "
                                             "draw_keep(tile, stage, tid);\n", 1))]),
    # A stage's steps past Lq or Lk left out (the built kernel runs them: they add nothing).
    ("early exit from a stage's steps",
     [("// the step's first key in the tile\n",
       "// the step's first key in the tile\n      if (tile * kTileK + kr >= lk) break;\n"),
      ("// the step's first query in the stage\n",
       "// the step's first query in the stage\n        if (tile * kTileQ + c0 >= lq) break;\n")]),
    ("steps of a stage not unrolled at Dh 32",
     [("constexpr int kUnroll = Dh == 32 ? 4 : 1;", "constexpr int kUnroll = 1;")]),
    ("passes at 4 CTAs an SM",
     [("__launch_bounds__(kThreads)\npasses_kernel",
       "__launch_bounds__(kThreads, 4)\npasses_kernel")]),
    ("rings of three stages at Dh 32", _ring(3)),
    ("rings of four stages at Dh 32", _ring(4)),
    # Ablation, timed but wrong: what drawing the keep words costs the pre-pass.
    ("ablate: no keep words drawn", [(_DRAW_FIRST, ""), (_DRAW_NEXT, "")]),
]


def inputs(lq, lk, masked, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    b, h, dh = 8, 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v = rng.normal(size=(2, b, lk, h, dh))
    dout = rng.normal(size=(b, lq, h, dh))
    to = lambda x: torch.from_numpy(x).to("cuda", dtype)  # noqa: E731
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
    """The line of (dq, dk, dv) against float64: each one's largest error and
    its L2 error, relative to the largest value and to the L2 norm, and the
    error of sum_j dK_j relative to the largest |dK|."""
    rel = [float((g.double() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
    l2 = [float((g.double() - r).norm() / r.norm()) for g, r in zip(got, ref)]
    col = float((got[1].double().sum(1) - ref[1].sum(1)).abs().max() / ref[1].abs().max())
    return (f"rel err against float64 dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}, L2 dq "
            f"{l2[0]:.4e} dk {l2[1]:.4e} dv {l2[2]:.4e}, sum_j dK_j {col:.3e}")


def differences(got, built):
    """How a variant's (dq, dk, dv) differ from the built kernel's: elements
    not bit-equal, of all, and the largest difference relative to the
    largest |value| of the tensor."""
    n = sum(int((g != b).sum()) for g, b in zip(got, built))
    total = sum(b.numel() for b in built)
    worst = max(float((g.float() - b.float()).abs().max() / b.float().abs().max())
                for g, b in zip(got, built))
    return f"{n} of {total} elements differ from built's, by at most {worst:.3e} relative"


def kernel_ms(fn, names, calls=20):
    """{kernel: device ms a call} over ``calls`` calls of ``fn`` under
    torch.profiler, for each kernel whose name holds one of ``names``,
    keyed by its name from that match up to its argument list (template
    arguments kept)."""
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
        for name in names:
            if name in evt.key and total:
                short = evt.key[evt.key.index(name):].split("(")[0]
                out[short] = out.get(short, 0.0) + total / 1e3 / calls
    return out


def graph_ms(fn):
    return chip_smoke.graph_ms(torch, fn)


def build_variants():
    """{variant name: its flash_attention_bwd_bf16 entry point}, one nvcc a
    distinct source, all at once; prints each build's ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor

    base = (nvcc_build.CSRC_DIR / BF16_SOURCE).read_text()
    sources = {name: edited(base, edits, name, once=True) for name, edits in VARIANTS}

    def build(src):
        handle, log = build_text(nvcc_build, src, "flash_attention_bwd_bf16_variant")
        if log:
            names = [n for n, other in sources.items() if other == src]
            print(f"variants {names}: {registers(log)}", flush=True)
        fn = handle.flash_attention_bwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_uint, ctypes.c_float] + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        return fn

    unique = list(dict.fromkeys(sources.values()))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(build, unique)))
    return {name: built[src] for name, src in sources.items()}


def call_variant(fn, q, k, v, out, dout, lse, mask, seed, rate):
    """(dq, dk, dv) of one call of a variant's entry point, with the
    scratch ``fa.launch_backward_bf16`` gives the built kernel."""
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    threshold = fa.dropout_threshold(rate)
    words = -(-lk // 32) if threshold else 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(b * h * lq * (1 + words), device="cuda", dtype=torch.float32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), None if mask is None else mask.data_ptr(),
             seed.data_ptr() if threshold else None, threshold,
             1.0 / (1.0 - rate) if threshold else 1.0, dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), scratch.data_ptr(), b, lq, lk, h, dh, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: cudaError {err}")
    return dq, dk, dv


def mma_rate(iters=4096):
    """(ns per MMA of a dependent chain, {warps per SM sub-partition: TFLOP/s
    with eight independent chains a warp}) of mma.sync m16n8k8 TF32."""
    fn = build_text(nvcc_build, MMA_LOOP, "mma_loop_probe")[0].mma_loop
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the variants of A'-bf16's source")
    parser.add_argument("--bf16-only", action="store_true",
                        help="leave out the fp32 kernels and the TF32 rate")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    for lq, lk, masked in [] if opts.bf16_only else SHAPES:
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
            print(f"{tag} {name}: {errors(got, ref)}", flush=True)
        times = kernel_ms(lambda: fa.launch_backward_mma(*args),
                          ("prepass_kernel", "dkdv_mma_kernel", "dq_mma_kernel"))
        print(f"{tag} tensor-core kernels, device ms a call (torch.profiler): "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)
    variants = build_variants() if opts.variants else {}
    for lq, lk, masked in SHAPES:
        q, k, v, dout, mask = inputs(lq, lk, masked, lq + lk, torch.bfloat16)
        seed = torch.tensor([lq * 31 + lk], device="cuda")
        keep = fa.kernel_keep_mask(seed, 64, lq, lk, RATE).view(8, 8, lq, lk)
        out, lse = fa.launch_forward(q, k, v, mask, seed, RATE, True)
        args = (q, k, v, out, dout, lse, mask, seed, RATE)
        ref = plain_grads(q, k, v, dout, mask, keep, torch.float64)
        rows = {"A'-bf16": fa.launch_backward_bf16(*args),
                "simt bf16": fa.launch_backward_simt(*args),
                "plain bf16": plain_grads(q, k, v, dout, mask, keep, torch.bfloat16)}
        tag = f"({lq},{lk}){' masked' if masked else ''} bf16"
        for name, got in rows.items():
            print(f"{tag} {name}: {errors(got, ref)}", flush=True)
        built = rows["A'-bf16"]
        for name, fn in variants.items():
            got = call_variant(fn, *args)
            print(f"{tag} variant {name}: {errors(got, ref)}; {differences(got, built)}",
                  flush=True)
        names = ("prepass_kernel", "passes_kernel")
        for rate, call in ((RATE, args), (0.0, args[:-2] + (None, 0.0))):
            times = kernel_ms(lambda: fa.launch_backward_bf16(*call), names)
            print(f"{tag} dropout {rate}: A'-bf16's launches, device ms a call (torch.profiler): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in times.items()) + "; the call from a "
                  f"CUDA graph {graph_ms(lambda: fa.launch_backward_bf16(*call)):.4f}", flush=True)
        if variants:
            names = list(variants)
            runs = {n: [] for n in names}
            for n in names + names[::-1]:
                runs[n].append(graph_ms(lambda fn=variants[n]: call_variant(fn, *args)))
            print(f"{tag} variants, CUDA-graph ms a call (two turns): "
                  + ", ".join(f"{n} {sum(r) / 2:.4f} ({r[0]:.4f}, {r[1]:.4f})"
                              for n, r in runs.items()), flush=True)
    if opts.bf16_only:
        return 0
    latency_ns, rates = mma_rate()
    print(f"mma.sync m16n8k8 TF32: {latency_ns:.2f} ns an MMA in a dependent chain (one warp per "
          f"SM sub-partition); with 8 independent chains a warp "
          + ", ".join(f"{w} warp(s) per sub-partition {r:.1f} TFLOP/s" for w, r in rates.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
