#!/usr/bin/env python3
"""Kernel D's tensor-core kernels on one NVIDIA GPU, shape by shape: D-tf32
(fp32, 3xTF32) or D-mma (bf16).

  python3 scripts/torch_fused_residual_probe.py [--dtype float32|bfloat16] [--no-time]
                                                [--mma-rate] [--variants]

Builds the kernel's source (``csrc/fused_residual_tf32.cu`` at fp32,
``csrc/fused_residual_mma.cu`` at bf16), prints nvcc's ptxas report
(registers, spills) and the HMMA (tensor-core) instructions in its SASS.
Then, at the 8 D shapes of a b1 fused-backbone forward (the masked
896x1408 bucket's 4, launched 3, 4, 6 and 3 times a forward, and the
bucket-exact 768x1280 bucket's 4, once each) and at ragged shapes: the CTAs
of each launch; the kernel against the plain version (error relative to
the largest plain value, tolerance 1e-5 at fp32 and 2e-2 at bf16, as in
``chip_smoke.py``); at fp32 the kernel's and the plain version's errors
against a float64 chain; and, unless ``--no-time``, the device time of one
call of the kernel, of the SIMT D called at the same dtype, of the plain
version and of the unfused cuDNN chain (TF32 off), from CUDA graphs,
beside the bound (at fp32 as 3xTF32 at 495 TFLOP/s and on the fp32 pipes
at 67), and their sums over each bucket's forward. With ``--mma-rate``,
first the card's rate of back-to-back `mma.sync` instructions alone (no
loads, no splits: every warp of 4 CTAs an SM issues 8 independent MMAs per
loop step into accumulators held in registers), m16n8k8 TF32 and m16n8k16
bf16, from CUDA events: the ceiling of the repo's `mma.sync` kernels. With
``--variants`` (fp32), D-tf32 as built beside variants of it generated from
its source (a 3-stage ring of 16-channel chunks, small rounded to TF32, one
CTA an SM, a 128 x 128 tile of 16 warps), each checked against the plain
version and timed at the 8 path shapes in turns, with their sums a forward:
the measurements behind the tile and ring D-tf32 compiles. Needs a card;
exits non-zero if a shape disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from detr_tensorflow_tpu_torch.ops import fused_residual as fr  # noqa: E402
from detr_tensorflow_tpu_torch.ops import nvcc_build  # noqa: E402
from torch_probe_common import build_text, edited  # noqa: E402

# (bucket, launches a forward, b, Cin, Cout, H, W): the path's shapes, then
# ragged ones (P, Cin, Cout off the tiles and chunks; a map under one tile).
SHAPES = [("masked", 3, 1, 64, 256, 224, 352), ("masked", 4, 1, 128, 512, 112, 176),
          ("masked", 6, 1, 256, 1024, 56, 88), ("masked", 3, 1, 512, 2048, 28, 44),
          ("exact", 1, 1, 64, 256, 192, 320), ("exact", 1, 1, 128, 512, 96, 160),
          ("exact", 1, 1, 256, 1024, 48, 80), ("exact", 1, 1, 512, 2048, 24, 40),
          (None, 0, 2, 48, 40, 7, 9), (None, 0, 2, 200, 136, 9, 13), (None, 0, 1, 64, 256, 5, 7)]
# name, source, launcher, CTA tile (pixels, channels)
KERNELS = {torch.float32: ("D-tf32", "fused_residual_tf32.cu", fr.launch_tf32, (128, 64)),
           torch.bfloat16: ("D-mma", "fused_residual_mma.cu", fr.launch_mma, (128, 128))}


# The `mma.sync` rate: a kernel of nothing but MMAs, built here with nvcc.
MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>

template <int KIND>
__global__ void __launch_bounds__(256) mma_rate_kernel(float* out, int iters) {
  const unsigned v = 0x3f800000u + (threadIdx.x << 13);  // TF32 values near 1; bf16 pairs
  const unsigned a[4] = {v, v ^ 0x2000u, v ^ 0x4000u, v ^ 0x6000u}, b0 = v ^ 0x8000u, b1 = v;
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int mma_rate(int kind, int ctas, int iters, void* out, void* stream) {
  if (kind == 0)
    mma_rate_kernel<0><<<ctas, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), iters);
  else
    mma_rate_kernel<1><<<ctas, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rates(iters=8192):
    """TFLOP/s of back-to-back m16n8k8 TF32 and m16n8k16 bf16 `mma.sync`."""
    fn = build_text(nvcc_build, MMA_RATE_SOURCE, "mma_rate")[0].mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    ctas = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(ctas * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kind, name, flop in ((0, "m16n8k8 TF32", 2 * 16 * 8 * 8), (1, "m16n8k16 bf16", 2 * 16 * 8 * 16)):
        if fn(kind, ctas, 16, out.data_ptr(), stream):
            raise RuntimeError("mma_rate launch failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(kind, ctas, iters, out.data_ptr(), stream):
            raise RuntimeError("mma_rate launch failed")
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        mmas = ctas * 8 * iters * 8
        print(f"mma.sync {name} alone: {mmas * flop / ms / 1e9:.1f} TFLOP/s ({ctas} CTAs of 8 "
              f"warps, 8 independent accumulators a warp, {ms:.3f} ms)", flush=True)


# D-tf32's variants: (name, [(text in csrc/fused_residual_tf32.cu, replacement)]).
TWO_CTAS = ("__launch_bounds__(C::kThreads, 2)", "__launch_bounds__(C::kThreads, 1)")
ONE_CTA = ("2 * (kSmem + 1024) <= 233472", "kSmem + 1024 <= 233472")
VARIANTS = [
    ("built", []),
    ("3-stage ring of 16-channel chunks", [("KC = 32, S = 2", "KC = 16, S = 3")]),
    ("small rounded to TF32", [("split_operand(__uint_as_float", "tf32mma::split_tf32(__uint_as_float")]),
    ("one CTA an SM", [TWO_CTAS, ONE_CTA]),
    ("128 x 128 tile of 16 warps", [("BN = 64,", "BN = 128,"), ("WN = 2;", "WN = 4;"), TWO_CTAS,
                                    ONE_CTA]),
]


def variant_entries():
    """Each variant of D-tf32 built from the source with its replacements
    (every replaced text must occur), as {name: ctypes entry point}."""
    from concurrent.futures import ThreadPoolExecutor

    base = (nvcc_build.CSRC_DIR / "fused_residual_tf32.cu").read_text()

    def build(variant):
        name, edits = variant
        handle, log = build_text(nvcc_build, edited(base, edits, name),
                                 "fused_residual_tf32_variant", timeout=600)
        if log:
            report = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            print(f"variant {name!r}: {report}", flush=True)
        fn = handle.conv1x1_bn_residual_relu_tf32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        return fn

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip((v[0] for v in VARIANTS), pool.map(build, VARIANTS)))


def time_variants(rtol):
    """The variants at the 8 path shapes, in turns; returns the shapes that
    disagree with the plain version."""
    entries, sums, failed = variant_entries(), {}, []
    for bucket, count, b, cin, cout, h, w in SHAPES[:8]:
        x, wt, scale, shift, identity = ops = operands(b, cin, cout, h, w, torch.float32, cin + h)
        ref = fr.reference_conv1x1_bn_residual_relu(*ops)
        line = f"variants {bucket} {cin}->{cout} {h}x{w}:"
        for name, fn in entries.items():
            def call(fn=fn):
                y = torch.empty_like(identity)
                if fn(x.data_ptr(), wt.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                      identity.data_ptr(), y.data_ptr(), b * h * w, cin, cout,
                      torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"variant {name!r} failed to launch")
                return y

            err = rel_err(call(), ref)
            if not err <= rtol:
                failed.append((name, cin, cout, h, w, err))
            ms = graph_ms(call)
            sums[(name, bucket)] = sums.get((name, bucket), 0) + count * ms
            line += f" {name} {ms:.4f} ms ({err:.1e});"
        print(line, flush=True)
    for (name, bucket), ms in sums.items():
        print(f"variant {name!r} per {bucket} forward: {ms:.4f} ms", flush=True)
    return failed


def graph_ms(fn):
    return chip_smoke.graph_ms(torch, fn)


def operands(b, cin, cout, h, w, dtype, seed):
    """x (post-ReLU), W scaled by its fan-in, moderate FrozenBN scale and
    shift, a unit-normal identity: chip_smoke.py's D operands."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    x = cl(torch.rand(b, cin, h, w, device="cuda", generator=gen)).to(dtype)
    wt = (torch.randn(cout, cin, 1, 1, device="cuda", generator=gen) * cin**-0.5).to(dtype)
    scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
    shift = torch.randn(cout, device="cuda", generator=gen) * 0.3
    identity = cl(torch.randn(b, cout, h, w, device="cuda", generator=gen)).to(dtype)
    return x, wt, scale, shift, identity


def float64_tail(x, wt, scale, shift, identity):
    """relu(conv1x1(x) * scale + shift + identity) in float64 on the card."""
    acc = F.conv2d(x.double(), wt.double())
    return F.relu(acc * scale.double()[:, None, None] + shift.double()[:, None, None]
                  + identity.double())


def rel_err(got, ref):
    return float((got.double() - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--no-time", action="store_true", help="check every shape, time none")
    parser.add_argument("--mma-rate", action="store_true",
                        help="first time mma.sync alone, TF32 and bf16")
    parser.add_argument("--variants", action="store_true",
                        help="then time D-tf32 beside variants of its source (fp32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    name, source, launch, (bm, bn) = KERNELS[dtype]
    rtol = chip_smoke.FUSED_RTOL[args.dtype]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.mma_rate:
        mma_rates()
    build = nvcc_build.build(source)
    print(f"{name}: nvcc {build.seconds:.1f} s", flush=True)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    cuobjdump = Path(nvcc_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    print(f"HMMA instructions in the SASS: {sum('HMMA' in ln for ln in sass.splitlines())}")
    failed, sums = [], {}
    for bucket, count, b, cin, cout, h, w in SHAPES:
        ops = operands(b, cin, cout, h, w, dtype, seed=cin + h)
        p = b * h * w
        ctas = -(-p // bm) * -(-cout // bn)
        ref = fr.reference_conv1x1_bn_residual_relu(*ops)
        x, wt, scale, shift, identity = ops
        sd, td = scale.to(dtype)[:, None, None], shift.to(dtype)[:, None, None]
        before = fr.conv1x1_bn_residual_relu.tf32_launches + fr.conv1x1_bn_residual_relu.mma_launches
        got = fr.conv1x1_bn_residual_relu(*ops)
        torch.cuda.synchronize()
        routed = (fr.conv1x1_bn_residual_relu.tf32_launches
                  + fr.conv1x1_bn_residual_relu.mma_launches - before) == 1
        err = rel_err(got, ref)
        ok = routed and err <= rtol and bool(torch.isfinite(got).all())
        if not ok:
            failed.append((b, cin, cout, h, w, err, routed))
        line = [f"{bucket or 'ragged'} b={b} {cin}->{cout} {h}x{w}: {name} {ctas} CTAs of "
                f"{bm}x{bn}, rel err {err:.2e} against plain{'' if ok else ' FAILED'}"]
        if dtype == torch.float32:
            exact = float64_tail(*ops)
            line.append(f"against float64 {name} {rel_err(got, exact):.2e}, plain "
                        f"{rel_err(ref, exact):.2e}")
        if not args.no_time:
            size = x.element_size()
            nbytes = (p * (cin + 2 * cout) + cout * cin) * size + 8 * cout
            gemm, epilogue = 2 * p * cin * cout, 4 * p * cout
            bounds = ({"3xTF32": {"tf32": 3 * gemm, "float32": epilogue},
                       "fp32 pipes": {"float32": gemm + epilogue}}
                      if dtype == torch.float32 else
                      {"bf16": {"bfloat16": gemm, "float32": epilogue}})
            t = np.array([graph_ms(lambda: launch(*ops)), graph_ms(lambda: fr.launch_simt(*ops)),
                          graph_ms(lambda: fr.reference_conv1x1_bn_residual_relu(*ops)),
                          graph_ms(lambda: F.relu(F.conv2d(x, wt) * sd + td + identity)),
                          chip_smoke.bound_ms(nbytes, next(iter(bounds.values())))[0]])
            if bucket:
                sums[bucket] = sums.get(bucket, 0) + count * t
            line.append(
                f"{name} {t[0]:.4f} ms, SIMT D {t[1]:.4f} ms, plain {t[2]:.4f} ms, unfused cuDNN "
                f"chain {t[3]:.4f} ms, bound "
                + ", ".join(f"{chip_smoke.bound_ms(nbytes, ops_)[0]:.4f} ms {label} "
                            f"({chip_smoke.bound_ms(nbytes, ops_)[1]})"
                            for label, ops_ in bounds.items()))
        print("; ".join(line), flush=True)
    for bucket, t in sums.items():
        print(f"per {bucket} forward ({'16' if bucket == 'masked' else '4'} launches): {name} "
              f"{t[0]:.4f} ms, SIMT D {t[1]:.4f} ms, plain {t[2]:.4f} ms, unfused cuDNN chain "
              f"{t[3]:.4f} ms, bound {t[4]:.4f} ms", flush=True)
    if args.variants and dtype == torch.float32:
        failed += time_variants(rtol)
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every shape agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
