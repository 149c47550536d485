#!/usr/bin/env python3
"""Kernel E's tensor-core kernels on one NVIDIA GPU, width by width: E-tf32
(fp32, 3xTF32) or E-mma (bf16).

  python3 scripts/torch_fused_bottleneck_probe.py [--dtype float32|bfloat16] [--no-time]
                                                  [--attention]

Builds the kernel's source (``csrc/fused_bottleneck_tf32.cu`` at fp32,
``csrc/fused_bottleneck_mma.cu`` at bf16), prints nvcc's ptxas report
(registers, spills, per plan) and the HMMA (tensor-core) instructions in
its SASS, and for each width's plan the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``) and a CTA's shared memory. Then, at
the four ResNet-50 widths on the maps of a 768x1280 bucket-exact forward
and at ragged maps, with nonzero biases: the CTAs of each launch; the
kernel against the plain version (error relative to the largest plain
value, tolerance 1e-5 at fp32 and 2e-2 at bf16, as in ``chip_smoke.py``);
at fp32 the kernel's and the plain version's errors against a float64
chain; and, unless ``--no-time``, the device time of one call of the
kernel, of the SIMT kernel called at the same dtype, of the plain version
and of the unfused cuDNN chain (TF32 off), from CUDA graphs, beside the
bound (3xTF32 at 495 TFLOP/s and the fp32 pipes at 67 at fp32). With
``--attention``, also A-tf32 at (1232,1232) B=2 and A'-mma at (252,252)
b8 dropout 0.1, fp32, from CUDA graphs (the kernels that share
``csrc/tf32_mma.cuh`` with E-tf32). Needs a card; exits non-zero if a shape
disagrees.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from detr_tensorflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from detr_tensorflow_tpu_torch.ops import fused_bottleneck as fb  # noqa: E402
from detr_tensorflow_tpu_torch.ops import nvcc_build  # noqa: E402

# (n, C, M, H, W): the 768x1280 bucket's maps, then ragged ones (partial
# tiles, a map smaller than one tile).
SHAPES = [(1, 256, 64, 192, 320), (1, 512, 128, 96, 160), (1, 1024, 256, 48, 80),
          (1, 2048, 512, 24, 40), (2, 256, 64, 13, 21), (2, 512, 128, 9, 11),
          (2, 1024, 256, 7, 5), (1, 2048, 512, 5, 7)]
KERNELS = {torch.float32: ("E-tf32", "fused_bottleneck_tf32.cu", fb.TF32_PLANS, fb.launch_tf32,
                           fb.tf32_occupancy),
           torch.bfloat16: ("E-mma", "fused_bottleneck_mma.cu", fb.MMA_PLANS, fb.launch_mma,
                            fb.mma_occupancy)}


def graph_ms(fn):
    return chip_smoke.graph_ms(torch, fn)


def operands(n, c, m, h, w, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, c, h, w, device="cuda", generator=gen).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w1, w3 = (torch.randn(s, device="cuda", generator=gen) * s[0] ** -0.5 for s in ((c, m), (m, c)))
    w2 = torch.randn(9, m, m, device="cuda", generator=gen) * (9 * m) ** -0.5
    b1 = torch.rand(m, device="cuda", generator=gen) + 0.5  # > 0: the halo is tested
    b2, b3 = (torch.randn(k, device="cuda", generator=gen) * 0.1 for k in (m, c))
    return x, (w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype), b3)


def convs(ops, m):
    """The three OIHW conv kernels of the operands."""
    w1t, _, w2t, _, w3t, _ = ops
    return (w1t.t()[:, :, None, None], w2t.reshape(3, 3, m, m).permute(3, 2, 0, 1),
            w3t.t()[:, :, None, None])


def float64_chain(x, ops, m):
    """The bottleneck in float64 on the card, from the same operands."""
    k1, k2, k3 = (k.double() for k in convs(ops, m))
    b1, b2, b3 = (b.double()[:, None, None] for b in ops[1::2])
    xd = x.double()
    t = F.relu(F.conv2d(xd, k1) + b1)
    t = F.relu(F.conv2d(t, k2, padding=1) + b2)
    return F.relu(F.conv2d(t, k3) + b3 + xd)


def rel_err(got, ref):
    return float((got.double() - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))


def attention_times():
    """A-tf32 and A'-mma, the kernels that share csrc/tf32_mma.cuh, at the
    shapes PERF.md records them at."""
    q, k, v, mask = chip_smoke.attention_inputs(torch, 2, 1232, 1232, torch.float32, seed=7)
    ms = graph_ms(lambda: fa.launch_forward_tf32(q, k, v, mask, None, 0.0, False))
    print(f"A-tf32 (1232,1232) fp32 B=2 H=8 Dh=32 masked: {ms:.4f} ms (CUDA graphs)", flush=True)
    q, k, v, dout, mask = chip_smoke.train_attention_inputs(torch, 252, 252, torch.float32,
                                                            seed=3, masked=False)
    chip_smoke.time_train_attention(torch, fa, q, k, v, dout, mask)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--no-time", action="store_true", help="check every shape, time none")
    parser.add_argument("--attention", action="store_true",
                        help="also time A-tf32 and A'-mma")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    name, source, plans, launch, occupancy = KERNELS[dtype]
    rtol = chip_smoke.FUSED_RTOL[args.dtype]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build = nvcc_build.build(source)
    print(f"{name}: nvcc {build.seconds:.1f} s", flush=True)
    plan_args = ""
    for line in build.log.splitlines():
        if "Compiling entry" in line:  # a mangled name: its integer template arguments
            plan_args = ",".join(re.findall(r"Li(\d+)E", line))
        elif "registers" in line or "spill" in line:
            print(f"  ptxas <{plan_args}>: {line.strip()}")
    cuobjdump = Path(nvcc_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    print(f"HMMA instructions in the SASS: {sum('HMMA' in ln for ln in sass.splitlines())}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, plan in plans.items():
        clusters, smem = occupancy(m)
        print(f"M={m} plan {plan}: {smem} bytes of shared memory a CTA, at most {clusters} "
              f"clusters of {plan[2]} at once ({clusters * plan[2]} CTAs on {sms} SMs)", flush=True)
    failed = []
    for n, c, m, h, w in SHAPES:
        x, ops = operands(n, c, m, h, w, dtype, seed=c + h)
        th, tw, k = plans[m]
        ctas = -(-h // th) * -(-w // tw) * k * n
        ref = fb.reference_fused_bottleneck(x, *ops)
        k1, k2, k3 = convs(ops, m)
        bd = [b.to(dtype)[:, None, None] for b in ops[1::2]]

        def chain():
            t = F.relu(F.conv2d(x, k1) + bd[0])
            t = F.relu(F.conv2d(t, k2, padding=1) + bd[1])
            return F.relu(F.conv2d(t, k3) + bd[2] + x)

        got = launch(x, *ops)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        ok = err <= rtol and bool(torch.isfinite(got).all())
        if not ok:
            failed.append((n, c, m, h, w, err))
        line = [f"n={n} C={c} M={m} {h}x{w}: {name} plan {plans[m]}, {ctas} CTAs, rel err "
                f"{err:.2e} against plain{'' if ok else ' FAILED'}"]
        if dtype == torch.float32:
            exact = float64_chain(x, ops, m)
            line.append(f"against float64 {name} {rel_err(got, exact):.2e}, plain "
                        f"{rel_err(ref, exact):.2e}")
        if not args.no_time:
            p = n * h * w
            nbytes = (2 * p * c + 2 * c * m + 9 * m * m) * x.element_size() + 4 * (2 * m + c)
            flops = 2 * p * (2 * c * m + 9 * m * m)
            bounds = ({"3xTF32": {"tf32": 3 * flops}, "fp32 pipes": {"float32": flops}}
                      if dtype == torch.float32 else {"bf16": {"bfloat16": flops}})
            line.append(
                f"{name} {graph_ms(lambda: launch(x, *ops)):.4f} ms, SIMT "
                f"{graph_ms(lambda: fb.launch_simt(x, *ops)):.4f} ms, plain "
                f"{graph_ms(lambda: fb.reference_fused_bottleneck(x, *ops)):.4f} ms, unfused cuDNN "
                f"chain {graph_ms(chain):.4f} ms, bound "
                + ", ".join(f"{chip_smoke.bound_ms(nbytes, ops_)[0]:.4f} ms {label} "
                            f"({chip_smoke.bound_ms(nbytes, ops_)[1]})"
                            for label, ops_ in bounds.items()))
        print("; ".join(line), flush=True)
    if args.attention:
        attention_times()
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every shape agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
