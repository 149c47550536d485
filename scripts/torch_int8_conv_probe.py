#!/usr/bin/env python3
"""Kernel G (``csrc/int8_conv.cu``, the int8 3x3 convolution with
requantization) on one NVIDIA GPU, shape by shape.

  python3 scripts/torch_int8_conv_probe.py [--root DIR] [--no-time] [--variants]

Builds G from the package under ``--root`` (default: this checkout; give a
``git archive`` of another commit to time that commit's G on the same
card) and prints nvcc's ptxas report (registers, spills) of each compiled
configuration. Then, at the 7 G shapes of one b1 896x1408 int8 DETR-R50
forward and at ragged shapes, holds the kernel against the plain version
(int8 integer-equal, bf16 equal, both epilogues) and, unless ``--no-time``,
prints the plan (patch, channels, cluster, CTAs) where the package has one,
the bytes its tiles move between L2 and the SMs (input windows, W slices,
the output) against the bytes that must move, and the device time of one
call from CUDA graphs of G, of the plain version and of the bf16 cuDNN
convolution on the same shapes (the float path G stands in for, not the
same function), beside the bound; with their sums over a forward. With
``--variants``, G as built beside variants of its plan (other patches,
no split, wider splits) and of its source (``VARIANTS``: the depth of the
W ring), each checked against the plain version, and ablations that drop
the products, the epilogue's arithmetic or the stores (timed only), all at
the 7 path shapes in turns, with their sums a forward: the measurements
behind the configuration G compiles and what its time goes to. Needs a
card; exits non-zero if a shape disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch
from torch_probe_common import build_text, edited

REPO = Path(__file__).resolve().parent.parent
# chip_smoke.py of this checkout: its timing, bound, operands and shapes.
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# Ragged shapes (N, H, W, C, K, stride): batch 2, odd H and W at both
# strides, partial channel tiles (K = 48, 8, 72, 136), and small maps whose
# few tiles split C across clusters of 2, 4 and 8.
RAGGED = [(2, 13, 20, 64, 48, 1), (2, 13, 21, 64, 48, 2), (2, 15, 33, 128, 48, 2),
          (1, 9, 17, 64, 8, 2), (2, 11, 19, 128, 8, 1), (1, 17, 35, 256, 72, 2),
          (1, 7, 12, 512, 64, 1), (3, 29, 45, 256, 136, 1)]

# G's variants of its source: (name, [(text in csrc/int8_conv.cu, replacement)]).
_RING = "constexpr int BN = 64, WM = 4, WN = 2, KC = 64, WS = 3,"
_SRC_PRODUCTS = ("products<G>(acc, xring + (i & 1) * G::kWindow, wring + (j % WS) * G::kSlice, "
                 "a_sr, a_hi,")
_SRC_EPILOGUE = ("make_char2(i8::to_int8<kRelu, kPrecise>(y0), i8::to_int8<kRelu, kPrecise>(y1));")
_SRC_STORE = ("*reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(staged + r * ldo "
              "+ cb);")
_SRC_EXPECT = "mbar_expect_tx(bar, G::kSlice + (dy == 0 ? G::kWindowTx : 0));"
_SRC_WINDOW = "if (dy == 0) {"
_SRC_SLICE = "tma_load(wring + (j % WS) * G::kSlice, &wmap, kb, 3 * dy, col0, bar);"
_WAIT_FULL = "mbar_wait(full + j % WS, (j / WS) & 1);"
_LOOP_END = "  __syncthreads();  // every warp is done with the ring, and every copy has landed\n"
_PROLOGUE = "for (int j = 0; j < WS - 1 && j < steps; ++j) issue(j);"
_LOOP = "for (int j = 0; j < steps; ++j) {"
_S1 = "using S1 = Cfg<1, 8, 16, 3>;"
_S2 = "using S2 = Cfg<2, 8, 16, 2>;"
_START = "  extern __shared__ __align__(kAlign) unsigned char smem[];\n"
_NO_PRODUCTS = (_SRC_PRODUCTS, "if (a_hi > 7) " + _SRC_PRODUCTS)
_NO_LOADS = [(_SRC_EXPECT, "mbar_arrive(bar);"), (_SRC_WINDOW, "if (dy < 0) {"),
             (_SRC_SLICE, "if (dy < 0) " + _SRC_SLICE)]
# (name, [(text in csrc/int8_conv.cu, replacement)], the plan's TILES or
# None, its FILL or None).
VARIANTS = [
    ("built", [], None, None),
    ("W ring of 2", [(_RING, _RING.replace("WS = 3", "WS = 2"))], None, None),
    ("stride 1 at 2 CTAs an SM", [(_S1, _S1.replace("3>", "2>"))], None, None),
    ("stride 1 on 16x16 patches", [(_S1, "using S1 = Cfg<1, 16, 16, 2>;")],
     {1: (16, 16), 2: (8, 16)}, None),
    ("no split", [], None, {1: 0, 2: 0}),
    ("splits below 132 tiles", [], None, {1: 132, 2: 132}),
    ("splits below 264 tiles", [], None, {1: 264, 2: 264}),
    # Ablations, timed but not checked: what each part of the kernel costs.
    ("ablate: no products", [_NO_PRODUCTS], None, None),
    ("ablate: no epilogue arithmetic", [(_SRC_EPILOGUE, "make_char2(acc[mt][nt][2 * hh], "
                                         "acc[mt][nt][2 * hh + 1]);")], None, None),
    ("ablate: no stores", [(_SRC_STORE, "(void)dst;")], None, None),
    ("ablate: no window or W loads", _NO_LOADS, None, None),
    ("ablate: no products, no loads", [_NO_PRODUCTS] + _NO_LOADS, None, None),
    ("ablate: return at once", [(_START, _START + "  if (c > 0) return;\n")], None, None),
    ("one lane a warp waits on a step", [(_WAIT_FULL, "if (lane == 0) " + _WAIT_FULL)], None,
     None),
    ("ablate: no epilogue", [(_LOOP_END, _LOOP_END + "  if (c > 0) return;\n")], None, None),
    ("ablate: no steps", [(_PROLOGUE, _PROLOGUE.replace("j < steps", "j < 0 * steps")),
                          (_LOOP, _LOOP.replace("j < steps", "j < 0 * steps"))], None, None),
]


def build_variant(nvcc_build, src):
    """The int8_conv3x3 entry point of a variant source (one build a distinct
    source), with the ptxas register lines of its configurations."""
    handle, log = build_text(nvcc_build, src, "int8_conv_variant")
    if log:
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                       if "Used " in ln})
        print(f"  variant {hashlib.sha256(src.encode()).hexdigest()[:12]}: {regs}", flush=True)
    fn = handle.int8_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    return fn


def time_variants(conv, nvcc_build, operands):
    """The variants at the 7 path shapes, in turns; returns those that
    disagree with the plain version."""
    from concurrent.futures import ThreadPoolExecutor

    base = (nvcc_build.CSRC_DIR / "int8_conv.cu").read_text()
    sources = [edited(base, edits, name) for name, edits, *_ in VARIANTS]
    unique = list(dict.fromkeys(sources))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(lambda s: build_variant(nvcc_build, s), unique)))
    runs = [(name, built[src], tiles, fill)
            for (name, _, tiles, fill), src in zip(VARIANTS, sources)]
    sums, failed = {}, []
    for (h, w, c, k, st), count, (x, wt, s, b), ref in operands:
        line = f"variants stride {st} {h}x{w} C={c}:"
        for name, fn, tiles, fill in runs:
            saved = conv.TILES, conv.FILL
            conv.TILES = tiles or conv.TILES
            conv.FILL = fill or conv.FILL
            p = conv.plan(1, h, w, c, k, st)
            conv.TILES, conv.FILL = saved

            def call(fn=fn, p=p):
                out = torch.empty(ref.shape, dtype=torch.int8, device="cuda")
                if fn(x.data_ptr(), wt.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), 1,
                      h, w, c, k, st, 1, 0, 1, p.patch_h, p.patch_w, p.cluster,
                      torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"variant {name!r} failed to launch")
                return out

            if not name.startswith("ablate") and not torch.equal(call(), ref):
                failed.append((name, st, h, w, c))
            ms = chip_smoke.graph_ms(torch, call)
            sums[name] = sums.get(name, 0) + count * ms
            line += f" {name} [{p.patch_h}x{p.patch_w}, cluster {p.cluster}] {ms:.4f};"
        print(line, flush=True)
    for name, ms in sums.items():
        print(f"variant {name!r} per forward: {ms:.4f} ms", flush=True)
    return failed


def tile_bytes(conv, n, h, w, c, k, stride):
    """(bytes G's CTAs move between L2 and the SMs, bytes that must move) at
    one shape: each CTA stages its halo'd window for each chunk of its share
    of C and its channels' W slices (rows past K are zero-filled, not read),
    and writes its output pixels; the must-move bytes read x and W once and
    write y once."""
    p = conv.plan(n, h, w, c, k, stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    window = ((p.patch_h - 1) * stride + 3) * ((p.patch_w - 1) * stride + 3)  # pixels
    patches = n * -(-ho // p.patch_h) * -(-wo // p.patch_w)
    moved = patches * (-(-k // p.channels) * window * c + 9 * c * k) + n * ho * wo * k
    return moved, n * h * w * c + 9 * c * k + n * ho * wo * k


def g_bound_ms(n, h, w, c, k, stride):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return chip_smoke.bound_ms(n * h * w * c + 9 * c * k + 8 * k + n * ho * wo * k,
                               {"int8": 2 * n * ho * wo * 9 * c * k,
                                "float32": 2 * n * ho * wo * k})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=REPO,
                        help="the checkout whose detr_tensorflow_tpu_torch to build and time")
    parser.add_argument("--no-time", action="store_true", help="check every shape, time none")
    parser.add_argument("--variants", action="store_true",
                        help="then time G beside variants of its plan and source")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    sys.path.insert(0, str(args.root.resolve()))
    from detr_tensorflow_tpu_torch.ops import int8_conv as conv
    from detr_tensorflow_tpu_torch.ops import nvcc_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; G from "
          f"{Path(conv.__file__).resolve()}", flush=True)
    build = nvcc_build.build("int8_conv.cu")
    print(f"G: nvcc {build.seconds:.1f} s", flush=True)
    name = ""
    for line in build.log.splitlines():
        if "Compiling entry" in line:
            name = chip_smoke.template_args(line)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}")

    act, wts, scale, bias = chip_smoke.int8_operands(torch, seed=17)
    _, g_shapes = chip_smoke.int8_path_shapes(*chip_smoke.INT8_BUCKET)
    shapes = [((1, h, w, c, k, st), count) for (h, w, c, k, st), count in sorted(g_shapes.items())]
    shapes += [(key, 0) for key in RAGGED]
    failed, path_operands = [], []
    total = torch.zeros(6, dtype=torch.float64)
    for (n, h, w, c, k, st), count in shapes:
        x, wt, s, b = act(n, h, w, c), wts(k, 3, 3, c), scale(k, 9 * c), bias(k)
        kernel = lambda **kw: conv.conv3x3_int8(x, wt, s, b, stride=st, relu=True, **kw)  # noqa: E731
        plain = lambda **kw: conv.reference_conv3x3_int8(  # noqa: E731
            x, wt, s, b, stride=st, relu=True, **kw)
        tag = f"stride {st} {n}x{h}x{w} C={c} K={k}"
        try:
            chip_smoke.check_int8(torch, tag, kernel, plain)
        except AssertionError as err:
            failed.append(f"{tag}: {err}")
            continue
        line = f"{tag}{f' (x{count})' if count else ' (ragged)'}: equal to plain"
        if count and args.variants:
            path_operands.append(((h, w, c, k, st), count, (x, wt, s, b), plain(precise=True)))
        if hasattr(conv, "plan"):
            p = conv.plan(n, h, w, c, k, st)
            line += f"; plan {p.patch_h}x{p.patch_w} x {p.channels}, cluster {p.cluster}, {p.ctas} CTAs"
        if not args.no_time and count:
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels-last NCHW
            wb = wt.permute(0, 3, 1, 2).to(torch.bfloat16)
            ms = chip_smoke.graph_ms(torch, kernel)
            plain_ms = chip_smoke.graph_ms(torch, plain)
            lib_ms = chip_smoke.graph_ms(
                torch, lambda: torch.nn.functional.conv2d(xb, wb, stride=st, padding=1))
            bound, by = g_bound_ms(n, h, w, c, k, st)
            moved, must = tile_bytes(conv, n, h, w, c, k, st) if hasattr(conv, "plan") else (0, 0)
            total += count * torch.tensor([ms, plain_ms, lib_ms, bound, moved, must],
                                          dtype=torch.float64)
            line += (f"; G {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 cuDNN conv {lib_ms:.4f} ms, "
                     f"bound {bound:.4f} ms ({by}, {bound / ms:.1%} of it)")
            if moved:
                line += (f"; tiles move {moved / 1e6:.2f} MB ({moved / must:.2f}x the "
                         f"{must / 1e6:.2f} MB that must), {moved / ms / 1e9:.2f} TB/s")
        print(line, flush=True)
    if not args.no_time:
        print(f"per b1 896x1408 int8 forward (16 launches): G {total[0]:.4f} ms, plain "
              f"{total[1]:.4f} ms, bf16 cuDNN conv {total[2]:.4f} ms, bound {total[3]:.4f} ms"
              + (f"; tiles move {total[4] / 1e9:.3f} GB against {total[5] / 1e9:.3f} GB, "
                 f"{total[4] / total[0] / 1e9:.2f} TB/s" if total[4] else ""), flush=True)
    if args.variants:
        failed += [f"variant {v}" for v in time_variants(conv, nvcc_build, path_operands)]
    if failed:
        print("FAILED:\n  " + "\n  ".join(failed))
        return 1
    print("every shape agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
