#!/usr/bin/env python3
"""The attention forward (kernel A) on one NVIDIA GPU, against float64.

  python3 scripts/torch_attention_fwd_probe.py [--bf16-only] [--variants] [--root DIR]

fp32: at DETR's served encoder shape ((1232, 1232), B=2, masked) and its
training shapes (b8, dropout 0.1: (252, 252), (100, 252) masked, (100,
100)), 8 heads, Dh 32, it prints for the tensor-core kernel (3xTF32), the
SIMT kernel and the plain fp32 version the largest error of the output and
of the row lse against a float64 plain version on the same inputs and keep
mask, relative to the largest float64 value (the lse: absolute). Then the
device time of one call of the tensor-core kernel at each CTA shape and of
the SIMT kernel, from ``torch.profiler`` over 20 calls.

bf16, the bf16 training step's call: at the three training shapes with
dropout 0.1, the same errors for A-mma (``csrc/flash_attention_fwd_mma.cu``)
at each CTA shape, the SIMT kernel and the plain bf16 version, against
float64 on the same bf16 values and keep mask; then CUDA-graph times, in two
turns, of A-mma at each CTA shape with dropout 0.1 and without it (what the
draws cost), the SIMT kernel, the plain version and PyTorch's
scaled_dot_product_attention with ``dropout_p`` (another mask), beside the
bound. ``--variants`` also builds variants of A-mma's source (``VARIANTS``,
text edits that must each occur once: every design choice tried and
dropped) and prints their errors, how many outputs differ from the built
kernel's, and their times in the same turns. ``--root DIR`` builds DIR's
A-mma (a ``git archive`` of another commit) and times it without dropout at
the served shapes (B=2 (1232, 1232), (100, 1232), (320, 320), and b1
(1232, 1232), (100, 1232), (100, 100)) in turns with this checkout's, at
the CTA shape ``cta_shape`` picks, and this checkout's at each CTA shape.
Needs a card; fp32 matmuls run without TF32.
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

# (batch, Lq, Lk, masked, dropout rate)
SHAPES = [(2, 1232, 1232, True, 0.0), (8, 252, 252, False, 0.1), (8, 100, 252, True, 0.1),
          (8, 100, 100, False, 0.1)]
TRAIN_SHAPES = SHAPES[1:]
# (batch, Lq, Lk, masked): the served calls of A-mma, without dropout.
SERVED_SHAPES = [(2, 1232, 1232, True), (2, 100, 1232, True), (2, 320, 320, True),
                 (1, 1232, 1232, True), (1, 100, 1232, True), (1, 100, 100, False)]
MMA_SOURCE = "flash_attention_fwd_mma.cu"
_DRAW = """      if constexpr (kDropout) {
        // Keys 4 (t / 2) .. + 3 of the block (absolute key indices): this
        // lane's call covers its own row's two keys and its partner's (lane
        // t ^ 1) two.
        const unsigned j0 = static_cast<unsigned>(tile * kTileK + key0 + 8 * n);
        const uint4 r = fa::philox4x32_10(
            make_uint4(j0 / 4 + t / 2, philox_row, static_cast<unsigned>(bh), 0u), philox_key);
        const unsigned x0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
        const unsigned x1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
        const unsigned bits[4] = {odd ? x0 : r.x, odd ? x1 : r.y, odd ? r.z : x0,
                                  odd ? r.w : x1};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= bits[e] >= threshold ? keep_scale : 0.f;
      }
"""
_SOFTMAX = "    // Bias, then the online softmax in fp32.\n"
_WAIT = "    cp_async_wait<kS - 1>();\n"
_BOUNDS = "__launch_bounds__(32 * kRowGroups * kSplit)\n"
# A tile's Philox calls issued apart from its exps, their keep bits held in
# one register (bit 4n + e for element e of column block n).
_EARLY_DRAW = (
    "    unsigned kept = 0u;\n"
    "    if constexpr (kDropout) {\n#pragma unroll\n      for (int n = 0; n < kNT; ++n) {\n"
    + _DRAW.split("      if constexpr (kDropout) {\n")[1].replace(
        "s[n][e] *= bits[e] >= threshold ? keep_scale : 0.f;",
        "kept |= (bits[e] >= threshold ? 1u : 0u) << (4 * n + e);")
    + "    }\n")
_APPLY = ("      if constexpr (kDropout) {\n#pragma unroll\n        for (int e = 0; e < 4; ++e) "
          "s[n][e] *= (kept >> (4 * n + e)) & 1u ? keep_scale : 0.f;\n      }\n")

# Four more warps a CTA that only draw, a tile ahead of the softmax warps, one
# 32-key keep word a thread in turn into shared memory (the design of
# A'-bf16's pre-pass); the softmax warps read their bits from there.
_DW_BOUNDS = "__launch_bounds__(32 * (kRowGroups * kSplit + kDrawWarps<kDropout>))\n"
_DRAW_WARPS = [
    ("constexpr float kLog2e = 1.4426950408889634f;\n",
     "constexpr float kLog2e = 1.4426950408889634f;\n"
     "template <bool kDropout>\nconstexpr int kDrawWarps = kDropout ? 4 : 0;\n"),
    (_BOUNDS, _DW_BOUNDS),
    ("  constexpr int kThreads = 32 * kRowGroups * kSplit;\n",
     "  constexpr int kMath = 32 * kRowGroups * kSplit;\n"
     "  constexpr int kDrawThreads = 32 * kDrawWarps<kDropout>;\n"
     "  constexpr int kThreads = kMath + kDrawThreads;\n"
     "  constexpr int kRows = 16 * kRowGroups;\n"),
    ("  __shared__ float bias_tile[kS][kTileK];\n",
     "  __shared__ float bias_tile[kS][kTileK];\n"
     "  __shared__ __align__(8) unsigned keep_tile[kDropout ? kS : 1][kRows][2];\n"),
    ("  const int n_tiles = (lk + kTileK - 1) / kTileK;\n",
     "  const int n_tiles = (lk + kTileK - 1) / kTileK;\n"
     "  const bool math = kDrawThreads == 0 || tid < kMath;\n"),
    ("  fetch_mask(1);\n", """  fetch_mask(1);
  const uint2 philox_key = kDropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  auto draw_keep = [&](int tile, int stage, int idx, int count) {
    for (int w = idx; w < 2 * kRows; w += count) {
      const unsigned row = static_cast<unsigned>(blockIdx.x * kRows + w / 2);
      const unsigned c0 = static_cast<unsigned>(tile * kTileK / 4 + (w % 2) * 8);
      unsigned word = 0u;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 r = fa::philox4x32_10(make_uint4(c0 + c, row, static_cast<unsigned>(bh), 0u),
                                          philox_key);
        word |= ((r.x >= threshold ? 1u : 0u) | (r.y >= threshold ? 2u : 0u) |
                 (r.z >= threshold ? 4u : 0u) | (r.w >= threshold ? 8u : 0u))
                << (4 * c);
      }
      keep_tile[stage][w / 2][w % 2] = word;
    }
  };
  if constexpr (kDrawThreads > 0) {
    if (!math) draw_keep(0, 0, tid - kMath, kDrawThreads);
  }
"""),
    ("  unsigned qf[kSteps][4];\n  {\n", "  unsigned qf[kSteps][4];\n  if (math) {\n"),
    ("  const uint2 philox_key = kDropout ? fa::seed_key(seed) : make_uint2(0u, 0u);\n"
     "  const bool odd", "  const bool odd"),
    (_WAIT + "    __syncthreads();\n", _WAIT + """    __syncthreads();
    if constexpr (kDrawThreads > 0) {
      if (!math) {
        if (tile + 1 < n_tiles) draw_keep(tile + 1, (tile + 1) % kS, tid - kMath, kDrawThreads);
        __syncthreads();
        continue;
      }
    }
"""),
    ("    const float* bias = bias_tile[stage] + key0;\n",
     """    const float* bias = bias_tile[stage] + key0;
    uint2 keep0, keep1;
    if constexpr (kDropout) {
      keep0 = *reinterpret_cast<const uint2*>(keep_tile[stage][group * 16 + g]);
      keep1 = *reinterpret_cast<const uint2*>(keep_tile[stage][group * 16 + g + 8]);
    }
"""),
    (_DRAW, """      if constexpr (kDropout) {
        const int key = key0 + 8 * n + 2 * t;
        const unsigned w0 = key < 32 ? keep0.x : keep0.y, w1 = key < 32 ? keep1.x : keep1.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned bit = ((e < 2 ? w0 : w1) >> (key % 32 + e % 2)) & 1u;
          s[n][e] *= bit != 0u ? keep_scale : 0.f;
        }
      }
"""),
    ("  // The four lanes of a row hold disjoint columns: sum their shares.\n",
     """  if constexpr (kDrawThreads > 0) {
    if (!math) {
      if constexpr (kSplit > 1) __syncthreads();
      return;
    }
  }
  // The four lanes of a row hold disjoint columns: sum their shares.
"""),
    ("<<<grid, 32 * kRowGroups * kSplit, 0, a.stream>>>",
     "<<<grid, 32 * (kRowGroups * kSplit + kDrawWarps<kDropout>), 0, a.stream>>>"),
]

# (name, [(text in csrc/flash_attention_fwd_mma.cu, replacement)]): every
# design choice tried and dropped, so that --variants measures each again.
VARIANTS = [
    ("built", []),
    # Each tile's draws after its S products, before its max and exps.
    ("draws before the softmax", [(_SOFTMAX, _EARLY_DRAW + _SOFTMAX), (_DRAW, _APPLY)]),
    # Each tile's draws before the wait for its K/V tile: they need no operand.
    ("draws before the tile's wait", [(_WAIT, _EARLY_DRAW + _WAIT), (_DRAW, _APPLY)]),
    # The dropout instantiations capped at 128 registers: 4 CTAs an SM at (4, 1).
    ("dropout at 4 CTAs an SM", [(_BOUNDS, _BOUNDS.replace(")\n", ", kDropout ? 4 : 1)\n"))]),
    ("draw warps, a tile ahead", _DRAW_WARPS),
    ("draw warps, capped at 2 CTAs an SM",
     _DRAW_WARPS + [(_DW_BOUNDS, _DW_BOUNDS.replace("))\n", "), kDropout ? 2 : 1)\n"))]),
    # The draw warps' words, drawn by the softmax warps at the start of each tile.
    ("keep words drawn by the softmax warps",
     _DRAW_WARPS + [
         ("constexpr int kDrawWarps = kDropout ? 4 : 0;", "constexpr int kDrawWarps = 0;"),
         (_WAIT, "    if constexpr (kDropout) draw_keep(tile, stage, tid, kThreads);\n" + _WAIT)]),
]


def inputs(b, lq, lk, masked, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    h, dh = 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v = rng.normal(size=(2, b, lk, h, dh))
    to = lambda x: torch.from_numpy(x).to("cuda", dtype)  # noqa: E731
    mask = None
    if masked:
        valid = rng.integers(lk // 3, lk + 1, size=b)
        mask = torch.from_numpy(np.arange(lk)[None, :] >= valid[:, None]).cuda()
    return to(q), to(k), to(v), mask


def plain(q, k, v, mask, keep, rate, dtype):
    """Output and row lse of the plain version in ``dtype``."""
    q, k, v = (t.to(dtype) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() if dtype == torch.bfloat16 else q,
                          k.float() if dtype == torch.bfloat16 else k)
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


def error_line(out, lse, ref, ref_lse):
    valid = ref_lse > -1e29
    err = float((out.double() - ref).abs().max() / ref.abs().max())
    lse_err = float((lse.double() - ref_lse)[valid].abs().max())
    return f"output rel err against float64 {err:.3e}, lse abs err {lse_err:.3e}"


def fp32_section():
    for b, lq, lk, masked, rate in SHAPES:
        q, k, v, mask = inputs(b, lq, lk, masked, lq + lk + b)
        seed = torch.tensor([lq * 17 + lk], device="cuda")
        keep = (fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk)
                if rate else None)
        ref, ref_lse = plain(q, k, v, mask, keep, rate, torch.float64)
        rows = {"tensor-core": fa.launch_forward_tf32(q, k, v, mask, seed, rate, True),
                "simt": fa.launch_forward_simt(q, k, v, mask, seed, rate, True),
                "plain fp32": plain(q, k, v, mask, keep, rate, torch.float32)}
        tag = f"({lq},{lk}) b{b}{' masked' if masked else ''} dropout {rate}"
        for name, (out, lse) in rows.items():
            print(f"{tag} {name}: {error_line(out, lse, ref, ref_lse)}", flush=True)
        times = {str(shape): device_ms(lambda: fa.launch_forward_tf32(
            q, k, v, mask, seed, rate, True, shape=shape), "fwd_tf32") for shape in fa.MMA_SHAPES}
        times["simt"] = device_ms(lambda: fa.launch_forward_simt(q, k, v, mask, seed, rate, True),
                                  "flash_attention_fwd_kernel")
        print(f"{tag} device ms a call (torch.profiler): "
              + ", ".join(f"{n} {t:.4f}" for n, t in times.items()), flush=True)


def entry(handle, new_signature=True):
    """The flash_attention_fwd_mma entry point of a library with its argtypes:
    the signature with dropout arguments, or the one before them."""
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = handle.flash_attention_fwd_mma
    fn.argtypes = ([vp] * 5 + [u, f, vp, vp] if new_signature else [vp] * 6) + [i] * 7 + [vp]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, mask, seed, rate, shape, new_signature=True):
    """(out, lse) of one call of an A-mma entry point."""
    b, lq, h, dh = q.shape
    threshold = fa.dropout_threshold(rate)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, lq), device="cuda", dtype=torch.float32)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr()]
    if new_signature:
        ptrs += [seed.data_ptr() if threshold else None, threshold,
                 1.0 / (1.0 - rate) if threshold else 1.0]
    err = fn(*ptrs, out.data_ptr(), lse.data_ptr(), b, lq, k.shape[1], h, dh, *shape,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"A-mma launch failed: cudaError {err}")
    return out, lse


def build_variants():
    """{variant name: its entry point}, one nvcc a source, all at once;
    prints each build's ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor

    base = (nvcc_build.CSRC_DIR / MMA_SOURCE).read_text()
    sources = {name: edited(base, edits, name, once=True) for name, edits in VARIANTS}

    def build(src):
        handle, log = build_text(nvcc_build, src, "flash_attention_fwd_mma_variant")
        if log:
            names = [n for n, other in sources.items() if other == src]
            print(f"variants {names}: {registers(log)}", flush=True)
        return entry(handle)

    unique = list(dict.fromkeys(sources.values()))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(build, unique)))
    return {name: built[src] for name, src in sources.items()}


def in_turns(fns):
    """{name: (mean, (first, second))} of CUDA-graph ms a call, each of
    ``fns`` timed in order and then in reverse order."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(chip_smoke.graph_ms(torch, fns[n]))
    return {n: (sum(r) / 2, tuple(r)) for n, r in runs.items()}


def bf16_section(variants):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, lq, lk, masked, rate in TRAIN_SHAPES:
        q, k, v, mask = inputs(b, lq, lk, masked, lq + lk + b, torch.bfloat16)
        seed = torch.tensor([lq * 17 + lk], device="cuda")
        keep = fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk)
        ref, ref_lse = plain(q, k, v, mask, keep, rate, torch.float64)
        mma = {shape: (lambda s=shape, r=rate: fa.launch_forward_mma(
            q, k, v, mask, True, dropout_seed=seed, dropout_rate=r, shape=s))
            for shape in fa.MMA_SHAPES}
        rows = {f"A-mma {shape}": fn() for shape, fn in mma.items()}
        rows["simt"] = fa.launch_forward_simt(q, k, v, mask, seed, rate, True)
        rows["plain bf16"] = plain(q, k, v, mask, keep, rate, torch.bfloat16)
        tag = f"({lq},{lk}) b{b}{' masked' if masked else ''} bf16 dropout {rate}"
        for name, (out, lse) in rows.items():
            print(f"{tag} {name}: {error_line(out, lse, ref, ref_lse)}", flush=True)
        fns = {f"A-mma {shape}": fn for shape, fn in mma.items()}
        fns.update({f"A-mma {shape} dropout 0": (lambda s=shape: fa.launch_forward_mma(
            q, k, v, mask, True, shape=s)) for shape in fa.MMA_SHAPES})
        for name, fn in variants.items():
            if name == "built":
                continue
            for shape in fa.MMA_SHAPES:
                out, lse = call(fn, q, k, v, mask, seed, rate, shape)
                built = rows[f"A-mma {shape}"][0]
                print(f"{tag} variant {name} {shape}: {error_line(out, lse, ref, ref_lse)}; "
                      f"{int((out != built).sum())} of {out.numel()} outputs differ from the "
                      "built kernel's", flush=True)
                fns[f"{name} {shape}"] = (lambda f=fn, s=shape: call(
                    f, q, k, v, mask, seed, rate, s))
        fns["simt"] = lambda: fa.launch_forward_simt(q, k, v, mask, seed, rate, True)
        fns["plain"] = lambda: fa.reference_mha(q, k, v, mask, keep, rate)
        fns["sdpa dropout_p"] = lambda: chip_smoke.sdpa(torch, q, k, v, mask, rate)
        turns = in_turns(fns)
        bound = chip_smoke.attention_bound(b, lq, lk, "bfloat16", masked, lse=True)
        print(f"{tag} CUDA-graph ms a call (two turns; cta_shape picks "
              f"{fa.cta_shape(b * 8, lq, sms)}): "
              + ", ".join(f"{n} {t:.4f} ({r[0]:.4f}, {r[1]:.4f})" for n, (t, r) in turns.items())
              + f"; bound {bound[0]:.4f} ({bound[1]})", flush=True)


def served_section(root: Path):
    """This checkout's A-mma against ``root``'s at the served shapes."""
    text = (root / "detr_tensorflow_tpu_torch" / "csrc" / MMA_SOURCE).read_text()
    include = root / "detr_tensorflow_tpu_torch" / "csrc"
    new_signature = "float keep_scale, void* out" in text
    other = entry(build_text(nvcc_build, text, "flash_attention_fwd_mma_root", include)[0],
                  new_signature)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, lq, lk, masked in SERVED_SHAPES:
        q, k, v, mask = inputs(b, lq, lk, masked, lq * 3 + lk, torch.bfloat16)
        shape = fa.cta_shape(b * 8, lq, sms)
        ours = fa.launch_forward_mma(q, k, v, mask, True, shape=shape)
        theirs = call(other, q, k, v, mask, None, 0.0, shape, new_signature)
        same = all(torch.equal(x, y) for x, y in zip(ours, theirs))
        fns = {"root": lambda: call(other, q, k, v, mask, None, 0.0, shape, new_signature),
               "this": lambda: fa.launch_forward_mma(q, k, v, mask, True, shape=shape)}
        fns.update({f"this {s_}": (lambda s_=s_: fa.launch_forward_mma(
            q, k, v, mask, True, shape=s_)) for s_ in fa.MMA_SHAPES})
        turns = in_turns(fns)
        print(f"served ({lq},{lk}) B={b}{' masked' if masked else ''} bf16, no dropout, CTA shape "
              f"{shape}, outputs and lse bit-equal to {root}'s: {same}; CUDA-graph ms a call "
              "(two turns): " + ", ".join(f"{n} {t:.4f} ({r[0]:.4f}, {r[1]:.4f})"
                                         for n, (t, r) in turns.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bf16-only", action="store_true", help="leave out the fp32 kernels")
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the variants of A-mma's source")
    parser.add_argument("--root", type=Path, default=None,
                        help="a checkout whose A-mma is timed beside this one's when served")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)
    if not opts.bf16_only:
        fp32_section()
    bf16_section(build_variants() if opts.variants else {})
    if opts.root is not None:
        served_section(opts.root.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
