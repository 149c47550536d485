#!/usr/bin/env python3
"""Where the port's bf16 model parts from the JAX package's bf16 model, on
the CPU (a diagnosis; imports both packages, as the tests do).

  JAX_PLATFORMS=cpu python scripts/torch_bf16_gradient_probe.py [--seeds 1 2 ...]

The model is the tiny DETR of tests/test_torch_training.py (TINY, dropout
0) on seeded float32 variables; each batch is that file's ``make_batch``.
Three runs share the variables and the batch: the JAX package in float64
(the reference), the JAX package at bf16 compute and the port at bf16
compute, both from float32 parameters. For each batch seed it prints

  * the forward: every module's output in forward order, as its relative
    L2 distance from float64 for the port and for JAX bf16, and the first
    module where the port's distance exceeds JAX's by ``--factor``;
  * the backward: every parameter's gradient (before the clip) the same
    way, in backward order (heads first), and the first tensor past the
    factor;
  * the median over gradient tensors of both distances and their ratio;
  * the Hungarian matching each run's outputs give (the port's exact LAP
    on each run's boxes and logits): how many (layer, image, target)
    assignments differ from float64's, for the port and for JAX bf16, and
    the port's median again with float64's matching imposed (``match=``),
    which takes the matching's flips out of the comparison.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from detr_tensorflow_tpu.models import DETR as JaxDETR  # noqa: E402
from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss  # noqa: E402
from detr_tensorflow_tpu_torch.models.detr import DETR  # noqa: E402
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables  # noqa: E402
from detr_tensorflow_tpu_torch.ops.losses import detr_loss, match_all_layers  # noqa: E402
from test_torch_training import TINY, make_batch, random_variables  # noqa: E402

# A gradient below this fraction of the largest is exactly zero in float64
# (every k_proj bias): both bf16 runs give noise there, left out.
NOISE_FLOOR = 1e-5


def rel(x, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref) / max(np.linalg.norm(ref), 1e-30))


def jax_run(dtype, variables, batch):
    """Per-module outputs (by dotted path) and per-parameter gradients (the
    port's names and layouts) of the JAX model at ``dtype``."""
    model = JaxDETR(dropout=0.0, attn_impl="xla", dtype=dtype, **TINY)

    def loss_fn(params):
        out, state = model.apply({"params": params, "frozen": variables["frozen"]},
                                 batch["images"], train=True, capture_intermediates=True,
                                 mutable=["intermediates"])
        total, _ = jax_detr_loss(out, batch["boxes"], batch["classes"], batch["mask"], 0)
        return total, (state["intermediates"], out)

    (total, (inter, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    outputs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(inter))[0]:
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] != "__call__" or len(keys) < 2:
            continue
        name = ".".join(keys[:-1])
        if name not in outputs:  # a module's first output
            outputs[name] = np.asarray(leaf, np.float64)
    grads = {k: v.numpy().astype(np.float64)
             for k, v in from_jax_variables({"params": jax.device_get(grads)}).items()}
    return float(total), outputs, grads, jax.device_get(out)


def matching(out, batch):
    """The pred_of_target of every layer of ``out`` (numpy or tensors), by
    the port's plain LAP in float64."""
    t = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in out.items()
         if k in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes")}
    b = {k: torch.from_numpy(np.asarray(batch[k])) for k in ("boxes", "classes", "mask")}
    return match_all_layers(t, b["boxes"].double(), b["classes"], b["mask"], lap_impl="plain")


def port_run(variables, batch, match=None):
    model = DETR(dropout=0.0, dtype=torch.bfloat16, **TINY)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    outputs, order = {}, []

    def hook(name):
        def fn(module, args, out):
            if isinstance(out, tuple):
                out = out[0]
            if isinstance(out, torch.Tensor) and name not in outputs:
                x = out.detach().float()
                if x.dim() == 4 and name.startswith("backbone"):
                    x = x.permute(0, 2, 3, 1)  # NCHW -> the JAX package's NHWC
                outputs[name] = x.numpy().astype(np.float64)
                order.append(name)
        return fn

    for name, module in model.named_modules():
        if name:
            module.register_forward_hook(hook(name))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = model(t["images"], train=True)
    total, _ = detr_loss(out, t["boxes"], t["classes"], t["mask"], 0, match=match)
    total.backward()
    grads = {n: p.grad.numpy().astype(np.float64) for n, p in model.named_parameters()}
    return float(total.detach()), outputs, order, grads, {k: v.detach() for k, v in out.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    p.add_argument("--factor", type=float, default=1.5)
    p.add_argument("--all", action="store_true", help="print every module and tensor")
    args = p.parse_args(argv)
    variables = random_variables(JaxDETR(dropout=0.0, attn_impl="xla", **TINY),
                                 jnp.zeros((1, 64, 64, 3)))
    as64 = lambda a: jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)  # noqa: E731
    for seed in args.seeds:
        batch = make_batch(seed)
        with jax.enable_x64(True):
            l64, o64, g64, out64 = jax_run(jnp.float64, jax.tree.map(lambda a: as64(np.asarray(a)),
                                                              variables),
                                    {k: as64(v) for k, v in batch.items()})
        l16, o16, g16, out16 = jax_run(jnp.bfloat16, variables,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        lp, op, order, gp, outp = port_run(variables, batch)
        print(f"batch seed {seed}: loss float64 {l64:.6f}, JAX bf16 {l16:.6f}, port bf16 {lp:.6f}")
        first = None
        print("  forward, module outputs (relative distance from float64): port / JAX bf16")
        for name in order:
            if name not in o64 or o64[name].shape != op[name].shape:
                continue
            e_p, e_j = rel(op[name], o64[name]), rel(o16[name], o64[name])
            flag = e_p > args.factor * e_j and first is None
            if flag:
                first = name
            if args.all or flag or "." not in name or name.count(".") == 1:
                print(f"    {name}: {e_p:.3e} / {e_j:.3e} ({e_p / max(e_j, 1e-30):.2f}x)"
                      + ("  <- first past the factor" if flag else ""))
        print(f"  first module whose output the port rounds {args.factor}x further: {first}")
        scale = max(np.linalg.norm(v) for v in g64.values())
        names = [n for n in reversed(list(gp)) if np.linalg.norm(g64[n]) > NOISE_FLOOR * scale]
        ratios, first = [], None
        print("  backward, gradients before the clip (heads first): port / JAX bf16")
        for name in names:
            e_p, e_j = rel(gp[name], g64[name]), rel(g16[name], g64[name])
            ratios.append((e_p, e_j))
            flag = e_p > args.factor * e_j and first is None
            if flag:
                first = name
            if args.all or flag:
                print(f"    {name}: {e_p:.3e} / {e_j:.3e} ({e_p / max(e_j, 1e-30):.2f}x)"
                      + ("  <- first past the factor" if flag else ""))
        med_p, med_j = np.median(np.array(ratios), axis=0)
        print(f"  first gradient past the factor: {first}; median over {len(names)} tensors "
              f"port {med_p:.4f}, JAX bf16 {med_j:.4f} ({med_p / med_j:.2f}x)")
        m64 = matching(out64, batch)
        real = torch.from_numpy(np.asarray(batch["mask"]))[None].expand_as(m64["pred_of_target"])
        flips = {label: int(((matching(o, batch)["pred_of_target"] != m64["pred_of_target"])
                             & real).sum()) for label, o in (("port", outp), ("JAX bf16", out16))}
        _, _, _, gm, _ = port_run(variables, batch, match=m64)
        med_m = np.median([rel(gm[n], g64[n]) for n in names])
        print(f"  matching: assignments differing from float64's, of {int(real.sum())}: {flips}; "
              f"the port's median with float64's matching {med_m:.4f} ({med_m / med_j:.2f}x JAX "
              f"bf16's)")


if __name__ == "__main__":
    main()
