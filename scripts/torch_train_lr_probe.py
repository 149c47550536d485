#!/usr/bin/env python3
"""How far the PyTorch port's training step moves the random-weight
backbone at a given learning rate, on one CUDA card.

  python3 scripts/torch_train_lr_probe.py [--lrs 1e-3:1e-3 1e-5:1e-4] [--reps 3]

For each ``backbone_lr:transformers_lr`` pair it builds the seeded
full-width DETR-R50 of ``chip_smoke.py``'s training phase, takes 1 + 8
dropout-0.1 steps through ``Trainer.step`` on that phase's b8 376x672 batch
(fp32, TF32 off), then runs the forward and the loss once more as the phase
does. It prints one line per repetition: each step's loss and the largest
|c5| (the backbone's output) of its forward, and the last forward's c5 and
loss. The model's FrozenBN does not normalise, so a large step on the
backbone's weights scales c5 directly; the repetitions differ only by the
card's nondeterministic reductions.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lrs", nargs="+", default=["1e-3:1e-3", "1e-5:1e-4"])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_lr_probe: needs a CUDA card")
    import chip_smoke as smoke
    from detr_tensorflow_tpu_torch import train
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.ops import losses
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    targets = ("boxes", "classes", "mask")
    batch = batch_to_device(smoke.train_batch(6), "cuda")
    for pair in args.lrs:
        backbone_lr, transformers_lr = (float(v) for v in pair.split(":"))
        for rep in range(args.reps):
            config = train.TrainingConfig(
                background_class=smoke.BACKGROUND, train_backbone=True, train_transformers=True,
                batch_size=smoke.TRAIN_BATCH, backbone_lr=backbone_lr,
                transformers_lr=transformers_lr)
            model = api.build_detr(seed=0, device="cuda").module
            c5 = []
            model.backbone.register_forward_hook(
                lambda module, inputs, out: c5.append(out.detach().abs().amax()))
            trainer = train.Trainer(model, config, seed=0)
            steps = [float(trainer.step(batch)["total_loss"]) for _ in range(1 + smoke.TRAIN_STEPS)]
            with torch.no_grad():
                out = model(batch["images"], train=True, generator=trainer.generator)
                total, _ = losses.detr_loss(out, *(batch[k] for k in targets), smoke.BACKGROUND)
            c5 = [float(v) for v in c5]
            print(f"lr {backbone_lr:g}/{transformers_lr:g} rep {rep}: losses "
                  f"{[round(v, 4) for v in steps]}; max |c5| per step "
                  f"{[f'{v:.3e}' for v in c5[:-1]]}; last forward max |c5| {c5[-1]:.3e}, loss "
                  f"{float(total):.4f}, finite {math.isfinite(float(total))}", flush=True)
            del model, trainer, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
