"""DETR trained through the 1F1B schedule (port of
``detr_tensorflow_tpu/parallel/detr_1f1b.py``).

``pp.pipeline_train_1f1b`` is the generic schedule; ``detr_1f1b_value_and_grad``
decomposes the model the way it needs, as the JAX package does:

* **prefix** on stage 0: backbone, the feature mask, the sine positions,
  ``input_proj`` and the ``query_embed`` broadcast (``DETR.features``), run
  once with gradients; the schedule's input cotangent ``dx`` drives its
  backward;
* **layer slots**: the ``n_enc + n_dec`` transformer layers in one
  sequence split contiguously over the stages
  (``pp.split_layers_into_stages(pad=True)``), identity slots padding the
  last stages' tails, so the last stage, which also scores the loss, gets
  the idle slots. The tree that crosses a stage boundary carries ``src``
  (the encoder sequence, the memory once the encoder is done), ``pos``, the
  key mask when the batch has a pixel mask, ``qpos`` and, from the first
  decoder slot on, ``tgt`` and ``hs``, the stack of every decoder layer's
  output. Unlike the JAX package's SPMD slots, which each carry an encoder
  and a decoder parameter tree (zeros where unused, ~2.4x the weights), a
  rank holds and runs only the layers of its own slots; ``pos`` carries no
  gradient (no parameter made it), so its cotangent never crosses;
* **suffix as the pipelined loss** on the last stage: ``decoder_norm`` over
  the whole ``hs`` stack (elementwise over D: equal to the sequential
  per-layer norm), the heads and ``detr_loss`` per microbatch, with the
  batch-global normalizers (over the data group too) computed first, so the
  microbatches' losses sum to the whole batch's.

Dropout trains through the schedule: one seed per (microbatch, slot), drawn
from the caller's generator alike on every rank, seeds the generator of
that slot's run, forward and recompute alike. So a run is deterministic
given the generator's state, its gradients are exact for the masks drawn,
and the masks differ between microbatches (the JAX package's one key per
slot repeats them); it is not bit-comparable to the sequential model's.

``keep_stage`` drops from a model what its stage does not compute; the
names of what stays are the sequential model's, so a rank's state_dict is
a part of the sequential model's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..ops.losses import detr_loss, global_loss_normalizers
from . import pp

_IDENTITY, _ENC, _DEC = "identity", "enc", "dec"


def slot_layers(num_encoder_layers: int, num_decoder_layers: int,
                n_stages: int) -> List[List[Tuple[str, Optional[int]]]]:
    """Each stage's slots, (kind, layer index): the encoder layers, then the
    decoder layers, contiguous, identity slots at the end."""
    layers = ([(_ENC, i) for i in range(num_encoder_layers)]
              + [(_DEC, i) for i in range(num_decoder_layers)])
    return [[slot or (_IDENTITY, None) for slot in stage]
            for stage in pp.split_layers_into_stages(layers, n_stages, pad=True)]


def _layer(model, kind: str, i: int):
    return getattr(model.transformer, f"{'encoder' if kind == _ENC else 'decoder'}_layer_{i}")


def stage_module_names(model, stage: int, n_stages: int) -> List[str]:
    """The top-level module and parameter names stage ``stage`` computes."""
    t = model.transformer
    names = []
    if stage == 0:
        names += ["backbone", "input_proj", "query_embed"]
    for kind, i in slot_layers(t.num_encoder_layers, t.num_decoder_layers, n_stages)[stage]:
        if kind != _IDENTITY:
            names.append(f"transformer.{'encoder' if kind == _ENC else 'decoder'}_layer_{i}")
    if stage == n_stages - 1:
        names += ["transformer.decoder_norm", "class_embed", "bbox_embed"]
    return names


def _check(model) -> None:
    if getattr(model, "masks", False) or getattr(model, "head", "detr") != "detr":
        raise NotImplementedError(
            "the 1F1B schedule supports head='detr' without the segmentation head; "
            "masks/non-detr variants pipeline via the GPipe path, DETR(pipeline=spec), "
            "which the Trainer selects automatically (train/engine.py)")


def keep_stage(model, stage: int, n_stages: int):
    """Delete in place every part of ``model`` that stage ``stage`` of
    ``n_stages`` does not compute (its backbone past stage 0, other stages'
    layers, the norm and heads before the last stage). Returns ``model``."""
    _check(model)
    keep = set(stage_module_names(model, stage, n_stages))
    t = model.transformer
    for i in range(t.num_encoder_layers):
        if f"transformer.encoder_layer_{i}" not in keep:
            delattr(t, f"encoder_layer_{i}")
    for i in range(t.num_decoder_layers):
        if f"transformer.decoder_layer_{i}" not in keep:
            delattr(t, f"decoder_layer_{i}")
    if "transformer.decoder_norm" not in keep:
        delattr(t, "decoder_norm")
    for name in ("backbone", "input_proj", "query_embed", "class_embed", "bbox_embed"):
        if name not in keep and hasattr(model, name):
            delattr(model, name)
    model.backbone_quant = None
    return model


def detr_1f1b_value_and_grad(model, batch: Dict[str, torch.Tensor], mesh, *,
                             background_class: int, n_micro: Optional[int] = None,
                             stage_axis: str = "stage", data_axis: Optional[str] = None,
                             generator: Optional[torch.Generator] = None,
                             lap_impl: str = "auto"):
    """Full-DETR loss and gradients through the 1F1B schedule.

    ``model`` is a ``models.DETR`` (``head="detr"``, no masks) whole or cut
    to this rank's stage by ``keep_stage``; ``batch`` holds ``images`` (B,
    H, W, 3), ``boxes``, ``classes``, ``mask`` and optionally
    ``pixel_mask``, this data rank's rows, on the model's device (every
    stage rank of a data rank holds the same batch); ``mesh`` carries
    ``stage_axis`` (and ``data_axis``). ``n_micro`` defaults to
    ``choose_n_micro`` of the global batch. ``generator`` is required when
    the model's dropout is above 0.

    Returns ``(loss, grads)``: the batch's loss (the global batch's under a
    data axis) on every rank, and ``grads``, the gradient of each parameter
    of this rank's stage that requires one, by its name in the sequential
    model (summed over the data group)."""
    _check(model)
    train = float(model.dropout) > 0.0
    if train and generator is None:
        raise ValueError("model.dropout > 0 requires generator= (or use the GPipe path, "
                         "DETR(pipeline=...))")
    stage = pp.stage_of(mesh, stage_axis)
    data_group, _, data_size = pp.data_of(mesh, data_axis)
    t = model.transformer
    n_enc, n_dec = t.num_encoder_layers, t.num_decoder_layers
    b = batch["images"].shape[0]
    if n_micro is None:
        n_micro = pp.choose_n_micro(b * data_size, stage.size, data_size)
    if b % n_micro:
        raise ValueError(f"this rank's batch of {b} does not split into {n_micro} microbatches")
    all_slots = slot_layers(n_enc, n_dec, stage.size)
    per = len(all_slots[0])
    slots = all_slots[stage.index]
    device = batch["images"].device
    seeds = pp.dropout_seeds(generator if train else None, per * stage.size, n_micro)
    aux = None
    if seeds is not None:
        aux = [row[stage.index * per:(stage.index + 1) * per] for row in seeds]
    names = {id(p): n for n, p in model.named_parameters()}

    def stage_fn(slot_seeds, a):
        a = dict(a)
        for j, (kind, i) in enumerate(slots):
            if kind == _IDENTITY:
                continue
            gen = pp.seeded(slot_seeds[j], device) if slot_seeds is not None else None
            layer = _layer(model, kind, i)
            if kind == _ENC:
                a["src"] = layer(a["src"], a["pos"], a.get("mask"), train, gen)
                continue
            if "tgt" not in a:
                qpos = a["qpos"]
                a["tgt"] = torch.zeros_like(qpos)
                a["hs"] = qpos.new_zeros((qpos.shape[0], n_dec) + tuple(qpos.shape[1:]))
            h = layer(a["tgt"], a["src"], a["pos"], a["qpos"], a.get("mask"), train, gen)
            a["tgt"] = h
            a["hs"] = a["hs"].index_copy(1, torch.tensor([i], device=h.device), h[:, None])
        return a

    stage_params = [p for kind, i in slots if kind != _IDENTITY
                    for p in _layer(model, kind, i).parameters() if p.requires_grad]

    x = prefix = None
    if stage.first:
        src, pos, key_padding_mask, _ = model.features(batch["images"], batch.get("pixel_mask"))
        qpos = model.query_embed[None].expand(b, -1, -1).to(src.dtype)
        x = {"src": src, "pos": pos.detach(), "qpos": qpos}
        if key_padding_mask is not None:
            x["mask"] = key_padding_mask
        prefix = x

    loss_fn, loss_params, targets = None, None, None
    if stage.last:
        norm = global_loss_normalizers(batch["mask"], model.num_queries, group=data_group)
        targets = {"boxes": batch["boxes"], "classes": batch["classes"], "mask": batch["mask"]}

        def loss_fn(y, tgt):
            hs = t.decoder_norm(y["hs"]).movedim(1, 0)  # (L, mb, Q, D)
            total, _ = detr_loss(model.heads(hs), tgt["boxes"], tgt["classes"], tgt["mask"],
                                 int(background_class), lap_impl=lap_impl, norm=norm)
            return total

        loss_params = [p for m in (t.decoder_norm, model.class_embed, model.bbox_embed)
                       for p in m.parameters() if p.requires_grad]

    out = pp.pipeline_train_1f1b(stage_fn if aux is not None else (lambda a: stage_fn(None, a)),
                                 loss_fn, stage_params, x, targets, mesh, n_micro=n_micro,
                                 stage_axis=stage_axis, data_axis=data_axis,
                                 loss_params=loss_params or [], stage_aux=aux, device=device)
    loss, stage_grads, dx, loss_grads = out
    grads = {names[id(p)]: g for p, g in zip(stage_params, stage_grads)}
    if stage.last:
        grads.update({names[id(p)]: g for p, g in zip(loss_params, loss_grads)})
    if stage.first:
        wrt = [p for n in ("backbone", "input_proj") for p in getattr(model, n).parameters()
               if p.requires_grad]
        if model.query_embed.requires_grad:
            wrt.append(model.query_embed)
        outs = [(prefix[k], dx[k]) for k in dx if prefix[k].requires_grad]
        if wrt and outs:
            g = torch.autograd.grad([o for o, _ in outs], wrt, [c for _, c in outs],
                                    allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(wrt, g)]
            if data_size > 1:
                g = pp.all_reduce_tensors(g, data_group)
            grads.update({names[id(p)]: gi for p, gi in zip(wrt, g)})
    return loss, grads
