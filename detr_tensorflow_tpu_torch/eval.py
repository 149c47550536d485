"""Evaluate DETR on a COCO-format set with the port: box AP, with
``--masks`` mask AP, and with ``--pq`` panoptic quality (twin of the
repository's ``eval.py``).

  python -m detr_tensorflow_tpu_torch.eval --data_dir /path/coco \\
      --img_dir val2017 --ann_file annotations/instances_val2017.json \\
      --weights detr_r50.npz [--batch 4] [--protocol cocoeval] [--device cpu] \\
      [--masks [--mask_lattice full|stride4] [--pq [--panoptic_ann panoptic_val2017.json \\
      --panoptic_png_dir panoptic_val2017]]]

Each image is evaluated at its original size, zero-padded to a multiple of
128 with a pixel mask; the masked forward is padding-invariant, so
``--batch N`` (images grouped by padded shape, the last batch of each
shape padded and masked out by ``batch_valid``) scores as batch 1 does.
``--weights`` is any local checkpoint ``models.weights.load_weights``
reads; without it the model starts from its seeded initialization.

``--masks`` builds the segmentation model and scores its masks too. With
``--mask_lattice full`` (the default, COCO's protocol) each image's kept
queries' mask probabilities are cropped to the valid stride-4 cells,
resized bilinearly to the image on the model's device and thresholded at
0.5, against the ground truth at full resolution (batch 1); ``stride4``
scores both on the padded stride-4 lattice.

``--pq`` (with ``--masks``) adds panoptic quality (``metrics/pq.py``). With
``--panoptic_ann`` the set is a COCO panoptic one (``data/panoptic.py``,
things and stuff, crowd and VOID, batch 1) and each image's kept queries
are merged at its own size on the model's device
(``inference.merge_full_res``); without it, a things-only PQ of the
stride-4 merge (``inference.merge_instance_masks`` of the unmasked mask
logits, as the JAX package scores it) against the instance masks.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from . import inference
from .data import load_coco_dataset, load_coco_panoptic
from .metrics import COCOProtocolEvaluator, MeanAPEvaluator, panoptic_quality
from .models import get_detr_model
from .ops import boxes as bbox_ops
from .train import TrainingConfig, training_config_parser


def build_model(config, **model_kwargs):
    """DETR with its COCO heads, from ``config.weights`` when given."""
    return get_detr_model(config, include_top=True, weights=config.weights, **model_kwargs)


def eval_model(model, config, class_names, valid_dt, protocol: str = "reference",
               mask_lattice: str = "full", report_pq: bool = False, stuff_classes=None):
    """Box AP of ``model`` (a ``DetrModel``) over ``valid_dt``, and mask AP
    when the model has the segmentation head and the batches carry
    ``t_masks``: prints the table and returns it. ``protocol="cocoeval"``
    adds the COCOeval protocol's box AP under ``table["box_cocoeval"]``;
    ``report_pq`` adds panoptic quality under ``table["pq"]``, with
    ``things`` and ``stuff`` sub-tables when ``stuff_classes`` is given.

    mask_lattice:
      * "full" (COCO's protocol, where the batches carry ``t_masks_full``):
        the kept queries' probabilities, cropped to the valid stride-4
        cells, resized bilinearly to the image on the device
        (``inference.kept_probs``) and thresholded, against the ground
        truth at the image's size;
      * "stride4": both sides on the padded stride-4 lattice.

    PQ scores the full-resolution merge of the kept queries against
    ``t_masks_full`` (with ``gt_is_crowd`` and ``void_mask`` where the
    batches carry them) on the "full" lattice, else the stride-4 merge of
    every query against ``t_masks``.
    """
    background = int(config.background_class)
    device = model.device
    evaluator = MeanAPEvaluator(num_classes=len(class_names), class_names=class_names)
    coco_ev = COCOProtocolEvaluator(num_classes=len(class_names)) if protocol == "cocoeval" \
        else None
    pq_args = collections.defaultdict(list)  # panoptic_quality's per-image arguments
    for it, batch in enumerate(valid_dt):
        images = torch.as_tensor(batch["images"]).to(device)
        pixel_mask = (torch.as_tensor(batch["pixel_mask"]).to(device)
                      if "pixel_mask" in batch else None)
        outputs = model(images, pixel_mask)
        boxes_, labels_, scores_, keep_ = (t.float().cpu().numpy() if t.is_floating_point()
                                           else t.cpu().numpy() for t in inference.postprocess(
                                               outputs, background, "yxyx"))
        probs = (inference.mask_probs(outputs["pred_masks"], pixel_mask)
                 if "pred_masks" in outputs and "t_masks" in batch else None)
        use_full = mask_lattice == "full" and "t_masks_full" in batch
        seg4 = (inference.merge_instance_masks(outputs, background)[0].cpu().numpy()
                if report_pq and probs is not None and not use_full else None)
        bvalid = batch.get("batch_valid", np.ones(batch["images"].shape[0], bool))
        for bi in np.nonzero(bvalid)[0]:
            keep0 = keep_[bi]
            p_bbox, p_labels, p_scores = boxes_[bi][keep0], labels_[bi][keep0], scores_[bi][keep0]
            n = int(batch["mask"][bi].sum())
            t_yxyx = bbox_ops.np_yxyx_to_xyxy(bbox_ops.np_xcycwh_to_xyxy(batch["boxes"][bi][:n]))
            p_masks = t_masks = None
            if probs is not None and use_full:
                if "pixel_mask" in batch:
                    pm0 = np.asarray(batch["pixel_mask"][bi])
                    h, w = int(pm0[:, 0].sum()), int(pm0[0, :].sum())
                else:
                    h, w = batch["images"].shape[1:3]
                up = inference.kept_probs(probs[bi], keep0, h, w)
                p_masks = inference.to_host(up > 0.5).transpose(1, 2, 0)
                gt_full = batch["t_masks_full"][bi][:n, :h, :w] > 0
                t_masks = gt_full.transpose(1, 2, 0)
                if report_pq:
                    _add_pq(pq_args, inference.merge_full_res(up, p_scores), p_labels, gt_full,
                            batch, bi, n, (h, w))
            elif probs is not None:
                p_masks = (probs[bi].cpu().numpy()[keep0] > 0.5).transpose(1, 2, 0)
                t_masks = batch["t_masks"][bi][:n].transpose(1, 2, 0)
                if report_pq:
                    _add_pq(pq_args, seg4[bi], labels_[bi], t_masks.transpose(2, 0, 1) > 0,
                            batch, bi, n, None)
            evaluator.add_image(p_bbox, p_labels, p_scores, t_yxyx, batch["classes"][bi][:n],
                                p_masks=p_masks, t_masks=t_masks)
            if coco_ev is not None:
                coco_ev.add_image(p_bbox, p_labels, p_scores, t_yxyx, batch["classes"][bi][:n])
        print(f"Computing map.....{it}", end="\r")
    table = evaluator.print_table()
    if coco_ev is not None:
        ct = coco_ev.compute()["box"]
        print("cocoeval-protocol box AP: " + "  ".join(f"{k}: {v:5.2f}" for k, v in ct.items()))
        table["box_cocoeval"] = ct
    if report_pq and pq_args:
        pq = panoptic_quality(**pq_args, stuff_classes=stuff_classes)
        print(f"       |  PQ: {100 * pq['pq']:.2f}  |  SQ: {100 * pq['sq']:.2f}"
              f"  |  RQ: {100 * pq['rq']:.2f}  | ({pq['n_classes']} classes)")
        if stuff_classes is not None:
            th, st = pq["things"], pq["stuff"]
            print(f"       |  PQ^th: {100 * th['pq']:.2f} ({th['n_classes']})"
                  f"  |  PQ^st: {100 * st['pq']:.2f} ({st['n_classes']})")
        table["pq"] = pq
    return table


def _add_pq(pq_args, seg_map, labels, gt_masks, batch, bi, n, full_hw):
    """One image's ``panoptic_quality`` arguments: its predicted segment map
    and the class of each of its ids, the ground truth's n segments, and at
    full resolution (``full_hw``) the crowd flags and the VOID region where
    the batch carries them."""
    pq_args["pred_seg_maps"].append(seg_map)
    pq_args["pred_labels"].append(labels)
    pq_args["gt_masks"].append(gt_masks)
    pq_args["gt_classes"].append(np.asarray(batch["classes"][bi][:n]))
    full = full_hw is not None
    pq_args["gt_iscrowd"].append(np.asarray(batch["gt_is_crowd"][bi])[:n]
                                 if full and "gt_is_crowd" in batch else None)
    pq_args["void_masks"].append(np.asarray(batch["void_mask"][bi])[:full_hw[0], :full_hw[1]]
                                 if full and "void_mask" in batch else None)


def parser():
    p = training_config_parser()
    p.description = "Evaluate DETR's box AP on a COCO-format set (PyTorch port)"
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (cuda, the default) or cpu")
    p.add_argument("--batch", type=int, default=1,
                   help="images a forward: 1 (the reference's protocol) or N, grouped by "
                        "padded shape; the same AP")
    p.add_argument("--exact_shapes", action="store_true",
                   help="run each image at its exact shape instead of padding it to a "
                        "multiple of 128 (batch 1 only)")
    p.add_argument("--protocol", choices=["reference", "cocoeval"], default="reference",
                   help="'cocoeval' also reports box AP under the pycocotools convention")
    p.add_argument("--paper_protocol", action="store_true",
                   help="the DETR paper's resize: shortest side 800, longest at most 1333")
    p.add_argument("--num_workers", type=int, default=8, help="data loading threads")
    p.add_argument("--masks", action="store_true",
                   help="run the instance-segmentation model and score mask AP too")
    p.add_argument("--mask_lattice", choices=["full", "stride4"], default="full",
                   help="'full': masks scored at each image's own size (COCO's protocol, "
                        "batch 1); 'stride4': on the padded stride-4 lattice")
    p.add_argument("--pq", action="store_true",
                   help="with --masks: also report panoptic quality (PQ/SQ/RQ) of the panoptic "
                        "pixel-argmax merge")
    p.add_argument("--panoptic_ann", default=None,
                   help="a COCO panoptic_*.json: --pq then follows the published protocol "
                        "(things and stuff, crowd and VOID; batch 1); without it --pq scores "
                        "a things-only PQ")
    p.add_argument("--panoptic_png_dir", default=None,
                   help="the panoptic segment-id PNGs (default: the annotation path without "
                        ".json, COCO's convention)")
    return p


def main(argv=None, **model_kwargs) -> dict:
    """Parse ``argv`` and evaluate; returns the AP table. ``model_kwargs``
    go to ``get_detr_model`` (a smaller model for tests)."""
    p = parser()
    args = p.parse_args(argv)
    if args.batch > 1 and args.exact_shapes:
        p.error("--batch N>1 requires bucket padding; drop --exact_shapes")
    panoptic = args.panoptic_ann and args.pq
    if panoptic and args.batch > 1:
        p.error("panoptic eval is batch-1 (ragged full-res ground truth); drop --batch")
    full_res = args.masks and args.mask_lattice == "full"
    if full_res and args.batch > 1:
        p.error("--mask_lattice full scores ragged full-size masks: batch 1, or stride4")
    config = TrainingConfig().update_from_args(args)
    model_kwargs.setdefault("device", args.device)
    if args.masks:
        model_kwargs.setdefault("masks", True)
    model = build_model(config, **model_kwargs)
    bucket = 1 if args.exact_shapes else 128
    if panoptic:
        valid_dt, class_names = load_coco_panoptic(
            config, args.batch, ann_file=args.panoptic_ann, png_dir=args.panoptic_png_dir,
            bucket_divisor=bucket, num_workers=args.num_workers)
    else:
        valid_dt, class_names = load_coco_dataset(
            config, args.batch, augmentation=None, bucket_divisor=bucket,
            paper_protocol=(800, 1333) if args.paper_protocol else None,
            num_workers=args.num_workers, include_masks=args.masks, full_res_masks=full_res)
    config = config.replace(background_class=valid_dt.background_class)
    return eval_model(model, config, class_names, valid_dt, protocol=args.protocol,
                      mask_lattice=args.mask_lattice, report_pq=args.pq and args.masks,
                      stuff_classes=valid_dt.stuff_classes if panoptic else None)


if __name__ == "__main__":
    main(sys.argv[1:])
