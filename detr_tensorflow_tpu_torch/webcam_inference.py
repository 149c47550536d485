"""Webcam (or video-file) inference with the port (twin of the
repository's ``webcam_inference.py``): capture -> colour conversion and
resize -> normalization, forward and postprocess on the model's device ->
boxes (and instance masks) drawn -> display.

  python -m detr_tensorflow_tpu_torch.webcam_inference [--source 0|path.mp4]
      [--image_size 376 672] [--weights detr] [--masks] [--device cuda]
      [--max_frames N] [--no_display]

COCO classes, background class 91. ``--weights`` takes what
``models.weights.load_weights`` reads: a local checkpoint path, or a short
name (the default ``detr``) searched under ``$DETR_TPU_WEIGHTS`` and
``weights/detr``; nothing is downloaded. Capture, colour conversion,
drawing and display need cv2; the resize is ``data/transforms.resize``
(cv2's INTER_LINEAR bit for bit), and ``make_run_inference`` needs no cv2.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import inference
from .data.processing import CAFFE_MEAN, IMAGENET_MEAN, IMAGENET_STD

BACKGROUND_CLASS = 91  # COCO's "no object" logit of DETR's 92


def make_run_inference(model, background_class: int):
    """A function of uint8 RGB frames (B, H, W, 3), numpy or a tensor, that
    normalizes them by ``model.normalized_method`` on the model's device,
    runs the forward and postprocess there, and returns
    (``inference.postprocess``'s (boxes xcycwh, labels, scores, keep),
    (B, Q, H/4, W/4) bool masks or None), tensors on the model's device. A
    segmentation model's masks are its thresholded mask probabilities."""
    method = getattr(model, "normalized_method", "torch_resnet")
    if method == "torch_resnet":
        shift = torch.as_tensor(IMAGENET_MEAN, device=model.device)
        scale = torch.as_tensor(IMAGENET_STD, device=model.device)
    elif method == "tf_resnet":
        shift = torch.as_tensor(CAFFE_MEAN, device=model.device)
    else:
        raise ValueError(f"unknown normalization method: {method}")

    def run(frames_u8):
        with torch.inference_mode():
            x = torch.as_tensor(frames_u8).to(model.device).float()
            images = (x / 255.0 - shift) / scale if method == "torch_resnet" else x.flip(-1) - shift
            outputs = model.module(images)
            post = inference.postprocess(outputs, background_class, "xy_center")
            if "pred_masks" in outputs:
                return post, inference.postprocess_masks(outputs)
            return post, None

    return run


def run_webcam_inference(model, source=0, image_size=(376, 672), display=True,
                         frame_callback=None, max_frames=None) -> int:
    """Detect on every frame of ``source`` (a camera index or a video
    path), resized to ``image_size`` (H, W), until the stream ends,
    ``max_frames`` frames or "q" in the window. Each drawn RGB frame goes to
    ``frame_callback`` and, with ``display``, to a window. Returns the
    number of frames run."""
    import cv2

    from .data import COCO_CLASS_NAME
    from .data.transforms import LINEAR, resize

    run = make_run_inference(model, BACKGROUND_CLASS)
    cap = cv2.VideoCapture(source)
    n_frames = 0
    try:
        while max_frames is None or n_frames < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frame = resize(frame, image_size[0], image_size[1], LINEAR)
            (boxes, labels, scores, keep), masks = run(frame[None])
            keep0 = keep[0].cpu().numpy()
            labels0 = labels[0].cpu().numpy()[keep0]
            out = frame
            if masks is not None:
                out = inference.numpy_masks_to_image(out, masks[0].cpu().numpy()[keep0],
                                                     labels=labels0)
            out = inference.numpy_bbox_to_image(out, boxes[0].cpu().numpy()[keep0], labels0,
                                                scores[0].cpu().numpy()[keep0], COCO_CLASS_NAME)
            n_frames += 1
            if frame_callback is not None:
                frame_callback(out)
            if display:
                cv2.imshow("detr-torch", cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        cap.release()
    return n_frames


def main(argv=None, **model_kwargs) -> int:
    """Parse ``argv`` and run the webcam loop; returns the frames run.
    ``model_kwargs`` go to ``get_detr_model`` (a smaller model for tests)."""
    from .models import get_detr_model

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", default="0", help="a camera index or a video file")
    parser.add_argument("--image_size", type=int, nargs=2, default=(376, 672))
    parser.add_argument("--weights", default="detr",
                        help="a local checkpoint path or a short name (no download)")
    parser.add_argument("--masks", action="store_true",
                        help="run the segmentation head and overlay its masks")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--no_display", action="store_true")
    args = parser.parse_args(argv)
    source = int(args.source) if args.source.isdigit() else args.source
    model = get_detr_model(None, include_top=True, weights=args.weights, masks=args.masks,
                           device=args.device, **model_kwargs)
    return run_webcam_inference(model, source, tuple(args.image_size),
                                display=not args.no_display, max_frames=args.max_frames)


if __name__ == "__main__":
    main(sys.argv[1:])
