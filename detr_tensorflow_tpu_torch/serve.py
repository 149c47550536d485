"""HTTP serving daemon over the port's ``Predictor`` (port of the
repository's ``serve.py``), stdlib ``http.server`` only.

  POST /detect   body: a .npy (H, W, 3) uint8 array, or JPEG/PNG bytes
                 (these need cv2) -> {"detections": [{"box": [xc, yc, w, h],
                 "label": i, "class": "...", "score": s, "mask_rle": {...}?},
                 ...]}
  GET  /healthz  -> {"ok": true, "buckets": [[h, w], ...]}

Usage:
  python -m detr_tensorflow_tpu_torch.serve --port 8000 [--weights detr.npz]
      [--dtype bfloat16] [--warmup 480x640,800x1333] [--masks]
  python -m detr_tensorflow_tpu_torch.serve --artifact DIR [--device cuda]

``--weights`` takes any local checkpoint ``models.weights.load_weights``
reads: a JAX-format ``.npz`` (``DetrModel.save``), or a facebook or
HuggingFace torch checkpoint (with ``--masks``, a DETRsegm or
``DetrForSegmentation`` one). Without it the model runs seeded random
weights at full DETR-R50 width, which serves the path but detects nothing
real. ``--masks`` serves the segmentation model: each detection carries its
instance mask at the image's size as COCO's uncompressed RLE
(``mask_rle``, column-major counts starting with a background run).

``--artifact DIR`` serves a directory ``export.export_predictor`` wrote,
loaded onto ``--device`` by ``export.load_predictor``: no model is built
and no weights are converted, and the model's flags (dtype, masks, bucket
divisor) are the artifact's. Without ``--score_threshold`` the artifact's
threshold applies (0.5 otherwise).
"""

from __future__ import annotations

import argparse
import io
import json
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """COCO-style uncompressed RLE (column-major counts) for a bool mask."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0]:  # RLE convention: the first run is background
        counts = [0] + counts
    return {"size": [int(mask.shape[0]), int(mask.shape[1])], "counts": counts}


def _decode_image(body: bytes) -> np.ndarray:
    """A raw .npy (H, W, 3) array, or JPEG/PNG through cv2."""
    if body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim != 3 or arr.shape[2] < 3:
            raise ValueError(f"expected an (H, W, 3) array, got shape {arr.shape}")
        return np.ascontiguousarray(arr[..., :3].astype(np.uint8))
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image body")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class DetrService:
    """Runs every device call on one long-lived worker thread, so requests
    reach the device one at a time. The HTTP server starts a thread per
    request, and PyTorch keeps cuDNN's execution plans per thread: a new
    thread rebuilds them for every shape, which cost 120-180 ms per request
    on an H100, several times the forward itself. On the worker thread
    that cost is paid once per bucket; warm the buckets there
    (``submit(predictor.warmup, shapes)``). ``close`` stops the worker."""

    def __init__(self, predictor, class_names):
        self.predictor = predictor
        self.class_names = list(class_names)
        self._device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="detr-device")

    def submit(self, fn, *args):
        """Run ``fn(*args)`` on the device thread and return its result."""
        return self._device.submit(fn, *args).result()

    def detect(self, images):
        return self.submit(self.predictor, images)

    def buckets(self):
        return self.submit(lambda: sorted(list(b) for b in self.predictor.buckets))

    def close(self):
        self._device.shutdown(wait=True)

    def to_json(self, det) -> dict:
        out = []
        for i in range(len(det.boxes)):
            label = int(det.labels[i])
            d = {
                "box": [float(x) for x in det.boxes[i]],
                "label": label,
                "class": (self.class_names[label]
                          if 0 <= label < len(self.class_names) else str(label)),
                "score": float(det.scores[i]),
            }
            if det.masks is not None:
                d["mask_rle"] = mask_to_rle(det.masks[i])
            out.append(d)
        return {"detections": out}


def make_handler(service: DetrService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "buckets": service.buckets()})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                image = _decode_image(self.rfile.read(n))
            except (ValueError, OSError, ImportError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                det = service.detect([image])[0]
            except Exception as e:  # noqa: BLE001 - reported to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, service.to_json(det))

    return Handler


def make_server(service: DetrService, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """A server bound to (host, port); port 0 picks a free one."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    from .data import COCO_CLASS_NAME

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--score_threshold", type=float, default=None,
                        help="default 0.5; with --artifact, unset keeps the artifact's threshold")
    parser.add_argument("--bucket_divisor", type=int, default=128)
    parser.add_argument("--weights", default=None,
                        help="a local checkpoint (.npz, .pth, .pt, .bin); default: seeded "
                             "random weights")
    parser.add_argument("--masks", action="store_true",
                        help="serve instance masks (the segmentation model) as mask_rle")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--warmup", default="",
                        help="comma-separated HxW sizes to run once, e.g. 480x640,800x1333")
    parser.add_argument("--artifact", default="",
                        help="serve an export_predictor directory instead of building the "
                             "model: no model code, no weight conversion at start-up")
    args = parser.parse_args(argv)

    if args.artifact:
        from .export import load_predictor

        predictor = load_predictor(args.artifact, device=args.device)
        if args.score_threshold is not None:
            predictor.score_threshold = args.score_threshold
    else:
        from .models import get_detr_model
        from .predictor import Predictor

        model = get_detr_model(None, include_top=True, weights=args.weights,
                               dtype=args.dtype, seed=args.seed, device=args.device,
                               masks=args.masks)
        predictor = Predictor(
            model, background_class=91, bucket_divisor=args.bucket_divisor,
            score_threshold=0.5 if args.score_threshold is None else args.score_threshold,
            masks=args.masks)
    service = DetrService(predictor, COCO_CLASS_NAME)
    if args.warmup:
        shapes = [tuple(map(int, s.split("x"))) for s in args.warmup.split(",")]
        service.submit(predictor.warmup, shapes)
    server = make_server(service, args.host, args.port)
    print(f"serving on {args.host}:{server.server_address[1]} "
          "(POST /detect, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
