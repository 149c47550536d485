#!/usr/bin/env python3
"""Smoke run of the PyTorch port (detr_tensorflow_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``;
  2. build: nvcc builds every kernel of the served path from csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the served path gives it, fp32 (TF32 off) and bf16,
     with kernel and plain times;
  4. serving: full-width DETR-R50 (seeded random weights) behind
     ``Predictor``: 3 requests with the launch counters reset just before,
     the whole forward against the plain-attention model, padded against
     exact, and one bf16 request;
  5. http: the port's HTTP service on 127.0.0.1, 3 POSTs and /healthz.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# (Lq, Lk) of every attention call on the served path: encoder self and
# decoder cross at the 896x1408 and 800x1344 buckets, decoder self, and
# the 512x640 bucket's encoder self.
ATTN_SHAPES = [(1232, 1232), (100, 1232), (1050, 1050), (100, 1050), (100, 100), (320, 320)]
TIMED_SHAPES = [(1232, 1232), (100, 1232)]
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAUNCHES_PER_FORWARD = 18  # 6 encoder self + 6 decoder self + 6 decoder cross
BOX_ATOL, LOGIT_ATOL = 5e-4, 5e-3  # kernel model vs plain-attention model, fp32
PADDED_BOX_ATOL = 1e-3
KERNEL_SOURCE = "detr_tensorflow_tpu_torch/csrc/flash_attention_fwd.cu"
KERNEL_REPLACES = "detr_tensorflow_tpu/ops/pallas/flash_attention.py:77"
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(torch, lq, lk, dtype, seed):
    rng = np.random.default_rng(seed)
    b, h, dh = 2, 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k = rng.normal(size=(b, lk, h, dh))
    v = rng.normal(size=(b, lk, h, dh))
    # Row 0 loses a ragged tail, row 1 about half its keys.
    valid = np.array([lk - lk // 7, lk // 2 + 1])
    mask = np.arange(lk)[None, :] >= valid[:, None]
    to = lambda x: torch.from_numpy(x).to(DEVICE, dtype)  # noqa: E731
    return to(q), to(k), to(v), torch.from_numpy(mask).to(DEVICE)


def phase_kernels(torch, fa):
    worst = {"float32": 0.0, "bfloat16": 0.0}
    times = {}
    for lq, lk in ATTN_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, mask = attention_inputs(torch, lq, lk, dtype, seed=lq * 7 + lk)
            out = fa.mha(q, k, v, mask)
            ref = fa.reference_mha(q, k, v, mask)
            torch.cuda.synchronize()
            if out.shape != q.shape or out.dtype != dtype:
                raise AssertionError(f"kernel output {out.shape} {out.dtype}")
            err = float((out.float() - ref.float()).abs().max())
            log(f"  attention ({lq},{lk}) {name}: max_abs_err {err:.3e} (tol {ATOL[name]})")
            if not err <= ATOL[name]:
                raise AssertionError(f"kernel disagrees with plain at ({lq},{lk}) {name}: {err}")
            worst[name] = max(worst[name], err)
            if (lq, lk) in TIMED_SHAPES:
                kernel = lambda: fa.mha(q, k, v, mask)  # noqa: E731
                plain = lambda: fa.reference_mha(q, k, v, mask)  # noqa: E731
                p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kernel, kernel, plain))
                times[(lq, lk, name)] = ((k1 + k2) / 2, (p1 + p2) / 2)
                log(f"  attention ({lq},{lk}) {name} B=2 H=8 Dh=32: kernel "
                    f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms")
    return worst, times


def random_images(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in shapes]


def check_detections(dets, num_classes=92):
    for d in dets:
        n = len(d.boxes)
        if d.boxes.shape != (n, 4) or len(d.labels) != n or len(d.scores) != n:
            raise AssertionError("ragged detection arrays")
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()):
            raise AssertionError("non-finite detections")
        if n and not ((d.boxes >= 0).all() and (d.boxes <= 1).all()
                      and (d.labels >= 0).all() and (d.labels < num_classes).all()
                      and (d.scores > 0).all() and (d.scores <= 1).all()):
            raise AssertionError("detections out of range")


def phase_serving(torch, fa, api, Predictor):
    model = api.build_detr(seed=0, device=DEVICE)
    predictor = Predictor(model, background_class=91)
    img_a, img_b, img_c, img_d = random_images(
        [(800, 1333), (480, 640), (800, 1333), (800, 1333)], seed=1)
    predictor.warmup([(800, 1333), (480, 640)])

    fa.mha.launches = 0  # main path: three requests, three forwards
    t0 = time.perf_counter()
    r1 = predictor([img_a])
    t1 = time.perf_counter()
    r2 = predictor([img_b])
    t2 = time.perf_counter()
    r3 = predictor([img_c, img_d])
    t3 = time.perf_counter()
    launches = fa.mha.launches
    log(f"  requests: 800x1333 b1 {1e3 * (t1 - t0):.2f} ms, 480x640 b1 "
        f"{1e3 * (t2 - t1):.2f} ms, 2x800x1333 b2 {1e3 * (t3 - t2):.2f} ms")
    if launches != 3 * LAUNCHES_PER_FORWARD:
        raise AssertionError(f"{launches} kernel launches for 3 forwards")
    for dets in (r1, r2, r3):
        check_detections(dets)
    if sorted(predictor.buckets) != [(512, 640), (896, 1408)]:
        raise AssertionError(f"buckets {predictor.buckets}")

    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor([img_a])
        lat.append(1e3 * (time.perf_counter() - t0))
    log(f"  Predictor 800x1333 b1 fp32 latency: median {statistics.median(lat):.2f} ms "
        f"of {[round(x, 2) for x in lat]}")

    # The whole forward against the same weights with plain attention.
    plain = api.build_detr(seed=0, device=DEVICE, attn_impl="plain")
    frames = np.zeros((1, 896, 1408, 3), np.uint8)
    frames[0, :800, :1333] = img_a
    mask = np.zeros((1, 896, 1408), bool)
    mask[0, :800, :1333] = True
    pm = torch.from_numpy(mask).to(DEVICE)
    with torch.inference_mode():
        x = predictor.normalize(torch.from_numpy(frames).to(DEVICE)) * pm[..., None]
    ours, ref = model(x, pm), plain(x, pm)
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL)):
        err = float((ours[key] - ref[key]).abs().max())
        log(f"  forward {key}: kernel vs plain attention max_abs_err {err:.3e} (tol {atol})")
        if not err <= atol:
            raise AssertionError(f"{key} disagrees with the plain-attention model: {err}")

    # Padded = exact: 768x1280 alone vs on an 896x1408 canvas with its mask.
    exact_img = random_images([(768, 1280)], seed=2)[0]
    with torch.inference_mode():
        alone = predictor.normalize(torch.from_numpy(exact_img[None]).to(DEVICE))
        canvas = torch.zeros((1, 896, 1408, 3), device=DEVICE)
        canvas[:, :768, :1280] = alone
        cmask = torch.zeros((1, 896, 1408), dtype=torch.bool, device=DEVICE)
        cmask[:, :768, :1280] = True
    err = float((model(alone)["pred_boxes"] - model(canvas, cmask)["pred_boxes"]).abs().max())
    log(f"  padded vs exact 768x1280 boxes max_abs_err {err:.3e} (tol {PADDED_BOX_ATOL})")
    if not err <= PADDED_BOX_ATOL:
        raise AssertionError(f"padded forward differs from exact: {err}")

    model_bf16 = api.build_detr(seed=0, device=DEVICE, dtype="bfloat16")
    pred_bf16 = Predictor(model_bf16, background_class=91)
    pred_bf16.warmup([(800, 1333)])
    fa.mha.launches = 0
    t0 = time.perf_counter()
    dets = pred_bf16([img_a])
    bf16_ms = 1e3 * (time.perf_counter() - t0)
    if fa.mha.launches != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"bf16: {fa.mha.launches} launches for one forward")
    check_detections(dets)
    lat16 = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred_bf16([img_a])
        lat16.append(1e3 * (time.perf_counter() - t0))
    log(f"  Predictor 800x1333 b1 bf16: first {bf16_ms:.2f} ms, median "
        f"{statistics.median(lat16):.2f} ms of {[round(x, 2) for x in lat16]}")
    del plain, model_bf16, pred_bf16
    return predictor, launches


def phase_http(predictor, serve, class_names):
    shapes = [(800, 1333), (480, 640), (600, 800)]
    service = serve.DetrService(predictor, class_names)
    # cuDNN plans are cached per thread and shape: warm them on the device thread.
    service.submit(predictor.warmup, shapes)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            r.read()  # the client's one-time set-up stays out of the POST times
        for img in random_images(shapes, seed=3):
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(url + "/detect", data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                status, payload = r.status, json.loads(r.read())
            ms = 1e3 * (time.perf_counter() - t0)
            if status != 200 or not isinstance(payload.get("detections"), list):
                raise AssertionError(f"/detect answered {status}: {payload}")
            for d in payload["detections"]:
                if set(d) != {"box", "label", "class", "score"} or len(d["box"]) != 4:
                    raise AssertionError(f"malformed detection {d}")
            log(f"  POST /detect {img.shape[0]}x{img.shape[1]}: 200, "
                f"{len(payload['detections'])} detections, {ms:.2f} ms")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            status, health = r.status, json.loads(r.read())
        if status != 200 or health.get("ok") is not True:
            raise AssertionError(f"/healthz answered {status}: {health}")
        log(f"  GET /healthz: 200, buckets {health['buckets']}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    from detr_tensorflow_tpu_torch import serve
    from detr_tensorflow_tpu_torch.data import COCO_CLASS_NAME
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa
    from detr_tensorflow_tpu_torch.ops import nvcc_build
    from detr_tensorflow_tpu_torch.predictor import Predictor

    # fp32 parity needs full fp32 matmuls and convolutions (TF32 off).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    build = nvcc_build.build("flash_attention_fwd.cu")
    log(f"[build] flash_attention_fwd.cu: nvcc {build.seconds:.2f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t = time.perf_counter()
    worst, times = phase_kernels(torch, fa)
    log(f"[kernels] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    predictor, launches = phase_serving(torch, fa, api, Predictor)
    log(f"[serving] ok in {time.perf_counter() - t:.1f} s, {launches} kernel launches "
        f"in 3 forwards")

    t = time.perf_counter()
    phase_http(predictor, serve, COCO_CLASS_NAME)
    log(f"[http] ok in {time.perf_counter() - t:.1f} s")

    ms, plain_ms = times[(1232, 1232, "float32")]
    record = {"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst["float32"], "ms": ms, "plain_ms": plain_ms,
    }]}
    log(f"[summary] max_abs_err fp32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; "
        "ms/plain_ms at (1232,1232) fp32 B=2 H=8 Dh=32")
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
