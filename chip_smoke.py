#!/usr/bin/env python3
"""Smoke run of the PyTorch port (detr_tensorflow_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``;
  2. build: nvcc builds every kernel of the serving and training paths from
     csrc/, one process per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the served path gives it, fp32 (TF32 off) and bf16,
     with kernel and plain times; then the attention forward with dropout
     and its backward at the training shapes, against plain autograd at
     dropout 0 and given the mask the kernel library materialises;
  4. lap: the LAP kernel on 48 problems (6 decoder layers x batch 8)
     against its plain version and scipy, with times;
  5. serving: full-width DETR-R50 (seeded random weights) behind
     ``Predictor``: 3 requests with the launch counters reset just before,
     the whole forward against the plain-attention model, padded against
     exact, and one bf16 request;
  6. http: the port's HTTP service on 127.0.0.1, 3 POSTs and /healthz;
  7. training: full-width DETR-R50 at b8 376x672 fp32: one step's loss and
     gradients, kernel route against plain route at dropout 0; eight
     dropout-0.1 steps through ``fit`` with the counters reset just before;
     matching and loss under ``torch.cuda.set_sync_debug_mode("error")``.
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
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "lap.cu")
CSRC = "detr_tensorflow_tpu_torch/csrc/"
REPLACES = {
    "flash_attention_fwd": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:77",
    "flash_attention_bwd": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:115",
    "lap": "detr_tensorflow_tpu/ops/pallas/lap.py:77",
}
DEVICE = "cuda"

# Training: (Lq, Lk) of encoder self, decoder cross and decoder self
# attention at 376x672 (a 12x21 = 252-key map), batch 8, 8 heads, Dh 32.
TRAIN_ATTN_SHAPES = [(252, 252), (100, 252), (100, 100)]
TRAIN_TIMED = [(252, 252), (100, 252)]
DROPOUT = 0.1
# Gradient tolerance relative to the largest reference value: fp32 differs
# by summation order; bf16 rounds P and dS at the TPU kernel's points, the
# plain version at autograd's.
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
LAP_PROBLEMS, LAP_SLOTS, LAP_MAX_REAL = 48, 100, 30
TRAIN_BATCH, TRAIN_HW, TRAIN_STEPS = 8, (376, 672), 8
BACKGROUND = 91  # DETR-R50's "no object" logit of 92
LOSS_RTOL, TENSOR_GRAD_RTOL, NOISE_FLOOR = 1e-4, 1e-3, 1e-6


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


def train_attention_inputs(torch, lq, lk, dtype, seed, masked):
    rng = np.random.default_rng(seed)
    b, h, dh = 8, 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v, dout = (rng.normal(size=s) for s in ((b, lk, h, dh), (b, lk, h, dh), (b, lq, h, dh)))
    to = lambda x: torch.from_numpy(x).to(DEVICE, dtype)  # noqa: E731
    mask = None
    if masked:  # a ragged key-padding mask: each image keeps its own prefix
        valid = rng.integers(lk // 3, lk + 1, size=b)
        mask = torch.from_numpy(np.arange(lk)[None, :] >= valid[:, None]).to(DEVICE)
    return to(q), to(k), to(v), to(dout), mask


def attention_grads(torch, fn, q, k, v, dout):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def phase_train_kernels(torch, fa):
    """Kernel A with dropout and kernel A' at the training shapes."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    times = {}
    for lq, lk in TRAIN_ATTN_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            masked = (lq, lk) == (100, 252)
            q, k, v, dout, mask = train_attention_inputs(torch, lq, lk, dtype, lq * 3 + lk, masked)
            for rate in (0.0, DROPOUT):
                seed = torch.tensor([lq * 100003 + lk * 7 + int(rate * 10)], device=DEVICE)
                keep = None
                if rate:
                    keep = fa.kernel_keep_mask(seed, 64, lq, lk, rate)
                    if not torch.equal(keep, fa.keep_mask(seed, 64, lq, lk, rate)):
                        raise AssertionError("kernel dropout bits differ from the PyTorch Philox")
                    kept, n = float(keep.float().mean()), keep.numel()
                    if abs(kept - (1 - rate)) > 5 * (rate * (1 - rate) / n) ** 0.5:
                        raise AssertionError(f"keep rate {kept} at ({lq},{lk})")
                    keep = keep.view(8, 8, lq, lk)
                got = attention_grads(torch, lambda *t: fa.mha(*t, mask, rate, seed), q, k, v, dout)
                ref = attention_grads(torch, lambda *t: fa.reference_mha(*t, mask, keep, rate),
                                      q, k, v, dout)
                torch.cuda.synchronize()
                errs = []
                for g, r, what in zip(got, ref, ("out", "dq", "dk", "dv")):
                    err = float((g.float() - r.float()).abs().max())
                    scale = max(1.0, float(r.float().abs().max()))
                    tol = ATOL[name] if what == "out" else GRAD_RTOL[name] * scale
                    if not err <= tol:
                        raise AssertionError(f"{what} disagrees with plain autograd at "
                                             f"({lq},{lk}) {name} dropout {rate}: {err} > {tol}")
                    if what != "out":
                        worst[name] = max(worst[name], err)
                    errs.append(f"{what} {err:.2e}")
                log(f"  attention fwd+bwd ({lq},{lk}) {name} dropout {rate}"
                    f"{' masked' if masked else ''}: {', '.join(errs)}")
            if (lq, lk) in TRAIN_TIMED and name == "float32":
                seed = torch.tensor([12345], device=DEVICE)
                keep = fa.keep_mask(seed, 64, lq, lk, DROPOUT).view(8, 8, lq, lk)
                out, lse = fa.launch_forward(q, k, v, mask, seed, DROPOUT, True)
                kernel = lambda: fa.launch_backward(  # noqa: E731
                    q, k, v, out, dout, lse, mask, seed, DROPOUT)
                qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
                ref_out = fa.reference_mha(qr, kr, vr, mask, keep, DROPOUT)
                plain = lambda: torch.autograd.grad(  # noqa: E731
                    ref_out, (qr, kr, vr), dout, retain_graph=True)
                p1, k1, k2, p2 = (time_ms(torch, f, iters=20) for f in (plain, kernel, kernel, plain))
                times[(lq, lk)] = ((k1 + k2) / 2, (p1 + p2) / 2)
                log(f"  attention backward ({lq},{lk}) fp32 B=8 H=8 Dh=32 dropout {DROPOUT}: "
                    f"kernel {(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms")
    return worst, times


def lap_problems(seed, ties=False):
    rng = np.random.default_rng(seed)
    shape = (LAP_PROBLEMS, LAP_SLOTS, LAP_SLOTS)
    cost = (rng.integers(0, 4, size=shape) if ties else rng.normal(size=shape)).astype(np.float32)
    n_real = rng.integers(0, LAP_MAX_REAL + 1, size=LAP_PROBLEMS)
    n_real[:2] = 0, LAP_MAX_REAL
    return cost, np.arange(LAP_SLOTS)[None, :] < n_real[:, None], n_real


def phase_lap(torch, lap):
    from scipy.optimize import linear_sum_assignment

    worst = 0.0
    for ties in (False, True):
        cost, mask, n_real = lap_problems(3 + ties, ties)
        ct, mt = torch.from_numpy(cost).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
        got = lap.solve_lap_masked(ct, mt).cpu().numpy()
        t0 = time.perf_counter()
        plain = lap.reference_solve_lap_masked(ct, mt).cpu().numpy()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        scipy_cols = [linear_sum_assignment(cost[i, :n])[1] for i, n in enumerate(n_real)]
        scipy_ms = 1e3 * (time.perf_counter() - t0)
        for i, n in enumerate(n_real):
            if (got[i, n:] != -1).any() or len(set(got[i, :n].tolist())) != n:
                raise AssertionError(f"problem {i}: not an assignment of its {n} real rows")
            best = float(cost[i, np.arange(n), scipy_cols[i]].sum())
            err = abs(float(cost[i, np.arange(n), got[i, :n]].sum()) - best)
            worst = max(worst, err)
            if not err <= 1e-4 * max(1.0, abs(best)):
                raise AssertionError(f"problem {i}: cost {err} above the optimum")
            if not ties and ((got[i, :n] != scipy_cols[i]).any() or (got[i] != plain[i]).any()):
                raise AssertionError(f"problem {i}: assignment differs from plain/scipy")
        if not ties:
            ms = time_ms(torch, lambda: lap.solve_lap_masked(ct, mt), iters=20, warmup=3)
            times = (ms, plain_ms, scipy_ms)
            log(f"  lap {LAP_PROBLEMS}x{LAP_SLOTS}x{LAP_SLOTS}, n_real 0..{LAP_MAX_REAL}: "
                f"kernel {ms:.4f} ms, plain (on the card's tensors) {plain_ms:.2f} ms, "
                f"scipy host loop {scipy_ms:.2f} ms; assignments equal to plain and scipy")
        else:
            log("  lap tied costs: optimal cost equal to scipy's on every problem")
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


def train_batch(seed):
    """A native b8 376x672 batch built in memory: normalized-scale images and
    1-20 boxes per image, padded with ``pad_targets``."""
    from detr_tensorflow_tpu_torch.data import MAX_TARGETS, pad_targets

    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                    rng.uniform(0.05, 0.5, (n, 2))], -1),
                    rng.integers(0, BACKGROUND, size=n), MAX_TARGETS)
        for n in rng.integers(1, 21, size=TRAIN_BATCH)))
    images = rng.normal(size=(TRAIN_BATCH,) + TRAIN_HW + (3,)).astype(np.float32)
    return {"images": images, "boxes": np.stack(boxes), "classes": np.stack(classes),
            "mask": np.stack(mask)}


def gradient_agreement(grads_k, grads_p):
    """Per-tensor gradient agreement of two routes: ||g_k - g_p|| <=
    TENSOR_GRAD_RTOL ||g_p||. A tensor whose gradient is below
    NOISE_FLOOR of the largest tensor gradient has an exactly-zero
    gradient (every k_proj bias: softmax ignores a per-row shift; parts of
    the first decoder layer's self-attention, whose input is zero), and
    both routes return rounding noise there: such a tensor is held to the
    floor itself. Returns (worst (rel err, name), noise tensor names)."""
    scale = max(float(g.norm()) for g in grads_p.values())
    worst, noise = (0.0, ""), []
    for name, g in grads_p.items():
        diff = float((grads_k[name] - g).norm())
        if float(g.norm()) <= NOISE_FLOOR * scale:
            noise.append(name)
            if not diff <= NOISE_FLOOR * scale:
                raise AssertionError(f"{name}: {diff} above the noise floor")
            continue
        rel = diff / float(g.norm())
        worst = max(worst, (rel, name))
        if not rel <= TENSOR_GRAD_RTOL:
            raise AssertionError(f"{name}: gradient rel err {rel} > {TENSOR_GRAD_RTOL}")
    return worst, noise


def phase_training(torch, fa, lap, api, train, losses):
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    targets = ("boxes", "classes", "mask")
    batch = batch_to_device(train_batch(5), DEVICE)
    # Parity at dropout 0: the kernel route's matching goes to the plain
    # route, so the two differ in attention (A and A') only.
    results = []
    match = None
    for impl in ("auto", "plain"):
        model = api.build_detr(seed=0, device=DEVICE, dropout=0.0, attn_impl=impl).module
        out = model(batch["images"], train=True)
        if match is None:
            match = losses.match_all_layers(out, *(batch[k] for k in targets))
        total, _ = losses.detr_loss(out, *(batch[k] for k in targets), BACKGROUND, match=match)
        total.backward()
        results.append((float(total.detach()), {n: p.grad for n, p in model.named_parameters()}))
        del model, out
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    worst, noise = gradient_agreement(grads_k, grads_p)
    log(f"  parity at dropout 0: loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel {loss_err:.2e}, "
        f"tol {LOSS_RTOL}); worst gradient rel err {worst[0]:.2e} ({worst[1]}, tol "
        f"{TENSOR_GRAD_RTOL}) over {len(grads_p) - len(noise)} tensors; {len(noise)} tensors "
        f"with an exactly-zero gradient agree within the noise floor: {', '.join(noise)}")
    if not loss_err <= LOSS_RTOL:
        raise AssertionError("kernel route and plain route losses disagree")
    del results, grads_k, grads_p
    torch.cuda.empty_cache()

    config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                  train_transformers=True, batch_size=TRAIN_BATCH,
                                  backbone_lr=1e-3, transformers_lr=1e-3)
    model = api.build_detr(seed=0, device=DEVICE).module  # dropout 0.1
    trainer = train.Trainer(model, config, seed=0)
    batch = batch_to_device(train_batch(6), DEVICE)
    trainer.step(batch)  # first call: cuDNN plans and kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses_seen = [time.perf_counter()], []

    def log_fn(host_log, step):
        marks.append(time.perf_counter())
        losses_seen.append(host_log["total_loss"])

    fa.mha.launches = fa.mha.backward_launches = lap.solve_lap_masked.launches = 0  # main path
    train.fit(trainer, [batch] * TRAIN_STEPS, config, epoch_nb=0, log_fn=log_fn, log_every=1)
    counts = (fa.mha.launches, fa.mha.backward_launches, lap.solve_lap_masked.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    median = statistics.median(step_ms)
    log(f"  {TRAIN_STEPS} steps at dropout {DROPOUT}: losses {[round(x, 4) for x in losses_seen]}")
    log(f"  step times {[round(x, 2) for x in step_ms]} ms, median {median:.2f} ms, "
        f"{TRAIN_BATCH * 1e3 / median:.2f} images/s, peak device memory {peak_gb:.2f} GiB")
    log(f"  launches in {TRAIN_STEPS} steps: attention forward {counts[0]}, backward {counts[1]}, "
        f"lap {counts[2]}")
    per_step = (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD, 1)
    if counts != tuple(TRAIN_STEPS * c for c in per_step):
        raise AssertionError(f"launch counts {counts}, expected {per_step} per step")
    if not all(np.isfinite(losses_seen)) or not losses_seen[-1] < losses_seen[0]:
        raise AssertionError(f"losses not finite and falling: {losses_seen}")

    out = model(batch["images"], train=True, generator=trainer.generator)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        total, _ = losses.detr_loss(out, *(batch[k] for k in targets), BACKGROUND)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool(torch.isfinite(total)):
        raise AssertionError("non-finite loss")
    log("  matching and loss ran under set_sync_debug_mode('error'): no host sync")
    return counts, median


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    from detr_tensorflow_tpu_torch import serve
    from detr_tensorflow_tpu_torch.data import COCO_CLASS_NAME
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch import train
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa
    from detr_tensorflow_tpu_torch.ops import lap, losses, nvcc_build
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

    t = time.perf_counter()
    for source, build in zip(SOURCES, nvcc_build.build_all(SOURCES)):
        log(f"[build] {source}: nvcc {build.seconds:.2f} s -> {build.path.name}")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"[build] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    worst, times = phase_kernels(torch, fa)
    bwd_worst, bwd_times = phase_train_kernels(torch, fa)
    log(f"[kernels] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    lap_err, lap_times = phase_lap(torch, lap)
    log(f"[lap] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    predictor, launches = phase_serving(torch, fa, api, Predictor)
    log(f"[serving] ok in {time.perf_counter() - t:.1f} s, {launches} kernel launches "
        f"in 3 forwards")

    t = time.perf_counter()
    phase_http(predictor, serve, COCO_CLASS_NAME)
    log(f"[http] ok in {time.perf_counter() - t:.1f} s")
    del predictor
    torch.cuda.empty_cache()

    t = time.perf_counter()
    counts, step_ms = phase_training(torch, fa, lap, api, train, losses)
    log(f"[training] ok in {time.perf_counter() - t:.1f} s, median step {step_ms:.2f} ms")

    ms, plain_ms = times[(1232, 1232, "float32")]
    bwd_ms, bwd_plain_ms = bwd_times[(252, 252)]
    lap_ms, lap_plain_ms, _ = lap_times
    record = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": CSRC + SOURCES[0],
         "replaces": REPLACES["flash_attention_fwd"], "launches": launches + counts[0],
         "max_abs_err": worst["float32"], "ms": ms, "plain_ms": plain_ms},
        {"name": "flash_attention_bwd", "route": "cuda", "source": CSRC + SOURCES[1],
         "replaces": REPLACES["flash_attention_bwd"], "launches": counts[1],
         "max_abs_err": bwd_worst["float32"], "ms": bwd_ms, "plain_ms": bwd_plain_ms},
        {"name": "lap", "route": "cuda", "source": CSRC + SOURCES[2],
         "replaces": REPLACES["lap"], "launches": counts[2],
         "max_abs_err": lap_err, "ms": lap_ms, "plain_ms": lap_plain_ms},
    ]}
    log(f"[summary] flash_attention_fwd: max_abs_err fp32 {worst['float32']:.3e}, bf16 "
        f"{worst['bfloat16']:.3e}, ms/plain_ms at (1232,1232) fp32 B=2 H=8 Dh=32, launches "
        f"{launches} serving + {counts[0]} training; flash_attention_bwd: gradient "
        f"max_abs_err fp32 {bwd_worst['float32']:.3e}, bf16 {bwd_worst['bfloat16']:.3e}, "
        f"ms/plain_ms backward at (252,252) fp32 B=8 dropout {DROPOUT}; lap: optimal-cost "
        f"max_abs_err {lap_err:.3e}, ms kernel / plain_ms plain version on 48 problems")
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
