"""The port's serving path (postprocess, Predictor, HTTP service) against
the JAX package's, with the same weights carried by ``from_jax_variables``.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import inference as jax_inference
from detr_tensorflow_tpu.models import build_detr as jax_build_detr
from detr_tensorflow_tpu.predictor import Predictor as JaxPredictor
from detr_tensorflow_tpu_torch import inference, serve
from detr_tensorflow_tpu_torch.models import api
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.predictor import Predictor

CONFIG = dict(num_classes=5, num_queries=6, head="detr", backbone_stage_sizes=(1, 1, 1, 1),
              model_dim=64, num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
              dim_feedforward=64)
# Golden tolerances (tests/test_golden_torch.py): boxes 5e-4; scores are
# softmax probabilities of logits held to 5e-3, and move far less.
BOX_ATOL, SCORE_ATOL = 5e-4, 1e-3


@pytest.fixture(scope="module")
def models():
    jax_model = jax_build_detr(image_size=(64, 64), seed=1, **CONFIG)
    port = api.build_detr(**CONFIG)
    port.module.load_state_dict(from_jax_variables(jax_model.variables), strict=True)
    return jax_model, port


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def _assert_same_detections(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        np.testing.assert_allclose(a.boxes, np.asarray(b.boxes), atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("fmt", ["xy_center", "xyxy", "yxyx"])
def test_postprocess_matches_jax(fmt):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 10, 7)).astype(np.float32)
    logits[0, 3, [2, 5]] = 9.0  # a tie: both frameworks take the first index
    boxes = rng.uniform(-0.1, 1.1, size=(2, 10, 4)).astype(np.float32)
    ref = jax_inference.postprocess(
        {"pred_logits": jnp.asarray(logits), "pred_boxes": jnp.asarray(boxes)}, 4, fmt)
    ours = inference.postprocess(
        {"pred_logits": torch.from_numpy(logits), "pred_boxes": torch.from_numpy(boxes)}, 4, fmt)
    assert int(ours[1][0, 3]) == 2
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        inference.postprocess({"pred_logits": torch.from_numpy(logits),
                               "pred_boxes": torch.from_numpy(boxes)}, 4, "cxcy")


@pytest.mark.parametrize("method", ["torch_resnet", "tf_resnet"])
def test_predictor_matches_jax_mixed_sizes(models, method):
    jax_model, port = models
    jax_model.normalized_method = port.normalized_method = method
    try:
        images = _images(1, [(60, 90), (64, 64), (50, 80), (33, 129)])
        ref = JaxPredictor(jax_model, background_class=0, bucket_divisor=64)(images)
        pred = Predictor(port, background_class=0, bucket_divisor=64)
        _assert_same_detections(pred(images), ref)
        assert pred.buckets == {(64, 128), (64, 64), (64, 192)}
    finally:
        jax_model.normalized_method = port.normalized_method = "torch_resnet"


def test_predictor_padded_equals_exact(models):
    """A bucket-padded serve gives the detections of the image alone."""
    _, port = models
    images = _images(2, [(50, 70), (37, 101)])
    exact = Predictor(port, background_class=0, bucket_divisor=1)(images)
    padded = Predictor(port, background_class=0, bucket_divisor=128)(images)
    for a, b in zip(padded, exact):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5, rtol=0)


def test_predictor_threshold_warmup_and_input_checks(models):
    _, port = models
    img = _images(3, [(64, 64)])
    assert len(Predictor(port, 0, 64, score_threshold=1.1)(img)[0].boxes) == 0
    loose = Predictor(port, 0, 64)
    loose.warmup([(60, 90)])
    assert loose.buckets == {(64, 128)}
    assert len(loose(img)[0].boxes) == int((loose(img)[0].labels != 0).sum())
    with pytest.raises(ValueError):
        loose([np.zeros((8, 8), np.uint8)])


def test_mask_to_rle_roundtrip():
    rng = np.random.default_rng(4)
    for mask in (rng.random((13, 17)) > 0.5, np.zeros((5, 7), bool), np.ones((5, 7), bool)):
        rle = serve.mask_to_rle(mask)
        flat = np.repeat(np.arange(len(rle["counts"])) % 2 == 1, rle["counts"])
        np.testing.assert_array_equal(flat.reshape(rle["size"][::-1]).T, mask)


@pytest.fixture(scope="module")
def server(models):
    _, port = models
    service = serve.DetrService(Predictor(port, background_class=0, bucket_divisor=64),
                                ["back", "a", "b", "c", "d"])
    httpd = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_detect_equals_predictor(server):
    service, url = server
    img = _images(5, [(60, 90)])[0]
    buf = io.BytesIO()
    np.save(buf, img)
    status, payload = _post(url + "/detect", buf.getvalue())
    assert status == 200
    assert payload == json.loads(json.dumps(service.to_json(service.detect([img])[0])))
    assert len(payload["detections"]) == 6 - sum(
        d["label"] == 0 for d in payload["detections"])
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "buckets": [[64, 128]]}


def test_http_errors(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/detect", b"\x93NUMPY" + b"\x00" * 10)
    assert e.value.code == 400
    buf = io.BytesIO()
    np.save(buf, np.zeros((4, 4), np.uint8))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/detect", buf.getvalue())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert e.value.code == 404


def test_service_runs_device_work_on_one_thread():
    """Concurrent requests reach the predictor one at a time, always on the
    service's own worker thread."""
    seen, active = [], []

    class Recorder:
        buckets = set()

        def __call__(self, images):
            active.append(1)
            assert len(active) == 1
            seen.append(threading.get_ident())
            active.pop()
            return [None] * len(images)

    service = serve.DetrService(Recorder(), [])
    threads = [threading.Thread(target=service.detect, args=([0],)) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert service.buckets() == []
    service.close()
    assert len(seen) == 8 and len(set(seen)) == 1 and seen[0] != threading.get_ident()
