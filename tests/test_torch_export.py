"""The port's serving artifacts (``detr_tensorflow_tpu_torch/export.py``) on
the CPU: ``export_predictor`` / ``load_predictor`` round trips against the
live port Predictor (bit for bit) and the JAX package's artifact (golden
tolerances), the ``detr_torch`` ops in every exported graph, and
``torch.library.opcheck`` of each op.

Each variant is exported once (module-scoped fixtures) at the reduced
config of ``tests/test_torch_serving.py``. Two artifacts go through files,
their programs taking any batch: fp32 at two buckets, and the masks model;
the other variants' programs are checked in memory at a fixed batch, which
traces in about half the time.
"""

import io
import json
import os
import threading
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.export import export_predictor as jax_export_predictor
from detr_tensorflow_tpu.export import load_predictor as jax_load_predictor
from detr_tensorflow_tpu.models.api import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.models.detr import DETR as JaxDETR
from detr_tensorflow_tpu.predictor import Predictor as JaxPredictor
from detr_tensorflow_tpu_torch import export, serve
from detr_tensorflow_tpu_torch.models import api, quantized
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.models.layers import FrozenBatchNorm
from detr_tensorflow_tpu_torch.models.weights import to_jax_variables
from detr_tensorflow_tpu_torch.ops import library
from detr_tensorflow_tpu_torch.predictor import Predictor
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

CONFIG = dict(num_classes=5, num_queries=6, head="detr", backbone_stage_sizes=(1, 1, 1, 1),
              model_dim=64, num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
              dim_feedforward=64)
# Golden tolerances (tests/test_golden_torch.py), as tests/test_torch_serving.py.
BOX_ATOL, SCORE_ATOL = 5e-4, 1e-3
SHAPES = [(60, 90), (64, 64)]  # buckets (64, 128) and (64, 64) at divisor 64
# The ops each exported graph calls, per (variant, masked): 3 attention
# calls (1 encoder self, 1 decoder self, 1 decoder cross) and the stem's
# pool (the mask head adds none); int8: per bottleneck conv1 and conv3 on
# F, conv2 on G, and the stem's F.max_pool2d; fused (stages (2, 1, 1, 1)):
# D on every block's tail with a pixel mask, E on the identity block
# without one.
A_C = {"mha_forward": 3, "max_pool_3x3_s2": 1}
EXPECTED_OPS = {
    ("fp32", True): A_C, ("masks", True): A_C, ("bf16 dc5", True): A_C,
    ("int8", True): {"mha_forward": 3, "int8_matmul": 8, "int8_conv3x3": 4},
    ("fused", True): {**A_C, "conv1x1_bn_residual_relu": 5},
    ("fused", False): {**A_C, "conv1x1_bn_residual_relu": 4, "fused_bottleneck": 1},
}
# Exported without a round trip through files, at batch BATCH. The DC5
# model (its last stage dilated, one block at dilation 2) computes in bf16:
# one export holds both.
BATCH = 3
VARIANTS = {
    "bf16 dc5": dict(dtype="bfloat16", dilation=True, backbone_stage_sizes=(1, 1, 1, 2)),
    "int8": dict(dtype="bfloat16", backbone_quant=True),
    "fused": dict(fuse_residual=True, fuse_bottleneck=True, backbone_stage_sizes=(2, 1, 1, 1)),
}


OPS = ("mha_forward", "max_pool_3x3_s2", "conv1x1_bn_residual_relu", "fused_bottleneck",
       "int8_matmul", "int8_conv3x3")


def op_counts(graph):
    """How many times each ``detr_torch`` op is called in ``graph``."""
    counts = {}
    for node in graph.nodes:
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload) \
                and node.target.namespace == library.NAMESPACE:
            name = node.target.name().split("::")[1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _images(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def _assert_equal_detections(ours, ref, masks=False):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for field in ("boxes", "labels", "scores") + (("masks",) if masks else ()):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def _seeded_frozen_bn(module, seed):
    """Nonzero FrozenBN buffers (a fold of identity statistics hides a wrong
    one)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.numel()
                for buf, value in ((m.weight, 1 + 0.1 * rng.normal(size=n)),
                                   (m.bias, 0.1 * rng.normal(size=n)),
                                   (m.running_mean, 0.1 * rng.normal(size=n)),
                                   (m.running_var, 0.5 + rng.random(n))):
                    buf.copy_(torch.from_numpy(value))


@pytest.fixture(scope="module")
def fp32(tmp_path_factory):
    """The live fp32 Predictor, its artifact's directory (buckets (64, 64)
    and (64, 128)) and the artifact loaded on the CPU, by a load that may
    construct no ``DETR``."""
    model = api.build_detr(device="cpu", seed=1, **CONFIG)
    _seeded_frozen_bn(model.module, 2)
    live = Predictor(model, background_class=0, bucket_divisor=64, score_threshold=0.1)
    path = str(tmp_path_factory.mktemp("fp32") / "artifact")
    export.export_predictor(live, path, SHAPES)
    with mock.patch.object(DETR, "__init__", side_effect=AssertionError("built a DETR")):
        loaded = export.load_predictor(path, device="cpu")
    return live, path, loaded


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    model = api.build_detr(device="cpu", masks=True, seed=3, **CONFIG)
    live = Predictor(model, background_class=0, bucket_divisor=64, masks=True,
                     score_threshold=0.0)
    path = str(tmp_path_factory.mktemp("masks") / "artifact")
    export.export_predictor(live, path, [(60, 90)])
    return live, export.load_predictor(path, device="cpu")


@pytest.fixture(scope="module")
def exported():
    """{variant: (live Predictor, {(bucket, masked): ExportedProgram})} for
    the variants exported without a round trip through files."""
    cache = {}

    def get(variant):
        if variant not in cache:
            model = api.build_detr(device="cpu", seed=4, **{**CONFIG, **VARIANTS[variant]})
            _seeded_frozen_bn(model.module, 5)
            if variant == "int8":
                x = torch.from_numpy(np.random.default_rng(6).normal(
                    size=(2, 64, 64, 3)).astype(np.float32))
                quantized.quantize_model(model, x)
            live = Predictor(model, background_class=0, bucket_divisor=64)
            cache[variant] = live, export.export_programs(live, [(64, 64)], batch=BATCH)
        return cache[variant]

    return get


def test_artifact_equals_live_predictor(fp32):
    """Mixed sizes; three images share the (64, 128) bucket (the batch is
    symbolic); (64, 64) fills its bucket, which the live model serves
    unmasked and the artifact through its masked program with every pixel
    valid."""
    live, _, loaded = fp32
    images = _images(1, [(60, 90), (64, 64), (50, 80), (33, 70)])
    _assert_equal_detections(loaded(images), live(images))
    assert loaded.buckets == {(64, 128), (64, 64)}
    assert loaded.exported_buckets == [(64, 64), (64, 128)]
    assert (loaded.score_threshold, loaded.bucket_divisor) == (0.1, 64)


def test_unknown_bucket_raises(fp32):
    loaded = fp32[2]
    with pytest.raises(ValueError, match=r"no exported program for bucket \(128, 256\)"):
        loaded(_images(2, [(100, 200)]))


def test_artifact_matches_jax_artifact(fp32, tmp_path):
    """The JAX package's artifact of the same weights (``to_jax_variables``,
    the inverse of ``from_jax_variables``) gives the same detections within
    the golden tolerances, at the (64, 128) bucket: padded images and one
    that fills it."""
    live = fp32[0]
    jax_model = JaxDetrModel(JaxDETR(**CONFIG), to_jax_variables(live.model.module.state_dict()))
    path = str(tmp_path / "jax_artifact")
    jax_export_predictor(JaxPredictor(jax_model, background_class=0, bucket_divisor=64,
                                      score_threshold=0.1), path, SHAPES[:1], platforms=("cpu",))
    images = _images(3, [(60, 90), (64, 128), (41, 77)])
    ours, ref = fp32[2](images), jax_load_predictor(path)(images)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        np.testing.assert_allclose(a.boxes, np.asarray(b.boxes), atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), atol=SCORE_ATOL, rtol=0)


def test_load_builds_no_model(fp32):
    """The artifact carries everything: the fixture loaded it with
    ``DETR.__init__`` raising; it holds weights, no module, and warms up."""
    live, _, loaded = fp32
    assert not hasattr(loaded.model, "module") and len(loaded.model.weights) > 100
    loaded.warmup([(64, 64), (60, 90)])
    assert {(64, 64), (64, 128)} <= loaded.buckets
    images = _images(4, [(61, 99)])
    _assert_equal_detections(loaded(images), live(images))


def test_bucket_programs_share_one_copy_of_the_weights(fp32):
    """weights.pt holds once every tensor that a program reads, and
    nothing else; each program file holds none of them; the loaded
    programs' parameters and buffers are one set of storages."""
    _, path, loaded = fp32
    weights_bytes = os.path.getsize(os.path.join(path, "weights.pt"))
    for bucket in loaded.exported_buckets:
        assert os.path.getsize(os.path.join(path, export.program_file(bucket, True))) \
            < weights_bytes / 10
    (_, first), (_, second) = sorted(loaded._programs.items())
    state = [dict(p.module.named_parameters()) | dict(p.module.named_buffers())
             for p in (first, second)]
    assert state[0].keys() == state[1].keys()
    assert len(state[0]) > 100
    for name, t in state[0].items():
        assert t.data_ptr() == state[1][name].data_ptr(), name
    saved = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
    read = set()
    for program in (first, second):
        read |= {n.target for n in program.module.graph.nodes if n.op == "get_attr"}
    assert saved.keys() == read & state[0].keys() and len(saved) > 100


def test_masks_artifact_equals_live_predictor(masks):
    live, loaded = masks
    images = _images(5, [(60, 90), (47, 66)])
    _assert_equal_detections(loaded(images), live(images), masks=True)
    assert loaded.masks and sum(len(d.masks) for d in loaded(images)) > 0


@pytest.mark.parametrize("variant", ["fp32", "masks"])
def test_loaded_graphs_call_the_ops(variant, fp32, masks):
    loaded = fp32[2] if variant == "fp32" else masks[1]
    for (_, masked), program in loaded._programs.items():
        assert op_counts(program.module.graph) == EXPECTED_OPS[variant, masked]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_exported_graphs_call_the_ops_and_equal_the_live_forward(variant, exported):
    """Each program calls the ``detr_torch`` ops at the reduced model's
    counts and computes what the live Predictor's forward does, bit for
    bit (fused: both programs)."""
    live, programs = exported(variant)
    assert sorted(programs) == ([((64, 64), False)] if variant == "fused" else []) \
        + [((64, 64), True)]
    frames = torch.from_numpy(np.stack(_images(7, [(64, 64)] * BATCH)))
    mask = torch.zeros((BATCH, 64, 64), dtype=torch.bool)
    mask[0], mask[1, :50, :40], mask[2, :64, :33] = True, True, True
    for (_, masked), ep in programs.items():
        assert op_counts(ep.graph) == EXPECTED_OPS[variant, masked]
        inputs = (frames, mask) if masked else (frames,)
        with torch.inference_mode():
            want = live.serve_forward(*inputs)[0]
            got = ep.module()(*inputs)
        for w, g in zip(want, got):
            assert torch.equal(w, g)


def test_bf16_graph_casts_no_parameter(exported):
    """A bf16 program reads its weights' bf16 copies as buffers derived
    once at export: no dtype cast takes a parameter, and the copies are
    state of the program, not computed per call. The float32 weights they
    were made from are not read, so an artifact does not save them.
    (``query_embed`` is cast after its batch expand on every call, as the
    live model casts it.)"""
    live, programs = exported("bf16 dc5")
    ep = programs[(64, 64), True]
    params = set(ep.graph_signature.inputs_to_parameters)
    casts = [n for n in ep.graph.nodes if n.op == "call_function"
             and n.target in (torch.ops.aten.to.dtype, torch.ops.aten._to_copy.default)]
    assert casts and not [n for n in casts if n.args[0].name in params]
    read = export.used_state(ep)
    for name, m in live.model.module.named_modules():
        if isinstance(m, torch.nn.Linear | torch.nn.Conv2d):
            assert name + ".weight" not in read, name
    operands = [name for name in ep.graph_signature.buffers if "._operand_" in name]
    # A weight and a bias of every Linear and Conv.
    assert len(operands) == sum(1 + (m.bias is not None) for m in live.model.module.modules()
                                if isinstance(m, torch.nn.Linear | torch.nn.Conv2d))
    assert all(ep.state_dict[name].dtype == torch.bfloat16 for name in operands)
    # Export leaves the live model as it was: no buffers added, caches at work.
    assert not [n for n, _ in live.model.module.named_buffers() if "_operand_" in n]


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    q, k, v = r(2, 5, 2, 32), r(2, 7, 2, 32), r(2, 7, 2, 32)
    kpm = torch.zeros(2, 7, dtype=torch.bool)
    kpm[1, 4:] = True
    cl = torch.channels_last
    x = r(2, 8, 6, 10).relu().contiguous(memory_format=cl)
    m, c = 16, 64
    scale, bias = r(c).abs() * 0.01, r(c)
    return {
        "mha_forward": [(q, k, v, kpm, None, 0.0, False), (q, k, v, None, None, 0.0, True),
                        (q.bfloat16(), k.bfloat16(), v.bfloat16(), kpm,
                         torch.tensor([7]), 0.1, True)],
        "max_pool_3x3_s2": [(x,), (x.bfloat16(),)],
        "conv1x1_bn_residual_relu": [
            (r(2, 16, 5, 6).contiguous(memory_format=cl), r(24, 16), r(24), r(24),
             r(2, 24, 5, 6).contiguous(memory_format=cl))],
        "fused_bottleneck": [
            (r(1, 32, 5, 6).contiguous(memory_format=cl), r(32, 16) * 0.1, r(16),
             r(9, 16, 16) * 0.1, r(16), r(16, 32) * 0.1, r(32))],
        "int8_matmul": [
            (i8(m, c), i8(c, c), scale, bias, None, None, None, None, None, None, True,
             torch.int8, True),
            (i8(m, c), i8(c, c), scale, bias, i8(m, c), torch.tensor(0.02), None, None, None,
             None, True, torch.bfloat16, False),
            (i8(m, c), i8(c, c), scale, bias, None, None, i8(m, c), i8(c, c), scale, bias, False,
             torch.int8, True)],
        "int8_conv3x3": [(i8(1, 6, 7, c), i8(16, 3, 3, c), r(16).abs() * 1e-3, r(16), s, True,
                          torch.int8, True) for s in (1, 2)],
    }


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    op = getattr(torch.ops.detr_torch, name).default
    for args in _opcheck_cases()[name]:
        torch.library.opcheck(op, args)


def test_serve_artifact_over_http(fp32, monkeypatch):
    """``python -m detr_tensorflow_tpu_torch.serve --artifact DIR --device
    cpu`` serves /detect from the artifact, at its score threshold (the
    fixture's load stands in for the one ``main`` makes)."""
    _, path, loaded = fp32
    servers, loads = [], []

    def load_predictor(*args, **kwargs):
        loads.append((args, kwargs))
        return loaded

    monkeypatch.setattr(export, "load_predictor", load_predictor)

    def make_server(service, host, port):
        servers.append(serve.ThreadingHTTPServer((host, port), serve.make_handler(service)))
        return servers[0]

    monkeypatch.setattr(serve, "make_server", make_server)
    thread = threading.Thread(target=serve.main, daemon=True, args=(
        ["--artifact", path, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"],))
    thread.start()
    for _ in range(600):
        if servers:
            break
        thread.join(timeout=0.1)
    url = f"http://127.0.0.1:{servers[0].server_address[1]}"
    try:
        img = _images(8, [(60, 90)])[0]
        buf = io.BytesIO()
        np.save(buf, img)
        req = urllib.request.Request(url + "/detect", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = json.loads(r.read())
        want = loaded([img])[0]
        assert [d["label"] for d in payload["detections"]] == want.labels.tolist()
        np.testing.assert_allclose([d["score"] for d in payload["detections"]], want.scores,
                                   rtol=0, atol=0)
        assert min(want.scores, default=1.0) >= 0.1
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert [64, 128] in json.loads(r.read())["buckets"]
    finally:
        servers[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert loads == [((path,), {"device": "cpu"})]
