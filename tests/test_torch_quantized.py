"""The port's int8 backbone (models/quantized.py and
DETR(backbone_quant=True), on the kernels of ops/int8_matmul.py and
ops/int8_conv.py, whose wrappers tests/test_torch_quantized_kernels.py
holds) against the JAX package's, on the CPU: the Pallas kernels run in
interpret mode, as tests/test_quantized.py runs them, and the port's
wrappers take their plain versions. Inputs come from numpy seeds; both
sides get the same fp32 weights and images.

XLA on the CPU contracts ``acc*s + b`` (and ``y + acc_d*s_d``) into fused
multiply-adds; the port rounds each product and sum on its own, as the TPU
kernel's code is written. The two fp32 epilogues therefore differ by an ulp
now and then: int8 results agree unless a value lies within that ulp of a
rounding boundary (none in these inputs), bf16 results within one bf16 ulp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.models import build_detr as jax_build_detr
from detr_tensorflow_tpu.models import quantized as JQ
from detr_tensorflow_tpu.models import weights as jax_weights
from detr_tensorflow_tpu.models.api import DetrModel as JaxDetrModel
from detr_tensorflow_tpu.models.resnet import ResNetBackbone as JaxResNetBackbone
from detr_tensorflow_tpu.predictor import Predictor as JaxPredictor
from detr_tensorflow_tpu_torch.models import api, quantized as Q, resnet
from detr_tensorflow_tpu_torch.models.weights import from_jax_quant, from_jax_variables
from detr_tensorflow_tpu_torch.predictor import Predictor
from test_torch_models import random_variables
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Calibration, quantization and the int8 backbone, from the same fp32 weights
# ---------------------------------------------------------------------------

STAGES = (2, 2, 2, 2)  # two blocks per stage: both conv3 variants run


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def tiny():
    """A (2,2,2,2) backbone with seeded non-trivial FrozenBN statistics, on
    both sides, and the JAX package's calibration, qtree and c5 (Pallas
    kernels in interpret mode, fp32 compute)."""
    img = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = random_variables(JaxResNetBackbone(stage_sizes=STAGES), jnp.asarray(img), seed=7)
    calib = jax.jit(functools.partial(JQ.calibrate_backbone, stage_sizes=STAGES))(
        variables, jnp.asarray(img))
    qtree = jax.jit(functools.partial(JQ.quantize_backbone, stage_sizes=STAGES))(variables, calib)
    c5 = jax.jit(functools.partial(JQ.quant_backbone_forward, stage_sizes=STAGES,
                                   compute_dtype=jnp.float32))(qtree, jnp.asarray(img))
    port = resnet.ResNetBackbone(STAGES)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return dict(img=img, calib=jax.tree.map(np.asarray, calib),
                qtree=jax.tree.map(np.asarray, qtree), c5=np.asarray(c5), port=port.eval())


def test_calibration_matches_jax(tiny):
    """Every abs-max of the instrumented fp32 forward, to rtol 1e-5
    (summation order of the fp32 convolutions)."""
    ours = dict(_flat(Q.calibrate_backbone(tiny["port"], t(tiny["img"]))))
    ref = dict(_flat(tiny["calib"]))
    assert set(ours) == set(ref) and len(ref) == 1 + 3 * sum(STAGES)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_quantization_matches_jax(tiny):
    """From the JAX calibration: int8 weights equal, multipliers (m*) to
    rtol 1e-6 (an ulp or two of rsqrt and the FMAs), biases (b*, a
    difference of two terms, hence cancellation) to 1e-6 of the tensor's
    largest value, scales equal."""
    ours = Q.quantize_backbone(tiny["port"], jax.tree.map(t, tiny["calib"]))
    ref = from_jax_quant(tiny["qtree"])
    assert set(ours) == set(ref) == set(Q.qtree_shapes(STAGES))
    flips = 0
    for k, r in ref.items():
        o = ours[k]
        assert o.dtype == r.dtype and o.shape == r.shape, k
        leaf = k.split(".")[-1]
        if r.dtype == torch.int8:
            flips += int((o != r).sum())  # a weight at a .5 rounding boundary
        elif leaf.startswith("m"):
            torch.testing.assert_close(o, r, rtol=1e-6, atol=0, msg=k)
        elif leaf.startswith("b") and not k.startswith("stem"):
            assert float((o - r).abs().max()) <= 1e-6 * float(r.abs().max()), k
        else:
            torch.testing.assert_close(o, r, rtol=0, atol=0, msg=k)
    assert flips == 0


def _c5_agrees(ours, ref, quantum):
    """The int8 chain's result, in units of the last block's output
    quantum: equal up to rounding flips, i.e. no element off by more than
    one quantum and at most 0.1% of them off by one."""
    off = np.abs(np.asarray(ours) - ref) / quantum
    return off.max() <= 1.0 + 1e-3 and (off > 0.5).mean() <= 1e-3


def test_int8_backbone_matches_jax(tiny):
    """The JAX qtree carried across (from_jax_quant): c5 against JAX
    quant_backbone_forward(use_pallas=True) at fp32 compute. A mutated
    requantization scale (the last identity block's in_scale x 1.01) fails
    the same check."""
    qtree = from_jax_quant(tiny["qtree"])
    quantum = float(tiny["qtree"]["layer4"]["block_1"]["out_scale"])
    ours = Q.quant_backbone_forward(qtree, t(tiny["img"]), STAGES, compute_dtype=torch.float32)
    assert ours.shape == (2, 2, 2, 2048) and ours.dtype == torch.float32
    assert _c5_agrees(ours, tiny["c5"], quantum)
    mutated = dict(qtree, **{"layer4.block_1.in_scale": qtree["layer4.block_1.in_scale"] * 1.01})
    bad = Q.quant_backbone_forward(mutated, t(tiny["img"]), STAGES, compute_dtype=torch.float32)
    assert not _c5_agrees(bad, tiny["c5"], quantum)


def test_padded_equals_exact_in_int8(tiny):
    """Bucket padding with a pixel mask is bit-exact in the int8 domain
    (tests/test_quantized.py::test_exact_padding_invariance)."""
    qtree = Q.quantize_backbone(tiny["port"], Q.calibrate_backbone(tiny["port"], t(tiny["img"])))
    out = Q.quant_backbone_forward(qtree, t(tiny["img"]), STAGES, compute_dtype=torch.float32)
    pad = torch.zeros((2, 96, 96, 3))
    pad[:, :64, :64] = t(tiny["img"])
    mask = torch.zeros((2, 96, 96), dtype=torch.bool)
    mask[:, :64, :64] = True
    padded = Q.quant_backbone_forward(qtree, pad, STAGES, pixel_mask=mask,
                                      compute_dtype=torch.float32)
    assert torch.equal(padded[:, :2, :2], out)


def test_fidelity_vs_fp32(tiny):
    """The port's own PTQ against its fp32 backbone: mean relative error
    < 0.10 and correlation > 0.99 (tests/test_quantized.py's bounds)."""
    port = tiny["port"]
    img = t(tiny["img"])
    qtree = Q.quantize_backbone(port, Q.calibrate_backbone(port, img))
    out = Q.quant_backbone_forward(qtree, img, STAGES, compute_dtype=torch.float32).numpy()
    with torch.no_grad():
        ref = port(img).permute(0, 2, 3, 1).numpy()
    rel = np.abs(out - ref).mean() / np.abs(ref).mean()
    corr = np.corrcoef(ref.ravel(), out.ravel())[0, 1]
    assert rel < 0.10, rel
    assert corr > 0.99, corr


# ---------------------------------------------------------------------------
# DETR(backbone_quant=True) through Predictor
# ---------------------------------------------------------------------------

CONFIG = dict(num_classes=5, num_queries=6, head="detr", backbone_stage_sizes=(1, 1, 1, 1),
              model_dim=64, num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
              dim_feedforward=64)
# Same fp32 weights and qtree on both sides; the int8 features agree up to
# rounding flips, and the fp32 transformer as in tests/test_torch_serving.py.
BOX_ATOL, SCORE_ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def int8_detr():
    jax_fp32 = jax_build_detr(image_size=(64, 64), seed=1, **CONFIG)
    calib = np.random.default_rng(9).normal(size=(2, 64, 96, 3)).astype(np.float32)
    quantize = jax.jit(functools.partial(JQ.quantize_model, stage_sizes=(1, 1, 1, 1)))
    qvars = quantize(jax_fp32.variables, jnp.asarray(calib))
    jax_model = JaxDetrModel(jax_fp32.module.clone(backbone_quant=True), qvars)
    port = api.build_detr(backbone_quant=True, device="cpu", **CONFIG)
    port.module.load_state_dict(from_jax_variables(jax_fp32.variables), strict=True)
    port.module.backbone_quant.load(from_jax_quant(jax.device_get(qvars["quant"]["backbone"])))
    return jax_model, port, qvars


def test_int8_detr_predictor_matches_jax(int8_detr):
    jax_model, port, _ = int8_detr
    images = [np.random.default_rng(2).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in [(60, 90), (50, 128)]]  # one 64x128 bucket, two masks
    ref = JaxPredictor(jax_model, background_class=0, bucket_divisor=64)(images)
    ours = Predictor(port, background_class=0, bucket_divisor=64)(images)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
        np.testing.assert_allclose(a.boxes, np.asarray(b.boxes), atol=BOX_ATOL, rtol=0)
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), atol=SCORE_ATOL, rtol=0)


def test_int8_npz_loads_into_build_detr(int8_detr, tmp_path):
    """``build_detr(weights=npz, backbone_quant=True)`` reads the archive
    the JAX package's ``save_variables_npz`` writes of ``quantize_model``'s
    output: the same buffers, the same outputs."""
    _, port, qvars = int8_detr
    path = str(tmp_path / "int8.npz")
    jax_weights.save_variables_npz(jax.device_get(qvars), path)
    loaded = api.build_detr(weights=path, backbone_quant=True, device="cpu", **CONFIG)
    ours = dict(loaded.module.backbone_quant.named_buffers())
    ref = dict(port.module.backbone_quant.named_buffers())
    assert set(ours) == set(ref)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32))
    assert torch.equal(loaded(x)["pred_boxes"], port(x)["pred_boxes"])


def test_int8_detr_needs_quantized_weights():
    model = api.build_detr(backbone_quant=True, device="cpu", **CONFIG)
    x = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="quantized backbone"):
        model(x)
    with pytest.raises(ValueError, match="backbone_quant=True"):
        Q.quantize_model(api.build_detr(device="cpu", **CONFIG), x)


def test_bf16_build_keeps_the_fp32_backbone_for_calibration():
    """A bf16 model built with backbone_quant=True keeps its fp32 backbone,
    so ``quantize_model`` calibrates from fp32 weights. Every parameter is
    float32 at every compute dtype, so a bf16 build without backbone_quant
    calibrates exactly as the fp32 build of the same seed; a backbone cast
    to bf16 by hand is refused."""
    model = api.build_detr(backbone_quant=True, dtype="bfloat16", device="cpu", **CONFIG)
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32))
    Q.quantize_model(model, x)
    out = model(x[:1])
    assert out["pred_boxes"].shape == (1, 6, 4) and torch.isfinite(out["pred_logits"]).all()
    bf16 = api.build_detr(dtype="bfloat16", device="cpu", **CONFIG).module.backbone
    fp32 = api.build_detr(device="cpu", **CONFIG).module.backbone
    a, b = Q.calibrate_backbone(bf16, x), Q.calibrate_backbone(fp32, x)
    assert torch.equal(a["stem_out"], b["stem_out"])
    assert torch.equal(a["layer4"]["block_0"]["out"], b["layer4"]["block_0"]["out"])
    with pytest.raises(ValueError, match="fp32 backbone"):
        Q.calibrate_backbone(bf16.to(torch.bfloat16), x)
