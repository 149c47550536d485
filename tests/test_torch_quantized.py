"""The port's int8 backbone (ops/int8_matmul.py, ops/int8_conv.py,
models/quantized.py and DETR(backbone_quant=True)) against the JAX
package's, on the CPU: the Pallas kernels run in interpret mode, as
tests/test_quantized.py runs them, and the port's wrappers take their plain
versions. Inputs come from numpy seeds; both sides get the same int8
operands and fp32 scales, or the same fp32 weights and images.

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
from detr_tensorflow_tpu.ops.pallas import int8_conv as jax_conv
from detr_tensorflow_tpu.ops.pallas import int8_matmul as jax_mm
from detr_tensorflow_tpu.predictor import Predictor as JaxPredictor
from detr_tensorflow_tpu_torch.models import api, quantized as Q, resnet
from detr_tensorflow_tpu_torch.models.weights import from_jax_quant, from_jax_variables
from detr_tensorflow_tpu_torch.ops import int8_conv, int8_matmul
from detr_tensorflow_tpu_torch.predictor import Predictor
from test_torch_models import random_variables

DTYPES = {"int8": (jnp.int8, torch.int8), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0**-7  # bf16 keeps 8 significant bits: one ulp <= 2^-7 |v|


def t(x):
    return torch.from_numpy(np.array(x))


def assert_epilogue_match(ours, ref, out_dtype):
    """int8: integer-equal. bf16: within one bf16 ulp (the FMA note above)."""
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    if out_dtype == "int8":
        np.testing.assert_array_equal(ours, ref)
    else:
        assert (np.abs(ours - ref) <= BF16_ULP * np.abs(ref)).all()


def assert_within_one_lsb(a, b):
    assert int(np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32)).max()) <= 1


def _mm_operands(seed, m=105, c=64, k=48, cd=128):
    """int8 operands with the JAX package's weight layout (C, K); M = 105
    is a multiple of no tile (the JAX side runs 32-row tiles, the CUDA
    kernel 64-row ones)."""
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-128, 128, s, np.int8)  # noqa: E731
    return dict(x=i8(m, c), w=i8(c, k), s=rng.uniform(1e-4, 1e-2, k).astype(np.float32),
                b=rng.normal(size=k).astype(np.float32), res=i8(m, k), rs=np.float32(0.37),
                xd=i8(m, cd), wd=i8(cd, k), sd=rng.uniform(1e-4, 1e-2, k).astype(np.float32),
                bd=rng.normal(size=k).astype(np.float32))


def _jax_qmatmul(variant, o, **kw):
    if variant == "plain":
        return jax_mm.qmatmul(o["x"], o["w"], o["s"], o["b"], m_tile=32, **kw)
    if variant == "residual":
        return jax_mm.qmatmul_residual(o["x"], o["w"], o["s"], o["b"], o["res"], o["rs"],
                                       m_tile=32, **kw)
    return jax_mm.qmatmul_residual2(o["x"], o["w"], o["s"], o["b"], o["xd"], o["wd"], o["sd"],
                                    o["bd"], m_tile=32, **kw)


def _port_qmatmul(variant, o, **kw):
    x, w, s, b = t(o["x"]), t(o["w"].T), t(o["s"]), t(o["b"])  # weights K-major
    if variant == "plain":
        return int8_matmul.qmatmul(x, w, s, b, **kw)
    if variant == "residual":
        return int8_matmul.qmatmul_residual(x, w, s, b, t(o["res"]), t(o["rs"]), **kw)
    return int8_matmul.qmatmul_residual2(x, w, s, b, t(o["xd"]), t(o["wd"].T), t(o["sd"]),
                                         t(o["bd"]), **kw)


@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", ["plain", "residual", "residual2"])
def test_qmatmul_matches_jax(variant, relu, out_dtype):
    """Kernel F's three entry points with the precise (fp32) epilogue
    against JAX: int8 integer-equal, bf16 within one bf16 ulp; with a bf16
    output the bf16 epilogue too."""
    o = _mm_operands(seed=len(variant) + 2 * relu)
    jdt, pdt = DTYPES[out_dtype]
    ours = _port_qmatmul(variant, o, relu=relu, out_dtype=pdt)
    assert ours.dtype == pdt and ours.shape == (105, 48)
    assert_epilogue_match(ours, _jax_qmatmul(variant, o, relu=relu, out_dtype=jdt), out_dtype)
    if out_dtype == "bfloat16":
        fast = _port_qmatmul(variant, o, relu=relu, out_dtype=pdt, precise=False)
        jax_fast = _jax_qmatmul(variant, o, relu=relu, out_dtype=jdt, precise=False)
        assert_epilogue_match(fast, jax_fast, out_dtype)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", ["plain", "residual", "residual2"])
def test_qmatmul_bf16_epilogue_matches_jax(variant, relu):
    """``precise=False``, the TPU kernel's bf16 epilogue, int8 out: equal to
    JAX's under ReLU (the backbone's case) and within 1 LSB without (XLA
    keeps some bf16 intermediates in fp32 there). Away from the precise
    result it strays no further than JAX's own bf16 epilogue, which at
    these magnitudes (terms in the hundreds, where a bf16 ulp is 1 or 2)
    is several LSB for the residual sums of rounded terms."""
    o = _mm_operands(seed=len(variant) + 2 * relu)
    fast = _port_qmatmul(variant, o, relu=relu, precise=False).numpy().astype(np.int32)
    jax_fast = np.asarray(_jax_qmatmul(variant, o, relu=relu, precise=False), np.int32)
    assert np.abs(fast - jax_fast).max() <= (0 if relu else 1)
    ours = _port_qmatmul(variant, o, relu=relu).numpy().astype(np.int32)
    jax_precise = np.asarray(_jax_qmatmul(variant, o, relu=relu), np.int32)
    assert np.abs(fast - ours).max() <= np.abs(jax_fast - jax_precise).max()


def test_bf16_epilogue_within_one_lsb():
    """At the magnitudes of tests/test_quantized.py::test_fast_epilogue_within_one_lsb
    the bf16 epilogue stays within 1 LSB of the precise one."""
    rng = np.random.default_rng(0)
    x = t(rng.integers(-128, 128, (64, 32), np.int8))
    w = t(rng.integers(-128, 128, (32, 48), np.int8).T)
    s = t(rng.uniform(1e-4, 1e-2, 48).astype(np.float32))
    b = t(rng.normal(size=48).astype(np.float32))
    fast = int8_matmul.qmatmul(x, w, s, b, precise=False)
    assert_within_one_lsb(fast, int8_matmul.qmatmul(x, w, s, b))


def _conv_operands(seed, shape=(2, 13, 20, 64), k=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, shape, np.int8)
    w = rng.integers(-128, 128, (3, 3, shape[-1], k), np.int8)  # HWIO, as JAX
    s = rng.uniform(1e-4, 1e-2, k).astype(np.float32)
    b = rng.normal(size=k).astype(np.float32)
    return x, w, s, b


def _port_conv(x, w, s, b, **kw):
    return int8_conv.conv3x3_int8(t(x), t(w.transpose(3, 0, 1, 2)), t(s), t(b), **kw)


@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_stride1_matches_jax(relu, out_dtype):
    """Kernel G at stride 1 against the Pallas kernel (interpret) and the
    XLA int32 reference, on odd H and W."""
    x, w, s, b = _conv_operands(seed=3 + relu)
    jdt, pdt = DTYPES[out_dtype]
    ours = _port_conv(x, w, s, b, relu=relu, out_dtype=pdt)
    assert ours.shape == (2, 13, 20, 64) and ours.dtype == pdt
    for ref in (jax_conv.conv3x3_int8(x, w, s, b, relu=relu, out_dtype=jdt),
                jax_conv.reference_conv3x3_int8(x, w, s, b, relu=relu, out_dtype=jdt)):
        assert_epilogue_match(ours, ref, out_dtype)
    fast = _port_conv(x, w, s, b, relu=relu, out_dtype=pdt, precise=False)
    if out_dtype == "int8":
        assert_within_one_lsb(fast, ours)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_stride2_matches_xla(relu):
    """Kernel G at stride 2 against the strided convs of the JAX backbone:
    ``_conv3x3_int8_xla`` and the f32 epilogue of quant_backbone_forward."""
    x, w, s, b = _conv_operands(seed=5 + relu)
    acc = JQ._conv3x3_int8_xla(jnp.asarray(x), jnp.asarray(w), 2, 1)
    y = acc.astype(jnp.float32) * s + b
    ref = JQ._requant(jnp.maximum(y, 0) if relu else y)
    ours = _port_conv(x, w, s, b, stride=2, relu=relu)
    assert ours.shape == ref.shape == (2, 7, 10, 64)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_conv3x3_saturating_boundaries():
    """Accumulators large enough to clip both rails
    (tests/test_quantized.py::test_saturating_boundaries)."""
    rng = np.random.default_rng(0)
    x = np.full((1, 9, 9, 128), 127, np.int8)
    w = rng.choice(np.array([-127, 127], np.int8), (3, 3, 128, 8))
    s = np.full((8,), 1e-3, np.float32)
    ref = np.asarray(jax_conv.conv3x3_int8(x, w, s, relu=False, out_dtype=jnp.int8))
    ours = int8_conv.conv3x3_int8(t(x), t(w.transpose(3, 0, 1, 2)), t(s)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() == 127 and ours.min() == -128


def test_int8_wrappers_route_by_device():
    """CPU tensors take the plain versions; other devices raise."""
    x = torch.zeros((4, 64), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 64), dtype=torch.int8, device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no int8 matmul kernel"):
        int8_matmul.qmatmul(x, w, s, s)
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        int8_conv.conv3x3_int8(x.reshape(1, 2, 2, 64), torch.zeros((8, 3, 3, 64), dtype=torch.int8,
                                                                    device="meta"), s)
    before = int8_matmul.qmatmul.launches
    cpu = [torch.zeros(v.shape, dtype=v.dtype) for v in (x, w, s)]
    int8_matmul.qmatmul(*cpu, cpu[2])
    assert int8_matmul.qmatmul.launches == before  # the plain version launches nothing


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
    so ``quantize_model`` calibrates from fp32 weights; a bf16-cast backbone
    is refused."""
    model = api.build_detr(backbone_quant=True, dtype="bfloat16", device="cpu", **CONFIG)
    assert model.module.backbone.conv1.weight.dtype == torch.float32
    assert model.module.input_proj.weight.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32))
    Q.quantize_model(model, x)
    out = model(x[:1])
    assert out["pred_boxes"].shape == (1, 6, 4) and torch.isfinite(out["pred_logits"]).all()
    with pytest.raises(ValueError, match="fp32 backbone"):
        Q.calibrate_backbone(api.build_detr(dtype="bfloat16", device="cpu", **CONFIG)
                             .module.backbone, x)
