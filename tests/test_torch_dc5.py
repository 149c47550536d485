"""The DC5 family, remat and the small API gaps of the port
(detr_tensorflow_tpu_torch) against the JAX package, on the CPU.

DC5 (``dilation=True``) dilates the backbone's last stage: C5 at stride
16. Held here against the JAX package on the same seeded variables: the
backbone with and without a pixel mask, the DETR forward at fp32 and bf16,
the int8 backbone (its dilated 3x3s exact, outside kernel G) and one
training step; the fused DC5 model against the unfused one, with kernel E
kept off the dilated blocks; ``remat`` and ``backbone_remat`` against the
step without them (same gradients, same generator state); and
``get_model_inference``, ``get_losses``, ``pad_labels``, ``unpack_labels``
and the ``--dilation`` / ``--backbone_weights`` flags. Stage sizes (1, 1,
1, 2): the dilated stage has a ``block_0`` at stride 1 and one dilated
block. Tolerances are stated at each comparison.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu import inference as jax_inference
from detr_tensorflow_tpu.data import processing as jax_processing
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import quantized as JQ
from detr_tensorflow_tpu.models.resnet import ResNetBackbone as JaxResNetBackbone
from detr_tensorflow_tpu.ops import losses as jax_losses
from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
from detr_tensorflow_tpu.train import config as jax_config
from detr_tensorflow_tpu.train import optimizers as jax_opt
from detr_tensorflow_tpu_torch import inference
from detr_tensorflow_tpu_torch.data import processing
from detr_tensorflow_tpu_torch.models import api, quantized, resnet
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.models.weights import from_jax_quant, from_jax_variables
from detr_tensorflow_tpu_torch.ops import int8_conv, losses
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig, config as port_config
from test_torch_bf16 import FORWARD_ATOL, GAP_FACTOR
from test_torch_models import _pixel_mask, close, random_variables
from test_torch_training import LRS, make_batch

STAGES = (1, 1, 1, 2)
DILATE = (False, False, True)
DC5 = dict(num_classes=7, num_queries=10, model_dim=64, num_heads=2, num_encoder_layers=1,
           num_decoder_layers=2, dim_feedforward=128, backbone_stage_sizes=STAGES, dilation=True)
TINY_DC5 = dict(DC5, num_classes=5, num_queries=6, dim_feedforward=32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_dc5_backbone_matches_jax(masked):
    """C5 at stride 16 (5x6 for 70x90), to the modules' 1e-4; with a pixel
    mask the validity follows the stride-16 map."""
    rng = np.random.default_rng(1)
    mask = _pixel_mask(2, 70, 90, [(70, 90), (45, 61)])
    x = (rng.normal(size=(2, 70, 90, 3)) * mask[..., None]).astype(np.float32)
    jmod = JaxResNetBackbone(stage_sizes=STAGES, replace_stride_with_dilation=DILATE)
    variables = random_variables(jmod, jnp.asarray(x), seed=1)
    pm = jnp.asarray(mask) if masked else None
    ref = jmod.apply(variables, jnp.asarray(x), pixel_mask=pm)
    port = resnet.ResNetBackbone(STAGES, replace_stride_with_dilation=DILATE)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port.eval()(t(x), t(mask) if masked else None)
    assert ours.shape == (2, 2048, 5, 6) and ref.shape == (2, 5, 6, 2048)
    close(ours.permute(0, 2, 3, 1), ref)


def test_dc5_detr_builds_at_r50_and_r101():
    """DETR-R50-DC5 and R101-DC5: the last stage's ``block_0`` at stride 1
    undilated (its shortcut at stride 1), every later block at dilation 2
    and padding 2; the other stages as without DC5."""
    for depth, n_last in ((50, 3), (101, 3)):
        model = DETR(backbone_depth=depth, dilation=True, num_encoder_layers=0,
                     num_decoder_layers=1)
        layer4, layer3 = model.backbone.layer4, model.backbone.layer3
        assert layer4.block_0.conv2.stride == (1, 1) and layer4.block_0.conv2.dilation == (1, 1)
        assert layer4.block_0.downsample_conv.stride == (1, 1)
        for i in range(1, n_last):
            conv2 = getattr(layer4, f"block_{i}").conv2
            assert conv2.dilation == (2, 2) and conv2.padding == (2, 2)
        assert layer3.block_0.conv2.stride == (2, 2) and layer3.block_1.conv2.dilation == (1, 1)


def _forward_pair(dtype, seed=3):
    rng = np.random.default_rng(seed)
    mask = _pixel_mask(2, 96, 160, [(96, 160), (70, 101)])
    x = (rng.normal(size=(2, 96, 160, 3)) * mask[..., None]).astype(np.float32)
    jmod = JaxDETR(dropout=0.0, attn_impl="xla", **DC5)
    variables = random_variables(jmod, jnp.asarray(x), seed=seed)
    refs = {dt: jax.jit(JaxDETR(dropout=0.0, attn_impl="xla", dtype=dt, **DC5).apply)(
        variables, jnp.asarray(x), jnp.asarray(mask)) for dt in (jnp.float32, dtype)}
    model = DETR(dtype={jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype], **DC5)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        ours = model.eval()(t(x), t(mask))
    return ours, refs[dtype], refs[jnp.float32]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
def test_dc5_detr_forward_matches_jax(dtype):
    """The DC5 DETR with a pixel mask (a 6x10 map, 60 keys). fp32: every
    decoder layer's boxes and logits within the golden tolerances (5e-4,
    5e-3). bf16 (float32 parameters): within the bf16 test's direct bounds
    of JAX bf16, and no further from JAX fp32 than GAP_FACTOR times JAX
    bf16's own distance."""
    ours, ref, ref32 = _forward_pair(dtype)
    for key in ("pred_boxes", "pred_logits", "aux_boxes", "aux_logits"):
        got = ours[key].numpy().astype(np.float64)
        if dtype == jnp.float32:
            atol = 5e-4 if "boxes" in key else 5e-3
            np.testing.assert_allclose(got, np.asarray(ref[key]), atol=atol, rtol=1e-3,
                                       err_msg=key)
            continue
        j16, j32 = (np.asarray(r[key], np.float64) for r in (ref, ref32))
        assert float(np.abs(got - j16).max()) <= FORWARD_ATOL[key.replace("aux", "pred")], key
        assert float(np.abs(got - j32).max()) <= GAP_FACTOR * float(np.abs(j16 - j32).max()), key


def test_dilated_int8_conv_is_exact():
    """The dilated 3x3 outside kernel G (taps gathered, ``torch._int_mm``):
    its int32 sums equal the float64 convolution's and XLA's int8
    convolution at dilation 2 (JAX ``_conv3x3_int8_xla``), and its int8
    output the JAX package's epilogue on them, at saturating inputs too."""
    rng = np.random.default_rng(4)
    for n, h, w in ((2, 7, 9, ), (1, 3, 4)):  # 126 rows, and 12 (padded to 17)
        x = rng.integers(-128, 128, size=(n, h, w, 64), dtype=np.int8)
        x[0, 0, :2] = -128
        wt = rng.integers(-127, 128, size=(3, 3, 64, 24), dtype=np.int8)  # HWIO
        s = rng.uniform(1e-4, 2e-4, size=24).astype(np.float32)
        b = rng.normal(size=24).astype(np.float32)
        w_port = t(wt).permute(3, 0, 1, 2).contiguous()
        acc = JQ._conv3x3_int8_xla(jnp.asarray(x), jnp.asarray(wt), 1, 2)
        ours = int8_conv.dilated_conv3x3_int32(t(x), w_port, 2)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(acc))
        np.testing.assert_array_equal(ours.double().numpy(),
                                      int8_conv._int_conv3x3(t(x), w_port, 1, 2).numpy())
        ref = JQ._requant(jnp.maximum(acc.astype(jnp.float32) * s + b, 0))
        y = int8_conv.dilated_conv3x3_int8(t(x), w_port, t(s), t(b), dilation=2, relu=True)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
        plain = int8_conv.reference_dilated_conv3x3_int8(t(x), w_port, t(s), t(b), dilation=2,
                                                         relu=True)
        assert torch.equal(y, plain)


def test_dc5_int8_backbone_matches_jax():
    """The JAX package's calibration, quantization and int8 forward with
    ``dilation=True`` (Pallas kernels in interpret mode, fp32 compute):
    the port's calibration of the same fp32 backbone to rtol 1e-5, and its
    int8 forward from the JAX qtree bit-equal (c5 is the last block's int8
    activations times one scale)."""
    img = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = JaxResNetBackbone(stage_sizes=STAGES, replace_stride_with_dilation=DILATE)
    variables = random_variables(jmod, jnp.asarray(img), seed=7)
    kw = dict(stage_sizes=STAGES, dilation=True)
    calib = jax.jit(functools.partial(JQ.calibrate_backbone, **kw))(variables, jnp.asarray(img))
    qtree = jax.jit(functools.partial(JQ.quantize_backbone, **kw))(variables, calib)
    c5 = jax.jit(functools.partial(JQ.quant_backbone_forward, compute_dtype=jnp.float32, **kw))(
        qtree, jnp.asarray(img))
    port = resnet.ResNetBackbone(STAGES, replace_stride_with_dilation=DILATE)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    ours_calib = quantized.calibrate_backbone(port.eval(), t(img))
    for name, ref in jax.tree_util.tree_flatten_with_path(calib)[0]:
        keys = [p.key for p in name]
        got = functools.reduce(lambda d, k: d[k], keys, ours_calib)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=str(keys))
    before = int8_conv.dilated_conv3x3_int8.calls
    ours = quantized.quant_backbone_forward(from_jax_quant(jax.device_get(qtree)), t(img),
                                            STAGES, compute_dtype=torch.float32, dilation=True)
    assert int8_conv.dilated_conv3x3_int8.calls - before == 1
    assert ours.shape == (2, 4, 4, 2048)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(c5))


def test_dc5_train_step_matches_jax():
    """One fp32 ``Trainer.step`` of the DC5 DETR at dropout 0 against the
    JAX loss and gradients on the same variables and batch: loss and log to
    rtol 1e-5, every per-tensor clipped gradient within 1e-3 of its norm
    (+1e-6), as ``test_torch_training``'s step test. JAX runs in float64
    (``jax.enable_x64``): on this batch the fp32 JAX step's stem gradient
    lies 1.0e-2 of its norm from float64's, the port's 1.5e-6 (the fp32
    JAX result depends on the machine XLA compiles for, ``test_torch_
    training``'s three-step test)."""
    cfg = dict(TINY_DC5, num_decoder_layers=1)
    jmodel = JaxDETR(dropout=0.0, attn_impl="xla", **cfg)
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)), seed=2)
    batch = make_batch(1)
    with jax.enable_x64(True):
        as64 = lambda a: jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)  # noqa: E731
        v64 = jax.tree.map(lambda a: as64(np.asarray(a)), variables)
        jb = {k: as64(v) for k, v in batch.items()}
        j64 = JaxDETR(dropout=0.0, attn_impl="xla", dtype=jnp.float64, **cfg)

        def loss_fn(params):
            out = j64.apply({"params": params, "frozen": v64["frozen"]}, jb["images"],
                            train=True)
            return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], 0)

        (jtotal, jlog), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jclipped = from_jax_variables(jax.device_get(
            {"params": jax_opt.clip_by_leaf_norm(0.1).update(jgrads, None)[0]}))
        jtotal, jlog = float(jtotal), {k: float(v) for k, v in jlog.items()}
    model = DETR(dropout=0.0, **cfg)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None,
                            **LRS)
    log = Trainer(model, config, seed=0).step(batch)
    np.testing.assert_allclose(float(log["total_loss"]), jtotal, rtol=1e-5)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(log[key]), value, rtol=1e-5, atol=1e-6, err_msg=key)
    for name, p in model.named_parameters():
        ref = jclipped[name]
        assert float((p.grad - ref).norm()) <= 1e-3 * float(ref.norm()) + 1e-6, name


def test_fused_dc5_keeps_e_off_dilated_blocks(monkeypatch):
    """The fused DC5 model (stages (2, 2, 2, 3)) equals the unfused one
    (fp32, rtol 1e-5 of the largest value): bucket-exact, kernel E runs on
    the three undilated identity blocks only and kernel D on the other six
    tails (the four ``block_0`` and the two dilated blocks); masked, D on
    all nine and E on none."""
    calls = {"E": 0, "D": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(resnet, "fused_bottleneck", counting("E", resnet.fused_bottleneck))
    monkeypatch.setattr(resnet, "conv1x1_bn_residual_relu",
                        counting("D", resnet.conv1x1_bn_residual_relu))
    stages = (2, 2, 2, 3)
    jmod = JaxResNetBackbone(stage_sizes=stages, replace_stride_with_dilation=DILATE)
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    state = from_jax_variables(random_variables(jmod, jnp.asarray(x), seed=2))
    models = {}
    for fused in (False, True):
        m = resnet.ResNetBackbone(stages, fused, fused, replace_stride_with_dilation=DILATE)
        m.load_state_dict(state, strict=True)
        models[fused] = m.eval()
    mask = t(_pixel_mask(1, 64, 64, [(50, 40)]))
    for pm, expected in ((None, {"E": 3, "D": 6}), (mask, {"E": 0, "D": 9})):
        calls.update(E=0, D=0)
        with torch.inference_mode():
            ours, ref = models[True](t(x), pm), models[False](t(x), pm)
        assert calls == expected
        assert float((ours - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("remat, backbone_remat", [(True, 0), (False, 2), (True, 4)],
                         ids=["transformer", "backbone", "both"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_gradients_and_generator(remat, backbone_remat, dtype):
    """A DC5 training forward and backward at dropout 0.1: with ``remat``
    (each encoder and decoder layer recomputed, its dropout draws replayed)
    and ``backbone_remat`` (the leading stages recomputed) the loss and
    every gradient are bit-equal to the run without, and the generator ends
    in the same state."""
    batch = make_batch(3)
    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None)
    results = []
    for kw in ({}, dict(remat=remat, backbone_remat=backbone_remat)):
        model = api.build_detr(seed=1, device="cpu", dtype=dtype, dropout=0.1,
                               attn_impl="kernel", **TINY_DC5, **kw).module
        generator = torch.Generator().manual_seed(5)
        out = model(t(batch["images"]), train=True, generator=generator)
        total, _ = losses.detr_loss(out, t(batch["boxes"]), t(batch["classes"]),
                                    t(batch["mask"]), 0)
        total.backward()
        results.append((total.detach(), {n: p.grad for n, p in model.named_parameters()},
                        generator.get_state()))
    (loss0, grads0, state0), (loss1, grads1, state1) = results
    assert torch.equal(loss0, loss1) and torch.equal(state0, state1)
    assert grads0.keys() == grads1.keys()
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name


def test_get_model_inference_matches_jax():
    rng = np.random.default_rng(0)
    out = {"pred_logits": rng.normal(size=(2, 10, 7)).astype(np.float32),
           "pred_boxes": rng.uniform(0.1, 0.9, size=(2, 10, 4)).astype(np.float32)}
    for fmt in ("xy_center", "xyxy", "yxyx"):
        ref = jax_inference.get_model_inference({k: jnp.asarray(v) for k, v in out.items()}, 0,
                                                fmt)
        ours = inference.get_model_inference({k: t(v) for k, v in out.items()}, 0, fmt)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_pad_and_unpack_labels_match_jax():
    """The reference's header-row layout, in and out, equal to JAX's."""
    rng = np.random.default_rng(1)
    images = rng.normal(size=(8, 8, 3)).astype(np.float32)
    rows = []
    for n in (0, 3, 12):
        boxes, classes = rng.uniform(size=(n, 4)), rng.integers(1, 9, size=n)
        ref = jax_processing.pad_labels(images, boxes, classes, max_targets=10)
        ours = processing.pad_labels(images, boxes, classes, max_targets=10)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        rows.append(ours[1:])
    t_bbox, t_class = (np.stack(r) for r in zip(*rows))
    for cls in (t_class, t_class[..., 0]):
        ref = jax_processing.unpack_labels(t_bbox, cls)
        ours = processing.unpack_labels(t(t_bbox), t(cls))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_get_losses_matches_jax():
    """The reference-signature loss on the header layout with the aux
    outputs as the reference's list of dicts: total and every log key to
    rtol 1e-5."""
    rng = np.random.default_rng(2)
    b, q, c = 2, 8, 6
    out = {"pred_logits": rng.normal(size=(b, q, c)), "pred_boxes": rng.uniform(0.2, 0.8, (b, q, 4)),
           "aux": [{"pred_logits": rng.normal(size=(b, q, c)),
                    "pred_boxes": rng.uniform(0.2, 0.8, (b, q, 4))} for _ in range(2)]}
    labels = [processing.pad_labels(None, np.concatenate(
        [rng.uniform(0.3, 0.7, (n, 2)), rng.uniform(0.1, 0.3, (n, 2))], -1),
        rng.integers(1, c, size=n), max_targets=q)[1:] for n in (2, 5)]
    t_bbox, t_class = (np.stack(r) for r in zip(*labels))
    config = TrainingConfig(background_class=0)
    as32 = lambda f: lambda v: f(np.asarray(v, np.float32))  # noqa: E731
    ref_total, ref_log = jax.jit(lambda o, tb, tc: jax_losses.get_losses(o, tb, tc, config))(
        jax.tree.map(as32(jnp.asarray), out), jnp.asarray(t_bbox), jnp.asarray(t_class))
    total, log = losses.get_losses(jax.tree.map(as32(t), out), t(t_bbox), t(t_class), config)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    assert set(log) == set(ref_log)
    for key, value in ref_log.items():
        np.testing.assert_allclose(float(log[key]), float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_dilation_and_backbone_weights_flags_parse_as_in_jax():
    """``--dilation`` and ``--backbone_weights`` give the JAX parser's
    config fields, and ``get_detr_model`` builds DC5 from the config."""
    argv = ["--dilation", "--backbone_weights", "resnet50.pth", "--backbone_depth", "101"]
    ref = jax_config.TrainingConfig().update_from_args(
        jax_config.training_config_parser().parse_args(argv))
    ours = port_config.TrainingConfig().update_from_args(
        port_config.training_config_parser().parse_args(argv))
    for field in ("dilation", "backbone_weights", "backbone_depth"):
        assert getattr(ours, field) == getattr(ref, field), field
    plain = port_config.TrainingConfig().update_from_args(
        port_config.training_config_parser().parse_args([]))
    assert plain.dilation is False and plain.backbone_weights is None
    model = api.get_detr_model(ours.replace(backbone_weights=None, backbone_depth=50),
                               include_top=True, device="cpu", **{
                                   k: v for k, v in DC5.items() if k != "dilation"})
    assert model.module.dilation and model.module.backbone.layer4.block_1.conv2.dilation == (2, 2)
