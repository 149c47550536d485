"""The port's instance-segmentation model (detr_tensorflow_tpu_torch/models/
segmentation.py, ``DETR(masks=True)``, the backbones' ``return_interm`` and
the segmentation checkpoint converter) against the JAX package's, on the
CPU.

Both sides get the same variables (a JAX tree of seeded numpy arrays
carried over with ``from_jax_variables``) and the same numpy inputs; the
JAX side runs ``attn_impl="xla"``, the port its plain versions. Models are
small: stage sizes (1, 1, 1, 1), D 32, 2 heads, one encoder and one decoder
layer, 6 queries, images 64x96 and an odd 70x100. Tolerances are stated at
each comparison.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import segmentation_state_dict
from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import quantized as JQ
from detr_tensorflow_tpu.models import segmentation as jax_seg
from detr_tensorflow_tpu.models import weights as jax_weights
from detr_tensorflow_tpu.models.resnet import ResNetBackbone as JaxResNetBackbone
from detr_tensorflow_tpu_torch.models import api, quantized, segmentation, weights
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.models.weights import from_jax_quant, from_jax_variables
from test_torch_bf16 import GAP_FACTOR
from test_torch_models import BOX_ATOL, GOLDEN_RTOL, LOGIT_ATOL, _pixel_mask, random_variables
from test_torch_quantized import _c5_agrees
from test_torch_weights import to_hf
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

SEG = dict(num_classes=7, num_queries=6, model_dim=32, num_heads=2, num_encoder_layers=1,
           num_decoder_layers=1, dim_feedforward=64, backbone_stage_sizes=(1, 1, 1, 1),
           masks=True)
MASK_ATOL = 1e-3  # pred_masks of the whole model, fp32
ATTN_MAP_ATOL, GN_ATOL, HEAD_ATOL, PADDING_ATOL = 1e-6, 1e-5, 1e-4, 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def _images(b, h, w, extents, seed):
    mask = _pixel_mask(b, h, w, extents)
    x = np.random.default_rng(seed).normal(size=(b, h, w, 3)) * mask[..., None]
    return x.astype(np.float32), mask


@pytest.mark.parametrize("hw,out", [((19, 25), (37, 50)), ((10, 13), (19, 25)),
                                    ((5, 7), (10, 13)), ((24, 20), (48, 40))])
def test_nearest_upsample_floor(hw, out):
    """The integer index map (i * H) // sh, equal to JAX's, at exact and
    non-exact stage ratios (148 px: 19 -> 10 at stride 8 -> 16)."""
    x = np.random.default_rng(0).normal(size=(3,) + hw + (4,)).astype(np.float32)
    ref = jax_seg.nearest_upsample_floor(jnp.asarray(x), *out)
    ours = segmentation.nearest_upsample_floor(t(x), *out)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_mh_attention_map_matches_jax(padded):
    """Softmax over heads and space jointly, with and without a key
    padding mask: to 1e-6."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 6, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 5, 7, 32)).astype(np.float32)
    kpm = np.zeros((2, 35), bool)
    kpm[1, 20:] = True
    jmod = jax_seg.MHAttentionMap(model_dim=32, num_heads=2)
    variables = random_variables(jmod, jnp.asarray(q), jnp.asarray(mem), seed=1)
    ref = jmod.apply(variables, jnp.asarray(q), jnp.asarray(mem),
                     key_padding_mask=jnp.asarray(kpm) if padded else None)
    port = segmentation.MHAttentionMap(32, 2)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    ours = port(t(q), t(mem), t(kpm) if padded else None)
    assert ours.shape == (2, 6, 2, 5, 7) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATTN_MAP_ATOL, rtol=0)


@pytest.mark.parametrize("with_valid", [False, True], ids=["plain", "valid"])
def test_masked_group_norm_matches_jax(with_valid):
    """Statistics over the valid cells only, counted per row: to 1e-5."""
    rng = np.random.default_rng(2)
    x = (3.0 + rng.normal(size=(4, 9, 11, 16))).astype(np.float32)
    valid = np.zeros((4, 9, 11), np.float32)
    for i, (vh, vw) in enumerate([(9, 11), (5, 7), (1, 2), (9, 4)]):
        valid[i, :vh, :vw] = 1
    jmod = jax_seg.MaskedGroupNorm(num_groups=8)
    variables = random_variables(jmod, jnp.asarray(x), seed=2)
    v = jnp.asarray(valid) if with_valid else None
    ref = jmod.apply(variables, jnp.asarray(x), valid=v)
    port = segmentation.MaskedGroupNorm(16, 8)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    ours = port(t(x), t(valid) if with_valid else None)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=GN_ATOL, rtol=0)


def test_mask_head_matches_jax():
    """The trunk on an odd 70x100 canvas with a pixel mask (two images,
    one padded): the split lay1, the adapters broadcast over queries, the
    masked GroupNorms and the re-zeroing. To 1e-4."""
    rng = np.random.default_rng(3)
    _, mask = _images(2, 70, 100, [(70, 100), (45, 61)], 3)
    shapes = {"c2": (18, 25, 256), "c3": (9, 13, 512), "c4": (5, 7, 1024)}
    fpn = {k: rng.normal(size=(2,) + s).astype(np.float32) for k, s in shapes.items()}
    proj = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    attn = rng.uniform(size=(2, 6, 2, 3, 4)).astype(np.float32)
    jmod = jax_seg.MaskHead(model_dim=32, num_heads=2)
    args = (jnp.asarray(proj), jnp.asarray(attn), jax.tree.map(jnp.asarray, fpn))
    variables = random_variables(jmod, *args, pixel_mask=jnp.asarray(mask), seed=3)
    ref = jax.jit(jmod.apply)(variables, *args, pixel_mask=jnp.asarray(mask))
    port = segmentation.MaskHead(32, 2)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port(t(proj), t(attn), {k: t(v) for k, v in fpn.items()}, t(mask))
    assert ours.shape == (2, 6, 18, 25) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=HEAD_ATOL, rtol=0)


def _jax_forward(cfg, variables, x, mask, dtype=jnp.float32):
    pm = None if mask is None else jnp.asarray(mask)
    return jax.jit(JaxDETR(dropout=0.0, attn_impl="xla", dtype=dtype, **cfg).apply)(
        variables, jnp.asarray(x), pm)


def _pair(cfg, x, mask, seed):
    """Seeded variables, the JAX fp32 outputs on (x, mask) and the port's
    fp32 model from the same variables."""
    variables = random_variables(JaxDETR(dropout=0.0, attn_impl="xla", **cfg), jnp.asarray(x),
                                 seed=seed)
    port = DETR(**cfg)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, _jax_forward(cfg, variables, x, mask), port.eval()


@pytest.fixture(scope="module")
def padded():
    """The padded case (an odd 70x100 canvas, one image at 45x61), shared
    by the fp32 and bf16 tests."""
    x, mask = _images(2, 70, 100, [(70, 100), (45, 61)], 4)
    return (x, mask) + _pair(SEG, x, mask, seed=4)


def _close_outputs(ours, ref):
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL),
                      ("pred_masks", MASK_ATOL)):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=atol,
                                   rtol=GOLDEN_RTOL, err_msg=key)


@pytest.mark.parametrize("case", ["padded", "exact", "dc5"])
def test_segm_detr_matches_jax(case, padded):
    """The whole segmentation DETR at fp32: padded (an odd 70x100 canvas,
    one image at 45x61), bucket-exact (64x96, no pixel mask) and DC5
    (stage sizes (1, 1, 1, 2), c4 and c5 at stride 16, masked). Boxes 5e-4
    and logits 5e-3 (the golden bounds), pred_masks 1e-3 (B, Q, H/4,
    W/4)."""
    if case == "padded":
        x, mask, _, ref, port = padded
    else:
        cfg = SEG if case == "exact" else dict(SEG, backbone_stage_sizes=(1, 1, 1, 2),
                                                dilation=True)
        h, w = (64, 96) if case == "exact" else (70, 100)
        x, mask = _images(2, h, w, [(h, w), (45, 61)], 5)
        mask = None if case == "exact" else mask
        _, ref, port = _pair(cfg, x, mask, seed=5)
    h, w = x.shape[1:3]
    with torch.no_grad():
        ours = port(t(x), None if mask is None else t(mask))
    assert ours["pred_masks"].shape == (2, 6, -(-h // 4), -(-w // 4))
    _close_outputs(ours, ref)


def test_segm_head_none_returns_masks():
    """The headless model returns pred_masks beside hs and memory, as the
    JAX one does."""
    cfg = dict(SEG, head="none")
    x, mask = _images(1, 64, 96, [(64, 96)], 5)
    model = DETR(**cfg).eval()
    with torch.no_grad():
        out = model(t(x), t(mask))
    assert set(out) == {"hs", "memory", "pred_masks"}
    assert out["pred_masks"].shape == (1, 6, 16, 24)


def test_padding_invariance():
    """A 45x61 image on a padded 70x100 canvas with its pixel mask against
    the image alone: boxes, logits and the masks on its valid 12x16
    stride-4 cells within 1e-4."""
    x, mask = _images(1, 70, 100, [(45, 61)], 6)
    model = DETR(**SEG).eval()
    api.init_weights(model, torch.Generator().manual_seed(6))
    with torch.no_grad():
        padded = model(t(x), t(mask))
        alone = model(t(x[:, :45, :61]))
    for key in ("pred_boxes", "pred_logits"):
        np.testing.assert_allclose(padded[key].numpy(), alone[key].numpy(), atol=PADDING_ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(padded["pred_masks"][..., :12, :16].numpy(),
                               alone["pred_masks"].numpy(), atol=PADDING_ATOL, rtol=0)


def test_bf16_segm_matches_jax(padded):
    """bf16 compute on float32 parameters against JAX ``DETR(dtype=
    bfloat16)`` with a pixel mask: each output no further from JAX fp32
    than GAP_FACTOR times JAX bf16's own distance; pred_masks float32."""
    x, mask, variables, ref32, _ = padded
    ref16 = _jax_forward(SEG, variables, x, mask, jnp.bfloat16)
    port = DETR(dtype=torch.bfloat16, **SEG)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port.eval()(t(x), t(mask))
    assert ours["pred_masks"].dtype == torch.float32
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    for key in ("pred_boxes", "pred_logits", "pred_masks"):
        j16, j32 = (np.asarray(r[key], np.float64) for r in (ref16, ref32))
        gap = float(np.abs(ours[key].numpy().astype(np.float64) - j32).max())
        assert gap <= GAP_FACTOR * float(np.abs(j16 - j32).max()), key


def test_int8_interm_matches_jax():
    """The int8 backbone's stage outputs (``return_interm``) from the JAX
    qtree against JAX ``quant_backbone_forward(return_interm=True)`` at
    fp32 compute: each stage in units of its last block's output quantum,
    as the int8 parity test holds c5. The int8 segm DETR runs them
    through the mask head."""
    stages = (1, 1, 1, 1)
    img = np.random.default_rng(8).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = random_variables(JaxResNetBackbone(stage_sizes=stages), jnp.asarray(img), seed=8)
    calib = jax.jit(functools.partial(JQ.calibrate_backbone, stage_sizes=stages))(
        variables, jnp.asarray(img))
    qtree = jax.device_get(jax.jit(functools.partial(JQ.quantize_backbone, stage_sizes=stages))(
        variables, calib))
    c5, interm = jax.jit(functools.partial(JQ.quant_backbone_forward, stage_sizes=stages,
                                           compute_dtype=jnp.float32, return_interm=True))(
        qtree, jnp.asarray(img))
    ours_c5, ours = quantized.quant_backbone_forward(from_jax_quant(qtree), t(img), stages,
                                                     compute_dtype=torch.float32,
                                                     return_interm=True)
    assert set(ours) == set(interm) == {"c2", "c3", "c4"}
    for s, key in enumerate(("c2", "c3", "c4", "c5")):
        quantum = float(qtree[f"layer{s + 1}"]["block_0"]["out_scale"])
        got, ref = (ours_c5, c5) if key == "c5" else (ours[key], interm[key])
        assert got.shape == ref.shape, key
        assert _c5_agrees(got, np.asarray(ref), quantum), key
    model = DETR(backbone_quant=True, **SEG).eval()
    quantized.quantize_model(model, t(img))
    with torch.no_grad():
        out = model(t(img))
    assert out["pred_masks"].shape == (2, 6, 16, 16)
    assert bool(torch.isfinite(out["pred_masks"]).all())


def _leaf_equal(ours, ref):
    flat_ours, flat_ref = (dict(weights._flatten(x)) for x in (ours, ref))
    assert set(flat_ours) == set(flat_ref)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_ours[k], np.asarray(v), err_msg="/".join(k))


SMALL_TRANSFORMER = dict(num_encoder_layers=1, num_decoder_layers=1, model_dim=32, num_heads=2,
                         dim_feedforward=64)


@pytest.mark.parametrize("naming", ["hf", "facebook"])
def test_convert_segmentation_checkpoint_matches_jax(naming):
    """``convert_torch_detr`` on narrow DETR-R50-segm state_dicts in HF
    DetrForSegmentation naming (the HF detector under ``detr.``, beside
    ``mask_head.*`` and ``bbox_attention.*``; ``tests/test_golden_torch.py``
    holds the JAX converter on a random-weight HF model) and in facebook's
    DETRsegm naming: the JAX converter's tree, leaf for leaf equal, with
    the mask head split into lay1_feats / lay1_attn; ``from_jax_variables``
    then ``to_jax_variables`` give the tree back. (Loading a full-width
    one into the port's masks model: the test below.)"""
    sd = segmentation_state_dict(seed=12, base=8, **SMALL_TRANSFORMER)
    if naming == "hf":
        detector = {k[len("detr."):]: v for k, v in sd.items() if k.startswith("detr.")}
        sd = dict({"detr." + k: v for k, v in to_hf(detector, 32).items()},
                  **{k: v for k, v in sd.items() if not k.startswith("detr.")})
    kw = dict(num_encoder_layers=1, num_decoder_layers=1, model_dim=32)
    ours = weights.convert_torch_detr(sd, **kw)
    _leaf_equal(ours, jax_weights.convert_torch_detr(sd, **kw))
    assert set(ours["params"]["mask_head"]) >= {"lay1_feats", "lay1_attn", "gn5", "adapter3"}
    _leaf_equal(weights.to_jax_variables(from_jax_variables(ours)), ours)


def test_build_detr_loads_segmentation_checkpoints(tmp_path):
    """``build_detr(masks=True, weights=.pth)`` loads a facebook DETRsegm
    file's mask head (DETR-R50's backbone, a one-layer D 32 transformer)
    with nothing missing or left over; a detection checkpoint (its
    detector alone) keeps the seeded mask head; a model without masks
    leaves the checkpoint's mask head unread. A masks model saved as
    ``.npz`` loads back bit-equal."""
    sd = segmentation_state_dict(seed=9, **SMALL_TRANSFORMER)
    path = str(tmp_path / "segm.pth")
    torch.save({"model": sd}, path)
    det_path = str(tmp_path / "det.pth")
    torch.save({"model": {k[len("detr."):]: v for k, v in sd.items() if k.startswith("detr.")}},
               det_path)
    kw = dict(device="cpu", **SMALL_TRANSFORMER)
    model = api.build_detr(weights=path, masks=True, **kw)
    got = model.module.mask_head.lay1_attn.weight.detach().numpy()
    np.testing.assert_array_equal(got, sd["mask_head.lay1.weight"].numpy()[:, 32:])
    np.testing.assert_array_equal(model.module.bbox_attention.q_proj.bias.detach().numpy(),
                                  sd["bbox_attention.q_linear.bias"].numpy())
    fresh = api.build_detr(masks=True, seed=3, **kw).module.mask_head.state_dict()
    det = api.build_detr(weights=det_path, masks=True, seed=3, **kw).module.mask_head
    assert all(torch.equal(v, det.state_dict()[k]) for k, v in fresh.items())
    plain = api.build_detr(weights=path, **kw).module
    assert not hasattr(plain, "mask_head")
    npz = str(tmp_path / "segm.npz")
    model.save(npz)
    back = api.build_detr(weights=npz, masks=True, seed=1, **kw)
    x = np.random.default_rng(10).normal(size=(1, 64, 64, 3)).astype(np.float32)
    a, b = model(t(x)), back(t(x))
    assert all(torch.equal(a[k], b[k]) for k in a)
