"""The port's model modules (detr_tensorflow_tpu_torch/models) against the
JAX package's, module by module and as a whole DETR.

Both sides get the same variables: a JAX variables tree of seeded numpy
arrays, carried to the port with ``from_jax_variables``. Inputs come from
``np.random.default_rng``. Tolerances are stated at each comparison.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.models import detr as jax_detr
from detr_tensorflow_tpu.models import layers as jax_layers
from detr_tensorflow_tpu.models import position as jax_position
from detr_tensorflow_tpu.models import resnet as jax_resnet
from detr_tensorflow_tpu.models import transformer as jax_transformer
from detr_tensorflow_tpu.models import weights as jax_weights
from detr_tensorflow_tpu_torch.models import api, detr, layers, position, resnet, transformer
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables, load_variables_npz

MODULE_ATOL = MODULE_RTOL = 1e-4
# Golden tolerances of tests/test_golden_torch.py (full-depth fp32 parity).
BOX_ATOL, LOGIT_ATOL, GOLDEN_RTOL = 5e-4, 5e-3, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_variables(module, *args, seed=0, **kwargs):
    """A variables tree of ``module``'s shapes filled from a numpy seed:
    conv/dense kernels ~ N(0, 1/fan_in), biases and LayerNorm/FrozenBN
    affines near their identity, running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "running_var":
            x = rng.uniform(0.5, 1.5, size=shape)
        elif name == "query_embed":
            x = rng.normal(size=shape)
        else:  # bias, running_mean
            x = 0.1 * rng.normal(size=shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_port(port_module, variables):
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    return port_module.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def close(ours, ref, atol=MODULE_ATOL, rtol=MODULE_RTOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _pixel_mask(b, h, w, extents):
    m = np.zeros((b, h, w), bool)
    for i, (vh, vw) in enumerate(extents):
        m[i, :vh, :vw] = True
    return m


def test_frozen_batchnorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 24)).astype(np.float32)  # NHWC
    jmod = jax_layers.FrozenBatchNorm()
    variables = random_variables(jmod, jnp.asarray(x))
    ref = jmod.apply(variables, jnp.asarray(x))
    ours = to_port(layers.FrozenBatchNorm(24), variables)(t(x).permute(0, 3, 1, 2))
    close(ours.permute(0, 2, 3, 1), ref)


def test_feature_valid_mask_odd_extents():
    """Exact equality down the whole ceil-halving chain of 101x75."""
    mask = _pixel_mask(4, 101, 75, [(101, 75), (37, 61), (1, 2), (64, 33)])
    h, w = 101, 75
    for _ in range(6):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        ref = jax_layers.feature_valid_mask(jnp.asarray(mask), h, w)
        ours = layers.feature_valid_mask(t(mask), h, w)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        layers.feature_valid_mask(t(mask), 50, 37)


def test_sine_position_embedding():
    valid = _pixel_mask(2, 9, 13, [(9, 13), (5, 7)]).astype(np.float32)
    ref = jax_position.sine_position_embedding(jnp.asarray(valid), num_pos_features=32)
    ours = position.sine_position_embedding(t(valid), num_pos_features=32)
    assert ours.shape == (2, 9, 13, 64)
    close(ours, ref)


def test_backbone_with_pixel_mask():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 70, 90, 3)).astype(np.float32)
    mask = _pixel_mask(2, 70, 90, [(70, 90), (45, 61)])
    x = x * mask[..., None]
    jmod = jax_resnet.ResNetBackbone(stage_sizes=(1, 1, 1, 1))
    variables = random_variables(jmod, jnp.asarray(x), seed=1)
    ref = jmod.apply(variables, jnp.asarray(x), pixel_mask=jnp.asarray(mask))
    port = to_port(resnet.ResNetBackbone((1, 1, 1, 1)), variables)
    with torch.no_grad():
        ours = port(t(x), t(mask)).permute(0, 2, 3, 1)
    assert ours.shape == ref.shape == (2, 3, 3, 2048)
    close(ours, ref)


def test_transformer_2_2():
    rng = np.random.default_rng(2)
    b, s, d, nq = 2, 30, 64, 10
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    pos = rng.normal(size=(b, s, d)).astype(np.float32)
    query = rng.normal(size=(nq, d)).astype(np.float32)
    kpm = np.arange(s)[None] >= np.array([[s], [19]])
    jmod = jax_transformer.Transformer(model_dim=d, num_heads=2, num_encoder_layers=2,
                                       num_decoder_layers=2, dim_feedforward=128,
                                       dropout=0.0, attn_impl="xla")
    args = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(query))
    variables = random_variables(jmod, *args, key_padding_mask=jnp.asarray(kpm), seed=2)
    hs_ref, mem_ref = jmod.apply(variables, *args, key_padding_mask=jnp.asarray(kpm))
    port = to_port(transformer.Transformer(d, 2, 2, 2, 128, attn_impl="kernel"), variables)
    with torch.no_grad():
        hs, mem = port(t(src), t(pos), t(query), t(kpm))
    assert hs.shape == (2, b, nq, d)
    close(hs, hs_ref)
    close(mem, mem_ref)


SMALL = dict(num_classes=7, num_queries=10, model_dim=64, num_heads=2,
             num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=128,
             backbone_stage_sizes=(1, 1, 1, 1))


def _detr_pair(head, jax_impl, port_impl, config=SMALL, seed=3):
    nb = 4 if head == "finetune" else None
    jmod = jax_detr.DETR(dropout=0.0, head=head, nb_class=nb, attn_impl=jax_impl, **config)
    pmod = detr.DETR(head=head, nb_class=nb, attn_impl=port_impl, **config)
    return jmod, pmod


def _compare_detr(out, ref, head):
    if head == "none":
        close(out["hs"], ref["hs"])
        close(out["memory"], ref["memory"])
        return
    for key, atol in (("pred_boxes", BOX_ATOL), ("aux_boxes", BOX_ATOL),
                      ("pred_logits", LOGIT_ATOL), ("aux_logits", LOGIT_ATOL)):
        assert out[key].dtype == torch.float32
        close(out[key], ref[key], atol=atol, rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("jax_impl,port_impl", [("pallas", "kernel"), ("xla", "plain")])
@pytest.mark.parametrize("head", ["detr", "finetune", "none"])
def test_detr_reduced_width(head, jax_impl, port_impl):
    """Stage sizes (1,1,1,1), 2+2 layers, d=64, 2 heads, with a pixel mask.
    JAX "pallas" runs the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(4)
    mask = _pixel_mask(2, 96, 160, [(96, 160), (70, 101)])
    x = (rng.normal(size=(2, 96, 160, 3)) * mask[..., None]).astype(np.float32)
    jmod, pmod = _detr_pair(head, jax_impl, port_impl)
    variables = random_variables(jmod, jnp.asarray(x), seed=3)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(mask))
    port = to_port(pmod, variables)
    with torch.no_grad():
        out = port(t(x), t(mask))
    _compare_detr(out, ref, head)


def test_detr_r50_full_width():
    """DETR-R50, 6+6 layers, d=256, 8 heads, FFN 2048, 100 queries, 92
    classes, on a 64x96 image (a 2x3 map at stride 32)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    jmod = jax_detr.DETR(dropout=0.0, attn_impl="xla")
    variables = random_variables(jmod, jnp.asarray(x), seed=5)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = to_port(detr.DETR(), variables)
    with torch.no_grad():
        out = port(t(x))
    assert out["pred_logits"].shape == (1, 100, 92)
    assert out["aux_boxes"].shape == (5, 1, 100, 4)
    _compare_detr(out, ref, "detr")


def test_from_jax_variables_loads_strict():
    jmod, pmod = _detr_pair("detr", "xla", "auto")
    variables = random_variables(jmod, jnp.zeros((1, 64, 64, 3)))
    state = from_jax_variables(variables)
    assert set(state) == set(pmod.state_dict())
    pmod.load_state_dict(state, strict=True)
    w = variables["params"]["transformer"]["encoder_layer_0"]["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(
        pmod.transformer.encoder_layer_0.self_attn.q_proj.weight.detach().numpy(),
        np.asarray(w).T)
    stem = variables["params"]["backbone"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(pmod.backbone.conv1.weight.detach().numpy(),
                                  np.asarray(stem).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("head", ["detr", "finetune", "none"])
def test_npz_roundtrip_and_build_detr(head, tmp_path):
    """A JAX ``save_variables_npz`` archive loads without JAX and gives
    the same state_dict; ``build_detr(weights=...)`` loads it (the trunk
    only for the finetune and headless variants)."""
    jmod, _ = _detr_pair("detr", "xla", "auto")
    variables = random_variables(jmod, jnp.zeros((1, 64, 64, 3)))
    path = str(tmp_path / "detr.npz")
    jax_weights.save_variables_npz(jax.device_get(variables), path)
    direct = from_jax_variables(variables)
    loaded = from_jax_variables(load_variables_npz(path))
    assert set(loaded) == set(direct)
    for k in direct:
        torch.testing.assert_close(loaded[k], direct[k], rtol=0, atol=0)
    config = {k: v for k, v in SMALL.items()}
    model = api.build_detr(head=head, nb_class=4 if head == "finetune" else None,
                           weights=path, device="cpu", **config)
    got = model.module.state_dict()
    for k, v in got.items():
        if k in direct:
            torch.testing.assert_close(v, direct[k], rtol=0, atol=0)
        else:
            assert k.startswith(("cls_layer.", "pos_layer.")), k


def test_build_detr_seeded_and_bf16():
    a = api.build_detr(seed=7, device="cpu", **SMALL)
    b = api.build_detr(seed=7, device="cpu", **SMALL)
    c = api.build_detr(seed=8, device="cpu", **SMALL)
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["query_embed"], sc["query_embed"])
    bf = api.build_detr(seed=7, dtype="bfloat16", device="cpu", **SMALL)
    # Parameters stay float32 at every compute dtype, as in the JAX package:
    # the bf16 build is the fp32 build's weights, computing in bf16.
    assert all(p.dtype == torch.float32 for p in bf.module.parameters())
    assert all(torch.equal(p, sa[n]) for n, p in bf.module.named_parameters())
    assert bf.module.transformer.decoder_norm.weight.dtype == torch.float32
    assert bf.module.backbone.bn1.running_var.dtype == torch.float32
    assert bf.module.query_embed.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32))
    out32, out16 = a(x), bf(x)
    assert out16["pred_boxes"].dtype == torch.float32
    assert torch.isfinite(out16["pred_logits"]).all()
    # bf16 keeps ~3 significant digits; boxes are sigmoids in [0, 1].
    assert float((out16["pred_boxes"] - out32["pred_boxes"]).abs().max()) < 0.1


def test_get_detr_model_heads():
    kw = {k: v for k, v in SMALL.items() if k not in ("num_encoder_layers", "num_decoder_layers")}
    kw["device"] = "cpu"
    x = torch.zeros((1, 64, 64, 3))
    top = api.get_detr_model(include_top=True, num_encoder_layers=1, num_decoder_layers=1, **kw)
    fine = api.get_detr_model(nb_class=3, num_encoder_layers=1, num_decoder_layers=1, **kw)
    headless = api.get_detr_model(tf_backbone=True, num_encoder_layers=1,
                                  num_decoder_layers=1, **kw)
    assert top(x)["pred_logits"].shape == (1, 10, 7)
    assert fine(x)["pred_logits"].shape == (1, 10, 3)
    assert headless(x)["hs"].shape == (1, 1, 10, 64)
    assert headless.normalized_method == "tf_resnet"
    aux = detr.as_aux_list(top(x))
    assert aux["aux"] == []


def test_build_detr_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    ``build_detr``'s device defaults to "cuda", and ``get_detr_model`` has
    no default of its own (its keyword arguments reach ``build_detr``)."""
    import inspect

    assert inspect.signature(api.build_detr).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(api.get_detr_model).parameters


def test_port_imports_no_jax():
    """Importing the port and every submodule loads neither JAX, flax,
    optax, orbax, cv2 nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import detr_tensorflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'cv2', 'detr_tensorflow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(list(pkgutil.walk_packages(p.__path__))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
