"""Checkpoints in and out of the port (detr_tensorflow_tpu_torch/models/
weights.py and DetrModel.save/load) against the JAX package's converters
and loaders, on the CPU.

The torch checkpoints are built from numpy seeds with the published naming
(``chip_smoke.facebook_state_dict``: facebookresearch/detr's; renamed here
into HuggingFace's and torchvision's). The naming tests run at narrow
widths (the converters check names, not widths); the forward and the
loads into a model run at DETR-R50's widths. Trees are compared leaf for
leaf: the same keys, equal arrays.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import build_detr as jax_build_detr
from detr_tensorflow_tpu.models import quantized as JQ
from detr_tensorflow_tpu.models import weights as jax_weights
from detr_tensorflow_tpu_torch.models import api, quantized
from detr_tensorflow_tpu_torch.models import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import facebook_state_dict  # noqa: E402

# Golden tolerances of tests/test_golden_torch.py (full-depth fp32 parity).
BOX_ATOL, LOGIT_ATOL = 5e-4, 5e-3
NARROW = dict(base=4, model_dim=16, dim_feedforward=32, num_classes=7, num_queries=5,
              num_encoder_layers=2, num_decoder_layers=2)
SMALL = dict(num_classes=7, num_queries=10, model_dim=64, num_heads=2, num_encoder_layers=1,
             num_decoder_layers=1, dim_feedforward=128, backbone_stage_sizes=(1, 1, 1, 1))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_trees_equal(ours, ref):
    ours, ref = dict(flat(ours)), dict(flat(ref))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def to_hf(sd, model_dim):
    """facebook naming -> HuggingFace ``DetrForObjectDetection`` naming."""
    out = {}
    bb = "model.backbone.conv_encoder.model."
    for k, v in sd.items():
        parts = k.split(".")
        if k.startswith("backbone.0.body."):
            rest = parts[3:]
            if rest[0] in ("conv1", "bn1"):
                kind = "convolution" if rest[0] == "conv1" else "normalization"
                out[f"{bb}embedder.embedder.{kind}.{rest[-1]}"] = v
                continue
            s, b, mod = int(rest[0][5:]) - 1, rest[1], rest[2]
            p = f"{bb}encoder.stages.{s}.layers.{b}."
            if mod == "downsample":
                kind = "convolution" if rest[3] == "0" else "normalization"
                out[f"{p}shortcut.{kind}.{rest[-1]}"] = v
            else:
                kind = "convolution" if mod.startswith("conv") else "normalization"
                out[f"{p}layer.{int(mod[-1]) - 1}.{kind}.{rest[-1]}"] = v
        elif k.startswith("transformer.decoder.norm."):
            out[f"model.decoder.layernorm.{parts[-1]}"] = v
        elif k.startswith("transformer."):
            side, i, mod = parts[1], parts[3], parts[4]
            p = f"model.{side}.layers.{i}."
            if mod in ("self_attn", "multihead_attn"):
                name = "self_attn" if mod == "self_attn" else "encoder_attn"
                if parts[5].startswith("in_proj"):
                    kind = "weight" if parts[5] == "in_proj_weight" else "bias"
                    for j, qkv in enumerate("qkv"):
                        out[f"{p}{name}.{qkv}_proj.{kind}"] = v[j * model_dim:(j + 1) * model_dim]
                else:
                    out[f"{p}{name}.out_proj.{parts[-1]}"] = v
            else:
                names = {"linear1": "fc1", "linear2": "fc2", "norm1": "self_attn_layer_norm",
                         "norm2": "final_layer_norm" if side == "encoder"
                         else "encoder_attn_layer_norm", "norm3": "final_layer_norm"}
                out[f"{p}{names[mod]}.{parts[-1]}"] = v
        else:
            names = {"input_proj": "model.input_projection",
                     "query_embed": "model.query_position_embeddings",
                     "class_embed": "class_labels_classifier", "bbox_embed": "bbox_predictor"}
            out[".".join([names[parts[0]]] + parts[1:])] = v
    return out


def segmentation(sd, model_dim, seed=0):
    """facebook DETRsegm naming: the detector under ``detr.``, beside the
    mask head and the attention map (MaskHeadSmallConv, MHAttentionMap)."""
    rng = np.random.default_rng(seed)
    out = {"detr." + k: v for k, v in sd.items()}
    dim, ctx = model_dim + 8, model_dim

    def put(name, *shape):
        out[name] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    widths = [dim, ctx // 2, ctx // 4, ctx // 8, ctx // 16]
    put("mask_head.lay1.weight", dim, dim, 3, 3)
    put("mask_head.lay1.bias", dim)
    for j in range(2, 6):
        put(f"mask_head.lay{j}.weight", widths[j - 1], widths[j - 2], 3, 3)
        put(f"mask_head.lay{j}.bias", widths[j - 1])
    for j in range(1, 6):
        put(f"mask_head.gn{j}.weight", widths[j - 1])
        put(f"mask_head.gn{j}.bias", widths[j - 1])
    for j, cin in enumerate((64, 32, 16)):
        put(f"mask_head.adapter{j + 1}.weight", widths[j + 1], cin, 1, 1)
        put(f"mask_head.adapter{j + 1}.bias", widths[j + 1])
    put("mask_head.out_lay.weight", 1, widths[4], 3, 3)
    put("mask_head.out_lay.bias", 1)
    for name in ("q_linear", "k_linear"):
        put(f"bbox_attention.{name}.weight", model_dim, model_dim)
        put(f"bbox_attention.{name}.bias", model_dim)
    return out


def torchvision(sd):
    """A torchvision ResNet state_dict: facebook's backbone without its
    root, BatchNorm's ``num_batches_tracked`` and the ImageNet classifier."""
    out = {k[len("backbone.0.body."):]: v for k, v in sd.items()
           if k.startswith("backbone.0.body.")}
    for k in [k for k in out if k.endswith(".running_var")]:
        out[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    cin = out["layer4.0.downsample.0.weight"].shape[0]
    out["fc.weight"], out["fc.bias"] = torch.zeros(1000, cin), torch.zeros(1000)
    return out


@pytest.fixture(scope="module")
def narrow():
    return {depth: facebook_state_dict(seed=depth, depth=depth, **NARROW) for depth in (50, 101)}


@pytest.mark.parametrize("case", ["facebook", "hf", "r101", "segmentation"])
def test_convert_torch_detr_matches_jax(narrow, case):
    """``convert_torch_detr`` of the port equals the JAX package's leaf for
    leaf, with identical keys; of a segmentation checkpoint too, its
    ``mask_head`` (lay1 split into lay1_feats / lay1_attn) and
    ``bbox_attention`` included."""
    depth = 101 if case == "r101" else 50
    sd = narrow[depth]
    if case == "hf":
        sd = to_hf(sd, NARROW["model_dim"])
    elif case == "segmentation":
        sd = segmentation(sd, NARROW["model_dim"])
    kw = dict(backbone_depth=depth, num_encoder_layers=2, num_decoder_layers=2,
              model_dim=NARROW["model_dim"])
    ref = jax_weights.convert_torch_detr(sd, **kw)
    if case == "segmentation":
        assert {"mask_head", "bbox_attention"} <= set(ref["params"])
    assert_trees_equal(weights.convert_torch_detr(sd, **kw), ref)


def test_torchvision_backbone_matches_jax(narrow, tmp_path):
    """``convert_torchvision_backbone``, ``load_backbone_weights`` (a
    ``.pth`` and its ``.npz``) and ``apply_backbone_weights`` equal the JAX
    package's leaf for leaf."""
    sd = torchvision(narrow[50])
    ref = jax_weights.convert_torchvision_backbone(sd)
    assert_trees_equal(weights.convert_torchvision_backbone(sd), ref)
    pth, npz = str(tmp_path / "resnet50.pth"), str(tmp_path / "resnet50.npz")
    torch.save(sd, pth)
    jax_weights.save_variables_npz(ref, npz)
    for path in (pth, npz):
        assert_trees_equal(weights.load_backbone_weights(path), jax_weights.load_backbone_weights(path))
    variables = jax_weights.convert_torch_detr(narrow[101], backbone_depth=101, num_encoder_layers=2,
                                               num_decoder_layers=2, model_dim=16)
    ours = weights.apply_backbone_weights(variables, ref)
    assert_trees_equal(ours, jax_weights.apply_backbone_weights(variables, ref))
    assert_trees_equal(ours["params"]["backbone"], ref["params"]["backbone"])


def save_facebook(sd, path):
    """As facebook's published checkpoints: ``{"model": sd, "args": Namespace}``."""
    torch.save({"model": sd, "args": argparse.Namespace(lr=1e-4, backbone="resnet50",
                                                          dilation=False, dec_layers=6)}, path)


@pytest.mark.parametrize("case", ["pth_with_args", "hf_bin", "short_name", "registry_name"])
def test_load_weights_reads_local_files(narrow, tmp_path, monkeypatch, case):
    """``load_weights`` reads a facebook ``.pth`` holding ``{"model",
    "args": Namespace}``, a bare HF ``.bin``, a short name under
    ``$DETR_TPU_WEIGHTS`` and a registered name by its published file name,
    each to the JAX ``load_weights`` tree."""
    sd = narrow[50]
    monkeypatch.setenv("DETR_TPU_WEIGHTS", str(tmp_path))
    if case == "hf_bin":
        name = str(tmp_path / "detr-hf.bin")
        torch.save(to_hf(sd, NARROW["model_dim"]), name)
    else:
        path = {"pth_with_args": "ckpt.pth", "short_name": "mine.pth",
                "registry_name": "detr-r50-e632da11.pth"}[case]
        save_facebook(sd, str(tmp_path / path))
        name = {"pth_with_args": str(tmp_path / path), "short_name": "mine",
                "registry_name": "detr"}[case]
    kw = dict(num_encoder_layers=2, num_decoder_layers=2, model_dim=NARROW["model_dim"])
    assert_trees_equal(weights.load_weights(name, **kw), jax_weights.load_weights(name, **kw))


def test_load_weights_missing_name_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("DETR_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="No local weights found for 'nowhere'"):
        weights.load_weights("nowhere")
    with pytest.raises(FileNotFoundError):
        api.build_detr(weights="nowhere", device="cpu", **SMALL)


@pytest.fixture(scope="module")
def r50_checkpoint(tmp_path_factory):
    """A DETR-R50 checkpoint at full width with 2+2 transformer layers, as
    facebook publishes it, and the JAX package's conversion of it."""
    sd = facebook_state_dict(seed=11, num_encoder_layers=2, num_decoder_layers=2)
    path = str(tmp_path_factory.mktemp("r50") / "detr-r50.pth")
    save_facebook(sd, path)
    return path, sd, jax_weights.load_weights(path, num_encoder_layers=2, num_decoder_layers=2)


def test_converted_r50_forward_matches_jax(r50_checkpoint):
    """``build_detr(weights=.pth)`` at DETR-R50's widths, 2+2 layers, on a
    64x96 image: the port's forward equals the JAX forward of the JAX
    conversion within the golden tolerances."""
    path, _, variables = r50_checkpoint
    kw = dict(num_encoder_layers=2, num_decoder_layers=2)
    model = api.build_detr(weights=path, device="cpu", attn_impl="plain", **kw)
    x = np.random.default_rng(5).normal(size=(1, 64, 96, 3)).astype(np.float32)
    ours = model(torch.from_numpy(x))
    ref = jax.jit(JaxDETR(attn_impl="xla", **kw).apply)(variables, jnp.asarray(x))
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL),
                      ("aux_boxes", BOX_ATOL), ("aux_logits", LOGIT_ATOL)):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=atol, rtol=1e-3,
                                   err_msg=key)


def test_build_detr_merge_rules_and_backbone_weights(r50_checkpoint, tmp_path):
    """JAX ``build_detr``'s merge rules: ``head="detr"`` loads every tensor;
    ``head="finetune"`` keeps the trunk with fresh heads;
    ``backbone_weights`` (a torchvision ``.pth``) replaces the backbone."""
    path, sd, variables = r50_checkpoint
    kw = dict(num_encoder_layers=2, num_decoder_layers=2, device="cpu")
    state = weights.from_jax_variables(variables)
    full = api.build_detr(weights=path, **kw).module.state_dict()
    assert all(torch.equal(full[k], v) for k, v in state.items()) and set(full) == set(state)
    fresh = api.build_detr(head="finetune", nb_class=4, **kw).module.state_dict()
    tuned = api.build_detr(weights=path, head="finetune", nb_class=4, **kw).module.state_dict()
    for k, v in tuned.items():
        assert torch.equal(v, fresh[k] if k.startswith(("cls_layer.", "pos_layer.")) else state[k]), k
    other = facebook_state_dict(seed=12, num_encoder_layers=0, num_decoder_layers=0)
    resnet = str(tmp_path / "resnet50.pth")
    torch.save(torchvision(other), resnet)
    both = api.build_detr(weights=path, backbone_weights=resnet, **kw).module.state_dict()
    backbone = weights.from_jax_variables(
        {c: t["backbone"] for c, t in jax_weights.load_backbone_weights(resnet).items()})
    for k, v in both.items():
        ref = backbone[k[len("backbone."):]] if k.startswith("backbone.") else state[k]
        assert torch.equal(v, ref), k


def npz_shapes(path):
    with np.load(path) as data:
        return {k: (data[k].shape, data[k].dtype) for k in data.files}


@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory):
    """A seeded port model with nonzero FrozenBN statistics, saved with
    ``DetrModel.save``."""
    port = api.build_detr(seed=3, device="cpu", **SMALL)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, b in port.module.named_buffers():
            if name.endswith(("running_mean", "bias")):
                b.normal_(0.0, 0.1, generator=g)
            else:
                b.uniform_(0.5, 1.5, generator=g)
    path = str(tmp_path_factory.mktemp("saved") / "port.npz")
    port.save(path)
    return port, path


def test_save_loads_in_jax(saved_pair, tmp_path):
    """The JAX package's ``build_detr(weights=)`` reads what
    ``DetrModel.save`` writes, to the variables its ``load_weights`` reads;
    its own ``save_variables_npz`` of that model writes the same keys,
    shapes and dtypes; its forward equals the port's (fp32 summation
    order, 1e-4)."""
    port, path = saved_pair
    jax_model = jax_build_detr(image_size=(64, 64), seed=0, weights=path, **SMALL)
    assert_trees_equal(jax.device_get(jax_model.variables), jax_weights.load_weights(path))
    ref_path = str(tmp_path / "jax.npz")
    jax_weights.save_variables_npz(jax.device_get(jax_model.variables), ref_path)
    assert npz_shapes(path) == npz_shapes(ref_path)
    x = np.random.default_rng(6).normal(size=(1, 64, 96, 3)).astype(np.float32)
    ref = jax_model(jnp.asarray(x))
    ours = port(torch.from_numpy(x))
    for key in ("pred_boxes", "pred_logits"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-4)


def test_detr_model_load_restores_exactly(saved_pair):
    """``DetrModel.load`` into a model of another seed restores every
    parameter and buffer bit for bit, and drops the cached casts."""
    port, path = saved_pair
    other = api.build_detr(seed=9, device="cpu", dtype="bfloat16", **SMALL)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 64, 64, 3)).astype(np.float32))
    before = other(x)["pred_boxes"]  # fills the bf16 cast cache
    assert other.load(path) is other
    ours, ref = other.module.state_dict(), port.module.state_dict()
    assert set(ours) == set(ref) and all(torch.equal(ours[k], ref[k]) for k in ref)
    fresh = api.build_detr(weights=path, device="cpu", dtype="bfloat16", **SMALL)
    after = other(x)["pred_boxes"]
    assert torch.equal(after, fresh(x)["pred_boxes"]) and not torch.equal(after, before)


def test_int8_save_loads_in_jax(tmp_path):
    """An int8 model's ``quant`` collection: the archive has the keys,
    shapes and dtypes of the JAX package's ``quantize_model`` output saved
    by ``save_variables_npz``, JAX's ``DETR(backbone_quant=True)`` runs it
    to the port's outputs (int8 chain equal, the heads within 1e-4), and
    ``build_detr(weights=, backbone_quant=True)`` reads it back exactly."""
    calib = np.random.default_rng(8).normal(size=(2, 64, 96, 3)).astype(np.float32)
    port = api.build_detr(seed=5, backbone_quant=True, device="cpu", **SMALL)
    quantized.quantize_model(port, torch.from_numpy(calib))
    path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port.save(path)
    loaded = jax_weights.load_weights(path)
    fp32 = {c: loaded[c] for c in ("params", "frozen")}
    qvars = jax.jit(lambda v, x: JQ.quantize_model(v, x, stage_sizes=(1, 1, 1, 1)))(
        fp32, jnp.asarray(calib))
    jax_weights.save_variables_npz(jax.device_get(qvars), ref_path)
    assert npz_shapes(path) == npz_shapes(ref_path)
    x = calib[:1]
    ref = jax.jit(JaxDETR(backbone_quant=True, attn_impl="xla", dropout=0.0, **SMALL).apply)(
        loaded, jnp.asarray(x))
    ours = port(torch.from_numpy(x))
    for key in ("pred_boxes", "pred_logits"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-4)
    back = api.build_detr(seed=6, weights=path, backbone_quant=True, device="cpu", **SMALL)
    ours_q, ref_q = (dict(m.module.backbone_quant.named_buffers()) for m in (back, port))
    assert set(ours_q) == set(ref_q) and all(torch.equal(ours_q[k], ref_q[k]) for k in ref_q)
    assert torch.equal(back(torch.from_numpy(x))["pred_boxes"], ours["pred_boxes"])
