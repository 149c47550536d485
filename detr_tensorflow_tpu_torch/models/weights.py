"""Weights in and out, read and written without JAX (port of
``detr_tensorflow_tpu/models/weights.py``).

The JAX package's variables tree is the one interchange format: a nested
dict of numpy arrays, ``{"params": ..., "frozen": ...}`` (plus ``"quant"``
for the int8 backbone), with Dense kernels (in, out), conv kernels HWIO,
LayerNorm ``scale`` and the FrozenBN statistics under ``frozen``.

* In: ``convert_torch_detr`` turns a torch DETR state_dict, in the
  facebookresearch naming (``backbone.0.body.*``, packed ``in_proj``
  attention) or the HuggingFace ``DetrForObjectDetection`` one, into that
  tree, leaf for leaf what the JAX converter gives;
  ``convert_torchvision_backbone`` does the same for a torchvision
  ResNet-50/101 (ImageNet initialization of the backbone);
  ``load_weights`` reads a local ``.npz``, ``.pth``, ``.pt`` or ``.bin``
  by path or short name. ``from_jax_variables`` and ``from_jax_quant`` map
  a tree onto this package's state_dict and int8 qtree.
* Out: ``to_jax_variables`` and ``to_jax_quant`` invert those two, and
  ``save_variables_npz`` writes the tree as the JAX package's ``.npz``
  (``DetrModel.save``), which the JAX package's ``load_weights`` reads.

A segmentation checkpoint (facebook DETRsegm, HF DetrForSegmentation:
``detr.``-prefixed detector beside ``mask_head.*`` and
``bbox_attention.*``) converts whole: the detector, and the mask head in
the split form of ``models/segmentation.py`` (``lay1`` cut into
``lay1_feats`` and the bias-free ``lay1_attn``). Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]

# ---------------------------------------------------------------------------
# torch state_dicts -> the JAX variables tree (copied from the JAX package)
# ---------------------------------------------------------------------------


def _t(x) -> np.ndarray:
    """torch tensor / array -> float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _linear(sd: Mapping, prefix: str) -> Tree:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T, "bias": _t(sd[f"{prefix}.bias"])}


def _layernorm(sd: Mapping, prefix: str) -> Tree:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, key: str) -> Tree:
    return {"kernel": _t(sd[key]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO


def _bn(sd: Mapping, prefix: str) -> Tree:
    return {k: _t(sd[f"{prefix}.{k}"]) for k in ("weight", "bias", "running_mean", "running_var")}


def _packed_attention(sd: Mapping, prefix: str, d: int) -> Tree:
    """facebook naming: the packed (3d, d) ``in_proj`` split into q/k/v."""
    w = _t(sd[f"{prefix}.in_proj_weight"])
    b = _t(sd[f"{prefix}.in_proj_bias"])
    out = {name: {"kernel": w[i * d:(i + 1) * d].T, "bias": b[i * d:(i + 1) * d]}
           for i, name in enumerate(("q_proj", "k_proj", "v_proj"))}
    out["out_proj"] = _linear(sd, f"{prefix}.out_proj")
    return out


def _split_attention(sd: Mapping, prefix: str) -> Tree:
    """HF naming: q/k/v already split."""
    return {name: _linear(sd, f"{prefix}.{name}")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


_STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _convert_backbone(sd: Mapping, scheme: str, depth: int) -> Tuple[Tree, Tree]:
    """(params, frozen) subtrees of the ``backbone`` module. torchvision's
    ResNet naming is facebook DETR's backbone without the
    ``backbone.0.body.`` root."""
    if scheme in ("facebook", "torchvision"):
        root = "backbone.0.body." if scheme == "facebook" else ""

        def conv_key(s, b, j):
            return f"{root}layer{s + 1}.{b}.conv{j + 1}.weight"

        def bn_prefix(s, b, j):
            return f"{root}layer{s + 1}.{b}.bn{j + 1}"

        def short_conv_key(s, b):
            return f"{root}layer{s + 1}.{b}.downsample.0.weight"

        def short_bn_prefix(s, b):
            return f"{root}layer{s + 1}.{b}.downsample.1"

        stem_conv, stem_bn = f"{root}conv1.weight", f"{root}bn1"
    elif scheme == "hf":
        root = "model.backbone.conv_encoder.model"

        def conv_key(s, b, j):
            return f"{root}.encoder.stages.{s}.layers.{b}.layer.{j}.convolution.weight"

        def bn_prefix(s, b, j):
            return f"{root}.encoder.stages.{s}.layers.{b}.layer.{j}.normalization"

        def short_conv_key(s, b):
            return f"{root}.encoder.stages.{s}.layers.{b}.shortcut.convolution.weight"

        def short_bn_prefix(s, b):
            return f"{root}.encoder.stages.{s}.layers.{b}.shortcut.normalization"

        stem_conv = f"{root}.embedder.embedder.convolution.weight"
        stem_bn = f"{root}.embedder.embedder.normalization"
    else:
        raise ValueError(scheme)

    params: Tree = {"conv1": _conv(sd, stem_conv)}
    frozen: Tree = {"bn1": _bn(sd, stem_bn)}
    for s, n_blocks in enumerate(_STAGE_SIZES[depth]):
        layer_p: Tree = {}
        layer_f: Tree = {}
        for b in range(n_blocks):
            block_p = {f"conv{j + 1}": _conv(sd, conv_key(s, b, j)) for j in range(3)}
            block_f = {f"bn{j + 1}": _bn(sd, bn_prefix(s, b, j)) for j in range(3)}
            if b == 0:
                block_p["downsample_conv"] = _conv(sd, short_conv_key(s, b))
                block_f["downsample_bn"] = _bn(sd, short_bn_prefix(s, b))
            layer_p[f"block_{b}"] = block_p
            layer_f[f"block_{b}"] = block_f
        params[f"layer{s + 1}"] = layer_p
        frozen[f"layer{s + 1}"] = layer_f
    return params, frozen


def _convert_transformer(sd: Mapping, scheme: str, num_encoder_layers: int,
                         num_decoder_layers: int, model_dim: int) -> Tree:
    tr: Tree = {}
    if scheme == "facebook":
        for i in range(num_encoder_layers):
            p = f"transformer.encoder.layers.{i}"
            tr[f"encoder_layer_{i}"] = {
                "self_attn": _packed_attention(sd, f"{p}.self_attn", model_dim),
                "linear1": _linear(sd, f"{p}.linear1"),
                "linear2": _linear(sd, f"{p}.linear2"),
                "norm1": _layernorm(sd, f"{p}.norm1"),
                "norm2": _layernorm(sd, f"{p}.norm2"),
            }
        for i in range(num_decoder_layers):
            p = f"transformer.decoder.layers.{i}"
            tr[f"decoder_layer_{i}"] = {
                "self_attn": _packed_attention(sd, f"{p}.self_attn", model_dim),
                "cross_attn": _packed_attention(sd, f"{p}.multihead_attn", model_dim),
                "linear1": _linear(sd, f"{p}.linear1"),
                "linear2": _linear(sd, f"{p}.linear2"),
                "norm1": _layernorm(sd, f"{p}.norm1"),
                "norm2": _layernorm(sd, f"{p}.norm2"),
                "norm3": _layernorm(sd, f"{p}.norm3"),
            }
        tr["decoder_norm"] = _layernorm(sd, "transformer.decoder.norm")
    else:  # hf
        for i in range(num_encoder_layers):
            p = f"model.encoder.layers.{i}"
            tr[f"encoder_layer_{i}"] = {
                "self_attn": _split_attention(sd, f"{p}.self_attn"),
                "linear1": _linear(sd, f"{p}.fc1"),
                "linear2": _linear(sd, f"{p}.fc2"),
                "norm1": _layernorm(sd, f"{p}.self_attn_layer_norm"),
                "norm2": _layernorm(sd, f"{p}.final_layer_norm"),
            }
        for i in range(num_decoder_layers):
            p = f"model.decoder.layers.{i}"
            tr[f"decoder_layer_{i}"] = {
                "self_attn": _split_attention(sd, f"{p}.self_attn"),
                "cross_attn": _split_attention(sd, f"{p}.encoder_attn"),
                "linear1": _linear(sd, f"{p}.fc1"),
                "linear2": _linear(sd, f"{p}.fc2"),
                "norm1": _layernorm(sd, f"{p}.self_attn_layer_norm"),
                "norm2": _layernorm(sd, f"{p}.encoder_attn_layer_norm"),
                "norm3": _layernorm(sd, f"{p}.final_layer_norm"),
            }
        tr["decoder_norm"] = _layernorm(sd, "model.decoder.layernorm")
    return tr


def _convert_segmentation_head(sd: Mapping, model_dim: int = 256) -> Tree:
    """The mask head and the attention-map projections (facebook DETRsegm
    and HF DetrForSegmentation share the ``mask_head.*`` /
    ``bbox_attention.*`` naming). torch's ``lay1`` convolves
    concat(features, attention maps): its first ``model_dim`` input
    channels become ``lay1_feats`` (with the bias), the rest the bias-free
    ``lay1_attn``."""

    def conv(name):
        out = {"kernel": _t(sd[f"mask_head.{name}.weight"]).transpose(2, 3, 1, 0)}
        if f"mask_head.{name}.bias" in sd:
            out["bias"] = _t(sd[f"mask_head.{name}.bias"])
        return out

    lay1 = _t(sd["mask_head.lay1.weight"]).transpose(2, 3, 1, 0)  # HWIO
    mask_head = {
        "lay1_feats": {"kernel": lay1[:, :, :model_dim, :], "bias": _t(sd["mask_head.lay1.bias"])},
        "lay1_attn": {"kernel": lay1[:, :, model_dim:, :]},
        "out_lay": conv("out_lay"),
    }
    for j in range(2, 6):
        mask_head[f"lay{j}"] = conv(f"lay{j}")
    for j in range(1, 6):
        mask_head[f"gn{j}"] = _layernorm(sd, f"mask_head.gn{j}")
    for j in range(1, 4):
        mask_head[f"adapter{j}"] = conv(f"adapter{j}")
    bbox_attention = {"q_proj": _linear(sd, "bbox_attention.q_linear"),
                      "k_proj": _linear(sd, "bbox_attention.k_linear")}
    return {"mask_head": mask_head, "bbox_attention": bbox_attention}


def convert_torch_detr(state_dict: Mapping, scheme: str = "auto", backbone_depth: int = 50,
                       num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                       model_dim: int = 256) -> Tree:
    """Torch DETR state_dict -> ``{"params", "frozen"}`` numpy tree.

    ``scheme="auto"`` tells facebook from HF naming by HF's ``model.`` root.
    A segmentation checkpoint (``mask_head.*`` keys) converts its mask head
    and attention-map projections too; its detector lives under ``detr.``
    and is unwrapped.
    """
    seg_tree = (_convert_segmentation_head(state_dict, model_dim)
                if any(k.startswith("mask_head.") for k in state_dict) else None)
    if any(k.startswith("detr.") for k in state_dict):
        state_dict = {k[len("detr."):]: v for k, v in state_dict.items()
                      if k.startswith("detr.")}
    if scheme == "auto":
        scheme = "hf" if any(k.startswith("model.") for k in state_dict) else "facebook"

    bb_params, bb_frozen = _convert_backbone(state_dict, scheme, backbone_depth)
    tr = _convert_transformer(state_dict, scheme, num_encoder_layers, num_decoder_layers,
                              model_dim)
    if scheme == "facebook":
        input_proj, query = "input_proj", "query_embed.weight"
        cls, bbox = "class_embed", "bbox_embed.layers"
    else:
        input_proj, query = "model.input_projection", "model.query_position_embeddings.weight"
        cls, bbox = "class_labels_classifier", "bbox_predictor.layers"
    params: Tree = {
        "backbone": bb_params,
        "transformer": tr,
        "input_proj": {"kernel": _t(state_dict[f"{input_proj}.weight"]).transpose(2, 3, 1, 0),
                       "bias": _t(state_dict[f"{input_proj}.bias"])},
        "query_embed": _t(state_dict[query]),
        "class_embed": _linear(state_dict, cls),
        "bbox_embed": {f"layer_{j}": _linear(state_dict, f"{bbox}.{j}") for j in range(3)},
    }
    if seg_tree is not None:
        params.update(seg_tree)
    return {"params": params, "frozen": {"backbone": bb_frozen}}


def convert_torchvision_backbone(state_dict: Mapping, depth: int = 50) -> Tree:
    """Torchvision ``resnet50/101`` state_dict -> backbone-only variables,
    ``{"params": {"backbone": ...}, "frozen": {"backbone": ...}}``; the
    classifier ``fc`` is ignored."""
    params, frozen = _convert_backbone(state_dict, "torchvision", depth)
    return {"params": {"backbone": params}, "frozen": {"backbone": frozen}}


def _torch_load(path: str):
    """A torch checkpoint's contents, tensors on the CPU. Only tensors,
    containers and ``argparse.Namespace`` (the ``"args"`` entry of
    facebook's published checkpoints) are unpickled."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_backbone_weights(path: str, depth: int = 50) -> Tree:
    """A local torchvision ResNet checkpoint (``.pth``/``.pt``/``.bin``, or
    a converted ``.npz`` variables archive) -> backbone-only variables."""
    if path.endswith(".npz"):
        tree = load_variables_npz(path)
        if "params" not in tree:
            raise ValueError(f"{path} is not a variables archive")
        return tree
    sd = _torch_load(path)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_torchvision_backbone(sd, depth=depth)


def apply_backbone_weights(variables: Tree, backbone_vars: Tree) -> Tree:
    """``variables`` with the backbone's params and frozen statistics
    replaced by ``backbone_vars``'."""
    out = {k: dict(v) for k, v in variables.items()}
    out.setdefault("frozen", {})
    out["params"]["backbone"] = backbone_vars["params"]["backbone"]
    out["frozen"]["backbone"] = backbone_vars["frozen"]["backbone"]
    return out


# ---------------------------------------------------------------------------
# Local files
# ---------------------------------------------------------------------------

WEIGHT_SEARCH_PATHS = ("weights/detr",)
# The file names of the published facebook checkpoints (the JAX package's
# registry), searched for locally under their short names.
PRETRAINED_CHECKPOINTS = {"detr-r50": "detr-r50-e632da11.pth",
                          "detr-r101": "detr-r101-2c7b67e5.pth"}
PRETRAINED_CHECKPOINTS["detr"] = PRETRAINED_CHECKPOINTS["detr-r50"]


def save_variables_npz(variables: Tree, path: str) -> None:
    """Write a variables tree as an ``.npz`` of ``collection/.../leaf``
    arrays, the JAX package's format."""
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten(variables)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_variables_npz(path: str) -> Tree:
    """Nested dict of numpy arrays from a ``save_variables_npz`` file."""
    tree: Tree = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def load_weights(name_or_path: str = "detr", **convert_kwargs) -> Tree:
    """DETR variables from a local file: a path to an ``.npz`` (this
    format) or a ``.pth``/``.pt``/``.bin`` torch state_dict (facebook or HF
    naming, bare or under ``"model"``), or a short name searched under
    ``$DETR_TPU_WEIGHTS`` and ``weights/detr`` as ``<name>.npz``, ``.pth``,
    ``.pt``, ``.bin`` and, for a registered name, its published file name.
    ``convert_kwargs`` go to ``convert_torch_detr``."""
    candidates = []
    if os.path.exists(name_or_path):
        candidates.append(name_or_path)
    else:
        search = [d for d in [os.environ.get("DETR_TPU_WEIGHTS", "")] + list(WEIGHT_SEARCH_PATHS)
                  if d]
        for d in search:
            candidates += [os.path.join(d, name_or_path + ext)
                           for ext in (".npz", ".pth", ".pt", ".bin")]
        if name_or_path in PRETRAINED_CHECKPOINTS:
            candidates += [os.path.join(d, PRETRAINED_CHECKPOINTS[name_or_path]) for d in search]
    for path in candidates:
        if not os.path.exists(path):
            continue
        if path.endswith(".npz"):
            return load_variables_npz(path)
        sd = _torch_load(path)
        if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]  # facebook checkpoints nest under 'model'
        return convert_torch_detr(sd, **convert_kwargs)
    raise FileNotFoundError(
        f"No local weights found for '{name_or_path}'. This environment has no "
        "network egress; place a torch checkpoint (facebook detr-r50-*.pth or a "
        "HuggingFace DetrForObjectDetection state_dict) or a converted .npz "
        "under weights/detr/ or point DETR_TPU_WEIGHTS at it."
    )


# ---------------------------------------------------------------------------
# The JAX variables tree <-> this package's state_dict and qtree
# ---------------------------------------------------------------------------


def _flatten(node: Mapping, prefix: tuple = ()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat) -> Tree:
    tree: Tree = {}
    for path, value in flat:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX DETR variables tree ({"params": ..., "frozen": ...}) to a
    state_dict of ``models.detr.DETR``.

    * Dense kernel (in, out) -> Linear weight (out, in);
    * conv kernel HWIO -> Conv2d weight OIHW;
    * LayerNorm ``scale`` -> ``weight``;
    * the ``frozen`` collection -> FrozenBatchNorm buffers, names unchanged;
    * ``query_embed`` as it is.
    """
    state = {}
    for collection, tree in variables.items():
        if collection not in ("params", "frozen"):  # "quant" goes to from_jax_quant
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, value in _flatten(tree):
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            *modules, leaf = path
            if collection == "params" and leaf == "kernel":
                leaf = "weight"
                arr = arr.t() if arr.dim() == 2 else arr.permute(3, 2, 0, 1)
            elif collection == "params" and leaf == "scale":
                leaf = "weight"
            state[".".join(modules + [leaf])] = arr.contiguous()
    return state


_FROZEN_BN = ("weight", "bias", "running_mean", "running_var")


def to_jax_variables(state: Mapping[str, torch.Tensor]) -> Tree:
    """The inverse of ``from_jax_variables``: a ``DETR`` state_dict (its
    ``backbone_quant.*`` buffers left out, see ``to_jax_quant``) -> the JAX
    variables tree of numpy float32 arrays. A module holding a
    ``running_mean`` is a FrozenBatchNorm and goes to ``frozen``; a 2-D
    ``weight`` is a Linear's, a 4-D one a conv's and a 1-D one a
    LayerNorm's ``scale``."""
    state = {k: v for k, v in state.items() if not k.startswith("backbone_quant.")}
    bn_modules = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    params, frozen = [], []
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        *modules, leaf = key.split(".")
        if ".".join(modules) in bn_modules:
            if leaf not in _FROZEN_BN:
                raise ValueError(f"unexpected FrozenBatchNorm tensor {key}")
            frozen.append((tuple(modules) + (leaf,), arr))
            continue
        if leaf == "weight":
            if arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            elif arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            else:
                leaf = "scale"
        params.append((tuple(modules) + (leaf,), np.array(arr, order="C")))
    return {"params": _nest(params), "frozen": _nest(frozen)}


def from_jax_quant(qtree: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX int8 qtree (``variables["quant"]["backbone"]`` from
    ``models/quantized.py:quantize_model``) to the port's qtree, the buffers
    of ``models.quantized.QuantizedBackbone``:

    * stem ``kernel`` HWIO -> OIHW float32;
    * 1x1 ``w1``/``w3``/``wd`` (1, 1, C, K) -> K-major (K, C) int8;
    * 3x3 ``w2`` HWIO (3, 3, C, K) -> OHWI (K, 3, 3, C) int8;
    * multipliers, biases, scales and the stem's FrozenBN as float32.
    """
    out = {}
    for path, value in _flatten(qtree):
        arr = torch.from_numpy(np.array(value))
        *modules, leaf = path
        if leaf == "kernel":
            arr = arr.float().permute(3, 2, 0, 1)
        elif leaf in ("w1", "w3", "wd"):
            arr = arr[0, 0].t()
        elif leaf == "w2":
            arr = arr.permute(3, 0, 1, 2)
        else:
            arr = arr.float()
        out[".".join(modules + [leaf])] = arr.contiguous()
    return out


def to_jax_quant(qtree: Mapping[str, torch.Tensor]) -> Tree:
    """The inverse of ``from_jax_quant``: the port's qtree -> the JAX
    package's (``variables["quant"]["backbone"]``), numpy arrays in its
    layouts (stem kernel HWIO, 1x1 weights (1, 1, C, K), 3x3 HWIO)."""
    flat = []
    for key, value in qtree.items():
        t = value.detach().cpu()
        *modules, leaf = key.split(".")
        if leaf == "kernel":
            t = t.permute(2, 3, 1, 0)
        elif leaf in ("w1", "w3", "wd"):
            t = t.t()[None, None]
        elif leaf == "w2":
            t = t.permute(1, 2, 3, 0)
        flat.append((tuple(modules) + (leaf,), np.array(t.numpy(), order="C")))
    return _nest(flat)
