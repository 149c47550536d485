"""Serving artifacts through ``torch.export`` (port of
``detr_tensorflow_tpu/export.py``).

``export_predictor`` writes a Predictor's bucket programs and its weights
into a directory; ``load_predictor`` reads them back into an
``ExportedPredictor``, which serves with no model definition, no
``DETR`` built and no weight conversion at start-up:

    predictor = Predictor(model, background_class=91)
    export_predictor(predictor, "artifact/", shapes=[(800, 1333)])

    # on the serving host:
    predictor = load_predictor("artifact/")      # an ExportedPredictor, on the card
    detections = predictor([frame1, frame2])     # the same API as Predictor

A program is ``Predictor.serve_forward`` at one bucket: normalize, zero the
padded pixels, the model, ``inference.postprocess`` and, with masks,
``inference.mask_probs``. Its batch dimension is a ``torch.export.Dim``, so
one program serves any batch. Every bucket gets the masked program, as in
the JAX package; for a ``fuse_bottleneck`` model each bucket also gets the
unmasked one, which a batch that fills its bucket runs (kernel E's only
route), so an artifact launches the same kernels as the live Predictor on
the same request. Elsewhere a bucket-exact batch runs the masked program
with an all-valid mask, which gives the same detections.

The kernels are ``torch.library`` ops (``ops/library.py``): a program calls
``detr_torch::*`` whatever device it was traced on, and each op launches
its kernel on CUDA tensors and runs its plain version on CPU tensors. The
bf16 casts and the BN folds the model caches (``models/layers.py``) are
derived once before tracing and held by the program as buffers
(``operands_as_buffers``), so a call recomputes none of them.

Layout: ``manifest.json`` (buckets, flags, the compute dtype, the device
and torch version of the export), ``program_<H>x<W>.pt2`` (masked) and,
for a fused model, ``program_<H>x<W>_unmasked.pt2`` (``torch.export.save``,
each without its tensors), and ``weights.pt``: the parameters and buffers
that some program reads, once. On load one copy of them, on the device
asked for, is the state of every program; a tensor that no graph reads
keeps its one-element placeholder.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .models.layers import CachedOperands, operands_as_buffers
from .ops import library  # noqa: F401  (registers the ops a program calls)
from .predictor import Predictor

FORMAT = "detr-tensorflow-tpu-torch/torch.export"
VERSION = 1
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
_STATE = (torch.export.graph_signature.InputKind.PARAMETER,
          torch.export.graph_signature.InputKind.BUFFER)


def _canonical(device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the current
    one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def program_file(bucket: Tuple[int, int], masked: bool) -> str:
    """The file of one bucket's masked or unmasked program."""
    return f"program_{bucket[0]}x{bucket[1]}{'' if masked else '_unmasked'}.pt2"


class _ServingProgram(nn.Module):
    """``predictor.serve_forward`` as a module whose state is the model's:
    (frames[, pixel_mask]) -> (boxes, labels, scores, keep[, mask
    probabilities])."""

    def __init__(self, predictor: Predictor):
        super().__init__()
        self.model = predictor.model.module
        self.serve_forward = predictor.serve_forward

    def forward(self, frames: torch.Tensor, pixel_mask=None):
        post, probs = self.serve_forward(frames, pixel_mask)
        return post if probs is None else (*post, probs)


def _derive_operands(predictor: Predictor, programs) -> None:
    """Empty every cache of derived operands, then run each program once
    at batch 1, so the caches hold what the programs read and nothing
    else."""
    module = predictor.model.module
    for m in module.modules():
        if isinstance(m, CachedOperands):
            m._cache = {}
    device = predictor.model.device
    with torch.no_grad():
        for (ph, pw), masked in programs:
            frames = torch.zeros((1, ph, pw, 3), dtype=torch.uint8, device=device)
            mask = torch.ones((1, ph, pw), dtype=torch.bool, device=device) if masked else None
            predictor.serve_forward(frames, mask)


def _placeholder(t: torch.Tensor) -> torch.Tensor:
    """A one-element stand-in of ``t`` (of its dtype and kind): a saved
    program carries no weights, the shared file does, and loading puts
    them back."""
    stub = torch.zeros(1, dtype=t.dtype)
    return nn.Parameter(stub, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) \
        else stub


def export_programs(predictor: Predictor, shapes: List[Tuple[int, int]],
                    batch: Optional[int] = None) -> Dict:
    """The Predictor's bucket programs, ``{(bucket, masked): ExportedProgram}``.

    ``shapes`` are (height, width) input sizes; each is rounded up to the
    Predictor's bucket as serving does, and each distinct bucket gets the
    masked program (and, for a ``fuse_bottleneck`` model, the unmasked one
    too). Their batch dimension is symbolic, as an artifact's is, unless
    ``batch`` fixes it, which traces in about half the time (a check of a
    program's graph). They are traced on the model's device, under
    ``torch.no_grad``: the routes the live Predictor takes under inference
    mode."""
    if isinstance(predictor, ExportedPredictor):
        raise TypeError("export_programs takes a live Predictor, not a loaded artifact")
    buckets = sorted({predictor._bucket(h, w) for h, w in shapes})
    programs = [(bk, True) for bk in buckets]
    if predictor.unmasked_route:
        programs += [(bk, False) for bk in buckets]
    _derive_operands(predictor, programs)

    device = predictor.model.device
    dim = torch.export.Dim("batch", min=1)
    wrapper = _ServingProgram(predictor)
    exported = {}
    with operands_as_buffers(predictor.model.module), torch.no_grad():
        for (ph, pw), masked in programs:
            # A symbolic batch is traced at 2: an example at 1 would specialize it.
            b = batch or 2
            inputs = (torch.zeros((b, ph, pw, 3), dtype=torch.uint8, device=device),)
            if masked:
                inputs += (torch.ones((b, ph, pw), dtype=torch.bool, device=device),)
            dynamic = None if batch else tuple({0: dim} for _ in inputs)
            exported[(ph, pw), masked] = torch.export.export(
                wrapper, inputs, dynamic_shapes=dynamic, strict=False)
    return exported


def used_state(ep) -> Dict[str, torch.Tensor]:
    """The parameters and buffers that ``ep``'s graph reads (a bf16 or a
    fused program reads its cached copies and folds, not the float32
    weights they were made from)."""
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    return {spec.target: ep.state_dict[spec.target] for spec in ep.graph_signature.input_specs
            if spec.kind in _STATE and nodes[spec.arg.name].users}


def export_predictor(predictor: Predictor, path: str, shapes: List[Tuple[int, int]]) -> None:
    """Write the Predictor's bucket programs (``export_programs``) and their
    weights to ``path``."""
    exported = export_programs(predictor, shapes)
    os.makedirs(path, exist_ok=True)
    weights: Dict[str, torch.Tensor] = {}
    for ep in exported.values():
        for name, t in used_state(ep).items():
            if name in weights and weights[name] is not t:
                raise AssertionError(f"the programs hold two tensors named {name}")
            weights[name] = t
    torch.save({name: t.detach().cpu() for name, t in weights.items()},
               os.path.join(path, _WEIGHTS))
    for (bucket, masked), ep in exported.items():
        for name, t in list(ep.state_dict.items()):
            ep.state_dict[name] = _placeholder(t)
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(path, program_file(bucket, masked)))

    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "buckets": [list(bk) for bk in sorted({bk for bk, _ in exported})],
        "bucket_divisor": predictor.bucket_divisor,
        "background_class": predictor.background_class,
        "score_threshold": predictor.score_threshold,
        "bbox_format": predictor.bbox_format,
        "masks": predictor.masks,
        "mask_threshold": predictor.mask_threshold,
        "unmasked_programs": predictor.unmasked_route,
        "dtype": str(predictor.model.module.dtype).removeprefix("torch."),
        "device": str(_canonical(predictor.model.device)),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


class _LoadedBundle:
    """What the Predictor's host path reads of a model bundle: the shared
    weights and their device."""

    def __init__(self, weights: Dict[str, torch.Tensor], device: torch.device):
        self.weights = weights
        self.device = device


class LoadedProgram:
    """A loaded program (``module``, from ``ExportedProgram.module()``)
    called as ``serve_forward`` is, with its return structure."""

    def __init__(self, module: nn.Module, masks: bool):
        self.module, self.masks = module, masks

    def __call__(self, *inputs):
        out = self.module(*inputs)
        return tuple(out[:4]), out[4] if self.masks else None


class ExportedPredictor(Predictor):
    """A Predictor read from an artifact directory.

    ``__call__``, ``warmup`` and ``buckets`` are the Predictor's (bucketing,
    unpadding, thresholding, per-image frames, masks); only
    ``_get_program`` differs: it returns the bucket's loaded program.
    Nothing is built or converted at start-up. A request at a bucket the
    artifact lacks raises ``ValueError`` naming the buckets it has.

    ``device`` (the card unless asked otherwise) is where the weights and
    the programs go. A program traced on another device is moved
    there (``torch.export.passes.move_to_device_pass``), literal devices of
    its factory calls included; its ``detr_torch`` ops dispatch on their
    inputs' device, so a CUDA request launches the kernels.
    """

    def __init__(self, path: str, device="cuda"):
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        if m.get("format") != FORMAT or m.get("version") != VERSION:
            raise ValueError(f"{path} is not a {FORMAT} artifact of version {VERSION}")
        device = _canonical(device)
        self.background_class = int(m["background_class"])
        self.bucket_divisor = int(m["bucket_divisor"])
        self.score_threshold = float(m["score_threshold"])
        self.bbox_format = m["bbox_format"]
        self.masks = bool(m["masks"])
        self.mask_threshold = float(m["mask_threshold"])
        self.buckets = set()
        self.exported_buckets = [tuple(bk) for bk in m["buckets"]]
        self._unmasked = bool(m["unmasked_programs"])
        weights = torch.load(os.path.join(path, _WEIGHTS), map_location=device,
                             weights_only=True)
        self.model = _LoadedBundle(weights, device)
        shared: Dict[str, torch.Tensor] = {}
        self._programs = {}
        for bucket in self.exported_buckets:
            for masked in (True, False) if self._unmasked else (True,):
                ep = torch.export.load(os.path.join(path, program_file(bucket, masked)))
                for spec in ep.graph_signature.input_specs:
                    # A tensor the graph never reads keeps its saved placeholder.
                    if spec.kind in _STATE and spec.target in weights:
                        if spec.target not in shared:
                            t = weights[spec.target]
                            shared[spec.target] = (
                                nn.Parameter(t, requires_grad=False)
                                if spec.kind == torch.export.graph_signature.InputKind.PARAMETER
                                else t)
                        ep.state_dict[spec.target] = shared[spec.target]
                if torch.device(m["device"]) != device:
                    # The weights are there already: this moves the constants
                    # and the devices written into the graph.
                    ep = move_to_device_pass(ep, device)
                self._programs[bucket, masked] = LoadedProgram(ep.module(), self.masks)

    @property
    def unmasked_route(self) -> bool:
        return self._unmasked

    def _get_program(self, shape, masked):
        shape = tuple(shape)
        if (shape, True) not in self._programs:
            raise ValueError(f"no exported program for bucket {shape}; the artifact has "
                             f"{self.exported_buckets}: export it with this shape, or resize")
        if masked or self._unmasked:
            return self._programs[shape, masked]
        program = self._programs[shape, True]
        # No unmasked program: the masked one with every pixel valid gives
        # the same detections through the same kernels.
        return lambda frames: program(frames, torch.ones(frames.shape[:3], dtype=torch.bool,
                                                         device=frames.device))


def load_predictor(path: str, device="cuda") -> ExportedPredictor:
    """Load a serving artifact written by ``export_predictor`` onto
    ``device`` (the card unless asked otherwise)."""
    return ExportedPredictor(path, device)
