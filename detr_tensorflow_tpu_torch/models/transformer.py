"""DETR transformer: post-norm encoder-decoder over batch-first tensors
(port of ``detr_tensorflow_tpu/models/transformer.py``).

``attn_impl`` picks the attention of every ``MultiHeadAttention``:
  * ``"auto"``: the CUDA kernels (``ops.flash_attention.mha``) for every
    call on a CUDA tensor, whether or not autograd is recording, and the
    plain version for CPU tensors, except while ``torch.export`` traces:
    then ``mha`` on every device, so that an exported program calls the
    op ``detr_torch::mha_forward`` wherever it was traced and launches the
    kernel wherever it runs on the card;
  * ``"kernel"``: always ``ops.flash_attention.mha``, which itself takes a
    CPU tensor to its plain reference;
  * ``"plain"``: materialised scores and softmax in PyTorch.
``return_weights=True`` always takes the plain version.

Every layer computes in its input's dtype from float32 parameters
(``models/layers.py``), as the JAX layers with ``dtype=``: the attention
scale is rounded to that dtype, the plain version's scores and softmax are
float32, and ``query_pos`` is cast from the float32 ``query_embed``.

``train=True`` turns on dropout where the JAX layers have it: on the
attention weights (inside the kernel, or on the plain version's
probabilities with the same Philox mask), on each residual branch and
after the FFN's ReLU. Every draw comes from the ``generator`` the caller
passes (the trainer owns it), never from the global RNG; the attention
takes one 64-bit seed per call from it, on the device.

Under Megatron tensor parallelism (``parallel/tp.py``) an attention and
a layer hold a ``tp`` (``ModelGroup``): the attention runs its local
``num_heads / m`` heads, its inputs pass through ``f`` and ``out_proj``'s
partial sum through ``g``; the FFN alike. Without it (``tp = None``) every
forward is the unsplit one.

``remat=True`` checkpoints every encoder and decoder layer while autograd
records (``torch.utils.checkpoint``, the JAX package's ``nn.remat``): the
backward recomputes the layer. ``torch.utils.checkpoint`` restores only
the global RNG states, so the recompute first sets the caller's generator
back to where the layer's forward found it, which replays the same keep
masks and attention seeds, and then returns it to where it stood.

``pipeline`` (a ``parallel.pp.PipelineSpec``) runs the layers GPipe-staged
over the spec's mesh, with the JAX package's rules: the encoder stack is
always staged, the decoder stack only when its depth divides by the stage
count (otherwise it runs sequentially on every rank), and the shared
``decoder_norm`` is applied to the staged decoder's whole output stack
(elementwise over D: the sequential per-layer norm). Every rank holds every
layer, runs its stage's share (``parallel/pp.py``) and gets the whole output
and every gradient; positions, the key mask, the memory and the query
positions travel with each microbatch. Dropout draws one seed per layer and
microbatch from the caller's generator (alike on every rank), which seeds
that layer's run, its recompute under ``remat_stage`` included.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention
from ..parallel import tp as tp_lib
from .layers import LayerNorm, Linear

_NEG_INF = -1e9
ATTN_IMPLS = ("auto", "kernel", "plain")


def _layer_norm(d: int) -> LayerNorm:
    return LayerNorm(d, eps=1e-5)


def _check_generator(rate: float, train: bool, generator) -> bool:
    """Whether dropout is on; training with dropout needs a generator."""
    if not train or rate == 0.0:
        return False
    if generator is None:
        raise ValueError("training with dropout needs a torch.Generator (generator=)")
    return True


def dropout(x: torch.Tensor, rate: float, train: bool, generator) -> torch.Tensor:
    """Inverted dropout whose keep mask comes from ``generator``."""
    if not _check_generator(rate, train, generator):
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep * (1.0 / (1.0 - rate))


def split_dropout(x: torch.Tensor, rate: float, train: bool, generator, mg) -> torch.Tensor:
    """``dropout`` of a tensor whose last dim is split over a model group:
    the whole mask is drawn (every rank's generator advances alike) and the
    rank's columns kept, the unsplit model's mask."""
    if mg is None or not _check_generator(rate, train, generator):
        return dropout(x, rate, train, generator)
    n = x.shape[-1]
    keep = torch.empty(x.shape[:-1] + (n * mg.size,), dtype=x.dtype, device=x.device)
    keep = keep.bernoulli_(1.0 - rate, generator=generator)[..., mg.rank * n:(mg.rank + 1) * n]
    return x * keep * (1.0 / (1.0 - rate))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate Q/K/V inputs and projections
    ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``."""

    def __init__(self, model_dim: int, num_heads: int, attn_impl: str = "auto",
                 dropout: float = 0.0):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.model_dim, self.num_heads, self.attn_impl = model_dim, num_heads, attn_impl
        self.dropout = dropout
        self.tp = None  # a tp_lib.ModelGroup under tensor parallelism
        self.q_proj = Linear(model_dim, model_dim)
        self.k_proj = Linear(model_dim, model_dim)
        self.v_proj = Linear(model_dim, model_dim)
        self.out_proj = Linear(model_dim, model_dim)

    def forward(self, query, key, value, key_padding_mask: Optional[torch.Tensor] = None,
                return_weights: bool = False, train: bool = False, generator=None):
        mg = self.tp
        parts = 1 if mg is None else mg.size
        d, h = self.model_dim // parts, self.num_heads // parts  # this rank's share
        dh = d // h
        b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
        if mg is not None:  # f once per distinct input: one all-reduce of its gradient
            copies = {}
            for x in (query, key, value):
                if id(x) not in copies:
                    copies[id(x)] = tp_lib.copy_to(x, mg)
            query, key, value = copies[id(query)], copies[id(key)], copies[id(value)]
        q = self.q_proj(query).view(b, lq, h, dh)
        # The scale is rounded to the model dtype first, as in the JAX model.
        q = q * torch.tensor(dh**-0.5, dtype=q.dtype).item()
        k = self.k_proj(key).view(b, lk, h, dh)
        v = self.v_proj(value).view(b, lk, h, dh)

        rate, seed = 0.0, None
        if _check_generator(self.dropout, train, generator):
            rate = self.dropout
            # One seed per model rank, this rank's taken: its heads draw apart.
            seed = torch.randint(0, 2**62, (parts,), generator=generator, device=q.device)
            seed = seed[mg.rank:mg.rank + 1] if mg is not None else seed
        impl = self.attn_impl
        if impl == "auto":
            impl = "kernel" if q.is_cuda or torch.compiler.is_exporting() else "plain"
        if impl == "kernel" and not return_weights:
            out, attn = flash_attention.mha(q, k, v, key_padding_mask, rate, seed), None
        else:
            # Scores and softmax in float32 whatever the compute dtype (the
            # JAX model's preferred_element_type), float64 products summed
            # in float64 first.
            acc = torch.promote_types(q.dtype, torch.float32)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)).float()
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
            attn = torch.softmax(logits, dim=-1)
            if rate:
                keep = flash_attention.keep_mask(seed, b * h, lq, lk, rate).view(b, h, lq, lk)
                attn = attn * (keep * (1.0 / (1.0 - rate)))
            attn = attn.to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        out = tp_lib.row_parallel(self.out_proj, out.reshape(b, lq, d), mg)
        if return_weights:
            return out, attn.mean(dim=1)  # head-averaged weights
        return out


def _ffn(layer, x, train, generator):
    """linear2(dropout(relu(linear1(x)))), split over the layer's model
    group when it has one."""
    mg = layer.tp
    hidden = F.relu(layer.linear1(tp_lib.copy_to(x, mg)))
    hidden = split_dropout(hidden, layer.dropout, train, generator, mg)
    return tp_lib.row_parallel(layer.linear2, hidden, mg)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer."""

    def __init__(self, model_dim: int, num_heads: int, dim_feedforward: int,
                 attn_impl: str = "auto", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.tp = None  # a tp_lib.ModelGroup under tensor parallelism
        self.self_attn = MultiHeadAttention(model_dim, num_heads, attn_impl, dropout)
        self.norm1 = _layer_norm(model_dim)
        self.linear1 = Linear(model_dim, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, model_dim)
        self.norm2 = _layer_norm(model_dim)

    def forward(self, src, pos, key_padding_mask=None, train=False, generator=None):
        drop = lambda x: dropout(x, self.dropout, train, generator)  # noqa: E731
        qk = src + pos
        attn = self.self_attn(qk, qk, src, key_padding_mask, train=train, generator=generator)
        src = self.norm1(src + drop(attn))
        return self.norm2(src + drop(_ffn(self, src, train, generator)))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: query self-attention (no mask),
    cross-attention to the memory, FFN."""

    def __init__(self, model_dim: int, num_heads: int, dim_feedforward: int,
                 attn_impl: str = "auto", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.tp = None  # a tp_lib.ModelGroup under tensor parallelism
        self.self_attn = MultiHeadAttention(model_dim, num_heads, attn_impl, dropout)
        self.norm1 = _layer_norm(model_dim)
        self.cross_attn = MultiHeadAttention(model_dim, num_heads, attn_impl, dropout)
        self.norm2 = _layer_norm(model_dim)
        self.linear1 = Linear(model_dim, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, model_dim)
        self.norm3 = _layer_norm(model_dim)

    def forward(self, tgt, memory, pos, query_pos, memory_key_padding_mask=None,
                train=False, generator=None):
        drop = lambda x: dropout(x, self.dropout, train, generator)  # noqa: E731
        qk = tgt + query_pos
        attn = self.self_attn(qk, qk, tgt, train=train, generator=generator)
        tgt = self.norm1(tgt + drop(attn))
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory,
                               memory_key_padding_mask, train=train, generator=generator)
        tgt = self.norm2(tgt + drop(attn))
        return self.norm3(tgt + drop(_ffn(self, tgt, train, generator)))


def _recomputed(layer: nn.Module, generator, *args):
    """``layer(*args, generator=generator)`` under a non-reentrant
    checkpoint whose recompute replays the generator's draws."""
    if generator is None:
        return checkpoint(layer, *args, generator=None, use_reentrant=False,
                          preserve_rng_state=False)
    start = generator.get_state()
    calls = []

    def run(*a):
        if not calls:  # the forward: the generator is at ``start``
            calls.append(1)
            return layer(*a, generator=generator)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, generator=generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _check_tp_axis(spec, layers) -> None:
    """ValueError unless every layer is split over ``spec.tp_axis`` of the
    spec's mesh (``parallel.tp.parallelize``), this rank's share."""
    from ..parallel import mesh as mesh_lib

    names = spec.mesh.mesh_dim_names if spec.mesh is not None else ()
    if spec.tp_axis not in (names or ()):
        raise ValueError(f"PipelineSpec.tp_axis {spec.tp_axis!r} is not an axis of the mesh")
    _, rank, size = mesh_lib.axis(spec.mesh, spec.tp_axis)
    want = (rank, size) if size > 1 else None
    if any((None if layer.tp is None else (layer.tp.rank, layer.tp.size)) != want
           for layer in layers):
        raise ValueError(f"PipelineSpec.tp_axis {spec.tp_axis!r}: the model is not split over "
                         "that axis (parallel.tp.parallelize it first)")


class Transformer(nn.Module):
    """Encoder-decoder. Inputs: src and pos (B, S, D), query_embed (Q, D).
    Returns hs (L, B, Q, D), every decoder layer's output through the
    shared ``decoder_norm``, and the encoder memory (B, S, D). ``remat``
    recomputes each layer in the backward."""

    def __init__(self, model_dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, attn_impl: str = "auto",
                 dropout: float = 0.1, remat: bool = False, pipeline=None):
        super().__init__()
        self.remat, self.pipeline, self.dropout = remat, pipeline, dropout
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", EncoderLayer(
                model_dim, num_heads, dim_feedforward, attn_impl, dropout))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(
                model_dim, num_heads, dim_feedforward, attn_impl, dropout))
        self.decoder_norm = _layer_norm(model_dim)

    def forward(self, src, pos, query_embed, key_padding_mask=None, train=False,
                generator=None):
        remat = self.remat and torch.is_grad_enabled()

        def run(layer, *args):
            if remat:
                return _recomputed(layer, generator, *args, train)
            return layer(*args, train, generator)

        if self.pipeline is not None:
            memory = self._pipelined("encoder", {"src": src, "pos": pos}, key_padding_mask,
                                     train, generator)["src"]
        else:
            memory = src
            for i in range(self.num_encoder_layers):
                memory = run(getattr(self, f"encoder_layer_{i}"), memory, pos, key_padding_mask)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1).to(src.dtype)
        tgt = torch.zeros_like(query_pos)
        if self.pipeline is not None and self.num_decoder_layers % self._stages().size == 0:
            b = src.shape[0]
            tree = {"tgt": tgt, "mem": memory, "pos": pos, "qpos": query_pos,
                    "hs": tgt.new_zeros((b, self.num_decoder_layers) + tuple(tgt.shape[1:]))}
            hs = self._pipelined("decoder", tree, key_padding_mask, train, generator)["hs"]
            return self.decoder_norm(hs.movedim(1, 0)), memory
        intermediate = []
        for i in range(self.num_decoder_layers):
            tgt = run(getattr(self, f"decoder_layer_{i}"), tgt, memory, pos, query_pos,
                      key_padding_mask)
            intermediate.append(self.decoder_norm(tgt))
        return torch.stack(intermediate, dim=0), memory

    def _stages(self):
        from ..parallel import pp

        return pp.stage_of(self.pipeline.mesh, self.pipeline.stage_axis)

    def _pipelined(self, kind: str, tree, key_padding_mask, train, generator):
        """The encoder (``tree`` src, pos) or decoder (tgt, mem, pos, qpos,
        hs) stack through ``pp.pipeline_forward``; returns its last stage's
        src or hs, whole on every rank."""
        from ..parallel import pp

        spec = self.pipeline
        stage = self._stages()
        _, _, data = pp.data_of(spec.mesh, spec.data_axis)
        n = self.num_encoder_layers if kind == "encoder" else self.num_decoder_layers
        layers = [getattr(self, f"{kind}_layer_{i}") for i in range(n)]
        if spec.tp_axis is not None:
            _check_tp_axis(spec, layers)
        mine = pp.split_layers_into_stages(list(range(n)), stage.size)[stage.index]
        b = tree["pos"].shape[0]
        n_micro = spec.n_micro or pp.choose_n_micro(b * data, stage.size, data)
        if key_padding_mask is not None:
            tree = dict(tree, kpm=key_padding_mask)
        dropout_on = _check_generator(self.dropout, train, generator)
        seeds = pp.dropout_seeds(generator if dropout_on else None, n, n_micro)
        aux = None if seeds is None else [[row[i] for i in mine] for row in seeds]
        device = tree["pos"].device

        def stage_fn(layer_seeds, a):
            a = dict(a)
            for j, i in enumerate(mine):
                gen = pp.seeded(layer_seeds[j], device) if layer_seeds is not None else None
                if kind == "encoder":
                    a["src"] = layers[i](a["src"], a["pos"], a.get("kpm"), train, gen)
                else:
                    a["tgt"] = layers[i](a["tgt"], a["mem"], a["pos"], a["qpos"], a.get("kpm"),
                                         train, gen)
                    a["hs"] = a["hs"].index_copy(1, torch.tensor([i], device=device),
                                                 a["tgt"][:, None])
            return a

        params = [p for layer in layers for p in layer.parameters()]
        out_key = "src" if kind == "encoder" else "hs"
        return pp.pipeline_forward(
            stage_fn if aux is not None else (lambda a: stage_fn(None, a)), params, tree,
            spec.mesh, n_micro=n_micro, stage_axis=spec.stage_axis,
            remat_stage=spec.remat_stage, out_keys=(out_key,), stage_aux=aux)
