"""The pipeline's arithmetic and the stage boundary's wire format
(detr_tensorflow_tpu_torch/parallel/pp.py, detr_1f1b.py, p2p.py), and
detr_tensorflow_tpu_torch/utils (profiling, trees), held against the JAX
package's functions where it has them. One process, no process group."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.parallel import choose_n_micro, p2p, split_layers_into_stages
from detr_tensorflow_tpu_torch.parallel.detr_1f1b import slot_layers, stage_module_names
from detr_tensorflow_tpu_torch.utils import (
    Timer, benchmark_fn, device_ms_per_step, print_tree_summary, trace, tree_bytes, tree_size,
)
from detr_tensorflow_tpu_torch.utils.profiling import device_stats_per_step
from torch_ranks import one_torch_thread  # noqa: F401

GRID = [(b, s, d) for b in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32) for s in (1, 2, 3, 4, 8)
        for d in (1, 2, 4)]


def test_choose_n_micro_equals_jax():
    """Every (batch, stages, data) of a grid: the same count as the JAX
    package's, or the same ValueError."""
    from detr_tensorflow_tpu.parallel.pp import choose_n_micro as jax_choose

    raised = 0
    for b, s, d in GRID:
        try:
            want = jax_choose(b, s, d)
        except ValueError as e:
            raised += 1
            with pytest.raises(ValueError, match="cannot be microbatched"):
                choose_n_micro(b, s, d)
            assert "data-parallel size" in str(e)
            continue
        assert choose_n_micro(b, s, d) == want, (b, s, d)
    assert 0 < raised < len(GRID)


@pytest.mark.parametrize("n_layers,n_stages", [(4, 2), (6, 3), (8, 4), (6, 1)])
def test_split_equals_jax_stacking(n_layers, n_stages):
    """Divisible depths: stage s holds the layers the JAX package stacks at
    index s (``split_layers_into_stages`` over per-layer trees holding their
    own index); an indivisible depth raises without ``pad``."""
    from detr_tensorflow_tpu.parallel.pp import split_layers_into_stages as jax_split

    stacked = jax_split([{"i": jnp.asarray(i)} for i in range(n_layers)], n_stages)["i"]
    assert split_layers_into_stages(list(range(n_layers)), n_stages) == np.asarray(
        stacked).tolist()
    with pytest.raises(ValueError):
        split_layers_into_stages(list(range(n_layers + 1)), max(n_stages, 2))


def _jax_slots(n_enc, n_dec, n_stages):
    """The JAX 1F1B's slots (``detr_1f1b.py:164-181``): per = ceil(L / S),
    slot i an encoder layer while i < n_enc, a decoder layer while i < L,
    then identity; stage s holds slots s*per .. (s+1)*per - 1."""
    L = n_enc + n_dec
    per = -(-L // n_stages)
    slots = []
    for i in range(n_stages * per):
        if i < n_enc:
            slots.append(("enc", i))
        elif i < L:
            slots.append(("dec", i - n_enc))
        else:
            slots.append(("identity", None))
    return [slots[s * per:(s + 1) * per] for s in range(n_stages)]


@pytest.mark.parametrize("n_enc,n_dec,n_stages", [(3, 2, 2), (3, 2, 4), (4, 1, 4), (6, 6, 2),
                                                  (4, 2, 4)])
def test_1f1b_slots_equal_jax(n_enc, n_dec, n_stages):
    """The 1F1B slot assignment and identity padding equal the JAX
    package's (enc + dec = 5 over 2 stages: 3 + 3 slots, the last one
    identity; over 4: 2 slots a stage, 3 identity slots at the end)."""
    assert slot_layers(n_enc, n_dec, n_stages) == _jax_slots(n_enc, n_dec, n_stages)
    flat = [s for stage in slot_layers(n_enc, n_dec, n_stages) for s in stage]
    assert all(k == "identity" for k, _ in flat[n_enc + n_dec:])


def test_stage_parts_cover_the_model_once():
    """Each stage's module names (``keep_stage``) are disjoint and cover
    every top-level part of DETR-R50's layout: stage 0 the prefix, the last
    stage the norm and heads, the layers by slot."""
    class T:
        num_encoder_layers, num_decoder_layers = 6, 6

    class M:
        transformer = T()

    parts = [stage_module_names(M(), s, 2) for s in range(2)]
    assert parts[0] == ["backbone", "input_proj", "query_embed"] + [
        f"transformer.encoder_layer_{i}" for i in range(6)]
    assert parts[1] == [f"transformer.decoder_layer_{i}" for i in range(6)] + [
        "transformer.decoder_norm", "class_embed", "bbox_embed"]
    four = [stage_module_names(M(), s, 4) for s in range(4)]
    names = [n for part in four for n in part]
    assert len(names) == len(set(names)) == 3 + 12 + 3


def test_p2p_wire_format_round_trips():
    """A boundary dict (float32, float64, bool, int64 leaves of odd sizes)
    packs into one 16-byte-aligned buffer and unpacks to equal tensors; the
    header carries keys, shapes, dtypes and gradient marks; the cotangent
    layout keeps the marked leaves; a tensor of another shape is refused."""
    rng = np.random.default_rng(0)
    tree = {"src": torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32)),
            "pos": torch.from_numpy(rng.normal(size=(2, 3))),
            "mask": torch.from_numpy(rng.uniform(size=(2, 3)) > 0.5),
            "idx": torch.arange(7)}
    spec = p2p.spec_of(tree, {"src": True, "pos": False, "mask": False, "idx": False})
    flat = p2p._pack(tree, spec)
    assert flat.dtype == torch.uint8 and flat.numel() % 16 == 0
    assert flat.numel() == p2p.nbytes(spec) == 128 + 48 + 16 + 64
    back = p2p._unpack(flat, spec)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert [leaf.key for leaf in p2p.cotangent_spec(spec)] == ["src"]

    sent = []
    original = p2p._send_flat, p2p._recv_flat
    try:
        p2p._send_flat = lambda flat, dst, tag: sent.append(flat.clone())
        p2p._recv_flat = lambda total, src, tag, device: sent[0][:total]
        p2p.send_spec(spec, 1, 0, "cpu")
        assert sent[0].numel() == p2p.HEADER_BYTES
        assert p2p.recv_spec(0, 0, "cpu") == spec
    finally:
        p2p._send_flat, p2p._recv_flat = original
    with pytest.raises(ValueError, match="link carries"):
        p2p._pack(dict(tree, src=tree["src"][:1]), spec)


def test_trees_equal_jax():
    """``tree_size`` and ``tree_bytes`` over the converted parameters and
    FrozenBN buffers of the small DETR equal the JAX package's over its
    variables; ``print_tree_summary`` groups a state_dict by its top-level
    names."""
    from detr_tensorflow_tpu.models import DETR as JaxDETR
    from detr_tensorflow_tpu.utils.trees import tree_bytes as jax_bytes
    from detr_tensorflow_tpu.utils.trees import tree_size as jax_size
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
    from test_torch_pipeline import TINY
    from test_torch_training import random_variables

    variables = random_variables(JaxDETR(dropout=0.0, attn_impl="xla", num_decoder_layers=2,
                                         **TINY), jnp.zeros((1, 32, 32, 3)))
    state = from_jax_variables(variables)
    params = from_jax_variables({"params": variables["params"]})
    assert tree_size(state) == jax_size(variables)
    assert tree_bytes(state) == jax_bytes(variables)
    assert tree_size(params) == jax_size(variables["params"])
    assert tree_bytes({"a": [params], "b": (np.zeros((3, 2), np.float16),)}) == \
        jax_bytes(variables["params"]) + 12
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_tree_summary(params)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"params: {jax_size(variables['params']):,} elements")
    assert {line.split(":")[0].strip() for line in lines[1:]} >= {"backbone", "transformer",
                                                                 "query_embed"}


def test_timer_and_benchmark_fn_on_the_cpu():
    """``Timer`` accumulates per name and reads a result back; ``benchmark_fn``
    times a callable's calls (each a positive time)."""
    timer = Timer()
    x = torch.ones(64, 64)
    for _ in range(2):
        with timer("matmul", sync_result={"y": x @ x}):
            pass
    assert timer.counts == {"matmul": 2} and timer.totals["matmul"] > 0
    assert "matmul" in timer.summary()
    stats = benchmark_fn(torch.matmul, x, x, iters=3, warmup=1)
    assert stats["name"] == "matmul" and stats["iters"] == 3 and stats["ms_per_iter"] > 0


def test_device_stats_none_without_cuda_events(tmp_path):
    """A CPU profile holds no CUDA kernel: ``device_stats_per_step`` and
    ``device_ms_per_step`` return None for the profile and for the
    directory its Chrome trace went to (as the JAX package's without a TPU
    plane), and for an empty directory."""
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(32, 32).sum()
    assert list((tmp_path / "t").glob("*.json"))
    assert device_stats_per_step(prof) is None
    assert device_ms_per_step(str(tmp_path / "t")) is None
    assert device_stats_per_step(str(tmp_path / "empty")) is None
