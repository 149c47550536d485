"""The JAX package's public functions that the port lacked until now,
against the JAX ones: one-problem matching (``ops/matcher.py``
``solve_lap``, ``solve_lap_masked``, ``hungarian_match``), the backbone
builders (``models/resnet.py`` ``resnet50_backbone``,
``resnet101_backbone``) and ``Predictor.warmup(shapes, batch)``.

On the CPU the matching runs the LAP's plain version; on the card each
one-problem call is one launch of kernel B (``tests/test_torch_cuda.py``).
Assignments are held exactly (continuous seeded costs have one optimum),
the backbone's features to 1e-4 relative to their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from detr_tensorflow_tpu.models import resnet as jax_resnet
from detr_tensorflow_tpu.ops import matcher as jax_matcher
from detr_tensorflow_tpu_torch.models import build_detr, resnet
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops import matcher
from detr_tensorflow_tpu_torch.predictor import Predictor
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

PROBLEMS = 20
Q, T, NCLS = 12, 7, 6


def _match_problem(seed):
    """One image's predictions and padded targets from a float64 numpy
    draw: Q queries, T slots of which 0..T are real (seed 0: none, seed 1:
    all), cast to float32 as the models produce them."""
    rng = np.random.default_rng(seed)
    n = {0: 0, 1: T}.get(seed, int(rng.integers(0, T + 1)))
    logits = rng.normal(size=(Q, NCLS))
    p_box = np.concatenate([rng.uniform(0.2, 0.8, (Q, 2)), rng.uniform(0.05, 0.5, (Q, 2))], -1)
    t_box = np.zeros((T, 4))
    t_box[:n] = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.5, (n, 2))],
                               -1)
    t_class = np.zeros(T, np.int32)
    t_class[:n] = rng.integers(1, NCLS, n)
    return (p_box.astype(np.float32), logits.astype(np.float32), t_box.astype(np.float32),
            t_class, np.arange(T) < n)


def test_hungarian_match_equals_jax_on_seeded_problems():
    """``hungarian_match`` of one image against JAX's on PROBLEMS seeded
    problems, padded targets included; each equals row 0 of the batch form
    and the real targets' assignment is scipy's."""
    jax_match = jax.jit(jax_matcher.hungarian_match)
    for seed in range(PROBLEMS):
        args = _match_problem(seed)
        ours = matcher.hungarian_match(*(torch.from_numpy(a) for a in args))
        ref = jax_match(*(jnp.asarray(a) for a in args))
        batch = matcher.hungarian_match_batch(*(torch.from_numpy(a[None]) for a in args))
        for key in ("target_of_pred", "pred_of_target", "pred_matched"):
            assert ours[key].shape == np.asarray(ref[key]).shape
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
            assert torch.equal(ours[key], batch[key][0])
        n = int(args[4].sum())
        cost = matcher.cost_matrix(*(torch.from_numpy(a) for a in args)).numpy()
        rows, cols = linear_sum_assignment(cost.T[:n])
        np.testing.assert_array_equal(ours["pred_of_target"].numpy()[:n], cols)
        assert (ours["pred_of_target"].numpy()[n:] == -1).all()


def test_solve_lap_and_solve_lap_masked_equal_jax():
    """Square problems through ``solve_lap`` and rectangular masked ones
    through ``solve_lap_masked``, float64 draws (0..R real rows), against
    JAX and scipy."""
    jax_square, jax_masked = jax.jit(jax_matcher.solve_lap), jax.jit(jax_matcher.solve_lap_masked)
    for seed in range(PROBLEMS):
        rng = np.random.default_rng(100 + seed)
        square = rng.uniform(-2, 3, (Q, Q))
        ours = matcher.solve_lap(torch.from_numpy(square))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_square(
            jnp.asarray(square, jnp.float32))))
        np.testing.assert_array_equal(ours.numpy(), linear_sum_assignment(square)[1])
        cost, real = rng.uniform(0, 1, (T, Q)), {0: 0, 1: T}.get(seed, int(rng.integers(0, T)))
        mask = np.arange(T) < real
        ours = matcher.solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(mask))
        ref = jax_masked(jnp.asarray(cost, jnp.float32), jnp.asarray(mask))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ours.numpy()[:real], linear_sum_assignment(cost[:real])[1])
        assert (ours.numpy()[real:] == -1).all()
    with pytest.raises(ValueError):
        matcher.solve_lap(torch.zeros(3, 4))


def _converted_shapes(tree):
    """The port's state_dict shapes of a JAX variables tree of shapes."""
    arrays = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)
    return {k: tuple(v.shape) for k, v in from_jax_variables(arrays).items()}


@pytest.mark.parametrize("depth,dilation", [(50, False), (101, False), (101, True)])
def test_backbone_builders_have_jax_stages_and_shapes(depth, dilation):
    builder = {50: "resnet50_backbone", 101: "resnet101_backbone"}[depth]
    ours = getattr(resnet, builder)(dilation=dilation)
    ref = getattr(jax_resnet, builder)(dilation=dilation)
    assert ours.stage_sizes == tuple(ref.stage_sizes)
    assert ours.dtype == torch.float32
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == _converted_shapes(shapes)
    out = jax.eval_shape(ref.apply, shapes, jnp.zeros((1, 64, 64, 3)))
    with torch.no_grad():
        assert tuple(ours(torch.zeros(1, 64, 64, 3)).permute(0, 2, 3, 1).shape) == out.shape


def test_resnet50_backbone_matches_jax_on_converted_weights():
    """DETR-R50's backbone from ``resnet50_backbone`` with seeded weights
    (nonzero FrozenBN buffers) at 64x96: the port's NCHW c5 against JAX's
    NHWC c5."""
    from test_torch_models import random_variables

    x = np.random.default_rng(7).normal(size=(2, 64, 96, 3)).astype(np.float32)
    ref_module = jax_resnet.resnet50_backbone()
    variables = jax.device_get(random_variables(ref_module, jnp.asarray(x), seed=7))
    ref = np.asarray(jax.jit(ref_module.apply)(variables, jnp.asarray(x)))
    ours = resnet.resnet50_backbone()
    ours.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2, 3, 2048)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    bf16 = resnet.resnet50_backbone(dtype=torch.bfloat16)
    bf16.load_state_dict(ours.state_dict())
    with torch.no_grad():
        assert bf16(torch.from_numpy(x)).dtype == torch.bfloat16


def test_warmup_runs_each_bucket_at_the_batch():
    """``warmup(shapes, batch=2)`` runs each bucket once at batch 2 (masked,
    as a padded request runs) and records the bucket."""
    model = build_detr(num_queries=5, model_dim=64, num_heads=2, num_encoder_layers=1,
                       num_decoder_layers=1, dim_feedforward=32,
                       backbone_stage_sizes=(1, 1, 1, 1), device="cpu")
    seen = []
    hook = model.module.register_forward_pre_hook(
        lambda module, args: seen.append((tuple(args[0].shape), args[1] is not None)))
    pred = Predictor(model, background_class=91, bucket_divisor=64)
    pred.warmup([(60, 90), (64, 64)], batch=2)
    hook.remove()
    assert seen == [((2, 64, 128, 3), True), ((2, 64, 64, 3), True)]
    assert pred.buckets == {(64, 128), (64, 64)}
    with pytest.raises(ValueError):
        pred.warmup([(64, 64)], batch=0)
