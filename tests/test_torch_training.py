"""The port's training step (detr_tensorflow_tpu_torch/train) against the
JAX package's, on a tiny DETR: the optimizer against optax, one
``Trainer.step`` against ``make_train_step`` (loss, log and every
gradient), parameters after three steps, checkpoints, ``fit`` and
``eval_loop``, dropout, and the backbone's maxpool gradient.

Both sides get the same variables (a JAX tree of seeded numpy arrays,
carried over with ``from_jax_variables``) and the same numpy batches.
Dropout is 0 wherever the two are compared: the two frameworks draw other
random bits. Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.ops import maxpool as jax_maxpool
from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu.train import Trainer as JaxTrainer
from detr_tensorflow_tpu.train import optimizers as jax_opt
from detr_tensorflow_tpu_torch.data import pad_targets
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops import maxpool as port_maxpool
from detr_tensorflow_tpu_torch.train import (
    TrainingConfig, Trainer, eval_loop, fit, latest_step, restore_latest, save_checkpoint,
)
from detr_tensorflow_tpu_torch.train import optimizers as opt_lib
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# tests/test_engine.py's tiny DETR, widened to d 64 and 2 heads (the port's
# attention takes head_dim 32 or 64 only).
TINY = dict(num_classes=5, num_queries=6, model_dim=64, num_heads=2, num_encoder_layers=1,
            num_decoder_layers=2, dim_feedforward=32, backbone_stage_sizes=(1, 1, 1, 1))
LRS = dict(backbone_lr=1e-3, transformers_lr=1e-3)


def random_variables(module, images, seed=0):
    """A variables tree of ``module``'s shapes from a numpy seed: kernels
    ~ N(0, 1/fan_in), affines near identity, running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), images)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "running_var":
            x = rng.uniform(0.5, 1.5, size=shape)
        elif name == "query_embed":
            x = rng.normal(size=shape)
        else:
            x = 0.1 * rng.normal(size=shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_batch(seed, b=2, h=64, w=64, t=6):
    """Native fixed-slot batch from numpy, built with ``pad_targets``."""
    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.3, 0.7, (n, 2)),
                                    rng.uniform(0.1, 0.4, (n, 2))], -1),
                    rng.integers(1, 5, size=n), t)
        for n in range(2, 2 + b)))
    return {"images": rng.normal(size=(b, h, w, 3)).astype(np.float32),
            "boxes": np.stack(boxes), "classes": np.stack(classes), "mask": np.stack(mask)}


@pytest.fixture(scope="module")
def jax_model_and_variables():
    model = JaxDETR(dropout=0.0, attn_impl="xla", **TINY)
    return model, random_variables(model, jnp.zeros((1, 64, 64, 3)))


def port_model(variables, dropout=0.0, attn_impl="auto", **overrides):
    model = DETR(dropout=dropout, attn_impl=attn_impl, **dict(TINY, **overrides))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("num_queries", [TINY["num_queries"], 260])
def test_trainer_step_matches_jax_train_step(jax_model_and_variables, num_queries):
    """One ``Trainer.step`` against the JAX train step on the same weights
    and batch, then three steps of both trainers. At 260 queries (past the
    255 columns of the LAP kernel's register instances; on the CPU the plain
    LAP, which the card's generic instance is held to) the single step is
    compared, the three steps only at the default width.

    Loss and every log key: fp32 summation order (rtol 1e-5). Gradients
    (after the per-tensor clip both sides apply): per tensor
    ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-6; tensors whose exact
    gradient is zero (every k_proj bias: softmax ignores a per-row shift;
    layer-0 decoder self-attention, whose values are all equal) carry
    rounding noise of ~1e-7 only. After three steps, every tensor with a
    real gradient has moved like JAX's (relative 1e-2 of its update); a
    noise-only tensor moves by Adam's +-lr steps in both, so it is held
    to 2 * lr * steps.

    The three steps are held against the JAX trainer run in float64 (under
    ``jax.enable_x64``, on float64 copies of the variables and batches):
    the fp32 JAX trainer's result depends on the machine XLA compiles for.
    On one x86 host its backbone weights left float64's path from the
    second step on (52 of layer 1's downsample weights off by up to
    1.2e-3, about lr, after three; 1.2e-2 of the tensor's update), while
    the port's stayed within 1e-5 of float64's (relative 4e-5 of the
    update) on every tensor with a real gradient.

    The batch is chosen to have no pre-ReLU activation within fp32
    rounding of zero: make_batch(0) has one at 2.6e-7 in layer 1, which the
    port rounds to the other side of the kink than JAX and float64 do, and
    that one element moves 1% of the first bottleneck's gradient."""
    jmodel, variables = jax_model_and_variables
    tiny = dict(TINY, num_queries=num_queries)
    if num_queries != TINY["num_queries"]:
        jmodel = JaxDETR(dropout=0.0, attn_impl="xla", **tiny)
        variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3)))
    batch = make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out = jmodel.apply({"params": params, "frozen": variables["frozen"]}, jb["images"],
                           train=True)
        return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], 0)

    (jtotal, jlog), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    jclipped = from_jax_variables(
        {"params": jax_opt.clip_by_leaf_norm(0.1).update(jgrads, None)[0]})

    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None,
                            **LRS)
    model = port_model(variables, num_queries=num_queries)
    trainer = Trainer(model, config, seed=0)
    log = trainer.step(batch)
    np.testing.assert_allclose(float(log["total_loss"]), float(jtotal), rtol=1e-5)
    for key, value in jlog.items():
        np.testing.assert_allclose(float(log[key]), float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    informative = set()
    jgrads = from_jax_variables({"params": jgrads})
    for name, p in model.named_parameters():
        ref = jclipped[name]
        assert float((p.grad - ref).norm()) <= 1e-3 * float(ref.norm()) + 1e-6, name
        if float(jgrads[name].norm()) > 1e-5:
            informative.add(name)
    assert len(informative) > 0.8 * len(jclipped)
    if num_queries != TINY["num_queries"]:
        return

    model = port_model(variables)
    trainer = Trainer(model, config, seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = [make_batch(10 + i) for i in range(3)]
    with jax.enable_x64(True):
        as64 = lambda a: jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)  # noqa: E731
        jtrainer = JaxTrainer(
            JaxDETR(dropout=0.0, attn_impl="xla", dtype=jnp.float64, **TINY),
            jax.tree.map(lambda a: as64(np.asarray(a)), variables), JaxConfig(
                background_class=0, train_backbone=True, train_transformers=True,
                target_batch=None, auto_input_layout=False, **LRS))
        jlosses = [float(jtrainer.step({k: as64(v) for k, v in b.items()})["total_loss"])
                   for b in batches]
        jparams = from_jax_variables({"params": jax.device_get(jtrainer.state.params)})
    for b, jl in zip(batches, jlosses):
        np.testing.assert_allclose(float(trainer.step(b)["total_loss"]), jl, rtol=1e-5)
    for name, p in model.named_parameters():
        moved_jax, moved = jparams[name] - start[name], p.detach() - start[name]
        if name in informative:
            assert _rel(moved, moved_jax) <= 1e-2, name
        else:
            assert float((moved - moved_jax).abs().max()) <= 2 * 1e-3 * 3, name


class _Groups(nn.Module):
    """One parameter tensor or two in each optimizer group."""

    def __init__(self, rng):
        super().__init__()
        init = lambda *s: nn.Parameter(torch.from_numpy(rng.normal(size=s).astype(np.float32)))  # noqa: E731
        self.backbone = nn.ParameterDict({"w": init(4, 3), "b": init(4)})
        self.query_embed = init(5, 2)
        self.transformer = nn.ParameterDict({"w": init(3, 3)})
        self.cls_layer = nn.ParameterDict({"w": init(2, 3)})


def test_optimizer_matches_optax():
    """Per-tensor clip 0.1, Adam, a frozen group and MultiSteps k = 2
    against ``make_optimizer`` + ``scale_updates_by_lr`` over 6 calls with
    the same gradients. Tolerance: fp32 Adam in two frameworks, 1e-6."""
    rng = np.random.default_rng(0)
    model = _Groups(rng)
    jparams = {"backbone": {"w": model.backbone["w"], "b": model.backbone["b"]},
               "query_embed": model.query_embed, "transformer": {"w": model.transformer["w"]},
               "cls_layer": {"w": model.cls_layer["w"]}}
    jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), jparams)
    config = TrainingConfig(train_backbone=True, train_transformers=True, train_nlayers=False,
                            batch_size=1, target_batch=2, backbone_lr=1e-2,
                            transformers_lr=3e-2, nlayers_lr=1e-2)
    jcfg = JaxConfig(train_backbone=True, train_transformers=True, train_nlayers=False,
                     batch_size=1, target_batch=2)
    tx = jax_opt.make_optimizer(jcfg, jparams)
    state = tx.init(jparams)
    jlrs = {"backbone": 1e-2, "transformers": 3e-2, "nlayers": 1e-2}
    opt = opt_lib.make_optimizer(config, model)
    assert not model.cls_layer["w"].requires_grad
    frozen = model.cls_layer["w"].detach().clone()
    named = dict(model.named_parameters())
    for step in range(6):
        # Norms on both sides of the clip: some tensors shrunk by 100.
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * (0.01 if step % 3 == 0 else 1.0),
                                  jnp.float32), jparams)
        updates, state = tx.update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams,
                               jax_opt.scale_updates_by_lr(updates, jlrs))
        flat = {
            "backbone.w": grads["backbone"]["w"], "backbone.b": grads["backbone"]["b"],
            "query_embed": grads["query_embed"], "transformer.w": grads["transformer"]["w"],
            "cls_layer.w": grads["cls_layer"]["w"]}
        for name, p in named.items():
            p.grad = torch.from_numpy(np.array(flat[name])) if p.requires_grad else None
        applied = opt.step(opt_lib.lr_dict(config))
        assert applied == (step % 2 == 1)
        for name, ref in (("backbone.w", jparams["backbone"]["w"]),
                          ("backbone.b", jparams["backbone"]["b"]),
                          ("query_embed", jparams["query_embed"]),
                          ("transformer.w", jparams["transformer"]["w"]),
                          ("cls_layer.w", jparams["cls_layer"]["w"])):
            np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(ref),
                                       atol=1e-6, rtol=1e-6, err_msg=f"{name} step {step}")
    assert torch.equal(model.cls_layer["w"].detach(), frozen)


def test_param_labels_partition():
    model = DETR(head="finetune", nb_class=4, dropout=0.0, **TINY)
    labels = opt_lib.param_labels(model)
    assert labels["backbone.conv1.weight"] == "backbone"
    assert labels["input_proj.weight"] == labels["query_embed"] == "backbone"
    assert all(v == "transformers" for k, v in labels.items() if k.startswith("transformer."))
    assert labels["cls_layer.weight"] == labels["pos_layer.layer_0.bias"] == "nlayers"


def test_checkpoint_restore_continues_identically(jax_model_and_variables, tmp_path):
    """Save after 3 micro-steps of a k = 2, dropout 0.1 run (an accumulation
    buffer half full), restore into a trainer built from other weights and
    another seed: the next step gives the same loss and parameters, bit for
    bit."""
    _, variables = jax_model_and_variables
    config = TrainingConfig(train_backbone=True, train_transformers=True, batch_size=2,
                            target_batch=4, checkpoint_dir=str(tmp_path), **LRS)
    trainer = Trainer(port_model(variables, dropout=0.1), config, seed=3)
    for i in range(3):
        trainer.step(make_batch(i))
    save_checkpoint(trainer, config.checkpoint_dir)
    assert latest_step(config.checkpoint_dir) == 3
    nxt = make_batch(7)
    ref_log = trainer.step(nxt)

    other = DETR(dropout=0.1, **TINY)
    restored = restore_latest(Trainer(other, config, seed=99), config.checkpoint_dir)
    assert restored is not None and restored.steps == 3
    log = restored.step(nxt)
    assert float(log["total_loss"]) == float(ref_log["total_loss"])
    for (name, a), b in zip(trainer.model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), name


def test_fit_eval_loop_and_dropout_training(jax_model_and_variables, tmp_path, capsys):
    """``fit`` over native batches with periodic checkpoints, ``eval_loop``,
    and training at dropout 0.1: finite logs, falling loss on a repeated
    batch, and dropout only in training."""
    _, variables = jax_model_and_variables
    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None,
                            checkpoint_dir=str(tmp_path / "ckpt"), **LRS)
    trainer = Trainer(port_model(variables, dropout=0.1), config, seed=0)
    batch = make_batch(1)
    logs = []
    assert fit(trainer, [batch] * 8, config, epoch_nb=0, log_every=1, checkpoint_every=4,
               log_fn=lambda log, step: logs.append(log["total_loss"])) is True
    assert trainer.steps == 8 and latest_step(config.checkpoint_dir) == 8
    assert "Epoch: [0]" in capsys.readouterr().out
    assert all(np.isfinite(logs)) and logs[-1] < logs[0], logs
    evals = eval_loop(trainer, [batch, make_batch(2)], config)
    assert len(evals) == 2 and all(np.isfinite(v) for e in evals for v in e.values())
    out_a, _ = trainer.evaluate(batch)
    out_b, _ = trainer.evaluate(batch)
    assert torch.equal(out_a["pred_boxes"], out_b["pred_boxes"])
    with pytest.raises(ValueError, match="Generator"):
        trainer.model(torch.zeros((1, 64, 64, 3)), train=True)


def test_dropout_routes_agree_in_training(jax_model_and_variables):
    """Training at dropout 0.1 from one generator seed: the "kernel" route
    (its plain version on the CPU) and the "plain" route draw the same
    seeds and masks, so loss and gradients agree (summation order only)."""
    _, variables = jax_model_and_variables
    config = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None,
                            **LRS)
    logs, grads = [], []
    for impl in ("kernel", "plain"):
        model = port_model(variables, dropout=0.1, attn_impl=impl)
        trainer = Trainer(model, config, seed=5)
        logs.append(float(trainer.step(make_batch(3))["total_loss"]))
        grads.append([p.grad.clone() for p in model.parameters()])
    np.testing.assert_allclose(logs[0], logs[1], rtol=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_set_trainable_and_learning_rates(jax_model_and_variables):
    """Frozen groups do not move; ``set_trainable`` rebuilds the optimizer
    with fresh moments and keeps the step count; unknown groups raise."""
    _, variables = jax_model_and_variables
    config = TrainingConfig(train_transformers=True, target_batch=None)
    trainer = Trainer(port_model(variables), config)
    backbone = {n: p.detach().clone() for n, p in trainer.model.backbone.named_parameters()}
    trainer.step(make_batch(0))
    for n, p in trainer.model.backbone.named_parameters():
        assert not p.requires_grad and torch.equal(p, backbone[n])
    assert trainer.optimizer.adam.state
    trainer.set_trainable(train_backbone=True)
    trainer.set_learning_rates(backbone=1e-3)
    assert not trainer.optimizer.adam.state and trainer.steps == 1
    trainer.step(make_batch(1))
    assert any(not torch.equal(p, backbone[n])
               for n, p in trainer.model.backbone.named_parameters())
    with pytest.raises(KeyError):
        trainer.set_learning_rates(heads=1e-3)


def test_maxpool_backward_routes_ties_to_the_first_max():
    """The backbone's max pool, the port's max_pool_3x3_s2 (the stem's
    nonneg=True call and the general one), on a tie-heavy non-negative
    input against the JAX max_pool_3x3_s2 custom VJP: the first maximum in
    row-major window order takes the whole gradient (a pixel winning two
    windows sums them: fp32 order, atol 1e-6). Both memory formats the
    port's tensors come in."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, size=(2, 9, 11, 4)).astype(np.float32)  # NHWC, many ties
    g = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    jout, vjp = jax.vjp(jax_maxpool.max_pool_3x3_s2, jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    for nonneg in (True, False):
        for fmt in (torch.contiguous_format, torch.channels_last):
            tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            tx.requires_grad_()
            out = port_maxpool.max_pool_3x3_s2(tx, nonneg=nonneg)
            np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                          np.asarray(jout))
            out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
            np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgrad),
                                       atol=1e-6)
