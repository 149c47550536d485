"""bf16 compute on float32 parameters (detr_tensorflow_tpu_torch) against the
JAX package's ``DETR(dtype=bfloat16)``, on the CPU.

Every parameter of the port stays float32 and each layer casts it at its
use, as flax's ``dtype=`` does; a bf16 ``Trainer`` step keeps float32
gradients, clip and Adam moments. Held here: the bf16 forward with a pixel
mask, one bf16 train step's loss and gradients, three Adam steps, an update
below half a bf16 ulp of the weights, the cache of cast copies, float32
parameters in every build, a bf16 trainer's checkpoint, and the float64 step
on the CPU against the JAX package's float64 step.

Both sides get the same variables (a JAX tree of seeded numpy arrays carried
over with ``from_jax_variables``) and the same numpy batches; the JAX side
runs ``attn_impl="xla"``, the port its plain versions. Where a fixed bound
on bf16 would be loose or flaky, the bound is relative to the JAX package's
own bf16 error: the port's bf16 result lies no further from the float64 (or
float32) JAX result than ``GAP_FACTOR`` times JAX bf16's distance from it.
Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.models import DETR as JaxDETR
from detr_tensorflow_tpu.models import weights as jax_weights
from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu.train import Trainer as JaxTrainer
from detr_tensorflow_tpu.train import optimizers as jax_opt
from detr_tensorflow_tpu_torch.models import api, layers
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.train import (
    TrainingConfig, Trainer, latest_step, restore_latest, save_checkpoint,
)
from detr_tensorflow_tpu_torch.train.engine import batch_to_device, forward_loss
from test_torch_models import SMALL, _pixel_mask
from test_torch_models import random_variables as random_variables_for
from test_torch_training import LRS, TINY, make_batch, random_variables

GAP_FACTOR = 2.0
# Per tensor, a gradient or an update is held at a wider factor: the port's
# and JAX's bf16 errors are two draws of rounding noise (the port's GEMMs
# add the bias before their one rounding, flax's after), and on a tensor
# whose bf16 gradient JAX itself gets ~28% wrong (the first decoder layer's
# cross-attention q and k weights) two draws differed by 2.4x. Summed over
# the tensors (root-sum-square of relative errors) the port is held at
# GAP_FACTOR.
TENSOR_GAP_FACTOR = 3.0
# A tensor whose float64 gradient (or update) is below this fraction of the
# largest has an exactly-zero one (every k_proj bias: softmax ignores a
# per-row shift; parts of the first decoder layer's self-attention, whose
# input is zero): its ratio compares rounding noise with rounding noise, and
# it stays out of the sums.
NOISE_FLOOR = 1e-5
# Step 1 runs the backbone group at a learning rate whose Adam update (about
# the rate itself) is below half a bf16 ulp of nearly all its weights.
SUB_ULP_LR = 1e-7
STEP_LRS = [dict(backbone=SUB_ULP_LR, transformers=1e-3),
            dict(backbone=1e-3, transformers=1e-3), dict(backbone=1e-3, transformers=1e-3)]
# The full-width transformer (DETR-R50's d 256, 8 heads, FFN 2048, 100
# queries, 92 classes) on the smallest backbone, two layers each side.
FULL_WIDTH = dict(num_classes=92, num_queries=100, model_dim=256, num_heads=8,
                  num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=2048,
                  backbone_stage_sizes=(1, 1, 1, 1))
CONFIG = TrainingConfig(train_backbone=True, train_transformers=True, target_batch=None, **LRS)


def port_names(tree, dtype=np.float64):
    """A JAX params tree as the port's state_dict names and layouts, in
    ``dtype`` (``from_jax_variables`` without its cast to float32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]:
        *mods, leaf_name = (p.key for p in path)
        arr = np.asarray(leaf, dtype)
        if leaf_name == "kernel":
            leaf_name, arr = "weight", arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf_name == "scale":
            leaf_name = "weight"
        out[".".join(mods + [leaf_name])] = arr
    return out


def jax_clipped_grads(model, variables, batch):
    """JAX loss, log and per-tensor clipped gradients (the port's names)."""
    def loss_fn(params):
        out = model.apply({"params": params, "frozen": variables["frozen"]}, batch["images"],
                          train=True)
        return jax_detr_loss(out, batch["boxes"], batch["classes"], batch["mask"], 0)

    (total, log), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return (float(total), {k: float(v) for k, v in log.items()},
            port_names(jax_opt.clip_by_leaf_norm(0.1).update(grads, None)[0]))


def jax_steps(dtype, variables, batches):
    """A JAX trainer over ``batches`` with STEP_LRS: the losses, the
    parameters after each step (the port's names, float64) and the
    parameter trees after each step (JAX's layout, float32)."""
    config = JaxConfig(background_class=0, train_backbone=True, train_transformers=True,
                       target_batch=None, auto_input_layout=False, **LRS)
    trainer = JaxTrainer(JaxDETR(dropout=0.0, attn_impl="xla", dtype=dtype, **TINY), variables,
                         config)
    losses, params, trees = [], [], []
    for batch, lrs in zip(batches, STEP_LRS):
        trainer.set_learning_rates(**lrs)
        losses.append(float(trainer.step(batch)["total_loss"]))
        params.append(port_names(trainer.state.params))
        trees.append(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  jax.device_get(trainer.state.params)))
    return losses, params, trees


def jax_losses(model, trees, frozen, batches):
    """The set loss of one forward (what a train step reports before its
    update) of each params tree on its batch, through one compile."""
    @jax.jit
    def loss(params, batch):
        out = model.apply({"params": params, "frozen": frozen}, batch["images"], train=True)
        return jax_detr_loss(out, batch["boxes"], batch["classes"], batch["mask"], 0)[0]

    return [float(loss(tree, batch)) for tree, batch in zip(trees, batches)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side of every training comparison: one bf16 and one float64
    gradient of batch 1 (the batch of the fp32 training test), and three
    steps of a bf16 and a float64 trainer, all from one variables tree."""
    variables = random_variables(JaxDETR(dropout=0.0, attn_impl="xla", **TINY),
                                 jnp.zeros((1, 64, 64, 3)))
    batch = make_batch(1)
    batches = [make_batch(10 + i) for i in range(3)]
    runs = {"variables": variables, "batch": batch, "batches": batches}
    runs["bf16"] = jax_clipped_grads(JaxDETR(dropout=0.0, attn_impl="xla", dtype=jnp.bfloat16,
                                             **TINY), variables, batch)
    runs["bf16 steps"] = jax_steps(jnp.bfloat16, variables,
                                   [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    with jax.enable_x64(True):
        v64 = jax.tree.map(_as64, variables)
        runs["f64"] = jax_clipped_grads(
            JaxDETR(dropout=0.0, attn_impl="xla", dtype=jnp.float64, **TINY), v64,
            {k: _as64(v) for k, v in batch.items()})
        runs["f64 steps"] = jax_steps(jnp.float64, v64,
                                      [{k: _as64(v) for k, v in b.items()} for b in batches])
    # JAX bf16's loss at steps 1 and 2 from the float64 trainer's parameters
    # of the step before (rounded to float32, as the port receives them).
    runs["bf16 held losses"] = [runs["bf16 steps"][0][0]] + jax_losses(
        JaxDETR(dropout=0.0, attn_impl="xla", dtype=jnp.bfloat16, **TINY),
        runs["f64 steps"][2][:2], variables["frozen"], batches[1:])
    return runs


def _as64(a):
    a = np.asarray(a)
    return jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)


def port_model(variables, dtype=torch.bfloat16, dropout=0.0, config=TINY):
    model = DETR(dropout=dropout, dtype=dtype, **config)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def check_tensor_gaps(ours, jax16, exact, label):
    """Hold every tensor of ``ours`` against ``exact`` (float64 JAX) beside
    JAX bf16's ``jax16``, in relative distance e = ||x - exact|| / ||exact||:

    * the median of the port's e over the tensors is at most GAP_FACTOR
      times JAX bf16's median;
    * each tensor's e is at most TENSOR_GAP_FACTOR times the larger of JAX
      bf16's e on it and JAX bf16's median (a tensor JAX happens to land
      near leaves the port the typical bf16 error, not less);
    * a tensor whose exact value is below NOISE_FLOOR of the largest norm
      (an exactly-zero gradient, or the update it drives) is held in
      absolute distance, to TENSOR_GAP_FACTOR times the larger of JAX
      bf16's and NOISE_FLOOR of the largest norm.

    Returns the medians and the worst tensor, for the record."""
    scale = max(float(np.linalg.norm(v)) for v in exact.values())
    rel, noise = {}, {}
    for name, ref in exact.items():
        gaps = [float(np.linalg.norm(np.asarray(t[name], np.float64) - ref))
                for t in (ours, jax16)]
        norm = float(np.linalg.norm(ref))
        (rel if norm > NOISE_FLOOR * scale else noise)[name] = (
            np.asarray(gaps) / (norm if norm > NOISE_FLOOR * scale else 1.0))
    ours_med, jax_med = np.median(np.array(list(rel.values())), axis=0)
    worst = max((e[0] / max(e[1], jax_med), n) for n, e in rel.items())
    print(f"{label}: median relative distance port {ours_med:.4f}, jax bf16 {jax_med:.4f}; "
          f"worst tensor {worst[1]} at {worst[0]:.3f} x; {len(noise)} exactly-zero tensors")
    assert ours_med <= GAP_FACTOR * jax_med, label
    for name, (e_ours, e_jax) in rel.items():
        assert e_ours <= TENSOR_GAP_FACTOR * max(e_jax, jax_med), (label, name)
    for name, (g_ours, g_jax) in noise.items():
        assert g_ours <= TENSOR_GAP_FACTOR * max(g_jax, NOISE_FLOOR * scale), (label, name)
    return ours_med, jax_med, worst


def _forward_case(config, seed):
    rng = np.random.default_rng(seed)
    mask = _pixel_mask(2, 96, 160, [(96, 160), (70, 101)])
    x = (rng.normal(size=(2, 96, 160, 3)) * mask[..., None]).astype(np.float32)
    jmod = JaxDETR(dropout=0.0, attn_impl="xla", **config)
    variables = random_variables_for(jmod, jnp.asarray(x), seed=seed)
    ref32, ref16 = (jax.jit(JaxDETR(dropout=0.0, attn_impl="xla", dtype=dt, **config).apply)(
        variables, jnp.asarray(x), jnp.asarray(mask)) for dt in (jnp.float32, jnp.bfloat16))
    model = port_model(variables, config=config).eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(mask))
    return ours, ref16, ref32


# Direct bounds of the port's bf16 forward on JAX bf16's: boxes are sigmoids
# in [0, 1] and logits of order 1-10, both after a few dozen bf16 roundings.
FORWARD_ATOL = {"pred_boxes": 1.5e-2, "pred_logits": 7.5e-2}


@pytest.mark.parametrize("config", [SMALL, FULL_WIDTH], ids=["reduced", "full_width"])
def test_bf16_forward_matches_jax(config):
    """The bf16 forward with a pixel mask against JAX ``DETR(dtype=
    bfloat16)`` on the same float32 variables: boxes and logits of every
    decoder layer within FORWARD_ATOL of JAX bf16's, and no further from
    the JAX float32 forward than GAP_FACTOR times JAX bf16's own distance
    (max |diff|). The reduced case is ``test_detr_reduced_width``'s
    config; the full-width case has DETR-R50's transformer widths."""
    ours, ref16, ref32 = _forward_case(config, seed=3)
    for key in ("pred_boxes", "pred_logits", "aux_boxes", "aux_logits"):
        got = ours[key].numpy().astype(np.float64)
        j16, j32 = (np.asarray(r[key], np.float64) for r in (ref16, ref32))
        assert ours[key].dtype == torch.float32
        direct = float(np.abs(got - j16).max())
        ours_gap, jax_gap = float(np.abs(got - j32).max()), float(np.abs(j16 - j32).max())
        print(f"{key}: |port - jax bf16| {direct:.3e}, |port - jax f32| {ours_gap:.3e}, "
              f"|jax bf16 - jax f32| {jax_gap:.3e}")
        assert direct <= FORWARD_ATOL[key.replace("aux", "pred")], key
        assert ours_gap <= GAP_FACTOR * jax_gap, key


def test_bf16_train_step_matches_jax(jax_runs):
    """One bf16 ``Trainer.step`` at dropout 0 against the JAX train step of
    ``DETR(dtype=bfloat16)`` on the same float32 variables and batch. The
    loss and every log key lie no further from the float64 JAX step's than
    GAP_FACTOR times the larger of JAX bf16's distance and one bf16 ulp
    (2^-8) of the value: the port's resolution is a bf16 rounding, however
    close JAX bf16 happens to land. Every gradient is float32 and, after the
    per-tensor clip, no further from the float64 JAX gradient than
    TENSOR_GAP_FACTOR times JAX bf16's per tensor, and GAP_FACTOR times
    over all tensors."""
    total16, log16, grads16 = jax_runs["bf16"]
    total64, log64, grads64 = jax_runs["f64"]
    model = port_model(jax_runs["variables"])
    log = Trainer(model, CONFIG, seed=0).step(jax_runs["batch"])
    log16, log64 = dict(log16, total_loss=total16), dict(log64, total_loss=total64)
    for key, exact in log64.items():
        ours, jax16 = float(log[key]), log16[key]
        print(f"{key}: port {ours!r}, jax bf16 {jax16!r}, jax f64 {exact!r}")
        assert abs(ours - exact) <= GAP_FACTOR * max(abs(jax16 - exact), 2**-8 * abs(exact)), key
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    check_tensor_gaps({n: p.grad.numpy() for n, p in model.named_parameters()}, grads16,
                      grads64, "gradients")


def test_bf16_adam_steps_keep_float32_master_weights(jax_runs):
    """Three bf16 ``Trainer`` steps at dropout 0 against a bf16 and a
    float64 JAX trainer from the same variables over the same batches.

    Step 0 trains the backbone group at SUB_ULP_LR: its Adam update (about
    the rate) is below half a bf16 ulp of all but the smallest weights, so
    weights held in bf16 would not move. The port's float32 weights move by
    the JAX float32 update: every backbone tensor's update no further from
    the float64 trainer's than TENSOR_GAP_FACTOR times the JAX bf16
    trainer's, while 99% of the moved weights keep their bf16 rounding.

    Each loss is held in the loss form of the step test, with steps 1 and 2
    taken from the float64 trainer's parameters of the step before (beside
    JAX bf16's loss from the same parameters): Adam's first update is about
    lr * sign(g) at 1e-3, so each gradient element that bf16 noise flips
    moves its weight a full 2e-3, and a free-running step 1's loss is a
    compounded draw of that noise, differently on each machine's bf16 CPU
    kernels and thread count. A free-running trainer's three steps are held
    too: every parameter and Adam moment float32 after them, and every
    tensor's update within the gradients' forms."""
    losses16 = jax_runs["bf16 held losses"]
    losses64, params64, trees64 = jax_runs["f64 steps"]
    params16 = jax_runs["bf16 steps"][1]

    def check_loss(i, loss):
        exact = losses64[i]
        print(f"step {i}: loss port {loss!r}, jax bf16 {losses16[i]!r}, jax f64 {exact!r}")
        assert abs(loss - exact) <= GAP_FACTOR * max(abs(losses16[i] - exact),
                                                     2**-8 * abs(exact)), i

    held = port_model(jax_runs["variables"])
    for i, batch in enumerate(jax_runs["batches"][1:], 1):
        held.load_state_dict(from_jax_variables(
            {"params": trees64[i - 1], "frozen": jax_runs["variables"]["frozen"]}))
        with torch.no_grad():  # the loss a step reports is its forward's, before the update
            total, _, _ = forward_loss(held, batch_to_device(batch, torch.device("cpu")),
                                       CONFIG, True)
        check_loss(i, float(total))

    model = port_model(jax_runs["variables"])
    trainer = Trainer(model, CONFIG, seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (batch, lrs) in enumerate(zip(jax_runs["batches"], STEP_LRS)):
        trainer.set_learning_rates(**lrs)
        loss = float(trainer.step(batch)["total_loss"])
        if i == 0:
            check_loss(i, loss)
            backbone = [n for n in start if trainer.optimizer.groups["backbone"]
                        and n.startswith(("backbone.", "input_proj."))]
            moved = {n: (model.get_parameter(n).detach() - start[n]).double().numpy()
                     for n in backbone}
            check_tensor_gaps(moved, *({n: p[n] - start[n].double().numpy() for n in backbone}
                                       for p in (params16[0], params64[0])), "sub-ulp updates")
            now = torch.cat([model.get_parameter(n).detach().flatten() for n in backbone])
            was = torch.cat([start[n].flatten() for n in backbone])
            moved64 = torch.from_numpy(np.concatenate([(params64[0][n] - start[n].double().numpy())
                                                       .ravel() for n in backbone])) != 0
            changed = now != was
            kept = (now.bfloat16() == was.bfloat16())[changed].float().mean()
            print(f"sub-ulp step: float64 moved "
                  f"{float(moved64.float().mean()):.4f} of the backbone's weights, the port "
                  f"{float(changed.float().mean()):.4f}, "
                  f"{float(changed[moved64].float().mean()):.4f} of those; {float(kept):.4f} of "
                  f"the port's moved weights keep their bf16 value")
            assert float(changed[moved64].float().mean()) >= 0.99 and float(kept) >= 0.99
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moments = [t for s in trainer.optimizer.adam.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.dim()]
    assert len(moments) == 2 * len(trainer.optimizer.params)
    assert all(t.dtype == torch.float32 for t in moments)
    check_tensor_gaps(
        {n: (p.detach() - start[n]).double().numpy() for n, p in model.named_parameters()},
        *({n: p[n] - start[n].double().numpy() for n in start} for p in (params16[-1],
                                                                          params64[-1])),
        "updates after three steps")


def _images(seed, b=1, h=64, w=64):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, h, w, 3))
                            .astype(np.float32))


def _cached_copies(module):
    """Every cast copy the model's layers hold: {(layer, key): tensor}."""
    return {(name, key): hit[1] for name, m in module.named_modules()
            for key, hit in getattr(m, "_cache", {}).items() if key[0] == "cast"}


def test_inference_reuses_cast_copies_until_the_weights_change(jax_runs):
    """Without autograd every bf16 layer reads a copy of its float32
    parameters cast once: a second forward uses the same tensors (same data
    pointers), one per parameter of every Linear and Conv. After an
    optimizer step, and after a ``load_state_dict``, the next inference
    forward equals (bit for bit) that of a freshly built model with those
    weights."""
    model = port_model(jax_runs["variables"]).eval()
    x = _images(0)
    with torch.inference_mode():
        first = model(x)
    copies = _cached_copies(model)
    n_cast = sum(1 for m in model.modules() if isinstance(m, (layers.Linear, layers.Conv2d))
                 for p in (m.weight, m.bias) if p is not None)
    assert len(copies) == n_cast and all(t.dtype == torch.bfloat16 for t in copies.values())
    with torch.no_grad():
        again = model(x)
    assert all(_cached_copies(model)[k].data_ptr() == t.data_ptr() for k, t in copies.items())
    assert torch.equal(first["pred_boxes"], again["pred_boxes"])

    def fresh(state):
        other = DETR(dropout=0.0, dtype=torch.bfloat16, **TINY).eval()
        other.load_state_dict(state)
        with torch.no_grad():
            return other(x)

    trainer = Trainer(model, CONFIG, seed=0)
    trainer.step(jax_runs["batch"])
    model.eval()
    with torch.no_grad():
        stepped = model(x)
    ref = fresh(model.state_dict())
    assert not torch.equal(stepped["pred_logits"], first["pred_logits"])
    for key in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        assert torch.equal(stepped[key], ref[key]), key
    model.load_state_dict(from_jax_variables(jax_runs["variables"]))
    with torch.inference_mode():
        reloaded = model(x)
    for key in ("pred_logits", "pred_boxes"):
        assert torch.equal(reloaded[key], first[key]), key


def test_training_forward_records_a_gradient_through_every_cast(jax_runs):
    """While autograd records, every cast is differentiable: one bf16
    training forward and backward gives every parameter a float32 gradient,
    and nothing is read from or written to the cache."""
    model = port_model(jax_runs["variables"]).train()
    out = model(_images(1), train=True)
    (out["pred_logits"].sum() + out["pred_boxes"].sum()
     + out["aux_logits"].sum() + out["aux_boxes"].sum()).backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert not _cached_copies(model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["unfused", "fused", "int8"])
def test_every_build_keeps_float32_parameters(dtype, variant):
    """``build_detr`` keeps every parameter float32 at both compute dtypes,
    unfused, fused and int8 (FrozenBN buffers and ``query_embed`` too, as
    before), and its forward computes in the compute dtype: the fp32 and
    bf16 builds of one seed hold the same weights."""
    kwargs = {"unfused": {}, "fused": dict(fuse_residual=True, fuse_bottleneck=True),
              "int8": dict(backbone_quant=True)}[variant]
    config = dict(num_classes=5, num_queries=6, model_dim=64, num_heads=2,
                  num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32,
                  backbone_stage_sizes=(1, 1, 1, 1), device="cpu", seed=2)
    model = api.build_detr(dtype=dtype, **config, **kwargs)
    module = model.module
    assert module.dtype == api.DTYPES[dtype]
    assert {p.dtype for p in module.parameters()} == {torch.float32}
    assert module.query_embed.dtype == torch.float32
    assert all(b.dtype == torch.float32 for n, b in module.backbone.named_buffers())
    reference = api.build_detr(**config, **kwargs).module.state_dict()
    for name, p in module.named_parameters():
        assert torch.equal(p, reference[name]), name
    x = _images(2)
    if variant == "int8":
        from detr_tensorflow_tpu_torch.models import quantized

        quantized.quantize_model(model, x)
    out = model(x)
    assert out["pred_boxes"].dtype == torch.float32 and torch.isfinite(out["pred_logits"]).all()
    with torch.inference_mode():
        hs, _ = module.transformer(*(torch.zeros((1, 4, 64), dtype=module.dtype)
                                     for _ in range(2)), module.query_embed)
    assert hs.dtype == module.dtype


def test_bf16_weights_load_from_npz_as_float32(tmp_path):
    """A JAX ``.npz`` loads into a bf16 build bit for bit: float32 in,
    float32 out, whatever the compute dtype."""
    jmod = JaxDETR(dropout=0.0, attn_impl="xla", **SMALL)
    variables = random_variables_for(jmod, jnp.zeros((1, 64, 64, 3)))
    path = str(tmp_path / "detr.npz")
    jax_weights.save_variables_npz(jax.device_get(variables), path)
    model = api.build_detr(weights=path, dtype="bfloat16", device="cpu", **SMALL)
    state = model.module.state_dict()
    for name, value in from_jax_variables(variables).items():
        assert state[name].dtype == torch.float32 and torch.equal(state[name], value), name


def test_bf16_trainer_checkpoint_continues_identically(jax_runs, tmp_path):
    """A bf16-compute trainer at dropout 0.1 saves after two steps and a
    trainer built from other weights and another seed restores it: the next
    step gives the same loss and float32 parameters, bit for bit (the cast
    copies are not state: they are derived again from the restored
    weights)."""
    config = CONFIG.replace(checkpoint_dir=str(tmp_path))
    trainer = Trainer(port_model(jax_runs["variables"], dropout=0.1), config, seed=3)
    for i in range(2):
        trainer.step(make_batch(i))
    save_checkpoint(trainer, config.checkpoint_dir)
    assert latest_step(config.checkpoint_dir) == 2
    nxt = make_batch(7)
    ref = trainer.step(nxt)
    other = DETR(dropout=0.1, dtype=torch.bfloat16, **TINY)
    restored = restore_latest(Trainer(other, config, seed=99), config.checkpoint_dir)
    log = restored.step(nxt)
    assert float(log["total_loss"]) == float(ref["total_loss"])
    for (name, a), b in zip(trainer.model.named_parameters(), other.parameters()):
        assert b.dtype == torch.float32 and torch.equal(a, b), name


def test_training_config_builds_a_bf16_model_that_trains():
    """``TrainingConfig(compute_dtype="bfloat16")`` builds, through
    ``get_detr_model``, a bf16-compute model with float32 parameters that
    ``Trainer`` takes; a model whose parameters were cast to bf16 by hand is
    refused, as is a float64 model on a device other than the CPU (checked
    by dtype here: the CPU one trains)."""
    config = TrainingConfig(compute_dtype="bfloat16", train_transformers=True, target_batch=None)
    model = api.get_detr_model(config, include_top=True, device="cpu", num_classes=5,
                               num_queries=6, model_dim=64, num_heads=2, dim_feedforward=32,
                               num_encoder_layers=1, num_decoder_layers=1,
                               backbone_stage_sizes=(1, 1, 1, 1), dropout=0.0).module
    assert model.dtype == torch.bfloat16
    trainer = Trainer(model, config)
    log = trainer.step(make_batch(3))
    assert np.isfinite(float(log["total_loss"]))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="float32 parameters|parameters stay float32"):
        Trainer(DETR(dtype=torch.bfloat16, **TINY).bfloat16(), config)


def test_float64_step_matches_jax_float64_step(jax_runs):
    """``DETR(dtype=torch.float64)`` with ``.double()`` parameters takes a
    ``Trainer`` step on the CPU (every cast a no-op) equal to the JAX
    package's float64 step on the same variables and batch (float64 copies):
    the loss and every log key within 1e-6 relative (a few float32 ulps)
    and every clipped gradient within 1e-5 of its norm plus the largest
    gradient norm (exactly-zero gradients carry rounding noise only). Both
    sides cast the heads' outputs to float32 and score the attention in
    float32, as the JAX model does, so float32 rounding in those places
    bounds the agreement, not float64's."""
    total64, log64, grads64 = jax_runs["f64"]
    model = port_model(jax_runs["variables"], dtype=torch.float64).double()
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in jax_runs["batch"].items()}
    log = Trainer(model, CONFIG, seed=0).step(batch)
    print(f"float64: loss port {float(log['total_loss'])!r}, jax {total64!r}")
    np.testing.assert_allclose(float(log["total_loss"]), total64, rtol=1e-6)
    for key, value in log64.items():
        np.testing.assert_allclose(float(log[key]), value, rtol=1e-6, atol=1e-12, err_msg=key)
    scale = max(float(np.linalg.norm(g)) for g in grads64.values())
    worst = (0.0, "")
    for name, p in model.named_parameters():
        assert p.dtype == torch.float64 and p.grad.dtype == torch.float64
        ref = grads64[name]
        diff, norm = float(np.linalg.norm(p.grad.numpy() - ref)), float(np.linalg.norm(ref))
        worst = max(worst, (diff / (norm + scale), name))
        assert diff <= 1e-5 * (norm + scale), name
    print(f"float64: worst gradient distance {worst[0]:.3e} of (its norm + the largest) "
          f"({worst[1]})")
