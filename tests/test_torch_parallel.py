"""Data parallelism across processes (detr_tensorflow_tpu_torch/parallel,
``Trainer(mesh=)``), held against the JAX package's step on a 2-device mesh
and against the port's one-process step.

Two Gloo ranks on the CPU train the tiny DETR of tests/test_multihost.py
(model_dim 16, 2 heads, one encoder and one decoder layer, stages
(1, 1, 1, 1), 6 queries, 32x32 images) on a global batch of 4: rank 0's
two images hold 6 real boxes, rank 1's hold 1, so per-rank loss
normalization would give another gradient than the global batch's. The
ranks are processes of their own, started by ``torch_ranks.run_ranks``
from a worker script written to ``tmp_path`` (it imports no JAX).
One run of the worker serves the module's tests: it writes what each test
reads. Tolerances are stated at each comparison.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.data import pad_targets
from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.parallel import multihost
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig, restore_latest
from detr_tensorflow_tpu_torch.train import optimizers as opt_lib
from test_torch_entry_points import coco_root  # noqa: F401  (the synthetic COCO set fixture)
from torch_ranks import REPO, WAIT_S, one_torch_thread, run_ranks  # noqa: F401

TINY = dict(num_classes=8, num_queries=6, model_dim=16, num_heads=2, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=32, backbone_stage_sizes=(1, 1, 1, 1))
BOXES_PER_IMAGE = (4, 2, 1, 0)  # rank 0: 6 real boxes, rank 1: 1
LR = 1e-3
CONFIG = dict(background_class=7, train_backbone=True, train_transformers=True,
              train_nlayers=True, batch_size=4, target_batch=None, backbone_lr=LR,
              transformers_lr=LR, nlayers_lr=LR)


def make_global_batch(seed=0, counts=BOXES_PER_IMAGE, size=32):
    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.3, 0.7, (n, 2)),
                                    rng.uniform(0.1, 0.4, (n, 2))], -1),
                    rng.integers(1, 7, size=n), TINY["num_queries"])
        for n in counts))
    return {"images": rng.normal(size=(len(counts), size, size, 3)).astype(np.float32),
            "boxes": np.stack(boxes), "classes": np.stack(classes), "mask": np.stack(mask)}


def with_masks(batch, seed=0):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=batch["boxes"].shape[:2] + (8, 8)) > 0.5).astype(np.uint8)
    return dict(batch, t_masks=t)


# The DP worker: every step the tests below check, in one run of 2 ranks.
DP_WORKER = '''
    from detr_tensorflow_tpu_torch.data import HostDataset
    from detr_tensorflow_tpu_torch.data.multiscale import MultiScalePlan
    from detr_tensorflow_tpu_torch.models import transformer
    from detr_tensorflow_tpu_torch.models.detr import DETR
    from detr_tensorflow_tpu_torch.ops.losses import detr_loss
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig, save_checkpoint
    from detr_tensorflow_tpu_torch.train import optimizers as opt_lib

    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    tiny, cfg = spec["tiny"], spec["config"]
    mesh = make_mesh(world)
    result = {}

    def grads(model):
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    # fp32: the per-rank-normalized control, then the Trainer's step.
    model = DETR(dropout=0.0, **tiny)
    model.load_state_dict(spec["weights"])
    trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
    local = {k: torch.as_tensor(v) for k, v in shard_batch(spec["batch"], mesh).items()}
    out_ = trainer.ddp(local["images"], train=True)
    total, _ = detr_loss(out_, local["boxes"], local["classes"], local["mask"], 7)
    total.backward()
    control = grads(model)
    opt_lib.clip_by_leaf_norm_(list(control.values()), 0.1)
    trainer.optimizer.zero_grad()
    log = trainer.step(local)
    result["fp32"] = {"log": {k: float(v) for k, v in log.items()}, "grads": grads(model),
                      "control": control}

    # float64: one step's gradients, three Adam steps, then set_trainable
    # (DDP rebuilt over the transformer and heads only) and one more step,
    # a checkpoint, and the step after it.
    model = DETR(dropout=0.0, dtype=torch.float64, **tiny).double()
    model.load_state_dict(spec["weights"])
    trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
    logs = []
    for i, batch in enumerate(spec["batches64"]):
        logs.append(float(trainer.step(shard_batch(batch, mesh))["total_loss"]))
        if i == 0:
            result["grads64"] = grads(model)
    result["params64"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.set_trainable(train_backbone=False)
    n_ddp = sum(1 for p in trainer.ddp.module.parameters() if p.requires_grad)
    logs.append(float(trainer.step(shard_batch(spec["batches64"][0], mesh))["total_loss"]))
    variables = {k: v.clone() for k, v in trainer.variables.items()}
    result["frozen64"] = {"variables": variables, "ddp_params": n_ddp}
    save_checkpoint(trainer, os.path.join(out, "ckpt"))
    result["resume"] = {"variables": variables, "steps": trainer.steps}
    logs.append(float(trainer.step(shard_batch(spec["batches64"][1], mesh))["total_loss"]))
    result["losses64"] = logs

    # masks: the segmentation step with t_masks.
    model = DETR(dropout=0.0, masks=True, **tiny)
    model.load_state_dict(spec["mask_weights"])
    trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
    log = trainer.step(shard_batch(spec["mask_batch"], mesh))
    result["masks"] = {"log": {k: float(v) for k, v in log.items()}, "grads": grads(model)}

    # dropout: each rank's generator and a mask drawn from it.
    model = DETR(dropout=0.1, **tiny)
    trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
    g = torch.Generator().set_state(trainer.generator.get_state())
    result["generator"] = trainer.generator.get_state()
    result["keep"] = transformer.dropout(torch.ones(4096), 0.1, True, g)

    # The loader: a multi-scale plan (sync by default across processes) and
    # this rank's rows of each global batch.
    plan = MultiScalePlan(spec["ladder"], seed=3)
    examples = spec["examples"]
    dataset = HostDataset(range(len(examples)), lambda i: examples[i], 4, seed=5,
                          num_workers=2, batch_transform=plan.batch_transform,
                          on_epoch_start=plan.set_epoch)
    dataset.set_shard(rank, world)
    result["loader"] = {"sync": plan.sync, "batches": [b for _ in range(2) for b in dataset]}

    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()
'''


def _spec_weights():
    """The tiny model's weights from a numpy seed (test_torch_training's
    ``random_variables``), the JAX tree and the port's state_dict."""
    import jax.numpy as jnp

    from detr_tensorflow_tpu.models import DETR as JaxDETR
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
    from test_torch_training import random_variables

    jmodel = JaxDETR(dropout=0.0, attn_impl="xla", **TINY)
    variables = random_variables(jmodel, jnp.zeros((1, 32, 32, 3)))
    return jmodel, variables, from_jax_variables(variables)


def _examples():
    rng = np.random.default_rng(7)
    out = []
    for i in range(14):
        ex = make_global_batch(seed=100 + i, counts=(1 + i % 3,), size=48)
        ex = {k: v[0] for k, v in ex.items()}
        ex["images"] = rng.normal(size=(48, 48, 3)).astype(np.float32)
        out.append(ex)
    return out


LADDER = ((32, 32), (48, 48), (40, 32))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX reference and the 2-rank worker's results."""
    out = tmp_path_factory.mktemp("dp")
    jmodel, variables, weights = _spec_weights()
    torch.manual_seed(0)
    mask_weights = DETR(dropout=0.0, masks=True, **TINY).state_dict()
    spec = {"tiny": TINY, "config": CONFIG, "weights": weights,
            "batch": make_global_batch(0),
            "batches64": [make_global_batch(s) for s in (1, 2, 3)],
            "mask_weights": mask_weights, "mask_batch": with_masks(make_global_batch(4)),
            "ladder": LADDER, "examples": _examples()}
    torch.save(spec, out / "spec.pt")
    run_ranks(DP_WORKER, 2, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"dir": out, "spec": spec, "ranks": ranks, "jax": (jmodel, variables)}


@pytest.fixture(scope="module")
def jax_ref(dp_run):
    """JAX's loss, log and gradients of the worker's fp32 batch on a
    2-device mesh."""
    return _jax_clipped_grads(*dp_run["jax"], dp_run["spec"]["batch"], 2)


def _jax_clipped_grads(jmodel, variables, batch, mesh_size):
    """JAX loss, log and per-tensor-clipped gradients of the global batch,
    jitted with the batch sharded over a ``mesh_size``-device mesh."""
    import jax
    import jax.numpy as jnp

    from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
    from detr_tensorflow_tpu.parallel import make_mesh, shard_batch
    from detr_tensorflow_tpu.train import optimizers as jax_opt
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables

    mesh = make_mesh(mesh_size)
    jb = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)

    def loss_fn(params):
        out = jmodel.apply({"params": params, "frozen": variables["frozen"]}, jb["images"],
                           train=True)
        return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], 7)

    (total, log), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    clipped = jax_opt.clip_by_leaf_norm(0.1).update(grads, None)[0]
    return float(total), {k: float(v) for k, v in log.items()}, from_jax_variables(
        {"params": clipped}), from_jax_variables({"params": grads})


def _grad_misses(got, ref, raw_ref):
    """Names whose gradient misses test_torch_training's tolerance,
    ||g - g_ref|| <= 1e-3 ||g_ref|| + 1e-6 per tensor, and the count of
    tensors with a real gradient."""
    misses = [n for n, r in ref.items() if not float((got[n] - r).norm())
              <= 1e-3 * float(r.norm()) + 1e-6]
    informative = sum(float(raw_ref[n].norm()) > 1e-5 for n in ref)
    return misses, informative


def test_dp_step_matches_jax_two_device_mesh(dp_run, jax_ref):
    """The 2-rank step against JAX's step on make_mesh(2) over the same
    global batch (6 real boxes on rank 0, 1 on rank 1): loss and every log
    key to rtol 1e-5 (atol 1e-6), every clipped gradient to
    ||g - g_jax|| <= 1e-3 ||g_jax|| + 1e-6, both ranks' logs equal."""
    total, jlog, jclipped, jgrads = jax_ref
    ours = dp_run["ranks"][0]["fp32"]
    assert ours["log"] == dp_run["ranks"][1]["fp32"]["log"]
    np.testing.assert_allclose(ours["log"]["total_loss"], total, rtol=1e-5)
    for key, value in jlog.items():
        np.testing.assert_allclose(ours["log"][key], value, rtol=1e-5, atol=1e-6, err_msg=key)
    misses, informative = _grad_misses(ours["grads"], jclipped, jgrads)
    assert not misses and informative > 0.8 * len(jclipped)
    for name, g in dp_run["ranks"][1]["fp32"]["grads"].items():
        assert torch.equal(g, ours["grads"][name]), name


def test_per_rank_normalization_misses_the_tolerance(dp_run, jax_ref):
    """The control: the same ranks normalizing each loss by their own boxes
    (6 and 1) and DDP averaging, against the same JAX gradients, misses the
    tolerance the global normalizers meet."""
    _, _, jclipped, jgrads = jax_ref
    misses, _ = _grad_misses(dp_run["ranks"][0]["fp32"]["control"], jclipped, jgrads)
    assert len(misses) > 0.5 * len(jclipped), misses


def _one_process(spec, float64=True, masks=False):
    """The one-process model and trainer of the worker's runs."""
    model = DETR(dropout=0.0, masks=masks, **TINY)
    if float64:
        model = DETR(dropout=0.0, dtype=torch.float64, **TINY).double()
    model.load_state_dict(spec["mask_weights" if masks else "weights"])
    return model, Trainer(model, TrainingConfig(**CONFIG), seed=0)


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-300)


@pytest.fixture(scope="module")
def one_process64(dp_run):
    """The worker's float64 run in one process: three steps (the first
    step's gradients, the losses, the parameters after them), then
    ``set_trainable(train_backbone=False)`` and one more step."""
    spec = dp_run["spec"]
    model, trainer = _one_process(spec)
    run = {"start": {n: p.detach().clone() for n, p in model.named_parameters()}, "losses": []}
    for i, batch in enumerate(spec["batches64"]):
        run["losses"].append(float(trainer.step(batch)["total_loss"]))
        if i == 0:
            run["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    run["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.set_trainable(train_backbone=False)
    trainer.step(spec["batches64"][0])
    run["frozen"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    run["trainable"] = sum(p.requires_grad for p in model.parameters())
    run["labels"] = opt_lib.param_labels(model)
    return run


def test_dp_float64_step_and_adam_steps_match_one_process(dp_run, one_process64):
    """float64, 2 ranks against one process: every gradient of the first
    step to 1e-10 relative; the losses to float32 rounding (rtol 1e-6: the
    heads cast their outputs to float32, as the JAX model does, so the loss
    terms are float32 sums in another order); the parameters after three
    Adam steps to 1e-10 relative of their update, except tensors whose
    exact gradient is zero (every k_proj bias), which carry rounding noise
    that Adam turns into +-lr steps: those within 2 lr x 3."""
    ours, ref = dp_run["ranks"][0], one_process64
    for name, g in ref["grads"].items():
        assert _rel(ours["grads64"][name], g) <= 1e-10 or float(g.norm()) < 1e-12, name
    np.testing.assert_allclose(ours["losses64"][:3], ref["losses"], rtol=1e-6)
    for name, p in ref["params"].items():
        moved, moved_ref = ours["params64"][name] - ref["start"][name], p - ref["start"][name]
        if "k_proj.bias" in name:
            assert float((moved - moved_ref).abs().max()) <= 2 * LR * 3, name
        else:
            assert _rel(moved, moved_ref) <= 1e-10, name


def test_dp_set_trainable_rebuilds_ddp(dp_run, one_process64):
    """``set_trainable(train_backbone=False)`` under DDP: the wrapper is
    rebuilt over the remaining parameters, the backbone stays put, and the
    next step's parameters equal one process's (float64, as above)."""
    ours, ref = dp_run["ranks"][0], one_process64
    frozen = ours["frozen64"]
    assert frozen["ddp_params"] == ref["trainable"] < len(ref["params"])
    for name, p in ref["frozen"].items():
        got, before = frozen["variables"][name], ref["params"][name]
        if ref["labels"][name] == "backbone":
            assert torch.equal(got, ours["params64"][name]), name
        elif "k_proj.bias" not in name:
            assert _rel(got - before, p - before) <= 1e-8, name


def test_world_two_checkpoint_resumes_at_world_one(dp_run):
    """A checkpoint written by rank 0 of the 2-rank run loads into a
    one-process trainer: the same step count, the parameters and FrozenBN
    buffers bit-equal to the world-2 run's, and the next step's loss equal
    to that run's continuation (rtol 1e-6, float32 loss terms); its model
    state converts to the JAX package's variables tree."""
    spec, ours = dp_run["spec"], dp_run["ranks"][0]
    model = DETR(dropout=0.0, dtype=torch.float64, **TINY).double()
    config = TrainingConfig(**dict(CONFIG, train_backbone=False))
    trainer = Trainer(model, config, seed=9)
    restore_latest(trainer, str(dp_run["dir"] / "ckpt"))
    assert trainer.steps == ours["resume"]["steps"] == 4
    for name, t in trainer.variables.items():
        assert torch.equal(t, ours["resume"]["variables"][name]), name
    # The saved generator is rank 0's, which data rank 0 takes as it is.
    saved = torch.load(dp_run["dir"] / "ckpt" / "4.pt", weights_only=False)
    assert torch.equal(trainer.generator.get_state(), saved["generator"])
    # Its names are the module's: it converts to the JAX package's tree.
    import jax

    from detr_tensorflow_tpu_torch.models.weights import to_jax_variables

    _, variables = dp_run["jax"]
    ours_tree = to_jax_variables(saved["model"])
    assert jax.tree.structure(ours_tree) == jax.tree.structure(variables)
    assert [a.shape for a in jax.tree.leaves(ours_tree)] == [
        a.shape for a in jax.tree.leaves(variables)]
    loss = float(trainer.step(spec["batches64"][1])["total_loss"])
    np.testing.assert_allclose(loss, ours["losses64"][-1], rtol=1e-6)


def test_dp_masks_step_matches_one_process(dp_run):
    """The segmentation step with ``t_masks`` under DDP (JAX
    test_engine.py's DP mask step): loss, mask and dice terms to rtol 1e-5,
    every clipped gradient to 1e-3 of its norm, against one process."""
    spec, ours = dp_run["spec"], dp_run["ranks"][0]["masks"]
    model, trainer = _one_process(spec, float64=False, masks=True)
    log = trainer.step(spec["mask_batch"])
    for key in ("total_loss", "mask_loss", "dice_loss", "label_cost", "giou_loss"):
        np.testing.assert_allclose(ours["log"][key], float(log[key]), rtol=1e-5, err_msg=key)
    for name, p in model.named_parameters():
        assert float((ours["grads"][name] - p.grad).norm()) <= 1e-3 * float(
            p.grad.norm()) + 1e-6, name


def test_dp_ranks_draw_their_own_dropout(dp_run):
    """Each data rank's generator: rank 0's is the one-process trainer's
    (seed 0); rank 1's differs, and so does the keep mask it draws."""
    r0, r1 = dp_run["ranks"]
    single = Trainer(DETR(dropout=0.1, **TINY), TrainingConfig(**CONFIG), seed=0)
    assert torch.equal(r0["generator"], single.generator.get_state())
    assert not torch.equal(r0["generator"], r1["generator"])
    assert not torch.equal(r0["keep"], r1["keep"])
    assert 0.85 < float((r1["keep"] > 0).float().mean()) < 0.95


def test_loader_shards_and_multiscale_rungs(dp_run):
    """Every rank's multi-scale plan syncs by default (world 2); at each
    step both ranks' batches have one shape, and their union, rank 0's rows
    first, is the one-process batch of the same plan (sync=True) at that
    step, bit for bit."""
    from detr_tensorflow_tpu_torch.data import HostDataset
    from detr_tensorflow_tpu_torch.data.multiscale import MultiScalePlan

    r0, r1 = (r["loader"] for r in dp_run["ranks"])
    assert r0["sync"] and r1["sync"]
    plan = MultiScalePlan(LADDER, seed=3, sync=True)
    assert not MultiScalePlan(LADDER, seed=3).sync  # one process: per-example rungs
    examples = dp_run["spec"]["examples"]
    single = HostDataset(range(len(examples)), lambda i: examples[i], 4, seed=5,
                         num_workers=2, batch_transform=plan.batch_transform,
                         on_epoch_start=plan.set_epoch)
    want = [b for _ in range(2) for b in single]  # two epochs of three batches
    assert len(r0["batches"]) == len(r1["batches"]) == len(want) == 6
    shapes = set()
    for a, b, w in zip(r0["batches"], r1["batches"], want):
        assert a["images"].shape == b["images"].shape
        shapes.add(a["images"].shape[1:3])
        for key in w:
            np.testing.assert_array_equal(np.concatenate([a[key], b[key]]), w[key], err_msg=key)
    assert len(shapes) > 1


def test_process_shard_equals_jax():
    """``process_shard`` is the JAX package's arithmetic, and refuses an
    uneven split."""
    from detr_tensorflow_tpu.parallel import multihost as jax_multihost

    for n, pc in ((8, 1), (8, 2), (8, 4), (12, 3), (100, 4)):
        for pi in range(pc):
            assert multihost.process_shard(n, pi, pc) == jax_multihost.process_shard(n, pi, pc)
    with pytest.raises(ValueError):
        multihost.process_shard(7, 0, 2)
    assert multihost.process_shard(8) == (0, 8)  # one process
    assert not multihost.initialize()  # no-op at one process
    assert multihost.world_size() == 1 and multihost.rank() == 0 and multihost.is_primary()



ENTRY = r'''
import sys
from detr_tensorflow_tpu_torch import train_coco

if __name__ == "__main__":  # the spawned ranks import this file again
    assert train_coco.main(sys.argv[1:], dropout=0.0, **%r) is None  # the ranks ran apart
'''


def test_train_coco_data_parallel_equals_one_process(coco_root, tmp_path):
    """``train_coco.main --data_parallel 2 --device cpu`` (two Gloo ranks
    spawned by the entry point, each loading the same examples with one
    loader thread and keeping its rows) against ``--data_parallel 1`` on
    the entry points' synthetic COCO set, two b2 steps with augmentation:
    only rank 0 prints and writes checkpoints, and its checkpoint's
    parameters moved like one process's: every element within the two Adam
    steps of lr 1e-4 either side could take (4e-4), and each tensor that
    moved by at least a tenth of a step (1e-5) within 1e-3 of its update's
    norm; the others (the k_proj biases and parts of decoder layer 0's
    self-attention, whose exact gradient is zero) carry rounding noise."""
    from test_torch_entry_points import TINY as ENTRY_TINY
    from test_torch_entry_points import _data_argv

    from detr_tensorflow_tpu_torch import train_coco
    from detr_tensorflow_tpu_torch.models import get_detr_model
    from detr_tensorflow_tpu_torch.train import latest_step

    argv = _data_argv(coco_root, "--batch_size", "2", "--target_batch", "2", "--image_size",
                      "64", "64", "--epochs", "1", "--steps_per_epoch", "2",
                      "--evaluation_steps", "1", "--num_workers", "1")
    one = train_coco.main(argv + ["--checkpoint_dir", str(tmp_path / "one")], dropout=0.0,
                          **ENTRY_TINY)
    script = tmp_path / "entry.py"
    script.write_text(ENTRY % (ENTRY_TINY,))
    env = dict(os.environ, PYTHONPATH=REPO, **{multihost.TIMEOUT_ENV: "60"})
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen([sys.executable, str(script), *argv, "--data_parallel", "2",
                             "--checkpoint_dir", str(tmp_path / "two")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=WAIT_S)
    finally:  # the entry point's own ranks too
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    assert out.count("Epoch: [0]") == 1 and out.count("Validation step") == 1
    assert latest_step(str(tmp_path / "two")) == one.steps == 2
    assert sorted(os.listdir(tmp_path / "two")) == ["2.pt"]
    state = torch.load(tmp_path / "two" / "2.pt", weights_only=False)
    start = get_detr_model(one.config, include_top=False, nb_class=4, tf_backbone=True,
                           device="cpu", dropout=0.0, **ENTRY_TINY).module.state_dict()
    for name, p in one.model.named_parameters():
        moved, moved_ref = state["model"][name] - start[name], p.detach() - start[name]
        assert float((moved - moved_ref).abs().max()) <= 4e-4, name
        if "k_proj.bias" not in name and float(moved_ref.abs().max()) >= 1e-5:
            assert float((moved - moved_ref).norm()) <= 1e-3 * float(moved_ref.norm()), name
