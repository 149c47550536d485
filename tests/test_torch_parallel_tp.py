"""Megatron tensor parallelism (detr_tensorflow_tpu_torch/parallel/tp.py and
``Trainer`` on a ("data", "model") mesh), held against the JAX package's
shardings and replicated model and against the port's one-process step.

The ranks run as in tests/test_torch_parallel.py (``torch_ranks.run_ranks``:
Gloo on the CPU, one thread each, a file rendezvous, bounded waits) on the same
tiny DETR: two heads, so each of 2 model ranks runs one. Tolerances are
stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.parallel import detr_param_shardings, shard_params, tp
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
from test_torch_parallel import CONFIG, TINY, _rel, _spec_weights, make_global_batch
from torch_ranks import one_torch_thread, run_ranks  # noqa: F401

TP_WORKER = '''
    from detr_tensorflow_tpu_torch.models.detr import DETR
    from detr_tensorflow_tpu_torch.ops.losses import detr_loss
    from detr_tensorflow_tpu_torch.parallel import tp
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    tiny, cfg = spec["tiny"], spec["config"]
    result = {}

    def gathered_grads(trainer):
        mg = trainer.model_group
        return {n: p.grad if tp.split_dim(n, p.dim()) is None or mg is None
                else tp.gather_tensor(p.grad, tp.split_dim(n, p.dim()), mg)
                for n, p in trainer.model.named_parameters()}

    if world == 2:
        mesh = make_mesh(2, ("data", "model"), (1, 2))
        # fp32 at dropout 0: the split forward and every gradient.
        model = DETR(dropout=0.0, **tiny)
        model.load_state_dict(spec["weights"])
        trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
        heads = {m.num_heads // m.tp.size for m in model.modules() if hasattr(m, "q_proj")}
        b = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
        outputs = model(b["images"], train=True, generator=trainer.generator)
        total, _ = detr_loss(outputs, b["boxes"], b["classes"], b["mask"], 7)
        total.backward()
        result["forward"] = {"loss": float(total), "heads": heads,
                             "outputs": {k: v.detach() for k, v in outputs.items()},
                             "grads": gathered_grads(trainer),
                             "local": {n: tuple(p.shape) for n, p in model.named_parameters()}}
        # dropout 0.1: two steps; each rank's replicated tensors and the
        # gathered state after each.
        model = DETR(dropout=0.1, **tiny)
        model.load_state_dict(spec["weights"])
        trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
        states = []
        for _ in range(2):
            trainer.step(spec["batch"])
            local = {n: t.clone() for n, t in model.state_dict().items()
                     if tp.split_dim(n, t.dim()) is None}
            states.append({"local": local, "gathered": trainer.variables})
        result["dropout"] = states
    else:
        # DP x TP, 2 x 2, float64: one step.
        mesh = make_mesh(4, ("data", "model"), (2, 2))
        model = DETR(dropout=0.0, dtype=torch.float64, **tiny).double()
        model.load_state_dict(spec["weights"])
        trainer = Trainer(model, TrainingConfig(**cfg), seed=0, mesh=mesh)
        log = trainer.step(shard_batch(spec["batch"], mesh))
        result["dpxtp"] = {"loss": float(log["total_loss"]), "grads": gathered_grads(trainer),
                           "variables": trainer.variables}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()
'''


@pytest.fixture(scope="module")
def tp_spec(tmp_path_factory):
    jmodel, variables, weights = _spec_weights()
    return {"tiny": TINY, "config": CONFIG, "weights": weights, "batch": make_global_batch(0),
            "jax": (jmodel, variables)}


def _run(tmp_path, spec, world):
    torch.save({k: v for k, v in spec.items() if k != "jax"}, tmp_path / "spec.pt")
    run_ranks(TP_WORKER, world, tmp_path)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory, tp_spec):
    return _run(tmp_path_factory.mktemp("tp"), tp_spec, 2)


def test_shardings_equal_jax(tp_spec):
    """``detr_param_shardings`` over the port's state_dict names the JAX
    ``detr_param_shardings`` assignment: a JAX kernel split on its output
    (P(None, "model")) is a torch weight split on dim 0, one split on its
    input dim 1, a split bias dim 0, replicated None; the transformer only."""
    from detr_tensorflow_tpu.parallel import detr_param_shardings as jax_shardings
    from detr_tensorflow_tpu.parallel import make_mesh

    _, variables = tp_spec["jax"]
    mesh = make_mesh(4, axis_names=("data", "model"), axis_sizes=(1, 4))
    specs = jax_shardings(variables["params"], mesh)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [k.key for k in path]
        spec = tuple(sharding.spec)
        leaf = keys[-1]
        name = ".".join(keys[:-1] + ["weight" if leaf in ("kernel", "scale") else leaf])
        if spec in ((), (None,), (None, None)):
            want[name] = None
        elif leaf == "kernel" and spec == (None, "model"):
            want[name] = 0
        elif leaf == "kernel" and spec == ("model", None):
            want[name] = 1
        else:
            assert spec == ("model",), (name, spec)
            want[name] = 0
    got = detr_param_shardings(tp_spec["weights"])
    assert {n: d for n, d in got.items() if n in want} == want
    assert all(d is None for n, d in got.items() if n not in want)  # FrozenBN buffers
    # Three attentions (q/k/v weights and biases, out_proj's weight), two FFNs
    # (linear1's weight and bias, linear2's weight).
    assert sum(d is not None for d in want.values()) == 3 * 7 + 2 * 3
    full = tp_spec["weights"]
    halves = [shard_params(full, r, 2) for r in range(2)]
    for name, dim in got.items():
        if dim is not None:
            assert torch.equal(torch.cat([h[name] for h in halves], dim), full[name])


def test_tp_forward_and_grads_match_jax_replicated(tp_spec, tp_run):
    """2 model ranks (one head each) against the JAX model unsplit, at
    dropout 0: the loss (rtol 1e-5), the outputs (rtol 1e-4, atol 1e-5) and
    every gradient, gathered whole (||g - g_jax|| <= 1e-3 ||g_jax|| +
    1e-6), after JAX test_tensor_parallel.py's check of its TP mesh."""
    from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables

    jmodel, variables = tp_spec["jax"]
    jb = {k: jnp.asarray(v) for k, v in tp_spec["batch"].items()}

    def loss_fn(params):
        out = jmodel.apply({"params": params, "frozen": variables["frozen"]}, jb["images"],
                           train=True)
        return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], 7)[0], out

    (total, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    jgrads = from_jax_variables({"params": jgrads})
    r0, r1 = (r["forward"] for r in tp_run)
    assert r0["heads"] == r1["heads"] == {1}
    assert r0["local"]["transformer.encoder_layer_0.linear1.weight"] == (16, 16)
    np.testing.assert_allclose(r0["loss"], float(total), rtol=1e-5)
    assert r0["loss"] == r1["loss"]
    for key in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        np.testing.assert_allclose(r0["outputs"][key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    for name, ref in jgrads.items():
        got = r0["grads"][name]
        assert float((got - ref).norm()) <= 1e-3 * float(ref.norm()) + 1e-6, name
        assert torch.equal(got, r1["grads"][name]), name


def test_tp_ranks_stay_equal_at_dropout(tp_run):
    """Dropout 0.1, two steps on 2 model ranks: each rank's replicated
    tensors are bit-equal across the ranks after each step (the residual
    dropouts draw alike), and so is the gathered state."""
    for step in range(2):
        a, b = (r["dropout"][step] for r in tp_run)
        assert a["local"].keys() == b["local"].keys()
        for name, t in a["local"].items():
            assert torch.equal(t, b["local"][name]), (step, name)
        for name, t in a["gathered"].items():
            assert torch.equal(t, b["gathered"][name]), (step, name)
    moved = tp_run[0]["dropout"][1]["gathered"]["transformer.encoder_layer_0.linear1.weight"]
    first = tp_run[0]["dropout"][0]["gathered"]["transformer.encoder_layer_0.linear1.weight"]
    assert not torch.equal(moved, first)


def test_dp_by_tp_step_matches_one_process(tmp_path, tp_spec):
    """4 ranks as a 2 x 2 ("data", "model") mesh, float64, one step against
    the one-process step on the global batch: the loss to float32 rounding
    (rtol 1e-6: the heads cast to float32), every clipped gradient and every
    parameter after the step to 1e-9 relative (of the gradient, of the
    update); a tensor with an exactly-zero gradient (every k_proj bias)
    carries rounding noise only, held to 1e-12 absolute."""
    ranks = _run(tmp_path, tp_spec, 4)
    model = DETR(dropout=0.0, dtype=torch.float64, **TINY).double()
    model.load_state_dict(tp_spec["weights"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, TrainingConfig(**CONFIG), seed=0)
    loss = float(trainer.step(tp_spec["batch"])["total_loss"])
    ours = ranks[0]["dpxtp"]
    np.testing.assert_allclose(ours["loss"], loss, rtol=1e-6)
    for name, p in model.named_parameters():
        if float(p.grad.norm()) < 1e-12:
            assert float(ours["grads"][name].norm()) < 1e-12, name
            continue
        assert _rel(ours["grads"][name], p.grad) <= 1e-9, name
        assert _rel(ours["variables"][name] - start[name], p.detach() - start[name]) <= 1e-9, name
    for r in ranks[1:]:
        for name, t in r["dpxtp"]["variables"].items():
            assert torch.equal(t, ours["variables"][name]), name
    assert tp.split_dim("transformer.decoder_layer_0.cross_attn.out_proj.weight", 2) == 1
