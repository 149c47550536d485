"""Pipeline parallelism (detr_tensorflow_tpu_torch/parallel/pp.py,
detr_1f1b.py, ``DETR(pipeline=)``, ``Trainer(pipeline_1f1b=)``), held against
the JAX package's sequential ``jax.value_and_grad`` of the loss at the same
converted weights, and against the port's own sequential model.

The stages are Gloo ranks on the CPU started by ``torch_ranks.start_ranks``
(one thread each, a file rendezvous, a 60 s collective timeout, bounded
waits): one run of 4 ranks writes what the tests below read, while this
process computes the JAX references. It runs S = 2 on a (replica 2, stage 2)
mesh, GPipe at fp32 on replica 0 (ranks 0, 1), 1F1B and GPipe at float64 on
replica 1 (ranks 2, 3), the Trainer on both, then S = 4, data 2 x stage 2
and stage 2 x model 2. The models are the JAX pipeline tests' small DETR (8
classes, 6 queries, d 16, 2 heads, 4 encoder layers, 1 or 2 decoder layers,
FFN 32, backbone stages (1, 1, 1, 1), 32x32 images) on a global batch of 8.
The JAX package's own tests show its GPipe and 1F1B equal its sequential
model; its schedules are not run here.

Tolerances: fp32, the loss to 1e-4 and each gradient to ||g - g_ref|| <=
1e-3 ||g_ref|| + 1e-6 (``PERF.md`` section 2). float64: both packages cast
the heads' outputs to float32 even in a float64 model, so the float64 loss
carries float32 rounding, which depends on the order of the sums: GPipe
computes the sequential model's loss in its order and is held to 1e-10 of
the port's sequential model (loss and every gradient); 1F1B sums the
microbatches' losses, each rounded to float32 alone, and is held to 1e-7
(loss) and 1e-10 (every gradient: the float32 cotangents are the
sequential model's element by element); against JAX's float64 model the
port is held to 1e-6 (its float64 step agrees with JAX's to ~1e-6,
tests/test_torch_training.py). A tensor whose exact gradient is zero (every
``k_proj`` bias; the first decoder layer's self-attention, whose queries are
zeros) carries rounding noise only and is held in absolute terms (its norm
below 1e-6 at fp32, 1e-7 at float64, where ``query_embed``'s is ~1e-8). At 32x32
the encoder sees one key, so every attention's q and k projections have a
zero gradient: 112 of the 146 tensors carry a real one, and a comparison
holds more than 70% of them relatively.
"""

import hashlib

import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.models.detr import DETR
from detr_tensorflow_tpu_torch.ops.losses import detr_loss, global_loss_normalizers
from detr_tensorflow_tpu_torch.parallel import pp
from detr_tensorflow_tpu_torch.parallel.detr_1f1b import slot_layers
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
from test_torch_parallel import CONFIG, make_global_batch, with_masks
from torch_ranks import one_torch_thread, start_ranks  # noqa: F401

TINY = dict(num_classes=8, num_queries=6, model_dim=16, num_heads=2, num_encoder_layers=4,
            dim_feedforward=32, backbone_stage_sizes=(1, 1, 1, 1))
COUNTS = (4, 2, 1, 0, 1, 0, 1, 0)  # data rank 0: 7 real boxes, data rank 1: 2
DROPOUT_SEEDS = (11, 12)
NOISE = 1e-6  # a gradient this small (norm) is rounding noise at fp32
NOISE64 = 1e-7  # and at float64, where the heads' float32 outputs set it

WORKER = '''
    import copy
    import hashlib
    import warnings
    from detr_tensorflow_tpu_torch.models.detr import DETR
    from detr_tensorflow_tpu_torch.ops.losses import detr_loss, global_loss_normalizers
    from detr_tensorflow_tpu_torch.parallel import PipelineSpec, detr_1f1b_value_and_grad, pp, tp
    from detr_tensorflow_tpu_torch.parallel.detr_1f1b import keep_stage
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
    import torch.distributed as dist

    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    cfg = TrainingConfig(**spec["config"])
    result = {}

    def tensors(batch, float64=False):
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        return {k: v.double() if float64 and v.is_floating_point() else v for k, v in b.items()}

    def model_of(dec, float64=False, dropout=0.0):
        m = DETR(dropout=dropout, dtype=torch.float64 if float64 else torch.float32,
                 num_decoder_layers=dec, **spec["tiny"])
        m = m.double() if float64 else m
        m.load_state_dict(spec["weights"][dec])
        return m

    models = {}  # reused between runs that leave a model as they found it

    def reused(kind, mesh, dec, float64=False, dropout=0.0):
        key = (kind, dec, float64, dropout)
        if key not in models:
            models[key] = model_of(dec, float64, dropout)
            if kind == "stage":
                st = pp.stage_of(mesh)
                keep_stage(models[key], st.index, st.size)
        models[key].zero_grad(set_to_none=True)
        return models[key]

    def grads_of(m):
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    def without_backbone(grads, keep):
        """``keep="head"``: the gradients past the backbone only (less disk;
        ``input_proj``'s reads the cotangent the backbone's would)."""
        if keep != "head":
            return grads
        return {n: g for n, g in grads.items() if not n.startswith("backbone.")}

    def gpipe(mesh, dec, n_micro, batch, float64=False, remat=False, data_axis=None,
              model_axis=None, dropout=0.0, keep="full"):
        m = model_of(dec) if model_axis else reused("whole", mesh, dec, float64, dropout)
        mg = None
        if model_axis:
            group, index, size = (mesh.get_group(model_axis), mesh.get_local_rank(model_axis),
                                   2)
            tp.parallelize(m, group, index, size)
            mg = tp.ModelGroup(group, index, size)
        m.set_pipeline(PipelineSpec(mesh, n_micro=n_micro, remat_stage=remat,
                                    data_axis=data_axis, tp_axis=model_axis))
        b = tensors(batch, float64)
        gen = torch.Generator().manual_seed(7) if dropout else None
        outputs = m(b["images"], train=True, generator=gen)
        live = pp.last_stats["max_live"]
        group = mesh.get_group(data_axis) if data_axis else None
        norm = (global_loss_normalizers(b["mask"], spec["tiny"]["num_queries"], group=group)
                if data_axis else None)
        total, _ = detr_loss(outputs, b["boxes"], b["classes"], b["mask"], 7, norm=norm)
        total.backward()
        grads = grads_of(m)
        loss = total.detach().clone()
        if data_axis:
            for g in list(grads.values()) + [loss]:
                dist.all_reduce(g, group=group)
        if mg is not None:
            grads = {n: g if tp.split_dim(n, g.dim()) is None
                     else tp.gather_tensor(g, tp.split_dim(n, g.dim()), mg)
                     for n, g in grads.items()}
        # Every rank holds every gradient: the first rank of a replica keeps
        # them (``keep``), the others a digest of each (bitwise equality).
        if keep == "digest" or rank not in (0, 2 if mesh is pair else 0):
            grads = {n: hashlib.sha256(g.numpy().tobytes()).hexdigest() for n, g in grads.items()}
        return {"loss": float(loss), "grads": without_backbone(grads, keep), "live": live,
                "outputs": {k: v.detach() for k, v in outputs.items()}}

    def one_f1b(mesh, dec, n_micro, batch, float64=False, data_axis=None, dropout=0.0,
                seed=None, keep="full"):
        m = reused("stage", mesh, dec, float64, dropout)
        st = pp.stage_of(mesh)
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        loss, grads = detr_1f1b_value_and_grad(m, tensors(batch, float64), mesh,
                                               background_class=7, n_micro=n_micro,
                                               data_axis=data_axis, generator=gen)
        if keep == "digest":
            grads = {n: hashlib.sha256(g.numpy().tobytes()).hexdigest() for n, g in grads.items()}
        return {"loss": float(loss), "grads": without_backbone(grads, keep),
                "live": pp.last_stats["max_live"], "stage": st.index}

    batch = spec["batch"]
    # S = 2 on each of two replicas: replica 0 runs GPipe, replica 1 1F1B.
    pair = make_mesh(4, ("replica", "stage"), (2, 2))
    if pair.get_local_rank("replica") == 0:
        for dec in (2, 1):  # the decoder staged (2 % 2 == 0) and not (1)
            for n_micro in (1, 2, 4):
                result[f"gpipe_{dec}_{n_micro}"] = gpipe(pair, dec, n_micro, batch,
                                                         keep="full" if n_micro == 4 else "head")
        result["gpipe_2_2_digest"] = gpipe(pair, 2, 2, batch, keep="digest")
        result["gpipe_remat"] = gpipe(pair, 2, 2, batch, remat=True, keep="digest")
        result["gpipe_dropout"] = [gpipe(pair, 2, 2, batch, remat=r, dropout=0.1, keep="digest")
                                   for r in (False, True)]
        # pipeline_transformer_encoder over the 4 encoder layers, 2 a stage
        enc = {k: torch.as_tensor(v) for k, v in spec["encoder"].items()}
        layers = [getattr(model_of(2).transformer, f"encoder_layer_{i}") for i in range(4)]
        src = enc["src"].clone().requires_grad_()
        y = pp.pipeline_transformer_encoder(lambda layer, a: layer(a, enc["pos"]), layers, src,
                                            pair)
        (y * enc["weight"]).sum().backward()
        result["encoder"] = {"out": y.detach(), "dsrc": src.grad, "n_micro": pp.last_stats["n_micro"],
                             "grads": {f"{i}.{n}": p.grad for i, layer in enumerate(layers)
                                       for n, p in layer.named_parameters()}}
    else:
        for n_micro in (2, 4):
            result[f"1f1b_{n_micro}"] = one_f1b(pair, 2, n_micro, batch)
        result["1f1b64"] = one_f1b(pair, 2, 4, batch, float64=True)
        # dropout: a seed twice, another seed; float64 for the replay check
        result["dropout"] = [one_f1b(pair, 2, 4, batch, float64=True, dropout=0.1, seed=s,
                                     keep=keep)
                             for s, keep in zip(spec["dropout_seeds"] + spec["dropout_seeds"][:1],
                                                ("full", "digest", "digest"))]
        # the memory bound, a batch of 16 (GPipe's graphs at 1, 2 and 4 above)
        result["live"] = {n: one_f1b(pair, 2, n, spec["big_batch"], keep="head")["live"]
                          for n in (8, 16)}
        result["gpipe64"] = gpipe(pair, 2, 2, batch, float64=True)
    models.clear()
    # Trainer(pipeline_1f1b=) on both replicas (its state gathers span the world)
    trainer = Trainer(model_of(2), cfg, seed=0, pipeline_1f1b=PipelineSpec(pair))
    log = trainer.step(spec["steps"][0])
    state = trainer.state_dict()
    result["trainer"] = {"log": {k: float(v) for k, v in log.items()},
                         "state": state if rank == 0 else None,
                         "stage_params": sorted(n for n, _ in trainer.model.named_parameters())}
    result["trainer_losses"] = [result["trainer"]["log"]["total_loss"]] + [
        float(trainer.step(b)["total_loss"]) for b in spec["steps"][1:]]
    again = Trainer(model_of(2), cfg, seed=0, pipeline_1f1b=PipelineSpec(pair))
    # A copy: a loaded optimizer steps the tensors it was given in place.
    again.load_state_dict(copy.deepcopy(state))
    result["resumed_loss"] = float(again.step(spec["steps"][1])["total_loss"])
    # masks: warns and trains through GPipe
    masked = DETR(dropout=0.0, masks=True, num_decoder_layers=2, **spec["tiny"])
    masked.load_state_dict(spec["mask_weights"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(masked, cfg, seed=0, pipeline_1f1b=PipelineSpec(pair))
    result["masks"] = {"warned": [str(w.message) for w in caught],
                       "routed": (trainer.pipeline is None, masked.pipeline is not None),
                       "loss": float(trainer.step(spec["mask_batch"])["total_loss"])}
    other = make_mesh(4, ("replica", "stage"), (2, 2))
    try:
        Trainer(model_of(2), cfg, mesh=other, pipeline_1f1b=PipelineSpec(pair))
        result["mesh_error"] = None
    except ValueError as e:
        result["mesh_error"] = str(e)
    # S = 4
    mesh = make_mesh(4, ("stage",))
    for n_micro in (4, 8):
        result[f"s4_{n_micro}"] = one_f1b(mesh, 2, n_micro, batch,
                                          keep="full" if n_micro == 4 else "head")
    result["s4_64"] = one_f1b(mesh, 2, 4, batch, float64=True)
    result["s4_gpipe"] = gpipe(mesh, 2, 4, batch)  # 2 decoder layers, 4 stages: sequential
    models.clear()
    # data 2 x stage 2, stage 2 x model 2
    mesh = make_mesh(4, ("data", "stage"), (2, 2))
    local = shard_batch(batch, mesh)
    result["dp_1f1b"] = one_f1b(mesh, 2, None, local, data_axis="data")
    result["dp_gpipe"] = gpipe(mesh, 2, None, local, data_axis="data")
    mesh = make_mesh(4, ("stage", "model"), (2, 2))
    result["pp_tp"] = gpipe(mesh, 2, 2, batch, model_axis="model")
    unsplit = model_of(2).set_pipeline(PipelineSpec(mesh, n_micro=2, tp_axis="model"))
    try:
        unsplit(tensors(batch)["images"], train=True)
        result["tp_unsplit"] = None
    except ValueError as e:
        result["tp_unsplit"] = str(e)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()
'''


def _jax_refs(weights_dec, batch, float64):
    """JAX's sequential loss, outputs and gradients (port names) of ``batch``
    for the models of ``weights_dec`` (decoder depth -> JAX variables)."""
    import jax
    import jax.numpy as jnp

    from detr_tensorflow_tpu.models import DETR as JaxDETR
    from detr_tensorflow_tpu.ops.losses import detr_loss as jax_detr_loss
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables

    refs = {}
    with jax.enable_x64(float64):
        dtype = jnp.float64 if float64 else jnp.float32
        cast = lambda a: jnp.asarray(a, dtype if a.dtype == np.float32 else a.dtype)  # noqa: E731
        jb = {k: cast(np.asarray(v)) for k, v in batch.items()}
        for dec, variables in weights_dec.items():
            model = JaxDETR(dropout=0.0, attn_impl="xla", dtype=dtype, num_decoder_layers=dec,
                            **TINY)
            variables = jax.tree.map(lambda a: cast(np.asarray(a)), variables)

            def loss_fn(params):
                out = model.apply({"params": params, "frozen": variables["frozen"]},
                                  jb["images"], train=True)
                return jax_detr_loss(out, jb["boxes"], jb["classes"], jb["mask"], 7)[0], out

            (total, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
            refs[dec] = (float(total), {k: torch.from_numpy(np.asarray(v)) for k, v in
                                        out.items()},
                         from_jax_variables({"params": jax.device_get(grads)}))
    return refs


@pytest.fixture(scope="module")
def spec():
    """The weights (JAX variables of the 2-decoder-layer model and their
    conversion; the 1-layer model's are a part of them), batches and seeds."""
    import jax.numpy as jnp

    from detr_tensorflow_tpu.models import DETR as JaxDETR
    from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
    from test_torch_training import random_variables

    jmodel = JaxDETR(dropout=0.0, attn_impl="xla", num_decoder_layers=2, **TINY)
    variables = random_variables(jmodel, jnp.zeros((1, 32, 32, 3)), seed=2)
    weights = from_jax_variables(variables)
    torch.manual_seed(0)
    return {"tiny": TINY, "config": CONFIG,
            "weights": {2: weights, 1: {k: v for k, v in weights.items()
                                        if not k.startswith("transformer.decoder_layer_1.")}},
            "batch": make_global_batch(0, counts=COUNTS),
            "big_batch": make_global_batch(1, counts=(1, 2) * 8),
            "steps": [make_global_batch(s, counts=COUNTS) for s in (2, 3, 4)],
            "dropout_seeds": list(DROPOUT_SEEDS),
            "mask_weights": DETR(dropout=0.0, masks=True, num_decoder_layers=2,
                                 **TINY).state_dict(),
            "mask_batch": with_masks(make_global_batch(5, counts=COUNTS)),
            "encoder": {k: np.random.default_rng(6).normal(size=shape).astype(np.float32)
                        for k, shape in (("src", (8, 12, 16)), ("pos", (1, 12, 16)),
                                         ("weight", (8, 12, 16)))},
            "variables": variables}


@pytest.fixture(scope="module")
def started(tmp_path_factory, spec):
    """The 4 ranks, started; the fixtures below compute the JAX references
    while they run, and ``ranks`` waits for them."""
    out = tmp_path_factory.mktemp("pp")
    torch.save({k: v for k, v in spec.items() if k != "variables"}, out / "spec.pt")
    wait = start_ranks(WORKER, 4, out)
    yield out, wait
    wait()  # a no-op once ``ranks`` has waited; bounded otherwise


@pytest.fixture(scope="module")
def jax32(spec, started):
    return _jax_refs({2: spec["variables"]}, spec["batch"], False)[2]


@pytest.fixture(scope="module")
def jax64(spec, started):
    return _jax_refs({2: spec["variables"]}, spec["batch"], True)[2]


@pytest.fixture(scope="module")
def ranks(started):
    out, wait = started
    wait()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _rel(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _hold(got, ref, rtol, atol=1e-6, noise=NOISE):
    """Every gradient of ``ref`` within ||g - g_ref|| <= rtol ||g_ref|| + atol,
    a reference below ``noise`` (rounding noise only) within ``atol``; returns
    the names held relatively."""
    if not any(n.startswith("backbone.") for n in got):  # a ``keep="head"`` result
        ref = {n: r for n, r in ref.items() if not n.startswith("backbone.")}
    assert set(got) == set(ref), set(got) ^ set(ref)
    informative = []
    for name, r in ref.items():
        err = float((got[name].to(r.dtype) - r).norm())
        if float(r.norm()) > noise:
            informative.append(name)
            assert err <= rtol * float(r.norm()) + atol, (name, err, float(r.norm()))
        else:
            assert err <= atol, (name, err)
    return informative


def _digests(grads):
    """The digest the worker's other ranks keep of each gradient."""
    return {n: hashlib.sha256(g.numpy().tobytes()).hexdigest() for n, g in grads.items()}


def _restricted(grads, like):
    """``grads`` restricted to the names of ``like``."""
    return {n: g for n, g in grads.items() if n in like}


def _merged(results, key):
    """One schedule's gradients, every stage rank's part merged."""
    out = {}
    for r in results:
        out.update(r[key]["grads"])
    return out


def _sequential(spec, dec, float64):
    """The port's sequential model: loss, outputs and gradients."""
    m = DETR(dropout=0.0, dtype=torch.float64 if float64 else torch.float32,
             num_decoder_layers=dec, **TINY)
    m = m.double() if float64 else m
    m.load_state_dict(spec["weights"][dec])
    b = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    if float64:
        b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    out = m(b["images"], train=True)
    total, _ = detr_loss(out, b["boxes"], b["classes"], b["mask"], 7)
    total.backward()
    return float(total.detach()), out, {n: p.grad for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def sequential(spec):
    """The port's sequential model: fp32 with 1 decoder layer, float64 with 2."""
    return {1: _sequential(spec, 1, False), 64: _sequential(spec, 2, True)}


def test_jax_reference_covers_the_port(spec, jax32):
    """JAX's fp32 reference has a gradient for every parameter of the port's
    model, under its name, and a finite loss."""
    names = {n for n, _ in DETR(dropout=0.0, num_decoder_layers=2, **TINY).named_parameters()}
    loss, _, grads = jax32
    assert set(grads) == names and np.isfinite(loss)


def test_jax_float64_reference_agrees_with_fp32(jax32, jax64):
    """JAX's float64 and fp32 references agree (loss 1e-5, gradients 1e-3):
    the float64 conversion holds the same model."""
    np.testing.assert_allclose(jax32[0], jax64[0], rtol=1e-5)
    assert len(_hold({k: v.double() for k, v in jax32[2].items()}, jax64[2], 1e-3)) > 0.7 * len(
        jax64[2])


@pytest.mark.parametrize("dec", [2, 1], ids=["decoder_staged", "decoder_sequential"])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gpipe_matches_sequential(jax32, sequential, ranks, dec, n_micro):
    """GPipe ``DETR(pipeline=)`` at S = 2 (fp32): loss, outputs and every
    gradient (past the backbone at 1 and 2 microbatches: ``input_proj``'s
    holds the cotangent the backbone's read), on both stage ranks alike
    (bitwise), against JAX's sequential model with
    the decoder staged (2 layers), and with it run sequentially (1 layer)
    against the port's sequential model (JAX's at 4 stages:
    ``test_gpipe_four_stages_decoder_sequential``)."""
    ref_loss, ref_out, ref_grads = jax32 if dec == 2 else sequential[1]
    r0, r1 = (r[f"gpipe_{dec}_{n_micro}"] for r in ranks[:2])
    np.testing.assert_allclose(r0["loss"], ref_loss, rtol=1e-4)
    assert r0["loss"] == r1["loss"]
    for k in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        np.testing.assert_allclose(r0["outputs"][k].numpy(), ref_out[k].detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        assert torch.equal(r0["outputs"][k], r1["outputs"][k])
    assert len(_hold(r0["grads"], ref_grads, 1e-3)) > 0.7 * len(r0["grads"])
    assert _digests(r0["grads"]) == _restricted(r1["grads"], r0["grads"])
    assert r0["live"] == n_micro


def test_gpipe_four_stages_decoder_sequential(jax32, ranks):
    """GPipe at S = 4 (one encoder layer a stage): the 2 decoder layers do
    not divide over 4 stages and run sequentially on every rank; the loss
    and every gradient against JAX's sequential model (fp32)."""
    jloss, jout, jgrads = jax32
    got = ranks[0]["s4_gpipe"]
    for r in ranks:
        np.testing.assert_allclose(r["s4_gpipe"]["loss"], jloss, rtol=1e-4)
        np.testing.assert_allclose(r["s4_gpipe"]["outputs"]["pred_boxes"].numpy(),
                                   jout["pred_boxes"].numpy(), rtol=1e-4, atol=1e-5)
    assert len(_hold(got["grads"], jgrads, 1e-3)) > 0.7 * len(jgrads)
    assert all(r["s4_gpipe"]["grads"] == _digests(got["grads"]) for r in ranks[1:])


def test_gpipe_remat_and_float64(jax64, sequential, ranks):
    """``remat_stage`` recomputes each stage in the backward and gives the
    kept-graph GPipe's gradients (fp32, bitwise: the same kernels on the
    same inputs), at dropout 0 and at 0.1 (the recompute replays each
    layer's seeded draws; the masks change the loss); at float64 GPipe
    equals the port's sequential model to 1e-10 and JAX's float64 model to
    1e-6."""
    remat, kept = ranks[0]["gpipe_remat"], ranks[0]["gpipe_2_2_digest"]
    kept_d, remat_d = ranks[0]["gpipe_dropout"]
    assert remat["loss"] == kept["loss"] and remat_d["loss"] == kept_d["loss"] != kept["loss"]
    assert remat["grads"] == kept["grads"] and remat_d["grads"] == kept_d["grads"]
    loss, _, grads = sequential[64]
    got = ranks[2]["gpipe64"]
    assert got["loss"] == ranks[3]["gpipe64"]["loss"]
    assert ranks[3]["gpipe64"]["grads"] == _digests(got["grads"])
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-10)
    _hold(got["grads"], grads, 1e-10, atol=1e-14, noise=1e-9)
    jloss, _, jgrads = jax64
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-6)
    _hold(got["grads"], jgrads, 1e-6, atol=NOISE64, noise=NOISE64)


def _stage_ranks(ranks, key):
    """The ranks that ran ``key``: S = 2's 1F1B on replica 1 (ranks 2, 3),
    the S = 4 runs on all four."""
    return ranks[2:] if key.startswith("1f1b") else ranks


@pytest.mark.parametrize("key", ["1f1b_2", "1f1b_4", "s4_4", "s4_8"])
def test_1f1b_matches_jax(jax32, ranks, key):
    """``detr_1f1b_value_and_grad`` at S = 2 and 4, n_micro S and 2S (fp32):
    the loss on every rank and the gradients of every stage, merged, against
    JAX's sequential model; each rank returns only its stage's names."""
    jloss, _, jgrads = jax32
    results = [r[key] for r in _stage_ranks(ranks, key)]
    assert len({r["loss"] for r in results}) == 1
    np.testing.assert_allclose(results[0]["loss"], jloss, rtol=1e-4)
    names = [set(r["grads"]) for r in results]
    assert all(not (a & b) for i, a in enumerate(names) for b in names[i + 1:])
    merged = _merged(_stage_ranks(ranks, key), key)
    assert len(_hold(merged, jgrads, 1e-3)) > 0.7 * len(merged)


@pytest.mark.parametrize("key", ["1f1b64", "s4_64"])
def test_1f1b_float64(jax64, sequential, ranks, key):
    """1F1B at float64 (S = 2 and 4) against the port's sequential model:
    the loss to 1e-7 (each microbatch's loss is rounded to float32 on its
    own, the heads' cast; the float32 cotangents are the sequential ones
    element by element) and every gradient to 1e-10; against JAX's float64
    model the loss and each informative gradient to 1e-6."""
    loss, _, grads = sequential[64]
    got = _stage_ranks(ranks, key)[0][key]["loss"]
    np.testing.assert_allclose(got, loss, rtol=1e-7)
    merged = _merged(_stage_ranks(ranks, key), key)
    _hold(merged, grads, 1e-10, atol=1e-14, noise=1e-9)
    jloss, _, jgrads = jax64
    np.testing.assert_allclose(got, jloss, rtol=1e-6)
    _hold(merged, jgrads, 1e-6, atol=NOISE64, noise=NOISE64)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_data_by_pipeline(jax32, ranks, schedule):
    """Data 2 x stage 2 (4 ranks; 7 real boxes on data rank 0, 2 on data
    rank 1): each schedule's global loss and gradients, summed over the data
    group with the batch-global normalizers, against JAX's sequential model
    on the whole batch."""
    jloss, _, jgrads = jax32
    results = [r[f"dp_{schedule}"] for r in ranks]
    assert len({r["loss"] for r in results}) == 1
    np.testing.assert_allclose(results[0]["loss"], jloss, rtol=1e-4)
    # GPipe: rank 0 holds every gradient; 1F1B: data rank 0's stages are
    # global ranks 0 and 1.
    merged = dict(results[0]["grads"])
    if schedule == "1f1b":
        merged.update(results[1]["grads"])
    assert len(_hold(merged, jgrads, 1e-3)) > 0.7 * len(jgrads)
    if schedule == "gpipe":  # every rank holds every gradient, summed over the data group
        assert all(r["grads"] == _digests(results[0]["grads"]) for r in results[1:])
    else:
        for a, b in zip(results[:2], results[2:]):  # the data replicas agree
            for name, g in a["grads"].items():
                assert float((g - b["grads"][name]).abs().max()) <= 1e-6, name


def test_pipeline_by_tensor_parallel(jax32, ranks):
    """GPipe with each stage split over a model axis of 2 (stage 2 x model 2,
    4 ranks; one head a rank): the forward and every gradient, the split
    ones gathered whole, against JAX's sequential model."""
    jloss, jout, jgrads = jax32
    for r in (r["pp_tp"] for r in ranks):
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-4)
        for k in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(r["outputs"][k].numpy(), jout[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    got = ranks[0]["pp_tp"]["grads"]
    assert len(_hold(got, jgrads, 1e-3)) > 0.7 * len(jgrads)
    assert all(r["pp_tp"]["grads"] == _digests(got) for r in ranks[1:])


def test_pipeline_transformer_encoder(spec, ranks):
    """``pp.pipeline_transformer_encoder`` over the 4 encoder layers at S = 2
    (GPipe, n_micro by ``choose_n_micro``): the output, the input's cotangent
    and every layer's gradient, alike on both stage ranks (bitwise), against
    the same layers run in order on one process (fp32: outputs 1e-4,
    gradients 1e-3)."""
    enc = {k: torch.as_tensor(v) for k, v in spec["encoder"].items()}
    model = DETR(dropout=0.0, num_decoder_layers=2, **TINY)
    model.load_state_dict(spec["weights"][2])
    layers = [getattr(model.transformer, f"encoder_layer_{i}") for i in range(4)]
    src = enc["src"].clone().requires_grad_()
    y = src
    for layer in layers:
        y = layer(y, enc["pos"])
    (y * enc["weight"]).sum().backward()
    ref = {f"{i}.{n}": p.grad for i, layer in enumerate(layers) for n, p in layer.named_parameters()}
    got, other = ranks[0]["encoder"], ranks[1]["encoder"]
    assert got["n_micro"] == pp.choose_n_micro(8, 2) == 4
    torch.testing.assert_close(got["out"], y.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["dsrc"], src.grad, rtol=1e-4, atol=1e-5)
    # every k_proj bias: an exactly-zero gradient (rounding noise ~1e-6)
    assert len(_hold(got["grads"], ref, 1e-3, atol=1e-5, noise=1e-5)) > 0.7 * len(ref)
    for k in ("out", "dsrc"):
        assert torch.equal(got[k], other[k])
    assert all(torch.equal(g, other["grads"][n]) for n, g in got["grads"].items())


def test_tp_axis_needs_a_split_model(ranks):
    """``PipelineSpec.tp_axis`` has an effect or raises: GPipe on a stage 2 x
    model 2 mesh with a model not split over ``model`` raises ValueError on
    every rank (``test_pipeline_by_tensor_parallel`` runs the split one), and
    the 1F1B Trainer refuses a spec with ``tp_axis``."""
    assert all("not split" in r["tp_unsplit"] for r in ranks)
    model = DETR(dropout=0.0, num_decoder_layers=2, **TINY)
    with pytest.raises(NotImplementedError, match="model axis"):
        Trainer(model, TrainingConfig(**CONFIG), seed=0,
                pipeline_1f1b=pp.PipelineSpec(None, tp_axis="model"))


def _replayed(spec, seed, n_stages, n_micro):
    """The 1F1B dropout run's loss and gradients by plain autograd on one
    process: the same per-(microbatch, slot) seeds drawn from a generator
    seeded alike, each microbatch through the layers in slot order, the
    losses with the batch-global normalizers summed, one backward."""
    m = DETR(dropout=0.1, dtype=torch.float64, num_decoder_layers=2, **TINY).double()
    m.load_state_dict(spec["weights"][2])
    b = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    b = {k: v.double() if v.is_floating_point() else v for k, v in b.items()}
    slots = [s for stage in slot_layers(4, 2, n_stages) for s in stage]
    seeds = pp.dropout_seeds(torch.Generator().manual_seed(seed), len(slots), n_micro)
    norm = global_loss_normalizers(b["mask"], TINY["num_queries"])
    total = 0.0
    for t in range(n_micro):
        mb = pp.microbatch(b, t, n_micro)
        src, pos, _, _ = m.features(mb["images"])
        qpos = m.query_embed[None].expand(src.shape[0], -1, -1).double()
        tgt, hs = torch.zeros_like(qpos), []
        for j, (kind, i) in enumerate(slots):
            gen = pp.seeded(seeds[t][j], "cpu")
            if kind == "enc":
                src = getattr(m.transformer, f"encoder_layer_{i}")(src, pos, None, True, gen)
            elif kind == "dec":
                tgt = getattr(m.transformer, f"decoder_layer_{i}")(tgt, src, pos, qpos, None,
                                                                  True, gen)
                hs.append(tgt)
        out = m.heads(m.transformer.decoder_norm(torch.stack(hs)))
        total = total + detr_loss(out, mb["boxes"], mb["classes"], mb["mask"], 7, norm=norm)[0]
    total.backward()
    return float(total), {n: p.grad for n, p in m.named_parameters()}


def test_1f1b_dropout(spec, ranks):
    """Dropout 0.1 through 1F1B (float64, S = 2, 4 microbatches): a seed
    gives the same loss and gradients twice, another seed another loss;
    every gradient is finite and equals plain autograd of the same layers
    with the same replayed generator seeds (1e-9 relative), and those seeds,
    one per (microbatch, slot), are all distinct, within a run and between
    the two trainer seeds."""
    slots = sum(len(stage) for stage in slot_layers(4, 2, 2))
    drawn = [x for s in DROPOUT_SEEDS
             for row in pp.dropout_seeds(torch.Generator().manual_seed(s), slots, 4) for x in row]
    assert len(set(drawn)) == len(drawn) == 2 * 4 * slots
    first, second, again = (ranks[2]["dropout"][i] for i in range(3))
    assert first["loss"] == again["loss"]
    assert first["loss"] != second["loss"]
    merged = {}
    for r in ranks[2:]:
        merged.update(r["dropout"][0]["grads"])
        assert _digests(r["dropout"][0]["grads"]) == r["dropout"][2]["grads"]
    assert all(bool(torch.isfinite(g).all()) for g in merged.values())
    loss, grads = _replayed(spec, DROPOUT_SEEDS[0], 2, 4)
    np.testing.assert_allclose(first["loss"], loss, rtol=1e-9)
    _hold(merged, grads, 1e-9, atol=1e-12, noise=1e-9)


def test_1f1b_memory_bound(ranks):
    """The schedule's live saved inputs per stage stay at most 2 S (here
    S - stage index) at 8 and 16 microbatches, while GPipe keeps one graph a
    microbatch (1, 2 and 4)."""
    for r in ranks[:2]:
        assert [r[f"gpipe_2_{n}"]["live"] for n in (1, 2, 4)] == [1, 2, 4]
    stage0, stage1 = (r["live"] for r in ranks[2:])
    assert stage0 == {8: 2, 16: 2}  # S - 0 in flight, <= 2 S
    assert stage1 == {8: 0, 16: 0}  # the last stage keeps none


def test_trainer_1f1b(spec, ranks):
    """``Trainer(pipeline_1f1b=)`` (fp32): its first step's loss equals the
    sequential Trainer's, its loss falls over 3 steps, and its state after
    one step (gathered from the stages) equals the sequential Trainer's
    checkpoint: the same names in the same order, the same optimizer groups,
    Adam's moments within 1e-3 where the gradient is real, the parameters
    within one Adam step (2 lr) where rounding noise flips a sign and equal
    to 1e-6 on all but 5% of a tensor with a real gradient. Each rank holds
    only its stage; a Trainer loaded from the state steps as the sequential
    one does."""
    cfg = TrainingConfig(**CONFIG)
    seq = DETR(dropout=0.0, num_decoder_layers=2, **TINY)
    seq.load_state_dict(spec["weights"][2])
    trainer = Trainer(seq, cfg, seed=0)
    log = trainer.step(spec["steps"][0])
    informative = {n for n, p in seq.named_parameters() if float(p.grad.norm()) > NOISE}
    want = trainer.state_dict()
    losses = ranks[0]["trainer_losses"]
    assert all(r["trainer_losses"] == losses for r in ranks)
    np.testing.assert_allclose(losses[0], float(log["total_loss"]), rtol=1e-5)
    assert losses[0] > losses[1] > losses[2]
    assert set(ranks[0]["trainer"]["log"]) == {"total_loss", "backbone_lr", "transformers_lr",
                                               "nlayers_lr"}
    got = ranks[0]["trainer"]["state"]
    assert list(got["model"]) == list(want["model"])
    assert got["steps"] == want["steps"] and torch.equal(got["generator"], want["generator"])
    lr = CONFIG["backbone_lr"]
    for name, w in want["model"].items():
        diff = (got["model"][name] - w).abs()
        assert float(diff.max()) <= 2 * lr + 1e-6, name
        if name in informative:
            assert float((diff > 1e-6).float().mean()) <= 0.05, name
    go, wo = got["optimizer"], want["optimizer"]
    assert go["mini_step"] == wo["mini_step"] and go["acc"] == wo["acc"] == []
    assert go["adam"]["param_groups"] == wo["adam"]["param_groups"]
    assert set(go["adam"]["state"]) == set(wo["adam"]["state"])
    names = trainer.optimizer.names
    for i, entry in wo["adam"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            if names[i] in informative:
                assert _rel(go["adam"]["state"][i][k], entry[k]) <= 1e-3, (names[i], k)
    assert not set(ranks[0]["trainer"]["stage_params"]) & set(
        ranks[1]["trainer"]["stage_params"])
    resumed = float(trainer.step(spec["steps"][1])["total_loss"])
    np.testing.assert_allclose(ranks[0]["resumed_loss"], resumed, rtol=1e-5)


def test_trainer_1f1b_routes_masks_and_checks_mesh(spec, ranks):
    """A masks model warns and trains through GPipe on the spec's mesh (its
    first step's loss equal to the sequential Trainer's); a ``mesh=`` other
    than the spec's raises ValueError."""
    masks = ranks[0]["masks"]
    assert any("GPipe" in w for w in masks["warned"])
    assert masks["routed"] == (True, True)
    assert all(r["masks"]["loss"] == masks["loss"] for r in ranks)
    model = DETR(dropout=0.0, masks=True, num_decoder_layers=2, **TINY)
    model.load_state_dict(spec["mask_weights"])
    ref = float(Trainer(model, TrainingConfig(**CONFIG), seed=0).step(
        spec["mask_batch"])["total_loss"])
    np.testing.assert_allclose(masks["loss"], ref, rtol=1e-5)
    assert "differ" in ranks[0]["mesh_error"]


def test_gpipe_without_process_group_is_sequential():
    """A spec without a mesh (one stage, no process group) runs the model
    through the pipeline function in 2 microbatches: the outputs and
    gradients equal the plain model's to fp32 rounding."""
    torch.manual_seed(3)
    model = DETR(dropout=0.0, num_decoder_layers=2, **TINY)
    images = torch.randn(4, 32, 32, 3)
    plain = model(images)
    (plain["pred_logits"].sum() + plain["pred_boxes"].sum()).backward()
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    model.set_pipeline(pp.PipelineSpec(None, n_micro=2))
    piped = model(images)
    (piped["pred_logits"].sum() + piped["pred_boxes"].sum()).backward()
    for k in plain:
        torch.testing.assert_close(piped[k], plain[k], rtol=1e-6, atol=1e-6)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, ref[n], rtol=1e-5, atol=1e-6)
