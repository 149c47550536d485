"""Pipeline parallelism over a mesh's ``stage`` axis (port of
``detr_tensorflow_tpu/parallel/pp.py``).

The JAX package runs every stage in one SPMD program and rotates the
activations with ``ppermute``; here each stage is a rank of its own, holds
only what its stage computes, and a stage boundary is a dict of tensors sent
to the neighbouring rank (``parallel/p2p.py``: on the card directly under
NCCL, through pinned host memory when two ranks share one card over Gloo).
Every send is asynchronous, every receive bounded by the group's timeout.

Two schedules, the JAX package's:

* **GPipe** (``pipeline_forward``): stage s runs microbatch t's forward as
  soon as stage s-1 has sent it, all T forwards, then in the backward all T
  backwards in reverse order: the bubble is (S-1)/(T+S-1). It is a
  differentiable function: one autograd node whose backward sends each
  cotangent back to the stage before. Its input (every rank holds it whole,
  as JAX's replicated input) enters at stage 0; its output is made whole on
  every stage rank (JAX's ``psum`` of the last stage's output), and so is
  its backward: the input's cotangent leaves stage 0 for every rank, and
  each stage's parameter gradients are summed over the stage group, so
  every rank ends with the gradients of the sequential model. Each stage
  keeps its T microbatches' autograd graphs (O(T) memory), or with
  ``remat_stage`` only their inputs, and recomputes the stage in the
  backward.
* **1F1B** (``pipeline_train_1f1b``): the one-forward-one-backward training
  schedule of PipeDream-Flush (Narayanan et al. 2021). Stage s runs S-1-s
  warm-up forwards, then alternates one forward and one backward, then
  drains the rest of its backwards. The last stage scores each microbatch's
  loss as soon as its forward ends and sends the cotangent back; each
  saved stage input is re-linearized (the stage recomputed with gradients)
  at its backward, so a stage holds at most S microbatch inputs whatever T
  is (the JAX ring buffer holds 2S). It returns the loss, this rank's
  gradients and the input cotangent, not a differentiable output.

Dropout: a stage's per-microbatch side inputs (``stage_aux``: for DETR, one
seed per layer slot and microbatch, drawn alike on every rank from the
trainer's generator) are passed to the stage function on every run of a
microbatch, the recompute included, so the masks of the backward equal the
forward's.

Composition: with ``data_axis`` each data rank holds its slice of the
batch, and 1F1B sums the loss and the gradients over the data group; the
GPipe function leaves that to DDP around the model (``Trainer(mesh=)``).
Tensor parallelism inside a stage is the model's own (``parallel/tp.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import mesh as mesh_lib
from . import multihost, p2p

Tree = Dict[str, torch.Tensor]

# Tag kinds of a call's links (the tag is call * _CALL + kind * _KIND + 1 + t).
_FWD, _BWD, _OUT, _DX, _LOSS = range(5)
_KIND, _CALL = 1024, 8 * 1024
# Schedule calls so far, by stage group (its global ranks): the ranks of one
# pipeline make the same sequence of calls, so a call's tags agree on them.
_calls: Dict[tuple, "itertools.count"] = {}

# The last schedule call on this rank: its name, stage, microbatches and the
# most microbatch inputs (or graphs) it held at once.
last_stats: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A pipeline over ``mesh``'s ``stage_axis`` (``DETR(pipeline=)``,
    ``Trainer(pipeline_1f1b=)``).

    ``n_micro``: microbatches per batch (None: ``choose_n_micro``);
    ``data_axis``: the mesh axis of data parallelism around the pipeline;
    ``tp_axis``: the axis of tensor parallelism inside each stage, as in
    JAX: the model must already be split over it (``parallel/tp.py``
    ``parallelize``), or its GPipe forward raises ValueError; the 1F1B
    Trainer refuses it (NotImplementedError);
    ``remat_stage``: GPipe keeps each microbatch's stage input only and
    recomputes the stage in the backward."""

    mesh: Any
    n_micro: Optional[int] = None
    stage_axis: str = "stage"
    data_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    remat_stage: bool = False


def choose_n_micro(batch: int, n_stages: int, data: int = 1) -> int:
    """Largest microbatch count <= 2*n_stages (bubble under ~33%) that
    divides the batch and keeps each microbatch divisible by the data axis;
    ValueError when none does (the JAX package's rule)."""
    n_micro = max(2 * n_stages, 1)
    while n_micro > 1 and (batch % n_micro or (batch // n_micro) % data):
        n_micro //= 2
    if batch % n_micro or (batch // n_micro) % data:
        raise ValueError(
            f"batch {batch} cannot be microbatched over data axis "
            f"{data}: batch must be divisible by the data-parallel size")
    return n_micro


def split_layers_into_stages(layers: Sequence[Any], n_stages: int,
                             pad: bool = False) -> List[List[Any]]:
    """``layers`` split contiguously into ``n_stages`` lists of equal
    length: stage s holds layers s*per .. (s+1)*per - 1. Without ``pad``
    the count must divide (ValueError, the JAX package's GPipe split); with
    ``pad`` per = ceil(L / S) and None (an identity slot) fills the last
    stages' tails (the JAX package's 1F1B slots, ``detr_1f1b.py``)."""
    n = len(layers)
    if not pad and n % n_stages:
        raise ValueError(f"{n} layers do not split over {n_stages} stages")
    per = -(-n // n_stages)
    slots = list(layers) + [None] * (per * n_stages - n)
    return [slots[s * per:(s + 1) * per] for s in range(n_stages)]


@dataclasses.dataclass(frozen=True)
class Stage:
    """A rank's place in its pipeline: its stage ``index`` of ``size``, the
    global ranks of its stage group in stage order, and the group."""

    index: int
    size: int
    ranks: tuple
    group: Any

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def rank(self, index: int) -> int:
        return self.ranks[index]


def stage_of(mesh, stage_axis: str = "stage") -> Stage:
    """This rank's ``Stage`` on ``mesh`` (one stage without a mesh or axis)."""
    group, index, size = mesh_lib.axis(mesh, stage_axis)
    if size == 1:
        return Stage(0, 1, (multihost.rank(),), None)
    dim = mesh.mesh_dim_names.index(stage_axis)
    coord = list(mesh.get_coordinate())
    coord[dim] = slice(None)
    return Stage(index, size, tuple(int(r) for r in mesh.mesh[tuple(coord)].tolist()), group)


def data_of(mesh, data_axis: Optional[str]):
    """(group, index, size) of the data axis, (None, 0, 1) without one."""
    return mesh_lib.axis(mesh, data_axis) if data_axis else (None, 0, 1)


def _bounded_all_reduce(tensor: torch.Tensor, group) -> None:
    """Sum ``tensor`` over ``group`` in place, waiting at most the group's
    timeout (a mesh's sub-groups carry torch's 30-minute default)."""
    if group is None or dist.get_world_size(group) == 1:
        return
    p2p._bounded(dist.all_reduce(tensor, group=group, async_op=True))


def all_reduce_tensors(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors summed over ``group``: one flat all-reduce per dtype."""
    if group is None or dist.get_world_size(group) == 1 or not tensors:
        return tensors
    out = list(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _bounded_all_reduce(flat, group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def microbatch(tree: Tree, t: int, n_micro: int) -> Tree:
    """Microbatch ``t`` of ``n_micro`` of every leaf (a view of dim 0)."""
    out = {}
    for k, v in tree.items():
        mb = v.shape[0] // n_micro
        out[k] = v.narrow(0, t * mb, mb)
    return out


def _tags(call: int, kind: int) -> int:
    return (call % (1 << 16)) * _CALL + kind * _KIND


def _next_call(stage: "Stage") -> int:
    return next(_calls.setdefault(stage.ranks, itertools.count()))


def dropout_seeds(generator: Optional[torch.Generator], n_slots: int, n_micro: int):
    """One seed per (microbatch, slot), drawn from ``generator`` on every rank
    alike (its state advances the same whatever stage a rank runs): a list
    of n_micro lists of n_slots ints, or None without a generator."""
    if generator is None:
        return None
    seeds = torch.randint(0, 2**62, (n_micro, n_slots), generator=generator,
                          device=generator.device)
    return seeds.cpu().tolist()


def seeded(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None: None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def _grad_inputs(tree: Tree, grads: Dict[str, bool]) -> Tree:
    """``tree`` detached, its leaves marked in ``grads`` requiring grad."""
    return {k: v.detach().requires_grad_(bool(grads.get(k)) and v.is_floating_point())
            for k, v in tree.items()}


def _out_grads(inp: Tree, out: Tree, grads: Dict[str, bool]) -> Dict[str, bool]:
    """Which leaves of a stage's output carry a gradient back: a leaf passed
    through unchanged keeps its input's mark, any other float leaf does."""
    return {k: (bool(grads.get(k)) if k in inp and v is inp[k] else v.is_floating_point())
            for k, v in out.items()}


def _vjp(out: Tree, ct: Tree, inp: Tree, grads: Dict[str, bool], params: List[torch.Tensor]):
    """Cotangents of ``inp``'s marked leaves and of ``params`` given the
    cotangent ``ct`` of ``out`` (zeros where nothing flows)."""
    pairs = [(out[k], c) for k, c in ct.items() if out[k].requires_grad]
    keys = [k for k in inp if grads.get(k) and inp[k].requires_grad]
    wrt = [inp[k] for k in keys] + list(params)
    if pairs and wrt:
        g = torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                allow_unused=True)
    else:
        g = [None] * len(wrt)
    gx = {k: (g[i] if g[i] is not None else torch.zeros_like(inp[k]))
          for i, k in enumerate(keys)}
    return gx, list(g[len(keys):])


def _accumulate(acc: List[Optional[torch.Tensor]], grads) -> None:
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def _call_stage(stage_fn, stage_aux, t, a):
    return stage_fn(a) if stage_aux is None else stage_fn(stage_aux[t], a)


def _share(tree: Optional[Tree], src_index: int, stage: Stage, tag: int, device) -> Tree:
    """``tree`` from stage ``src_index`` on every rank of the stage group
    (point to point from it to each other stage)."""
    if stage.size == 1:
        return tree
    if stage.index == src_index:
        for i in range(stage.size):
            if i != src_index:
                p2p.Link(stage.rank(i), tag, device).send(tree, 0)
        p2p.drain()  # a schedule call leaves no send in flight
        return tree
    return p2p.Link(stage.rank(src_index), tag, device).recv(0)


class _GPipeRun:
    """One GPipe call on one rank: the forward's state kept for its backward."""

    def __init__(self, stage_fn, keys, params, stage, n_micro, out_keys, remat, stage_aux,
                 device):
        self.stage_fn, self.keys, self.params, self.stage = stage_fn, keys, params, stage
        self.n_micro, self.out_keys, self.remat = n_micro, out_keys, remat
        self.stage_aux, self.device, self.call = stage_aux, device, _next_call(stage)

    def forward(self, x: Tree, x_grads: Dict[str, bool]):
        st, T = self.stage, self.n_micro
        tag = lambda kind: _tags(self.call, kind)  # noqa: E731
        self.fwd_in = p2p.Link(None if st.first else st.rank(st.index - 1), tag(_FWD),
                               self.device)
        self.fwd_out = p2p.Link(None if st.last else st.rank(st.index + 1), tag(_FWD),
                                self.device)
        self.saved, outs = [], []
        for t in range(T):
            if st.first:
                inp, grads = microbatch(x, t, T), x_grads
            else:
                inp = self.fwd_in.recv(t)
                grads = self.fwd_in.grads()
            if self.remat:
                with torch.no_grad():
                    out = _call_stage(self.stage_fn, self.stage_aux, t, inp)
                self.saved.append((inp, None, grads))
            else:
                inp = _grad_inputs(inp, grads)
                with torch.enable_grad():
                    out = _call_stage(self.stage_fn, self.stage_aux, t, inp)
                self.saved.append((inp, out, grads))
            if st.last:
                outs.append({k: out[k].detach() for k in self.out_keys})
            else:
                self.fwd_out.send(out, t, _out_grads(inp, out, grads))
        p2p.drain()
        last_stats.clear()
        last_stats.update(schedule="gpipe", stage=st.index, n_micro=T, max_live=len(self.saved))
        y = None
        if st.last:
            y = {k: torch.cat([o[k] for o in outs]) for k in self.out_keys}
        y = _share(y, st.size - 1, st, tag(_OUT), self.device)
        return tuple(y[k].clone() for k in self.out_keys)

    def backward(self, gys, x_needs):
        st, T = self.stage, self.n_micro
        tag = lambda kind: _tags(self.call, kind)  # noqa: E731
        ct_in = None if st.last else p2p.Link(st.rank(st.index + 1), tag(_BWD), self.device,
                                              p2p.cotangent_spec(self.fwd_out.spec))
        ct_out = None if st.first else p2p.Link(st.rank(st.index - 1), tag(_BWD), self.device,
                                                p2p.cotangent_spec(self.fwd_in.spec))
        params = [p for p in self.params if p.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(params)
        dxs = [None] * T
        for t in reversed(range(T)):
            inp, out, grads = self.saved[t]
            self.saved[t] = None
            if out is None:  # remat: the stage again, with gradients, same aux
                inp = _grad_inputs(inp, grads)
                with torch.enable_grad():
                    out = _call_stage(self.stage_fn, self.stage_aux, t, inp)
            if st.last:
                ct = {}
                for k, g in zip(self.out_keys, gys):
                    mb = out[k].shape[0]
                    ct[k] = torch.zeros_like(out[k]) if g is None else g.narrow(0, t * mb, mb)
            else:
                ct = ct_in.recv(t)
            with torch.enable_grad():
                gx, gp = _vjp(out, ct, inp, grads, params)
            _accumulate(acc, gp)
            if st.first:
                dxs[t] = gx
            else:
                ct_out.send(gx, t)
        p2p.drain()
        dx = None
        if st.first:
            dx = {k: torch.cat([d[k] for d in dxs]) for k in dxs[0]}
        dx = _share(dx, 0, st, tag(_DX), self.device)
        acc = [torch.zeros_like(p) if g is None else g for p, g in zip(params, acc)]
        acc = all_reduce_tensors(acc, st.group)
        by_param = dict(zip(map(id, params), acc))
        x_grads = tuple(dx.get(k) if need else None for k, need in zip(self.keys, x_needs))
        return x_grads + tuple(by_param.get(id(p)) for p in self.params)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x_keys_grads, *tensors):
        ctx.run = run
        nx = len(run.keys)
        x = dict(zip(run.keys, tensors[:nx]))
        grads = {k: need for k, need in zip(run.keys, x_keys_grads)}
        return run.forward(x, grads)

    @staticmethod
    def backward(ctx, *gys):
        run = ctx.run
        x_needs = ctx.needs_input_grad[2:2 + len(run.keys)]
        return (None, None) + run.backward(gys, x_needs)


def pipeline_forward(stage_fn: Callable, stage_params: Sequence[torch.Tensor], x: Tree, mesh, *,
                     n_micro: int, stage_axis: str = "stage", remat_stage: bool = False,
                     out_keys: Optional[Sequence[str]] = None,
                     stage_aux: Optional[Sequence[Any]] = None) -> Tree:
    """Run ``x`` through the pipeline's stages, GPipe-scheduled, and return
    ``out_keys`` of the last stage's output (default: every key), whole on
    every stage rank. Differentiable.

    ``stage_fn(a)`` (``stage_fn(stage_aux[t], a)`` with ``stage_aux``) is
    this rank's stage: it maps a microbatch tree to a tree (a leaf it does
    not change it returns as the same object). ``x`` (dict of (B, ...)
    tensors) is the same on every stage rank; each leaf is split into
    ``n_micro`` microbatches along dim 0. ``stage_params`` lists, in the
    same order on every rank, every parameter any stage's ``stage_fn``
    reads: each rank's gradients of them are summed over the stage group.
    Under data parallelism ``x`` is this data rank's batch and the caller
    sums the gradients over the data group (DDP around the model); tensor
    parallelism inside a stage is the stage's own modules' split."""
    stage = stage_of(mesh, stage_axis)
    keys = list(x)
    b = x[keys[0]].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    device = x[keys[0]].device
    out_keys = tuple(out_keys or keys)
    run = _GPipeRun(stage_fn, keys, list(stage_params), stage, n_micro, out_keys, remat_stage,
                    stage_aux, device)
    grads = tuple(x[k].requires_grad for k in keys)
    y = _GPipe.apply(run, grads, *[x[k] for k in keys], *stage_params)
    return dict(zip(out_keys, y))


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable,
                        stage_params: Sequence[torch.Tensor], x: Optional[Tree],
                        targets: Optional[Tree], mesh, *, n_micro: int,
                        stage_axis: str = "stage", data_axis: Optional[str] = None,
                        loss_params: Optional[Sequence[torch.Tensor]] = None,
                        stage_aux: Optional[Sequence[Any]] = None, device=None):
    """One 1F1B training step through the pipeline.

    ``stage_fn`` is this rank's stage (``stage_fn(a)``, or
    ``stage_fn(stage_aux[t], a)``, as in ``pipeline_forward``) over this
    rank's ``stage_params``; ``x`` (dict of (B, ...) tensors) is stage 0's
    input (others may pass None); ``targets`` (dict of (B, ...)) are read on
    the last stage, whose ``loss_fn(y_mb, targets_mb)`` is a sum-style loss
    (total = sum over microbatches; normalize outside) over ``loss_params``.

    Returns ``(loss, stage_grads, dx, loss_grads)`` (the last omitted
    without ``loss_params``): the loss on every stage rank; the gradients
    of this rank's ``stage_params`` (a list, zeros where none flowed); on
    stage 0 the cotangent of ``x`` (its marked leaves; None elsewhere); on
    the last stage the gradients of ``loss_params`` (None elsewhere). With
    ``data_axis`` the loss and gradients are summed over the data group.
    ``device`` (default: that of ``x`` or ``targets``) is where this rank's
    boundaries arrive; a middle stage names it. ``last_stats["max_live"]``
    is the most microbatch inputs this rank held at once (at most S - stage
    index)."""
    stage = stage_of(mesh, stage_axis)
    S, s, T = stage.size, stage.index, int(n_micro)
    call = _next_call(stage)
    tag = lambda kind: _tags(call, kind)  # noqa: E731
    if device is None:
        device = next(iter((x or targets).values())).device
    params = list(stage_params)
    lparams = list(loss_params or [])
    fwd_in = p2p.Link(None if stage.first else stage.rank(s - 1), tag(_FWD), device)
    fwd_out = p2p.Link(None if stage.last else stage.rank(s + 1), tag(_FWD), device)
    links = {}

    def ct_link(name):
        if name not in links:
            if name == "in":
                links[name] = p2p.Link(stage.rank(s + 1), tag(_BWD), device,
                                       p2p.cotangent_spec(fwd_out.spec))
            else:
                links[name] = p2p.Link(stage.rank(s - 1), tag(_BWD), device,
                                       p2p.cotangent_spec(fwd_in.spec))
        return links[name]

    x_grads = None
    if stage.first:
        if x is None:
            raise ValueError("stage 0 needs the pipeline's input x")
        x_grads = {k: bool(v.requires_grad and v.is_floating_point()) for k, v in x.items()}
    acc: List[Optional[torch.Tensor]] = [None] * len(params)
    lacc: List[Optional[torch.Tensor]] = [None] * len(lparams)
    loss_sum = torch.zeros((), device=device, dtype=torch.float64)
    saved: Dict[int, tuple] = {}
    dxs: Dict[int, Tree] = {}
    live = 0

    def take_input(t):
        if stage.first:
            return microbatch({k: v.detach() for k, v in x.items()}, t, T), x_grads
        inp = fwd_in.recv(t)
        return inp, fwd_in.grads()

    def give_back(t, gx):
        if stage.first:
            dxs[t] = gx
        else:
            ct_link("out").send(gx, t)

    def forward(t):
        nonlocal loss_sum, live
        inp, grads = take_input(t)
        if stage.last:  # its backward follows at once: no recompute
            inp = _grad_inputs(inp, grads)
            with torch.enable_grad():
                out = _call_stage(stage_fn, stage_aux, t, inp)
                loss = loss_fn(out, microbatch(targets, t, T))
                gx, g = _vjp({"loss": loss}, {"loss": torch.ones_like(loss)}, inp, grads,
                             params + lparams)
            _accumulate(acc, g[:len(params)])
            _accumulate(lacc, g[len(params):])
            loss_sum = loss_sum + loss.detach().double()
            give_back(t, gx)
            return
        with torch.no_grad():
            out = _call_stage(stage_fn, stage_aux, t, inp)
        saved[t] = (inp, grads)
        live = max(live, len(saved))
        fwd_out.send(out, t, _out_grads(inp, out, grads))

    def backward(t):
        if stage.last:
            return
        ct = ct_link("in").recv(t)
        inp, grads = saved.pop(t)
        inp = _grad_inputs(inp, grads)
        with torch.enable_grad():
            out = _call_stage(stage_fn, stage_aux, t, inp)
            gx, g = _vjp(out, ct, inp, grads, params)
        _accumulate(acc, g)
        give_back(t, gx)

    warm = min(S - 1 - s, T)
    for t in range(warm):
        forward(t)
    for i in range(T - warm):
        forward(warm + i)
        backward(i)
    for i in range(T - warm, T):
        backward(i)
    p2p.drain()
    last_stats.clear()
    last_stats.update(schedule="1f1b", stage=s, n_micro=T, max_live=live)

    shared = _share({"loss": loss_sum.reshape(1)} if stage.last else None, S - 1, stage,
                    tag(_LOSS), device)
    loss = shared["loss"].reshape(())
    stage_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, acc)]
    loss_grads = ([torch.zeros_like(p) if g is None else g for p, g in zip(lparams, lacc)]
                  if stage.last else None)
    data_group, _, data_size = data_of(mesh, data_axis)
    if data_size > 1:
        loss = loss.clone()
        _bounded_all_reduce(loss, data_group)
        stage_grads = all_reduce_tensors(stage_grads, data_group)
        if loss_grads is not None:
            loss_grads = all_reduce_tensors(loss_grads, data_group)
    dx = ({k: torch.cat([dxs[t][k] for t in range(T)]) for k in dxs[0]}
          if stage.first else None)
    if loss_params is None:
        return loss, stage_grads, dx
    return loss, stage_grads, dx, loss_grads


def scan_layers(apply_one: Callable, layers: Sequence[Any]) -> Callable:
    """A stage function applying ``apply_one(layer, a)`` over ``layers`` in
    order (the JAX package's ``scan_layers`` over a stage's stacked layers)."""

    def stage_fn(a):
        for layer in layers:
            a = apply_one(layer, a)
        return a

    return stage_fn


def pipeline_transformer_encoder(encoder_layer_apply: Callable, encoder_layers: Sequence[Any],
                                 src: torch.Tensor, mesh, *, n_stages: Optional[int] = None,
                                 n_micro: Optional[int] = None, stage_axis: str = "stage",
                                 data_axis: Optional[str] = None,
                                 remat_stage: bool = False) -> torch.Tensor:
    """Pipeline an encoder stack (``encoder_layers``, every rank holding the
    list; each runs its stage's share) over the mesh's stage axis, GPipe.
    ``encoder_layer_apply(layer, src) -> src`` is one layer with positions
    and masks closed over."""
    stage = stage_of(mesh, stage_axis)
    n_stages = n_stages or stage.size
    if n_stages != stage.size:
        raise ValueError(f"{n_stages} stages on a stage axis of {stage.size}")
    _, _, data = data_of(mesh, data_axis)
    if n_micro is None:
        n_micro = choose_n_micro(src.shape[0] * data, n_stages, data)
    mine = split_layers_into_stages(list(encoder_layers), n_stages)[stage.index]
    run = scan_layers(encoder_layer_apply, mine)
    params = [p for layer in encoder_layers for p in layer.parameters()]
    out = pipeline_forward(lambda a: {"src": run(a["src"])}, params, {"src": src}, mesh,
                           n_micro=n_micro, stage_axis=stage_axis, remat_stage=remat_stage)
    return out["src"]
