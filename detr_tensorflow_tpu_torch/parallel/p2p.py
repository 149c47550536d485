"""Point-to-point transfers of a dict of tensors between pipeline stages.

The JAX package has no counterpart: its schedules rotate activations with
``jax.lax.ppermute`` inside one SPMD program. Here each stage is a process,
and a stage boundary is a dict of tensors (activations forward, their
cotangents backward) sent from one rank to its neighbour with
``torch.distributed`` point-to-point ops on the world group.

The route is chosen from the backend and the tensors' device, never after a
failure (``route``):

  * ``"nccl"``: CUDA tensors under NCCL, sent as they lie on the card;
  * ``"gloo-host"``: CUDA tensors under Gloo, which sends CPU tensors only
    (the case of ranks sharing one card, which NCCL refuses): the sender
    copies the packed tensors into pinned host memory and sends that, the
    receiver receives into pinned host memory and copies it to its card;
  * ``"gloo"``: CPU tensors under Gloo, sent as they are.

A dict travels as one message: its tensors packed into one flat byte
buffer, each at a 16-byte aligned offset, and unpacked on arrival as views
of the received buffer. The receiver must know the layout (the ``Spec``:
keys, shapes, dtypes and which tensors carry a gradient back); a ``Link``
sends it once, in a header ahead of a boundary's first message, and both
sides derive the cotangents' layout from it. Every send is asynchronous
(its buffer is kept until it completes); every receive and every wait on a
send is bounded by ``multihost.timeout()`` and raises past it. ``stats``
counts bytes, messages and the host time spent sending and receiving.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import multihost

HEADER_BYTES = 4096  # a Spec as JSON, length-prefixed
_ALIGN = 16

stats = {"bytes_sent": 0, "bytes_received": 0, "messages": 0, "send_ms": 0.0, "recv_ms": 0.0}
_in_flight: List[Tuple[object, torch.Tensor]] = []  # (work, buffer) of sends not yet waited on


class Leaf(NamedTuple):
    key: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    grad: bool  # whether a cotangent of it travels back


Spec = List[Leaf]


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0.0 if k.endswith("_ms") else 0


def route(device) -> str:
    """The transfer route for tensors on ``device`` under the running backend."""
    device = torch.device(device)
    if dist.get_backend() == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL sends CUDA tensors only")
        return "nccl"
    return "gloo-host" if device.type == "cuda" else "gloo"


def spec_of(tree: Dict[str, torch.Tensor], grads: Optional[Dict[str, bool]] = None) -> Spec:
    """The layout of ``tree``; ``grads`` marks the leaves whose cotangent
    travels back (default: every floating-point leaf)."""
    return [Leaf(k, tuple(v.shape), v.dtype,
                 bool(grads[k]) if grads is not None else v.is_floating_point())
            for k, v in tree.items()]


def cotangent_spec(spec: Spec) -> Spec:
    """The layout of the cotangents of a boundary of layout ``spec``."""
    return [leaf for leaf in spec if leaf.grad]


def _layout(spec: Spec):
    offsets, total = [], 0
    for leaf in spec:
        offsets.append(total)
        n = leaf.dtype.itemsize * _numel(leaf.shape)
        total += -(-n // _ALIGN) * _ALIGN
    return offsets, max(total, _ALIGN)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nbytes(spec: Spec) -> int:
    return _layout(spec)[1]


def _pack(tree: Dict[str, torch.Tensor], spec: Spec) -> torch.Tensor:
    offsets, total = _layout(spec)
    first = tree[spec[0].key]
    flat = torch.empty(total, dtype=torch.uint8, device=first.device)
    for leaf, off in zip(spec, offsets):
        t = tree[leaf.key]
        if tuple(t.shape) != leaf.shape or t.dtype != leaf.dtype:
            raise ValueError(f"{leaf.key}: {tuple(t.shape)} {t.dtype}, the link carries "
                             f"{leaf.shape} {leaf.dtype}")
        n = leaf.dtype.itemsize * t.numel()
        flat[off:off + n].copy_(t.detach().contiguous().reshape(-1).view(torch.uint8))
    return flat


def _unpack(flat: torch.Tensor, spec: Spec) -> Dict[str, torch.Tensor]:
    offsets, _ = _layout(spec)
    out = {}
    for leaf, off in zip(spec, offsets):
        n = leaf.dtype.itemsize * _numel(leaf.shape)
        out[leaf.key] = flat[off:off + n].view(leaf.dtype).view(leaf.shape)
    return out


def _bounded(work) -> None:
    """Wait for ``work`` at most the group's timeout."""
    if work.wait(timeout=multihost.timeout()) is False:
        raise TimeoutError(f"a point-to-point transfer took longer than {multihost.timeout()}")


def _reap() -> None:
    while _in_flight and _in_flight[0][0].is_completed():
        _bounded(_in_flight.pop(0)[0])


def drain() -> None:
    """Wait for every send still in flight (bounded)."""
    while _in_flight:
        _bounded(_in_flight.pop(0)[0])


def _send_flat(flat: torch.Tensor, dst: int, tag: int) -> None:
    if route(flat.device) == "gloo-host":
        host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flat.device))
        done.synchronize()  # Gloo reads the host buffer from its own threads
        flat = host
    _in_flight.append((dist.isend(flat, dst, tag=tag), flat))
    _reap()


def _recv_flat(total: int, src: int, tag: int, device) -> torch.Tensor:
    kind = route(device)
    if kind == "gloo-host":
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    else:
        buf = torch.empty(total, dtype=torch.uint8, device=device)
    _bounded(dist.irecv(buf, src, tag=tag))
    return buf.to(device, non_blocking=True) if kind == "gloo-host" else buf


def send(tree: Dict[str, torch.Tensor], spec: Spec, dst: int, tag: int) -> None:
    """Send ``tree`` (laid out as ``spec``) to global rank ``dst``."""
    t0 = time.perf_counter()
    flat = _pack(tree, spec)
    _send_flat(flat, dst, tag)
    stats["bytes_sent"] += flat.numel()
    stats["messages"] += 1
    stats["send_ms"] += 1e3 * (time.perf_counter() - t0)


def recv(spec: Spec, src: int, tag: int, device) -> Dict[str, torch.Tensor]:
    """Receive a tree laid out as ``spec`` from global rank ``src`` onto
    ``device``."""
    t0 = time.perf_counter()
    total = nbytes(spec)
    out = _unpack(_recv_flat(total, src, tag, device), spec)
    stats["bytes_received"] += total
    stats["recv_ms"] += 1e3 * (time.perf_counter() - t0)
    return out


def send_spec(spec: Spec, dst: int, tag: int, device) -> None:
    body = json.dumps([[leaf.key, list(leaf.shape), str(leaf.dtype).split(".")[-1], leaf.grad]
                       for leaf in spec]).encode()
    if len(body) + 4 > HEADER_BYTES:
        raise ValueError(f"a header of {len(body)} bytes: at most {HEADER_BYTES - 4}")
    raw = len(body).to_bytes(4, "little") + body
    head = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
    head[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    _send_flat(head.to(device), dst, tag)
    stats["bytes_sent"] += HEADER_BYTES
    stats["messages"] += 1


def recv_spec(src: int, tag: int, device) -> Spec:
    head = _recv_flat(HEADER_BYTES, src, tag, device).cpu().numpy().tobytes()
    stats["bytes_received"] += HEADER_BYTES
    n = int.from_bytes(head[:4], "little")
    return [Leaf(k, tuple(shape), getattr(torch, dtype), bool(grad))
            for k, shape, dtype, grad in json.loads(head[4:4 + n].decode())]


class Link:
    """One direction of one stage boundary in one schedule call: messages to
    or from the global rank ``peer``, tagged ``tag + 1 + t`` for microbatch
    ``t``. Without a ``spec`` the first send carries the layout in a header
    (tag ``tag``) and the first receive reads it."""

    def __init__(self, peer: Optional[int], tag: int, device, spec: Optional[Spec] = None):
        self.peer, self.tag, self.device, self.spec = peer, int(tag), device, spec

    def send(self, tree: Dict[str, torch.Tensor], t: int,
             grads: Optional[Dict[str, bool]] = None) -> None:
        if self.spec is None:
            self.spec = spec_of(tree, grads)
            send_spec(self.spec, self.peer, self.tag, self.device)
        send(tree, self.spec, self.peer, self.tag + 1 + t)

    def recv(self, t: int) -> Dict[str, torch.Tensor]:
        if self.spec is None:
            self.spec = recv_spec(self.peer, self.tag, self.device)
        return recv(self.spec, self.peer, self.tag + 1 + t, self.device)

    def grads(self) -> Dict[str, bool]:
        return {leaf.key: leaf.grad for leaf in self.spec}
