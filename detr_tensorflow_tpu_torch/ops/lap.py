"""Batched exact linear assignment: the hand-written Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel ``_lap_kernel`` / ``solve_lap_masked_pallas`` of
``detr_tensorflow_tpu/ops/pallas/lap.py`` and solves what
``detr_tensorflow_tpu/ops/matcher.py:solve_lap_masked`` solves: per
problem, a (R, C) cost matrix with R <= C and a row mask; each real row
gets a distinct column at minimal total cost, masked rows get -1, at any
number of columns, as the JAX package's ``lax.while_loop`` solver takes. The
CUDA source is ``csrc/lap.cu``: one CTA of sixteen warps per problem, the
real rows staged compacted, the auction pre-pass of ``matcher.py`` with the
bids spread over the warps, then its shortest augmenting paths. Three
instances, picked per launch from the width: up to 127 columns (DETR's 100
queries) and up to 255 (the panoptic recipe's 250), the paths on one warp
with the column state in registers; above 255 (Deformable-DETR's 300,
DINO's 900, wider) the generic kernel, the state in shared memory or, past
what that holds, in a device scratch this wrapper allocates, every warp on
each Dijkstra step. Its header note says what bounds it and how a problem
with more real rows than shared memory holds is read.

``solve_lap_masked`` takes CUDA tensors to the kernel and CPU tensors to
``reference_solve_lap_masked``; there is no fallback from one to the
other. The kernel counts the real rows on the device, so the call never
synchronises with the host.
"""

from __future__ import annotations

import ctypes

import torch

_SOURCE = "lap.cu"
_WIDE_COLS = 255  # the most columns the 256-column instance takes (the virtual column 0 too)
_NARROW_COLS = 127  # the most columns the 128-column instance takes
_INF = 1e9  # matcher.py's _INF
_AUCTION_ROUNDS = 5


def _solve_one(cost: torch.Tensor, row_mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``matcher.solve_lap_masked`` for one (R, C) problem, in PyTorch:
    the five-round auction, then the serial shortest augmenting paths.
    fp32 throughout, ties to the lowest column (argmin) and lowest row.
    Returns the column of each row and the number of Dijkstra steps the
    augmenting paths took."""
    r, c = cost.shape
    dev = cost.device
    rows_idx = torch.arange(r, device=dev)
    cols_idx = torch.arange(c, device=dev)
    u = torch.zeros(r, device=dev)
    v = torch.zeros(c, device=dev)
    owner = torch.full((c,), r, device=dev)  # r = free
    for _ in range(_AUCTION_ROUNDS):
        assigned = (owner[None, :] == rows_idx[:, None]).any(dim=1)
        bidder = row_mask & ~assigned
        red = cost - v[None, :]
        min1, j1 = red.min(dim=1)
        onehot = j1[:, None] == cols_idx[None, :]
        min2 = torch.where(onehot, _INF, red).min(dim=1).values
        min2 = torch.where(min2 < _INF / 2, min2, min1)  # c == 1: no second column
        bid_on = onehot & bidder[:, None]
        win_row = torch.where(bid_on, rows_idx[:, None], r).min(dim=0).values
        has_bid = win_row < r
        won = bidder & (torch.where(onehot, win_row[None, :], r).min(dim=1).values == rows_idx)
        u = torch.where(won, min2, torch.where(bidder, min1, u))
        v_new = torch.where(bid_on & won[:, None], cost - u[:, None], _INF).min(dim=0).values
        v = torch.where(has_bid, v_new, v)
        owner = torch.where(has_bid, win_row, owner)
    assigned = (owner[None, :] == rows_idx[:, None]).any(dim=1)

    # 1-indexed rows and columns; column 0 is virtual and carries the row
    # being inserted.
    zero = torch.zeros(1, device=dev)
    costp = torch.zeros((r + 1, c + 1), device=dev)
    costp[1:, 1:] = cost
    u = torch.cat([zero, torch.where(row_mask, u, 0.0)])
    v = torch.cat([zero, v])
    p = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                   torch.where(owner < r, owner + 1, 0)])
    real_col = torch.arange(c + 1, device=dev) > 0
    steps = 0
    for i in (row_mask & ~assigned).nonzero().flatten().tolist():
        p[0] = i + 1
        minv = torch.full((c + 1,), _INF, device=dev)
        way = torch.zeros(c + 1, dtype=torch.long, device=dev)
        used = torch.zeros(c + 1, dtype=torch.bool, device=dev)
        j0 = 0
        while True:
            steps += 1
            used[j0] = True
            i0 = int(p[j0])
            cur = costp[i0] - u[i0] - v
            cand = real_col & ~used
            better = cand & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(cand, minv, _INF)
            j1 = int(masked.argmin())
            delta = masked[j1]
            u[p[used]] += delta  # the rows of used columns are distinct
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
            if not bool(delta < _INF / 2) or int(p[j0]) == 0:
                break
        while j0 != 0:  # relink along the predecessor chain
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1

    col_of_row = torch.full((r,), -1, dtype=torch.int32, device=dev)
    matched = p[1:] > 0
    col_of_row[p[1:][matched] - 1] = cols_idx[matched].to(torch.int32)
    return col_of_row, steps


def reference_solve_lap_masked(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Plain version: (P, R, C) costs and (P, R) bool row masks to (P, R)
    int32 column per row, -1 for masked rows, one problem after another."""
    _check(cost, row_mask)
    cost = cost.float()
    return torch.stack([_solve_one(cost[i], row_mask[i])[0] for i in range(cost.shape[0])])


def augmenting_steps(cost: torch.Tensor, row_mask: torch.Tensor) -> list[int]:
    """The Dijkstra steps of each problem's augmenting paths, counted by the
    plain version: the serial chain that the kernel runs on one warp."""
    _check(cost, row_mask)
    cost = cost.float()
    return [_solve_one(cost[i], row_mask[i])[1] for i in range(cost.shape[0])]


def _check(cost, row_mask):
    if cost.dim() != 3:
        raise ValueError(f"cost must be (P, R, C), got {tuple(cost.shape)}")
    p, r, c = cost.shape
    if r > c:
        raise ValueError(f"more rows than columns: {r} > {c}")
    if row_mask.dtype != torch.bool or tuple(row_mask.shape) != (p, r):
        raise ValueError(f"row_mask must be bool {(p, r)}, got {row_mask.dtype} "
                         f"{tuple(row_mask.shape)}")
    if row_mask.device != cost.device:
        raise ValueError("cost and row_mask lie on different devices")


def _library() -> ctypes.CDLL:
    from .nvcc_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.lap_solve
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lap_solve_generic.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.lap_solve_generic.restype = ctypes.c_int
        lib.lap_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.lap_scratch_bytes.restype = ctypes.c_int64
    return lib


def generic_scratch_bytes(problems: int, rows: int, cols: int) -> int:
    """Bytes of device scratch the generic instance needs for these
    problems: 0 where each problem's state fits in shared memory."""
    nbytes = _library().lap_scratch_bytes(problems, rows, cols)
    if nbytes < 0:
        raise RuntimeError(f"lap_scratch_bytes failed: cudaError {-nbytes}")
    return nbytes


def solve_lap_masked(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Batched partial rectangular LAP: (P, R, C) float costs, R <= C, and
    (P, R) bool row masks -> (P, R) int32 assigned column per row, -1 for
    masked rows.

    A CUDA tensor launches the kernel: its 128-column instance up to 127
    columns, its 256-column one up to 255, the generic one above
    (``solve_lap_masked.launches`` counts every launch,
    ``solve_lap_masked.wide_launches`` those of the 256-column instance,
    ``solve_lap_masked.generic_launches`` those of the generic one); a CPU
    tensor goes to ``reference_solve_lap_masked``; any other device raises.
    """
    _check(cost, row_mask)
    if cost.device.type == "cpu":
        return reference_solve_lap_masked(cost, row_mask)
    if cost.device.type != "cuda":
        raise ValueError(f"no LAP kernel for device {cost.device}")
    p, r, c = cost.shape
    cost = cost.detach().float().contiguous()
    row_mask = row_mask.contiguous()
    out = torch.empty((p, r), device=cost.device, dtype=torch.int32)
    with torch.cuda.device(cost.device):
        lib = _library()
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        if c <= _WIDE_COLS:
            err = lib.lap_solve(cost.data_ptr(), row_mask.data_ptr(), out.data_ptr(), p, r, c,
                                stream)
        else:
            nbytes = generic_scratch_bytes(p, r, c)
            scratch = (torch.empty(nbytes // 4, device=cost.device, dtype=torch.int32)
                       if nbytes else None)  # 0: the state fits in shared memory
            err = lib.lap_solve_generic(cost.data_ptr(), row_mask.data_ptr(), out.data_ptr(),
                                        scratch.data_ptr() if nbytes else None, p, r, c, stream)
    if err != 0:
        raise RuntimeError(f"lap_solve launch failed: cudaError {err}")
    solve_lap_masked.launches += 1
    solve_lap_masked.wide_launches += _NARROW_COLS < c <= _WIDE_COLS
    solve_lap_masked.generic_launches += c > _WIDE_COLS
    return out


solve_lap_masked.launches = 0
solve_lap_masked.wide_launches = 0
solve_lap_masked.generic_launches = 0
