"""Numpy models of how kernels B (``csrc/lap.cu``) and C
(``csrc/maxpool.cu``) split their work, on the CPU, against the plain
versions the card holds them to.

C: one thread a 16-byte channel group (or one element, the scalar channel
path) of a run of output columns of ``ROWS`` output rows, the window's last
input column carried into the next window, the taps folded in row-major
order by ATen's rule (take a tap that is greater or NaN), bf16 rounded back
as the card rounds. It must equal ``F.max_pool2d`` bit for bit (NaN where
it has NaN), and must not with the carried column shifted by one.

B: the real rows ranked by a ballot a warp and staged compacted, the
auction's bids, and the augmenting paths' argmin as two ``redux.sync``
minima (over an order-preserving key, then over the column among the lanes
at it). It must equal ``reference_solve_lap_masked`` exactly, ties
included, on any row mask.

The kernels' own constants (C's run lengths and ``ROWS``, B's ``kWarps``)
are read from their sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detr_tensorflow_tpu_torch.ops import lap
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(__file__).resolve().parent.parent / "detr_tensorflow_tpu_torch" / "csrc"


def constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())[1])


def pool_runs():
    """The run lengths C compiles: {(RUN, vector path)}."""
    found = re.findall(r"launch_run<U, (V|1), (\d+)>", (CSRC / "maxpool.cu").read_text())
    return {(int(run), v == "V") for v, run in found}


# ---- C: the max pool --------------------------------------------------------


def pool_model(bits, bf16, run, rows, vector, shift=0):
    """Kernel C over (B, H, W, C) element bits (uint16 bf16 or uint32 fp32):
    the output bits. ``shift=1`` carries column 2j instead of 2j + 1."""
    b_, h, w, c = bits.shape
    vals = ((bits.astype(np.uint32) << 16) if bf16 else bits).view(np.float32)
    v = (8 if bf16 else 4) if vector else 1
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    row_blocks, runs, groups = -(-ho // rows), -(-wo // run), c // v
    t = np.arange(b_ * row_blocks * runs * groups)  # the work index of each thread
    g, rest = t % groups, t // groups
    j0, block = (rest % runs) * run, rest // runs
    b, i0 = block // row_blocks, (block % row_blocks) * rows
    chan = g[:, None] * v + np.arange(v)
    nr = 2 * rows + 1
    rr = 2 * i0[:, None] - 1 + np.arange(nr)
    valid = (rr >= 0) & (rr < h)

    def load(q, col):
        return vals[b[:, None], np.clip(rr[:, q], 0, h - 1)[:, None],
                    np.clip(col, 0, w - 1)[:, None], chan]

    def fold(best, tap, take):
        with np.errstate(invalid="ignore"):
            take = take[:, None] & ((tap > best) | np.isnan(tap))
        return np.where(take, tap, best)

    out = np.full((b_, ho, wo, c), np.nan, np.float32)
    prev = [load(q, 2 * j0 - 1) for q in range(nr)]
    for k in range(run):
        j = j0 + k
        left, right = j > 0, 2 * j + 1 < w
        mid = [load(q, 2 * j) for q in range(nr)]
        last = [load(q, 2 * j + 1) for q in range(nr)]
        for o in range(rows):
            best = np.full((len(t), v), -np.inf, np.float32)
            for dy in range(3):
                q = 2 * o + dy
                best = fold(best, prev[q], valid[:, q] & left)
                best = fold(best, mid[q], valid[:, q])
                best = fold(best, last[q], valid[:, q] & right)
            act = (j < wo) & (i0 + o < ho)
            out[b[act, None], (i0 + o)[act, None], j[act, None], chan[act]] = best[act]
        prev = mid if shift else last
    if not bf16:
        return out.view(np.uint32)
    # The card's float -> bf16 rounding: exact for a bf16 value, 0x7fff for NaN.
    rounded = np.where(np.isnan(out), np.uint32(0x7FFF), out.view(np.uint32) >> 16)
    return rounded.astype(np.uint16)


def same_bits(a, b, bf16):
    """Equal bits where neither is NaN, and NaN at the same places."""
    fa = ((a.astype(np.uint32) << 16) if bf16 else a).view(np.float32)
    fb = ((b.astype(np.uint32) << 16) if bf16 else b).view(np.float32)
    nan = np.isnan(fa)
    return bool((nan == np.isnan(fb)).all() and (a[~nan] == b[~nan]).all())


def pool_input(shape, seed):
    """Ties (small integers, +0 and -0), -inf and NaN; all exact in bf16."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 3, size=shape).astype(np.float32)
    x[x == -1] = -0.0
    x[rng.random(shape) < 0.05] = -np.inf
    x[rng.random(shape) < 0.02] = np.nan
    return x


def pool_case(shape, bf16, seed):
    """(input bits NHWC, F.max_pool2d's output bits NHWC) for ``shape``."""
    x = torch.from_numpy(pool_input(shape, seed))
    if bf16:
        x = x.to(torch.bfloat16)
    ref = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    ints, uints = (torch.int16, np.uint16) if bf16 else (torch.int32, np.uint32)
    return (x.contiguous().view(ints).numpy().view(uints),
            ref.contiguous().view(ints).numpy().view(uints))


HW = [(9, 11), (10, 12), (7, 8), (8, 9), (1, 2)]


@pytest.mark.parametrize("c", [4, 12, 64, 72])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_maxpool_model_equals_max_pool2d(bf16, c):
    """At the source's run lengths and ROWS on their channel paths, and at
    others on both (the vector path only where C * size is a multiple of 16
    bytes, as the kernel's launch picks), batch 3, odd and even H and W."""
    rows = constant("maxpool.cu", "ROWS")
    configs = {(run, rows, vector) for run, vector in pool_runs()}
    configs |= {(run, r, vector) for run, r in ((1, 1), (3, 2), (16, 2))
                for vector in (True, False)}
    for h, w in HW:
        bits, ref = pool_case((3, h, w, c), bf16, seed=h * w + c)
        for run, r, vector in configs:
            if vector and (c * (2 if bf16 else 4)) % 16:
                continue
            got = pool_model(bits, bf16, run, r, vector)
            assert same_bits(got, ref, bf16), (h, w, run, r, vector)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_maxpool_model_fails_with_the_carried_column_shifted(bf16):
    rows = constant("maxpool.cu", "ROWS")
    bits, ref = pool_case((3, 17, 34, 16), bf16, seed=7)
    for run, vector in pool_runs():
        assert same_bits(pool_model(bits, bf16, run, rows, vector), ref, bf16)
        assert not same_bits(pool_model(bits, bf16, run, rows, vector, shift=1), ref, bf16)


# ---- B: the batched LAP -----------------------------------------------------

_INF = np.float32(1e9)
_COLS = 128


def key(f):
    """The kernel's order-preserving key: -0 keyed as +0."""
    b = (np.asarray(f, np.float32) + np.float32(0)).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def redux_argmin(values, consider):
    """(value, column) of the warp's argmin over 128 column slots (column j
    on lane j % 32, slot j // 32): each lane keeps its lowest-key slot,
    lowest column first; then one redux.sync minimum over the keys and one
    over the columns of the lanes at it."""
    keys = np.where(consider, key(values), key(np.inf)).reshape(4, 32)  # [slot, lane]
    lane_key = np.full(32, key(np.inf), np.uint32)
    lane_col = np.full(32, 2**31 - 1, np.int64)
    for s in range(4):
        better = consider.reshape(4, 32)[s] & (keys[s] < lane_key)
        lane_key = np.where(better, keys[s], lane_key)
        lane_col = np.where(better, 32 * s + np.arange(32), lane_col)
    least = lane_key.min()
    col = np.where(lane_key == least, lane_col, 2**32 - 1).min()
    b = np.uint32(least)
    value = (b & 0x7FFFFFFF if b & 0x80000000 else ~b).astype(np.uint32).view(np.float32)
    return np.float32(value), int(col)


def lap_model(cost, mask, warps):
    """Kernel B on one (R, C) problem in float32: the column of each row."""
    r, c = cost.shape
    # Ballots a warp, ranks by popcount: the compacted real rows.
    real = np.zeros(32 * warps, bool)
    real[:r] = mask
    per_warp = real.reshape(warps, 32)
    before = np.concatenate([[0], np.cumsum(per_warp.sum(1))[:-1]])
    orig = np.empty(int(real.sum()), int)
    for w, lanes in enumerate(per_warp):
        for lane in np.flatnonzero(lanes):
            orig[before[w] + lanes[:lane].sum()] = 32 * w + lane
    n = len(orig)
    staged = cost[orig]  # the real rows, compacted

    cols = np.arange(_COLS)
    col_real = (cols >= 1) & (cols <= c)
    v = np.zeros(_COLS, np.float32)
    p = np.zeros(_COLS, int)
    owned = np.full(n, -1)
    u = np.zeros(n + 1, np.float32)
    for _ in range(5):
        bids = {}
        for k in range(n):  # the warps take the bidders in turn: order-free
            if owned[k] >= 0:
                continue
            red = np.full(_COLS, np.inf, np.float32)
            red[1:c + 1] = staged[k] - v[1:c + 1]
            best, best_j = redux_argmin(red, col_real)
            second, _ = redux_argmin(np.where(cols == best_j, _INF, red), col_real)
            bids[k] = (best_j, best, second if second < _INF / 2 else best)
        winner = {}
        for k, (j, *_) in bids.items():
            winner[j] = min(winner.get(j, k), k)
        for j, w in winner.items():
            v[j] = staged[w, j - 1] - bids[w][2]
            if p[j] > 0:
                owned[p[j] - 1] = -1
            owned[w], p[j] = j, w + 1
        for k, (j, min1, min2) in bids.items():
            u[k + 1] = min2 if winner[j] == k else min1

    for k in range(n):
        if owned[k] >= 0:
            continue
        minv = np.full(_COLS, _INF, np.float32)
        way = np.zeros(_COLS, int)
        used = np.zeros(_COLS, bool)
        p[0], j0, i0, alive = k + 1, 0, k + 1, True
        while True:
            used[j0] = True
            cand = col_real & ~used
            cur = np.full(_COLS, np.inf, np.float32)
            cur[1:c + 1] = staged[i0 - 1] - u[i0] - v[1:c + 1]
            better = cand & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            delta, j1 = redux_argmin(np.where(cand, minv, _INF), cols <= c)
            u[p[used]] += delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0, alive = j1, delta < _INF / 2
            if not alive or p[j0] == 0:
                break
            i0 = p[j0]
        while alive and j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    out = np.full(r, -1, np.int32)
    for j in np.flatnonzero(col_real & (p > 0)):
        out[orig[p[j] - 1]] = j - 1
    return out


def lap_cases():
    rng = np.random.default_rng(0)
    cases = []
    for r, c in ((12, 20), (30, 100), (1, 1), (5, 5)):
        cost = rng.normal(size=(r, c)).astype(np.float32)
        cases.append((f"scattered {r}x{c}", cost, rng.random(r) < 0.6))
    cases.append(("all masked", rng.normal(size=(8, 10)).astype(np.float32), np.zeros(8, bool)))
    cases.append(("R=C=127", rng.normal(size=(127, 127)).astype(np.float32), np.ones(127, bool)))
    cases.append(("R=C=127 scattered", rng.normal(size=(127, 127)).astype(np.float32),
                  rng.random(127) < 0.5))
    for r, c in ((10, 12), (30, 100)):  # ties everywhere
        cases.append((f"tied {r}x{c}", rng.integers(0, 3, size=(r, c)).astype(np.float32),
                      rng.random(r) < 0.7))
    return cases


@pytest.mark.parametrize("name,cost,mask", lap_cases(), ids=[c[0] for c in lap_cases()])
def test_lap_model_equals_plain(name, cost, mask):
    ref = lap.reference_solve_lap_masked(torch.from_numpy(cost)[None],
                                         torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_array_equal(lap_model(cost, mask, constant("lap.cu", "kWarps")), ref)


def test_lap_key_orders_floats_and_ties_zeros():
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.normal(size=200) * 10.0 ** rng.integers(-30, 30, 200),
                        [0.0, -0.0, np.inf, -np.inf, 1e9, -1e-45]]).astype(np.float32)
    k = key(f)
    order = np.argsort(f, kind="stable")
    assert (np.diff(k[order].astype(np.int64)) >= 0).all()
    assert ((k[:, None] == k[None, :]) == (f[:, None] == f[None, :])).all()
    # A -0 at column 3 and a +0 at column 1: the lowest column wins.
    values = np.full(_COLS, 1.0, np.float32)
    values[3], values[1] = -0.0, 0.0
    assert redux_argmin(values, np.ones(_COLS, bool))[1] == 1
    values[1] = np.float32(-1e-30)
    assert redux_argmin(values, np.ones(_COLS, bool))[1] == 1


# ---- B's generic instance (above 255 columns) --------------------------------


def cta_argmin(values, consider, threads, warps, lowest_column_wins=True):
    """(value, column) of the generic instance's argmin over columns 0..n-1:
    thread t keeps its lowest key over columns t, t + threads, ... (lowest
    column first), each warp a redux.sync pair, then one pass over the
    warps' results, ties to the lowest column (or, broken, to the highest)."""
    n = len(values)
    keys = np.where(consider, key(values), key(np.inf)).astype(np.uint64)
    slots = -(-n // threads)
    grid = np.full(slots * threads, key(np.inf), np.uint64)
    grid[:n] = keys
    grid = grid.reshape(slots, threads)
    col = np.arange(slots * threads).reshape(slots, threads)
    t_key = grid.min(0)
    t_col = np.where(grid == t_key, col, 2**40).min(0)  # ascending columns: the first minimum
    w_key = t_key.reshape(warps, 32).min(1)
    w_col = np.where(t_key.reshape(warps, 32) == w_key[:, None], t_col.reshape(warps, 32),
                     2**40).min(1)
    best, best_col = w_key[0], w_col[0]
    for k, c in zip(w_key[1:], w_col[1:]):
        if k < best or (k == best and (c < best_col if lowest_column_wins else c > best_col)):
            best, best_col = k, c
    b = np.uint32(best)
    value = (b & 0x7FFFFFFF if b & 0x80000000 else ~b).astype(np.uint32).view(np.float32)
    return np.float32(value), int(best_col)


def generic_lap_model(cost, mask, warps, lowest_column_wins=True):
    """The generic instance on one (R, C) problem in float32: the real rows
    ranked kThreads at a time, the auction's bids a warp a row (lanes
    strided over the columns), the augmenting paths with every warp's
    threads owning strided columns and the CTA argmin."""
    r, c = cost.shape
    threads = 32 * warps
    orig = []
    for base in range(0, r, threads):  # a ballot a warp, chunk by chunk
        chunk = np.zeros(threads, bool)
        chunk[:min(threads, r - base)] = mask[base:base + threads]
        orig += [base + t for t in np.flatnonzero(chunk)]
    orig = np.asarray(orig, int)
    n, staged = len(orig), cost[orig]
    cols = np.arange(c + 1)
    col_real = cols >= 1
    v = np.zeros(c + 1, np.float32)
    p = np.zeros(c + 1, int)
    owned = np.full(n, -1)
    u = np.zeros(n + 1, np.float32)
    for _ in range(5):
        bids = {}
        for k in range(n):
            if owned[k] >= 0:
                continue
            red = np.full(c + 1, np.inf, np.float32)
            red[1:] = staged[k] - v[1:]
            best, best_j = cta_argmin(red, col_real, 32, 1)  # one warp, lanes strided
            second, _ = cta_argmin(np.where(cols == best_j, _INF, red), col_real, 32, 1)
            bids[k] = (best_j, best, second if second < _INF / 2 else best)
        winner = {}
        for k, (j, *_) in bids.items():
            winner[j] = min(winner.get(j, k), k)
        for j, w in winner.items():
            v[j] = staged[w, j - 1] - bids[w][2]
            if p[j] > 0:
                owned[p[j] - 1] = -1
            owned[w], p[j] = j, w + 1
        for k, (j, min1, min2) in bids.items():
            u[k + 1] = min2 if winner[j] == k else min1
    for k in range(n):
        if owned[k] >= 0:
            continue
        minv = np.full(c + 1, _INF, np.float32)
        way = np.zeros(c + 1, int)
        used = np.zeros(c + 1, bool)
        p[0], j0, i0, alive = k + 1, 0, k + 1, True
        while True:
            used[j0] = True
            cand = col_real & ~used
            cur = np.full(c + 1, np.inf, np.float32)
            cur[1:] = staged[i0 - 1] - u[i0] - v[1:]
            better = cand & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            delta, j1 = cta_argmin(np.where(cand, minv, _INF), np.ones(c + 1, bool), threads,
                                   warps, lowest_column_wins)
            u[p[used]] += delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0, alive = j1, delta < _INF / 2
            if not alive or p[j0] == 0:
                break
            i0 = p[j0]
        while alive and j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    out = np.full(r, -1, np.int32)
    for j in np.flatnonzero(col_real & (p > 0)):
        out[orig[p[j] - 1]] = j - 1
    return out


def generic_cases():
    rng = np.random.default_rng(2)
    cases = []
    for name, r, c, share in (("300x300 scattered", 300, 300, 0.15),
                              ("100 slots x 300 queries", 100, 300, 0.3),
                              ("600x600, rows past one chunk", 600, 600, 0.08),
                              ("257x257 all real", 257, 257, 1.0)):
        cases.append((name, rng.normal(size=(r, c)).astype(np.float32), rng.random(r) < share))
    cases.append(("tied 300x300", rng.integers(0, 3, size=(300, 300)).astype(np.float32),
                  rng.random(300) < 0.5))
    return cases


@pytest.mark.parametrize("name,cost,mask", generic_cases(), ids=[c[0] for c in generic_cases()])
def test_generic_lap_model_equals_plain(name, cost, mask):
    """The generic instance's work split equals the plain version exactly,
    ties included; on the tied case, a CTA argmin that breaks ties to the
    highest column instead differs (the test sees the tie rule)."""
    ref = lap.reference_solve_lap_masked(torch.from_numpy(cost)[None],
                                         torch.from_numpy(mask)[None])[0].numpy()
    warps = constant("lap.cu", "kWarps")
    np.testing.assert_array_equal(generic_lap_model(cost, mask, warps), ref)
    if name.startswith("tied"):
        assert (generic_lap_model(cost, mask, warps, lowest_column_wins=False) != ref).any()
