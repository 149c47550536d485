"""Kernel F (``csrc/int8_matmul.cu``) on the CPU: a numpy emulation of the
kernel's addressing (its plan is held in ``tests/test_torch_int8_plan.py``).

The emulation follows one CTA of the kernel byte by byte: the swizzled
ring stage its ``cp.async`` copies write, the rows each lane hands
``ldmatrix.x4``, the fragments ``mma.sync.m16n8k32`` takes and returns
(the PTX ISA's layouts), each cluster rank's share of C and Cd, the
exchange of partial sums, the rows each rank finishes and the masked
edges. It must equal the plain version exactly, and must not when the
swizzle or the lane map is broken.
"""
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.ops import int8_matmul as mm
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# ---- the kernel's addressing, emulated ------------------------------------------------------

BM, BN = mm.TILE
KC, Q = mm.KC, mm.KC // 16  # bytes of a chunk row, and its 16-byte columns
WM, WN = 4, 2           # warps of a CTA
TM, TN = BM // WM, BN // WN
MT, NT = TM // 16, TN // 8
LANE = np.arange(32)


def ring_swizzle(row):
    """load_chunk: 16-byte column q of stage row r lies at q ^ swizzle(r),
    (r >> 1) & 3 for 64-byte rows, r & 7 for 128-byte ones."""
    return (row >> 1) & 3 if KC == 64 else row & 7


def lane_swizzle(lane):
    """The kernel's ``swz``: the swizzle of every row a lane addresses."""
    return ring_swizzle(lane % 8)


def a_lane_row(lane):
    """The kernel's ``a_row`` less the warp's and the fragment's rows."""
    return lane % 16


def _stage(a_rows, b_rows, swizzle):
    """One ring stage as load_chunk's copies leave it: x's BM rows then W's
    BN rows of KC bytes, as (row, 16-byte column, byte)."""
    logical = np.concatenate([a_rows, b_rows]).reshape(BM + BN, Q, 16)
    stage = np.zeros_like(logical)
    rows = np.arange(BM + BN)[:, None]
    stage[rows, np.arange(Q)[None, :] ^ swizzle(rows)] = logical
    return stage


def _ldmatrix_x4(stage, rows, cols):
    """``ldmatrix.sync.aligned.m8n8.x4.b16``: lanes 8j..8j+7 give the rows of
    matrix j (16 bytes at stage[row, col]); lane 4g + t receives bytes
    4t..4t+3 of row g of each. rows, cols (..., 32) -> (..., 32, 4, 4)."""
    lines = stage[rows, cols]
    src = 8 * np.arange(4)[None, :, None] + (LANE // 4)[:, None, None]
    byte = 4 * (LANE % 4)[:, None, None] + np.arange(4)[None, None, :]
    return lines[..., src, byte]


def _mma_m16n8k32(a, b):
    """``mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`` by the PTX ISA's
    fragment layouts: a (..., 32 lanes, 4 registers, 4 bytes), b (..., 32,
    2, 4); returns each lane's c0..c3, (..., 32, 4)."""
    g, t = LANE // 4, LANE % 4
    lead = np.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    A = np.zeros(lead + (16, 32), np.int64)
    B = np.zeros(lead + (32, 8), np.int64)
    for reg, (dr, dk) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
        A[..., g[:, None] + dr, dk + 4 * t[:, None] + np.arange(4)] = a[..., :, reg, :]
    for reg, dk in enumerate([0, 16]):
        B[..., dk + 4 * t[:, None] + np.arange(4), g[:, None]] = b[..., :, reg, :]
    D = A @ B
    return np.stack([D[..., g, 2 * t], D[..., g, 2 * t + 1], D[..., g + 8, 2 * t],
                     D[..., g + 8, 2 * t + 1]], axis=-1)


def _fragment_positions():
    """(row, column) in the CTA tile of accumulator (warp, mt, nt, lane, i):
    c0, c1 at (g, 2t), (g, 2t + 1), c2, c3 eight rows down."""
    warp, mt, nt, lane, i = np.meshgrid(np.arange(WM * WN), np.arange(MT), np.arange(NT),
                                        LANE, np.arange(4), indexing="ij")
    row = (warp // WN) * TM + 16 * mt + lane // 4 + 8 * (i // 2)
    col = (warp % WN) * TN + 8 * nt + 2 * (lane % 4) + i % 2
    return row, col


def _cta_partial_sums(chunks, rows, cols, swizzle, lane_swz, a_rows_of):
    """One rank's int32 sums over its chunks, as (warp, mt, nt, lane, 4): each
    chunk (a, b, byte offset, valid bytes) staged from the tile's rows of a
    and channels of b (zero past M and K; the part past its share neither
    loaded nor multiplied), then a k32 step of ldmatrix and mma per warp
    fragment for each 32 valid bytes."""
    warps = np.arange(WM * WN)
    a_row = ((warps // WN) * TM)[:, None, None] + 16 * np.arange(MT)[None, :, None] + a_rows_of(LANE)
    b_row = (BM + ((warps % WN) * TN)[:, None, None] + 16 * np.arange(NT // 2)[None, :, None]
             + 8 * (LANE // 16) + LANE % 8)
    a_hi, b_hi, swz = LANE // 16, (LANE // 8) % 2, lane_swz(LANE)
    acc = np.zeros((WM * WN, MT, NT, 32, 4), np.int64)
    for a, b, kb, valid in chunks:
        a_tile = np.zeros((BM, KC), np.int8)
        b_tile = np.zeros((BN, KC), np.int8)
        ok_r, ok_c = rows < a.shape[0], cols < b.shape[0]
        a_tile[ok_r, :valid] = a[rows[ok_r], kb:kb + valid]
        b_tile[ok_c, :valid] = b[cols[ok_c], kb:kb + valid]
        stage = _stage(a_tile, b_tile, swizzle)
        for step in range(valid // 32):
            af = _ldmatrix_x4(stage, a_row, (2 * step + a_hi) ^ swz)  # (warp, mt, lane, 4, 4)
            bf = _ldmatrix_x4(stage, b_row, (2 * step + b_hi) ^ swz)  # (warp, jp, lane, 4, 4)
            # matrices 0-1 are n8 fragment 2jp's b0, b1; 2-3 fragment 2jp + 1's.
            bf = bf.reshape(WM * WN, NT // 2, 32, 2, 2, 4).transpose(0, 1, 3, 2, 4, 5)
            bf = bf.reshape(WM * WN, NT, 32, 2, 4)
            acc += _mma_m16n8k32(af[:, :, None], bf[:, None])
    return acc


def emulate(variant, x, w, scale, bias, res=None, rs=None, xd=None, wd=None, sd=None, bd=None,
            *, relu=True, out_dtype=torch.int8, precise=True, cluster=None,
            swizzle=ring_swizzle, lane_swz=lane_swizzle, a_rows_of=a_lane_row):
    """Kernel F on numpy int8 operands, CTA by CTA. Returns the output over
    the whole grid of tiles as float64, NaN where nothing was stored."""
    m, c = x.shape
    k = w.shape[0]
    cd = 0 if xd is None else xd.shape[1]
    cluster = cluster or mm.plan(m, c, k, cd).cluster
    slice_ = BM // cluster
    frag_row, frag_col = _fragment_positions()
    owner = frag_row[:, :, 0, 0, 0] // slice_  # (warp, mt): the rank that finishes it
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32))  # noqa: E731
    out = np.full((-(-m // BM) * BM, -(-k // BN) * BN), np.nan)
    for row0 in range(0, m, BM):
        for col0 in range(0, k, BN):
            rows, cols = np.arange(row0, row0 + BM), np.arange(col0, col0 + BN)
            # Rank r sums its share of C into acc and of Cd into accd.
            partial = []
            for rank in range(cluster):
                sets = [_cta_partial_sums(
                    [(a, b, rank * ld // cluster + kb, min(KC, ld // cluster - kb))
                     for kb in range(0, ld // cluster, KC)],
                    rows, cols, swizzle, lane_swz, a_rows_of) if ld else 0
                    for a, b, ld in ((x, w, c), (xd, wd, cd))]
                partial.append(np.stack(np.broadcast_arrays(*sets)))
            for rank in range(cluster):
                # Peers leave the fragments they do not finish in their
                # exchange; whatever else it holds is stale.
                acc = partial[rank].copy()
                for p in range(cluster):
                    if p != rank:
                        acc += np.where((owner != p)[None, :, :, None, None, None], partial[p],
                                        1 << 40)
                mine = np.broadcast_to((owner == rank)[:, :, None, None, None], frag_row.shape)
                tiles = np.full((2, BM, BN), np.nan)
                tiles[:, frag_row[mine], frag_col[mine]] = acc[:, mine]
                # The epilogue operands: the rows this rank finishes, zero
                # past M and K.
                lo, hi = rank * slice_, (rank + 1) * slice_
                ok_c = cols < k
                coef = [np.where(ok_c, np.asarray(v)[np.minimum(cols, k - 1)], 0.0)
                        if v is not None else None for v in (scale, bias, sd, bd)]
                staged = np.zeros((BM, BN), np.int8)
                if res is not None:
                    ok = (rows[lo:hi] < m)[:, None] & ok_c[None, :]
                    staged[lo:hi][ok] = res[np.minimum(rows[lo:hi], m - 1)][:, np.minimum(cols, k - 1)][ok]
                kw = dict(relu=relu, out_dtype=out_dtype, precise=precise)
                if variant == "residual":
                    kw.update(res=torch.from_numpy(staged[lo:hi]), res_scale=f32(rs))
                if variant == "residual2":
                    kw.update(acc_d=torch.from_numpy(tiles[1, lo:hi]), scale_d=f32(coef[2]),
                              bias_d=f32(coef[3]))
                y = mm.epilogue(torch.from_numpy(tiles[0, lo:hi]), f32(coef[0]), f32(coef[1]),
                                **kw).double().numpy()
                # Copy-out: the finished rows below M, the channels below K.
                store = (rows[lo:hi] < m)[:, None] & ok_c[None, :]
                block = out[row0 + lo:row0 + hi, col0:col0 + BN]
                block[store] = y[store]
    return out


def _operands(m, c, k, cd, variant, seed):
    """chip_smoke.py's int8 operands: post-ReLU activations, int8 weights,
    scales that put the epilogue's input at ~40, biases ~N(0, 10)."""
    rng = np.random.default_rng(seed)
    act = lambda *s: rng.integers(0, 128, s).astype(np.int8)  # noqa: E731
    wts = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    scale = lambda kk, cc: ((rng.random(kk) + 0.5) * 40.0 / (5373.0 * cc**0.5)).astype(np.float32)  # noqa: E731
    bias = lambda kk: (rng.normal(size=kk) * 10.0).astype(np.float32)  # noqa: E731
    ops = [act(m, c), wts(k, c), scale(k, c), bias(k)]
    if variant == "residual":
        ops += [act(m, k), np.float32(0.3)]
    elif variant == "residual2":
        ops += [act(m, cd), wts(k, cd), scale(k, cd), bias(k)]
    return ops


def _reference(variant, ops, **kw):
    t = [torch.from_numpy(np.asarray(o)) for o in ops]
    fn = {"plain": mm.reference_qmatmul, "residual": mm.reference_qmatmul_residual,
          "residual2": mm.reference_qmatmul_residual2}[variant]
    return fn(*t, **kw).double().numpy()


def _emulate_ops(variant, ops, **kw):
    if variant == "residual":
        return emulate(variant, *ops[:4], res=ops[4], rs=ops[5], **kw)
    if variant == "residual2":
        return emulate(variant, *ops[:4], xd=ops[4], wd=ops[5], sd=ops[6], bd=ops[7], **kw)
    return emulate(variant, *ops, **kw)


# Ragged rows (M = 1, 20, 40, 105), channels past K (K = 8, 24, 40, 48, 72),
# the 8-byte int8 path (K % 16 != 0), and the plan's clusters of 2 and 4
# ranks over all three variants, and one of 8 forced.
@pytest.mark.parametrize("m,c,k,cd,variant,cluster,kw", [
    (105, 128, 48, 0, "plain", 1, {}),
    (1, 64, 8, 0, "residual", 1, {}),
    (105, 64, 72, 128, "residual2", 1, dict(out_dtype=torch.bfloat16)),
    (20, 1024, 48, 0, "plain", 2, dict(relu=False, precise=False)),
    (105, 2048, 64, 0, "residual", 4, {}),
    (40, 512, 24, 1024, "residual2", 4, dict(precise=False)),
    (40, 256, 64, 2048, "residual2", 4, {}),
    (105, 512, 40, 0, "residual", 8, dict(relu=False, out_dtype=torch.bfloat16)),
])
def test_emulated_kernel_equals_the_plain_version(m, c, k, cd, variant, cluster, kw):
    ops = _operands(m, c, k, cd, variant, seed=m + c + k)
    planned = mm.plan(m, c, k, cd).cluster
    assert planned == cluster or cluster == 8
    got = _emulate_ops(variant, ops, cluster=cluster, **kw)
    ref = _reference(variant, ops, **kw)
    assert np.isnan(got[m:]).all() and np.isnan(got[:, k:]).all()  # nothing stored past M, K
    np.testing.assert_array_equal(got[:m, :k], ref)


@pytest.mark.parametrize("broken", [
    dict(lane_swz=lambda lane: 0 * lane),                      # rows read unswizzled
    dict(swizzle=lambda row: row & 3),                         # written by another swizzle
    dict(a_rows_of=lambda lane: 2 * (lane % 8) + (lane // 8) % 2),  # A rows interleaved
])
def test_emulation_sees_a_broken_swizzle_or_lane_map(broken):
    ops = _operands(105, 128, 48, 0, "plain", seed=3)
    got = _emulate_ops("plain", ops, **broken)
    assert not np.array_equal(got[:105, :48], _reference("plain", ops))


def test_ring_accesses_are_free_of_bank_conflicts():
    """Each 8-lane phase of the kernel's ldmatrix reads (A's and B's rows at
    their swizzled columns) and of load_chunk's cp.async copies touches 8
    distinct 16-byte bank groups of a 128-byte line."""
    for base in range(0, BM + BN, 16):
        for step in range(KC // 32):
            for rows, hi in ((base + a_lane_row(LANE), LANE // 16),
                             (base + 8 * (LANE // 16) + LANE % 8, (LANE // 8) % 2)):
                groups = (Q * rows + ((2 * step + hi) ^ lane_swizzle(LANE))) % 8
                for j in range(4):
                    assert len(set(groups[8 * j:8 * j + 8])) == 8, (base, step, j)
    idx = np.arange(256)  # thread i copies row i // Q, 16-byte column i % Q
    rows, q = idx // Q, idx % Q
    groups = (Q * rows + (q ^ ring_swizzle(rows))) % 8
    for phase in range(0, 256, 8):
        assert len(set(groups[phase:phase + 8])) == 8
