"""Kernel G (``csrc/int8_conv.cu``) on the CPU: the plan the wrapper picks
from the shape, and a numpy emulation of the kernel's addressing.

The emulation follows one CTA of the kernel byte by byte: the halo'd input
window its TMA copies stage for each 64-byte chunk (zero-filled past the
image's edges; at stride 2 the even columns and the odd ones as two
blocks; TMA's 64-byte swizzle), the W slices of one kernel row, the window
row each lane hands ``ldmatrix.x4`` for each of the nine taps, the
``mma.sync.m16n8k32`` fragments (the models of
``tests/test_torch_int8_emulation.py``), the cluster ranks' shares of C and
their exchange, and the pixels and channels stored at ragged patches. It
must equal the plain version exactly, and must not when the swizzle or a
tap's offset is broken. It also counts the bank conflicts of every
``ldmatrix`` phase at both strides.
"""
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.ops import int8_conv as conv
from test_torch_int8_emulation import LANE, _ldmatrix_x4, _mma_m16n8k32
from test_torch_int8_plan import SMS
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# (H, W, C, stride, launches) of kernel G in one b1 896x1408 int8 DETR-R50
# forward (K = C): every 3x3 of the four layers.
G_PATH_SHAPES = [
    (224, 352, 64, 1, 3), (224, 352, 128, 2, 1), (112, 176, 128, 1, 3), (112, 176, 256, 2, 1),
    (56, 88, 256, 1, 5), (56, 88, 512, 2, 1), (28, 44, 512, 1, 2),
]


def test_path_shapes_are_one_forward():
    counts = {}
    for *_, stride, n in G_PATH_SHAPES:
        counts[stride] = counts.get(stride, 0) + n
    assert counts == {1: 13, 2: 3}


@pytest.mark.parametrize("h,w,c,stride,launches", G_PATH_SHAPES)
def test_plan_fills_the_card_at_every_path_shape(h, w, c, stride, launches):
    """At least one wave of CTAs; the stride's compiled patch; a split only
    where the tiles alone are fewer than FILL, each rank's share of C whole
    64-byte chunks; and shared memory that fits the CTAs an SM the tile is
    built for (``Cfg``'s last argument: 3 at stride 1, 2 at stride 2), with
    either output dtype."""
    p = conv.plan(1, h, w, c, c, stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    tiles = -(-ho // p.patch_h) * -(-wo // p.patch_w) * -(-c // p.channels)
    assert (p.patch_h, p.patch_w) == conv.TILES[stride] and p.channels == conv.CHANNELS
    assert p.ctas == tiles * p.cluster >= SMS and c % (64 * p.cluster) == 0
    if tiles >= conv.FILL[stride]:
        assert p.cluster == 1
    else:
        assert p.cluster > 1 and (p.ctas >= conv.WAVE or c // 64 == p.cluster)
    for out_dtype in (torch.int8, torch.bfloat16):
        smem = conv.smem_bytes(stride, conv.TILES[stride], out_dtype)
        assert {1: 3, 2: 2}[stride] * (smem + 1024) <= 233472


def test_plan_splits_only_where_the_tiles_are_few():
    clusters = {(h, w, c, s): conv.plan(1, h, w, c, c, s).cluster for h, w, c, s, _ in G_PATH_SHAPES}
    assert {key: n for key, n in clusters.items() if n > 1} == {
        (56, 88, 256, 1): 2, (56, 88, 512, 2): 2, (28, 44, 512, 1): 2}
    assert conv.plan(1, 7, 12, 512, 64, 1).cluster == 8
    # 9 chunks split into whole chunks by no cluster: one CTA sums them all.
    assert conv.plan(1, 8, 8, 576, 64, 1).cluster == 1


@pytest.mark.parametrize("c,k,stride", [(32, 64, 1), (96, 64, 2), (64, 12, 1), (0, 64, 1),
                                        (64, 64, 3)])
def test_plan_refuses_what_the_kernel_cannot_take(c, k, stride):
    with pytest.raises(ValueError, match="multiple of 64|stride"):
        conv.plan(1, 8, 8, c, k, stride)


# ---- the kernel's addressing, emulated ------------------------------------------------------

BN, KC, Q = conv.CHANNELS, conv.KC, conv.KC // 16
WM, WN = 4, 2  # warps of a CTA
TN, NT = BN // WN, BN // WN // 8


class Tile:
    """One compiled tile of the kernel (``Cfg``): stride, patch, window."""

    def __init__(self, stride, ph, pw):
        self.s, self.ph, self.pw = stride, ph, pw
        self.bm = ph * pw
        self.tm = self.bm // WM
        self.mt = self.tm // 16
        self.wh, self.ww = (ph - 1) * stride + 3, (pw - 1) * stride + 3
        # A block of p stored columns a window row: one block at stride 1,
        # at stride 2 the even columns, then the odd ones (and one past the
        # window); each block rounded up to whole kilobytes.
        self.p = pw + 2 if stride == 1 else pw + 1
        self.block_rows = self.wh * self.p
        self.block_pitch = -(-self.block_rows * KC // 1024) * 1024 // KC

    def stored_row(self, wy, wx):
        """Where window pixel (wy, wx) lies in a window stage."""
        wx = np.asarray(wx)
        if self.s == 1:
            return wy * self.p + wx
        return (wx & 1) * self.block_pitch + wy * self.p + (wx >> 1)

    def tap_offset(self, dy, dx):
        return dy * self.p + (dx if self.s == 1 else self.block_pitch if dx == 1 else dx // 2)

    def a_rows(self):
        """``a_sr``: the stored window row of each (warp, fragment, lane) at tap (0, 0)."""
        r = _tile_rows(self)
        return (r // self.pw) * self.s * self.p + r % self.pw


def _tile_rows(t):
    """The CTA-tile row of each (warp, fragment, lane) an A ldmatrix reads."""
    return ((np.arange(WM * WN) // WN) * t.tm)[:, None, None] + \
        16 * np.arange(t.mt)[None, :, None] + (LANE % 16)[None, None, :]


def swizzle(row):
    """TMA's 64-byte swizzle: column q of a stored 64-byte row r lies at q ^ swizzle(r)."""
    return (np.asarray(row) >> 1) & 3


def _swizzled(logical, swz):
    rows = np.arange(logical.shape[0])
    stage = np.zeros_like(logical)
    stage[rows[:, None], np.arange(Q)[None, :] ^ swz(rows)[:, None]] = logical
    return stage


def stage_window(t, x, img, iy0, ix0, kb, swz=swizzle):
    """One window stage as the kernel's TMA copies leave it: the box from
    window pixel (0, 0) (stride 2: the even columns from column 0, the odd
    ones from column 1, every other column), 64 bytes a pixel, zero outside
    the image, swizzled."""
    n, h, w, _ = x.shape
    logical = np.zeros((t.s * t.block_pitch, Q, 16), np.int8)
    for b in range(t.s):
        rem = np.arange(t.block_rows)
        wy, wx = rem // t.p, t.s * (rem % t.p) + b
        iy, ix = iy0 + wy, ix0 + wx
        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        rows = b * t.block_pitch + rem
        logical[rows[ok]] = x[img, iy[ok], ix[ok], kb:kb + KC].reshape(-1, Q, 16)
    return _swizzled(logical, swz)


def stage_slice(wt, col0, dy, kb):
    """One W slice as the kernel's TMA copy leaves it: row 3 j + dx holds
    output channel col0 + j's tap (dy, dx), zero past K, swizzled."""
    k = wt.shape[0]
    row = np.arange(3 * BN)
    col, dx = col0 + row // 3, row % 3
    ok = col < k
    logical = np.zeros((row.size, Q, 16), np.int8)
    logical[ok] = wt[col[ok], dy, dx[ok], kb:kb + KC].reshape(-1, Q, 16)
    return _swizzled(logical, swizzle)


def _b_channels():
    """The slice channel j of each (warp, fragment pair, lane) a B ldmatrix reads."""
    warps = np.arange(WM * WN)
    return ((warps % WN) * TN)[:, None, None] + 16 * np.arange(NT // 2)[None, :, None] + \
        8 * (LANE // 16) + LANE % 8


def _rank_sums(t, x, wt, img, oy0, ox0, col0, kbs, *, swz, read_swz, tap):
    """One rank's int32 sums over its chunks, as (warp, mt, nt, lane, 4)."""
    a_sr, a_hi = t.a_rows(), LANE // 16
    b_ch = _b_channels()
    b_hi = (LANE // 8) % 2
    acc = np.zeros((WM * WN, t.mt, NT, 32, 4), np.int64)
    for kb in kbs:
        xs = stage_window(t, x, img, oy0 * t.s - 1, ox0 * t.s - 1, kb, swz)
        for dy in range(3):
            ws = stage_slice(wt, col0, dy, kb)
            for dx in range(3):
                for step in range(KC // 32):
                    sr = a_sr + tap(t, dy, dx)
                    af = _ldmatrix_x4(xs, sr, (2 * step + a_hi) ^ read_swz(sr))
                    b_row = 3 * b_ch + dx
                    bf = _ldmatrix_x4(ws, b_row, (2 * step + b_hi) ^ swizzle(b_row))
                    # matrices 0-1 are n8 fragment 2jp's b0, b1; 2-3 fragment 2jp + 1's.
                    bf = bf.reshape(WM * WN, NT // 2, 32, 2, 2, 4).transpose(0, 1, 3, 2, 4, 5)
                    bf = bf.reshape(WM * WN, NT, 32, 2, 4)
                    acc += _mma_m16n8k32(af[:, :, None], bf[:, None])
    return acc


def emulate(x, wt, scale, bias, *, stride, relu=False, out_dtype=torch.int8, precise=True,
            plan=None, swz=swizzle, read_swz=swizzle, tap=Tile.tap_offset):
    """Kernel G on numpy int8 operands (x NHWC, wt (K, 3, 3, C)), CTA by CTA,
    at the plan's tile and cluster. Returns (N, Ho, Wo, K) as float64 over
    the whole grid of patches and channel tiles, NaN where nothing was
    stored."""
    n, h, w, c = x.shape
    k = wt.shape[0]
    p = plan or conv.plan(n, h, w, c, k, stride)
    t = Tile(stride, p.patch_h, p.patch_w)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    prows, pcols, ctiles = -(-ho // t.ph), -(-wo // t.pw), -(-k // BN)
    split = p.cluster
    slice_ = t.bm // split
    warp, mt, nt, lane, i = np.meshgrid(np.arange(WM * WN), np.arange(t.mt), np.arange(NT), LANE,
                                        np.arange(4), indexing="ij")
    frag_row = (warp // WN) * t.tm + 16 * mt + lane // 4 + 8 * (i // 2)
    frag_col = (warp % WN) * TN + 8 * nt + 2 * (lane % 4) + i % 2
    owner = frag_row[:, :, 0, 0, 0] // slice_
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32))  # noqa: E731
    out = np.full((n, prows * t.ph, pcols * t.pw, ctiles * BN), np.nan)
    nc = c // KC // split
    for img in range(n):
        for oy0 in range(0, ho, t.ph):
            for ox0 in range(0, wo, t.pw):
                for col0 in range(0, k, BN):
                    partial = [_rank_sums(t, x, wt, img, oy0, ox0, col0,
                                          [KC * (r * nc + j) for j in range(nc)], swz=swz,
                                          read_swz=read_swz, tap=tap) for r in range(split)]
                    cols = np.arange(col0, col0 + BN)
                    ok_c = cols < k
                    coef = [np.where(ok_c, np.asarray(v)[np.minimum(cols, k - 1)], 0.0)
                            for v in (scale, bias)]
                    for rank in range(split):
                        # Peers leave the fragments they do not finish in
                        # their exchange; whatever else it holds is stale.
                        acc = partial[rank].copy()
                        for q in range(split):
                            if q != rank:
                                acc += np.where((owner != q)[:, :, None, None, None], partial[q],
                                                1 << 40)
                        mine = np.broadcast_to((owner == rank)[:, :, None, None, None],
                                               frag_row.shape)
                        tile = np.full((t.bm, BN), np.nan)
                        tile[frag_row[mine], frag_col[mine]] = acc[mine]
                        lo, hi = rank * slice_, (rank + 1) * slice_
                        y = conv.epilogue(torch.from_numpy(tile[lo:hi]), f32(coef[0]),
                                          f32(coef[1]), relu=relu, out_dtype=out_dtype,
                                          precise=precise).double().numpy()
                        # Copy-out: the rows below Ho and Wo, the channels below K.
                        r = np.arange(lo, hi)
                        oy, ox = oy0 + r // t.pw, ox0 + r % t.pw
                        store = ((oy < ho) & (ox < wo))[:, None] & ok_c[None, :]
                        block = out[img, oy[:, None], ox[:, None], cols[None, :]]
                        block[store] = y[store]
                        out[img, oy[:, None], ox[:, None], cols[None, :]] = block
    return out


def _operands(n, h, w, c, k, seed):
    """chip_smoke.py's int8 operands: post-ReLU activations, int8 weights,
    scales that put the epilogue's input at ~40, biases ~N(0, 10)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 128, (n, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, 3, 3, c)).astype(np.int8)
    scale = ((rng.random(k) + 0.5) * 40.0 / (5373.0 * (9 * c) ** 0.5)).astype(np.float32)
    bias = (rng.normal(size=k) * 10.0).astype(np.float32)
    return x, wt, scale, bias


def _reference(ops, stride, **kw):
    t = [torch.from_numpy(np.asarray(o)) for o in ops]
    return conv.reference_conv3x3_int8(*t, stride=stride, **kw).double().numpy()


def _forced(n, h, w, c, k, stride, cluster):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    patch = conv.TILES[stride]
    return conv.Plan(*patch, BN, cluster, conv._tiles(n, ho, wo, k, patch) * cluster)


# Both compiled tiles; odd H and W at both strides (Ho = (H - 1) / 2 + 1),
# patches past the map's right and bottom edges, batch 2, channels past K
# (K = 48, 8: an 8-byte int8 copy-out), clusters of 1, 2, 4 and 8, both
# epilogues and both output dtypes.
@pytest.mark.parametrize("n,h,w,c,k,stride,cluster,kw", [
    (2, 13, 21, 64, 48, 2, 1, {}),
    (1, 11, 19, 128, 64, 1, 2, dict(precise=False)),
    (2, 9, 17, 64, 8, 1, 1, dict(out_dtype=torch.bfloat16)),
    (1, 17, 35, 256, 72, 2, 4, dict(relu=True)),
    (1, 7, 12, 512, 64, 1, 8, dict(relu=True, precise=False)),
    (1, 15, 33, 128, 16, 2, 2, dict(out_dtype=torch.bfloat16, precise=False)),
])
def test_emulated_kernel_equals_the_plain_version(n, h, w, c, k, stride, cluster, kw):
    ops = _operands(n, h, w, c, k, seed=h + w + c)
    got = emulate(*ops, stride=stride, plan=_forced(n, h, w, c, k, stride, cluster), **kw)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    # Nothing stored past the output map or past K.
    assert np.isnan(got[:, ho:]).all() and np.isnan(got[:, :, wo:]).all()
    assert np.isnan(got[..., k:]).all()
    np.testing.assert_array_equal(got[:, :ho, :wo, :k], _reference(ops, stride, **kw))


def test_emulation_takes_the_plan_of_a_small_shape():
    """Unforced, a small shape's few tiles split the contraction."""
    ops = _operands(1, 9, 13, 128, 24, seed=5)
    assert conv.plan(1, 9, 13, 128, 24, 2).cluster == 2
    got = emulate(*ops, stride=2)
    np.testing.assert_array_equal(got[:, :5, :7, :24], _reference(ops, 2))


@pytest.mark.parametrize("stride,broken", [
    (1, dict(read_swz=lambda r: 0 * np.asarray(r))),                    # read unswizzled
    (2, dict(swz=lambda r: np.asarray(r) & 3)),                         # written by another swizzle
    (2, dict(tap=lambda t, dy, dx: dy * t.p + dx)),                     # the stride-1 offsets
    (1, dict(tap=lambda t, dy, dx: dy * t.pw + dx)),                    # the patch's row pitch
    (2, dict(tap=lambda t, dy, dx: Tile.tap_offset(t, dy, 2 - dx))),    # taps mirrored
])
def test_emulation_sees_a_broken_swizzle_or_tap_offset(stride, broken):
    n, h, w, c, k = 1, 13, 21, 64, 16
    ops = _operands(n, h, w, c, k, seed=3)
    got = emulate(*ops, stride=stride, plan=_forced(n, h, w, c, k, stride, 1), **broken)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert not np.array_equal(got[:, :ho, :wo, :k], _reference(ops, stride))


def _ways(groups):
    """The most lanes of one 8-lane phase on one 16-byte bank group (1: no
    conflict), per phase."""
    g = np.asarray(groups).reshape(-1, 8)
    return np.array([np.bincount(row, minlength=8).max() for row in g])


def _a_phase_ways(t, stored_row):
    """Bank-group multiplicity of every ldmatrix phase reading A, at every
    tap and 16-byte column, with window pixel (wy, wx) stored at row
    ``stored_row(wy, wx)``."""
    py, px = np.divmod(_tile_rows(t), t.pw)
    ways = []
    for dy in range(3):
        for dx in range(3):
            sr = stored_row(py * t.s + dy, px * t.s + dx)
            for q in range(Q):
                ways.append(_ways((Q * sr + (q ^ swizzle(sr))) % 8))
    return np.concatenate(ways)


@pytest.mark.parametrize("stride", [1, 2])
def test_ldmatrix_phases_are_free_of_bank_conflicts(stride):
    """Each 8-lane phase of the kernel's ldmatrix reads, A at every tap from
    the window and B from the slice, touches 8 distinct 16-byte bank groups
    of a 128-byte line."""
    t = Tile(stride, *conv.TILES[stride])
    assert (_a_phase_ways(t, t.stored_row) == 1).all()
    # The stored row each A lane reads, the kernel's a_sr plus the tap's
    # offset, is its output pixel's input pixel at that tap.
    py, px = np.divmod(_tile_rows(t), t.pw)
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(t.a_rows() + t.tap_offset(dy, dx),
                                          t.stored_row(py * t.s + dy, px * t.s + dx))
    for dx in range(3):
        b_row = 3 * _b_channels() + dx
        for hi in range(2):
            cols = (2 * hi + (LANE // 8) % 2) ^ swizzle(b_row)
            assert (_ways((Q * b_row + cols) % 8) == 1).all()


def test_stride_two_would_conflict_without_the_column_split():
    """At stride 2 a phase reads every other window pixel: stored in window
    order, they fall in 4 bank groups twice (two-way conflicts), which is
    what staging the even columns apart from the odd ones removes."""
    t = Tile(2, *conv.TILES[2])
    assert _a_phase_ways(t, lambda wy, wx: wy * t.ww + wx).max() == 2
    assert _a_phase_ways(t, t.stored_row).max() == 1
