"""The port's fused-backbone slice against the JAX package: the stem max
pool (kernel C), the fused bottleneck tail (D) and the whole fused
bottleneck (E), each through its plain version here on the CPU, numpy
emulations of D's and E's tensor-core kernels (D-mma's and E-mma's tilings
at bf16, D-tf32's and E-tf32's tilings and 3xTF32 arithmetic at fp32) and
their plans, then the fused ResNet backbone and DETR, their routing, and
that they refuse to train.

JAX runs on the CPU, its Pallas kernels in interpret mode. Inputs come from
``np.random.default_rng``; variables from ``random_variables``, whose
FrozenBN buffers are random (scale near 1, shifts ~0.1), so a kernel that
let relu(b1) leak into E's halo would show. The port's tensors are NCHW in
channels_last memory, as its backbone holds them. Tolerances are stated
at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detr_tensorflow_tpu.models import detr as jax_detr
from detr_tensorflow_tpu.models import resnet as jax_resnet
from detr_tensorflow_tpu.ops import maxpool as jax_maxpool
from detr_tensorflow_tpu.ops.pallas import fused_bottleneck as jax_fb
from detr_tensorflow_tpu.ops.pallas import fused_residual as jax_fr
from detr_tensorflow_tpu.ops.pallas.maxpool import max_pool_3x3_s2_pallas
from detr_tensorflow_tpu_torch.models import api, detr, resnet
from detr_tensorflow_tpu_torch.models.weights import from_jax_variables
from detr_tensorflow_tpu_torch.ops import fused_bottleneck as fb
from detr_tensorflow_tpu_torch.ops import fused_residual as fr
from detr_tensorflow_tpu_torch.ops import maxpool
from detr_tensorflow_tpu_torch.predictor import Predictor
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
from test_torch_models import BOX_ATOL, GOLDEN_RTOL, LOGIT_ATOL, _pixel_mask, close, random_variables

# The JAX test's reduced DETR (tests/test_pallas_attention.py): layer1 has
# one identity block, the other stages none.
TINY = dict(num_classes=5, num_queries=6, model_dim=16, num_heads=2, num_encoder_layers=1,
            num_decoder_layers=1, dim_feedforward=32, backbone_stage_sizes=(2, 1, 1, 1))
FUSED = dict(fuse_residual=True, fuse_bottleneck=True)


def nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC numpy array as the port holds it: NCHW in channels_last."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def _d_counts():
    """Kernel D's launch counters: the SIMT D, D-mma, D-tf32."""
    d = fr.conv1x1_bn_residual_relu
    return d.launches, d.mma_launches, d.tf32_launches


# ---- kernel C: the stem max pool -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_matches_pallas_kernel_even_shape(dtype):
    """max_pool_3x3_s2(nonneg=True) against the TPU kernel in interpret
    mode at an even stem-like shape, on a tie-heavy non-negative input:
    exactly equal (a max picks one of its inputs)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, size=(2, 16, 24, 8)).astype(np.float32) * 0.25
    ref = max_pool_3x3_s2_pallas(jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                                             else jnp.float32))
    ours = maxpool.max_pool_3x3_s2(nchw(x).to(dtype), nonneg=True)
    assert ours.dtype == dtype and ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(ours), np.asarray(ref, np.float32))


@pytest.mark.parametrize("h,w", [(9, 11), (7, 8), (1, 1)])
def test_maxpool_matches_jax_at_odd_shapes(h, w):
    """At odd H or W (where the TPU kernel does not run) against the JAX
    max_pool_3x3_s2: exactly equal, fp32."""
    x = np.random.default_rng(h * w).uniform(0, 2, size=(2, h, w, 3)).astype(np.float32)
    ref = jax_maxpool.max_pool_3x3_s2(jnp.asarray(x), nonneg=True)
    ours = maxpool.max_pool_3x3_s2(nchw(x), nonneg=True)
    assert ours.shape == (2, 3, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    np.testing.assert_array_equal(nhwc(ours), np.asarray(ref))


# ---- kernel D: the fused bottleneck tail ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_residual_matches_jax(dtype):
    """The plain version (and the wrapper, which takes it on the CPU)
    against matmul_bn_residual_relu in interpret mode, N = 2 * 7 * 9 = 126
    pixels (not a multiple of its row tile). fp32, rtol 1e-5 and atol 1e-5:
    the same products summed in another order. bf16 (operands bf16, scale
    and shift float32, both sides summing in float32): within two bf16 ulps
    of the largest output (2^-7), since a sum or an epilogue rounded another
    way moves its output across a bf16 rounding boundary."""
    rng = np.random.default_rng(1)
    b, h, w, cin, cout = 2, 7, 9, 24, 40
    x = rng.uniform(0, 1, size=(b, h, w, cin)).astype(np.float32)
    kernel = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    shift = rng.normal(0, 0.3, size=cout).astype(np.float32)
    identity = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jax_fr.matmul_bn_residual_relu(
        jnp.asarray(x.reshape(-1, cin), jdt), jnp.asarray(kernel, jdt), jnp.asarray(scale),
        jnp.asarray(shift), jnp.asarray(identity.reshape(-1, cout), jdt)), np.float32)
    args = (nchw(x).to(dtype), torch.from_numpy(kernel.T.copy()).to(dtype),
            torch.from_numpy(scale), torch.from_numpy(shift), nchw(identity).to(dtype))
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=0, atol=2**-7 * np.abs(ref).max()))
    before = _d_counts()
    for fn in (fr.reference_conv1x1_bn_residual_relu, fr.conv1x1_bn_residual_relu):
        ours = fn(*args)
        assert ours.shape == (b, cout, h, w) and ours.dtype == dtype
        assert ours.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(nhwc(ours).reshape(-1, cout), ref, **tol)
    # the CPU takes the plain version
    assert _d_counts() == before


def test_fused_ops_check_their_operands():
    x = torch.zeros(1, 16, 4, 4)
    w, s = torch.zeros(32, 16), torch.ones(32)
    with pytest.raises(TypeError):
        fr.conv1x1_bn_residual_relu(x.double(), w.double(), s, s, torch.zeros(1, 32, 4, 4).double())
    with pytest.raises(ValueError, match="identity"):
        fr.conv1x1_bn_residual_relu(x, w, s, s, torch.zeros(1, 16, 4, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        fr.conv1x1_bn_residual_relu(x, w.requires_grad_(), s, s, torch.zeros(1, 32, 4, 4))
    ops = (torch.zeros(16, 8), torch.zeros(8), torch.zeros(9, 8, 8), torch.zeros(8),
           torch.zeros(8, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="w3t"):
        fb.fused_bottleneck(x, *ops[:4], torch.zeros(8, 8), ops[5])
    with pytest.raises(RuntimeError, match="no backward"):
        fb.fused_bottleneck(x.requires_grad_(), *ops)


# ---- kernel D's bf16 path, D-mma: its shape check and its tiling emulated -------------------

# Kernel D's (P, Cin, Cout) on the path: the 896x1408 bucket's 4 maps
# (masked, D on all 16 blocks), then the 768x1280 bucket's 4 (D on the
# block_0s).
D_SHAPES = [(224 * 352, 64, 256), (112 * 176, 128, 512), (56 * 88, 256, 1024), (28 * 44, 512, 2048),
            (192 * 320, 64, 256), (96 * 160, 128, 512), (48 * 80, 256, 1024), (24 * 40, 512, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_residual_routes_by_dtype_and_cpu_takes_plain(dtype):
    """bf16 routes to D-mma and fp32 to D-tf32 on the card; a CPU call
    takes the plain version at either dtype and launches nothing; D-mma
    refuses fp32 and D-tf32 bf16 before either looks at the device, and
    every launcher refuses a CPU tensor of its dtype."""
    assert fr.route(dtype) == ("mma" if dtype == torch.bfloat16 else "tf32")
    rng = np.random.default_rng(2)
    ops = (nchw(rng.uniform(0, 1, size=(1, 5, 7, 16)).astype(np.float32)).to(dtype),
           torch.from_numpy(rng.normal(size=(24, 16)).astype(np.float32)).to(dtype),
           torch.ones(24), torch.zeros(24),
           nchw(rng.normal(size=(1, 5, 7, 24)).astype(np.float32)).to(dtype))
    before = _d_counts()
    assert torch.equal(fr.conv1x1_bn_residual_relu(*ops),
                       fr.reference_conv1x1_bn_residual_relu(*ops))
    if dtype == torch.float32:
        with pytest.raises(TypeError, match="takes bfloat16"):
            fr.launch_mma(*ops)
    else:
        with pytest.raises(TypeError, match="takes float32"):
            fr.launch_tf32(*ops)
    for launch in (fr.launch_simt, fr.launch_tf32 if dtype == torch.float32 else fr.launch_mma):
        with pytest.raises(ValueError, match="no fused residual kernel for device cpu"):
            launch(*ops)
    assert _d_counts() == before


@pytest.mark.parametrize("p,cin,cout", D_SHAPES)
def test_mma_shape_check_takes_the_path_shapes(p, cin, cout):
    """D-mma takes each D shape of the path, and its grid of 128 x 128
    tiles stays within a launch's 2^31 CTAs; it refuses Cin or Cout not a
    multiple of 8."""
    fr.check_mma_shape(cin, cout)
    assert -(-p // 128) * -(-cout // 128) < 2**31
    for bad in ((cin + 4, cout), (cin, cout - 4), (20, cout)):
        with pytest.raises(ValueError, match="multiples of 8"):
            fr.check_mma_shape(*bad)


def _d_mma_emulation(x, w, scale, shift, identity, tile=128, kc=32, bn=128):
    """csrc/fused_residual_mma.cu's algorithm in numpy float64, on (P, Cin)
    x, (Cout, Cin) w and (P, Cout) identity with bf16 values and float32
    scale and shift: per tile of ``tile`` pixels x ``bn`` channels, x's rows
    past P and w's rows past Cout zero-filled, Cin in chunks of ``kc`` in
    order (columns past Cin zero on both operands), the identity tile zero
    past P and Cout, then ((acc * scale) + shift) + identity, ReLU and one
    rounding to bf16. Returns the (P, Cout) output inside a buffer padded to
    whole tiles, NaN where the kernel stores nothing."""
    p, cin = x.shape
    cout = w.shape[0]
    pp, cp, kp = -(-p // tile) * tile, -(-cout // bn) * bn, -(-cin // kc) * kc
    xs, ws, ids = np.zeros((pp, kp)), np.zeros((cp, kp)), np.zeros((pp, cp))
    xs[:p, :cin], ws[:cout, :cin], ids[:p, :cout] = x, w, identity
    sc, sh = np.zeros(cp), np.zeros(cp)
    sc[:cout], sh[:cout] = scale, shift
    y = np.full((pp, cp), np.nan)
    for p0 in range(0, pp, tile):
        for c0 in range(0, cp, bn):
            rows, cols = slice(p0, p0 + tile), slice(c0, c0 + bn)
            acc = np.zeros((tile, bn))
            for k0 in range(0, kp, kc):
                acc += xs[rows, k0:k0 + kc] @ ws[cols, k0:k0 + kc].T
            out = _bf16(np.maximum((acc * sc[cols] + sh[cols]) + ids[rows, cols], 0))
            stored = (np.arange(p0, p0 + tile) < p)[:, None] & (np.arange(c0, c0 + bn) < cout)
            y[rows, cols] = np.where(stored, out, np.nan)
    return y


def _d_case(p, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.uniform(0, 1, size=(p, cin)))
    w = _bf16(rng.normal(size=(cout, cin)) * cin**-0.5)
    scale = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    shift = (rng.normal(size=cout) * 0.3).astype(np.float32)
    identity = _bf16(rng.normal(size=(p, cout)))
    return x, w, scale, shift, identity


# (P, Cin, Cout): the card case (2, 48->40, 7x9), ragged P over several
# pixel tiles with Cin not a whole number of chunks and Cout not of channel
# tiles, a 64->256 map smaller than one tile, one pixel past a whole tile
# at the smallest Cin and Cout, P a whole number of tiles, and P and Cout
# ragged over several tiles each.
D_EMULATION_CASES = [(2 * 7 * 9, 48, 40), (13 * 21, 200, 136), (5 * 7, 64, 256), (129, 8, 8),
                     (256, 32, 128), (3 * 7 * 19, 72, 264)]


@pytest.mark.parametrize("p,cin,cout", D_EMULATION_CASES)
def test_d_mma_emulation_matches_jax_and_float64(p, cin, cout):
    """D-mma's tiling, emulated, stores every output and nothing past P or
    Cout, and agrees with a float64 chain with the same bf16 rounding point
    within 1e-6 of the largest output (summation order only), and with the
    JAX package's matmul_bn_residual_relu (Pallas, interpret mode, bf16
    operands, float32 sums) within two bf16 ulps of the largest output
    (2^-7): an output whose float32 and float64 values round to different
    bf16 values moves by one ulp."""
    x, w, scale, shift, identity = ops = _d_case(p, cin, cout, seed=p + cin)
    padded = _d_mma_emulation(*ops)
    ours = padded[:p, :cout]
    assert np.isfinite(ours).all()
    assert np.isnan(padded[p:]).all() and np.isnan(padded[:, cout:]).all()
    exact = _bf16(np.maximum((x @ w.T) * scale + shift + identity, 0))
    top = np.abs(exact).max()
    np.testing.assert_allclose(ours, exact, atol=1e-6 * top, rtol=0)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = jax_fr.matmul_bn_residual_relu(bf(x), bf(w.T), jnp.asarray(scale), jnp.asarray(shift),
                                         bf(identity))
    np.testing.assert_allclose(ours, np.asarray(ref, np.float64), atol=2**-7 * top, rtol=0)


# ---- kernel E: the whole identity bottleneck ------------------------------------------------


def _bottleneck_operands(rng, c, m, b1=None, scale=0.2):
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    w1, w2, w3 = mk(1, 1, c, m), mk(3, 3, m, m), mk(1, 1, m, c)
    b1 = mk(m) if b1 is None else b1
    return w1, b1, w2, mk(m), w3, mk(c)


def _port_operands(w1, b1, w2, b2, w3, b3):
    """JAX HWIO kernels flattened are the port's kernel layouts."""
    m, c = w1.shape[-1], w3.shape[-1]
    to = torch.from_numpy
    return (to(w1.reshape(-1, m)), to(b1), to(w2.reshape(9, m, m).copy()), to(b2),
            to(w3.reshape(m, c)), to(b3))


def _unmasked_t1_bottleneck(x, w1t, b1, w2t, b2, w3t, b3):
    """The halo bug E must avoid: conv1 over the zero-padded image, T1 left
    unmasked (relu(b1) on the border), then an unpadded conv2."""
    m = w1t.shape[1]
    xp = F.pad(x, (1, 1, 1, 1))
    t1 = F.relu(F.conv2d(xp, w1t.t()[:, :, None, None]) + b1[:, None, None])
    t2 = F.relu(F.conv2d(t1, w2t.reshape(3, 3, m, m).permute(3, 2, 0, 1)) + b2[:, None, None])
    return F.relu(F.conv2d(t2, w3t.t()[:, :, None, None]) + b3[:, None, None] + x)


@pytest.mark.parametrize("n,h,w,c,m", [(1, 9, 12, 32, 8), (2, 16, 10, 16, 16), (1, 8, 8, 8, 8)])
def test_fused_bottleneck_matches_jax(n, h, w, c, m):
    """The plain version (and the wrapper) against fused_bottleneck in
    interpret mode at the JAX test's shapes; atol/rtol 1e-4, the JAX
    test's own tolerance for its kernel against its XLA chain."""
    rng = np.random.default_rng(c + m + h)
    x = (rng.normal(size=(n, h, w, c)) * 0.5).astype(np.float32)
    ops = _bottleneck_operands(rng, c, m)
    ref = jax_fb.fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ops))
    for fn in (fb.reference_fused_bottleneck, fb.fused_bottleneck):
        ours = fn(nchw(x), *_port_operands(*ops))
        np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_fused_bottleneck_edge_masking():
    """b1 = 2.0 makes relu(b1) != 0 on the halo outside the image: the
    plain version agrees with the TPU kernel (atol/rtol 1e-4), and the
    same chain with T1 left unmasked misses that tolerance, so this check
    sees the bug the CUDA kernel has to avoid."""
    rng = np.random.default_rng(3)
    n, h, w, c, m = 1, 10, 11, 16, 8
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ops = _bottleneck_operands(rng, c, m, b1=np.full((m,), 2.0, np.float32), scale=0.3)
    ref = np.asarray(jax_fb.fused_bottleneck(jnp.asarray(x), *map(jnp.asarray, ops)))
    port_ops = _port_operands(*ops)
    ours = fb.reference_fused_bottleneck(nchw(x), *port_ops)
    np.testing.assert_allclose(nhwc(ours), ref, atol=1e-4, rtol=1e-4)
    mutant = nhwc(_unmasked_t1_bottleneck(nchw(x), *port_ops))
    assert not np.allclose(mutant, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(mutant - ref).max() > 0.1


def test_fold_and_pack_match_jax():
    """fold_bn_params folds like the JAX function (float32, exact), and
    pack_weights of the port's OIHW weights gives the JAX HWIO kernels
    flattened."""
    rng = np.random.default_rng(4)
    k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)  # HWIO
    scale, shift = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    jw, jb = jax_fb.fold_bn_params(jnp.asarray(k), jnp.asarray(scale), jnp.asarray(shift))
    w, b = fb.fold_bn_params(torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(scale),
                             torch.from_numpy(shift))
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    w1 = torch.from_numpy(rng.normal(size=(16, 8, 1, 1)).astype(np.float32))  # (M, C) OIHW
    w3 = torch.from_numpy(rng.normal(size=(8, 16, 1, 1)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(16, 16, 3, 3)).astype(np.float32))
    w1t, w2t, w3t = fb.pack_weights(w1, w2, w3, torch.bfloat16)
    assert w1t.dtype == torch.bfloat16 and w2t.shape == (9, 16, 16)
    np.testing.assert_array_equal(w1t.float().numpy(), w1[:, :, 0, 0].t().bfloat16().float())
    np.testing.assert_array_equal(w2t.float().numpy(),
                                  w2.permute(2, 3, 1, 0).reshape(9, 16, 16).bfloat16().float())
    np.testing.assert_array_equal(w3t.float().numpy(), w3[:, :, 0, 0].t().bfloat16().float())


# ---- kernel E's bf16 path, E-mma: plans and its tiling emulated -----------------------------

# The feature maps of ResNet-50's four stages at the 768x1280 and 896x1408
# buckets, and ragged ones (partial tiles, a map smaller than one tile).
E_MAPS = {"768x1280": [(192, 320), (96, 160), (48, 80), (24, 40)],
          "896x1408": [(224, 352), (112, 176), (56, 88), (28, 44)],
          "ragged": [(13, 21), (9, 11), (7, 5), (5, 7), (1, 1)]}


@pytest.mark.parametrize("bucket", sorted(E_MAPS))
@pytest.mark.parametrize("m", [64, 128, 256, 512])
def test_mma_plan_fits_the_card(m, bucket):
    """At each ResNet-50 width (C = 4M), E-mma's plan fits a CTA in 232,448
    bytes of shared memory, with a cluster of 1, 2, 4 or 8 CTAs that splits
    M and C evenly; at each map of the bucket its grid (pixel tiles times
    the cluster, images along y) lies within CUDA's limits; a width
    without a plan is refused."""
    c = 4 * m
    th, tw, k = plan = fb.mma_plan(c, m)
    assert plan == fb.MMA_PLANS[m]
    assert k in (1, 2, 4, 8) and m % k == 0 and c % k == 0
    assert fb.mma_smem_bytes(m) <= fb.MAX_SMEM == 232448
    maps = E_MAPS[bucket] if bucket == "ragged" else [E_MAPS[bucket][[64, 128, 256, 512].index(m)]]
    for h, w in maps:
        ctas = -(-h // th) * -(-w // tw) * k
        assert 1 <= ctas < 2**31 and ctas % k == 0
    with pytest.raises(ValueError, match="takes M in"):
        fb.mma_plan(96, 48)
    with pytest.raises(ValueError, match="takes M in"):
        fb.mma_plan(c + 32, m)


def _bf16(a):
    """``a`` rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()


def _chunked(a, b, kc=16):
    """a @ b as the kernel sums it: chunks of kc contraction rows in order."""
    return sum(a[:, k0:k0 + kc] @ b[k0:k0 + kc] for k0 in range(0, a.shape[1], kc))


def _push(buf, nk):
    """The cluster exchange: rank r copies its slice (columns r nk..) into
    every other rank's buffer, after which each rank holds every slice."""
    k = len(buf)
    for r in range(k):
        for d in range(1, k):
            buf[(r + d) % k][..., r * nk:(r + 1) * nk] = buf[r][..., r * nk:(r + 1) * nk]


def _mma_emulation(x, w1, b1, w2, b2, w3, b3, tile, cluster, np3=16, zero_halo=True,
                   exchange=True):
    """csrc/fused_bottleneck_mma.cu's algorithm in numpy float64, on NHWC x
    (bf16 values) and bf16-valued weights w1 (C, M), w2 (9, M, M), w3 (M,
    C): per TH x TW tile, x over the halo (zero outside the image), in
    16-row tiles whose rows past the halo repeat its last pixel; each rank
    r of a cluster computes T1's columns r M/K.. into its own buffer (the
    others NaN until the exchange fills them), T1 zeroed outside the image;
    conv2 gathers each tap's rows by the kernel's row address; T2 likewise;
    y's columns r C/K.. in passes of np3, the residual added in fp32,
    pixels outside the image not written (NaN)."""
    th, tw = tile
    n, h, w, c = x.shape
    m = w1.shape[1]
    nk, cs, hw = m // cluster, c // cluster, tw + 2
    p1, p2 = (th + 2) * hw, th * tw
    q, p = np.arange(p1), np.arange(p2)
    rows1 = np.minimum(np.arange(-(-p1 // 16) * 16), p1 - 1)
    taps = [(p // tw) * hw + p % tw + (tap // 3) * hw + tap % 3 for tap in range(9)]
    y = np.full(x.shape, np.nan)
    for img in range(n):
        for oy0 in range(0, h, th):
            for ox0 in range(0, w, tw):
                gy, gx = oy0 - 1 + q // hw, ox0 - 1 + q % hw
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                xs = np.zeros((p1, c))
                xs[inside] = x[img, gy[inside], gx[inside]]
                t1, t2 = np.full((cluster, p1, m), np.nan), np.full((cluster, p2, m), np.nan)
                for r in range(cluster):
                    sl = slice(r * nk, (r + 1) * nk)
                    v = _bf16(np.maximum(_chunked(xs[rows1], w1[:, sl])[:p1] + b1[sl], 0))
                    t1[r][:, sl] = np.where(inside[:, None] | (not zero_halo), v, 0)
                if exchange:
                    _push(t1, nk)
                for r in range(cluster):
                    sl = slice(r * nk, (r + 1) * nk)
                    acc = sum(_chunked(t1[r][taps[tap]], w2[tap][:, sl]) for tap in range(9))
                    t2[r][:, sl] = _bf16(np.maximum(acc + b2[sl], 0))
                if exchange:
                    _push(t2, nk)
                oy, ox = oy0 + p // tw, ox0 + p % tw
                out = (oy < h) & (ox < w)
                for r in range(cluster):
                    for n0 in range(r * cs, (r + 1) * cs, np3):
                        cols = slice(n0, n0 + np3)
                        acc = _chunked(t2[r], w3[:, cols])[out]
                        res = x[img, oy[out], ox[out]][:, cols]
                        y[img, oy[out], ox[out], cols] = _bf16(np.maximum(acc + b3[cols] + res, 0))
    return y


def _float64_chain(x, w1, b1, w2, b2, w3, b3):
    """The bottleneck in float64 with the kernel's bf16 rounding points."""
    n, h, w, _ = x.shape
    t1 = np.pad(_bf16(np.maximum(x @ w1 + b1, 0)), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(t1[:, dy:dy + h, dx:dx + w] @ w2[3 * dy + dx] for dy in range(3) for dx in range(3))
    t2 = _bf16(np.maximum(acc + b2, 0))
    return _bf16(np.maximum(t2 @ w3 + b3 + x, 0))


def _mma_case(n, h, w, c, m, seed):
    """bf16-valued x and weights, float32 biases; b1 > 0 so that a T1 left
    unmasked outside the image would show."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.uniform(0, 1, size=(n, h, w, c)))
    w1, w3 = (_bf16(rng.normal(size=s) * s[0] ** -0.5) for s in ((c, m), (m, c)))
    w2 = _bf16(rng.normal(size=(9, m, m)) * (9 * m) ** -0.5)
    b1 = rng.uniform(0.5, 1.5, size=m).astype(np.float32)
    b2, b3 = (rng.normal(size=k).astype(np.float32) * 0.1 for k in (m, c))
    return x, w1, b1, w2, b2, w3, b3


# (n, h, w, C, M, tile, cluster): partial tiles at the compiled tile shapes
# (8 x 8, 8 x 16) and at 4 x 8, a map smaller than one tile, and forced
# cluster splits of 2 and 4.
MMA_EMULATION_CASES = [(2, 9, 13, 64, 32, (4, 8), 4), (2, 9, 13, 64, 32, (8, 8), 2),
                       (2, 5, 7, 32, 16, (8, 8), 2), (2, 11, 10, 32, 16, (8, 16), 1)]


@pytest.mark.parametrize("n,h,w,c,m,tile,cluster", MMA_EMULATION_CASES)
def test_mma_emulation_matches_jax_and_float64(n, h, w, c, m, tile, cluster):
    """E-mma's tiling, emulated, writes every output and agrees with the
    float64 chain with the same bf16 rounding points within 1e-6 of the
    largest output (summation order only), and with the JAX package's
    fused_bottleneck (Pallas, interpret mode, bf16 operands, float32
    accumulation) within two bf16 ulps of the largest output (2^-7): a
    T1 or T2 value whose float32 and float64 sums round to different bf16
    values moves its output by about one ulp."""
    ops = _mma_case(n, h, w, c, m, seed=h * w + cluster)
    ours = _mma_emulation(*ops, tile=tile, cluster=cluster)
    assert np.isfinite(ours).all()
    exact = _float64_chain(*ops)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(ours, exact, atol=1e-6 * scale, rtol=0)
    x, w1, b1, w2, b2, w3, b3 = ops
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = jax_fb.fused_bottleneck(bf(x), bf(w1), jnp.asarray(b1), bf(w2).reshape(3, 3, m, m),
                                  jnp.asarray(b2), bf(w3), jnp.asarray(b3))
    np.testing.assert_allclose(ours, np.asarray(ref, np.float64), atol=2**-7 * scale, rtol=0)


def test_mma_emulation_sees_a_leaky_halo_and_a_missing_exchange():
    """The checks above would catch E-mma's two hazards: T1 left at
    relu(b1) outside the image misses the float64 chain by far more than
    its tolerance, and a cluster that skips the exchange leaves NaN (the
    other ranks' slices) in every output."""
    ops = _mma_case(2, 9, 13, 64, 32, seed=5)
    exact = _float64_chain(*ops)
    leaky = _mma_emulation(*ops, tile=(8, 8), cluster=2, zero_halo=False)
    assert np.abs(leaky - exact).max() > 100 * 1e-6 * np.abs(exact).max()
    assert np.isnan(_mma_emulation(*ops, tile=(8, 8), cluster=2, exchange=False)).all()


# ---- kernel E's fp32 path, E-tf32: plans and its arithmetic emulated ------------------------


@pytest.mark.parametrize("bucket", sorted(E_MAPS))
@pytest.mark.parametrize("m", [64, 128, 256, 512])
def test_tf32_plan_fits_the_card(m, bucket):
    """At each ResNet-50 width (C = 4M), E-tf32's plan fits a CTA in 232,448
    bytes of shared memory (T1 over the halo, T2 written over it, and a
    3-stage ring), with a cluster of 1, 2 or 4 CTAs that splits M and C in
    whole stage-3 passes; at each map of the bucket its grid lies within
    CUDA's limits; a width without a plan is refused."""
    c = 4 * m
    th, tw, k = plan = fb.tf32_plan(c, m)
    assert plan == fb.TF32_PLANS[m]
    assert k in (1, 2, 4) and m % (8 * k) == 0 and c % (k * fb.tf32_stage3_pass(m)) == 0
    assert th * tw // 16 * fb.tf32_stage3_pass(m) // 8 == 64  # a CTA's accumulator blocks
    assert fb.tf32_smem_bytes(m) <= fb.MAX_SMEM == 232448
    maps = E_MAPS[bucket] if bucket == "ragged" else [E_MAPS[bucket][[64, 128, 256, 512].index(m)]]
    for h, w in maps:
        ctas = -(-h // th) * -(-w // tw) * k
        assert 1 <= ctas < 2**31 and ctas % k == 0
    with pytest.raises(ValueError, match="takes M in"):
        fb.tf32_plan(96, 48)
    with pytest.raises(ValueError, match="takes M in"):
        fb.tf32_plan(c + 32, m)


def _tf32(a):
    """float32 ``a`` rounded to TF32 as ``tf32mma::to_tf32`` does (10 mantissa
    bits, to nearest, ties away from zero)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(a, trunc_small=False):
    """``tf32mma::split_tf32``: (big, small), TF32 values as float64. With
    ``trunc_small``, D-tf32's ``split_operand``: small = a - big passed to
    the MMA unrounded, modelled as the MMA truncating it to TF32."""
    a = np.asarray(a, np.float32)
    big = _tf32(a)
    small = a - big
    if trunc_small:
        small = (small.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    else:
        small = _tf32(small)
    return big.astype(np.float64), small.astype(np.float64)


def _mma(acc, a, b):
    """One TF32 MMA into a float32 accumulator, the pessimistic model of the
    tensor cores' add: the products summed exactly, then the sum truncated
    (rounded toward zero) to float32."""
    v = acc + a @ b
    r = v.astype(np.float32)
    return np.where(np.abs(r) > np.abs(v), np.nextafter(r, np.float32(0)), r)


def _tf32_product(a, b, split=True, flush=True, trunc_small=False):
    """a (R, K) @ b (K, N), float32, as E-tf32's chunk_product sums it: per
    k8 step one MMA of the big parts into hi and, with ``split`` (3xTF32),
    two MMAs of the cross terms chained into lo; hi added to the running
    float32 sum at the end of each 32-row chunk with ``flush`` (else chained
    through the whole contraction); then (sum + lo) in float32. Operands
    split as ``_split_tf32(trunc_small)``."""
    (ab, a_small), (bb, b_small) = (_split_tf32(v, trunc_small) for v in (a, b))
    acc, hi, lo = (np.zeros((a.shape[0], b.shape[1]), np.float32) for _ in range(3))
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        hi = _mma(hi, ab[:, s], bb[s])
        if split:
            lo = _mma(_mma(lo, a_small[:, s], bb[s]), ab[:, s], b_small[s])
        if flush and (k0 + 8) % 32 == 0:
            acc, hi = acc + hi, np.zeros_like(hi)
    return (acc + hi) + lo


def _tf32_emulation(x, w1, b1, w2, b2, w3, b3, tile, cluster, zero_halo=True, t2_barrier=True,
                    **arith):
    """csrc/fused_bottleneck_tf32.cu's algorithm on NHWC float32 x and
    weights w1 (C, M), w2 (9, M, M), w3 (M, C), every tile of the map at
    once: x over each TH x TW tile's halo (zero outside the image); rank r of
    a cluster computes T1's columns r M/K.. (the other ranks' NaN until the
    exchange), zeroed outside the image; conv2 gathers each tap's rows by
    the kernel's row address, chunks tap by tap; each rank writes its T2
    slice over rows 0.. of its own T1 buffer, and after a cluster barrier
    (skipped with ``t2_barrier=False``: each rank pushes as soon as it is
    done) pushes it into the others'; y's columns r C/K.. with the residual
    added in float32, pixels outside the image not written (NaN). Products
    as ``_tf32_product(**arith)``."""
    th, tw = tile
    n, h, w, c = x.shape
    m = w1.shape[1]
    nk, cs, hw = m // cluster, c // cluster, tw + 2
    p1, p2 = (th + 2) * hw, th * tw
    q, p = np.arange(p1), np.arange(p2)
    taps = np.concatenate([(p // tw) * hw + p % tw + (tap // 3) * hw + tap % 3 for tap in range(9)])
    origins = [(img, oy0, ox0) for img in range(n) for oy0 in range(0, h, th)
               for ox0 in range(0, w, tw)]
    xs, inside = np.zeros((len(origins), p1, c), np.float32), np.zeros((len(origins), p1), bool)
    for i, (img, oy0, ox0) in enumerate(origins):
        gy, gx = oy0 - 1 + q // hw, ox0 - 1 + q % hw
        inside[i] = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        xs[i, inside[i]] = x[img, gy[inside[i]], gx[inside[i]]]
    tiles = len(origins)
    buf = np.full((cluster, tiles, p1, m), np.nan, np.float32)  # each rank's T1, then T2
    for r in range(cluster):
        sl = slice(r * nk, (r + 1) * nk)
        v = _tf32_product(xs.reshape(-1, c), w1[:, sl], **arith).reshape(tiles, p1, nk)
        v = np.maximum(v + b1[sl], 0)
        buf[r][..., sl] = np.where(inside[..., None] | (not zero_halo), v, 0)
    _push(buf, nk)
    w2k = w2.reshape(9 * m, m)
    for r in range(cluster):
        sl = slice(r * nk, (r + 1) * nk)
        a = buf[r][:, taps].reshape(tiles, 9, p2, m).transpose(0, 2, 1, 3).reshape(-1, 9 * m)
        t2 = np.maximum(_tf32_product(a, w2k[:, sl], **arith) + b2[sl], 0)
        buf[r][:, :p2, sl] = t2.reshape(tiles, p2, nk)
        if not t2_barrier:  # pushed while later ranks still read their T1
            for d in range(1, cluster):
                buf[(r + d) % cluster][:, :p2, sl] = buf[r][:, :p2, sl]
    if t2_barrier:
        _push(buf[:, :, :p2], nk)
    y = np.full(x.shape, np.nan, np.float32)
    for r in range(cluster):
        cols = slice(r * cs, (r + 1) * cs)
        acc = _tf32_product(buf[r][:, :p2].reshape(-1, m), w3[:, cols], **arith)
        acc = (acc + b3[cols]).reshape(tiles, p2, cs)
        for i, (img, oy0, ox0) in enumerate(origins):
            oy, ox = oy0 + p // tw, ox0 + p % tw
            out = (oy < h) & (ox < w)
            res = x[img, oy[out], ox[out], cols]
            y[img, oy[out], ox[out], cols] = np.maximum(acc[i][out] + res, 0)
    return y


def _tf32_case(n, h, w, c, m, seed):
    """float32 x (post-ReLU, in [0, 1)) and weights scaled by their fan-in,
    float32 biases; b1 > 0 so that a T1 left unmasked outside the image
    would show."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, h, w, c)).astype(np.float32)
    w1, w3 = ((rng.normal(size=s) * s[0] ** -0.5).astype(np.float32) for s in ((c, m), (m, c)))
    w2 = (rng.normal(size=(9, m, m)) * (9 * m) ** -0.5).astype(np.float32)
    b1 = rng.uniform(0.5, 1.5, size=m).astype(np.float32)
    b2, b3 = ((rng.normal(size=k) * 0.1).astype(np.float32) for k in (m, c))
    return x, w1, b1, w2, b2, w3, b3


# (n, h, w, M) with C = 4M at each width's plan: ragged maps (partial tiles
# on both axes) at M = 64..256, and layer 4's 9 * 512-deep conv2 at a 5 x 7
# map (two 4 x 8 tiles, the second a single row).
TF32_EMULATION_CASES = [(2, 9, 13, 64), (1, 11, 10, 128), (1, 9, 11, 256), (1, 5, 7, 512)]


@pytest.mark.parametrize("n,h,w,m", TF32_EMULATION_CASES)
def test_tf32_emulation_matches_jax_and_float64(n, h, w, m):
    """E-tf32's tiling and 3xTF32 arithmetic, emulated with every MMA's add
    truncated, write every output and agree with the float64 chain and with
    the JAX package's fused_bottleneck (Pallas, interpret mode, float32)
    within 1e-5 of the largest output: the fp32 tolerance chip_smoke.py holds
    the kernel to against the plain version on the card."""
    ops = _tf32_case(n, h, w, 4 * m, m, seed=m + h)
    th, tw, k = fb.TF32_PLANS[m]
    ours = _tf32_emulation(*ops, tile=(th, tw), cluster=k)
    assert np.isfinite(ours).all()
    exact = _float64_chain_tf32(*ops)
    scale = max(1.0, np.abs(exact).max())
    np.testing.assert_allclose(ours, exact, atol=1e-5 * scale, rtol=0)
    x, w1, b1, w2, b2, w3, b3 = map(jnp.asarray, ops)
    ref = jax_fb.fused_bottleneck(x, w1, b1, w2.reshape(3, 3, m, m), b2, w3, b3)
    np.testing.assert_allclose(ours, np.asarray(ref, np.float64), atol=1e-5 * scale, rtol=0)


def _float64_chain_tf32(x, w1, b1, w2, b2, w3, b3):
    """The bottleneck in float64, no rounding point."""
    x, w1, w2, w3 = (np.asarray(a, np.float64) for a in (x, w1, w2, w3))
    n, h, w, _ = x.shape
    t1 = np.pad(np.maximum(x @ w1 + b1, 0), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(t1[:, dy:dy + h, dx:dx + w] @ w2[3 * dy + dx] for dy in range(3) for dx in range(3))
    return np.maximum(np.maximum(acc + b2, 0) @ w3 + b3 + x, 0)


def test_tf32_accuracy_needs_3xtf32_and_the_flushes():
    """At conv2's 9 * 512-deep contraction (layer 4, T1 >= 0 as after the
    ReLU), 3xTF32 with each 32-row chunk's big x big flushed into the
    float32 sum stays within 1e-5 of float64 relative to the largest value;
    single TF32 (one MMA of the rounded operands) misses it by more than
    10x, and 3xTF32 chaining big x big through one truncating accumulator
    misses it too."""
    rng = np.random.default_rng(6)
    m = 512
    t1 = rng.uniform(0, 1, size=(32, 9 * m)).astype(np.float32)
    w2 = (rng.normal(size=(9 * m, m)) * (9 * m) ** -0.5).astype(np.float32)
    exact = t1.astype(np.float64) @ w2.astype(np.float64)
    scale = np.abs(exact).max()
    err = {kw: np.abs(_tf32_product(t1, w2, *kw) - exact).max() / scale
           for kw in ((True, True), (False, True), (True, False))}
    assert err[(True, True)] <= 1e-5
    assert err[(False, True)] > 10 * 1e-5
    assert err[(True, False)] > 1e-5


def test_tf32_emulation_sees_a_leaky_halo_and_a_broken_exchange():
    """The checks above would catch E-tf32's hazards: T1 left at relu(b1)
    outside the image misses the float64 chain by far more than 1e-5; a
    cluster whose ranks push T2 into the others' buffers before every rank
    has finished reading its T1 (T2 is written over T1) gives wrong
    outputs."""
    ops = _tf32_case(1, 9, 11, 128, 32, seed=5)
    exact = _float64_chain_tf32(*ops)
    scale = max(1.0, np.abs(exact).max())
    leaky = _tf32_emulation(*ops, tile=(8, 8), cluster=2, zero_halo=False)
    assert np.abs(leaky - exact).max() > 100 * 1e-5 * scale
    early = _tf32_emulation(*ops, tile=(8, 8), cluster=2, t2_barrier=False)
    assert np.abs(early - exact).max() > 100 * 1e-5 * scale


# ---- kernel D's fp32 path, D-tf32: its shape check, its tiling and arithmetic emulated --------


@pytest.mark.parametrize("p,cin,cout", D_SHAPES)
def test_tf32_shape_check_takes_the_path_shapes(p, cin, cout):
    """D-tf32 takes each D shape of the path, and its grid of 128-pixel x
    64-channel tiles stays within a launch's 2^31 CTAs and gives at least
    one CTA per SM of the H100 (132); it refuses Cin or Cout not a multiple
    of 4."""
    fr.check_tf32_shape(cin, cout)
    assert 132 <= -(-p // 128) * -(-cout // 64) < 2**31
    for bad in ((cin + 2, cout), (cin, cout - 2), (18, cout)):
        with pytest.raises(ValueError, match="multiples of 4"):
            fr.check_tf32_shape(*bad)


def _d_tf32_emulation(x, w, scale, shift, identity, tile=128, kc=32, bn=64):
    """csrc/fused_residual_tf32.cu's algorithm in numpy, on float32 (P, Cin)
    x, (Cout, Cin) w, (P, Cout) identity, scale and shift: per tile of
    ``tile`` pixels x ``bn`` channels, x's rows past P and w's rows past Cout
    zero-filled, Cin in chunks of ``kc`` (columns past Cin zero on both
    operands) walked in k8 steps in order, each step's 3xTF32 MMAs with
    every MMA's add truncated and small truncated to TF32, big x big chained
    through one accumulator and the cross terms through another over the
    whole sum (``_tf32_product(flush=False, trunc_small=True)``), then (hi +
    lo), ((acc * scale) + shift)
    + identity in float32 (the identity tile zero past P and Cout) and ReLU.
    Returns the (P, Cout) output inside a buffer padded to whole tiles, NaN
    where the kernel stores nothing."""
    p, cin = x.shape
    cout = w.shape[0]
    pp, cp, kp = -(-p // tile) * tile, -(-cout // bn) * bn, -(-cin // kc) * kc
    xs, ws = np.zeros((pp, kp), np.float32), np.zeros((cp, kp), np.float32)
    ids, sc, sh = (np.zeros(s, np.float32) for s in ((pp, cp), cp, cp))
    xs[:p, :cin], ws[:cout, :cin], ids[:p, :cout] = x, w, identity
    sc[:cout], sh[:cout] = scale, shift
    y = np.full((pp, cp), np.nan, np.float32)
    for p0 in range(0, pp, tile):
        for c0 in range(0, cp, bn):
            rows, cols = slice(p0, p0 + tile), slice(c0, c0 + bn)
            acc = _tf32_product(xs[rows], ws[cols].T, flush=False, trunc_small=True)
            out = np.maximum(((acc * sc[cols]) + sh[cols]) + ids[rows, cols], np.float32(0))
            stored = (np.arange(p0, p0 + tile) < p)[:, None] & (np.arange(c0, c0 + bn) < cout)
            y[rows, cols] = np.where(stored, out, np.nan)
    return y


def _d_tf32_case(p, cin, cout, seed):
    """float32 x (post-ReLU, in [0, 1)), weights scaled by their fan-in, the
    moderate FrozenBN scale and shift of ``_d_case`` and a unit-normal
    identity."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(p, cin)).astype(np.float32)
    w = (rng.normal(size=(cout, cin)) * cin**-0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    shift = (rng.normal(size=cout) * 0.3).astype(np.float32)
    identity = rng.normal(size=(p, cout)).astype(np.float32)
    return x, w, scale, shift, identity


@pytest.mark.parametrize("p,cin,cout", D_EMULATION_CASES)
def test_d_tf32_emulation_matches_jax_and_float64(p, cin, cout):
    """D-tf32's tiling and 3xTF32 arithmetic, emulated with every MMA's add
    truncated, store every output and nothing past P or Cout, and agree with
    a float64 chain and with the JAX package's matmul_bn_residual_relu
    (Pallas, interpret mode, float32) within 1e-5 of the largest output: the
    fp32 tolerance chip_smoke.py holds the kernel to against the plain
    version on the card."""
    x, w, scale, shift, identity = ops = _d_tf32_case(p, cin, cout, seed=p + cin)
    padded = _d_tf32_emulation(*ops)
    ours = padded[:p, :cout]
    assert np.isfinite(ours).all()
    assert np.isnan(padded[p:]).all() and np.isnan(padded[:, cout:]).all()
    exact = np.maximum((x.astype(np.float64) @ w.T.astype(np.float64)) * scale + shift
                       + identity, 0)
    top = np.abs(exact).max()
    np.testing.assert_allclose(ours, exact, atol=1e-5 * top, rtol=0)
    ref = jax_fr.matmul_bn_residual_relu(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(scale),
                                         jnp.asarray(shift), jnp.asarray(identity))
    np.testing.assert_allclose(ours, np.asarray(ref, np.float64), atol=1e-5 * top, rtol=0)


def test_d_tf32_accuracy_needs_3xtf32_but_no_flush():
    """At layer 4's Cin = 512 (x >= 0 as after the ReLU), 3xTF32 with big x
    big chained through one truncating accumulator over the whole sum and
    small truncated to TF32 (D-tf32's scheme, two accumulator sets) stays
    within 1e-5 of float64 relative to the largest value, a quarter of it
    besides; single TF32 misses 1e-5 by more than 10x. E-tf32's per-chunk
    flush, which needs a third accumulator set, is for its 9 * 512-deep
    conv2 (test_tf32_accuracy_needs_3xtf32_and_the_flushes)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, size=(64, 512)).astype(np.float32)
    w = (rng.normal(size=(512, 256)) * 512 ** -0.5).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).max()
    err = {split: np.abs(_tf32_product(x, w, split, flush=False, trunc_small=True)
                         - exact).max() / scale for split in (True, False)}
    assert err[True] <= 1e-5 / 4
    assert err[False] > 10 * 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bottleneck_routes_by_dtype_and_cpu_takes_plain(dtype):
    """bf16 routes to E-mma and fp32 to E-tf32 on the card; a CPU call takes
    the plain version at either dtype and launches no kernel, and each
    tensor-core kernel refuses the other dtype before it looks at the
    device."""
    assert fb.route(dtype) == ("mma" if dtype == torch.bfloat16 else "tf32")
    rng = np.random.default_rng(11)
    x = nchw((rng.normal(size=(2, 9, 13, 64)) * 0.5).astype(np.float32)).to(dtype)
    ops = [t.to(dtype) if t.dim() > 1 else t
           for t in _port_operands(*_bottleneck_operands(rng, 64, 32))]
    counts = lambda: (fb.fused_bottleneck.launches, fb.fused_bottleneck.mma_launches,  # noqa: E731
                      fb.fused_bottleneck.tf32_launches)
    before = counts()
    got = fb.fused_bottleneck(x, *ops)
    assert torch.equal(got, fb.reference_fused_bottleneck(x, *ops))
    assert counts() == before == (0, 0, 0)
    own, other, other_dtype = ((fb.launch_mma, fb.launch_tf32, "float32")
                               if dtype == torch.bfloat16 else
                               (fb.launch_tf32, fb.launch_mma, "bfloat16"))
    with pytest.raises(TypeError, match=f"takes {other_dtype}"):
        other(x, *ops)
    with pytest.raises(ValueError, match="no fused bottleneck kernel for device cpu"):
        own(x, *ops)


# ---- the fused backbone and DETR ------------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(fuse_residual=True), FUSED])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_backbone_matches_jax(flags, masked):
    """ResNetBackbone (2,1,1,1) with the fusion flags against the JAX fused
    backbone from the same random variables (nonzero BN shifts), with and
    without a pixel mask; and against the port's unfused backbone. fp32,
    atol/rtol 1e-4 (the module tolerance of tests/test_torch_models.py)."""
    rng = np.random.default_rng(5)
    mask = _pixel_mask(2, 64, 96, [(64, 96), (45, 61)])
    x = (rng.normal(size=(2, 64, 96, 3)) * mask[..., None]).astype(np.float32)
    stages = (2, 1, 1, 1)
    jmod = jax_resnet.ResNetBackbone(stage_sizes=stages, **flags)
    variables = random_variables(jmod, jnp.asarray(x), seed=5)
    pm = jnp.asarray(mask) if masked else None
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x), pixel_mask=pm)
    port = resnet.ResNetBackbone(stages, **flags).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    plain = resnet.ResNetBackbone(stages).eval()
    plain.load_state_dict(from_jax_variables(variables), strict=True)
    args = (torch.from_numpy(x), torch.from_numpy(mask) if masked else None)
    with torch.no_grad():
        ours, unfused = port(*args), plain(*args)
    close(ours.permute(0, 2, 3, 1), ref)
    close(ours, unfused.numpy())


def test_fused_bf16_backbone_with_a_pixel_mask_matches_jax():
    """ResNetBackbone (2,1,1,1) with fuse_residual=True at bf16 (float32
    parameters, bf16 activations: kernel D on every block) with a pixel
    mask, against the JAX fused backbone at bf16 from the same random
    variables as test_fused_backbone_matches_jax: the port's c5 lies at most
    FUSED_BF16_C5_RATIO = 2 times as far from the JAX fp32 backbone's as the
    JAX bf16 backbone's own (both gaps are bf16 rounding at different
    points; chip_smoke.py's rule)."""
    rng = np.random.default_rng(5)
    mask = _pixel_mask(2, 64, 96, [(64, 96), (45, 61)])
    x = (rng.normal(size=(2, 64, 96, 3)) * mask[..., None]).astype(np.float32)
    stages = (2, 1, 1, 1)
    jmods = {dt: jax_resnet.ResNetBackbone(stage_sizes=stages, fuse_residual=True, dtype=dt)
             for dt in (jnp.float32, jnp.bfloat16)}
    variables = random_variables(jmods[jnp.float32], jnp.asarray(x), seed=5)
    ref, jax_bf16 = (np.asarray(jax.jit(jmods[dt].apply)(variables, jnp.asarray(x),
                                                          pixel_mask=jnp.asarray(mask)), np.float32)
                     for dt in (jnp.float32, jnp.bfloat16))
    port = resnet.ResNetBackbone(stages, fuse_residual=True).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    before = _d_counts()
    with torch.no_grad():
        ours = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    ours = nhwc(ours)
    top = np.abs(ref).max()
    gap_port, gap_jax = (np.abs(v - ref).max() / top for v in (ours, jax_bf16))
    assert 0 < gap_port <= 2.0 * gap_jax, (gap_port, gap_jax)
    assert _d_counts() == before  # plain on the CPU


@pytest.mark.parametrize("masked", [False, True])
def test_fused_detr_matches_jax(masked):
    """DETR(fuse_residual=True, fuse_bottleneck=True), the JAX package's
    fused-backbone serving configuration, against the JAX model from the
    same variables, with and without a pixel mask. Golden tolerances
    (boxes 5e-4, logits 5e-3, rtol 1e-3); and the unfused port model within
    the same."""
    rng = np.random.default_rng(6)
    mask = _pixel_mask(1, 64, 64, [(64, 64)] if not masked else [(50, 37)])
    x = (rng.normal(size=(1, 64, 64, 3)) * mask[..., None]).astype(np.float32)
    jmod = jax_detr.DETR(dropout=0.0, attn_impl="xla", **TINY, **FUSED)
    variables = random_variables(jmod, jnp.asarray(x), seed=6)
    pm = jnp.asarray(mask) if masked else None
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x), pm)
    port = detr.DETR(**TINY, **FUSED).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    plain = detr.DETR(**TINY).eval()
    plain.load_state_dict(from_jax_variables(variables), strict=True)
    args = (torch.from_numpy(x), torch.from_numpy(mask) if masked else None)
    with torch.inference_mode():
        out, unfused = port(*args), plain(*args)
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL)):
        close(out[key], ref[key], atol=atol, rtol=GOLDEN_RTOL)
        close(out[key], unfused[key].numpy(), atol=atol, rtol=GOLDEN_RTOL)


def test_fused_model_loads_jax_fused_variables_strict():
    """The fused configuration has the unfused parameter tree: a JAX
    DETR(fuse_bottleneck=True)'s variables load into the fused port model
    with strict=True."""
    jmod = jax_detr.DETR(dropout=0.0, **TINY, fuse_bottleneck=True)
    variables = random_variables(jmod, jnp.zeros((1, 64, 64, 3)))
    port = detr.DETR(**TINY, **FUSED)
    state = from_jax_variables(variables)
    assert set(state) == set(port.state_dict()) == set(detr.DETR(**TINY).state_dict())
    port.load_state_dict(state, strict=True)


def test_folded_weights_follow_the_buffers():
    """Kernel E's folded weights and kernel D's bn3 scale and shift are
    cached; writing a BN buffer or a conv weight in place, or loading a
    state_dict, makes the next forward fold again: the fused backbone keeps
    agreeing with the unfused one (atol/rtol 1e-4)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 32, 32, 3)).astype(np.float32))
    fused = resnet.ResNetBackbone((2, 1, 1, 1), **FUSED).eval()
    plain = resnet.ResNetBackbone((2, 1, 1, 1)).eval()
    plain.load_state_dict(fused.state_dict())
    block, tail = fused.layer1.block_1, fused.layer1.block_0
    with torch.no_grad():
        fused(x)
        cached = dict(block._cache), dict(tail._cache)
        fused(x)
        assert (block._cache, tail._cache) == cached  # no refold while nothing changed
        for model in (fused, plain):
            for b in (model.layer1.block_0, model.layer1.block_1):
                b.bn3.bias.add_(0.5)
            model.layer1.block_1.bn2.bias.add_(0.5)
            model.layer1.block_1.conv3.weight.mul_(1.5)
        close(fused(x), plain(x).numpy())
        assert block._cache != cached[0] and tail._cache != cached[1]
        state = {k: v + 0.01 * torch.randn(v.shape) if k.endswith("running_mean") else v
                 for k, v in plain.state_dict().items()}
        plain.load_state_dict(state)
        fused.load_state_dict(state)
        close(fused(x), plain(x).numpy())


# ---- routing and training -------------------------------------------------------------------


@pytest.fixture
def op_calls(monkeypatch):
    """Count the calls of each fused op's entry function in models/resnet.py
    (the plain versions run underneath, on the CPU)."""
    calls = {"max_pool_3x3_s2(nonneg=True)": 0, "conv1x1_bn_residual_relu": 0,
             "fused_bottleneck": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            if name != "max_pool_3x3_s2" or kwargs.get("nonneg"):
                key = name + ("(nonneg=True)" if name == "max_pool_3x3_s2" else "")
                calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("max_pool_3x3_s2", "conv1x1_bn_residual_relu", "fused_bottleneck"):
        monkeypatch.setattr(resnet, name, counted(name, getattr(resnet, name)))
    return calls


@pytest.mark.parametrize("masked", [False, True])
def test_fused_routing(op_calls, masked):
    """Stage sizes (2, 3, 2, 2): without a mask, E on every identity block
    (5) and D on every block_0 (4); with a mask, D on every block (9) and
    no E; the stem through max_pool_3x3_s2(nonneg=True) once either way."""
    model = detr.DETR(**{**TINY, "backbone_stage_sizes": (2, 3, 2, 2)}, **FUSED).eval()
    mask = torch.from_numpy(_pixel_mask(1, 64, 64, [(40, 64)])) if masked else None
    with torch.inference_mode():
        model(torch.zeros(1, 64, 64, 3), mask)
    expected = (0, 9) if masked else (5, 4)
    assert op_calls == {"max_pool_3x3_s2(nonneg=True)": 1,
                        "conv1x1_bn_residual_relu": expected[1],
                        "fused_bottleneck": expected[0]}


def test_unfused_stem_routes_through_the_nonneg_pool(op_calls):
    with torch.no_grad():
        detr.DETR(**TINY)(torch.zeros(1, 32, 32, 3))
    assert op_calls == {"max_pool_3x3_s2(nonneg=True)": 1, "conv1x1_bn_residual_relu": 0,
                        "fused_bottleneck": 0}


@pytest.mark.parametrize("flags", [dict(fuse_residual=True), dict(fuse_bottleneck=True)])
def test_fused_model_refuses_to_train(flags):
    """The fused kernels have no backward: Trainer refuses a fused model in
    its constructor, and a fused forward under autograd raises instead of
    falling back to the unfused chain."""
    model = detr.DETR(dropout=0.0, **TINY, **flags)
    with pytest.raises(ValueError, match="inference only"):
        Trainer(model, TrainingConfig(train_backbone=True))
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.zeros(1, 32, 32, 3))
    with torch.no_grad():
        assert torch.isfinite(model(torch.zeros(1, 32, 32, 3))["pred_boxes"]).all()


# ---- repaired faults: warmup, inference-mode builds, the bf16 fold ---------------------------


def test_warmup_warms_the_fused_route(op_calls):
    """Predictor.warmup runs each bucket with and without a pixel mask: a
    request that fills its bucket runs unmasked, and on a fused model only
    that route runs kernel E, so warmup must reach E too."""
    model = api.build_detr(device="cpu", **TINY, **FUSED)
    Predictor(model, background_class=TINY["num_classes"] - 1).warmup([(64, 64)])
    assert op_calls["fused_bottleneck"] > 0
    assert op_calls["conv1x1_bn_residual_relu"] > 0


@pytest.mark.parametrize("flags,forwards", [({}, 1), (dict(fuse_residual=True), 1),
                                           (FUSED, 2)])
def test_warmup_runs_the_unmasked_route_only_where_it_differs(flags, forwards):
    """Only ``fuse_bottleneck`` changes the kernels of an unmasked forward,
    so only such a model is warmed twice a bucket."""
    model = api.build_detr(device="cpu", **TINY, **flags)
    masks = []
    model.module.register_forward_hook(lambda m, args, out: masks.append(args[1] is not None))
    Predictor(model, background_class=TINY["num_classes"] - 1).warmup([(64, 64), (100, 64)])
    assert masks == [True, False][:forwards] * 2


@pytest.mark.parametrize("flags", [dict(fuse_residual=True), dict(fuse_bottleneck=True)])
def test_fused_model_built_under_inference_mode_runs(flags):
    """A fused model built inside torch.inference_mode (its parameters are
    inference tensors, which have no version counter) runs, and equals the
    unfused model built the same way: atol/rtol 1e-4, the fused fp32
    module tolerance above."""
    cfg = dict(backbone_stage_sizes=(2, 1, 1, 1), num_encoder_layers=1, num_decoder_layers=1,
               device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        fused, plain = api.build_detr(**cfg, **flags), api.build_detr(**cfg)
        assert fused.module.backbone.conv1.weight.is_inference()
        out, ref = fused(x), plain(x)
        again = fused(x)
    for key in ("pred_boxes", "pred_logits"):
        close(out[key], ref[key].numpy())
        assert torch.equal(again[key], out[key])


@pytest.mark.parametrize("flags", [dict(fuse_residual=True), dict(fuse_bottleneck=True)])
def test_fused_model_reloaded_under_inference_mode_folds_again(flags):
    """``load_state_dict`` inside inference mode writes the inference
    tensors in place (same data pointer, no version counter); the fused
    operands cached from the old weights are dropped, so the reloaded model
    equals the unfused model with the new weights (atol/rtol 1e-4). The new
    weights are another seed's, with random FrozenBN buffers (kernel D's
    cached operands are bn3's scale and shift)."""
    cfg = dict(backbone_stage_sizes=(2, 1, 1, 1), num_encoder_layers=1, num_decoder_layers=1,
               device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 64, 64, 3)).astype(np.float32))
    rng = np.random.default_rng(14)
    with torch.inference_mode():
        fused, plain = api.build_detr(**cfg, **flags), api.build_detr(**cfg, seed=5)
        first = fused(x)
        state = plain.module.state_dict()
        for name, t in state.items():
            if name.startswith("backbone.") and "bn" in name.split(".")[-2]:
                noise = torch.from_numpy(rng.uniform(0.5, 1.5, size=t.shape).astype(np.float32))
                state[name] = t * noise + (0 if name.endswith("running_var") else 0.1 * noise)
        plain.module.load_state_dict(state)
        fused.module.load_state_dict(state)
        assert fused.module.backbone.conv1.weight.is_inference()
        out, ref = fused(x), plain(x)
    for key in ("pred_boxes", "pred_logits"):
        close(out[key], ref[key].numpy())
        assert not torch.allclose(out[key], first[key], atol=1e-3)


def test_bf16_fused_block_folds_float32_weights_once():
    """The bf16 fused model keeps its backbone's conv weights in float32,
    and kernel E's operands of an identity block equal, bit for bit, the
    JAX fold_bn_params of the same float32 weights cast to bf16 once (one
    float32 multiply and one round-to-nearest cast on both sides). The
    seeded float32 weights come from the fp32 model of the same seed; the
    FrozenBN buffers are random. A fold of weights already rounded to bf16
    rounds twice and fails this test. The unfused convs read bf16 copies
    cached once, each in its own conv: a second forward casts nothing."""
    cfg = dict(backbone_stage_sizes=(3, 1, 1, 1), num_encoder_layers=1, num_decoder_layers=1,
               device="cpu", seed=3, **FUSED)
    fp32 = api.build_detr(**cfg).module.backbone.layer1.block_1
    model = api.build_detr(dtype="bfloat16", **cfg)
    block = model.module.backbone.layer1.block_1
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for bn in (block.bn1, block.bn2, block.bn3):
            n = bn.weight.numel()
            for buf, value in ((bn.weight, 1 + 0.1 * rng.normal(size=n)),
                               (bn.bias, 0.1 * rng.normal(size=n)),
                               (bn.running_mean, 0.1 * rng.normal(size=n)),
                               (bn.running_var, rng.uniform(0.5, 1.5, size=n))):
                buf.copy_(torch.from_numpy(value))
    ours = block._whole_block_operands(torch.bfloat16)
    expected = []
    for conv, bn in zip((fp32.conv1, fp32.conv2, fp32.conv3), (block.bn1, block.bn2, block.bn3)):
        assert conv.weight.dtype == torch.float32
        scale, shift = (t.detach().numpy() for t in bn.scale_shift())
        hwio = jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())
        w, b = jax_fb.fold_bn_params(hwio, jnp.asarray(scale), jnp.asarray(shift))
        expected += [np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32)), np.asarray(b)]
    m, c = expected[0].shape[-1], expected[4].shape[-1]
    expected[0], expected[2], expected[4] = (expected[0].reshape(c, m),
                                            expected[2].reshape(9, m, m), expected[4].reshape(m, c))
    for got, want in zip(ours, expected):
        assert got.dtype == (torch.bfloat16 if want.ndim > 1 else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)

    mask = torch.from_numpy(_pixel_mask(1, 64, 64, [(50, 37)]))
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(1, 64, 64, 3)).astype(np.float32))
    model(x, mask)
    convs = (block.conv1, block.conv2, block.conv3)
    casts = [conv._cache[("cast", "weight", torch.bfloat16)][1] for conv in convs]
    assert all(t.dtype == torch.bfloat16 for t in casts)
    model(x, mask)
    assert all(conv._cache[("cast", "weight", torch.bfloat16)][1] is t
               for conv, t in zip(convs, casts))
