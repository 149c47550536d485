"""The port's attention (detr_tensorflow_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against its XLA reference.

On the CPU the port's ``mha`` runs its plain version; the CUDA kernel is
checked against that plain version on the card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detr_tensorflow_tpu.ops.pallas import flash_attention as jax_fa
from detr_tensorflow_tpu_torch.models.transformer import MultiHeadAttention
from detr_tensorflow_tpu_torch.ops import flash_attention as fa
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# fp32 tolerance of the JAX kernel's own test (tests/test_pallas_attention.py).
ATOL, RTOL = 2e-5, 1e-4


def _inputs(seed, b, lq, lk, h, dh, masked):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, lq, h, dh)) * dh**-0.5).astype(np.float32)
    k = rng.normal(size=(b, lk, h, dh)).astype(np.float32)
    v = rng.normal(size=(b, lk, h, dh)).astype(np.float32)
    mask = None
    if masked:
        # Row 0 keeps every key; the others keep a ragged prefix, one of
        # them about half.
        valid = rng.integers(1, lk + 1, size=b)
        valid[0], valid[-1] = lk, max(1, lk // 2 + 1)
        mask = np.arange(lk)[None, :] >= valid[:, None]  # True = padded
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lq,lk", [(100, 37), (20, 130), (64, 64)])
def test_mha_matches_jax_kernel(lq, lk, masked):
    q, k, v, mask = _inputs(lq * 1000 + lk, 3, lq, lk, 2, 32, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    jax_kernel = jax_fa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            key_padding_mask=jmask, interpret=True)
    jax_ref = jax_fa.reference_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask)
    tmask = None if mask is None else torch.from_numpy(mask)
    ours = fa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tmask)
    assert ours.shape == (3, lq, 2, 32) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_kernel), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_ref), atol=ATOL, rtol=RTOL)


def test_mha_bf16_matches_jax_reference():
    """bf16 in, bf16 out; P rounded to bf16 before PV in both. Tolerance:
    a few bf16 ulps of values of order 1 (2**-8 relative each)."""
    q, k, v, mask = _inputs(7, 2, 50, 70, 2, 32, True)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = jax_fa.reference_mha(*bf, jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)).bfloat16() for x in bf)
    ours = fa.mha(tq, tk, tv, torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,rate,head_dim,route", [
    (torch.bfloat16, 0.0, 32, "mma"), (torch.bfloat16, 0.0, 64, "mma"),
    (torch.bfloat16, 0.1, 32, "mma"), (torch.float32, 0.0, 32, "tf32"),
    (torch.float32, 0.1, 64, "tf32"), (torch.bfloat16, 0.0, 16, "simt"),
    (torch.float32, 0.1, 32, "tf32"), (torch.float32, 0.0, 64, "tf32"),
    (torch.bfloat16, 0.1, 64, "mma"), (torch.float32, 0.0, 16, "simt")])
def test_forward_route(dtype, rate, head_dim, route):
    """A CUDA call's forward kernel depends on dtype and head dim alone: the
    3xTF32 tensor-core kernel for fp32, the bf16 tensor-core kernel for
    bf16, each at any dropout rate; the SIMT kernel on no route (a head dim
    of 16 is refused by ``mha`` before routing)."""
    assert fa.forward_route(dtype, rate, head_dim) == route


@pytest.mark.parametrize("batch_heads,lq,shape", [
    (16, 1232, (4, 1)), (8, 1232, (4, 1)), (8, 1050, (4, 1)), (8, 100, (1, 4)),
    (16, 100, (1, 4)), (16, 320, (4, 1)), (8, 320, (1, 4)), (64, 252, (4, 1)),
    (64, 100, (4, 1)), (32, 100, (1, 4)), (33, 100, (4, 1)), (64, 1232, (4, 1))])
def test_cta_shape(batch_heads, lq, shape):
    """The tensor-core forwards' CTA shape (row groups of 16 queries, warps
    on each row group's keys) on a 132-SM card: 64 rows a CTA when those
    CTAs number at least 66 (every encoder shape served at b1, B=2 and b8,
    160, 320 and 1280 CTAs; (320, 320) at B=2, 80; the b8 training step's three
    shapes, the 100 decoder queries' 128 included), else one row group with
    its keys split 4 ways (the 100 decoder queries served at b1 and B=2, 16
    and 32 CTAs; (320, 320) at b1, 40)."""
    assert fa.cta_shape(batch_heads, lq, 132) == shape
    assert shape in fa.MMA_SHAPES


def test_cpu_call_takes_the_plain_version_on_either_route():
    """On CPU tensors both routes' dtypes take ``reference_mha`` and launch
    nothing."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 8, 9, 2, 32, True))
    before = (fa.mha.launches, fa.mha.mma_launches, fa.mha.tf32_launches)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, k, v)]
        torch.testing.assert_close(fa.mha(*args, mask), fa.reference_mha(*args, mask),
                                   rtol=0, atol=0)
    assert (fa.mha.launches, fa.mha.mma_launches, fa.mha.tf32_launches) == before


@pytest.mark.parametrize("case", ["dropout", "head_dim", "dtype", "shape", "mask_dtype",
                                  "mask_shape", "device"])
def test_mha_rejects_what_the_kernel_does_not_take(case):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 9, 2, 32, True))
    kwargs = {"key_padding_mask": mask}
    expected = ValueError
    if case == "dropout":
        # Dropout without a seed: the mask would have no source.
        kwargs["dropout_rate"] = 0.1
    elif case == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif case == "dtype":
        q, k, v, expected = q.half(), k.half(), v.half(), TypeError
    elif case == "shape":
        k = k[:, :, :1]
    elif case == "mask_dtype":
        kwargs["key_padding_mask"], expected = mask.float(), TypeError
    elif case == "mask_shape":
        kwargs["key_padding_mask"] = mask[:, :-1]
    elif case == "device":
        # Neither CPU nor CUDA: there is no kernel and no fallback.
        q, k, v = (t.to("meta") for t in (q, k, v))
        kwargs["key_padding_mask"] = mask.to("meta")
    with pytest.raises(expected):
        fa.mha(q, k, v, **kwargs)


@pytest.mark.parametrize("masked", [False, True])
def test_model_attention_kernel_route_equals_plain(masked):
    """MultiHeadAttention: attn_impl="kernel" (here the kernel's plain
    version, -1e30 bias) equals "plain" (materialised, -1e9 fill)."""
    rng = np.random.default_rng(3)
    query = torch.from_numpy(rng.normal(size=(2, 12, 64)).astype(np.float32))
    key = torch.from_numpy(rng.normal(size=(2, 40, 64)).astype(np.float32))
    mask = torch.from_numpy(np.arange(40)[None] >= np.array([[40], [17]])) if masked else None
    torch.manual_seed(0)
    plain = MultiHeadAttention(64, 2, "plain")
    kernel = MultiHeadAttention(64, 2, "kernel")
    kernel.load_state_dict(plain.state_dict())
    with torch.no_grad():
        a = plain(query, key, key, mask)
        b = kernel(query, key, key, mask)
        _, weights = kernel(query, key, key, mask, return_weights=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL, rtol=RTOL)
    assert weights.shape == (2, 12, 40)
    if masked:
        assert float(weights[1, :, 17:].abs().max()) == 0.0


@pytest.mark.parametrize("dropout_case", ["rate_above_one", "int32_seed"])
def test_mha_rejects_bad_dropout_arguments(dropout_case):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 9, 2, 32, True))
    rate, seed = 0.1, torch.tensor([3])
    if dropout_case == "rate_above_one":
        rate = 1.0
    else:
        seed = seed.int()
    with pytest.raises(ValueError):
        fa.mha(q, k, v, mask, dropout_rate=rate, dropout_seed=seed)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lq,lk", [(24, 40), (40, 40)])
def test_mha_gradients_match_jax_kernel(lq, lk, masked):
    """dQ, dK, dV of the port's attention (plain version under autograd on
    the CPU) against jax.grad through the Pallas kernel's custom VJP in
    interpret mode, for the same output cotangent. No row is fully
    padded: there the TPU kernel spreads over its 128-padded keys."""
    q, k, v, mask = _inputs(lq * 7 + lk, 2, lq, lk, 2, 32, masked)
    g = np.random.default_rng(lq).normal(size=q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_fa.mha(q_, k_, v_, key_padding_mask=jmask, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.mha(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    for ours, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_philox_known_answers():
    """The PyTorch Philox4x32-10 reproduces Random123's known-answer vectors
    (the CUDA kernels' generator is held against it on the card)."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        words = fa.philox4x32_10(*(torch.tensor(x) for x in ctr + key))
        assert tuple(int(w) for w in words) == want


def test_dropout_keep_rate_and_replay_on_cpu():
    """keep_mask at the training shape keeps 0.9 of the weights within 5
    sigma, is a pure function of the seed, and differs between seeds; the
    CPU mha with dropout equals the plain version given that mask."""
    seed = torch.tensor([2024])
    keep = fa.keep_mask(seed, 64, 100, 252, 0.1)
    n = keep.numel()
    assert abs(float(keep.float().mean()) - 0.9) <= 5 * (0.09 / n) ** 0.5
    assert torch.equal(keep, fa.keep_mask(seed.clone(), 64, 100, 252, 0.1))
    assert not torch.equal(keep, fa.keep_mask(seed + 1, 64, 100, 252, 0.1))
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(5, 2, 30, 50, 2, 32, True))
    ours = fa.mha(q, k, v, mask, dropout_rate=0.1, dropout_seed=seed)
    keep = fa.keep_mask(seed, 4, 30, 50, 0.1).view(2, 2, 30, 50)
    ref = fa.reference_mha(q, k, v, mask, keep, 0.1)
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)
    assert not torch.allclose(ours, fa.mha(q, k, v, mask))


def test_model_attention_dropout_routes_agree():
    """In training, "kernel" and "plain" attention draw the same seed from
    the same generator and the same Philox mask, so they agree."""
    rng = np.random.default_rng(8)
    query = torch.from_numpy(rng.normal(size=(2, 12, 64)).astype(np.float32))
    torch.manual_seed(0)
    plain = MultiHeadAttention(64, 2, "plain", dropout=0.1)
    kernel = MultiHeadAttention(64, 2, "kernel", dropout=0.1)
    kernel.load_state_dict(plain.state_dict())
    a = plain(query, query, query, train=True, generator=torch.Generator().manual_seed(5))
    b = kernel(query, query, query, train=True, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    assert not torch.allclose(a, plain(query, query, query))
    with pytest.raises(ValueError, match="Generator"):
        plain(query, query, query, train=True)


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.float32, 32, "mma"), (torch.float32, 64, "mma"), (torch.bfloat16, 32, "bf16"),
    (torch.bfloat16, 64, "bf16"), (torch.float32, 16, "simt")])
def test_backward_route(dtype, head_dim, route):
    """A CUDA call's backward kernel depends on dtype and head dim alone: the
    tensor-core kernel (3xTF32) for fp32, the bf16 tensor-core kernel for
    bf16 (a head dim of 16 is refused by ``mha`` before routing)."""
    assert fa.backward_route(dtype, head_dim) == route


def _tf32(x):
    """x rounded to TF32 as ``tf32mma::to_tf32`` (csrc/tf32_mma.cuh)
    and ``cvt.rna.tf32.f32`` do: 10 mantissa bits, to nearest, ties away
    from zero (on the magnitude bits of float32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product_errors(a, b):
    """Largest error of a @ b, as 3xTF32 and as one TF32 product (fp32
    accumulation, as the tensor cores), relative to the largest float64
    value."""
    exact = a.astype(np.float64) @ b.astype(np.float64)
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    three = a_small @ b_big + a_big @ b_small + a_big @ b_big
    one = a_big @ b_big
    scale = np.abs(exact).max()
    return (float(np.abs(three - exact).max() / scale),
            float(np.abs(one - exact).max() / scale))


def test_3xtf32_products_are_fp32_accurate():
    """The accuracy argument of csrc/flash_attention_bwd_mma.cu, emulated in
    numpy at DETR's encoder shape (252 queries and keys, Dh 32): dQ = dS K
    and dK = dS^T Q from 3xTF32 products lie within 1e-5 of their largest
    float64 value, and single-TF32 products at least 100 times further off.
    dS is the attention backward's, from seeded inputs."""
    rng = np.random.default_rng(252)
    lq = lk = 252
    q = (rng.normal(size=(lq, 32)) * 32**-0.5).astype(np.float32)
    k, v = rng.normal(size=(2, lk, 32)).astype(np.float32)
    dout = rng.normal(size=(lq, 32)).astype(np.float32)
    s = q.astype(np.float64) @ k.T
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    dp = dout.astype(np.float64) @ v.T
    ds = (p * (dp - (p * dp).sum(axis=1, keepdims=True))).astype(np.float32)
    # A tie (half of TF32's last place above 1) rounds away from zero.
    assert _tf32(np.float32([1 + 2**-11, -1 - 2**-11])).tolist() == [1 + 2**-10, -1 - 2**-10]
    for a, b in ((ds, k), (ds.T.copy(), q)):  # dQ, then dK
        three, one = _product_errors(a, b)
        assert three <= 1e-5
        assert one >= 100 * three


def _tf32_forward(q, k, v, bias, keep=None, rate=0.0, single=False):
    """numpy emulation of csrc/flash_attention_fwd_tf32.cu on (BH, L, Dh)
    float32 arrays with a (BH, Lk) additive bias: 64-key tiles, the online
    row max and sum with rescale, S = Q K^T and O += (P o M) V as 3xTF32
    (big x big apart from the cross terms; ``single``: one TF32 product),
    S's big x big summed per 8 head dims and each 16 keys' PV products
    summed apart, each added in fp32. ``keep`` is a (BH, Lq, Lk) bool mask;
    the row sum takes every key."""
    f32 = np.float32

    def product(a, b, step):  # a @ b at fp32, from TF32 parts
        a_big, b_big = _tf32(a), _tf32(b)
        if single:
            return a_big @ b_big
        big = sum(a_big[..., i:i + step] @ b_big[..., i:i + step, :]
                  for i in range(0, a.shape[-1], step))
        return big + (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big))

    bh, lq, dh = q.shape
    lk = k.shape[1]
    o = np.zeros((bh, lq, dh), f32)
    m = np.full((bh, lq, 1), -np.inf, f32)
    l = np.zeros((bh, lq, 1), f32)
    scale = f32(1.0 / (1.0 - rate)) if rate else f32(1.0)
    for k0 in range(0, lk, 64):
        kt, vt = k[:, k0:k0 + 64], v[:, k0:k0 + 64]
        s = product(q, kt.transpose(0, 2, 1), 8) + bias[:, None, k0:k0 + 64]
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new)
        l = l * alpha + p.sum(axis=-1, keepdims=True)
        o, m = o * alpha, m_new
        if keep is not None:
            p = p * np.where(keep[:, :, k0:k0 + 64], scale, f32(0))
        for j in range(0, kt.shape[1], 16):
            o = o + product(p[:, :, j:j + 16], vt[:, j:j + 16], 16)
    return o / l


def _heads(x):
    """(B, L, H, Dh) -> (B * H, L, Dh)."""
    b, l, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, l, d))


def _emulation_case(lq, lk, masked):
    """Inputs at b2 h2 Dh 32; masked: batch element 1 has every key padded,
    element 0 a ragged tail."""
    q, k, v, _ = _inputs(lq * 3 + lk, 2, lq, lk, 2, 32, False)
    mask = np.zeros((2, lk), bool)
    if masked:
        mask[0, lk - lk // 3:] = True
        mask[1] = True
    bias = np.repeat(np.where(mask, np.float32(-1e30), np.float32(0)), 2, axis=0)
    return q, k, v, mask, bias


@pytest.mark.parametrize("lq,lk,masked", [(252, 252, False), (100, 37, True)])
def test_tf32_forward_emulation_is_fp32_accurate(lq, lk, masked):
    """The algorithm of csrc/flash_attention_fwd_tf32.cu, emulated in numpy:
    within 1e-5 of the largest output of float64 attention, single-TF32
    products at least 100 times further off; and within 1e-5 of the JAX
    package's kernel (Pallas, interpret mode) at dropout 0. A batch element
    whose keys are all padded gets the uniform softmax of float64; the JAX
    kernel spreads it over its 128-padded keys instead, so that element is
    left out of the JAX comparison."""
    q, k, v, mask, bias = _emulation_case(lq, lk, masked)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    s = qh.astype(np.float64) @ kh.transpose(0, 2, 1) + bias[:, None, :]
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    exact = (p / p.sum(axis=-1, keepdims=True)) @ vh
    scale = np.abs(exact).max()
    three = np.abs(_tf32_forward(qh, kh, vh, bias) - exact).max() / scale
    one = np.abs(_tf32_forward(qh, kh, vh, bias, single=True) - exact).max() / scale
    assert three <= 1e-5
    assert one >= 100 * three
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(jax_fa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                key_padding_mask=jmask, interpret=True))
    ours = _tf32_forward(qh, kh, vh, bias).reshape(2, 2, lq, 32).transpose(0, 2, 1, 3)
    rows = slice(0, 1) if masked else slice(None)
    np.testing.assert_allclose(ours[rows], ref[rows], atol=1e-5, rtol=0)


def test_tf32_forward_emulation_dropout_matches_plain():
    """At dropout 0.1 the emulation, given ``keep_mask``'s bits, agrees with
    the port's plain version given the same mask within 1e-5, the fully
    padded element included."""
    q, k, v, mask, bias = _emulation_case(100, 37, True)
    seed = torch.tensor([99])
    keep = fa.keep_mask(seed, 4, 100, 37, 0.1)
    ours = _tf32_forward(_heads(q), _heads(k), _heads(v), bias, keep.numpy(), 0.1)
    ref = fa.reference_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
                           keep.view(2, 2, 100, 37), 0.1)
    ref = ref.numpy().transpose(0, 2, 1, 3).reshape(4, 100, 32)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def _bf16(x):
    """float32 values rounded to bf16 (to nearest even), kept as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _chunked(a, b):
    """a @ b over (BH, M, K) x (BH, K, N) float32, as the kernel's MMAs sum:
    each 16-deep slice of K summed, then added to the running sum in fp32
    (the tensor cores truncate that add, 2**-23 of the sum, far below the
    outputs' bf16 rounding)."""
    out = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for j in range(0, a.shape[2], 16):
        out += a[:, :, j:j + 16] @ b[:, j:j + 16]
    return out


def _bf16_backward(q, k, v, dout, bias, lse, keep=None, rate=0.0, delta=None):
    """numpy emulation of csrc/flash_attention_bwd_bf16.cu on (BH, L, Dh)
    float32 arrays holding bf16 values, a (BH, Lk) additive bias and the
    forward's (BH, Lq, 1) float32 lse: S and dP in fp32 (products of bf16
    values are exact in fp32), p = exp(s + bias - lse) (1 / Lk on a fully
    padded row), delta = sum_j p m dP in fp32 unless ``delta`` is given,
    p m and dS rounded to bf16 at the TPU kernel's points (dS 0 on padded
    keys), dV, dK and dQ summed 16 deep a step and rounded to bf16 once.
    ``keep`` is a (BH, Lq, Lk) bool mask. Returns ([dq, dk, dv], dS before
    its rounding, p m dP)."""
    f32 = np.float32
    lk = k.shape[1]
    s = q @ k.transpose(0, 2, 1)
    p = np.where(lse <= f32(-5e29), f32(1.0 / lk), np.exp(s + bias[:, None, :] - lse)).astype(f32)
    m = np.ones_like(p) if keep is None else np.where(keep, f32(1.0 / (1.0 - rate)), f32(0))
    dp = dout @ v.transpose(0, 2, 1)
    terms = (p * m) * dp
    if delta is None:
        delta = terms.sum(axis=-1, keepdims=True, dtype=f32)
    ds = np.where(bias[:, None, :] != 0, f32(0), p * (m * dp - delta)).astype(f32)
    pm_low, ds_low = _bf16(p * m), _bf16(ds)
    grads = (_chunked(ds_low, k), _chunked(np.ascontiguousarray(ds_low.transpose(0, 2, 1)), q),
             _chunked(np.ascontiguousarray(pm_low.transpose(0, 2, 1)), dout))
    return [_bf16(g) for g in grads], ds, terms


def _unheads(x, b):
    """(B * H, L, Dh) -> (B, L, H, Dh)."""
    bh, l, d = x.shape
    return x.reshape(b, bh // b, l, d).transpose(0, 2, 1, 3)


def _lse(q, k, bias):
    """The forward's row log-sum-exp, float64 rounded to float32, (BH, Lq, 1)."""
    s = q.astype(np.float64) @ k.transpose(0, 2, 1).astype(np.float64) + bias[:, None, :]
    top = s.max(axis=-1, keepdims=True)
    return (top + np.log(np.exp(s - top).sum(axis=-1, keepdims=True))).astype(np.float32)


def _rel(x, exact):
    return float(np.linalg.norm(x - exact) / np.linalg.norm(exact))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lq,lk", [(24, 40), (40, 40)])
def test_bf16_backward_emulation_matches_jax_and_float64(lq, lk, masked, rate):
    """The arithmetic of csrc/flash_attention_bwd_bf16.cu, emulated in numpy
    on bf16 inputs, against float64 autograd of the plain version on the
    same bf16 values and keep mask: each of dq, dk, dv no further from it,
    in relative L2 distance, than TENSOR_GAP_FACTOR (3, as
    tests/test_torch_bf16.py holds a bf16 gradient per tensor) times the
    distance of ``jax.grad`` through the JAX package's kernel (custom VJP,
    Pallas in interpret mode) at bf16 without dropout. At dropout 0 the
    emulation also agrees with JAX's bf16 gradients within 4 bf16 ulps of
    the largest value (2**-6 relative): the two round at the same points
    but take delta differently (JAX from O recomputed from the rounded p).
    In interpret mode Pallas's random bits are zeros, so JAX's gradients
    are not taken with dropout; there the emulation gets ``keep_mask``'s
    bits and JAX's dropout-0 distance stays the yardstick. No row is fully
    padded: there the JAX kernel spreads over its 128-padded keys."""
    tensor_gap_factor = 3.0
    q, k, v, mask = _inputs(lq * 7 + lk, 2, lq, lk, 2, 32, masked)
    g = np.random.default_rng(lq).normal(size=q.shape).astype(np.float32)
    q, k, v, g = (_bf16(x) for x in (q, k, v, g))
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_fa.mha(q_, k_, v_, key_padding_mask=jmask, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert all(x.dtype == jnp.bfloat16 for x in jgrads)
    jgrads = [np.asarray(x, np.float32) for x in jgrads]

    seed = torch.tensor([lq * 13 + lk])
    keep = fa.keep_mask(seed, 4, lq, lk, rate) if rate else None
    tmask = None if mask is None else torch.from_numpy(mask)
    exact = {}
    for key, keep_ in (("jax", None), ("ours", keep)):
        t64 = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
        out = fa.reference_mha(*t64, tmask, None if keep_ is None else keep_.view(2, 2, lq, lk),
                               rate)
        out.backward(torch.from_numpy(g).double())
        exact[key] = [t.grad.numpy() for t in t64]

    bias = np.zeros((4, lk), np.float32)
    if masked:
        bias = np.repeat(np.where(mask, np.float32(-1e30), np.float32(0)), 2, axis=0)
    qh, kh = _heads(q), _heads(k)
    ours, _, _ = _bf16_backward(qh, kh, _heads(v), _heads(g), bias, _lse(qh, kh, bias),
                                None if keep is None else keep.numpy(), rate)
    for name, x, j, e_ours, e_jax in zip(("dq", "dk", "dv"), ours, jgrads, exact["ours"],
                                         exact["jax"]):
        x = _unheads(x, 2)
        assert _rel(x, e_ours) <= tensor_gap_factor * _rel(j, e_jax), name
        if not rate:
            assert np.abs(x - j).max() <= 2**-6 * np.abs(j).max(), name


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_emulation_ds_rows_sum_to_zero(rate):
    """On keys and values with a large common component, as DETR's
    cross-attention keys (memory + pos), the emulation's dS rows (before
    their bf16 rounding) sum to zero to fp32 precision: within 2**-20 of
    the largest row's sum of |p m dP|, the terms whose cancellation leaves
    them. delta is the kernel's fp32 sum of p m dP over the keys; taken as
    rowsum(dO * O) from the bf16 O, the rows miss zero by over 100 times
    as much."""
    rng = np.random.default_rng(17)
    b, h, lq, lk, dh = 2, 2, 40, 72, 32
    q = _bf16(rng.normal(size=(b * h, lq, dh)) * dh**-0.5)
    k = _bf16(2.0 + rng.normal(size=(b * h, lk, dh)))
    v = _bf16(4.0 + rng.normal(size=(b * h, lk, dh)))
    dout = _bf16(rng.normal(size=(b * h, lq, dh)))
    bias = np.zeros((b * h, lk), np.float32)
    bias[:2, 60:] = np.float32(-1e30)
    lse = _lse(q, k, bias)
    keep = fa.keep_mask(torch.tensor([5]), b * h, lq, lk, rate).numpy() if rate else None
    _, ds, terms = _bf16_backward(q, k, v, dout, bias, lse, keep, rate)
    scale = float(np.abs(terms).sum(axis=-1).max())
    ours = float(np.abs(ds.sum(axis=-1)).max())
    assert ours <= 2**-20 * scale
    # O from the same p, m and v in float64, then rounded to bf16.
    s = q.astype(np.float64) @ k.transpose(0, 2, 1) + bias[:, None, :]
    p = np.exp(s - lse)
    m = 1.0 if keep is None else np.where(keep, 1.0 / (1.0 - rate), 0.0)
    out = _bf16(((p * m) @ v).astype(np.float32))
    delta = (dout * out).sum(axis=-1, keepdims=True, dtype=np.float32)
    _, ds_out, _ = _bf16_backward(q, k, v, dout, bias, lse, keep, rate, delta=delta)
    assert float(np.abs(ds_out.sum(axis=-1)).max()) >= 100 * ours


_LOG2E = np.float32(1.4426950408889634)


def _mma_forward(q, k, v, bias, keep=None, rate=0.0, split=1):
    """numpy emulation of csrc/flash_attention_fwd_mma.cu on (BH, L, Dh)
    float32 arrays holding bf16 values and a (BH, Lk) additive bias, at the
    CTA shape (4, 1) (``split`` 1) or (1, 4) (``split`` 4: each of four
    warps takes 16 keys of every 64-key tile with a running max and sum of
    its own, merged at the end). Scores in fp32 (products of bf16 values are
    exact in fp32), keys past Lk at -inf; p = exp2((s - max) log2 e) left
    unnormalised; the row sum takes p before dropout; p times the keep
    factor (``keep``, a (BH, Lq, Lk) bool mask) in fp32, rounded to bf16
    for PV, summed in fp32; O and the sum rescaled a tile; O times 1 / sum
    rounded to bf16 at the end. Returns (out, lse) with lse = max + log sum,
    (BH, Lq, 1)."""
    f32 = np.float32
    bh, lq, dh = q.shape
    lk = k.shape[1]
    tiles = -(-lk // 64)
    pad = ((0, 0), (0, tiles * 64 - lk), (0, 0))
    k, v = np.pad(k, pad), np.pad(v, pad)
    bias = np.pad(bias, ((0, 0), (0, tiles * 64 - lk)), constant_values=-np.inf)
    factor = np.ones((bh, lq, tiles * 64), f32)
    if keep is not None:
        factor[:, :, :lk] = np.where(keep, f32(1.0 / (1.0 - rate)), f32(0))
    width = 64 // split
    shares = []
    for part in range(split):
        o = np.zeros((bh, lq, dh), f32)
        m = np.full((bh, lq, 1), -np.inf, f32)
        l = np.zeros((bh, lq, 1), f32)
        for tile in range(tiles):
            cols = slice(tile * 64 + part * width, tile * 64 + (part + 1) * width)
            s = q @ k[:, cols].transpose(0, 2, 1) + bias[:, None, cols]
            mx = np.maximum(m, s.max(axis=-1, keepdims=True))
            mn = np.where(mx == -np.inf, f32(0), mx)
            alpha = np.exp2((m - mn) * _LOG2E)
            p = np.exp2((s - mn) * _LOG2E)
            l = l * alpha + p.sum(axis=-1, keepdims=True, dtype=f32)
            m = mx
            o = o * alpha + _bf16(p * factor[:, :, cols]) @ v[:, cols]
        shares.append((o, m, l))
    o, m, l = shares[0]
    for o_, m_, l_ in shares[1:]:  # the first share holds key 0: its max is finite
        mx = np.maximum(m, m_)
        a, c = np.exp2((m - mx) * _LOG2E), np.exp2((m_ - mx) * _LOG2E)
        o, l, m = o * a + o_ * c, l * a + l_ * c, mx
    return _bf16(o * (f32(1) / l)), m + np.log(l)


# (Lq, Lk, case): "full" keeps every key; "ragged" pads a different tail of
# each batch element's keys; "padded" pads every key of batch element 1 (a
# uniform softmax) and a tail of element 0's.
_MMA_CASES = [(252, 252, "full"), (100, 37, "ragged"), (40, 70, "padded")]


def _mma_case(lq, lk, case):
    """bf16 values (as float32) at b2 h2 Dh 32, the (B, Lk) key-padding mask
    (None for "full") and the kernel's (B * H, Lk) bias."""
    q, k, v, _ = _inputs(lq * 5 + lk, 2, lq, lk, 2, 32, False)
    q, k, v = (_bf16(x) for x in (q, k, v))
    mask = np.zeros((2, lk), bool)
    if case == "ragged":
        mask[0, lk - lk // 3:] = True
        mask[1, lk // 2:] = True
    elif case == "padded":
        mask[0, lk - lk // 4:] = True
        mask[1] = True
    bias = np.repeat(np.where(mask, np.float32(-1e30), np.float32(0)), 2, axis=0)
    return q, k, v, (mask if case != "full" else None), bias


def _float64_attention(q, k, v, bias, keep=None, rate=0.0):
    """Softmax attention in float64 on (BH, L, Dh) arrays, with the keep
    mask's multipliers: (out, lse)."""
    s = q.astype(np.float64) @ k.transpose(0, 2, 1).astype(np.float64) + bias[:, None, :]
    top = s.max(axis=-1, keepdims=True)
    e = np.exp(s - top)
    p = e / e.sum(axis=-1, keepdims=True)
    if keep is not None:
        p = p * np.where(keep, 1.0 / (1.0 - rate), 0.0)
    return p @ v.astype(np.float64), top + np.log(e.sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("lq,lk,case", _MMA_CASES)
def test_mma_forward_emulation_matches_jax_kernel(lq, lk, case):
    """At dropout 0, the emulation of A-mma at both CTA shapes agrees with
    the JAX package's kernel (Pallas, interpret mode) on the same bf16
    inputs within 4 bf16 ulps of the largest output (2**-6 relative): both
    round P to bf16 before PV, the JAX kernel after normalising it, A-mma
    before. A batch element whose keys are all padded is left out: the JAX
    kernel spreads it over its 128-padded keys."""
    q, k, v, mask, bias = _mma_case(lq, lk, case)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_fa.mha(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), key_padding_mask=jmask,
                     interpret=True)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    rows = slice(0, 1) if case == "padded" else slice(None)
    for split in (1, 4):
        ours, _ = _mma_forward(_heads(q), _heads(k), _heads(v), bias, split=split)
        ours = _unheads(ours, 2)
        tol = 2**-6 * np.abs(ref[rows]).max()
        np.testing.assert_allclose(ours[rows], ref[rows], atol=tol, rtol=0)


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("lq,lk,case", _MMA_CASES)
def test_mma_forward_emulation_dropout_matches_plain(lq, lk, case, split):
    """At dropout 0.1, the emulation given ``keep_mask``'s bits agrees with
    the port's plain version (``reference_mha`` on the same bf16 tensors,
    given the same mask) within 4 bf16 ulps of the largest output (2**-6
    relative), the fully padded element included: plain normalises and
    drops before rounding P to bf16, the kernel drops, rounds and divides
    by the row sum at the end. (Interpret mode's random bits are zeros, so
    the JAX kernel is not taken with dropout.)"""
    q, k, v, mask, bias = _mma_case(lq, lk, case)
    keep = fa.keep_mask(torch.tensor([lq * 11 + lk]), 4, lq, lk, 0.1)
    ours, _ = _mma_forward(_heads(q), _heads(k), _heads(v), bias, keep.numpy(), 0.1, split)
    ref = fa.reference_mha(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                           None if mask is None else torch.from_numpy(mask),
                           keep.view(2, 2, lq, lk), 0.1)
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    np.testing.assert_allclose(_unheads(ours, 2), ref, atol=2**-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk,case", _MMA_CASES)
def test_mma_forward_emulation_is_near_float64(lq, lk, case, rate):
    """Against float64 attention on the same bf16 values and keep mask, the
    emulation at both CTA shapes is no further off, in the largest error
    relative to the largest output, than 1.5 times the plain bf16 version
    (``reference_mha``, which rounds P once, normalised) and than 2**-8
    (one bf16 ulp at 1); its lse, taken before dropout, is within 1e-5 of
    float64's on every row that keeps a key and below -1e29 on a fully
    padded one."""
    q, k, v, mask, bias = _mma_case(lq, lk, case)
    keep = fa.keep_mask(torch.tensor([lq * 13 + lk]), 4, lq, lk, rate) if rate else None
    keep_np = None if keep is None else keep.numpy()
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    exact, exact_lse = _float64_attention(qh, kh, vh, bias, keep_np, rate)
    plain = fa.reference_mha(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                             None if mask is None else torch.from_numpy(mask),
                             None if keep is None else keep.view(2, 2, lq, lk), rate)
    scale = np.abs(exact).max()
    plain_err = np.abs(_heads(plain.float().numpy()) - exact).max() / scale
    valid = (bias > -1e29).any(axis=-1)
    for split in (1, 4):
        ours, lse = _mma_forward(qh, kh, vh, bias, keep_np, rate, split)
        err = np.abs(ours - exact).max() / scale
        assert err <= min(1.5 * plain_err, 2**-8), (split, err, plain_err)
        np.testing.assert_allclose(lse[valid], exact_lse[valid], atol=1e-5, rtol=0)
        assert (lse[~valid] < -1e29).all()
