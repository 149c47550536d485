"""The port's attention (detr_tensorflow_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against its XLA reference.

On the CPU the port's ``mha`` runs its plain version; the CUDA kernel is
checked against that plain version on the card by tests/test_torch_cuda.py
and by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detr_tensorflow_tpu.ops.pallas import flash_attention as jax_fa
from detr_tensorflow_tpu_torch.models.transformer import MultiHeadAttention
from detr_tensorflow_tpu_torch.ops import flash_attention as fa

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


@pytest.mark.parametrize("case", ["dropout", "head_dim", "dtype", "shape", "mask_dtype",
                                  "mask_shape", "device"])
def test_mha_rejects_what_the_kernel_does_not_take(case):
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 9, 2, 32, True))
    kwargs = {"key_padding_mask": mask}
    expected = ValueError
    if case == "dropout":
        kwargs["dropout_rate"], expected = 0.1, NotImplementedError
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
