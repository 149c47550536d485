"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.models import api, quantized
from detr_tensorflow_tpu_torch.ops import flash_attention as fa
from detr_tensorflow_tpu_torch.ops import fused_bottleneck, fused_residual, int8_conv, int8_matmul
from detr_tensorflow_tpu_torch.ops import lap, maxpool
from test_torch_int8_conv_plan import G_PATH_SHAPES
from test_torch_int8_plan import F_PATH_SHAPES

# B's wide problems and the JPEG sets, shared with chip_smoke.py.
_spec = importlib.util.spec_from_file_location(
    "smoke_inputs", Path(__file__).resolve().parents[1] / "scripts" / "smoke_inputs.py")
smoke_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, b, lq, lk, h, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v = rng.normal(size=(2, b, lk, h, dh))
    valid = np.maximum(1, np.array([lk, lk // 2 + 1] * b)[:b] - np.arange(b))
    mask = np.arange(lk)[None, :] >= valid[:, None]
    to = lambda x: torch.from_numpy(x).to(device, dtype)  # noqa: E731
    return to(q), to(k), to(v), torch.from_numpy(mask).to(device)


# fp32: summation order only. bf16: P is rounded to bf16 before PV on
# both sides but normalised at different points (a few bf16 ulps).
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,lq,lk,dh", [(2, 1232, 1232, 32), (2, 100, 1232, 32),
                                         (1, 100, 100, 32), (3, 37, 5, 32),
                                         (2, 130, 300, 64)])
def test_attention_kernel_matches_plain(cuda_device, b, lq, lk, dh, dtype, atol):
    q, k, v, mask = _inputs(cuda_device, dtype, b, lq, lk, 8, dh, seed=lq + lk)
    before = _forward_counts()
    out = fa.mha(q, k, v, mask)
    unmasked = fa.mha(q, k, v)
    torch.cuda.synchronize()
    # fp32 runs the 3xTF32 tensor-core kernel, bf16 without dropout the bf16
    # one; neither the SIMT kernel.
    mma = dtype == torch.bfloat16
    assert _forward_counts(before) == (0, 2 * mma, 2 * (not mma))
    assert out.dtype == dtype and out.shape == q.shape
    for got, m in ((out, mask), (unmasked, None)):
        ref = fa.reference_mha(q, k, v, m)
        assert float((got.float() - ref.float()).abs().max()) <= atol


def _forward_counts(before=(0, 0, 0)):
    """Forward launches (SIMT, bf16 tensor-core, 3xTF32 tensor-core), less
    ``before``."""
    now = (fa.mha.launches, fa.mha.mma_launches, fa.mha.tf32_launches)
    return tuple(a - b for a, b in zip(now, before))


# The tensor-core forward (csrc/flash_attention_fwd_mma.cu) at every CTA shape
# it has: DETR's shapes, the three b8 training shapes, Dh 64, and a ragged Lq
# and Lk (not multiples of 16 or 64; at 129 keys a warp of a 4-way split
# sees no valid key in the last tile), with and without dropout (plain given
# the kernel library's keep mask), masked and not. bf16: P rounded to bf16
# before PV on both sides, normalised at different points; chip_smoke.ATOL.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
@pytest.mark.parametrize("b,lq,lk,dh", [(2, 1232, 1232, 32), (2, 100, 1232, 32),
                                         (1, 100, 100, 32), (2, 320, 320, 64),
                                         (3, 77, 129, 32), (8, 252, 252, 32),
                                         (8, 100, 252, 32), (8, 100, 100, 32)])
def test_attention_mma_kernel_matches_plain(cuda_device, b, lq, lk, dh, shape, rate):
    q, k, v, mask = _inputs(cuda_device, torch.bfloat16, b, lq, lk, 8, dh, seed=lq + lk + dh)
    seed = torch.tensor([lq * 131 + lk], device=cuda_device)
    keep = fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk) if rate else None
    before = _forward_counts()
    for m in (mask, None):
        out, lse = fa.launch_forward_mma(q, k, v, m, False, dropout_seed=seed, dropout_rate=rate,
                                         shape=shape)
        torch.cuda.synchronize()
        assert lse is None and out.dtype == torch.bfloat16 and out.shape == q.shape
        ref = fa.reference_mha(q, k, v, m, keep, rate)
        assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    assert _forward_counts(before) == (0, 2, 0)


def test_attention_mma_kernel_fully_padded_row_and_lse(cuda_device):
    """A batch element whose keys are all padded gets a uniform softmax, as
    the plain version; the row lse is within 1e-3 of torch.logsumexp of the
    plain fp32 scores (-1e30 on padded keys), and the backward kernel takes
    it as it takes the SIMT kernel's."""
    q, k, v, _ = _inputs(cuda_device, torch.bfloat16, 3, 77, 129, 8, 32, seed=11)
    mask = torch.zeros((3, 129), dtype=torch.bool, device=cuda_device)
    mask[1] = True
    mask[2, 70:] = True
    out, lse = fa.launch_forward_mma(q, k, v, mask, True)
    ref = fa.reference_mha(q, k, v, mask)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores.masked_fill(mask[:, None, None, :], -1e30)
    want = torch.logsumexp(scores, dim=-1).reshape(3 * 8, 77)
    valid = mask.logical_not().any(dim=1).repeat_interleave(8)
    assert float((lse[valid] - want[valid]).abs().max()) <= 1e-3
    assert bool((lse[~valid] < -1e29).all())
    dout = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    got = _grads(lambda *t: fa.mha(*t, mask), q, k, v, dout)
    want_grads = _grads(lambda *t: fa.reference_mha(*t, mask), q, k, v, dout)
    for g, r in zip(got[1:], want_grads[1:]):
        assert _rel_err(g, r) <= GRAD_RTOL[torch.bfloat16]


@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
def test_attention_mma_dropout_bits_are_keep_mask(cuda_device, shape):
    """A-mma's dropout multipliers, read out exactly: with q = 0 every p is
    exp2(0) = 1 and the row sum is 64, and with V's key j the unit vector
    e_j (Dh 64) out[i, j] = bf16(m_ij) / 64, a power-of-two scaling of a
    bf16 value, so 64 out / bf16(keep_scale) equals the keep mask of
    ``keep_mask`` (PyTorch Philox) bit for bit."""
    b, lq, lk, h, rate = 2, 100, 64, 8, 0.1
    q = torch.zeros((b, lq, h, 64), device=cuda_device, dtype=torch.bfloat16)
    v = torch.eye(64, device=cuda_device, dtype=torch.bfloat16)[None, :, None, :]
    v = v.expand(b, lk, h, 64).contiguous()
    k = torch.randn((b, lk, h, 64), device=cuda_device).bfloat16()
    seed = torch.tensor([0xDEAD_BEEF_1234], device=cuda_device)
    out, _ = fa.launch_forward_mma(q, k, v, None, True, dropout_seed=seed, dropout_rate=rate,
                                   shape=shape)
    scale = torch.tensor(1 / (1 - rate)).bfloat16().float()
    got = (out.float() * lk / scale).permute(0, 2, 1, 3).reshape(b * h, lq, lk)
    want = fa.keep_mask(seed, b * h, lq, lk, rate)
    assert torch.equal(got, want.float())


@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
@pytest.mark.parametrize("b,lq,lk,dh", [(8, 252, 252, 32), (8, 100, 252, 32), (3, 77, 129, 64)])
def test_attention_mma_lse_is_taken_before_dropout(cuda_device, b, lq, lk, dh, shape):
    """A-mma's row lse with dropout equals its lse without dropout bit for
    bit (the row sum takes p before the keep factor), and the output with
    dropout differs."""
    q, k, v, mask = _inputs(cuda_device, torch.bfloat16, b, lq, lk, 8, dh, seed=lq * 3 + lk)
    seed = torch.tensor([lq + 7 * lk], device=cuda_device)
    out0, lse0 = fa.launch_forward_mma(q, k, v, mask, True, shape=shape)
    out1, lse1 = fa.launch_forward_mma(q, k, v, mask, True, dropout_seed=seed, dropout_rate=0.1,
                                       shape=shape)
    assert torch.equal(lse0, lse1)
    assert not torch.equal(out0, out1)


def test_attention_mma_dropout_refuses_a_missing_seed(cuda_device):
    """A rate above 0 without a seed is refused by the C entry point: the
    wrapper raises and launches nothing."""
    q, k, v, mask = _inputs(cuda_device, torch.bfloat16, 2, 16, 16, 8, 32, seed=0)
    before = fa.mha.mma_launches
    with pytest.raises(RuntimeError, match="flash_attention_fwd_mma"):
        fa.launch_forward_mma(q, k, v, mask, False, dropout_rate=0.1)
    assert fa.mha.mma_launches == before


def test_attention_simt_kernel_still_takes_bf16(cuda_device):
    """The SIMT kernel stays callable at bf16 without dropout, to time it
    against the tensor-core kernel; it agrees with the plain version."""
    q, k, v, mask = _inputs(cuda_device, torch.bfloat16, 2, 100, 1232, 8, 32, seed=5)
    before = fa.mha.launches
    out, _ = fa.launch_forward_simt(q, k, v, mask, None, 0.0, False)
    torch.cuda.synchronize()
    assert fa.mha.launches == before + 1
    assert float((out.float() - fa.reference_mha(q, k, v, mask).float()).abs().max()) <= 2e-2


def test_attention_simt_kernel_still_takes_fp32(cuda_device):
    """The SIMT kernel stays callable at fp32, with and without dropout, to
    time it against the tf32 kernel; it agrees with the plain version (given
    the kernel library's keep mask)."""
    q, k, v, mask = _inputs(cuda_device, torch.float32, 8, 100, 252, 8, 32, seed=15)
    seed = torch.tensor([77], device=cuda_device)
    keep = fa.kernel_keep_mask(seed, 64, 100, 252, 0.1).view(8, 8, 100, 252)
    before = _forward_counts()
    for rate, m in ((0.0, None), (0.1, keep)):
        out, lse = fa.launch_forward_simt(q, k, v, mask, seed, rate, True)
        torch.cuda.synchronize()
        assert lse.shape == (64, 100)
        ref = fa.reference_mha(q, k, v, mask, m, rate)
        assert float((out - ref).abs().max()) <= 1e-4
    assert _forward_counts(before) == (2, 0, 0)


# The 3xTF32 tensor-core forward (csrc/flash_attention_fwd_tf32.cu) at each CTA
# shape: every served shape (B=2, b1), the three b8 training shapes, ragged
# Lq and Lk (not multiples of 16 or 64; at 5 and 129 keys a warp of a 4-way
# split sees no valid key in the last tile), Dh 64, with and without
# dropout (plain given the kernel library's keep mask), masked and not.
# fp32: summation order only, chip_smoke.ATOL.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
@pytest.mark.parametrize("b,lq,lk,dh", [
    (2, 1232, 1232, 32), (2, 100, 1232, 32), (1, 1232, 1232, 32), (1, 100, 1232, 32),
    (1, 100, 100, 32), (8, 252, 252, 32), (8, 100, 252, 32), (8, 100, 100, 32),
    (3, 37, 5, 32), (2, 77, 129, 64), (1, 200, 37, 32), (2, 130, 300, 64)])
def test_attention_tf32_kernel_matches_plain(cuda_device, b, lq, lk, dh, shape, rate):
    q, k, v, mask = _inputs(cuda_device, torch.float32, b, lq, lk, 8, dh, seed=lq + lk + dh)
    seed = torch.tensor([lq * 131 + lk], device=cuda_device)
    keep = fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk) if rate else None
    before = _forward_counts()
    for m in (mask, None):
        out, lse = fa.launch_forward_tf32(q, k, v, m, seed, rate, True, shape=shape)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == q.shape and lse.shape == (b * 8, lq)
        ref = fa.reference_mha(q, k, v, m, keep, rate)
        assert float((out - ref).abs().max()) <= 1e-4
    assert _forward_counts(before) == (0, 0, 2)


@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
def test_attention_tf32_fully_padded_row_and_lse(cuda_device, shape):
    """A batch element whose keys are all padded gets a uniform softmax, as
    the plain version; the row lse is within 1e-4 of torch.logsumexp of the
    plain fp32 scores (-1e30 on padded keys), below -1e29 on the padded
    rows, and the backward kernel takes it as it takes the SIMT kernel's."""
    q, k, v, _ = _inputs(cuda_device, torch.float32, 3, 77, 129, 8, 32, seed=12)
    mask = torch.zeros((3, 129), dtype=torch.bool, device=cuda_device)
    mask[1] = True
    mask[2, 70:] = True
    out, lse = fa.launch_forward_tf32(q, k, v, mask, None, 0.0, True, shape=shape)
    assert float((out - fa.reference_mha(q, k, v, mask)).abs().max()) <= 1e-4
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).masked_fill(mask[:, None, None, :], -1e30)
    want = torch.logsumexp(scores, dim=-1).reshape(3 * 8, 77)
    valid = mask.logical_not().any(dim=1).repeat_interleave(8)
    assert float((lse[valid] - want[valid]).abs().max()) <= 1e-4
    assert bool((lse[~valid] < -1e29).all())
    _, simt_lse = fa.launch_forward_simt(q, k, v, mask, None, 0.0, True)
    dout = torch.randn(q.shape, device=cuda_device)
    got = fa.launch_backward_mma(q, k, v, out, dout, lse, mask, None, 0.0)
    ref = _grads(lambda *t: fa.reference_mha(*t, mask), q, k, v, dout)
    for g, r in zip(got, ref[1:]):
        assert _rel_err(g, r) <= GRAD_RTOL[torch.float32]
    assert float((lse[valid] - simt_lse[valid]).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", fa.MMA_SHAPES)
def test_attention_tf32_dropout_bits_are_keep_mask(cuda_device, shape):
    """The kernel's dropout multipliers, read out exactly: with q = 0 the
    softmax is uniform over the 64 keys, and with V's key j the unit vector
    e_j (Dh 64) out[i, j] = m_ij / 64, so 64 out / keep_scale equals the
    keep mask of ``keep_mask`` (PyTorch Philox) bit for bit."""
    b, lq, lk, h, rate = 2, 100, 64, 8, 0.1
    q = torch.zeros((b, lq, h, 64), device=cuda_device)
    v = torch.eye(64, device=cuda_device)[None, :, None, :].expand(b, lk, h, 64).contiguous()
    k = torch.randn((b, lk, h, 64), device=cuda_device)
    seed = torch.tensor([0xDEAD_BEEF_1234], device=cuda_device)
    out, _ = fa.launch_forward_tf32(q, k, v, None, seed, rate, False, shape=shape)
    got = (out * (lk * (1 - rate))).permute(0, 2, 1, 3).reshape(b * h, lq, lk)
    want = fa.keep_mask(seed, b * h, lq, lk, rate)
    assert torch.equal(got.round().bool(), want)
    assert float((got - want.float()).abs().max()) <= 1e-5


def test_attention_tf32_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits, with dropout."""
    q, k, v, mask = _inputs(cuda_device, torch.float32, 8, 100, 252, 8, 32, seed=21)
    seed = torch.tensor([5], device=cuda_device)
    first = fa.launch_forward_tf32(q, k, v, mask, seed, 0.1, True)
    second = fa.launch_forward_tf32(q, k, v, mask, seed, 0.1, True)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_attention_tf32_rejects_bf16(cuda_device):
    q, k, v, mask = _inputs(cuda_device, torch.bfloat16, 2, 16, 16, 8, 32, seed=0)
    with pytest.raises(TypeError, match="float32"):
        fa.launch_forward_tf32(q, k, v, mask, None, 0.0, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_route_in_a_model_forward(cuda_device, dtype):
    """A DETR with the full 6 + 6 transformer on a reduced backbone: 18
    launches of the bf16 tensor-core kernel per bf16 forward, 18 of the
    3xTF32 one per fp32 forward, and none of the SIMT kernel."""
    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), device=cuda_device,
                           dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 256, 320, 3)).astype(np.float32))
    before = _forward_counts()
    out = model(x.to(cuda_device))
    expected = (0, 18, 0) if dtype == torch.bfloat16 else (0, 0, 18)
    assert _forward_counts(before) == expected
    assert torch.isfinite(out["pred_boxes"].float()).all()


def test_attention_kernel_rejects_strided_input(cuda_device):
    q, k, v, mask = _inputs(cuda_device, torch.float32, 2, 16, 16, 4, 32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.mha(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)


def test_model_forward_launches_kernel(cuda_device):
    """A reduced-depth DETR on the card: 2 encoder + 2x2 decoder attention
    launches, and the same outputs as plain attention (fp32, TF32 off)."""
    cfg = dict(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=2,
               num_decoder_layers=2, device=cuda_device)
    model = api.build_detr(**cfg)
    plain = api.build_detr(attn_impl="plain", **cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 256, 320, 3)).astype(np.float32))
    x = x.to(cuda_device)
    before = _forward_counts()
    out = model(x)
    assert _forward_counts(before) == (0, 0, 6)
    ref = plain(x)
    assert float((out["pred_boxes"] - ref["pred_boxes"]).abs().max()) <= 5e-4
    assert float((out["pred_logits"] - ref["pred_logits"]).abs().max()) <= 5e-3


# Gradient tolerances, relative to the largest reference value: fp32 differs
# by summation order; bf16 rounds P and dS to bf16 at the TPU kernel's
# points, the plain version at autograd's (its dP comes out of a bf16
# einsum), a few bf16 ulps apart.
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


def _grads(fn, q, k, v, dout):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def test_attention_output_is_differentiable(cuda_device):
    """On a CUDA tensor under autograd the kernel's output carries a
    grad_fn, and the gradients come from the backward kernel (fp32: the
    tensor-core one)."""
    q, k, v, mask = _inputs(cuda_device, torch.float32, 2, 100, 252, 8, 32, seed=4)
    q.requires_grad_()
    before = (fa.mha.backward_mma_launches, fa.mha.backward_launches)
    out = fa.mha(q, k, v, mask)
    assert out.grad_fn is not None
    out.sum().backward()
    assert (fa.mha.backward_mma_launches, fa.mha.backward_launches) == (before[0] + 1, before[1])
    ref_q = q.detach().clone().requires_grad_()
    fa.reference_mha(ref_q, k, v, mask).sum().backward()
    assert _rel_err(q.grad, ref_q.grad) <= GRAD_RTOL[torch.float32]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,dh", [(8, 252, 252, 32), (8, 100, 252, 32), (8, 100, 100, 32),
                                         (3, 37, 5, 32), (2, 130, 300, 64)])
def test_attention_backward_matches_plain(cuda_device, b, lq, lk, dh, dtype, rate):
    """Kernel forward and dQ/dK/dV against plain autograd; with dropout,
    the plain version gets the mask the kernel library materialises for
    the same seed, so forward and backward must use that one mask. fp32
    runs the tensor-core backward (3xTF32), bf16 the bf16 tensor-core one;
    neither the SIMT one."""
    q, k, v, mask = _inputs(cuda_device, dtype, b, lq, lk, 8, dh, seed=lq * 3 + lk)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(lk),
                       device=cuda_device).to(dtype)
    seed = torch.tensor([lq * 1000 + lk], device=cuda_device)
    keep = fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk) if rate else None
    before = _backward_counts()
    got = _grads(lambda *t: fa.mha(*t, mask, rate, seed), q, k, v, dout)
    mma = dtype == torch.float32
    assert _backward_counts(before) == (int(mma), int(not mma), 0)
    ref = _grads(lambda *t: fa.reference_mha(*t, mask, keep, rate), q, k, v, dout)
    torch.cuda.synchronize()
    assert _rel_err(got[0], ref[0]) <= (1e-4 if dtype == torch.float32 else 2e-2)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel_err(g, r) <= GRAD_RTOL[dtype]


def test_bf16_attention_with_dropout_under_autograd(cuda_device):
    """bf16 ``mha`` under autograd at dropout 0.1, the bf16 step's call: the
    forward on A-mma, the backward on A'-bf16 (no SIMT kernel), output and
    gradients against plain autograd given the kernel library's keep mask,
    at each training shape."""
    for lq, lk in ((252, 252), (100, 252), (100, 100)):
        q, k, v, mask = _inputs(cuda_device, torch.bfloat16, 8, lq, lk, 8, 32, seed=lq + 5 * lk)
        dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(lq),
                           device=cuda_device).bfloat16()
        seed = torch.tensor([lq * 977 + lk], device=cuda_device)
        keep = fa.kernel_keep_mask(seed, 64, lq, lk, 0.1).view(8, 8, lq, lk)
        fwd, bwd = _forward_counts(), _backward_counts()
        got = _grads(lambda *t: fa.mha(*t, mask, 0.1, seed), q, k, v, dout)
        assert _forward_counts(fwd) == (0, 1, 0) and _backward_counts(bwd) == (0, 1, 0)
        ref = _grads(lambda *t: fa.reference_mha(*t, mask, keep, 0.1), q, k, v, dout)
        assert float((got[0].float() - ref[0].float()).abs().max()) <= 2e-2
        for g, r in zip(got[1:], ref[1:]):
            assert g.dtype == torch.bfloat16 and _rel_err(g, r) <= GRAD_RTOL[torch.bfloat16]


def _backward_counts(before=(0, 0, 0)):
    """Backward launches (3xTF32 tensor-core, bf16 tensor-core, SIMT), less
    ``before``."""
    now = (fa.mha.backward_mma_launches, fa.mha.backward_bf16_launches, fa.mha.backward_launches)
    return tuple(a - b for a, b in zip(now, before))


def test_attention_fully_padded_row(cuda_device):
    """A batch element whose keys are all padded: uniform softmax over the
    keys, as the plain version, forward and backward."""
    q, k, v, _ = _inputs(cuda_device, torch.float32, 2, 40, 70, 8, 32, seed=9)
    mask = torch.zeros((2, 70), dtype=torch.bool, device=cuda_device)
    mask[1] = True
    mask[0, 50:] = True
    dout = torch.randn(q.shape, device=cuda_device)
    before = fa.mha.backward_mma_launches
    got = _grads(lambda *t: fa.mha(*t, mask), q, k, v, dout)
    assert fa.mha.backward_mma_launches == before + 1
    ref = _grads(lambda *t: fa.reference_mha(*t, mask), q, k, v, dout)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 1e-4


def _backward_case(device, dtype, b, lq, lk, dh, rate, padded_row=False):
    """Inputs, the kernel forward's output and lse, and the plain version's
    gradients (given the kernel library's keep mask) of one backward call."""
    q, k, v, mask = _inputs(device, dtype, b, lq, lk, 8, dh, seed=lq * 5 + lk + dh)
    if padded_row:
        mask[0] = True
    dout = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(lq),
                       device=device).to(dtype)
    seed = torch.tensor([lq * 7919 + lk], device=device)
    out, lse = fa.launch_forward(q, k, v, mask, seed, rate, True)
    keep = fa.kernel_keep_mask(seed, b * 8, lq, lk, rate).view(b, 8, lq, lk) if rate else None
    ref = _grads(lambda *t: fa.reference_mha(*t, mask, keep, rate), q, k, v, dout)[1:]
    return (q, k, v, out, dout, lse, mask, seed, rate), ref


# The tensor-core backward at DETR's training shapes, Dh 64 with ragged Lq
# and Lk (not multiples of 8, 16, 32 or 64: the keep words and tiles end
# mid-way), and a batch element whose keys are all padded.
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,lq,lk,dh,padded_row", [
    (8, 252, 252, 32, False), (8, 100, 252, 32, False), (8, 100, 100, 32, False),
    (3, 37, 5, 64, False), (2, 77, 129, 64, False), (3, 37, 70, 32, True),
    (2, 130, 300, 64, True), (1, 200, 37, 32, False)])
def test_attention_backward_mma_matches_plain(cuda_device, b, lq, lk, dh, padded_row, rate):
    args, ref = _backward_case(cuda_device, torch.float32, b, lq, lk, dh, rate, padded_row)
    before = fa.mha.backward_mma_launches
    got = fa.launch_backward_mma(*args)
    torch.cuda.synchronize()
    assert fa.mha.backward_mma_launches == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert _rel_err(g, r) <= GRAD_RTOL[torch.float32]


def test_attention_backward_mma_is_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    args, _ = _backward_case(cuda_device, torch.float32, 8, 100, 252, 32, 0.1)
    first = fa.launch_backward_mma(*args)
    second = fa.launch_backward_mma(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_simt_still_matches_plain(cuda_device, dtype, rate):
    """The SIMT backward, called directly, still takes fp32 (to time it
    against the tensor-core kernel) and bf16, and agrees with plain."""
    args, ref = _backward_case(cuda_device, dtype, 8, 100, 252, 32, rate)
    before = fa.mha.backward_launches
    got = fa.launch_backward_simt(*args)
    torch.cuda.synchronize()
    assert fa.mha.backward_launches == before + 1
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= GRAD_RTOL[dtype]


def test_attention_backward_mma_rejects_bf16(cuda_device):
    args, _ = _backward_case(cuda_device, torch.float32, 2, 16, 16, 32, 0.0)
    bf16 = [t.bfloat16() if isinstance(t, torch.Tensor) and t.dim() == 4 else t for t in args]
    with pytest.raises(TypeError, match="float32"):
        fa.launch_backward_mma(*bf16)


def test_kernel_keep_mask_is_the_torch_philox(cuda_device):
    """The bits the kernels draw equal ``keep_mask`` (PyTorch Philox) bit for
    bit, and the keep rate is 0.9 within 5 sigma."""
    seed = torch.tensor([0x1234_5678_9ABC], device=cuda_device)
    got = fa.kernel_keep_mask(seed, 64, 252, 252, 0.1)
    assert torch.equal(got, fa.keep_mask(seed, 64, 252, 252, 0.1))
    n = got.numel()
    assert abs(float(got.float().mean()) - 0.9) <= 5 * (0.09 / n) ** 0.5


def _lap_problems(seed, p=48, r=100, c=100, max_real=30, ties=False, scattered=False):
    rng = np.random.default_rng(seed)
    if ties:
        cost = rng.integers(0, 4, size=(p, r, c)).astype(np.float32)
    else:
        cost = rng.normal(size=(p, r, c)).astype(np.float32)
    n_real = rng.integers(0, max_real + 1, size=p)
    n_real[:2] = 0, max_real
    mask = np.arange(r)[None, :] < n_real[:, None]
    if scattered:
        mask = np.stack([rng.permutation(m) for m in mask])
    return cost, mask


# (problems, rows, columns, most real rows, scattered masks, costs at an
# address 4 bytes past a 16-byte boundary): the path's 48 x 100 x 100, masks
# that are no prefix, the widest problems of the 128-column instance (R = C =
# 127, 4-byte staging), a single column, and misaligned costs; then the
# 256-column instance: the panoptic recipe's 48 x 250 x 250 (250 target
# slots, 250 queries) with prefix and scattered masks, problems of 250 real
# rows (past the rows shared memory holds: the rest read from device
# memory), its widest (R = C = 255, 4-byte staging) and its narrowest (128
# columns); then the generic instance, past 255 columns: 300 queries against
# 100 target slots, and 257 columns (4-byte staging) at a misaligned address.
LAP_LAYOUTS = {"path": (48, 100, 100, 30, False, False),
               "scattered": (48, 100, 100, 30, True, False),
               "square127": (6, 127, 127, 127, True, False),
               "one column": (5, 1, 1, 1, False, False),
               "misaligned": (6, 20, 40, 20, True, True),
               "panoptic": (48, 250, 250, 60, False, False),
               "panoptic scattered": (48, 250, 250, 60, True, False),
               "square250 past the staged rows": (4, 250, 250, 250, True, False),
               "square255": (3, 255, 255, 255, True, True),  # misaligned too
               "128 columns": (6, 100, 128, 100, True, False),
               "300 queries 100 slots": (6, 100, 300, 100, True, False),
               "257 columns misaligned": (3, 60, 257, 60, True, True)}


@pytest.mark.parametrize("layout", list(LAP_LAYOUTS))
@pytest.mark.parametrize("ties", [False, True])
def test_lap_kernel_matches_plain_and_scipy(cuda_device, ties, layout):
    """B's assignments equal the plain version's and scipy's where the
    optimum is unique; with tied costs its optimal cost equals scipy's."""
    from scipy.optimize import linear_sum_assignment

    p, r, c, max_real, scattered, misaligned = LAP_LAYOUTS[layout]
    cost, mask = _lap_problems(1 + ties, p, r, c, max_real, ties, scattered)
    cost_d = torch.from_numpy(cost).to(cuda_device)
    if misaligned:
        cost_d = torch.empty(cost.size + 1, device=cuda_device)[1:].view(cost.shape).copy_(cost_d)
        assert cost_d.data_ptr() % 16 == 4
    before = _lap_counts()
    got = lap.solve_lap_masked(cost_d, torch.from_numpy(mask).to(cuda_device)).cpu().numpy()
    assert _lap_counts(before) == (1, 127 < c <= 255, c > 255)
    plain = lap.reference_solve_lap_masked(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    for i, m in enumerate(mask):
        n = int(m.sum())
        assert (got[i, ~m] == -1).all()
        rows, cols = linear_sum_assignment(cost[i, m])
        assert len(set(got[i, m].tolist())) == n
        ours = cost[i, m][np.arange(n), got[i, m]].sum()
        assert abs(ours - cost[i, m][rows, cols].sum()) <= 1e-4 * max(1.0, abs(ours))
        if not ties:
            assert (got[i, m] == cols).all() and (plain[i] == got[i]).all()


def _lap_counts(before=(0, 0, 0)):
    """B's launches (all, the 256-column instance, the generic one), less
    ``before``."""
    now = (lap.solve_lap_masked.launches, lap.solve_lap_masked.wide_launches,
           lap.solve_lap_masked.generic_launches)
    return tuple(a - b for a, b in zip(now, before))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("width", [w[0] for w in smoke_inputs.LAP_GENERIC])
def test_lap_kernel_at_any_width(cuda_device, width, ties):
    """B's generic instance at the widths of wider query sets
    (``smoke_inputs.LAP_GENERIC``: Deformable-DETR's 300, DINO's 900 with one
    problem of 900 real rows, H-DETR's 1800 rounded up to 2000, 4097 with
    3900 real rows, one staged and the rest read from L2, 5000 with 4800
    and its state in device memory), real rows scattered: assignments equal
    to the plain version's and scipy's on continuous costs, the optimal cost
    (within 1e-4 relative) on tied ones."""
    from scipy.optimize import linear_sum_assignment

    k = [w[0] for w in smoke_inputs.LAP_GENERIC].index(width)
    _, p, c, real, many = smoke_inputs.LAP_GENERIC[k]
    cost, mask, n_real = smoke_inputs.generic_lap_problems(40 + k + ties, p, c, real, many, ties)
    before = _lap_counts()
    got = lap.solve_lap_masked(torch.from_numpy(cost).to(cuda_device),
                               torch.from_numpy(mask).to(cuda_device)).cpu().numpy()
    assert _lap_counts(before) == (1, 0, 1)
    plain = None if ties else lap.reference_solve_lap_masked(torch.from_numpy(cost),
                                                             torch.from_numpy(mask)).numpy()
    for i, (m, n) in enumerate(zip(mask, n_real)):
        assert (got[i, ~m] == -1).all() and len(set(got[i, m].tolist())) == n
        rows, cols = linear_sum_assignment(cost[i, m])
        best = float(cost[i, m][rows, cols].sum())
        ours = float(cost[i, m][np.arange(n), got[i, m]].sum())
        assert abs(ours - best) <= 1e-4 * max(1.0, abs(best))
        if not ties:
            assert (got[i, m] == cols).all() and (plain[i] == got[i]).all()


def test_jpeg_decoder_on_the_fixtures_gives_imageios_hashes(cuda_device):
    """On the card's machine, which has no imageio: ``data/jpeg.py`` built
    there decodes every committed fixture to the shape and SHA-256 imageio
    gave where the fixtures were written (``tests/data/jpeg/expected.json``)."""
    import hashlib
    import json
    from pathlib import Path

    from detr_tensorflow_tpu_torch.data import jpeg

    root = Path(__file__).parent / "data" / "jpeg"
    for name, want in json.loads((root / "expected.json").read_text()).items():
        image = jpeg.read_jpeg(str(root / name))
        assert list(image.shape) == want["shape"], name
        assert hashlib.sha256(image.tobytes()).hexdigest() == want["sha256"], name


def test_finetune_hardhat_on_jpeg_files(cuda_device, tmp_path):
    """``finetune_hardhat.main`` on the card for 2 steps on a CSV set of JPEG
    copies of the fixtures (``smoke_inputs.write_jpeg_sets``), at reduced depth:
    "person" excluded (4 logits), the heads alone training at epoch 0 (A-tf32
    3 a step for one encoder and one decoder layer, A' none, B and C once a
    step)."""
    from detr_tensorflow_tpu_torch import finetune_hardhat

    smoke_inputs.write_jpeg_sets(str(tmp_path), 5, images=16, eval_images=8, ft_images=16)
    before = (fa.mha.tf32_launches, fa.mha.backward_mma_launches) + _lap_counts() + (
        maxpool.max_pool_3x3_s2.launches,)
    trainer = finetune_hardhat.main(
        ["--data_dir", str(tmp_path / "hardhat"), "--img_dir", "train", "--ann_file",
         "train/_annotations.csv", "--device", "cuda", "--batch_size", "2", "--target_batch",
         "2", "--image_size", "128", "192", "--epochs", "1", "--steps_per_epoch", "2",
         "--evaluation_steps", "0"],
        backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=1, num_decoder_layers=1)
    torch.cuda.synchronize()
    after = (fa.mha.tf32_launches, fa.mha.backward_mma_launches) + _lap_counts() + (
        maxpool.max_pool_3x3_s2.launches,)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 0, 2, 0, 0, 2)
    assert trainer.steps == 2 and trainer.model.cls_layer.weight.shape[0] == 4


def test_train_step_kernel_route_matches_plain(cuda_device):
    """A reduced-depth DETR train step on the card. At dropout 0, with the
    kernel route's matching handed to the plain route, loss (rel 1e-4) and
    every parameter's gradient (per tensor, rel 1e-3; tensors with an
    exactly-zero gradient, such as every k_proj bias, within 1e-6 of the
    largest tensor gradient) agree; then two dropout-0.1 ``Trainer`` steps
    launch A-tf32, A' and B as designed."""
    from detr_tensorflow_tpu_torch.data import pad_targets
    from detr_tensorflow_tpu_torch.ops import losses
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    rng = np.random.default_rng(0)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                                    rng.uniform(0.05, 0.4, (n, 2))], -1),
                    rng.integers(0, 91, size=n)) for n in (3, 7)))
    batch = batch_to_device({"images": rng.normal(size=(2, 128, 192, 3)).astype(np.float32),
                             "boxes": np.stack(boxes), "classes": np.stack(classes),
                             "mask": np.stack(mask)}, cuda_device)
    targets = [batch[k] for k in ("boxes", "classes", "mask")]
    cfg = dict(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=2, num_decoder_layers=2,
               device=cuda_device)
    results, match = [], None
    for impl in ("auto", "plain"):
        model = api.build_detr(dropout=0.0, attn_impl=impl, **cfg).module
        out = model(batch["images"], train=True)
        if match is None:
            match = losses.match_all_layers(out, *targets)
        total, _ = losses.detr_loss(out, *targets, 91, match=match)
        total.backward()
        results.append((float(total.detach()), {n: p.grad for n, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = results
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    floor = 1e-6 * max(float(g.norm()) for g in grads_p.values())
    for name, g in grads_p.items():
        diff = float((grads_k[name] - g).norm())
        assert diff <= (floor if float(g.norm()) <= floor else 1e-3 * float(g.norm())), name

    config = TrainingConfig(background_class=91, train_backbone=True, train_transformers=True,
                            batch_size=2, backbone_lr=1e-3, transformers_lr=1e-3)
    trainer = Trainer(api.build_detr(**cfg).module, config, seed=0)
    logs = []
    counts = _counts(lambda: logs.extend(trainer.step(batch) for _ in range(2)))
    assert counts == (2 * 6, 0, 0, 2 * 6, 0, 2)  # fp32: the tensor-core kernels only
    assert all(bool(torch.isfinite(log["total_loss"])) for log in logs)


def _counts(fn):
    """Launches of A-tf32, A SIMT, A' SIMT, A'-mma (3xTF32), A'-bf16 and B
    during ``fn()``."""
    def read():
        return (fa.mha.tf32_launches, fa.mha.launches, fa.mha.backward_launches,
                fa.mha.backward_mma_launches, fa.mha.backward_bf16_launches,
                lap.solve_lap_masked.launches)
    before = read()
    fn()
    return tuple(a - b for a, b in zip(read(), before))


def test_train_step_launches_the_mma_backward_18_times(cuda_device):
    """One fp32 ``Trainer`` step of a DETR with the full 6 + 6 transformer
    (reduced backbone) at dropout 0.1: 18 tensor-core (3xTF32) attention
    forwards, 18 tensor-core backwards, no SIMT forward or backward, one LAP
    launch."""
    from detr_tensorflow_tpu_torch.data import pad_targets
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    rng = np.random.default_rng(3)
    boxes, classes, mask = pad_targets(
        np.concatenate([rng.uniform(0.2, 0.8, (4, 2)), rng.uniform(0.05, 0.4, (4, 2))], -1),
        rng.integers(0, 91, size=4))
    batch = batch_to_device({"images": rng.normal(size=(1, 128, 192, 3)).astype(np.float32),
                             "boxes": boxes[None], "classes": classes[None],
                             "mask": mask[None]}, cuda_device)
    config = TrainingConfig(background_class=91, train_backbone=True, train_transformers=True,
                            batch_size=1)
    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), device=cuda_device).module
    trainer = Trainer(model, config, seed=0)
    logs = []
    assert _counts(lambda: logs.append(trainer.step(batch))) == (18, 0, 0, 18, 0, 1)
    assert bool(torch.isfinite(logs[0]["total_loss"]))


def _int8_operands(device, seed):
    """Post-ReLU int8 activations, int8 weights, and per-channel scales that
    put the epilogue's input at ~40, as on the served path."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(*shape):
        return torch.randint(0, 128, shape, dtype=torch.int8, device=device, generator=gen)

    def wts(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=device, generator=gen)

    def scale(k, c):
        return (torch.rand(k, device=device, generator=gen) + 0.5) * (40.0 / (5373.0 * c**0.5))

    def bias(k):
        return torch.randn(k, device=device, generator=gen) * 10.0

    return act, wts, scale, bias


def _int8_equal(kernel, plain):
    """Kernel and plain version agree exactly, for each ReLU setting and
    output dtype: both run the same arithmetic in the same order."""
    for relu in (True, False):
        for out_dtype in (torch.int8, torch.bfloat16):
            kw = dict(relu=relu, out_dtype=out_dtype)
            got, ref = kernel(**kw), plain(**kw)
            assert got.dtype == out_dtype and got.shape == ref.shape
            assert torch.equal(got, ref), (kw, float((got.float() - ref.float()).abs().max()))


# (M, C, K, Cd, variant): the 16 shapes of the b1 896x1408 int8 forward,
# then ragged ones that reach every plan: M = 1 and 105 (partial row
# tiles), K = 8 and 48 (partial channel tiles; 8-byte int8 copies where K %
# 16 != 0), residual2s whose Cd differs from C, deep, narrow contractions
# split across clusters of 2, 4 and 8 CTAs, and many row tiles ending in a
# partial channel tile (M = 40,000).
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("m,c,k,cd,variant", [s[:5] for s in F_PATH_SHAPES] + [
    (1, 64, 8, 0, "plain"), (105, 128, 48, 0, "residual"), (105, 64, 48, 128, "residual2"),
    (1, 256, 48, 64, "residual2"), (105, 2048, 64, 0, "plain"), (105, 1024, 8, 0, "residual"),
    (33, 512, 72, 1024, "residual2"), (105, 4096, 48, 0, "plain"),
    (40, 512, 64, 2048, "residual2"), (40000, 128, 200, 0, "residual"),
    (40000, 64, 136, 128, "residual2")])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, c, k, cd, variant, precise):
    act, wts, scale, bias = _int8_operands(cuda_device, seed=m + c + k)
    args = (act(m, c), wts(k, c), scale(k, c), bias(k))
    if variant == "plain":
        name, extra = "qmatmul", ()
    elif variant == "residual":
        name, extra = "qmatmul_residual", (act(m, k), torch.tensor(0.3, device=cuda_device))
    else:
        name, extra = "qmatmul_residual2", (act(m, cd), wts(k, cd), scale(k, cd), bias(k))
    fn = getattr(int8_matmul, name)
    counters = (int8_matmul.qmatmul, int8_matmul.qmatmul_residual, int8_matmul.qmatmul_residual2)
    before = [f.launches for f in counters]
    _int8_equal(lambda **kw: fn(*args, *extra, precise=precise, **kw),
                lambda **kw: getattr(int8_matmul, "reference_" + name)(*args, *extra,
                                                                       precise=precise, **kw))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [4 * (f is fn) for f in counters]


# (N, H, W, C, K, stride): the 7 shapes of the b1 896x1408 int8 forward
# (every tile and cluster the plan picks there), then ragged ones: batch 2,
# odd H and W at both strides (patches past the map's edges), K = 48 and 8
# (partial channel tiles; 8-byte int8 copies where K % 16 != 0), and small
# maps whose few tiles split C = 128 to 512 across clusters of 2, 4 and 8
# (C = 64 is one chunk, which no cluster splits).
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("n,h,w,c,k,stride", [(1, h, w, c, c, s) for h, w, c, s, _ in G_PATH_SHAPES] + [
    (2, 13, 20, 64, 48, 1), (2, 13, 21, 64, 48, 2), (2, 15, 33, 128, 48, 2),
    (1, 9, 17, 64, 8, 2), (2, 11, 19, 128, 8, 1), (1, 17, 35, 256, 72, 2),
    (1, 7, 12, 512, 64, 1), (3, 29, 45, 256, 136, 1)])
def test_int8_conv_kernel_matches_plain(cuda_device, n, h, w, c, k, stride, precise):
    act, wts, scale, bias = _int8_operands(cuda_device, seed=h + w + c)
    args = (act(n, h, w, c), wts(k, 3, 3, c), scale(k, 9 * c), bias(k))
    before = int8_conv.conv3x3_int8.launches[stride]
    _int8_equal(lambda **kw: int8_conv.conv3x3_int8(*args, stride=stride, precise=precise, **kw),
                lambda **kw: int8_conv.reference_conv3x3_int8(*args, stride=stride,
                                                             precise=precise, **kw))
    torch.cuda.synchronize()
    assert int8_conv.conv3x3_int8.launches[stride] == before + 4


def test_int8_kernels_state_their_shape_limits(cuda_device):
    """C must be a multiple of 64 and K of 8; the kernels raise outside."""
    act, wts, scale, bias = _int8_operands(cuda_device, seed=0)
    with pytest.raises(ValueError, match="multiples of 64"):
        int8_matmul.qmatmul(act(70, 32), wts(16, 32), scale(16, 32), bias(16))
    with pytest.raises(ValueError, match="multiple of 8"):
        int8_conv.conv3x3_int8(act(1, 8, 8, 64), wts(12, 3, 3, 64), scale(12, 576), bias(12))


def test_int8_detr_on_the_card(cuda_device):
    """A reduced-depth int8 DETR on the card, quantized from its own fp32
    backbone: every 1x1 on F, every 3x3 on G, and c5 on the kernel route
    equal to the plain int8 route (fp32 compute, TF32 off)."""
    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=2,
                           num_decoder_layers=2, backbone_quant=True, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 128, 192, 3)).astype(np.float32))
    x = x.to(cuda_device)
    quantized.quantize_model(model, x)
    counts = (int8_matmul.qmatmul.launches, int8_matmul.qmatmul_residual2.launches,
              int8_conv.conv3x3_int8.launches[1], int8_conv.conv3x3_int8.launches[2])
    out = model(x)
    after = (int8_matmul.qmatmul.launches, int8_matmul.qmatmul_residual2.launches,
             int8_conv.conv3x3_int8.launches[1], int8_conv.conv3x3_int8.launches[2])
    assert tuple(a - b for a, b in zip(after, counts)) == (4, 4, 1, 3)
    assert torch.isfinite(out["pred_boxes"]).all()
    qtree = dict(model.module.backbone_quant.named_buffers())
    with torch.inference_mode():
        c5 = quantized.quant_backbone_forward(qtree, x, (1, 1, 1, 1), compute_dtype=torch.float32)
        ref = quantized.quant_backbone_forward(qtree, x, (1, 1, 1, 1), compute_dtype=torch.float32,
                                               use_kernels=False)
    assert torch.equal(c5, ref)


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def _same_bits(a, b):
    """Equal bits where ``a`` is not NaN, and NaN at the same places."""
    nan = torch.isnan(a)
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 448, 704), (1, 64, 384, 640), (2, 64, 188, 336),
                                   (8, 64, 188, 336), (2, 8, 9, 11), (3, 4, 9, 11),
                                   (3, 12, 10, 12), (2, 72, 17, 34)])
def test_maxpool_kernel_is_bit_exact(cuda_device, shape, dtype):
    """Kernel C equals F.max_pool2d(3, 2, 1) bit for bit at the stem's
    shapes (the training stem at batch 8), at odd and even H and W and at
    channel counts whose rows are not a multiple of 16 bytes (the scalar
    channel path), on post-ReLU input with many ties, on any input (it
    skips the taps outside the image instead of reading zeros), on input
    with -0, -inf and NaN (NaN where F.max_pool2d has NaN), and on a view
    that does not start at a 16-byte boundary."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[2])
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    odd = torch.randint(-1, 3, shape, device=cuda_device, generator=gen).to(dtype)
    odd[odd == -1] = -0.0
    odd[torch.rand(shape, device=cuda_device, generator=gen) < 0.05] = float("-inf")
    odd[torch.rand(shape, device=cuda_device, generator=gen) < 0.02] = float("nan")
    b, c, h, w = shape
    shifted = torch.empty(x.numel() + 1, device=cuda_device, dtype=dtype)[1:]
    shifted = shifted.view(b, h, w, c).permute(0, 3, 1, 2)
    shifted.copy_(x)
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert shifted.data_ptr() % 16 != 0
    for inp in (_channels_last(torch.relu(x).round()), _channels_last(x), _channels_last(odd),
                shifted):
        before = maxpool.max_pool_3x3_s2.launches
        got = maxpool.max_pool_3x3_s2(inp, nonneg=True)
        assert maxpool.max_pool_3x3_s2.launches == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert _same_bits(got, maxpool.reference_max_pool_3x3_s2(inp))
    with pytest.raises(ValueError, match="channels_last"):
        maxpool.max_pool_3x3_s2(x.contiguous(), nonneg=True)


def test_maxpool_kernel_backward_routes_to_the_first_max(cuda_device):
    x = _channels_last(torch.randint(0, 3, (2, 4, 9, 11), device=cuda_device).float())
    g = torch.randn(2, 4, 5, 6, device=cuda_device)
    grads = []
    for fn in (lambda t: maxpool.max_pool_3x3_s2(t, nonneg=True),
               maxpool.reference_max_pool_3x3_s2):
        t = x.clone().requires_grad_()
        fn(t).backward(g)
        grads.append(t.grad)
    assert torch.allclose(grads[0], grads[1], atol=1e-6)


# Kernel against plain, relative to the largest reference value: fp32 sums
# the same products in another order; in bf16 both round T1/T2 and the
# output at the same points, and a sum that lands on the other side of a
# rounding boundary moves one bf16 ulp (2^-8 relative).
FUSED_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The fused bf16 model's c5 may lie at most this many times as far from the
# unfused fp32 model's as the unfused bf16 model's does (chip_smoke.py's
# bound; both gaps come from rounding to bf16 at different points).
FUSED_BF16_C5_RATIO = 2.0


def _d_operands(device, b, cin, cout, h, w, dtype):
    gen = torch.Generator(device=device).manual_seed(cin + h)
    x = _channels_last(torch.rand(b, cin, h, w, device=device, generator=gen)).to(dtype)
    wt = (torch.randn(cout, cin, 1, 1, device=device, generator=gen) * cin**-0.5).to(dtype)
    scale = torch.rand(cout, device=device, generator=gen) + 0.5
    shift = torch.randn(cout, device=device, generator=gen) * 0.3
    identity = _channels_last(torch.randn(b, cout, h, w, device=device, generator=gen)).to(dtype)
    return x, wt, scale, shift, identity


def _d_counts(before=(0, 0, 0)):
    """Kernel D's launches (SIMT, D-mma, D-tf32), less ``before``."""
    d = fused_residual.conv1x1_bn_residual_relu
    return tuple(a - b for a, b in zip((d.launches, d.mma_launches, d.tf32_launches), before))


# Kernel D's shapes: the 4 of a masked 896x1408 forward, the 4 of a
# bucket-exact 768x1280 one, and ragged ones: P, Cin and Cout not multiples
# of D-mma's and D-tf32's tiles and chunks (Cin not a whole number of 32- or
# 16-channel chunks, Cout not of 128- or 64-channel tiles), and a map
# smaller than one tile.
FUSED_D_CASES = [(1, 64, 256, 224, 352), (1, 128, 512, 112, 176), (1, 256, 1024, 56, 88),
                 (1, 512, 2048, 28, 44), (1, 64, 256, 192, 320), (1, 128, 512, 96, 160),
                 (1, 256, 1024, 48, 80), (1, 512, 2048, 24, 40), (2, 48, 40, 7, 9),
                 (2, 200, 136, 9, 13), (1, 64, 256, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w", FUSED_D_CASES)
def test_fused_residual_kernel_matches_plain(cuda_device, b, cin, cout, h, w, dtype):
    """conv1x1_bn_residual_relu launches D-mma at bf16 and D-tf32 at fp32,
    once, and agrees with the plain version within FUSED_RTOL."""
    ops = _d_operands(cuda_device, b, cin, cout, h, w, dtype)
    before = _d_counts()
    got = fused_residual.conv1x1_bn_residual_relu(*ops)
    ref = fused_residual.reference_conv1x1_bn_residual_relu(*ops)
    torch.cuda.synchronize()
    mma = dtype == torch.bfloat16
    assert _d_counts(before) == (0, int(mma), int(not mma))
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert _rel_err(got, ref) <= FUSED_RTOL[dtype]


def test_fused_residual_simt_still_takes_bf16(cuda_device):
    """launch_simt runs the SIMT kernel at bf16 (for timing beside D-mma)."""
    ops = _d_operands(cuda_device, 1, 256, 1024, 56, 88, torch.bfloat16)
    before = _d_counts()
    got = fused_residual.launch_simt(*ops)
    torch.cuda.synchronize()
    assert _d_counts(before) == (1, 0, 0)
    ref = fused_residual.reference_conv1x1_bn_residual_relu(*ops)
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.bfloat16]


def test_fused_residual_simt_still_runs_at_fp32(cuda_device):
    """launch_simt runs the SIMT kernel at fp32 (for timing beside D-tf32)."""
    ops = _d_operands(cuda_device, 1, 256, 1024, 56, 88, torch.float32)
    before = _d_counts()
    got = fused_residual.launch_simt(*ops)
    torch.cuda.synchronize()
    assert _d_counts(before) == (1, 0, 0)
    ref = fused_residual.reference_conv1x1_bn_residual_relu(*ops)
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.float32]


def test_fused_residual_mma_refuses_what_it_does_not_take(cuda_device):
    """A bf16 call with Cin (or Cout) not a multiple of 8 raises ValueError
    and names the rule; launch_mma refuses fp32. No kernel launches."""
    before = _d_counts()
    ops = _d_operands(cuda_device, 1, 20, 64, 8, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_residual.conv1x1_bn_residual_relu(*ops)
    ops = _d_operands(cuda_device, 1, 64, 36, 8, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_residual.conv1x1_bn_residual_relu(*ops)
    with pytest.raises(TypeError, match="takes bfloat16"):
        fused_residual.launch_mma(*_d_operands(cuda_device, 1, 64, 64, 8, 8, torch.float32))
    assert _d_counts(before) == (0, 0, 0)


def test_fused_residual_tf32_refuses_what_it_does_not_take(cuda_device):
    """An fp32 call with Cin (or Cout) not a multiple of 4 raises ValueError
    and names the rule, with no fallback to the SIMT D; launch_tf32 refuses
    bf16. No kernel launches."""
    before = _d_counts()
    for cin, cout in ((18, 64), (64, 34)):
        ops = _d_operands(cuda_device, 1, cin, cout, 8, 8, torch.float32)
        with pytest.raises(ValueError, match="multiples of 4"):
            fused_residual.conv1x1_bn_residual_relu(*ops)
    with pytest.raises(TypeError, match="takes float32"):
        fused_residual.launch_tf32(*_d_operands(cuda_device, 1, 64, 64, 8, 8, torch.bfloat16))
    assert _d_counts(before) == (0, 0, 0)


def _bottleneck_operands(device, c, m, seed, b1=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    w1, w3 = (torch.randn(s, device=device, generator=gen) * s[0] ** -0.5 for s in ((c, m), (m, c)))
    w2 = torch.randn(9, m, m, device=device, generator=gen) * (9 * m) ** -0.5
    b1 = torch.randn(m, device=device, generator=gen) * 0.1 if b1 is None else b1
    b2 = torch.randn(m, device=device, generator=gen) * 0.1
    b3 = torch.randn(c, device=device, generator=gen) * 0.1
    return w1, b1, w2, b2, w3, b3


# Kernel E's cases: every ResNet-50 width (M 64 to 512) at the 768x1280
# bucket's maps and at ragged ones (partial tiles, a map smaller than one
# tile).
FUSED_E_CASES = [(1, 256, 64, 192, 320), (1, 512, 128, 96, 160), (1, 1024, 256, 48, 80),
                 (1, 2048, 512, 24, 40), (2, 256, 64, 13, 21), (2, 1024, 256, 7, 5),
                 (1, 2048, 512, 5, 7)]


def _e_counts(before=(0, 0, 0)):
    """Kernel E's launches (SIMT, E-mma, E-tf32), less ``before``."""
    fb = fused_bottleneck.fused_bottleneck
    return tuple(a - b for a, b in zip((fb.launches, fb.mma_launches, fb.tf32_launches), before))


def _e_inputs(device, n, c, m, h, w, dtype, seed, b1=None):
    w1, b1, w2, b2, w3, b3 = _bottleneck_operands(device, c, m, seed=seed, b1=b1)
    ops = (w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype), b3)
    return _channels_last(torch.rand(n, c, h, w, device=device)).to(dtype), ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,m,h,w", FUSED_E_CASES)
def test_fused_bottleneck_kernel_matches_plain(cuda_device, n, c, m, h, w, dtype):
    """Kernel E through ``fused_bottleneck``: fp32 on E-tf32 (its width's
    plan: clusters of 1, 2 and 4 CTAs), bf16 on E-mma (clusters of 1, 2 and
    8); each launch counted on its route's counter only."""
    x, ops = _e_inputs(cuda_device, n, c, m, h, w, dtype, seed=c + h)
    before = _e_counts()
    got = fused_bottleneck.fused_bottleneck(x, *ops)
    ref = fused_bottleneck.reference_fused_bottleneck(x, *ops)
    torch.cuda.synchronize()
    assert _e_counts(before) == ((0, 1, 0) if dtype == torch.bfloat16 else (0, 0, 1))
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert _rel_err(got, ref) <= FUSED_RTOL[dtype]


@pytest.mark.parametrize("m", [64, 256, 512])
def test_fused_bottleneck_mma_masks_the_halo(cuda_device, m):
    """b1 = 2.0 on the bf16 route (E-mma): relu(b1) would leak into T1
    outside the image; E-mma zeroes it and agrees with the plain chain."""
    x, ops = _e_inputs(cuda_device, 1, 4 * m, m, 11, 13, torch.bfloat16, seed=m,
                       b1=torch.full((m,), 2.0, device=cuda_device))
    before = _e_counts()
    got = fused_bottleneck.fused_bottleneck(x, *ops)
    assert _e_counts(before) == (0, 1, 0)
    ref = fused_bottleneck.reference_fused_bottleneck(x, *ops)
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.bfloat16]


def test_fused_bottleneck_mma_is_deterministic(cuda_device):
    """Each output is one CTA's fixed sequence of MMAs: two calls agree bit
    for bit, at a clustered plan (M = 512, clusters of 8)."""
    x, ops = _e_inputs(cuda_device, 1, 2048, 512, 24, 40, torch.bfloat16, seed=9)
    first = fused_bottleneck.launch_mma(x, *ops)
    assert torch.equal(first, fused_bottleneck.launch_mma(x, *ops))


def test_fused_bottleneck_mma_refuses_fp32_and_foreign_widths(cuda_device):
    """E-mma takes bf16 only, and only the widths it has a plan for."""
    x, ops = _e_inputs(cuda_device, 1, 256, 64, 16, 16, torch.float32, seed=2)
    with pytest.raises(TypeError, match="takes bfloat16"):
        fused_bottleneck.launch_mma(x, *ops)
    x, ops = _e_inputs(cuda_device, 1, 256, 96, 16, 16, torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="takes M in"):
        fused_bottleneck.launch_mma(x, *ops)


def test_fused_bottleneck_simt_still_takes_bf16(cuda_device):
    """``launch_simt`` runs the SIMT kernel at bf16 (for timing beside
    E-mma), within the bf16 tolerance of plain."""
    x, ops = _e_inputs(cuda_device, 2, 1024, 256, 7, 5, torch.bfloat16, seed=4)
    before = _e_counts()
    got = fused_bottleneck.launch_simt(x, *ops)
    assert _e_counts(before) == (1, 0, 0)
    ref = fused_bottleneck.reference_fused_bottleneck(x, *ops)
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.bfloat16]


def test_fused_bottleneck_simt_still_takes_fp32(cuda_device):
    """``launch_simt`` runs the SIMT kernel at fp32 (for timing beside
    E-tf32), within the fp32 tolerance of plain."""
    x, ops = _e_inputs(cuda_device, 2, 1024, 256, 7, 5, torch.float32, seed=4)
    before = _e_counts()
    got = fused_bottleneck.launch_simt(x, *ops)
    assert _e_counts(before) == (1, 0, 0)
    ref = fused_bottleneck.reference_fused_bottleneck(x, *ops)
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.float32]


@pytest.mark.parametrize("m", [64, 256, 512])
def test_fused_bottleneck_kernel_masks_the_halo(cuda_device, m):
    """b1 = 2.0 on the fp32 route (E-tf32): relu(b1) would leak into T1
    outside the image; the kernel zeroes it and agrees with the plain chain
    (fp32)."""
    c = 4 * m
    ops = _bottleneck_operands(cuda_device, c, m, seed=m,
                               b1=torch.full((m,), 2.0, device=cuda_device))
    x = _channels_last(torch.randn(1, c, 11, 13, device=cuda_device))
    before = _e_counts()
    got = fused_bottleneck.fused_bottleneck(x, *ops)
    assert _e_counts(before) == (0, 0, 1)
    assert _rel_err(got, fused_bottleneck.reference_fused_bottleneck(x, *ops)) <= 1e-5


@pytest.mark.parametrize("n,c,m,h,w", FUSED_E_CASES)
def test_fused_bottleneck_tf32_masks_the_halo_at_every_map(cuda_device, n, c, m, h, w):
    """E-tf32 with b1 in [0.5, 1.5] and x >= 0 (post-ReLU), at every width
    on the 768x1280 bucket's maps and on ragged ones: a T1 left at relu(b1)
    outside the image, or a tile edge read past the map, would miss the
    plain chain's 1e-5."""
    b1 = torch.rand(m, device=cuda_device, generator=torch.Generator(device=cuda_device)
                    .manual_seed(m)) + 0.5
    x, ops = _e_inputs(cuda_device, n, c, m, h, w, torch.float32, seed=c + w, b1=b1)
    got = fused_bottleneck.launch_tf32(x, *ops)
    ref = fused_bottleneck.reference_fused_bottleneck(x, *ops)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, ref) <= FUSED_RTOL[torch.float32]


def test_fused_bottleneck_tf32_is_deterministic(cuda_device):
    """Each output is one CTA's fixed sequence of MMAs: two calls agree bit
    for bit, at a clustered plan (M = 512, clusters of 4)."""
    x, ops = _e_inputs(cuda_device, 1, 2048, 512, 24, 40, torch.float32, seed=9)
    first = fused_bottleneck.launch_tf32(x, *ops)
    assert torch.equal(first, fused_bottleneck.launch_tf32(x, *ops))


def test_fused_bottleneck_tf32_refuses_bf16_and_foreign_widths(cuda_device):
    """E-tf32 takes fp32 only, and only the widths it has a plan for."""
    x, ops = _e_inputs(cuda_device, 1, 256, 64, 16, 16, torch.bfloat16, seed=2)
    with pytest.raises(TypeError, match="takes float32"):
        fused_bottleneck.launch_tf32(x, *ops)
    x, ops = _e_inputs(cuda_device, 1, 256, 96, 16, 16, torch.float32, seed=2)
    with pytest.raises(ValueError, match="takes M in"):
        fused_bottleneck.launch_tf32(x, *ops)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_detr_on_the_card(cuda_device, dtype):
    """A reduced-depth fused DETR on the card: C once, D on each block_0,
    E on each identity block without a mask and none with one; D on D-tf32
    at fp32 and on D-mma at bf16, E on E-tf32 at fp32 and on E-mma at bf16. fp32 outputs against the
    unfused model from the same weights (TF32 off), with nonzero BN
    shifts; at bf16, c5 of the bucket-exact forward (E-mma in every
    identity block) and of the masked one (D-mma in every block) against
    the unfused fp32 model's, within FUSED_BF16_C5_RATIO times the unfused
    bf16 model's own gap."""
    cfg = dict(backbone_stage_sizes=(2, 2, 2, 2), num_encoder_layers=1, num_decoder_layers=1,
               device=cuda_device, dtype=dtype)
    fused = api.build_detr(fuse_residual=True, fuse_bottleneck=True, **cfg)
    plain = api.build_detr(**cfg)
    gen = torch.Generator().manual_seed(3)
    state = {k: (v + 0.1 * torch.randn(v.shape, generator=gen).to(v.device, v.dtype)
                 if k.endswith(("bn1.bias", "bn2.bias", "bn3.bias", "running_mean")) else v)
             for k, v in plain.module.state_dict().items()}
    for m in (fused, plain):
        m.module.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 256, 384, 3)).astype(np.float32))
    x = x.to(cuda_device)
    mask = torch.zeros((1, 256, 384), dtype=torch.bool, device=cuda_device)
    mask[:, :200, :301] = True
    mma = dtype == "bfloat16"
    for pixel_mask, d, e in ((None, 4, 4), (mask, 8, 0)):
        def counts():
            return (maxpool.max_pool_3x3_s2.launches, *_d_counts(), *_e_counts())

        before = counts()
        out = fused(x, pixel_mask)
        after = counts()
        assert tuple(a - b for a, b in zip(after, before)) == (
            1, 0, d if mma else 0, 0 if mma else d, 0, e if mma else 0, 0 if mma else e)
        if mma:
            assert all(bool(torch.isfinite(v).all()) for v in out.values())
            continue
        ref = plain(x, pixel_mask)
        assert float((out["pred_boxes"] - ref["pred_boxes"]).abs().max()) <= 5e-4
        assert float((out["pred_logits"] - ref["pred_logits"]).abs().max()) <= 5e-3
    if mma:
        fp32 = api.build_detr(**{**cfg, "dtype": "float32"})
        fp32.module.load_state_dict(state)
        for pixel_mask in (None, mask):
            with torch.inference_mode():
                c5 = [m.module.backbone(x.to(m.module.dtype), pixel_mask)
                      for m in (fp32, fused, plain)]
            assert all(bool(torch.isfinite(v).all()) for v in c5)
            gap_fused, gap_plain = (_rel_err(v, c5[0]) for v in c5[1:])
            assert gap_fused <= FUSED_BF16_C5_RATIO * gap_plain, (pixel_mask is None, gap_fused,
                                                                  gap_plain)


def _train_batch(device, b=1, seed=3):
    from detr_tensorflow_tpu_torch.data import pad_targets
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(pad_targets(
        np.concatenate([rng.uniform(0.2, 0.8, (4, 2)), rng.uniform(0.05, 0.4, (4, 2))], -1),
        rng.integers(0, 91, size=4)) for _ in range(b)))
    return batch_to_device({"images": rng.normal(size=(b, 128, 192, 3)).astype(np.float32),
                            "boxes": np.stack(boxes), "classes": np.stack(classes),
                            "mask": np.stack(mask)}, device)


def test_bf16_train_step_launches_the_tensor_core_kernels(cuda_device):
    """One bf16 ``Trainer`` step of a DETR with the full 6 + 6 transformer
    (reduced backbone) at dropout 0.1: 18 bf16 tensor-core attention
    forwards (A-mma with dropout), 18 bf16 tensor-core backwards (A'-bf16),
    no SIMT forward or backward, no 3xTF32 kernel, one LAP launch, one max
    pool; every parameter, gradient and Adam moment float32."""
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    config = TrainingConfig(background_class=91, train_backbone=True, train_transformers=True,
                            batch_size=1)
    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), dtype="bfloat16",
                           device=cuda_device).module
    trainer = Trainer(model, config, seed=0)
    batch, logs = _train_batch(cuda_device), []
    pool, mma = maxpool.max_pool_3x3_s2.launches, fa.mha.mma_launches
    assert _counts(lambda: logs.append(trainer.step(batch))) == (0, 0, 0, 0, 18, 1)
    assert fa.mha.mma_launches == mma + 18 and maxpool.max_pool_3x3_s2.launches == pool + 1
    assert bool(torch.isfinite(logs[0]["total_loss"]))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(t.dtype == torch.float32 for s in trainer.optimizer.adam.state.values()
               for t in s.values() if isinstance(t, torch.Tensor) and t.dim())


def test_bf16_predictor_launches_as_before_and_casts_once(cuda_device):
    """A bf16 ``Predictor`` (full 6 + 6 transformer, reduced backbone): each
    request launches A-mma 18 times and C once, no other attention kernel;
    ``warmup`` fills the cast copies of the float32 parameters, and a
    request after it casts nothing (every cached copy is the same tensor)."""
    from detr_tensorflow_tpu_torch.predictor import Predictor

    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), dtype="bfloat16",
                           device=cuda_device)
    assert {p.dtype for p in model.module.parameters()} == {torch.float32}
    predictor = Predictor(model, background_class=91)
    predictor.warmup([(200, 300)])

    def copies():
        return {(n, k): hit[1] for n, m in model.module.named_modules()
                for k, hit in getattr(m, "_cache", {}).items() if k[0] == "cast"}

    warm = copies()
    assert warm and all(t.dtype == torch.bfloat16 for t in warm.values())
    img = np.random.default_rng(5).integers(0, 255, (200, 300, 3), dtype=np.uint8)
    for _ in range(2):
        before, pool = _forward_counts(), maxpool.max_pool_3x3_s2.launches
        predictor([img])
        assert _forward_counts(before) == (0, 18, 0)
        assert maxpool.max_pool_3x3_s2.launches == pool + 1
        now = copies()
        assert now.keys() == warm.keys() and all(now[k] is t for k, t in warm.items())


def test_fused_and_int8_bf16_models_launch_from_float32_parameters(cuda_device):
    """The bf16 fused and int8 models keep float32 parameters and still run
    their kernels: the fused one D-mma and E-mma (bucket-exact forward), the
    int8 one F and G."""
    cfg = dict(backbone_stage_sizes=(2, 1, 1, 1), num_encoder_layers=1, num_decoder_layers=1,
               device=cuda_device, dtype="bfloat16")
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 128, 192, 3)).astype(np.float32))
    x = x.to(cuda_device)
    fused = api.build_detr(fuse_residual=True, fuse_bottleneck=True, **cfg)
    int8 = api.build_detr(backbone_quant=True, **cfg)
    quantized.quantize_model(int8, x)
    for model in (fused, int8):
        assert {p.dtype for p in model.module.parameters()} == {torch.float32}
    d, e = _d_counts(), _e_counts()
    assert torch.isfinite(fused(x)["pred_boxes"]).all()
    assert _d_counts(d) == (0, 4, 0) and _e_counts(e) == (0, 1, 0)
    f, g = int8_matmul.qmatmul.launches, sum(int8_conv.conv3x3_int8.launches.values())
    assert torch.isfinite(int8(x)["pred_boxes"]).all()
    assert int8_matmul.qmatmul.launches - f == 5
    assert sum(int8_conv.conv3x3_int8.launches.values()) - g == 5


def test_float64_is_refused_on_the_card(cuda_device):
    """float64 runs on the CPU only, for diagnosis: on the card the
    attention and the max pool raise, and ``Trainer`` refuses a float64
    model."""
    from detr_tensorflow_tpu_torch.models.detr import DETR
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    q, k, v, mask = _inputs(cuda_device, torch.float64, 1, 16, 16, 2, 32, seed=0)
    with pytest.raises(TypeError):
        fa.mha(q, k, v, mask)
    x = _channels_last(torch.rand(1, 4, 9, 11, device=cuda_device, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maxpool.max_pool_3x3_s2(x, nonneg=True)
    model = DETR(dtype=torch.float64, backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=1,
                 num_decoder_layers=1).double().to(cuda_device)
    with pytest.raises(ValueError, match="CPU"):
        Trainer(model, TrainingConfig())


@pytest.mark.parametrize("kernel", ["bf16", "simt"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_bf16_ds_rows_sum_to_zero(cuda_device, rate, kernel):
    """A bf16 backward on keys and values with a large common component, as
    DETR's cross-attention keys (memory + pos): A'-bf16 (through ``mha``,
    the route bf16 takes) and the SIMT A' (called directly). Softmax's dS
    rows sum to zero, so sum_j dK_j = sum_i q_i sum_j dS_ij vanishes up to
    rounding. Both kernels' delta is sum_j p_ij m_ij dO_i . v_j in fp32,
    not rowsum(dO * O) with O rounded to bf16 (which left each row's sum at
    O's rounding and made sum_j dK_j ~60x larger here): the kernel's
    ||sum_j dK_j||, relative to ||dK||, is within 3x plain autograd's at
    bf16, whose dS is fp32."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    b, lq, lk, h, dh = 8, 100, 252, 8, 32

    def normal(*shape, mean=0.0):
        return (mean + torch.randn(shape, device=cuda_device, generator=gen)).bfloat16()

    q = normal(b, lq, h, dh) * dh**-0.5
    k, v, dout = normal(b, lk, h, dh, mean=2.0), normal(b, lk, h, dh, mean=4.0), normal(b, lq, h, dh)
    seed = torch.tensor([77], device=cuda_device)
    keep = fa.kernel_keep_mask(seed, b * h, lq, lk, rate).view(b, h, lq, lk) if rate else None
    before = _backward_counts()
    if kernel == "bf16":
        _, _, dk, _ = _grads(lambda *t: fa.mha(*t, None, rate, seed), q, k, v, dout)
    else:
        out, lse = fa.launch_forward(q, k, v, None, seed, rate, True)
        _, dk, _ = fa.launch_backward_simt(q, k, v, out, dout, lse, None, seed, rate)
    assert _backward_counts(before) == ((0, 1, 0) if kernel == "bf16" else (0, 0, 1))
    _, _, dk_ref, _ = _grads(lambda *t: fa.reference_mha(*t, None, keep, rate), q, k, v, dout)

    def key_sum(g):
        g = g.float()
        return float(g.sum(dim=1).norm()) / float(g.norm())

    assert key_sum(dk) <= 3 * key_sum(dk_ref), (key_sum(dk), key_sum(dk_ref))
    assert _rel_err(dk, dk_ref) <= GRAD_RTOL[torch.bfloat16]


# A'-bf16 called directly where the training shapes do not reach: Dh 64,
# ragged Lq and Lk (not multiples of 16, 32 or 64: the keep words and the
# tiles end mid-way, and at Lk 37 a dK/dV CTA's last two warps hold no key),
# and a batch element whose keys are all padded (uniform softmax over the
# keys, as the plain version).
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,lq,lk,dh,padded_row", [
    (3, 37, 5, 64, False), (2, 77, 129, 64, False), (3, 37, 70, 32, True),
    (2, 130, 300, 64, True), (1, 200, 37, 32, False)])
def test_attention_backward_bf16_ragged_and_padded(cuda_device, b, lq, lk, dh, padded_row, rate):
    args, ref = _backward_case(cuda_device, torch.bfloat16, b, lq, lk, dh, rate, padded_row)
    before = fa.mha.backward_bf16_launches
    got = fa.launch_backward_bf16(*args)
    torch.cuda.synchronize()
    assert fa.mha.backward_bf16_launches == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel_err(g, r) <= GRAD_RTOL[torch.bfloat16]


def test_attention_backward_bf16_is_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    args, _ = _backward_case(cuda_device, torch.bfloat16, 8, 100, 252, 32, 0.1)
    first = fa.launch_backward_bf16(*args)
    second = fa.launch_backward_bf16(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_attention_backward_bf16_rejects_fp32(cuda_device):
    args, _ = _backward_case(cuda_device, torch.float32, 2, 16, 16, 32, 0.0)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.launch_backward_bf16(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefetch_equals_a_synchronous_copy(cuda_device, dtype):
    """``Trainer.prefetch`` (pinned host memory, a side stream, ``depth``
    batches ahead): every batch bit-equal to a synchronous ``.to("cuda")``
    of the same numpy batch, images cast to bf16 on the host for a bf16
    model (the values of ``.to(torch.bfloat16)`` on the card), while the
    consumer's stream runs work of its own between batches; a batch already
    on the card passes through (its images cast alike)."""
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    model = api.build_detr(num_classes=5, num_queries=6, model_dim=32, num_heads=2,
                           num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32,
                           backbone_stage_sizes=(1, 1, 1, 1), dtype=dtype, device="cuda")
    trainer = Trainer(model.module, TrainingConfig(train_transformers=True))
    rng = np.random.default_rng(0)
    batches = [{"images": rng.normal(size=(2, 96, 128, 3)).astype(np.float32),
                "pixel_mask": rng.random((2, 96, 128)) < 0.9,
                "boxes": rng.random((2, 6, 4)).astype(np.float32),
                "classes": rng.integers(0, 5, (2, 6)).astype(np.int32),
                "mask": rng.random((2, 6)) < 0.5} for _ in range(6)]
    on_card = batch_to_device(batches[0], "cuda")
    busy = torch.randn(2048, 2048, device="cuda")
    seen = []
    for batch in trainer.prefetch(batches + [on_card], depth=3):
        busy = busy @ busy / 2048  # the consumer stream's own work
        seen.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert len(seen) == len(batches) + 1
    for got, batch in zip(seen, batches + [on_card]):
        want = batch_to_device(batch, "cuda")
        if dtype == "bfloat16":
            want["images"] = want["images"].to(torch.bfloat16)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


# DC5 (the last stage dilated, C5 at stride 16), remat, and checkpoints on the card.
DC5_CFG = dict(backbone_stage_sizes=(1, 1, 1, 2), dilation=True, num_encoder_layers=2,
               num_decoder_layers=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dc5_forward_matches_plain_route(cuda_device, dtype):
    """A reduced-depth DC5 DETR at a 512x768 bucket with a pixel mask
    (32x48 = 1536 keys): the kernel route (A-tf32 at fp32, A-mma at bf16, 6
    launches a forward) against the plain-attention route from the same
    weights: fp32 within the golden tolerances (TF32 off), bf16 within
    tests/test_torch_bf16.py's direct bounds."""
    models = [api.build_detr(attn_impl=impl, dtype=dtype, device=cuda_device, **DC5_CFG)
              for impl in ("auto", "plain")]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 512, 768, 3)).astype(np.float32)).to(cuda_device)
    mask = torch.zeros((1, 512, 768), dtype=torch.bool, device=cuda_device)
    mask[:, :450, :700] = True
    before = _forward_counts()
    out = models[0](x * mask[..., None], mask)
    mma = dtype == "bfloat16"
    assert _forward_counts(before) == (0, 6 * mma, 6 * (not mma))
    ref = models[1](x * mask[..., None], mask)
    tol = {"pred_boxes": 1.5e-2, "pred_logits": 7.5e-2} if mma else {"pred_boxes": 5e-4,
                                                                      "pred_logits": 5e-3}
    for key, atol in tol.items():
        assert float((out[key] - ref[key]).abs().max()) <= atol, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_the_card(cuda_device, dtype):
    """A DC5 forward and backward at dropout 0.1 on the card with ``remat``
    and ``backbone_remat=2``: every attention call's seed and every keep
    mask replayed from the generator in the recompute, so the loss and the
    gradients lie no further from the run without remat than twice a
    second run without remat does (cuDNN's reductions may sum in another
    order from one run to the next; floor 1e-6 of each tensor's norm), the
    generator ends in the same state, and the recompute launches the
    attention forward a second time (12 launches with 2 + 2 layers, 6
    without)."""
    from detr_tensorflow_tpu_torch.ops.losses import detr_loss

    batch = _train_batch(cuda_device, b=2)
    runs = []
    for kw in ({}, {}, dict(remat=True, backbone_remat=2)):
        model = api.build_detr(dropout=0.1, dtype=dtype, device=cuda_device, **DC5_CFG,
                               **kw).module
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        before = _forward_counts()
        out = model(batch["images"], train=True, generator=gen)
        total, _ = detr_loss(out, batch["boxes"], batch["classes"], batch["mask"], 91)
        total.backward()
        runs.append((total.detach(), {n: p.grad for n, p in model.named_parameters()},
                     gen.get_state(), sum(_forward_counts(before))))
    (l0, g0, s0, n0), (l2, g2, s2, _), (l1, g1, s1, n1) = runs
    assert (n0, n1) == (6, 12) and torch.equal(s0, s1) and torch.equal(s0, s2)

    def allowed(a, b, ref):
        return 2 * max(float((b - a).norm()), 1e-6 * float(ref.norm()), 1e-30)

    assert float((l1 - l0).abs()) <= allowed(l0, l2, l0)
    for name, g in g0.items():
        assert float((g1[name] - g).norm()) <= allowed(g, g2[name], g), name


def test_save_and_load_on_the_card(cuda_device, tmp_path):
    """``DetrModel.save`` of a DC5 model on the card and
    ``build_detr(weights=.npz)`` on the card: every tensor and the outputs
    bit-equal; ``DetrModel.load`` into a model of another seed the same."""
    model = api.build_detr(seed=1, device=cuda_device, **DC5_CFG)
    path = str(tmp_path / "dc5.npz")
    model.save(path)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 256, 384, 3)).astype(
        np.float32)).to(cuda_device)
    ref = model(x)
    for other in (api.build_detr(weights=path, device=cuda_device, **DC5_CFG),
                  api.build_detr(seed=2, device=cuda_device, **DC5_CFG).load(path)):
        state, want = other.module.state_dict(), model.module.state_dict()
        assert all(torch.equal(state[k], want[k]) for k in want)
        out = other(x)
        assert all(torch.equal(out[k], ref[k]) for k in ref)


# The segmentation model: DETR-R50's widths, reduced depth.
SEGM_CFG = dict(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=2, num_decoder_layers=2,
                masks=True)


def _segm_input(device, h=256, w=384, vh=230, vw=301, seed=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(1, h, w, 3)).astype(np.float32))
    mask = torch.zeros((1, h, w), dtype=torch.bool)
    mask[:, :vh, :vw] = True
    return (x * mask[..., None]).to(device), mask.to(device)


def test_segm_forward_on_the_card_matches_the_cpu(cuda_device):
    """A reduced-depth segmentation DETR with a pixel mask on the card
    (fp32, TF32 off: A-tf32 6 launches, C 1) against the same model on the
    CPU: boxes 5e-4, logits 5e-3, pred_masks 1e-3 (the CPU parity tests'
    bounds)."""
    cpu = api.build_detr(device="cpu", **SEGM_CFG)
    card = api.build_detr(device=cuda_device, **SEGM_CFG)
    x, mask = _segm_input(cuda_device)
    before, pool = _forward_counts(), maxpool.max_pool_3x3_s2.launches
    out = card(x, mask)
    torch.cuda.synchronize()
    assert _forward_counts(before) == (0, 0, 6)
    assert maxpool.max_pool_3x3_s2.launches - pool == 1
    ref = cpu(x.cpu(), mask.cpu())
    assert out["pred_masks"].shape == (1, 100, 64, 96) and out["pred_masks"].dtype == torch.float32
    for key, atol in (("pred_boxes", 5e-4), ("pred_logits", 5e-3), ("pred_masks", 1e-3)):
        assert float((out[key].cpu() - ref[key]).abs().max()) <= atol, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segm_kernel_route_matches_plain_route(cuda_device, dtype):
    """The segmentation model's kernel route (A-tf32 or A-mma) against its
    plain-attention route on the card, from the same weights: fp32 within
    the golden tolerances and 1e-3 on pred_masks; bf16 within
    tests/test_torch_bf16.py's direct bounds, pred_masks float32 within
    5e-2."""
    models = [api.build_detr(attn_impl=impl, dtype=dtype, device=cuda_device, **SEGM_CFG)
              for impl in ("auto", "plain")]
    x, mask = _segm_input(cuda_device)
    out, ref = (m(x, mask) for m in models)
    assert out["pred_masks"].dtype == torch.float32
    tol = ({"pred_boxes": 1.5e-2, "pred_logits": 7.5e-2, "pred_masks": 5e-2}
           if dtype == "bfloat16" else
           {"pred_boxes": 5e-4, "pred_logits": 5e-3, "pred_masks": 1e-3})
    for key, atol in tol.items():
        assert float((out[key] - ref[key]).abs().max()) <= atol, key


def test_predictor_masks_on_the_card(cuda_device):
    """``Predictor(masks=True)`` on the card against the same weights on the
    CPU, a padded and a bucket-exact image: labels equal, boxes within 1e-3,
    each mask bool at its image's size, equal wherever the CPU's
    probability is further than 1e-3 from the threshold."""
    from detr_tensorflow_tpu_torch import inference
    from detr_tensorflow_tpu_torch.predictor import Predictor

    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((200, 300), (256, 256))]
    preds = [Predictor(api.build_detr(device=d, **SEGM_CFG), background_class=91, masks=True)
             for d in (cuda_device, "cpu")]
    preds[0].warmup([(200, 300)])
    for img, a, b in zip(images, *(p(images) for p in preds)):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3, rtol=0)
        assert a.masks.dtype == bool and a.masks.shape == (len(a.labels),) + img.shape[:2]
        h, w = img.shape[:2]
        frames = np.zeros((1, 256, 384 if w > 256 else 256, 3), np.uint8)
        frames[0, :h, :w] = img
        pm = np.zeros(frames.shape[:3], bool)
        pm[0, :h, :w] = True
        (_, _, _, keep), probs = preds[1]._run(frames, None if pm.all() else pm)
        p = inference.upsample_mask_probs(probs[0].numpy()[keep[0].numpy()],
                                          (h, w)).transpose(2, 0, 1)
        far = np.abs(p - 0.5) > 1e-3
        assert np.array_equal(a.masks[far], b.masks[far])


def test_frozen_detector_mask_step_on_the_card(cuda_device):
    """The mask-head training step of the frozen-detector recipe on the card
    at dropout 0.1: A-tf32 6 a step (2 + 2 layers), the attention backward
    never (the transformer takes no gradient), B 1, C 1; the loss is finite
    with mask_loss and dice_loss logged; only the mask head and the
    attention-map projections move."""
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    batch = _train_batch(cuda_device, b=2)
    batch["t_masks"] = (torch.rand((2, 100, 32, 48), device=cuda_device) < 0.3).to(torch.uint8)
    model = api.build_detr(device=cuda_device, dropout=0.1, **SEGM_CFG).module
    before = {k: v.clone() for k, v in model.state_dict().items()}
    config = TrainingConfig(train_backbone=False, train_transformers=False, train_nlayers=True,
                            target_batch=None, background_class=91)
    trainer = Trainer(model, config, seed=0)
    counts = lambda: (fa.mha.tf32_launches, fa.mha.backward_mma_launches,  # noqa: E731
                      fa.mha.backward_launches, lap.solve_lap_masked.launches,
                      maxpool.max_pool_3x3_s2.launches)
    start = counts()
    log = trainer.step(batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), start)) == (6, 0, 0, 1, 1)
    assert bool(torch.isfinite(log["total_loss"])) and {"mask_loss", "dice_loss"} <= set(log)
    for name, value in model.state_dict().items():
        moved = not torch.equal(value, before[name])
        assert moved == name.startswith(("mask_head.", "bbox_attention.")), name


@pytest.mark.parametrize("hw,kept", [((800, 1333), 100), ((427, 640), 7), ((61, 77), 0)])
def test_device_merge_matches_np_merge_full_res(cuda_device, hw, kept):
    """The panoptic merge at full resolution on the card
    (``inference.kept_probs`` then ``merge_full_res``) against the host's
    ``np_merge_full_res(upsample_mask_probs(...))`` on the same
    probabilities: the winning query equal at every pixel whose two best
    weighted scores lie further apart than 1e-5 and whose winner's
    probability lies further than 1e-5 from the threshold (-1 there)."""
    from detr_tensorflow_tpu_torch import inference

    h, w = hw
    rng = np.random.default_rng(h + kept)
    q, hs, ws = 100, -(-h // 128) * 32, -(-w // 128) * 32  # the 128-bucket's stride-4 lattice
    probs = rng.random((q, hs, ws)).astype(np.float32)
    keep = np.zeros(q, bool)
    keep[rng.permutation(q)[:kept]] = True
    scores = rng.random(q).astype(np.float32)[keep]
    up = inference.kept_probs(torch.from_numpy(probs).to(cuda_device), keep, h, w)
    got = inference.merge_full_res(up, scores)
    assert got.dtype == np.int32 and got.shape == (h, w)
    if not kept:  # no query kept: -1 everywhere, as the eval's merge gives
        assert (got == -1).all()
        return
    host_up = inference.upsample_mask_probs(probs[keep], (h, w))
    want = inference.np_merge_full_res(host_up, scores, np.ones(kept, bool))
    top2 = np.sort(host_up * scores, axis=-1)[..., -2:]
    best_prob = np.take_along_axis(host_up, (host_up * scores).argmax(-1)[..., None], -1)[..., 0]
    far = (top2[..., 1] - top2[..., 0] > 1e-5) & (np.abs(best_prob - 0.5) > 1e-5)
    assert far.mean() > 0.9
    np.testing.assert_array_equal(got[far], want[far])


# Serving artifacts: the kernels on the serving paths are torch.library ops.
def _opcheck_cases(device):
    g = torch.Generator(device=device).manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def i8(*shape, low=-128):
        return torch.randint(low, 128, shape, generator=g, dtype=torch.int8, device=device)

    q, k, v = r(2, 100, 8, 32), r(2, 160, 8, 32), r(2, 160, 8, 32)
    kpm = torch.zeros(2, 160, dtype=torch.bool, device=device)
    kpm[1, 120:] = True
    cl = torch.channels_last
    seed = torch.tensor([11], device=device)
    m, c = 256, 128
    scale, bias = (r(c).abs() + 0.5) * 1e-3, r(c)
    cases = {
        "mha_forward": [(q, k, v, kpm, None, 0.0, False), (q, k, v, None, None, 0.0, True),
                        (q, k, v, kpm, seed, 0.1, True)]
        + [(q.bfloat16(), k.bfloat16(), v.bfloat16(), kpm, s, p, lse)
           for s, p, lse in ((None, 0.0, False), (seed, 0.1, True))],
        "max_pool_3x3_s2": [(r(1, 64, 37, 50).relu().contiguous(memory_format=cl).to(dt),)
                            for dt in (torch.float32, torch.bfloat16)],
        "conv1x1_bn_residual_relu": [
            (r(1, 128, 12, 20).contiguous(memory_format=cl).to(dt), (r(256, 128) * 0.1).to(dt),
             r(256), r(256), r(1, 256, 12, 20).contiguous(memory_format=cl).to(dt))
            for dt in (torch.float32, torch.bfloat16)],
        "fused_bottleneck": [
            (r(1, 256, 16, 24).contiguous(memory_format=cl).to(dt), (r(256, 64) * 0.05).to(dt),
             r(64), (r(9, 64, 64) * 0.05).to(dt), r(64), (r(64, 256) * 0.05).to(dt), r(256))
            for dt in (torch.float32, torch.bfloat16)],
        "int8_matmul": [
            (i8(m, c, low=0), i8(c, c), scale, bias, None, None, None, None, None, None, True,
             torch.int8, True),
            (i8(m, c, low=0), i8(c, c), scale, bias, i8(m, c, low=0), torch.tensor(0.02).to(device),
             None, None, None, None, True, torch.bfloat16, False),
            (i8(m, c, low=0), i8(c, c), scale, bias, None, None, i8(m, c), i8(c, c), scale, bias,
             True, torch.int8, True)],
        "int8_conv3x3": [(i8(1, 16, 24, c, low=0), i8(64, 3, 3, c), scale[:64], bias[:64], s,
                          True, torch.int8, True) for s in (1, 2)],
    }
    return cases


@pytest.mark.parametrize("name", ["mha_forward", "max_pool_3x3_s2", "conv1x1_bn_residual_relu",
                                  "fused_bottleneck", "int8_matmul", "int8_conv3x3"])
def test_op_fake_agrees_with_the_kernel(cuda_device, name):
    """``torch.library.opcheck`` on CUDA tensors: the fake implementation
    gives the kernel's output shapes, dtypes and strides (channels_last for
    C, D and E), and the op's schema, autograd registration and traced
    dispatch hold."""
    op = getattr(torch.ops.detr_torch, name).default
    for args in _opcheck_cases(cuda_device)[name]:
        torch.library.opcheck(op, args)
        out = op(*args)
        fake = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
        for o, f in zip(out if isinstance(out, tuple) else (out,),
                        fake if isinstance(fake, tuple) else (fake,)):
            assert (o.shape, o.dtype, o.stride()) == (f.shape, f.dtype, f.stride())


def _artifact_counts():
    d, e = fused_residual.conv1x1_bn_residual_relu, fused_bottleneck.fused_bottleneck
    return {"A-tf32": fa.mha.tf32_launches, "A-mma": fa.mha.mma_launches, "A": fa.mha.launches,
            "C": maxpool.max_pool_3x3_s2.launches, "D-tf32": d.tf32_launches,
            "D-mma": d.mma_launches, "E-tf32": e.tf32_launches, "E-mma": e.mma_launches}


def _request_counts(pred, images):
    before = _artifact_counts()
    dets = pred(images)
    torch.cuda.synchronize()
    return dets, {k: v - before[k] for k, v in _artifact_counts().items() if v != before[k]}


@pytest.mark.parametrize("dtype,flags", [
    ("float32", {}), ("bfloat16", dict(fuse_residual=True, fuse_bottleneck=True))])
def test_artifact_on_the_card_equals_the_live_predictor(cuda_device, tmp_path, dtype, flags):
    """A reduced-depth model's artifact exported, loaded and served on the
    card: the live Predictor's detections, bit for bit, and its launches
    per request (fused: a bucket-exact request runs the unmasked program,
    kernel E, a padded one the masked program, kernel D only)."""
    from detr_tensorflow_tpu_torch.export import export_predictor, load_predictor
    from detr_tensorflow_tpu_torch.predictor import Predictor

    model = api.build_detr(backbone_stage_sizes=(2, 1, 1, 1), num_encoder_layers=2,
                           num_decoder_layers=2, dtype=dtype, device=cuda_device, **flags)
    live = Predictor(model, background_class=91)
    shapes = [(128, 256), (100, 230)]
    live.warmup(shapes)
    export_predictor(live, str(tmp_path), shapes)
    loaded = load_predictor(str(tmp_path))
    loaded.warmup(shapes)
    rng = np.random.default_rng(0)
    for size in shapes + [(120, 250)] * 2:
        images = [rng.integers(0, 256, size=size + (3,), dtype=np.uint8)]
        ours, live_n = _request_counts(loaded, images)
        ref, art_n = _request_counts(live, images)
        # 2 encoder self, 2 decoder self and 2 decoder cross attentions
        assert live_n == art_n and live_n[("A-tf32" if dtype == "float32" else "A-mma")] == 6
        if flags:
            exact = size == (128, 256)
            tail = "D-mma" if dtype == "bfloat16" else "D-tf32"
            assert live_n[tail] == (4 if exact else 5)
            assert live_n.get("E-mma" if dtype == "bfloat16" else "E-tf32", 0) == exact
        for a, b in zip(ours, ref):
            for field in ("boxes", "labels", "scores"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_cpu_exported_artifact_launches_the_kernels_on_the_card(cuda_device, tmp_path):
    """An artifact traced on the CPU names the ops, so loaded onto the card
    it launches A-tf32 and C, moved there by ``move_to_device_pass``."""
    from detr_tensorflow_tpu_torch.export import export_predictor, load_predictor
    from detr_tensorflow_tpu_torch.predictor import Predictor

    cpu = Predictor(api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=1,
                                   num_decoder_layers=1, device="cpu"), background_class=91)
    export_predictor(cpu, str(tmp_path), [(100, 150)])
    loaded = load_predictor(str(tmp_path), device=cuda_device)
    images = [np.random.default_rng(1).integers(0, 256, size=(100, 150, 3), dtype=np.uint8)]
    ours, counts = _request_counts(loaded, images)
    assert counts == {"A-tf32": 3, "C": 1}
    for a, b in zip(ours, cpu(images)):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=5e-4, rtol=0)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_step_through_the_attention_op(cuda_device, dtype):
    """A ``Trainer`` step (6 + 6 transformer, reduced backbone) since the
    attention forward became the op ``detr_torch::mha_forward``: autograd
    still runs its backward kernel, A'-mma at fp32 and A'-bf16 at bf16, 18
    times, beside 18 forwards, one LAP and one max pool launch."""
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    config = TrainingConfig(background_class=91, train_backbone=True, train_transformers=True,
                            batch_size=1)
    model = api.build_detr(backbone_stage_sizes=(1, 1, 1, 1), dtype=dtype,
                           device=cuda_device).module
    trainer = Trainer(model, config, seed=0)
    batch, logs = _train_batch(cuda_device), []
    fwd = fa.mha.mma_launches if dtype == "bfloat16" else fa.mha.tf32_launches
    pool = maxpool.max_pool_3x3_s2.launches
    counts = _counts(lambda: logs.append(trainer.step(batch)))
    assert counts == ((18, 0, 0, 18, 0, 1) if dtype == "float32" else (0, 0, 0, 0, 18, 1))
    now = fa.mha.mma_launches if dtype == "bfloat16" else fa.mha.tf32_launches
    assert now - fwd == 18 and maxpool.max_pool_3x3_s2.launches == pool + 1
    assert bool(torch.isfinite(logs[0]["total_loss"]))


# Parallelism across processes on the card: two Gloo ranks sharing cuda:0
# (NCCL refuses two ranks on one device), a reduced DETR (model_dim 64, 2
# heads of 32, one encoder and one decoder layer), started by
# torch_ranks.run_ranks (file rendezvous, 60 s collective timeout,
# every wait bounded).
CARD_TINY = dict(model_dim=64, num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
                 dim_feedforward=128, backbone_stage_sizes=(1, 1, 1, 1), dropout=0.0)

CARD_WORKER = '''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa, lap, losses, maxpool
    from detr_tensorflow_tpu_torch.parallel import tp
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    config = TrainingConfig(**spec["config"])
    shape = (2, 1) if sys.argv[4] == "dp" else (1, 2)
    mesh = make_mesh(2, ("data", "model"), shape)
    model = api.build_detr(seed=0, device="cuda", **spec["tiny"]).module
    trainer = Trainer(model, config, seed=0, mesh=mesh)
    b = {k: torch.as_tensor(v).cuda() for k, v in spec["batch"].items()}
    before = (fa.mha.tf32_launches, fa.mha.backward_mma_launches,
              lap.solve_lap_masked.launches, maxpool.max_pool_3x3_s2.launches)
    if sys.argv[4] == "dp":
        loss = float(trainer.step(shard_batch(b, mesh))["total_loss"])
    else:
        outputs = model(b["images"], train=True)
        total, _ = losses.detr_loss(outputs, b["boxes"], b["classes"], b["mask"], 91)
        total.backward()
        loss = float(total.detach())
    torch.cuda.synchronize()
    counts = tuple(a - c for a, c in zip((fa.mha.tf32_launches, fa.mha.backward_mma_launches,
                   lap.solve_lap_masked.launches, maxpool.max_pool_3x3_s2.launches), before))
    mg = trainer.model_group
    grads = {n: (p.grad if mg is None or tp.split_dim(n, p.dim()) is None
                 else tp.gather_tensor(p.grad, tp.split_dim(n, p.dim()), mg)).cpu()
             for n, p in model.named_parameters()}
    torch.save({"loss": loss, "counts": counts, "grads": grads}, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()
'''


def _card_batch():
    rng = np.random.default_rng(3)
    from detr_tensorflow_tpu_torch.data import pad_targets

    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.3, 0.7, (n, 2)), rng.uniform(0.1, 0.4, (n, 2))],
                                   -1), rng.integers(1, 90, size=n), 100) for n in (5, 3, 1, 1)))
    return {"images": rng.normal(size=(4, 128, 160, 3)).astype(np.float32),
            "boxes": np.stack(boxes), "classes": np.stack(classes), "mask": np.stack(mask)}


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_two_gloo_ranks_on_the_card(cuda_device, tmp_path, mode):
    """DP (2 x b2, 6 and 2 boxes) and TP (1 head a rank) with two Gloo
    ranks on cuda:0 against one process on the card: the loss within 1e-4
    relative, each gradient (clipped for DP, whole for TP) within 1e-3 of
    its norm (a tensor whose exact gradient is zero, every k_proj bias,
    within 1e-6 of the largest gradient); per rank A-tf32 3 and C 1 a
    forward, A'-mma 3 and B 1 a step."""
    from torch_ranks import run_ranks

    from detr_tensorflow_tpu_torch.ops import losses
    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    config = dict(background_class=91, train_backbone=True, train_transformers=True,
                  batch_size=4)
    spec = {"config": config, "tiny": CARD_TINY, "batch": _card_batch()}
    torch.save(spec, tmp_path / "spec.pt")
    run_ranks(CARD_WORKER, 2, tmp_path, mode)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    model = api.build_detr(seed=0, device=cuda_device, **CARD_TINY).module
    b = {k: torch.as_tensor(v).to(cuda_device) for k, v in spec["batch"].items()}
    if mode == "dp":
        loss = float(Trainer(model, TrainingConfig(**config), seed=0).step(b)["total_loss"])
    else:
        total, _ = losses.detr_loss(model(b["images"], train=True), b["boxes"], b["classes"],
                                    b["mask"], 91)
        total.backward()
        loss = float(total.detach())
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    scale = max(float(g.norm()) for g in grads.values())
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-4 * abs(loss)
        assert r["counts"] == (3, 3, 1, 1)
        for name, g in grads.items():
            diff = float((r["grads"][name] - g).norm())
            assert diff <= 1e-3 * float(g.norm()) or diff <= 1e-6 * scale, name


NCCL_WORKER = r'''
import os, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from detr_tensorflow_tpu_torch.models import api
from detr_tensorflow_tpu_torch.parallel import make_mesh, multihost
from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

out = sys.argv[1]
assert multihost.initialize(init_method="file://" + os.path.join(out, "rendezvous"),
                            num_processes=1, process_id=0, backend="nccl", timeout_s=60)
spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
model = api.build_detr(seed=0, device="cuda", **spec["tiny"]).module
trainer = Trainer(model, TrainingConfig(**spec["config"]), seed=0, mesh=make_mesh(1))
assert trainer.ddp is not None and torch.distributed.get_backend() == "nccl"
b = {k: torch.as_tensor(v).cuda() for k, v in spec["batch"].items()}
loss = float(trainer.step(b)["total_loss"])
torch.save({"loss": loss, "params": {n: p.detach().cpu() for n, p in model.named_parameters()}},
           os.path.join(out, "nccl.pt"))
multihost.shutdown()
'''


def test_nccl_world_one_step_on_the_card(cuda_device, tmp_path):
    """``multihost.initialize`` with NCCL at world size 1 and a
    ``Trainer(mesh=make_mesh(1))`` step (DDP over the one-rank NCCL group)
    against the plain Trainer's: the loss within 1e-4 relative, every
    parameter within 2 lr (Adam's step on a tensor whose exact gradient is
    zero may take the other sign)."""
    import os
    import subprocess
    import sys

    from detr_tensorflow_tpu_torch.train import Trainer, TrainingConfig

    config = dict(background_class=91, train_backbone=True, train_transformers=True,
                  batch_size=4)
    spec = {"config": config, "tiny": CARD_TINY, "batch": _card_batch()}
    torch.save(spec, tmp_path / "spec.pt")
    (tmp_path / "nccl.py").write_text(NCCL_WORKER)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    env.pop("WORLD_SIZE", None)
    done = subprocess.run([sys.executable, str(tmp_path / "nccl.py"), str(tmp_path)], env=env,
                          cwd=repo, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    got = torch.load(tmp_path / "nccl.pt", weights_only=False)
    model = api.build_detr(seed=0, device=cuda_device, **CARD_TINY).module
    b = {k: torch.as_tensor(v).to(cuda_device) for k, v in spec["batch"].items()}
    loss = float(Trainer(model, TrainingConfig(**config), seed=0).step(b)["total_loss"])
    assert abs(got["loss"] - loss) <= 1e-4 * abs(loss)
    for n, p in model.named_parameters():
        assert float((got["params"][n] - p.detach().cpu()).abs().max()) <= 2e-4, n


# Pipeline parallelism on the card: two Gloo ranks sharing cuda:0 as the
# two stages of a ("stage",) mesh, their boundaries staged through pinned
# host memory (parallel/p2p.py, route "gloo-host").
PIPE_CARD_WORKER = '''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa, lap, maxpool
    from detr_tensorflow_tpu_torch.parallel import detr_1f1b_value_and_grad, p2p, pp
    from detr_tensorflow_tpu_torch.parallel.detr_1f1b import keep_stage

    spec = torch.load(os.path.join(out, "spec.pt"), weights_only=False)
    mesh = make_mesh(2, ("stage",))
    result = {"route": p2p.route("cuda")}
    if sys.argv[4] == "p2p":
        gen = torch.Generator(device="cuda").manual_seed(5)
        tree = {"f": torch.randn(3, 5, 7, device="cuda", generator=gen),
                "h": torch.randn(2, 9, device="cuda", generator=gen).to(torch.bfloat16),
                "m": torch.rand(4, 3, device="cuda", generator=gen) > 0.5,
                "i": torch.arange(11, device="cuda") * 7}
        there, back = p2p.Link(1 - rank, 0, "cuda"), p2p.Link(1 - rank, 64, "cuda")
        if rank == 0:
            there.send(tree, 0)
            got = back.recv(0)
        else:
            got = there.recv(0)
            back.send(got, 0)
        p2p.drain()
        result.update(sent={k: v.cpu() for k, v in tree.items()},
                      got={k: v.cpu() for k, v in got.items()},
                      devices={k: str(v.device) for k, v in got.items()})
    else:
        model = api.build_detr(seed=0, device="cuda", **spec["tiny"]).module
        stage = pp.stage_of(mesh)
        keep_stage(model, stage.index, stage.size)
        b = {k: torch.as_tensor(v).cuda() for k, v in spec["batch"].items()}
        before = (fa.mha.tf32_launches, fa.mha.backward_mma_launches,
                  lap.solve_lap_masked.launches, maxpool.max_pool_3x3_s2.launches)
        loss, grads = detr_1f1b_value_and_grad(model, b, mesh, background_class=91, n_micro=2)
        torch.cuda.synchronize()
        counts = tuple(a - c for a, c in zip((fa.mha.tf32_launches, fa.mha.backward_mma_launches,
                       lap.solve_lap_masked.launches, maxpool.max_pool_3x3_s2.launches), before))
        result.update(loss=float(loss), counts=counts, grads={n: g.cpu() for n, g in grads.items()})
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    multihost.shutdown()
'''


def test_pipeline_p2p_round_trip_on_the_card(cuda_device, tmp_path):
    """A dict of CUDA tensors (float32, bf16, bool, int64) sent from stage 0
    to stage 1 and back through Gloo's host-staged route arrives bit-equal,
    on the card."""
    from torch_ranks import run_ranks

    torch.save({}, tmp_path / "spec.pt")
    run_ranks(PIPE_CARD_WORKER, 2, tmp_path, "p2p")
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["route"] == r1["route"] == "gloo-host"
    for k, v in r0["sent"].items():
        assert r0["got"][k].dtype == v.dtype and torch.equal(r0["got"][k], v), k
        assert torch.equal(r1["got"][k], v), k
        assert r0["devices"][k].startswith("cuda"), k


def test_pipeline_1f1b_on_the_card(cuda_device, tmp_path):
    """A 2-stage 1F1B step (the reduced DETR: stage 0 the backbone and the
    encoder layer, stage 1 the decoder layer and the loss, 2 microbatches of
    2) with A-tf32 and A'-mma inside the stages, against one process's
    sequential forward and backward on the card: the loss within 1e-4
    relative, each gradient within 1e-3 of its norm (a tensor whose exact
    gradient is zero within 1e-6 of the largest gradient); launches per rank
    A-tf32 4 (forward and re-linearization) / 4, A'-mma 2 / 4, B 0 / 2, C 1 / 0."""
    from torch_ranks import run_ranks

    from detr_tensorflow_tpu_torch.ops import losses

    spec = {"tiny": CARD_TINY, "batch": _card_batch()}
    torch.save(spec, tmp_path / "spec.pt")
    run_ranks(PIPE_CARD_WORKER, 2, tmp_path, "1f1b")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    model = api.build_detr(seed=0, device=cuda_device, **CARD_TINY).module
    b = {k: torch.as_tensor(v).to(cuda_device) for k, v in spec["batch"].items()}
    total, _ = losses.detr_loss(model(b["images"], train=True), b["boxes"], b["classes"],
                                b["mask"], 91)
    total.backward()
    loss = float(total.detach())
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    scale = max(float(g.norm()) for g in grads.values())
    assert ranks[0]["counts"] == (4, 2, 0, 1) and ranks[1]["counts"] == (4, 4, 2, 0)
    merged = {}
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-4 * abs(loss)
        merged.update(r["grads"])
    assert set(merged) == set(grads)
    for name, g in grads.items():
        diff = float((merged[name] - g).norm())
        assert diff <= 1e-3 * float(g.norm()) or diff <= 1e-6 * scale, name
