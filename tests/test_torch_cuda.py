"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from detr_tensorflow_tpu_torch.models import api
from detr_tensorflow_tpu_torch.ops import flash_attention as fa

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
    before = fa.mha.launches
    out = fa.mha(q, k, v, mask)
    unmasked = fa.mha(q, k, v)
    torch.cuda.synchronize()
    assert fa.mha.launches == before + 2
    assert out.dtype == dtype and out.shape == q.shape
    for got, m in ((out, mask), (unmasked, None)):
        ref = fa.reference_mha(q, k, v, m)
        assert float((got.float() - ref.float()).abs().max()) <= atol


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
    before = fa.mha.launches
    out = model(x)
    assert fa.mha.launches == before + 6
    ref = plain(x)
    assert float((out["pred_boxes"] - ref["pred_boxes"]).abs().max()) <= 5e-4
    assert float((out["pred_logits"] - ref["pred_logits"]).abs().max()) <= 5e-3
