"""The port's int8 kernels' wrappers (``ops/int8_matmul.py`` ``qmatmul``,
``qmatmul_residual``, ``qmatmul_residual2`` and ``ops/int8_conv.py``
``conv3x3_int8``) against the JAX package's Pallas kernels, on the CPU: the
Pallas kernels run in interpret mode, as tests/test_quantized.py runs them,
and the port's wrappers take their plain versions. Operands come from numpy
seeds; both sides get the same int8 operands and fp32 scales. The int8
backbone built on them is held in tests/test_torch_quantized.py.

XLA on the CPU contracts ``acc*s + b`` (and ``y + acc_d*s_d``) into fused
multiply-adds; the port rounds each product and sum on its own, as the TPU
kernel's code is written. The two fp32 epilogues therefore differ by an ulp
now and then: int8 results agree unless a value lies within that ulp of a
rounding boundary (none in these inputs), bf16 results within one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tensorflow_tpu.models import quantized as JQ
from detr_tensorflow_tpu.ops.pallas import int8_conv as jax_conv
from detr_tensorflow_tpu.ops.pallas import int8_matmul as jax_mm
from detr_tensorflow_tpu_torch.ops import int8_conv, int8_matmul
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"int8": (jnp.int8, torch.int8), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0**-7  # bf16 keeps 8 significant bits: one ulp <= 2^-7 |v|


def t(x):
    return torch.from_numpy(np.array(x))


def assert_epilogue_match(ours, ref, out_dtype):
    """int8: integer-equal. bf16: within one bf16 ulp (the FMA note above)."""
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    if out_dtype == "int8":
        np.testing.assert_array_equal(ours, ref)
    else:
        assert (np.abs(ours - ref) <= BF16_ULP * np.abs(ref)).all()


def assert_within_one_lsb(a, b):
    assert int(np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32)).max()) <= 1


def _mm_operands(seed, m=105, c=64, k=48, cd=128):
    """int8 operands with the JAX package's weight layout (C, K); M = 105
    is a multiple of no tile (the JAX side runs 32-row tiles, the CUDA
    kernel 64-row ones)."""
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-128, 128, s, np.int8)  # noqa: E731
    return dict(x=i8(m, c), w=i8(c, k), s=rng.uniform(1e-4, 1e-2, k).astype(np.float32),
                b=rng.normal(size=k).astype(np.float32), res=i8(m, k), rs=np.float32(0.37),
                xd=i8(m, cd), wd=i8(cd, k), sd=rng.uniform(1e-4, 1e-2, k).astype(np.float32),
                bd=rng.normal(size=k).astype(np.float32))


def _jax_qmatmul(variant, o, **kw):
    if variant == "plain":
        return jax_mm.qmatmul(o["x"], o["w"], o["s"], o["b"], m_tile=32, **kw)
    if variant == "residual":
        return jax_mm.qmatmul_residual(o["x"], o["w"], o["s"], o["b"], o["res"], o["rs"],
                                       m_tile=32, **kw)
    return jax_mm.qmatmul_residual2(o["x"], o["w"], o["s"], o["b"], o["xd"], o["wd"], o["sd"],
                                    o["bd"], m_tile=32, **kw)


def _port_qmatmul(variant, o, **kw):
    x, w, s, b = t(o["x"]), t(o["w"].T), t(o["s"]), t(o["b"])  # weights K-major
    if variant == "plain":
        return int8_matmul.qmatmul(x, w, s, b, **kw)
    if variant == "residual":
        return int8_matmul.qmatmul_residual(x, w, s, b, t(o["res"]), t(o["rs"]), **kw)
    return int8_matmul.qmatmul_residual2(x, w, s, b, t(o["xd"]), t(o["wd"].T), t(o["sd"]),
                                         t(o["bd"]), **kw)


@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", ["plain", "residual", "residual2"])
def test_qmatmul_matches_jax(variant, relu, out_dtype):
    """Kernel F's three entry points with the precise (fp32) epilogue
    against JAX: int8 integer-equal, bf16 within one bf16 ulp; with a bf16
    output the bf16 epilogue too."""
    o = _mm_operands(seed=len(variant) + 2 * relu)
    jdt, pdt = DTYPES[out_dtype]
    ours = _port_qmatmul(variant, o, relu=relu, out_dtype=pdt)
    assert ours.dtype == pdt and ours.shape == (105, 48)
    assert_epilogue_match(ours, _jax_qmatmul(variant, o, relu=relu, out_dtype=jdt), out_dtype)
    if out_dtype == "bfloat16":
        fast = _port_qmatmul(variant, o, relu=relu, out_dtype=pdt, precise=False)
        jax_fast = _jax_qmatmul(variant, o, relu=relu, out_dtype=jdt, precise=False)
        assert_epilogue_match(fast, jax_fast, out_dtype)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", ["plain", "residual", "residual2"])
def test_qmatmul_bf16_epilogue_matches_jax(variant, relu):
    """``precise=False``, the TPU kernel's bf16 epilogue, int8 out: equal to
    JAX's under ReLU (the backbone's case) and within 1 LSB without (XLA
    keeps some bf16 intermediates in fp32 there). Away from the precise
    result it strays no further than JAX's own bf16 epilogue, which at
    these magnitudes (terms in the hundreds, where a bf16 ulp is 1 or 2)
    is several LSB for the residual sums of rounded terms."""
    o = _mm_operands(seed=len(variant) + 2 * relu)
    fast = _port_qmatmul(variant, o, relu=relu, precise=False).numpy().astype(np.int32)
    jax_fast = np.asarray(_jax_qmatmul(variant, o, relu=relu, precise=False), np.int32)
    assert np.abs(fast - jax_fast).max() <= (0 if relu else 1)
    ours = _port_qmatmul(variant, o, relu=relu).numpy().astype(np.int32)
    jax_precise = np.asarray(_jax_qmatmul(variant, o, relu=relu), np.int32)
    assert np.abs(fast - ours).max() <= np.abs(jax_fast - jax_precise).max()


def test_bf16_epilogue_within_one_lsb():
    """At the magnitudes of tests/test_quantized.py::test_fast_epilogue_within_one_lsb
    the bf16 epilogue stays within 1 LSB of the precise one."""
    rng = np.random.default_rng(0)
    x = t(rng.integers(-128, 128, (64, 32), np.int8))
    w = t(rng.integers(-128, 128, (32, 48), np.int8).T)
    s = t(rng.uniform(1e-4, 1e-2, 48).astype(np.float32))
    b = t(rng.normal(size=48).astype(np.float32))
    fast = int8_matmul.qmatmul(x, w, s, b, precise=False)
    assert_within_one_lsb(fast, int8_matmul.qmatmul(x, w, s, b))


def _conv_operands(seed, shape=(2, 13, 20, 64), k=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, shape, np.int8)
    w = rng.integers(-128, 128, (3, 3, shape[-1], k), np.int8)  # HWIO, as JAX
    s = rng.uniform(1e-4, 1e-2, k).astype(np.float32)
    b = rng.normal(size=k).astype(np.float32)
    return x, w, s, b


def _port_conv(x, w, s, b, **kw):
    return int8_conv.conv3x3_int8(t(x), t(w.transpose(3, 0, 1, 2)), t(s), t(b), **kw)


@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_stride1_matches_jax(relu, out_dtype):
    """Kernel G at stride 1 against the Pallas kernel (interpret) and the
    XLA int32 reference, on odd H and W."""
    x, w, s, b = _conv_operands(seed=3 + relu)
    jdt, pdt = DTYPES[out_dtype]
    ours = _port_conv(x, w, s, b, relu=relu, out_dtype=pdt)
    assert ours.shape == (2, 13, 20, 64) and ours.dtype == pdt
    for ref in (jax_conv.conv3x3_int8(x, w, s, b, relu=relu, out_dtype=jdt),
                jax_conv.reference_conv3x3_int8(x, w, s, b, relu=relu, out_dtype=jdt)):
        assert_epilogue_match(ours, ref, out_dtype)
    fast = _port_conv(x, w, s, b, relu=relu, out_dtype=pdt, precise=False)
    if out_dtype == "int8":
        assert_within_one_lsb(fast, ours)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_stride2_matches_xla(relu):
    """Kernel G at stride 2 against the strided convs of the JAX backbone:
    ``_conv3x3_int8_xla`` and the f32 epilogue of quant_backbone_forward."""
    x, w, s, b = _conv_operands(seed=5 + relu)
    acc = JQ._conv3x3_int8_xla(jnp.asarray(x), jnp.asarray(w), 2, 1)
    y = acc.astype(jnp.float32) * s + b
    ref = JQ._requant(jnp.maximum(y, 0) if relu else y)
    ours = _port_conv(x, w, s, b, stride=2, relu=relu)
    assert ours.shape == ref.shape == (2, 7, 10, 64)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_conv3x3_saturating_boundaries():
    """Accumulators large enough to clip both rails
    (tests/test_quantized.py::test_saturating_boundaries)."""
    rng = np.random.default_rng(0)
    x = np.full((1, 9, 9, 128), 127, np.int8)
    w = rng.choice(np.array([-127, 127], np.int8), (3, 3, 128, 8))
    s = np.full((8,), 1e-3, np.float32)
    ref = np.asarray(jax_conv.conv3x3_int8(x, w, s, relu=False, out_dtype=jnp.int8))
    ours = int8_conv.conv3x3_int8(t(x), t(w.transpose(3, 0, 1, 2)), t(s)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() == 127 and ours.min() == -128


def test_int8_wrappers_route_by_device():
    """CPU tensors take the plain versions; other devices raise."""
    x = torch.zeros((4, 64), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 64), dtype=torch.int8, device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no int8 matmul kernel"):
        int8_matmul.qmatmul(x, w, s, s)
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        int8_conv.conv3x3_int8(x.reshape(1, 2, 2, 64), torch.zeros((8, 3, 3, 64), dtype=torch.int8,
                                                                    device="meta"), s)
    before = int8_matmul.qmatmul.launches
    cpu = [torch.zeros(v.shape, dtype=v.dtype) for v in (x, w, s)]
    int8_matmul.qmatmul(*cpu, cpu[2])
    assert int8_matmul.qmatmul.launches == before  # the plain version launches nothing
