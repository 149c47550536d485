"""Kernel F (``csrc/int8_matmul.cu``) on the CPU: the plan the wrapper picks
from the shape. The numpy emulation of the kernel's addressing is in
``tests/test_torch_int8_emulation.py``.
"""

import pytest
import torch

from detr_tensorflow_tpu_torch.ops import int8_matmul as mm
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

# (M, C, K, Cd, variant, launches) of kernel F in one b1 896x1408 int8
# DETR-R50 forward: conv1 (plain) and the conv3 tails of layers 1-4.
F_PATH_SHAPES = [
    (78848, 64, 64, 0, "plain", 1), (78848, 64, 256, 64, "residual2", 1),
    (78848, 64, 256, 0, "residual", 2), (78848, 256, 64, 0, "plain", 2),
    (78848, 256, 128, 0, "plain", 1), (19712, 128, 512, 256, "residual2", 1),
    (19712, 128, 512, 0, "residual", 3), (19712, 512, 128, 0, "plain", 3),
    (19712, 512, 256, 0, "plain", 1), (4928, 256, 1024, 512, "residual2", 1),
    (4928, 256, 1024, 0, "residual", 5), (4928, 1024, 256, 0, "plain", 5),
    (4928, 1024, 512, 0, "plain", 1), (1232, 512, 2048, 1024, "residual2", 1),
    (1232, 512, 2048, 0, "residual", 2), (1232, 2048, 512, 0, "plain", 2),
]
SMS = 132  # streaming multiprocessors of the H100


def test_path_shapes_are_one_forward():
    counts = {}
    for *_, variant, n in F_PATH_SHAPES:
        counts[variant] = counts.get(variant, 0) + n
    assert counts == {"plain": 16, "residual": 12, "residual2": 4}


@pytest.mark.parametrize("m,c,k,cd,variant,launches", F_PATH_SHAPES)
def test_plan_fills_the_card_at_every_path_shape(m, c, k, cd, variant, launches):
    """At least one wave of CTAs; a split only where the tiles alone are
    fewer than FILL, each rank's share of C and Cd then whole 64-byte chunks
    and at most DEPTH of them; and shared memory that fits: three CTAs an SM
    for plain and residual with an int8 output (their register budget), two
    for residual2."""
    p = mm.plan(m, c, k, cd)
    tiles = -(-m // p.rows) * -(-k // p.channels)
    assert (p.rows, p.channels) == mm.TILE and p.cluster in mm.CLUSTERS
    assert p.ctas == tiles * p.cluster >= SMS
    assert c % (64 * p.cluster) == 0 and cd % (64 * p.cluster) == 0
    assert p.cluster == 1 if tiles >= mm.FILL else (c + cd) // 64 // p.cluster <= mm.DEPTH
    per_sm = 2 if variant == "residual2" else 3
    assert per_sm * (mm.smem_bytes(variant) + 1024) <= 233472
    assert mm.smem_bytes(variant, torch.bfloat16) <= mm.SMEM_LIMIT


def test_plan_splits_only_the_deep_contractions_of_few_tiles():
    clusters = {(m, c, k, cd): mm.plan(m, c, k, cd).cluster for m, c, k, cd, *_ in F_PATH_SHAPES}
    assert {key: n for key, n in clusters.items() if n > 1} == {
        (4928, 1024, 256, 0): 2, (1232, 2048, 512, 0): 4}
    assert mm.plan(105, 2048, 64).cluster == 4 and mm.plan(105, 4096, 64).cluster == 8
    assert mm.plan(40, 256, 64, 2048).cluster == 4
    # 9 chunks split into whole chunks by no cluster: one CTA sums them all.
    assert mm.plan(105, 576, 64).cluster == 1


@pytest.mark.parametrize("c,k,cd", [(32, 64, 0), (96, 64, 0), (64, 12, 0), (64, 64, 32),
                                    (0, 64, 0)])
def test_plan_refuses_what_the_kernel_cannot_take(c, k, cd):
    with pytest.raises(ValueError, match="multiples of 64"):
        mm.plan(128, c, k, cd)
