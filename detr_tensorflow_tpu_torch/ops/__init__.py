"""Tensor ops of the PyTorch port: box geometry, Hungarian matching, set
losses, and the hand-written CUDA kernels with their plain versions."""

from . import boxes  # noqa: F401
from . import losses  # noqa: F401
from . import matcher  # noqa: F401
