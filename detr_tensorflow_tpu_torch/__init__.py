"""DETR in PyTorch for NVIDIA Hopper: the port of ``detr_tensorflow_tpu``.

The JAX package stays the reference; this package imports neither it nor
JAX. Public tensors keep the JAX layouts (NHWC images, (B, L, H, Dh)
attention inputs, the same output dicts), so the two compare like with
like. The TPU kernels on the served path are rewritten by hand for the
GPU under ``csrc/`` and built with nvcc on first use.
"""

from .models import DETR, DetrModel, as_aux_list, build_detr, get_detr_model  # noqa: F401
from .predictor import Detection, Predictor  # noqa: F401
