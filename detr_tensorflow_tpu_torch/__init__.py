"""DETR in PyTorch for NVIDIA Hopper: the port of ``detr_tensorflow_tpu``.

The JAX package stays the reference; this package imports neither it nor
JAX. Public tensors keep the JAX layouts (NHWC images, (B, L, H, Dh)
attention inputs, the same output dicts), so the two compare like with
like. The TPU kernels on the serving and training paths are rewritten by
hand for the GPU under ``csrc/`` and built with nvcc on first use; the
serving kernels are ``torch.library`` ops, so ``export_predictor`` writes
``torch.export`` programs that launch them and ``load_predictor`` serves
those programs without the model's code.
"""

from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import data  # noqa: F401
from . import train  # noqa: F401
from . import parallel  # noqa: F401
from . import metrics  # noqa: F401
from . import logger  # noqa: F401
from . import utils  # noqa: F401
from . import inference  # noqa: F401
from .models import DETR, DetrModel, as_aux_list, build_detr, get_detr_model  # noqa: F401
from .predictor import Detection, Predictor  # noqa: F401
from .export import export_predictor, load_predictor  # noqa: F401
