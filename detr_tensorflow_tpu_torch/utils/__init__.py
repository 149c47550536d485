"""Utilities: profiling and tracing, a timing harness, tree helpers (port of
``detr_tensorflow_tpu/utils``)."""

from .profiling import trace, Timer, benchmark_fn, device_ms_per_step  # noqa: F401
from .trees import tree_size, tree_bytes, print_tree_summary  # noqa: F401
