"""Multi-scale rung selection, deterministic and multi-host safe (port of
``detr_tensorflow_tpu/data/multiscale.py``; resampling by ``data/transforms.py``
in place of cv2; ``sync=None`` means sync across processes, as there).

1. **Reproducible per-example draws.** The rung an example trains at is
   a pure function of ``(seed, epoch, example id)``, not of the worker
   thread that decoded it.
2. **One batch shape across processes** (``sync=True``): workers render
   every example at the ladder's largest rung and batch ``b`` is resized
   to rung ``batch_rung(seed, b)``, a pure function of ``(seed, batch
   index)``. Only pixels are resampled: normalized boxes do not change.

Batches are bucketed by shape, so each rung is one set of shapes.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# Domain-separation tags so example- and batch-keyed streams never
# collide even for equal integer keys.
_EXAMPLE_TAG = 0xE7A3
_BATCH_TAG = 0x5CA1E


def _stable_key(key) -> int:
    """Map an example id (int / str / path) to a stable 32-bit int.

    Python's ``hash`` is salted per process (PYTHONHASHSEED) and so
    useless across runs or hosts; crc32 is stable everywhere.
    """
    if isinstance(key, (int, np.integer)):
        return int(key) & 0xFFFFFFFF
    return zlib.crc32(str(key).encode("utf-8"))


def example_rung(seed: int, key, n_rungs: int, epoch: int = 0) -> int:
    """Deterministic rung index for one example:
    f(seed, epoch, example id). The epoch term re-draws every example
    each epoch (the DETR paper re-samples the scale per pass) while
    keeping the assignment a pure function — reproducible run to run,
    independent of thread scheduling."""
    seq = np.random.SeedSequence(
        [int(seed), _EXAMPLE_TAG, int(epoch), _stable_key(key)]
    )
    return int(np.random.default_rng(seq).integers(n_rungs))


def batch_rung(seed: int, batch_index: int, n_rungs: int) -> int:
    """Deterministic rung index for one batch: f(seed, batch index).

    Identical on every host — the multi-host shape synchronizer.
    """
    seq = np.random.SeedSequence([int(seed), _BATCH_TAG, int(batch_index)])
    return int(np.random.default_rng(seq).integers(n_rungs))


def resize_batch_to_rung(
    batch: Dict[str, np.ndarray], h: int, w: int
) -> Dict[str, np.ndarray]:
    """Resize an assembled batch to rung (h, w).

    images: bilinear (they are already mean/std-normalized floats —
    linear resampling commutes with the affine normalization).
    boxes/classes/mask: normalized or resolution-free — unchanged.
    """
    from .transforms import LINEAR, resize

    images = batch["images"]
    if images.shape[1:3] == (h, w):
        return batch
    out = dict(batch)
    out["images"] = np.stack([resize(im, h, w, LINEAR) for im in images]).astype(images.dtype)
    return out


class MultiScalePlan:
    """Rung-selection strategy for one loader instance.

    sync=False (single host): per-example deterministic draws +
    shape-keyed bucket batching (one static shape per batch, one XLA
    program per rung).

    sync=True (multi host): workers render at the top rung; batches are
    resized to the shared ``batch_rung`` schedule — every host emits
    the same shape sequence. bucket_key is None (no bucketing needed:
    all worker outputs share the top-rung shape).

    sync=None: auto, True iff the run spans processes
    (``parallel.multihost.world_size() > 1``).
    """

    def __init__(
        self,
        scales: Sequence[Tuple[int, int]],
        seed: int,
        sync: Optional[bool] = None,
    ):
        self.scales = tuple(tuple(int(v) for v in s) for s in scales)
        if not self.scales:
            raise ValueError("multi_scale ladder is empty")
        self.seed = int(seed)
        if sync is None:
            from ..parallel import multihost

            sync = multihost.world_size() > 1
        self.sync = bool(sync)
        self.top = max(self.scales, key=lambda s: s[0] * s[1])
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Epoch hook (HostDataset ``on_epoch_start``): re-draws each
        example's rung every epoch, still deterministically."""
        self._epoch = int(epoch)

    def size_for(self, key) -> Tuple[int, int]:
        """The (H, W) a worker should render example ``key`` at."""
        if self.sync:
            return self.top
        return self.scales[
            example_rung(self.seed, key, len(self.scales), self._epoch)
        ]

    @property
    def bucket_key(self) -> Optional[Callable]:
        if self.sync:
            return None
        return lambda ex: ex["images"].shape

    @property
    def batch_transform(self) -> Optional[Callable]:
        if not self.sync:
            return None

        def transform(batch: Dict[str, np.ndarray], batch_index: int):
            h, w = self.scales[
                batch_rung(self.seed, batch_index, len(self.scales))
            ]
            return resize_batch_to_rung(batch, h, w)

        return transform
