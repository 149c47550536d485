"""Threaded host input pipeline (port of ``detr_tensorflow_tpu/data/pipeline.py``).

A thread pool decodes and augments examples while a bounded queue keeps
batches ready; ``Trainer.prefetch`` then copies them to the card ahead of
the step. Every batch is a dict of stacked numpy arrays in the native
target layout (``data/processing.py``): images, boxes, classes, mask,
and pixel_mask / batch_valid where the loader adds them.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np


def stack_batch(examples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], axis=0) for k in keys}


class WorkerRNG:
    """Per-thread numpy Generators spawned from one SeedSequence (a numpy
    Generator is not thread-safe; the spawn is guarded by a lock)."""

    def __init__(self, seed: int = 0):
        self._seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._tls = threading.local()

    def get(self) -> np.random.Generator:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._lock:
                child = self._seq.spawn(1)[0]
            rng = np.random.default_rng(child)
            self._tls.rng = rng
        return rng


class HostDataset:
    """Index-based dataset with shuffling, filtering, batching and prefetch.

    Args:
      indices: the example keys, passed to ``load_fn``.
      load_fn: index -> example dict, or None to drop the example.
      batch_size: examples per batch; incomplete batches are dropped (per
        bucket) unless ``pad_remainder``.
      shuffle: reshuffle the indices each epoch (a numpy Generator seeded
        with ``seed``).
      num_workers: decode/augment threads.
      prefetch: ready batches buffered ahead.
      bucket_key: optional example -> key; a batch holds examples of one
        key (one image shape per batch).
      batch_transform: optional ``(batch, batch_index) -> batch`` applied to
        each assembled batch; the index counts emitted batches across epochs.
      on_epoch_start: optional ``epoch -> None`` hook.
      pad_remainder: pad each bucket's final partial batch by repeating its
        last example, and add a ``batch_valid`` (B,) bool key to every batch.

    Images stay float32 here. The JAX package casts a bf16 model's images
    on the host with ml_dtypes (``image_dtype``); ``Trainer.prefetch`` casts
    them to bf16 before its host-to-device copy (round to nearest even, the
    same values).
    """

    def __init__(self, indices: Sequence, load_fn: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 8, collate_fn: Callable = stack_batch,
                 bucket_key: Callable = None, batch_transform: Callable = None,
                 on_epoch_start: Callable = None, pad_remainder: bool = False):
        self.indices = list(indices)
        self.load_fn = load_fn
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.bucket_key = bucket_key
        self.batch_transform = batch_transform
        self.on_epoch_start = on_epoch_start
        self.pad_remainder = pad_remainder
        self.shard = None  # (index, count): set_shard
        self._emitted = 0  # lifetime batch counter for batch_transform
        self._epoch = 0
        self._rng = np.random.default_rng(seed)

    def set_shard(self, index: int, count: int) -> None:
        """From now on yield only rank ``index`` of ``count``'s rows
        (``multihost.process_shard``) of each global batch of
        ``batch_size``. Every rank loads the same examples in the same
        shuffle (the seed is shared) and keeps its slice, so the union of
        the ranks' batches at step t is the one-process batch at step t; the
        ``batch_transform`` (the multi-scale rung) sees the global batch
        index on every rank."""
        if self.batch_size % count:
            raise ValueError(f"batch_size {self.batch_size} does not split over {count} ranks")
        self.shard = (int(index), int(count))

    def __len__(self) -> int:
        """Upper bound on batches per epoch (``load_fn`` may drop examples)."""
        return len(self.indices) // self.batch_size

    def _epoch_indices(self) -> List:
        idx = list(self.indices)
        if self.shuffle:
            perm = self._rng.permutation(len(idx))
            idx = [idx[i] for i in perm]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.on_epoch_start is not None:
            self.on_epoch_start(self._epoch)
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def safe_put(item) -> bool:
            """Put without deadlocking when the consumer stopped early."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def emit(examples, valid=None) -> bool:
            rows = slice(None)
            if self.shard is not None:
                per = self.batch_size // self.shard[1]
                rows = slice(self.shard[0] * per, (self.shard[0] + 1) * per)
            batch = self.collate_fn(examples[rows])
            if self.pad_remainder:
                batch["batch_valid"] = (np.ones(self.batch_size, bool) if valid is None
                                        else np.arange(self.batch_size) < valid)[rows]
            if self.batch_transform is not None:
                batch = self.batch_transform(batch, self._emitted)
                self._emitted += 1
            return safe_put(batch)

        def producer():
            # A load_fn or collate failure is shipped through the queue and
            # raised in the consumer rather than truncating the epoch.
            error = None
            try:
                # A sliding window of loads in flight: at most window_size
                # decoded examples wait at any time; results in order.
                window_size = max(2 * self.num_workers, self.batch_size)
                epoch = iter(self._epoch_indices())
                with ThreadPoolExecutor(self.num_workers) as pool:
                    in_flight = collections.deque()
                    for _ in range(window_size):
                        idx = next(epoch, None)
                        if idx is None:
                            break
                        in_flight.append(pool.submit(self.load_fn, idx))
                    pending: Dict = {}
                    while in_flight:
                        if stop.is_set():
                            for future in in_flight:
                                future.cancel()
                            return
                        ex = in_flight.popleft().result()
                        idx = next(epoch, None)
                        if idx is not None:
                            in_flight.append(pool.submit(self.load_fn, idx))
                        if ex is None:
                            continue
                        key = self.bucket_key(ex) if self.bucket_key else None
                        bucket = pending.setdefault(key, [])
                        bucket.append(ex)
                        if len(bucket) == self.batch_size:
                            if not emit(bucket):
                                return
                            pending[key] = []
                    if self.pad_remainder:
                        for bucket in pending.values():
                            if bucket and not emit(
                                    bucket + [bucket[-1]] * (self.batch_size - len(bucket)),
                                    valid=len(bucket)):
                                return
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer
                error = e
            finally:
                # The end of the epoch, or the error, reaches a slow consumer
                # however long it takes; only a consumer that stopped drops it.
                safe_put(error)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:  # pragma: no cover
                    break
