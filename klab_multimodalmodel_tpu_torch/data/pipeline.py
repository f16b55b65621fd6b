"""Host input pipeline: shuffled, prefetching batch assembly.

The reference's ``DataLoader + DistributedSampler``, as the JAX package
rebuilt it:

  * epoch-seeded shuffling (``seed + epoch``), reproducible and resumable
    mid-epoch (``iter_from``);
  * ``drop_last`` as in the reference's sampler; ``drop_last=False`` wraps
    indices from the start of the epoch order into the last batch;
  * decode workers (threads, or spawned processes) assemble batches while a
    background producer keeps ``prefetch`` batches ready;
  * tokenization to fixed max lengths.

Batches are dicts of numpy arrays: images uint8 (B,H,W,3) (normalized on the
device, ``image_ops``), source/target ids and masks int32 (B,L), and each
row's dataset index (keys the frozen-feature cache). One process draws the
whole batch: ``process_index`` / ``process_count`` stay 0 / 1 until the port
trains across processes (ROADMAP A11).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

from ..text.tokenizer import TokenizerBase
from .datasets import DatasetBase

# Decode-worker processes (worker_mode="process"): the dataset is shipped
# once per worker through the pool initializer. Spawn, not fork: the pool is
# made lazily inside a live training process whose threads may hold locks.
# The pool persists across epochs, so per-epoch dataset state (the epoch's
# reseed, skip_image_load) travels with each task.
_WORKER_DATASET = None


def _init_decode_worker(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _decode_worker_getitem(task):
    i, epoch, skip = task
    if getattr(_WORKER_DATASET, "epoch", None) != epoch:
        _WORKER_DATASET.set_epoch(epoch)
    _WORKER_DATASET.skip_image_load = skip
    return _WORKER_DATASET[i]


class DataLoader:
    def __init__(self, dataset: DatasetBase, tokenizer: TokenizerBase,
                 global_batch_size: int, max_source_length: int = 256,
                 max_target_length: int = 128, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int | None = None, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 worker_mode: str = "thread"):
        if global_batch_size % process_count != 0:
            raise ValueError(
                f"global batch {global_batch_size} % hosts {process_count}")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.max_source_length = max_source_length
        self.max_target_length = max_target_length
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers or max((os.cpu_count() or 4) // 4, 1)
        self.worker_mode = worker_mode
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._pool = None  # made at first use, kept across epochs

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def epoch_indices(self) -> np.ndarray:
        """(num_batches, local_batch_size) dataset indices this process
        draws in the current epoch (``set_epoch``): deterministic, so a
        resumed epoch replays its order and the cache can check coverage."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        num_batches = len(self)
        usable = num_batches * self.global_batch_size
        order = np.resize(order, usable)  # truncates, or wraps the order
        local = order.reshape(num_batches, self.process_count,
                              self.local_batch_size)[:, self.process_index]
        return local

    def _get_pool(self):
        if self._pool is None:
            if self.worker_mode == "process":
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_init_decode_worker,
                    initargs=(self.dataset,))
            else:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers)
        return self._pool

    def close(self) -> None:
        """Shut the decode pool down (interpreter exit also reaps it)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _assemble(self, idxs: np.ndarray, pool) -> dict:
        if self.worker_mode == "process":
            skip = bool(getattr(self.dataset, "skip_image_load", False))
            tasks = [(int(i), self.epoch, skip) for i in idxs.tolist()]
            items = list(pool.map(_decode_worker_getitem, tasks))
        else:
            items = list(pool.map(self.dataset.__getitem__, idxs.tolist()))
        src = self.tokenizer([it[1] for it in items],
                             max_length=self.max_source_length)
        tgt = self.tokenizer([it[2] for it in items],
                             max_length=self.max_target_length)
        return dict(images=np.stack([it[0] for it in items]),
                    source_ids=src.input_ids, source_mask=src.attention_mask,
                    target_ids=tgt.input_ids, target_mask=tgt.attention_mask,
                    index=np.asarray(idxs, np.int64))

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[dict]:
        """Iterate the current epoch from batch ``start_batch``: a resumed
        epoch replays the tail of its order without decoding the prefix."""
        batches = self.epoch_indices()[start_batch:]
        pool = self._get_pool()
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A bounded put that keeps watching ``stop``: a consumer that
            abandons the epoch (a halt) must not leave the producer blocked
            on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if not put_or_stop(self._assemble(b, pool)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put_or_stop(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def get_dataloader(config, phase: str, tokenizer: TokenizerBase) -> DataLoader:
    """The reference's ``get_dataloader(args, phase, rank)`` on one device:
    the global batch is ``batch_size``; train shuffles, val does not."""
    from .datasets import build_dataset

    dataset = build_dataset(config.data_dir, phase, config.swin.image_size,
                            config.seed)
    return DataLoader(
        dataset, tokenizer, global_batch_size=config.batch_size,
        max_source_length=config.max_source_length,
        max_target_length=config.max_target_length,
        shuffle=(phase == "train"), seed=config.seed,
        num_workers=config.num_workers or None,
        prefetch=config.prefetch_batches, worker_mode=config.decode_workers)
