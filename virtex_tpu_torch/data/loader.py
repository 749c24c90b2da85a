r"""
The host data loader: batches from a background thread, prefetched,
resumable.

Counterpart of ``virtex_tpu/data/loader.py``: the stream is a pure function
of ``(seed, items consumed)``: :class:`ShardedSampler` reconstructs each
epoch's shuffle from its index, and every item's augmentation draws from
:func:`item_rng` of ``(seed, epoch, index)``. So a loader restored from
:meth:`DataLoader.state_dict` replays the batches that an unbroken run
would have drawn next. Each batch is fetched in one call of the dataset's
``get_batch`` (the data plane fans its pixel work over OpenMP threads);
with ``background`` one thread fetches ahead of the consumer.
With ``pin_memory`` the batch arrives as page-locked torch tensors, ready
for a ``non_blocking`` copy to the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def item_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The augmentation draws of one visit, a pure function of its
    arguments."""
    root = np.random.SeedSequence((seed, epoch, index))
    return np.random.RandomState(root.generate_state(1)[0])


class ShardedSampler:
    """An infinite stream of ``(epoch, dataset index)``: each epoch a
    shuffle seeded by ``(seed, epoch)``, cut into ``num_shards`` even
    shards (the remainder dropped)."""

    def __init__(self, num_examples: int, shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.num_examples = num_examples
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.items_per_epoch = num_examples // num_shards

    def epoch_order(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(
                (self.seed * 1_000_003 + epoch) % (2**31)
            ).permutation(self.num_examples)
        else:
            order = np.arange(self.num_examples)
        lo = self.shard_index * self.items_per_epoch
        return order[lo:lo + self.items_per_epoch]

    def iterate(self, start_count: int = 0) -> Iterator[Tuple[int, int]]:
        """The stream from absolute position ``start_count``."""
        count = start_count
        while True:
            epoch, pos = divmod(count, self.items_per_epoch)
            order = self.epoch_order(epoch)
            for i in range(pos, self.items_per_epoch):
                yield epoch, int(order[i])
                count += 1

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return self.iterate(0)


def pin(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy leaves → page-locked torch tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}


class DataLoader:
    """Batches of a dataset with ``__len__``, ``get_batch(indices, rngs)``
    and ``collate_fn(items)``.

    Args:
        batch_size: items per batch.
        shuffle: shuffle each epoch.
        background: fetch in one background thread, ``prefetch`` batches
            ahead; else in the consumer's thread. (The JAX loader's
            ``num_workers`` threads are the data plane's OpenMP team here:
            :class:`~virtex_tpu_torch.native.DataPlane` ``threads``.)
        seed: the stream's seed (shuffles and augmentations).
        infinite: cycle forever, tracking the position for resume
            (pretraining); else one epoch from the start (validation).
        drop_last: drop a short last batch of a finite epoch.
        pin_memory: hand out page-locked torch tensors instead of numpy.
    """

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = True,
                 background: bool = True, seed: int = 0, prefetch: int = 2,
                 infinite: bool = True, num_shards: int = 1,
                 shard_index: int = 0, drop_last: bool = True,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.background = background
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.infinite = infinite
        self.drop_last = drop_last or infinite
        self.pin_memory = pin_memory
        self.sampler = ShardedSampler(len(dataset), shuffle=shuffle,
                                      seed=seed, num_shards=num_shards,
                                      shard_index=shard_index)
        # Items handed to the consumer; only the infinite stream advances.
        self.items_consumed = 0

    def state_dict(self) -> Dict[str, int]:
        return {"items_consumed": int(self.items_consumed)}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.items_consumed = int(state["items_consumed"])

    def __len__(self) -> int:
        return self.sampler.items_per_epoch // self.batch_size

    def _fetch(self, pairs):
        rngs = [item_rng(self.seed, e, i) for e, i in pairs]
        batch = self.dataset.collate_fn(
            self.dataset.get_batch([i for _, i in pairs], rngs))
        return pin(batch) if self.pin_memory else batch

    def _batch_pairs(self):
        full = len(self)
        remainder = (0 if self.drop_last
                     else self.sampler.items_per_epoch % self.batch_size)
        if full == 0 and remainder == 0:
            raise ValueError(
                f"Dataset ({len(self.dataset)} examples / "
                f"{self.sampler.num_shards} shards) smaller than batch size "
                f"{self.batch_size}")
        stream = self.sampler.iterate(self.items_consumed if self.infinite
                                      else 0)
        n = 0
        while self.infinite or n < full:
            yield [next(stream) for _ in range(self.batch_size)]
            n += 1
        if remainder:
            yield [next(stream) for _ in range(remainder)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if not self.background:
            for pairs in self._batch_pairs():
                batch = self._fetch(pairs)
                if self.infinite:
                    self.items_consumed += len(pairs)
                yield batch
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # Poll the stop event, so a consumer that walks away from a
            # full queue does not leave this thread blocked forever.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for pairs in self._batch_pairs():
                    if stop.is_set() or not put((self._fetch(pairs),
                                                 len(pairs))):
                        return
                put(None)
            except BaseException as e:  # handed to the consumer, re-raised
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, n_items = item
                # Counted when the consumer receives the batch, so batches
                # prefetched but never consumed are replayed on resume.
                if self.infinite:
                    self.items_consumed += n_items
                yield batch
        finally:
            stop.set()
            thread.join(timeout=60)
