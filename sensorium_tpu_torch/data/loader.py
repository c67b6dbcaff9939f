"""Threaded prefetching batch loader (counterpart of ``sensorium_tpu/data/loader.py``).

A thread pool gathers samples from memory-mapped arrays (NumPy and the
native library release the GIL) and writes them straight into the rows of a
preallocated batch (``dataset.fill_into``); a small queue keeps batches ready
ahead of the card, and the consumer's wait on it is the span ``loader.wait``
(``utils/profiling.py``). A dataset without fixed row shapes (``row_shapes``
None) goes through ``get`` and ``collate_mice_batch`` instead. Batches are
numpy ``MiceBatch``es; ``MouseModel`` stages them on the device.

``shard=(index, extent)`` makes the loader fill only the rows of each global
batch that shard ``index`` of a data-parallel mesh holds
(``parallel.mesh.shard_rows``: its slice of each of ``microbatches`` equal
microbatches). The order is the unsharded loader's and samples are keyed by
``(seed, epoch, index)``, so the rows are those of the global batch, bit for
bit. A short last batch (no ``drop_last``) is padded to a multiple of
``extent`` with zero-weight rows of zeros.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sensorium_tpu_torch.data.datasets import MiceBatch, collate_mice_batch
from sensorium_tpu_torch.parallel.mesh import shard_rows
from sensorium_tpu_torch.utils.profiling import span


def resolve_workers(num_threads: int) -> int:
    """The number of worker threads the loader runs: ``num_threads``, at
    most the cores this process may use; ``SENSORIUM_LOADER_THREADS=N``
    overrides both."""
    override = os.environ.get("SENSORIUM_LOADER_THREADS")
    if override:
        try:
            return max(1, int(override))
        except ValueError:
            raise ValueError(f"SENSORIUM_LOADER_THREADS must be an integer, got {override!r}") from None
    try:
        usable = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        usable = os.cpu_count() or num_threads
    return max(1, min(num_threads, usable))


class MiceDataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_threads: int = 8,
        drop_last: bool = False,
        prefetch: int = 3,
        shard: tuple[int, int] | None = None,
        microbatches: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard = shard
        self.microbatches = microbatches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _batch_indexes(self, order: np.ndarray, b: int) -> np.ndarray:
        """The dataset indexes of batch ``b``'s rows (this shard's; -1 for padding)."""
        indexes = order[b * self.batch_size : (b + 1) * self.batch_size]
        if self.shard is None:
            return indexes
        rows = shard_rows(len(indexes), *self.shard, chunks=self.microbatches, pad=not self.drop_last)
        return np.where(rows < len(indexes), indexes[np.minimum(rows, len(indexes) - 1)], -1)

    def __iter__(self):
        order = self._index_order()
        num_batches = len(self)
        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        epoch = self.epoch
        stop = threading.Event()
        row_shapes = getattr(self.dataset, "row_shapes", None)
        num_mice = getattr(self.dataset, "num_mice", None)
        workers = resolve_workers(self.num_threads)

        def make_batch_fill(pool, batch_indexes):
            input_shape, target_shape = row_shapes
            b = len(batch_indexes)
            inputs = np.empty((b,) + input_shape, np.float32)
            targets = np.zeros((b,) + target_shape, np.float32)
            weights = np.zeros((b, num_mice), np.float32)

            def fill_rows(rows):
                for row, i in rows:
                    if i < 0:  # padding: zeros, weight 0
                        inputs[row] = 0.0
                        continue
                    weights[row, self.dataset.fill_into(int(i), epoch, inputs[row], targets[row])] = 1.0

            # One contiguous chunk of rows per worker: one task per row would
            # cost a queue round trip and a GIL hand-off per row. Reading the
            # results raises a worker's exception here.
            rows = list(enumerate(batch_indexes))
            chunk = -(-len(rows) // workers)
            for _ in pool.map(fill_rows, [rows[i : i + chunk] for i in range(0, len(rows), chunk)]):
                pass
            return MiceBatch(inputs=inputs, targets=targets, weights=weights)

        def make_batch_collate(pool, batch_indexes):
            real = [i for i in batch_indexes if i >= 0]  # padding rows come last
            samples = list(pool.map(lambda i: self.dataset.get(int(i), epoch), real))
            batch = collate_mice_batch(samples, num_mice=num_mice, max_neurons=getattr(self.dataset, "max_neurons", None))
            padding = len(batch_indexes) - len(real)
            if padding == 0:
                return batch
            return MiceBatch(*(np.concatenate([a, np.zeros((padding,) + a.shape[1:], a.dtype)])
                               for a in (batch.inputs, batch.targets, batch.weights)))

        make_batch = make_batch_collate if row_shapes is None else make_batch_fill

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for b in range(num_batches):
                        if stop.is_set():
                            return
                        out_queue.put(make_batch(pool, self._batch_indexes(order, b)))
                out_queue.put(None)
            except BaseException as exc:  # handed to the consumer, which raises it
                out_queue.put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                with span("loader.wait"):
                    item = out_queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain, so that the producer never blocks on a full queue.
            while producer.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    producer.join(timeout=0.1)


__all__ = ["MiceDataLoader", "MiceBatch", "resolve_workers"]
