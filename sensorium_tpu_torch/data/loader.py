"""Threaded prefetching batch loader (counterpart of ``sensorium_tpu/data/loader.py``).

A thread pool gathers samples from memory-mapped arrays (NumPy and the
native library release the GIL) and writes them straight into the rows of a
preallocated batch (``dataset.fill_into``); a small queue keeps batches ready
ahead of the card. A dataset without fixed row shapes (``row_shapes`` None)
goes through ``get`` and ``collate_mice_batch`` instead. Batches are numpy
``MiceBatch``es; ``MouseModel`` stages them on the device.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sensorium_tpu_torch.data.datasets import MiceBatch, collate_mice_batch


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
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.prefetch = prefetch
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
            samples = list(pool.map(lambda i: self.dataset.get(int(i), epoch), batch_indexes))
            return collate_mice_batch(samples, num_mice=num_mice, max_neurons=getattr(self.dataset, "max_neurons", None))

        make_batch = make_batch_collate if row_shapes is None else make_batch_fill

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for b in range(num_batches):
                        if stop.is_set():
                            return
                        out_queue.put(make_batch(pool, order[b * self.batch_size : (b + 1) * self.batch_size]))
                out_queue.put(None)
            except BaseException as exc:  # handed to the consumer, which raises it
                out_queue.put(exc)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
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
