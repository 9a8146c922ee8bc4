"""Threaded prefetching batch loader.

Counterpart of `avmoe_tpu/data/loader.py`: the same seeded permutation per
epoch (seed + epoch), the same drop_last and multi-host slicing, the same
thread-pool prefetch, with a worker's exception raised in the consumer. In
place of the JAX package's `device_put`, the workers stack each batch into
CPU tensors, pinned where the target device is the card, and the consumer
copies them to the device with non_blocking=True on its current stream (so
the copy is ordered before the step that reads it). For the CPU the tensors
pass through unchanged.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Union

import numpy as np
import torch

_POLL_S = 0.1     # how often a blocked producer looks at the stop flag
_NUMERIC = "biufc"   # numpy kinds that become tensors: bool, ints, floats, complex


class BatchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 0, device=None, process_index: int = 0,
                 process_count: int = 1, split: str = "rows"):
        """batch_size is the global batch. With process_count > 1 every
        process builds the same seeded permutation and, with split="rows",
        collates only its contiguous 1/process_count slice of each batch
        (drop_last required: the train loaders); with split="batches" it
        collates whole batches, process_index, process_index +
        process_count, ... (the eval loaders: every batch is the one a
        single process would see; `parallel/mesh.py` `gather_ordered`
        restores their order). `device`: where batches go (None or a CPU
        device: left on the CPU)."""
        if split not in ("rows", "batches"):
            raise ValueError(f"split={split!r}, want 'rows' or 'batches'")
        self.split = split
        if split == "rows" and batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"process_count {process_count}")
        if split == "rows" and process_count > 1 and not drop_last:
            raise ValueError("drop_last=False is unsupported with process_count > 1: the "
                             "final partial batch cannot be evenly sliced across processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def num_batches(self) -> int:
        """The global batches of an epoch."""
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self) -> int:
        """The batches this process collates in an epoch."""
        n = self.num_batches()
        if self.split == "batches":
            return len(range(self.process_index, n, self.process_count))
        return n

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i * self.batch_size: (i + 1) * self.batch_size]
                   for i in range(self.num_batches())]
        if self.split == "batches":
            return batches[self.process_index::self.process_count]
        if self.process_count > 1:
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            batches = [b[lo: lo + local] for b in batches]
        return batches

    def _collate(self, indices) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
        items = [self.dataset[int(i)] for i in indices]
        batch = {}
        for k in items[0]:
            arr = np.stack([it[k] for it in items])
            if arr.dtype.kind in _NUMERIC:
                t = torch.from_numpy(arr)
                batch[k] = t.pin_memory() if self.device.type == "cuda" else t
            else:
                batch[k] = arr
        return batch

    def _to_device(self, batch: Dict) -> Dict:
        if self.device.type == "cpu":
            return batch
        return {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict]:
        self.epoch += 1
        batches = self._index_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(self._collate, b) for b in batches]
                for fut in futures:
                    if stop.is_set():
                        fut.cancel()
                        continue
                    try:
                        item = fut.result()
                    except Exception as e:  # raised again in the consumer
                        for f in futures:
                            f.cancel()
                        put(e)
                        return
                    if not put(item):
                        for f in futures:
                            f.cancel()
                        return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self._to_device(item)
        finally:
            stop.set()
            t.join()
