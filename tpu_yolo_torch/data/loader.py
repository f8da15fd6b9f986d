"""Multi-threaded prefetching data loader: the port's own copy of
`tpu_yolo/data/loader.py` (numpy only; the same batches from the same
seeds). OpenCV decode/warp releases the GIL, so a thread pool uses the
host cores without multiprocessing overhead; batches are prefetched into
a bounded queue so host preprocessing overlaps device steps.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpu_yolo_torch.data.dataset import collate


def shard_rows(start: int, batch_size: int, n: int, shard=None) -> range:
    """The dataset indices of the batch that starts at `start` (of `n`
    images) that a process decodes: all of them, or with shard=(index,
    count) the index-th of `count` contiguous equal parts of the batch
    (empty past the end of the dataset)."""
    if shard is None:
        return range(start, min(start + batch_size, n))
    index, count = shard
    if batch_size % count:
        raise ValueError(f"a batch of {batch_size} does not split over {count} processes")
    lo = start + index * (batch_size // count)
    return range(min(lo, n), min(lo + batch_size // count, n))


def empty_batch(size: int):
    """A batch of no images (a process's part past the end of the data)."""
    return (np.zeros((0, size, size, 3), np.uint8),
            {"cls": np.zeros((0, 1), np.float32), "box": np.zeros((0, 4), np.float32),
             "idx": np.zeros((0,), np.float32)})


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False,
                 prefetch: int = 4, seed: int = 0, sampler=None, shard=None):
        """`shard`: (index, count) to yield only that contiguous part of
        each batch (shard_rows), for data-parallel eval; every process
        then yields as many batches, some of them empty."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0
        self.sampler = sampler  # optional per-host shard sampler

    def set_epoch(self, epoch: int):
        """Reshuffle seed per epoch (reference DistributedSampler.set_epoch,
        main.py:107-108)."""
        self.epoch = epoch

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler.indices(self.epoch))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx.tolist()

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is not None:
            batches = [[b[j] for j in shard_rows(0, self.batch_size, len(b), self.shard)]
                       for b in batches]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(max(self.num_workers, 1)) as pool:
                try:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        q.put(collate(samples) if samples
                              else empty_batch(self.dataset.input_size))
                finally:
                    q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class ShardSampler:
    """Deterministic per-host shard of the index space for multi-host data
    parallelism (reference DistributedSampler, main.py:69-70). Each host
    sees an equal-size, padded shard; reshuffled by epoch."""

    def __init__(self, n: int, num_shards: int, shard: int, shuffle: bool = True,
                 seed: int = 0):
        self.n = n
        self.num_shards = num_shards
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed

    def indices(self, epoch: int):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        per = -(-self.n // self.num_shards)
        padded = np.concatenate([idx, idx[: per * self.num_shards - self.n]])
        return padded[self.shard::self.num_shards]


def make_val_loader(dataset, batch_size: int, num_workers: int = 8,
                    native: str = "auto", shard=None, device=None):
    """The eval loader over `dataset` (DetectionDataset(augment=False)),
    in dataset order. `native`: "auto" and "on" take a NativeEvalLoader
    (data/native_loader.py: the same label geometry, decode and letterbox
    in one pass) over, on a CUDA `device`, the card's pipeline (nvJPEG and
    the placement kernels; a failure to build or launch it raises), else
    the host C++ pool; off the card "auto" takes the Python loader where
    the host library is unavailable and "on" raises. "off" takes the
    Python loader, the parity oracle. `shard`: (index, count) to decode
    and yield only this process's contiguous part of each batch
    (shard_rows), for evaluate(dp=...)."""
    if native not in ("auto", "on", "off"):
        raise ValueError(f"native must be auto|on|off, got {native!r}")
    if native != "off":
        from tpu_yolo_torch.data import native_loader as nl
        if device is not None and str(device).startswith("cuda"):
            threads = max(num_workers, 1)
            return nl.NativeEvalLoader(
                dataset, batch_size, shard=shard, pipeline=nl.CardPipeline(
                    dataset.input_size, threads=threads, device=device))
        if nl.available():
            return nl.NativeEvalLoader(dataset, batch_size,
                                       threads=max(num_workers, 1), shard=shard)
        if native == "on":
            raise RuntimeError(
                "native eval loader requested (--native-eval on) but the host "
                f"data library is unavailable: {nl.why_unavailable()}")
    return DataLoader(dataset, batch_size, shuffle=False,
                      num_workers=num_workers, shard=shard)
