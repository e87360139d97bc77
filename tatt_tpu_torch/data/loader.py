"""Batches from an indexable dataset (counterpart of ``tatt_tpu/data/loader.py``).

``ds[i] -> (hr, lr, label)`` into :class:`~tatt_tpu_torch.data.collate.Batch`
es of ``batch_size``, shuffled per epoch by ``np.random.default_rng(seed +
epoch)`` as the JAX loader shuffles (the same seed gives the same batches),
the last short batch dropped when ``drop_last``; ``y_domain`` adds the
``YCbCr`` crops to each batch, and ``alphabet`` is the one the label fields
are encoded over (:func:`~tatt_tpu_torch.data.collate.collate`).

Real crops cost a PNG/JPEG decode and, where their size differs, a bicubic
resize per sample, so whole batches are built ahead on a thread pool of
``max(num_workers, 1)`` threads (PIL decode and resize and the LMDB reads
release the interpreter lock), at most ``num_workers + prefetch`` in
flight, and yielded in order: any worker count gives the same batches.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from tatt_tpu_torch.core.charset import CRNN_ALPHABET
from tatt_tpu_torch.data.collate import Batch, collate


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 1234, num_workers: int = 1,
                 prefetch: int = 2, y_domain: bool = False, alphabet: str = CRNN_ALPHABET):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.y_domain = y_domain
        self.alphabet = alphabet
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _build(self, sel: np.ndarray) -> Batch:
        return collate([self.dataset[int(i)] for i in sel], self.y_domain, self.alphabet)

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        if hasattr(self.dataset, "set_epoch"):  # per-epoch augmentation draws
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        sels = (idx[b * self.batch_size : (b + 1) * self.batch_size] for b in range(len(self)))
        workers = max(self.num_workers, 1)
        pool = ThreadPoolExecutor(workers)
        try:
            inflight = deque(pool.submit(self._build, s)
                             for s in itertools.islice(sels, workers + self.prefetch))
            while inflight:
                fut = inflight.popleft()
                nxt = next(sels, None)
                if nxt is not None:
                    inflight.append(pool.submit(self._build, nxt))
                yield fut.result()
        finally:  # also when the consumer stops early (max_iters)
            pool.shutdown(wait=True, cancel_futures=True)
