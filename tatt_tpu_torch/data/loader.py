"""Batches from an indexable dataset (counterpart of ``tatt_tpu/data/loader.py``).

``ds[i] -> (hr, lr, label)`` into :class:`~tatt_tpu_torch.data.collate.Batch`
es of ``batch_size``, shuffled per epoch by ``np.random.default_rng(seed +
epoch)`` as the JAX loader shuffles (the same seed gives the same batches),
the last short batch dropped when ``drop_last``.  Synchronous: collating
cached synthetic crops takes a few milliseconds a batch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tatt_tpu_torch.data.collate import Batch, collate


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])
