"""Batches from an indexable dataset (counterpart of ``tatt_tpu/data/loader.py``).

``ds[i] -> (hr, lr, label)`` into :class:`~tatt_tpu_torch.data.collate.Batch`
es of ``batch_size``, shuffled per epoch by ``np.random.default_rng(seed +
epoch)`` as the JAX loader shuffles (the same seed gives the same batches),
the last short batch dropped when ``drop_last``; ``y_domain`` adds the
``YCbCr`` crops to each batch, ``syn`` collates as ``--syn`` does (without
the pseudo-LR crops, which no step reads), ``alphabet`` is the one the
label fields are encoded over and ``width``, ``height`` and
``down_sample_scale`` the crops' geometry, ``TRAIN``'s
(:func:`~tatt_tpu_torch.data.collate.collate`).  The collate's draws come
from a seed of (seed, epoch, batch index) (``tatt_tpu/data/loader.py:61-71``),
and the dataset's from its own per-sample keys (``set_epoch``).

Real crops cost a PNG/JPEG decode and, where their size differs, a bicubic
resize per sample, so whole batches are built ahead on a thread pool of
``max(num_workers, 1)`` threads (PIL decode and resize and the LMDB reads
release the interpreter lock), at most ``num_workers + prefetch`` in
flight, and yielded in order: any worker count gives the same batches.
The consumer's wait is spanned ``tatt.loader.first`` for an epoch's first
batch (the pool starts with nothing built) and ``tatt.loader.wait`` for
the rest; a worker's dataset reads ``tatt.loader.read`` and its collate
``tatt.loader.collate`` (:mod:`~tatt_tpu_torch.train.observe`).
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from tatt_tpu_torch.core.charset import CRNN_ALPHABET
from tatt_tpu_torch.data.collate import Batch, collate
from tatt_tpu_torch.data.lmdb_dataset import sample_key
from tatt_tpu_torch.train.observe import span, tracing


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 1234, num_workers: int = 1,
                 prefetch: int = 2, y_domain: bool = False, alphabet: str = CRNN_ALPHABET,
                 syn: bool = False, width: int = 128, height: int = 32,
                 down_sample_scale: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.y_domain = y_domain
        self.alphabet = alphabet
        self.syn = syn
        self.geometry = dict(width=width, height=height, down_sample_scale=down_sample_scale)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _build(self, sel: np.ndarray, batch_idx: int, epoch: int, traced: bool) -> Batch:
        """A batch, on a worker thread; ``traced``: whether the consumer's
        thread ran a profiler when it asked for the batch."""
        with span("tatt.loader.read", traced):
            samples = [self.dataset[int(i)] for i in sel]
        with span("tatt.loader.collate", traced):
            return collate(samples, self.y_domain, self.alphabet, syn=self.syn,
                           seed=sample_key(self.seed, epoch, batch_idx), pseudo_lr=False,
                           **self.geometry)

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        if hasattr(self.dataset, "set_epoch"):  # per-epoch augmentation draws
            self.dataset.set_epoch(self._epoch)
        epoch, self._epoch = self._epoch, self._epoch + 1
        sels = ((idx[b * self.batch_size : (b + 1) * self.batch_size], b, epoch)
                for b in range(len(self)))
        workers = max(self.num_workers, 1)
        pool = ThreadPoolExecutor(workers)
        try:
            inflight = deque(pool.submit(self._build, *s, tracing())
                             for s in itertools.islice(sels, workers + self.prefetch))
            wait = "tatt.loader.first"
            while inflight:
                fut = inflight.popleft()
                nxt = next(sels, None)
                if nxt is not None:
                    inflight.append(pool.submit(self._build, *nxt, tracing()))
                with span(wait):
                    batch = fut.result()
                wait = "tatt.loader.wait"
                yield batch
        finally:  # also when the consumer stops early (max_iters)
            pool.shutdown(wait=True, cancel_futures=True)
