"""Offline data-prep tools (counterpart of ``tatt_tpu/data/prep_tools.py``).

``dataset/crop_800k.py`` (word boxes cut out of SynthText's ``gt.mat``)
and the ``dataset/voc_data.py`` folder reader; their corpora become
TextZoom-layout LMDBs through :mod:`tatt_tpu_torch.data.create_lmdb`.
"""

from __future__ import annotations

import math
import os
import string
from typing import Iterator, Optional

import numpy as np
from PIL import Image


def split_synthtext_labels(txt) -> list[str]:
    """SynthText ``txt`` entries pack several whitespace-separated words
    each (``crop_800k.py:14-23``)."""
    return [part for entry in txt for part in str(entry).split() if part]


def word_rects(word_bb: np.ndarray) -> list[tuple[int, int, int, int]]:
    """``wordBB`` [2, 4, N] -> an axis-aligned (x0, y0, x1, y1) a word
    (``crop_800k.py:26-54``)."""
    if word_bb.ndim == 2:
        word_bb = word_bb.reshape(2, 4, 1)
    rects = []
    for j in range(word_bb.shape[2]):
        xs, ys = word_bb[0, :, j], word_bb[1, :, j]
        rects.append((int(math.floor(xs.min())), int(math.floor(ys.min())),
                      int(math.ceil(xs.max())), int(math.ceil(ys.max()))))
    return rects


def iter_synthtext_crops(gt_path: str, image_root: str, min_size: int = 4,
                         skip_punct_only: bool = True) -> Iterator[tuple[Image.Image, str]]:
    """(word crop, label) pairs of a SynthText ``gt.mat`` (read with
    ``scipy.io.loadmat``); images missing under ``image_root`` are skipped,
    and so are crops under ``min_size`` px and punctuation-only words."""
    from scipy.io import loadmat

    def unwrap_str(x):
        while isinstance(x, np.ndarray):
            x = x.ravel()[0]
        return str(x)

    def unwrap_arr(x):
        while isinstance(x, np.ndarray) and x.dtype == object and x.size == 1:
            x = x.ravel()[0]
        return np.asarray(x, dtype=np.float64) if np.asarray(x).dtype == object else np.asarray(x)

    m = loadmat(gt_path)
    for i in range(m["imnames"][0].shape[0]):
        labels = split_synthtext_labels(unwrap_arr(m["txt"][0][i]).ravel())
        rects = word_rects(unwrap_arr(m["wordBB"][0][i]))
        path = os.path.join(image_root, unwrap_str(m["imnames"][0][i]))
        if not os.path.exists(path):
            continue
        img = Image.open(path).convert("RGB")
        for label, (x0, y0, x1, y1) in zip(labels, rects):
            if skip_punct_only and all(ch in string.punctuation for ch in label):
                continue
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, img.width), min(y1, img.height)
            if x1c - x0c < min_size or y1c - y0c < min_size:
                continue
            yield img.crop((x0c, y0c, x1c, y1c)), label


class VocFolderDataset:
    """A folder of ``.jpg`` crops (``dataset/voc_data.py:46-101``), each
    labelled by ``<stem>.txt`` beside it, else by its stem."""

    def __init__(self, root: str):
        self.root = root
        self.names = sorted(n for n in os.listdir(root) if n.lower().endswith(".jpg"))

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, index: int):
        name = self.names[index]
        img = Image.open(os.path.join(self.root, name)).convert("RGB")
        stem = os.path.splitext(name)[0]
        label_path = os.path.join(self.root, stem + ".txt")
        if os.path.exists(label_path):
            with open(label_path) as fh:
                return img, fh.read().strip()
        return img, stem


def synthtext_to_lmdb(gt_path: str, image_root: str, out_root: str,
                      limit: Optional[int] = None) -> int:
    """SynthText's word crops into a TextZoom-layout LMDB (HR = crop, LR =
    its bicubic half); returns the sample count."""
    from tatt_tpu_torch.data.create_lmdb import create_dataset

    def samples():
        for k, (img, label) in enumerate(iter_synthtext_crops(gt_path, image_root)):
            if limit is not None and k >= limit:
                return
            yield img, None, label

    return create_dataset(out_root, samples())
