"""Collate: PIL samples -> stacked uint8 crops and the label tensors
(``tatt_tpu/data/collate.py`` in its ``raw=True`` form, plus its label
fields and ``--y_domain``'s ``YCbCr`` crops).

HR is resized to 128x32 and LR to 64x16 (the default geometry, scale 2)
with PIL BICUBIC where the source size differs (``resizeNormalize``,
``dataset.py:1266-1319``).  The float conversion, layout and mask channel
run on the device (:func:`.device_pipeline.device_normalize`); the host
path's float tensors are bit-equal to them (the mask threshold is a mean
of integer lumas over 32x128 or 16x64 pixels, exact in float32).  With
``y_domain`` the same crops converted to PIL ``YCbCr`` ship beside the RGB
pair and are normalized the same way, their mask channel computed from
the ``YCbCr`` bytes as the JAX host collate computes it.

The label fields are the train collate's (``collate.py:203-214``), over
``alphabet`` (the CRNN's 37 symbols, or blank + the 3965-character table
under ``--CHNSR``: the table holds '-' too, so its symbols map to 3965
ids, '-' to the table's, and the one-hots are [B, 3965, 1, 26], as in
JAX): the
'-'-spread one-hots, their flat CTC ids, dense padded ``ctc_targets``
[B, 26] (the '-' padding is id 0, the blank) with ``ctc_lengths`` counted
from the one-hots' occupancy, and ``weighted_tics``.  ``--use_label``
reads the last three.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, encode_label_vecs

HR_SIZE = (128, 32)  # (width, height), TRAIN.width/height defaults
LR_SIZE = (64, 16)  # HR / down_sample_scale 2
LABEL_LEN = 26  # CTC frames of the CRNN, the spread labels' length


def batch_u8(imgs: Sequence[Image.Image], size: tuple[int, int]) -> np.ndarray:
    """Stack to [B, H, W, 3] uint8, resizing only images of another size."""
    return np.stack(
        [np.asarray(im if im.size == size else im.resize(size, Image.BICUBIC)) for im in imgs]
    )


@dataclass
class Batch:
    images_hr: np.ndarray  # [B, H, W, 3] uint8
    images_lr: np.ndarray  # [B, H/s, W/s, 3] uint8
    label_strs: list[str]
    label_vecs: np.ndarray  # [B, len(alphabet), 1, 26] spread one-hots
    ctc_ids: np.ndarray  # flat CTC ids
    ctc_targets: np.ndarray  # [B, 26] int32
    ctc_lengths: np.ndarray  # [B] int32
    weighted_tics: np.ndarray  # [B] int32
    images_hr_y: Optional[np.ndarray] = None  # [B, H, W, 3] uint8 YCbCr
    images_lr_y: Optional[np.ndarray] = None


def collate(samples: Sequence[tuple[Image.Image, Image.Image, str]], y_domain: bool = False,
            alphabet: str = CRNN_ALPHABET) -> Batch:
    """``samples``: iterable of (img_HR, img_lr, label)."""
    hrs, lrs, labels = zip(*samples)
    label_vecs, ctc_ids, tics = encode_label_vecs(labels, alphabet, LABEL_LEN)
    lengths = (label_vecs.sum(axis=1)[:, 0, :] > 0).sum(axis=1).astype(np.int32)
    ctc_targets = np.zeros((len(labels), LABEL_LEN), dtype=np.int32)
    ends = np.cumsum(lengths)
    for i, (n, end) in enumerate(zip(lengths, ends)):
        ctc_targets[i, :n] = ctc_ids[end - n : end]
    y = {}
    if y_domain:
        y = {"images_hr_y": batch_u8([im.convert("YCbCr") for im in hrs], HR_SIZE),
             "images_lr_y": batch_u8([im.convert("YCbCr") for im in lrs], LR_SIZE)}
    return Batch(batch_u8(hrs, HR_SIZE), batch_u8(lrs, LR_SIZE), list(labels), label_vecs,
                 ctc_ids, ctc_targets, lengths, tics, **y)
