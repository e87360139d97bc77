"""Collate: PIL samples -> stacked uint8 crops (``tatt_tpu/data/collate.py``
in its ``raw=True`` form, the fields the eval path and the canonical
training recipe read).

HR is resized to 128x32 and LR to 64x16 (the default geometry, scale 2)
with PIL BICUBIC where the source size differs (``resizeNormalize``,
``dataset.py:1266-1319``).  The float conversion, layout and mask channel
run on the device (:func:`.device_pipeline.device_normalize`); the host
path's float tensors are bit-equal to them (the mask threshold is a mean
of integer lumas over 32x128 or 16x64 pixels, exact in float32).  The
label tensors of the JAX collate (spread one-hots, CTC targets) serve only
``--use_label``, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
from PIL import Image

HR_SIZE = (128, 32)  # (width, height), TRAIN.width/height defaults
LR_SIZE = (64, 16)  # HR / down_sample_scale 2


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


def collate(samples: Sequence[tuple[Image.Image, Image.Image, str]]) -> Batch:
    """``samples``: iterable of (img_HR, img_lr, label)."""
    hrs, lrs, labels = zip(*samples)
    return Batch(batch_u8(hrs, HR_SIZE), batch_u8(lrs, LR_SIZE), list(labels))
