"""Collate: PIL samples -> stacked uint8 crops and the label tensors
(``tatt_tpu/data/collate.py`` in its ``raw=True`` form, plus its label
fields and ``--y_domain``'s ``YCbCr`` crops and ``--syn``'s pseudo-LR crops).

HR is resized to ``width`` x ``height`` (``TRAIN.width`` / ``height``,
128x32 by default) and LR to that over ``down_sample_scale`` (64x16 at
scale 2) with PIL BICUBIC where the source size differs
(``resizeNormalize``, ``dataset.py:1266-1319``; JAX's ``collate``,
``collate.py:131-135, 171``).  The float conversion, layout and mask
channel run on the device (:func:`.device_pipeline.device_normalize`);
the host path's float tensors are bit-equal to them (the mask threshold is
a mean of integer lumas, exact in float32 below 2^24 / 255 pixels).  With
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

``syn`` is ``alignCollate_syn`` (``tatt_tpu/data/collate.py:141-220``):
each LR crop is halved again with PIL BICUBIC before the resize to the LR
size, the labels are not '-'-spread and the ``word[2]='e'`` perturbation
is on; with ``pseudo_lr`` (the default, as JAX builds it)
``images_pseudo_lr`` holds the blur ensemble of each halved LR resized to
the LR size, drawn from ``random.Random(seed)``.  No train step reads it,
in JAX either, so the train loader asks for none
(:class:`~tatt_tpu_torch.data.loader.DataLoader`); the ensemble draws only
from its own stream, so no other field changes.  At an LR width other than
64 or 128 the blur inherits ``imgproc.gaussian_blur``'s one-ulp float32
difference from OpenCV at a row's last columns (ROADMAP C.3).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from tatt_tpu_torch.core.charset import CRNN_ALPHABET, encode_label_vecs
from tatt_tpu_torch.data.degradation import blur_ensemble

LABEL_LEN = 26  # CTC frames of the CRNN, the spread labels' length (any geometry)


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
    images_pseudo_lr: Optional[np.ndarray] = None  # [B, H/s, W/s, 3] uint8, syn and pseudo_lr


def collate(samples: Sequence[tuple[Image.Image, Image.Image, str]], y_domain: bool = False,
            alphabet: str = CRNN_ALPHABET, syn: bool = False, seed: Optional[int] = None,
            width: int = 128, height: int = 32, down_sample_scale: int = 2,
            pseudo_lr: bool = True) -> Batch:
    """``samples``: iterable of (img_HR, img_lr, label)."""
    hrs, lrs, labels = zip(*samples)
    hr_size = (width, height)
    lr_size = (width // down_sample_scale, height // down_sample_scale)
    extra = {}
    if syn:
        lrs = [lr.resize((lr.width // 2, lr.height // 2), Image.BICUBIC) for lr in lrs]
        if pseudo_lr:
            rng = random.Random(seed)
            extra["images_pseudo_lr"] = batch_u8(
                [blur_ensemble(lr.resize(lr_size, Image.BICUBIC), rng) for lr in lrs], lr_size)
    label_vecs, ctc_ids, tics = encode_label_vecs(labels, alphabet, LABEL_LEN, eval_perturb=syn,
                                                  spread=not syn)
    lengths = (label_vecs.sum(axis=1)[:, 0, :] > 0).sum(axis=1).astype(np.int32)
    ctc_targets = np.zeros((len(labels), LABEL_LEN), dtype=np.int32)
    ends = np.cumsum(lengths)
    for i, (n, end) in enumerate(zip(lengths, ends)):
        ctc_targets[i, :n] = ctc_ids[end - n : end]
    if y_domain:
        extra["images_hr_y"] = batch_u8([im.convert("YCbCr") for im in hrs], hr_size)
        extra["images_lr_y"] = batch_u8([im.convert("YCbCr") for im in lrs], lr_size)
    return Batch(batch_u8(hrs, hr_size), batch_u8(lrs, lr_size), list(labels), label_vecs,
                 ctc_ids, ctc_targets, lengths, tics, **extra)
