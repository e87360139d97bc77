"""TextZoom LMDB datasets (counterpart of ``tatt_tpu/data/lmdb_dataset.py``).

``lmdbDataset_real`` (reference ``dataset/dataset.py:565-686``): keys
``num-samples``, ``label-%09d``, ``image_hr-%09d`` (128x32) and
``image_lr-%09d`` (64x16), indices 1-based; an index past the end reads
the last sample; a corrupt record skips to the next index; a missing label
reads as a single space; labels go through ``str_filt(label, voc_type)``.
Images decode with PIL (the JAX package's fallback when OpenCV is absent,
bit-equal to its OpenCV path on JPEG since both link libjpeg-turbo).

``manmade_degrade`` replaces the stored LR by the manmade degradation of
HR (:func:`~tatt_tpu_torch.data.degradation.manmade_degradation`, at HR
size; the collate resizes it), ``cutblur`` pastes an HR slice into the LR
crop of a train sample.  Their draws come from a ``random.Random`` keyed
on (seed, epoch, index) (:func:`sample_key`), and the shot noise from a
``np.random.RandomState`` on the same key (JAX draws it from numpy's
global state), so any worker count gives the same samples.
:class:`MixDataset` is ``--mixed``'s wrapper, :class:`LmdbRecognitionDataset`
a recognition LMDB.
"""

from __future__ import annotations

import bisect
import io
import random

import numpy as np
from PIL import Image

from tatt_tpu_torch.core.charset import str_filt
from tatt_tpu_torch.data.degradation import manmade_degradation
from tatt_tpu_torch.data.lmdb_lite import LmdbEnv

MIX_STREAM = 0x6D6978  # MixDataset's draws: a stream apart from the wrapped set's


def buf2pil(buf: bytes) -> Image.Image:
    """PNG or JPEG bytes -> a loaded RGB PIL image (OSError when corrupt)."""
    return Image.open(io.BytesIO(buf)).convert("RGB")


def sample_key(seed: int, epoch: int, index: int) -> int:
    """The per-sample key of the augmentation draws (``lmdb_dataset.py:122-131``)."""
    return (seed * 1_000_003 + epoch) * 1_000_003 + index


def noise_state(key: int) -> np.random.RandomState:
    """The shot noise's generator for a sample key (numpy seeds are 32-bit)."""
    return np.random.RandomState(key % 2**32)


def open_lmdb(root: str) -> tuple[LmdbEnv, int]:
    """(the environment, its ``num-samples``); IOError without that key."""
    env = LmdbEnv(root)
    n = env.get(b"num-samples")
    if n is None:
        raise IOError(f"{root}: missing num-samples key")
    return env, int(n)


class LmdbTextDataset:
    """``ds[i] -> (img_hr, img_lr, label)`` over one TextZoom LMDB; a
    ``test`` set takes no ``cutblur``."""

    def __init__(self, root: str, voc_type: str = "all", manmade_degrade: bool = False,
                 cutblur: bool = False, test: bool = False, seed: int = 0):
        self.env, self.n_samples = open_lmdb(root)
        self.root = root
        self.voc_type = voc_type
        self.manmade_degrade = manmade_degrade
        self.cutblur = cutblur
        self.test = test
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Called by the loader each epoch, so that the draws change."""
        self._epoch = epoch

    def __len__(self) -> int:
        return self.n_samples

    def _cutblur(self, img_hr, img_lr, rng: random.Random):
        """CutBlur (``dataset.py:622-637``): with p=0.3 paste an HR slice,
        resized to the LR size, into the LR crop."""
        if rng.random() <= 0.7:
            return img_lr
        hr = np.array(img_hr.resize(img_lr.size, Image.BICUBIC))
        lr = np.array(img_lr)
        randx = int(lr.shape[1] * (0.2 + 0.8 * rng.random()))
        if rng.random() <= 0.5:
            lr[:, randx:] = hr[:, randx:]
        else:
            lr[:, :randx] = hr[:, :randx]
        return Image.fromarray(lr)

    def __getitem__(self, index: int):
        index = min(index, self.n_samples - 1)
        idx = index + 1  # keys are 1-based
        label_buf = self.env.get(b"label-%09d" % idx)
        label = label_buf.decode("utf-8", "ignore") if label_buf else " "
        hr_buf = self.env.get(b"image_hr-%09d" % idx)
        lr_buf = None if self.manmade_degrade else self.env.get(b"image_lr-%09d" % idx)
        if hr_buf is None or (lr_buf is None and not self.manmade_degrade):
            return self[(index + 1) % self.n_samples]
        key = sample_key(self.seed, self._epoch, index)
        rng = random.Random(key)
        try:
            img_hr = buf2pil(hr_buf)
            if self.manmade_degrade:
                img_lr = manmade_degradation(img_hr, rng, noise_state(key))
            else:
                img_lr = buf2pil(lr_buf)
        except OSError:  # corrupt record: skip forward like the reference
            return self[(index + 1) % self.n_samples]
        if self.cutblur and not self.test:
            img_lr = self._cutblur(img_hr, img_lr, rng)
        return img_hr, img_lr, str_filt(label, self.voc_type)


class LmdbRecognitionDataset:
    """A recognition LMDB (``lmdbDataset``, ``dataset.py:127-166``): keys
    ``label-%09d`` and ``image_hr-%09d`` or ``image-%09d``;
    ``ds[i] -> (img, label)``, the label unfiltered."""

    def __init__(self, root: str, voc_type: str = "all"):
        self.env, self.n_samples = open_lmdb(root)
        self.voc_type = voc_type

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int):
        idx = index + 1
        label_buf = self.env.get(b"label-%09d" % idx)
        label = label_buf.decode("utf-8", "ignore") if label_buf else " "
        buf = self.env.get(b"image_hr-%09d" % idx) or self.env.get(b"image-%09d" % idx)
        try:
            img = buf2pil(buf) if buf is not None else None
        except OSError:
            img = None
        if img is None:
            return self[(index + 1) % self.n_samples]
        return img, label


class MixDataset:
    """``--mixed`` (``lmdbDataset_mix``, ``dataset.py:1488-1596``): each
    sample's LR is, with probability ``synth_prob``, the manmade
    degradation of its HR resized to the LR's size."""

    def __init__(self, real_dataset, synth_prob: float = 0.5, seed: int = 0):
        self.real = real_dataset
        self.synth_prob = synth_prob
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.real, "set_epoch"):
            self.real.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.real)

    def __getitem__(self, index: int):
        key = sample_key(self.seed, self._epoch, index) ^ MIX_STREAM
        rng = random.Random(key)
        hr, lr, label = self.real[index]
        if rng.random() < self.synth_prob:
            lr = manmade_degradation(hr, rng, noise_state(key)).resize(lr.size, Image.BICUBIC)
        return hr, lr, label


class ConcatDataset:
    """Several datasets end to end (reference ``dataset/dataset.py:2237-2276``)."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("empty dataset list")
        self.datasets = list(datasets)
        self.cum = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cum.append(total)

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self) -> int:
        return self.cum[-1]

    def __getitem__(self, index: int):
        ds_idx = bisect.bisect_right(self.cum, index)
        prev = self.cum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][index - prev]
