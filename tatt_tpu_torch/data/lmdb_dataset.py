"""TextZoom LMDB datasets (counterpart of ``tatt_tpu/data/lmdb_dataset.py``,
its defaults only).

``lmdbDataset_real`` (reference ``dataset/dataset.py:565-686``): keys
``num-samples``, ``label-%09d``, ``image_hr-%09d`` (128x32) and
``image_lr-%09d`` (64x16), indices 1-based; an index past the end reads
the last sample; a corrupt record skips to the next index; a missing label
reads as a single space; labels go through ``str_filt(label, voc_type)``.
Images decode with PIL (the JAX package's fallback when OpenCV is absent,
bit-equal to its OpenCV path on JPEG since both link libjpeg-turbo).
``manmade_degrade``, ``cutblur``, ``MixDataset`` and
``LmdbRecognitionDataset`` are not ported yet.
"""

from __future__ import annotations

import bisect
import io

from PIL import Image

from tatt_tpu_torch.core.charset import str_filt
from tatt_tpu_torch.data.lmdb_lite import LmdbEnv


def decode_rgb(buf: bytes) -> Image.Image:
    """PNG or JPEG bytes -> a loaded RGB PIL image (OSError when corrupt)."""
    return Image.open(io.BytesIO(buf)).convert("RGB")


class LmdbTextDataset:
    """``ds[i] -> (img_hr, img_lr, label)`` over one TextZoom LMDB."""

    def __init__(self, root: str, voc_type: str = "all"):
        self.env = LmdbEnv(root)
        self.root = root
        n = self.env.get(b"num-samples")
        if n is None:
            raise IOError(f"{root}: missing num-samples key")
        self.n_samples = int(n)
        self.voc_type = voc_type

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int):
        index = min(index, self.n_samples - 1)
        idx = index + 1  # keys are 1-based
        label_buf = self.env.get(b"label-%09d" % idx)
        label = label_buf.decode("utf-8", "ignore") if label_buf else " "
        hr_buf, lr_buf = self.env.get(b"image_hr-%09d" % idx), self.env.get(b"image_lr-%09d" % idx)
        if hr_buf is None or lr_buf is None:
            return self[(index + 1) % self.n_samples]
        try:
            img_hr, img_lr = decode_rgb(hr_buf), decode_rgb(lr_buf)
        except OSError:  # corrupt record: skip forward like the reference
            return self[(index + 1) % self.n_samples]
        return img_hr, img_lr, str_filt(label, self.voc_type)


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

    def __len__(self) -> int:
        return self.cum[-1]

    def __getitem__(self, index: int):
        ds_idx = bisect.bisect_right(self.cum, index)
        prev = self.cum[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][index - prev]
