"""Synthetic TextZoom-like fixture data (copied from
``tatt_tpu/data/synthetic.py``; the same seed renders the same samples).

The reference ships no test assets; its data comes from LMDB archives of
real paired LR/HR word crops (``dataset/dataset.py:565-686``).  For tests,
CI, and benchmarking we render random word crops with PIL: HR = text on a
textured background at 128x32; LR = HR downsampled with a blur, emulating
the TextZoom degradation gap.
"""

from __future__ import annotations

import random
import string
from functools import lru_cache

import numpy as np
from PIL import Image, ImageDraw, ImageFilter, ImageFont


@lru_cache(maxsize=None)
def _font(size: int):
    """Scalable built-in font (PIL >= 10.1); bitmap fallback otherwise."""
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # pragma: no cover - old PIL
        return ImageFont.load_default()


def render_sample(
    rng: random.Random,
    hr_size: tuple[int, int] = (128, 32),
    lr_size: tuple[int, int] = (64, 16),
    charset: str | None = None,
    misalign: float = 0.0,
) -> tuple[Image.Image, Image.Image, str]:
    """Returns (img_HR, img_lr, label).  ``charset`` defaults to
    lowercase+digits; a Chinese charset yields Chinese labels (PIL's
    built-in bitmap font cannot draw CJK glyphs, so the pixels then carry
    an ASCII placeholder — fixture images exercise shapes/metrics, not
    OCR legibility).

    ``misalign`` > 0 translates the LR crop by a per-sample uniform
    offset of up to that many HR pixels before downsampling — emulating
    TextZoom's imperfectly registered LR/HR pairs (the pairs come from
    different focal lengths; registration is a few pixels off), which is
    what gives the STN rectifier a real restoring gradient.  Aligned
    fixtures (the default) leave train-only STN with no anchor: it
    random-walks while the trunk co-adapts, so eval PSNR on unwarped
    inputs decays even as train loss falls."""
    w, h = hr_size
    charset = charset or (string.ascii_lowercase + string.digits)
    label = "".join(rng.choice(charset) for _ in range(rng.randint(2, 8)))
    bg = rng.randint(120, 255)
    fg = rng.randint(0, 100)
    noise = np.clip(
        np.full((h, w, 3), bg, np.float32)
        + np.random.default_rng(rng.randrange(2**31)).normal(0, 12, (h, w, 3)),
        0,
        255,
    ).astype(np.uint8)
    img = Image.fromarray(noise)
    draw = ImageDraw.Draw(img)
    drawable = (
        label
        if all(ord(ch) < 256 for ch in label)
        else "".join(rng.choice(string.ascii_lowercase) for _ in label)
    )
    # TextZoom-like glyph scale: text fills most of the crop height
    # (real word crops are tight boxes), shrunk to fit the width
    size = max(int(h * 0.65), 8)
    font = _font(size)
    while size > 8 and draw.textlength(drawable, font=font) > w - 6:
        size -= 2
        font = _font(size)
    left, top, right, bottom = draw.textbbox((0, 0), drawable, font=font)
    tw, th = right - left, bottom - top
    x = rng.randint(1, max(w - tw - 2, 1)) - left
    y = rng.randint(0, max(h - th - 1, 0)) - top
    draw.text((x, y), drawable, font=font, fill=(fg, fg, fg))
    blurred = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.8, 1.6)))
    if misalign > 0.0:
        dx = rng.uniform(-misalign, misalign)
        dy = rng.uniform(-misalign, misalign)
        # subpixel translation (bilinear); shifted-in border rows are
        # filled with the constant bg level (noise-free, a faint
        # statistical seam vs the sigma=12 background — acceptable for
        # fixtures)
        blurred = blurred.transform(
            blurred.size,
            Image.AFFINE,
            (1.0, 0.0, dx, 0.0, 1.0, dy),
            resample=Image.BILINEAR,
            fillcolor=(bg, bg, bg),
        )
    lr = blurred.resize(lr_size, Image.BICUBIC)
    return img, lr, label


class SyntheticTextDataset:
    """Deterministic synthetic dataset with the lmdbDataset_real sample
    contract: ``ds[i] -> (img_HR, img_lr, label_str)``."""

    def __init__(
        self,
        n: int = 64,
        seed: int = 0,
        hr_size: tuple[int, int] = (128, 32),
        lr_size: tuple[int, int] = (64, 16),
        cache: bool = True,
        charset: str | None = None,
        misalign: float = 0.0,
    ):
        self.n = n
        self.seed = seed
        self.hr_size = hr_size
        self.lr_size = lr_size
        self.charset = charset
        self.misalign = misalign
        # rendering costs ~2 ms/sample on a 1-CPU host; samples are
        # deterministic per index, so memoize across epochs
        self._cache: dict[int, tuple] | None = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        rng = random.Random(self.seed * 1_000_003 + i)
        sample = render_sample(
            rng, self.hr_size, self.lr_size, self.charset, self.misalign
        )
        if self._cache is not None:
            self._cache[i] = sample
        return sample
