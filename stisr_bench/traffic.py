"""The benchmark's traffic: seeded word crops in TextZoom's LMDB layout.

A crop is rendered from ``(seed, index)`` alone (:func:`render_sample`: a
random lowercase-and-digit word of 2-8 characters on a noisy background,
HR 128x32, LR the HR blurred and downsampled to 64x16), so every run of a
seed reads the same images, and every seed the same sizes.  A mix's file
says how the crops are stored (:func:`encode`): which are JPEG and which
at another size than the crop's, as real TextZoom crops come, so that the
loader decodes and resizes.  Crops are rendered by a pool of worker
processes (spawned: they import this module alone), before the process
touches the card.
"""

from __future__ import annotations

import concurrent.futures
import io
import multiprocessing
import os
import random
import string
from functools import lru_cache

import numpy as np
from PIL import Image, ImageDraw, ImageFilter, ImageFont


@lru_cache(maxsize=None)
def _font(size: int):
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # an old PIL: the bitmap font
        return ImageFont.load_default()


def render_sample(rng: random.Random, hr_size=(128, 32), lr_size=(64, 16)):
    """(HR image, LR image, label) of one crop."""
    w, h = hr_size
    charset = string.ascii_lowercase + string.digits
    label = "".join(rng.choice(charset) for _ in range(rng.randint(2, 8)))
    bg, fg = rng.randint(120, 255), rng.randint(0, 100)
    noise = np.clip(np.full((h, w, 3), bg, np.float32)
                    + np.random.default_rng(rng.randrange(2**31)).normal(0, 12, (h, w, 3)),
                    0, 255).astype(np.uint8)
    img = Image.fromarray(noise)
    draw = ImageDraw.Draw(img)
    size = max(int(h * 0.65), 8)
    font = _font(size)
    while size > 8 and draw.textlength(label, font=font) > w - 6:
        size -= 2
        font = _font(size)
    left, top, right, bottom = draw.textbbox((0, 0), label, font=font)
    x = rng.randint(1, max(w - (right - left) - 2, 1)) - left
    y = rng.randint(0, max(h - (bottom - top) - 1, 0)) - top
    draw.text((x, y), label, font=font, fill=(fg, fg, fg))
    blurred = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.8, 1.6)))
    return img, blurred.resize(lr_size, Image.BICUBIC), label


def _png_or_jpeg(img: Image.Image, fmt: str) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def encode(i: int, hr: Image.Image, lr: Image.Image, store: dict) -> tuple[bytes, bytes]:
    """Crop ``i`` as stored: at ``store["odd_size"]`` sizes every
    ``store["odd_every"]``-th crop, JPEG every ``store["jpeg_every"]``-th,
    else PNG."""
    if store["odd_every"] and i % store["odd_every"] == store["odd_every"] // 2:
        (hw, hh), (lw, lh) = store["odd_size"]["hr"], store["odd_size"]["lr"]
        hr, lr = hr.resize((hw, hh)), lr.resize((lw, lh))
    fmt = "JPEG" if store["jpeg_every"] and i % store["jpeg_every"] == 0 else "PNG"
    return _png_or_jpeg(hr, fmt), _png_or_jpeg(lr, fmt)


def _render_chunk(job):
    seed, lo, hi, hr_size, lr_size, store = job
    out = []
    for i in range(lo, hi):
        hr, lr, label = render_sample(random.Random(seed * 1_000_003 + i), hr_size, lr_size)
        out.append((*encode(i, hr, lr, store), label))
    return out


def render(seed: int, n: int, hr_size, lr_size, store: dict, workers: int = 8) -> list:
    """``n`` stored crops ``(HR bytes, LR bytes, label)`` of ``seed``, in
    index order."""
    chunk = 256
    jobs = [(seed, lo, min(lo + chunk, n), tuple(hr_size), tuple(lr_size), store)
            for lo in range(0, n, chunk)]
    if workers <= 1 or len(jobs) == 1:
        return [r for job in jobs for r in _render_chunk(job)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx) as pool:
        return [r for part in pool.map(_render_chunk, jobs) for r in part]


def lmdb_records(crops: list) -> dict:
    """TextZoom's keys: ``num-samples`` and 1-based ``label-``,
    ``image_hr-`` and ``image_lr-%09d``."""
    records = {b"num-samples": str(len(crops)).encode()}
    for i, (hr, lr, label) in enumerate(crops, start=1):
        records[b"label-%09d" % i] = label.encode()
        records[b"image_hr-%09d" % i] = hr
        records[b"image_lr-%09d" % i] = lr
    return records


def decode(buf: bytes, size: tuple[int, int]) -> np.ndarray:
    """Stored bytes -> [H, W, 3] uint8 at ``size`` (W, H): PIL decode,
    BICUBIC resize where the stored size differs."""
    img = Image.open(io.BytesIO(buf)).convert("RGB")
    return np.asarray(img if img.size == tuple(size) else img.resize(tuple(size), Image.BICUBIC))


def batch_arrays(crops: list, rows, hr_size, lr_size) -> dict:
    """The uint8 HR and LR crops of ``rows``, decoded as the reference
    reads them."""
    return {"images_hr": np.stack([decode(crops[int(i)][0], hr_size) for i in rows]),
            "images_lr": np.stack([decode(crops[int(i)][1], lr_size) for i in rows])}


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The training loader's order of an epoch: ``np.random.default_rng(
    seed + epoch)`` shuffles the indices."""
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def cpu_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))
