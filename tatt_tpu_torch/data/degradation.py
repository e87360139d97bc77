"""Synthetic degradation (counterpart of ``tatt_tpu/data/degradation.py``),
host-side, over :mod:`.imgproc` in place of OpenCV.

The reference's manmade-degradation chain (``dataset/dataset.py:422-489``:
pre-blur, shot and read noise, Gaussian or bilateral noise reduction,
unsharp sharpening) and the random blur ensemble of the ``--syn`` collate
(``dataset.py:1636-1649``, imgaug's seven augmenters, each with
probability p in random order).  Every random draw is the JAX package's,
in its order, from the ``random.Random`` the caller passes; the shot
noise, which JAX draws from numpy's global state, comes from the
``np.random.RandomState`` the caller passes (the same draws when that
state is seeded as the global one was).
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image

from tatt_tpu_torch.data import imgproc


def gauss_unsharp_mask(rgb: np.ndarray, k: int, sigma: float, gain: float):
    lf = imgproc.gaussian_blur(rgb, k, sigma)
    hf = rgb - lf
    return np.clip(rgb + hf * gain, 0.0, 255.0), lf


def add_shot_gauss_noise(rgb: np.ndarray, shot_noise_mean: float, read_noise: float,
                         noise_rng: np.random.RandomState) -> np.ndarray:
    noise_var = shot_noise_mean * rgb + read_noise
    noise = noise_rng.normal(loc=0.0, scale=np.sqrt(noise_var))
    if rgb.mean() > 252.0:
        return rgb
    return np.clip(rgb + noise, 0.0, 255.0)


def manmade_degradation(src_img, rng: random.Random, noise_rng: np.random.RandomState) -> Image.Image:
    """``degradation()`` (``dataset.py:442-489``)."""
    gt = np.asarray(src_img).astype(np.float32)
    k = rng.choice([3, 5])
    pre = imgproc.gaussian_blur(gt, k, rng.uniform(5.0, 6.0))
    if rng.random() > 0.2:
        noised = add_shot_gauss_noise(pre, rng.uniform(0, 0.005), rng.uniform(0, 0.015), noise_rng)
    else:
        noised = pre
    noised = np.round(noised).astype(np.uint8)
    if rng.uniform(0, 1.0) < 0.7:
        nk = rng.choice([3, 5])
        nr = imgproc.gaussian_blur(noised, nk, rng.uniform(2.0, 3.0))
    else:
        nr = imgproc.bilateral_filter(noised, 7, rng.uniform(70, 80), rng.uniform(70, 80))
    nr = nr.astype(np.float32)
    sk = rng.choice([3, 5])
    sharp, _ = gauss_unsharp_mask(nr, sk, rng.uniform(2.0, 3.0), rng.uniform(3.0, 4.0))
    return Image.fromarray(sharp.astype(np.uint8))


def motion_kernel(k: int, angle: float) -> np.ndarray:
    """The k x k line kernel of ``_motion_blur`` at ``angle`` degrees."""
    kernel = np.zeros((k, k), np.float32)
    c = (k - 1) / 2
    dx, dy = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    for t in np.linspace(-c, c, k * 2):
        x, y = int(round(c + t * dx)), int(round(c + t * dy))
        if 0 <= x < k and 0 <= y < k:
            kernel[y, x] = 1
    kernel /= max(kernel.sum(), 1)
    return kernel


def _motion_blur(img: np.ndarray, k: int, rng: random.Random) -> np.ndarray:
    return imgproc.filter2d(img, motion_kernel(k, rng.uniform(0, 180)))


def slic_segments(img: np.ndarray, n_segments: int, compactness: float = 10.0,
                  n_iter: int = 10) -> np.ndarray:
    """SLIC superpixels (Achanta et al. 2012, what ``iaa.Superpixels``
    wraps): localized k-means over (L, a, b, y, x) with the distance
    ``d_lab + (compactness / S)^2 d_xy``.  An int32 label map [H, W]."""
    h, w = img.shape[:2]
    n_segments = max(int(n_segments), 1)
    lab = imgproc.rgb_to_lab(np.ascontiguousarray(img, np.uint8)).astype(np.float32)
    step = max(int(np.sqrt(h * w / n_segments)), 1)
    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    if ys.size == 0:
        ys = np.array([h // 2])
    if xs.size == 0:
        xs = np.array([w // 2])
    centers = np.array(
        [[lab[y, x, 0], lab[y, x, 1], lab[y, x, 2], y, x] for y in ys for x in xs], np.float32
    )
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ratio = (compactness / step) ** 2
    labels = np.zeros((h, w), np.int32)
    for _ in range(n_iter):
        dist = np.full((h, w), np.inf, np.float32)
        for ci, c in enumerate(centers):
            y0, y1 = max(int(c[3]) - step, 0), min(int(c[3]) + step + 1, h)
            x0, x1 = max(int(c[4]) - step, 0), min(int(c[4]) + step + 1, w)
            if y0 >= y1 or x0 >= x1:
                continue
            patch = lab[y0:y1, x0:x1]
            d_lab = ((patch - c[:3]) ** 2).sum(axis=-1)
            d_xy = (yy[y0:y1, x0:x1] - c[3]) ** 2 + (xx[y0:y1, x0:x1] - c[4]) ** 2
            d = d_lab + ratio * d_xy
            win = dist[y0:y1, x0:x1]
            better = d < win
            win[better] = d[better]
            labels[y0:y1, x0:x1][better] = ci
        for ci in range(len(centers)):
            m = labels == ci
            if m.any():
                centers[ci, :3] = lab[m].mean(axis=0)
                centers[ci, 3] = yy[m].mean()
                centers[ci, 4] = xx[m].mean()
    return labels


def _superpixels(img: np.ndarray, n_segments: int, p_replace: float, rng: random.Random) -> np.ndarray:
    """``iaa.Superpixels(p_replace, n_segments)``: SLIC, then each segment
    (in ``np.unique`` order) replaced by its mean colour with probability
    ``p_replace``."""
    labels = slic_segments(img, n_segments)
    out = img.copy()
    for ci in np.unique(labels):
        if rng.random() < p_replace:
            m = labels == ci
            out[m] = img[m].mean(axis=0).astype(img.dtype)
    return out


def blur_ensemble(img, rng: random.Random, p: float = 0.2) -> Image.Image:
    """The ``--syn`` collate's blur ensemble (``dataset.py:1636-1649``):
    seven augmenters, shuffled, each applied with probability ``p``."""
    arr = np.asarray(img)

    def gaussian(a):
        return imgproc.gaussian_blur(a, 5, rng.uniform(0.0, 3.0) + 1e-6)

    def average(a):
        return imgproc.box_blur(a, rng.choice([1, 3, 5]))

    def median(a):
        return imgproc.median_blur(a, rng.choice([3, 5, 7]))

    def bilateral(a):
        d = rng.choice([3, 5, 7, 9])
        return imgproc.bilateral_filter(a, d, rng.uniform(10, 250), rng.uniform(10, 250))

    def motion(a):
        return _motion_blur(a, 3, rng)

    def meanshift(a):
        # iaa.MeanShiftBlur: both radii uniform in (5, 40)
        return imgproc.mean_shift_filter(a, rng.uniform(5.0, 40.0), rng.uniform(5.0, 40.0))

    def superpixels(a):
        return _superpixels(a, rng.randint(1, 7), rng.uniform(0.1, 0.5), rng)

    augs = [gaussian, average, median, bilateral, motion, meanshift, superpixels]
    rng.shuffle(augs)
    for aug in augs:
        if rng.random() < p:
            arr = aug(np.ascontiguousarray(arr))
    return Image.fromarray(arr)

