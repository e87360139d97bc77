"""The image operations of the data path, in numpy and scipy (no OpenCV).

The JAX package's degradation pipeline and dataset readers call OpenCV
(``tatt_tpu/data/degradation.py``, ``tatt_tpu/data/variants.py``); the
port's machine has no OpenCV, so each call has a counterpart here that
follows OpenCV's own arithmetic, its fixed-point rounding included.
Inputs are HWC (or HW) arrays, uint8 or float32, as the JAX calls pass
them; the default border is OpenCV's ``BORDER_REFLECT_101`` (numpy's
``"reflect"``).  Held against ``cv2`` by ``tests/test_torch_degradation.py``
and, where ``cv2`` is absent, against ``tests/torch_cv2_golden.npz``:

- exact: ``gaussian_blur`` on uint8, ``box_blur``, ``median_blur``,
  ``filter2d`` on uint8, ``mean_shift_filter``, ``rgb_to_lab`` and
  ``rgb_to_gray`` (over all 2^24 colours), ``canny``, ``dilate``;
- ``gaussian_blur`` on float32 (k = 3 and 5): exact on the data path's
  64- and 128-pixel-wide crops; on other widths OpenCV sums the last
  columns of a row in another order (1 ulp apart there);
- ``bilateral_filter``: 1 level off on ~1e-5 of the values (a weighted
  mean whose float32 sum OpenCV orders otherwise lands on the other side
  of a half).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

REFLECT_101 = "reflect"  # numpy's name for OpenCV's BORDER_REFLECT_101
# pyrMeanShiftFiltering's defaults: maxLevel 1, TermCriteria(MAX_ITER + EPS, 5, 1)
MEAN_SHIFT_LEVELS, MEAN_SHIFT_ITERS, MEAN_SHIFT_EPS = 1, 5, 1
MEAN_SHIFT_CHUNK = 1024  # pixels shifted at once (bounds the [n, H*W] products)


def _hwc(img: np.ndarray) -> tuple[np.ndarray, bool]:
    """(img with a channel axis, whether one was added)."""
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _pad(a: np.ndarray, ry: int, rx: int, mode: str = REFLECT_101) -> np.ndarray:
    return np.pad(a, ((ry, ry), (rx, rx), (0, 0)), mode=mode)


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """``cv::getGaussianKernel(k, sigma)`` for sigma > 0: float64 taps
    summing to 1."""
    x = np.arange(k) - (k - 1) / 2.0
    t = np.exp(-(x * x) / (2.0 * sigma * sigma))
    half = k // 2
    total = 2.0 * t[:half].sum() + 1.0
    taps = t / total
    taps[half] = 1.0 / total
    return taps


def _gaussian_taps_q8(k: int, sigma: float) -> np.ndarray:
    """The uint8 path's taps in Q8: each outer tap rounded with the
    previous taps' rounding error carried on (error diffusion), the centre
    tap what makes the sum 256."""
    taps = gaussian_kernel(k, sigma)
    out = np.zeros(k, np.int64)
    err, outer = 0.0, 0
    for i in range(k // 2):
        adj = taps[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[k - 1 - i] = v
        outer += v
    out[k // 2] = 256 - 2 * outer
    return out


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _symmetric_pass(tap, taps: np.ndarray, centre_first: bool) -> np.ndarray:
    """One float32 pass of a symmetric kernel in OpenCV's order
    (``SymmRowSmallVec_32f`` / ``SymmColumn*Vec_32f``): the column pass
    starts from centre x its tap, the row pass from the inner pair x its
    tap with the centre fused in next; then each further pair, inner to
    outer, fused in (``v_muladd``).  ``tap(i)`` is the input shifted to
    kernel position i."""
    r = len(taps) // 2
    pair = lambda i: (tap(r - i) + tap(r + i)).astype(np.float32)  # noqa: E731
    if centre_first or r == 0:
        s, first = (tap(r) * taps[r]).astype(np.float32), 1
    else:
        s, first = _fma32(tap(r), taps[r], (pair(1) * taps[r - 1]).astype(np.float32)), 2
    for i in range(first, r + 1):
        s = _fma32(pair(i), taps[r - i], s)
    return s


def gaussian_blur(img: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)``.  uint8: two integer passes
    over Q8 taps, then ``(x + 2^15) >> 16``; float32: a row pass then a
    column pass, each summed as :func:`_symmetric_pass` says."""
    a, squeeze = _hwc(np.asarray(img))
    h, w = a.shape[:2]
    r = k // 2
    if a.dtype == np.uint8:
        taps = _gaussian_taps_q8(k, sigma)
        p = _pad(a.astype(np.int64), 0, r)
        rows = sum(taps[i] * p[:, i:i + w] for i in range(k))
        p = _pad(rows, r, 0)
        out = sum(taps[i] * p[i:i + h] for i in range(k))
        out = ((out + (1 << 15)) >> 16).astype(np.uint8)
    else:
        taps = gaussian_kernel(k, sigma).astype(np.float32)
        p = _pad(a.astype(np.float32), 0, r)
        rows = _symmetric_pass(lambda i: p[:, i:i + w], taps, centre_first=False)
        p = _pad(rows, r, 0)
        out = _symmetric_pass(lambda i: p[i:i + h], taps, centre_first=True)
    return out[..., 0] if squeeze else out


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` on uint8: the window's integer sum over
    k^2, rounded (no sum of a 3x3 or 5x5 window falls on a half)."""
    a, squeeze = _hwc(np.asarray(img))
    if k == 1:
        return np.array(img, copy=True)
    h, w = a.shape[:2]
    r = k // 2
    p = _pad(a.astype(np.int64), r, r)
    s = sum(p[i:i + h, j:j + w] for i in range(k) for j in range(k))
    out = ((2 * s + k * k) // (2 * k * k)).astype(np.uint8)
    return out[..., 0] if squeeze else out


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)``: per channel, replicated border."""
    a, squeeze = _hwc(np.asarray(img))
    out = ndimage.median_filter(a, size=(k, k, 1), mode="nearest")
    return out[..., 0] if squeeze else out


def bilateral_filter(img: np.ndarray, d: int, sigma_color: float, sigma_space: float) -> np.ndarray:
    """``cv2.bilateralFilter`` on uint8: the neighbours of the disc of
    radius d // 2, each weighted in float32 by its space weight times the
    colour weight indexed by the L1 distance summed over the channels,
    accumulated in the disc's row-major order; the weighted mean rounded."""
    a, squeeze = _hwc(np.asarray(img))
    h, w, cn = a.shape
    sigma_color = sigma_color if sigma_color > 0 else 1.0
    sigma_space = sigma_space if sigma_space > 0 else 1.0
    radius = max(d // 2 if d > 0 else int(np.rint(sigma_space * 1.5)), 1)
    color_w = np.exp(np.arange(256 * cn, dtype=np.float64) ** 2
                     * (-0.5 / (sigma_color * sigma_color))).astype(np.float32)
    p = _pad(a.astype(np.int32), radius, radius)
    centre = a.astype(np.int32)
    wsum = np.zeros((h, w), np.float32)
    acc = np.zeros((h, w, cn), np.float32)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            rr = np.sqrt(float(i * i + j * j))
            if rr > radius:
                continue
            space = np.float32(np.exp(rr * rr * (-0.5 / (sigma_space * sigma_space))))
            nb = p[radius + i:radius + i + h, radius + j:radius + j + w]
            wt = space * color_w[np.abs(nb - centre).sum(-1)]
            wsum += wt
            acc += nb.astype(np.float32) * wt[..., None]
    out = np.rint(acc * (np.float32(1) / wsum)[..., None]).clip(0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8: correlation with the
    anchor at the kernel's centre, a float32 sum over the non-zero taps in
    row-major order, rounded."""
    a, squeeze = _hwc(np.asarray(img))
    kh, kw = kernel.shape
    h, w = a.shape[:2]
    ay, ax = kh // 2, kw // 2
    p = np.pad(a.astype(np.float32), ((ay, kh - 1 - ay), (ax, kw - 1 - ax), (0, 0)),
               mode=REFLECT_101)
    s = np.zeros(a.shape, np.float32)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0:
                s = s + np.float32(kernel[i, j]) * p[i:i + h, j:j + w]
    out = np.rint(s).clip(0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def _pyr_down(a: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown``: [1 4 6 4 1]^2 / 256, reflect-101, even samples."""
    h, w = a.shape[:2]
    k = (1, 4, 6, 4, 1)
    p = _pad(a.astype(np.int64), 2, 2)
    rows = sum(k[i] * p[:, i:i + w] for i in range(5))[:, 0::2]
    out = sum(k[i] * rows[i:i + h] for i in range(5))[0::2]
    return ((out + 128) >> 8).astype(np.uint8)


def _pyr_up(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.pyrUp`` to ``size`` (h, w): even outputs take [1 6 1], odd
    ones [4 4], / 64; the border reflects (101) at the top and left and
    replicates at the bottom and right, as OpenCV's loop does."""
    s = a.astype(np.int64)
    h, w = s.shape[:2]
    ext = np.concatenate([s[:, 1:2] if w > 1 else s[:, :1], s, s[:, -1:]], axis=1)
    rows = np.empty((h, 2 * w) + s.shape[2:], np.int64)
    rows[:, 0::2] = ext[:, :-2] + 6 * ext[:, 1:-1] + ext[:, 2:]
    rows[:, 1::2] = 4 * (ext[:, 1:-1] + ext[:, 2:])
    ext = np.concatenate([rows[1:2] if h > 1 else rows[:1], rows, rows[-1:]], axis=0)
    out = np.empty((2 * h, 2 * w) + s.shape[2:], np.int64)
    out[0::2] = ext[:-2] + 6 * ext[1:-1] + ext[2:]
    out[1::2] = 4 * (ext[1:-1] + ext[2:])
    return ((out[:size[0], :size[1]] + 32) >> 6).astype(np.uint8)


def _shift(src: np.ndarray, sp: np.float32, isr2: int, starts: np.ndarray) -> np.ndarray:
    """Mean shift of the pixels ``starts`` (flat indices) of ``src``, all
    at once: each step averages, over the square window of radius ``sp``
    around the pixel's current position, the pixels whose squared colour
    distance to its current colour is at most ``isr2``; a pixel stops when
    its position stays or position and colour move by at most
    ``MEAN_SHIFT_EPS``, or after ``MEAN_SHIFT_ITERS`` steps.
    Returns the final colours [n, 3].  Every sum is of integers below
    2^24, so float32 products and sums are exact."""
    h, w, _ = src.shape
    col = src.reshape(-1, 3).astype(np.float32)
    ys, xs = np.divmod(np.arange(h * w), w)
    # per pixel of the window: x, y, the three channels and 1, so that one
    # product gives every sum of a step
    feats = np.concatenate([xs[:, None], ys[:, None], col, np.ones((h * w, 1))],
                           axis=1).astype(np.float32)
    sq = (col * col).sum(1)
    x0, y0 = starts % w, starts // w
    c = col[starts].astype(np.int64)
    active = np.ones(len(starts), bool)
    cols, rows = np.arange(w), np.arange(h)
    for _ in range(MEAN_SHIFT_ITERS):
        for lo in range(0, len(starts), MEAN_SHIFT_CHUNK):
            idx = np.nonzero(active[lo:lo + MEAN_SHIFT_CHUNK])[0] + lo
            if idx.size == 0:
                continue
            ax, ay, ac = x0[idx], y0[idx], c[idx]
            lox, hix, loy, hiy = (np.rint(v.astype(np.float32) + o).astype(np.int64)
                                  for v in (ax, ay) for o in (-sp, sp))
            in_x = (cols >= lox[:, None]) & (cols <= hix[:, None])
            in_y = (rows >= loy[:, None]) & (rows <= hiy[:, None])
            acf = ac.astype(np.float32)
            d2 = acf @ (-2.0 * col.T).astype(np.float32)
            d2 += sq
            d2 += (acf * acf).sum(1)[:, None]
            take = (in_y[:, :, None] & in_x[:, None, :]).reshape(len(idx), -1)
            take &= d2 <= isr2
            sums = take.astype(np.float32) @ feats
            count = sums[:, 5]
            empty = count == 0
            active[idx[empty]] = False
            keep = ~empty
            idx, sums, ax, ay, ac = idx[keep], sums[keep], ax[keep], ay[keep], ac[keep]
            mean = np.rint(sums[:, :5].astype(np.float64) * (1.0 / sums[:, 5:6].astype(np.float64)))
            mean = mean.astype(np.int64)
            x1, y1, s = mean[:, 0], mean[:, 1], mean[:, 2:]
            moved = np.abs(x1 - ax) + np.abs(y1 - ay) + ((s - ac) ** 2).sum(1)
            stop = ((x1 == ax) & (y1 == ay)) | (moved <= MEAN_SHIFT_EPS)
            x0[idx], y0[idx], c[idx] = x1, y1, s
            active[idx[stop]] = False
        if not active.any():
            break
    return c


def mean_shift_filter(img: np.ndarray, sp: float, sr: float) -> np.ndarray:
    """``cv2.pyrMeanShiftFiltering(img, sp, sr)`` on uint8 RGB, OpenCV's
    defaults (``maxLevel=1``, at most 5 iterations, epsilon 1).  The
    coarsest level of a ``pyrDown`` pyramid is filtered first; each finer
    level starts from the ``pyrUp`` of the level above and filters again
    only where a coarse pixel's colour differs from one of its 8
    neighbours' by ``max(round(sr^2), 16)`` or more: coarse (i, j) marks
    fine (2i + 1, 2j - 1), as OpenCV's pointer arithmetic does, and the
    marks are dilated by 3x3."""
    isr2 = int(np.rint(sr * sr))
    isr22 = max(isr2, 16)
    pyramid = [np.asarray(img)]
    for _ in range(MEAN_SHIFT_LEVELS):
        pyramid.append(_pyr_down(pyramid[-1]))
    dst = None
    for level in range(MEAN_SHIFT_LEVELS, -1, -1):
        src = pyramid[level]
        h, w = src.shape[:2]
        spl = max(np.float32(sp / (1 << level)), np.float32(1))
        if dst is None:
            out = np.empty((h * w, 3), np.int64)
            starts = np.arange(h * w)
        else:
            coarse = dst.astype(np.int64)
            h1, w1 = coarse.shape[:2]
            marks = np.zeros((h, w), bool)
            if h1 > 2 and w1 > 2:
                centre = coarse[1:-1, 1:-1]
                far = np.zeros(centre.shape[:2], bool)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dy or dx:
                            nb = coarse[1 + dy:h1 - 1 + dy, 1 + dx:w1 - 1 + dx]
                            far |= ((centre - nb) ** 2).sum(-1) >= isr22
                marks[3:2 * h1 - 2:2, 1:2 * w1 - 4:2] = far
            marks = ndimage.binary_dilation(marks, np.ones((3, 3), bool))
            starts = np.nonzero(marks.ravel())[0]
            out = _pyr_up(dst, (h, w)).reshape(-1, 3).astype(np.int64)
        out[starts] = _shift(src, spl, isr2, starts)
        dst = out.reshape(h, w, 3).astype(np.uint8)
    return dst


def _lab_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's 8-bit Lab tables: the sRGB gamma in Q3 of 255, the
    D65-normalized RGB -> XYZ matrix in Q12, and f(t) in Q15 over 3072
    steps of 1/2040.  OpenCV computes f with its own software-float cube
    root, which rounds entries 49 and 628 the other way from float64's
    (found by converting all 2^24 colours)."""
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma = np.rint(255 * 8 * gamma).astype(np.int64)
    rgb2xyz = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                        0.019334, 0.119193, 0.950227], np.float32).astype(np.float64).reshape(3, 3)
    white = np.array([0.950456, 1.0, 1.088754], np.float32).astype(np.float64)
    coeffs = np.rint((1 << 12) * rgb2xyz / white[:, None]).astype(np.int64)
    t = np.arange(3072) / 2040.0
    f = np.where(t < 216 / 24389, t * (841 / 108) + 16 / 116, np.cbrt(t))
    cbrt = np.rint((1 << 15) * f).astype(np.int64)
    cbrt[49] -= 1
    cbrt[628] += 1
    return gamma, coeffs, cbrt


_LAB = _lab_tables()


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)`` on uint8 (its fixed-point
    path: L in 0..255 as L*255/100, a and b offset by 128)."""
    gamma, coeffs, cbrt = _LAB
    rgb = gamma[np.asarray(img).astype(np.int64)]
    xyz = (rgb @ coeffs.T + (1 << 11)) >> 12
    fx, fy, fz = cbrt[xyz[..., 0]], cbrt[xyz[..., 1]], cbrt[xyz[..., 2]]
    lscale, lshift = (116 * 255 + 50) // 100, -((16 * 255 * (1 << 15) + 50) // 100)
    half = 1 << 14
    lab = np.stack([(lscale * fy + lshift + half) >> 15,
                    (500 * (fx - fy) + (128 << 15) + half) >> 15,
                    (200 * (fy - fz) + (128 << 15) + half) >> 15], axis=-1)
    return lab.clip(0, 255).astype(np.uint8)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` on uint8:
    ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    a = np.asarray(img).astype(np.int64)
    return ((a[..., 0] * 9798 + a[..., 1] * 19235 + a[..., 2] * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` (3x3 Sobel on a replicated border, L1
    magnitude): non-maximum suppression along the gradient's sector
    (tan 22.5 degrees in Q15), then the pixels above ``low`` that an
    8-connected path of such pixels joins to one above ``high``; 255 on
    an edge, else 0."""
    low, high = int(np.floor(low)), int(np.floor(high))
    low, high = min(low, high), max(low, high)
    h, w = gray.shape
    p = np.pad(gray.astype(np.int64), 1, mode="edge")
    dx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    dy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    mag = np.abs(dx) + np.abs(dy)
    padded = np.pad(mag, 1)  # magnitude 0 outside the image

    def at(oy, ox):
        return padded[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    tg22x = np.abs(dx) * int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)
    ay = np.abs(dy) << 15
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (np.abs(dx) << 16))
    diagonal = ~horizontal & ~vertical
    same_sign = (dx ^ dy) >= 0
    peak = ((horizontal & (mag > at(0, -1)) & (mag >= at(0, 1)))
            | (vertical & (mag > at(-1, 0)) & (mag >= at(1, 0)))
            | (diagonal & same_sign & (mag > at(-1, -1)) & (mag > at(1, 1)))
            | (diagonal & ~same_sign & (mag > at(-1, 1)) & (mag > at(1, -1))))
    weak = peak & (mag > low)
    labels, _ = ndimage.label(weak, structure=np.ones((3, 3), int))
    strong = np.unique(labels[weak & (mag > high)])
    return np.where(np.isin(labels, strong[strong > 0]), 255, 0).astype(np.uint8)


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k), np.uint8))``: the window's maximum."""
    a, squeeze = _hwc(np.asarray(img))
    out = ndimage.maximum_filter(a, size=(k, k, 1), mode="nearest")
    return out[..., 0] if squeeze else out
