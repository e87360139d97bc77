"""SSIM, PSNR and the TRI-SSIM loss (counterpart of ``tatt_tpu/losses/ssim.py``).

SSIM uses the reference's 11x11 Gaussian window (sigma 1.5), and
``distorted_ssim`` rectangular ones, applied as two separable 1-D
depthwise passes in float32.  With TF32 off
(:func:`tatt_tpu_torch.core.device.set_cuda_flags`) the window convs stay in
full f32 on the card: the variances E[x^2] - E[x]^2 cancel badly in any
reduced precision (``ssim.py:41-48``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2


@lru_cache(maxsize=None)
def _gaussian_1d(n: int, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(n, dtype=np.float64) - n // 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return (w / w.sum()).astype(np.float32)


def _depthwise_filter(img: torch.Tensor, window) -> torch.Tensor:
    """Depthwise 'same' Gaussian filter of NCHW, zero padding, as a row
    pass then a column pass.  ``window``: n for an n x n window, or
    (height, width) for a rectangular one (``distorted_ssim``)."""
    kh, kw = (window, window) if isinstance(window, int) else window
    c = img.shape[1]
    row = torch.as_tensor(_gaussian_1d(kw), device=img.device).reshape(1, 1, 1, kw)
    col = torch.as_tensor(_gaussian_1d(kh), device=img.device).reshape(1, 1, kh, 1)
    y = F.conv2d(img, row.expand(c, 1, 1, kw), padding=(0, kw // 2), groups=c)
    return F.conv2d(y, col.expand(c, 1, kh, 1), padding=(kh // 2, 0), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size=11) -> torch.Tensor:
    """Mean SSIM over the first 3 channels (``utils/ssim_psnr.py:76-96``);
    ``window_size`` as :func:`_depthwise_filter`'s ``window``."""
    img1 = img1[:, :3].float()
    img2 = img2[:, :3].float()
    mu1 = _depthwise_filter(img1, window_size)
    mu2 = _depthwise_filter(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_filter(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_filter(img1 * img2, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


def distorted_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean of the SSIMs with rectangular windows (5, 11), (11, 5) and
    (11, 11) (``utils/ssim_psnr.py:158-197``, ``ssim.py:136-158``): the
    ``--ssim_loss`` of the ``tsrn`` arch."""
    return sum(ssim(img1, img2, window) for window in ((5, 11), (11, 5), (11, 11))) / 3.0


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR on RGB in [0, 1] scaled x255 (``utils/ssim_psnr.py:9-15``)."""
    mse = ((img1[:, :3] * 255.0 - img2[:, :3] * 255.0) ** 2).mean()
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def tri_ssim(
    img1: torch.Tensor, img2: torch.Tensor, img3: torch.Tensor, window_size: int = 11
) -> torch.Tensor:
    """Three-way SSIM for rotation consistency (``utils/ssim_psnr.py:99-129``),
    over ALL channels as the reference's TRI_SSIM (``ssim.py:103-133``)."""
    imgs = [i.float() for i in (img1, img2, img3)]
    mu = [_depthwise_filter(i, window_size) for i in imgs]
    sq = [m * m for m in mu]
    cross = [mu[0] * mu[1], mu[1] * mu[2], mu[2] * mu[0]]
    var = [_depthwise_filter(i * i, window_size) - s for i, s in zip(imgs, sq)]
    pairs = ((0, 1), (1, 2), (2, 0))
    cov = [_depthwise_filter(imgs[a] * imgs[b], window_size) - c for (a, b), c in zip(pairs, cross)]
    ssim_map = ((sum(cross) + C1) * (sum(cov) + C2)) / ((sum(sq) + C1) * (sum(var) + C2))
    return ssim_map.mean()
