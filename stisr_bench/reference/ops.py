"""Plain operations of the reference: image normalisation, resizes,
sampling and the thin-plate spline, the recurrences as loops, dropout,
the losses, PSNR / SSIM and the CTC greedy decode.

Each follows the published model's definition (TextZoom / TPGSR / TATT
code: ``model/tsrn.py``, ``model/tps_spatial_transformer.py``,
``loss/image_loss.py``, ``loss/semantic_loss.py``, ``utils/ssim_psnr.py``,
``utils/metrics.py``) in float32 NCHW.
"""

from __future__ import annotations

import math
import string
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

CRNN_ALPHABET = "-0123456789abcdefghijklmnopqrstuvwxyz"
LOWER = string.digits + string.ascii_lowercase


# --- images ---------------------------------------------------------------

def normalize_u8(u8_nhwc: torch.Tensor, mask: bool) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3 (+1), H, W] float32 in [0, 1]; the mask
    channel is PIL's fixed-point luma at or under its per-image mean
    (``dataset.py``'s ``resizeNormalize`` with ``mask=True``)."""
    out = (u8_nhwc.float() / 255.0).permute(0, 3, 1, 2)
    if not mask:
        return out.contiguous()
    u = u8_nhwc.to(torch.int64)
    luma = (u[..., 0] * 19595 + u[..., 1] * 38470 + u[..., 2] * 7471 + 0x8000) >> 16
    gray = luma.float()
    m = (gray <= gray.mean(dim=(1, 2), keepdim=True)).float()
    return torch.cat([out, m[:, None]], dim=1)


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
                    np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0))


@lru_cache(maxsize=None)
def bicubic_matrix(n_in: int, n_out: int, a: float = -0.75) -> np.ndarray:
    """[n_out, n_in] weights of torch's ``upsample_bicubic2d``
    (``align_corners=False``, edges clamped)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * n_in / n_out - 0.5
    base = np.floor(src).astype(np.int64)
    mat = np.zeros((n_out, n_in))
    for tap in range(-1, 3):
        np.add.at(mat, (dst.astype(np.int64), np.clip(base + tap, 0, n_in - 1)),
                  _cubic(src - base - tap, a))
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def bilinear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """[n_out, n_in] weights of ``F.interpolate(mode='bilinear')``."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = dst * (n_in - 1) / max(n_out - 1, 1)
    else:
        src = np.maximum((dst + 0.5) * n_in / n_out - 0.5, 0.0)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((n_out, n_in))
    rows = dst.astype(np.int64)
    np.add.at(mat, (rows, np.clip(base, 0, n_in - 1)), 1.0 - frac)
    np.add.at(mat, (rows, np.clip(base + 1, 0, n_in - 1)), frac)
    return mat.astype(np.float32)


def _separable(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    th = torch.as_tensor(wh, device=x.device)
    tw = torch.as_tensor(ww, device=x.device)
    return torch.matmul(torch.matmul(th, x.float()), tw.T).to(x.dtype)


def resize_bicubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return _separable(x, bicubic_matrix(x.shape[-2], h), bicubic_matrix(x.shape[-1], w))


def resize_bilinear(x: torch.Tensor, h: int, w: int, align_corners: bool = False) -> torch.Tensor:
    return _separable(x, bilinear_matrix(x.shape[-2], h, align_corners),
                      bilinear_matrix(x.shape[-1], w, align_corners))


def luma(x: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of the first three channels: [N, 1, H, W]."""
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def crnn_input(images: torch.Tensor) -> torch.Tensor:
    """The CRNN's input: RGB resized bicubically to 32x100, then luma."""
    return luma(resize_bicubic(images[:, :3], 32, 100))


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def rotate(images: torch.Tensor, arc: torch.Tensor, offs: torch.Tensor,
           off_range: float = 0.2) -> torch.Tensor:
    """The reference's ``torch_rotate_img``: rotation by ``arc`` radians
    with the aspect ratio jittered by ``offs`` in [0, 1)."""
    n, c, h, w = images.shape
    ratios = h / float(w) + offs * off_range * 2.0 - off_range
    cos, sin, zero = torch.cos(arc), torch.sin(arc), torch.zeros_like(arc)
    theta = torch.stack([cos, sin * ratios, zero, -sin / ratios, cos, zero], dim=1).reshape(n, 2, 3)
    return grid_sample(images, F.affine_grid(theta, [n, c, h, w], align_corners=False))


def border_points(num_ctrl: int, margin: float) -> np.ndarray:
    """The TPS's border control points: a top and a bottom row."""
    per_side = num_ctrl // 2
    xs = np.linspace(margin, 1.0 - margin, per_side)
    top = np.stack([xs, np.full(per_side, margin)], axis=1)
    bottom = np.stack([xs, np.full(per_side, 1.0 - margin)], axis=1)
    return np.concatenate([top, bottom], axis=0)


def _phi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 0.5 * d * np.log(d)
    r[~np.isfinite(r)] = 0.0
    return r


@lru_cache(maxsize=None)
def tps_matrices(h: int, w: int, num_ctrl: int = 20, margin: float = 0.05):
    """(inverse kernel [K+3, K+3], target representation [HW, K+3]) of
    ``tps_spatial_transformer.py``."""
    tcp = border_points(num_ctrl, margin)
    n = num_ctrl
    kern = np.zeros((n + 3, n + 3))
    kern[:n, :n] = _phi(tcp, tcp)
    kern[:n, -3] = 1.0
    kern[-3, :n] = 1.0
    kern[:n, -2:] = tcp
    kern[-2:, :n] = tcp.T
    yx = np.array([(y, x) for y in range(h) for x in range(w)], dtype=np.float64)
    coord = np.stack([yx[:, 1] / (w - 1), yx[:, 0] / (h - 1)], axis=1)
    rep = np.concatenate([_phi(coord, tcp), np.ones((h * w, 1)), coord], axis=1)
    return np.linalg.inv(kern).astype(np.float32), rep.astype(np.float32)


def tps_warp(images: torch.Tensor, ctrl: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Warp ``images`` by the TPS that maps the border points to ``ctrl``
    [N, K, 2], sampled at ``size``."""
    n, k = ctrl.shape[:2]
    h, w = size
    inv, rep = (torch.as_tensor(m, device=images.device) for m in tps_matrices(h, w, k))
    padded = torch.cat([ctrl.float(), ctrl.new_zeros(n, 3, 2, dtype=torch.float32)], 1)
    source = torch.einsum("ha,nac->nhc", rep, torch.einsum("ab,nbc->nac", inv, padded))
    grid = source.reshape(n, h, w, 2).clamp(0.0, 1.0) * 2.0 - 1.0
    return grid_sample(images, grid.to(images.dtype))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c, h, w = x.shape
    oc = c // (r * r)
    return x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3).reshape(n, oc, h * r, w * r)


def dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Inverted dropout whose keep mask is one uniform draw of ``x``'s
    shape from ``gen``; the identity without a generator."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


@lru_cache(maxsize=None)
def sinusoid_table(length: int, d: int) -> np.ndarray:
    pe = np.zeros((length, d), dtype=np.float32)
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


# --- recurrences ----------------------------------------------------------

def _both_ways(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x, x.flip(1)])


def _rejoin(y: torch.Tensor) -> torch.Tensor:
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def bigru(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Bidirectional GRU (torch gate order r, z, n), one step at a time:
    ``x`` [R, L, In], weights stacked [2, ...] by direction -> [R, L, 2H]."""
    hid = w_hh.shape[-1]
    gx = torch.einsum("drli,dgi->drlg", _both_ways(x), w_ih) + b_ih[:, None, None]
    h = x.new_zeros(2, x.shape[0], hid)
    ys = []
    for t in range(x.shape[1]):
        gh = torch.baddbmm(b_hh[:, None], h, w_hh.transpose(1, 2))
        g = gx[:, :, t]
        r = torch.sigmoid(g[..., :hid] + gh[..., :hid])
        z = torch.sigmoid(g[..., hid:2 * hid] + gh[..., hid:2 * hid])
        n = torch.tanh(g[..., 2 * hid:] + r * gh[..., 2 * hid:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return _rejoin(torch.stack(ys, dim=2))


def bilstm(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Bidirectional LSTM (gate order i, f, g, o), one step at a time."""
    hid = w_hh.shape[-1]
    gx = torch.einsum("drli,dgi->drlg", _both_ways(x), w_ih) + b_ih[:, None, None]
    h = x.new_zeros(2, x.shape[0], hid)
    c = x.new_zeros(2, x.shape[0], hid)
    ys = []
    for t in range(x.shape[1]):
        a = gx[:, :, t] + torch.baddbmm(b_hh[:, None], h, w_hh.transpose(1, 2))
        i, f = torch.sigmoid(a[..., :hid]), torch.sigmoid(a[..., hid:2 * hid])
        g, o = torch.tanh(a[..., 2 * hid:3 * hid]), torch.sigmoid(a[..., 3 * hid:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return _rejoin(torch.stack(ys, dim=2))


# --- losses and metrics ---------------------------------------------------

def gradient_map(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    r = F.pad(x, (0, 1))[..., :, 1:]
    left = F.pad(x, (1, 0))[..., :, :w]
    t = F.pad(x, (0, 0, 1, 0))[..., :h, :]
    b = F.pad(x, (0, 0, 0, 1))[..., 1:, :]
    return torch.sqrt(((r - left) * 0.5) ** 2 + ((t - b) * 0.5) ** 2 + 1e-6)


def image_loss(sr: torch.Tensor, hr: torch.Tensor, gradient: bool = True) -> torch.Tensor:
    """Per-sample MSE plus 1e-4 x the L1 of the RGB gradient maps [N]."""
    loss = ((sr - hr) ** 2).mean(dim=(1, 2, 3))
    if gradient:
        diff = (gradient_map(sr[:, :3]) - gradient_map(hr[:, :3])).abs()
        loss = loss + 1e-4 * diff.mean(dim=(1, 2, 3))
    return loss


def semantic_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean |gt - pred| plus the elementwise-mean KL of pred from gt."""
    gt_eps = gt + 1e-20
    return (gt - pred).abs().mean() + (gt_eps * (torch.log(gt_eps) - torch.log(pred + 1e-20))).mean()


C1, C2 = 0.01**2, 0.03**2


@lru_cache(maxsize=None)
def gaussian(n: int, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(n, dtype=np.float64) - n // 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return (w / w.sum()).astype(np.float32)


def blur(img: torch.Tensor, n: int = 11) -> torch.Tensor:
    """Depthwise 'same' n x n Gaussian window with zero padding."""
    c = img.shape[1]
    row = torch.as_tensor(gaussian(n), device=img.device).reshape(1, 1, 1, n)
    col = row.reshape(1, 1, n, 1)
    y = F.conv2d(img, row.expand(c, 1, 1, n), padding=(0, n // 2), groups=c)
    return F.conv2d(y, col.expand(c, 1, n, 1), padding=(n // 2, 0), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of the RGB channels."""
    a, b = a[:, :3].float(), b[:, :3].float()
    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def tri_ssim(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The three-way SSIM of the rotation-consistency loss, over every
    channel."""
    imgs = [i.float() for i in (a, b, c)]
    mu = [blur(i) for i in imgs]
    sq = [m * m for m in mu]
    cross = [mu[0] * mu[1], mu[1] * mu[2], mu[2] * mu[0]]
    var = [blur(i * i) - s for i, s in zip(imgs, sq)]
    cov = [blur(imgs[p] * imgs[q]) - x for (p, q), x in zip(((0, 1), (1, 2), (2, 0)), cross)]
    m = ((sum(cross) + C1) * (sum(cov) + C2)) / ((sum(sq) + C1) * (sum(var) + C2))
    return m.mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = ((a[:, :3] * 255.0 - b[:, :3] * 255.0) ** 2).mean()
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def ctc_greedy(best: np.ndarray, alphabet: str = CRNN_ALPHABET) -> list[str]:
    """Blank collapse of greedy ids [B, T], the reference's
    ``get_string_crnn`` (a blank resets the repeat tracker)."""
    out = []
    for row in np.asarray(best):
        s, last = "", ""
        for idx in row:
            ch = alphabet[int(idx)]
            if ch != last:
                if idx != 0:
                    s += ch
                    last = ch
                else:
                    last = ""
        out.append(s)
    return out


def lower_filter(s: str) -> str:
    """``str_filt(s, 'lower')``: lowercase, digits and letters only."""
    return "".join(ch for ch in s.lower() if ch in LOWER)
