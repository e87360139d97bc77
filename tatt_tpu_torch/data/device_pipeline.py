"""Device-side image normalization — the uint8 fast path (copied from
``tatt_tpu/data/device_pipeline.py``).

Batches ship as stacked [B, H, W, 3] uint8 crops (4x fewer bytes to the
card than float32); the float conversion, the NCHW layout and the mask
channel (PIL's exact fixed-point luma, thresholded at its per-image mean)
run on the device.  :func:`host_normalize_u8` is the numpy twin, and
:func:`prep_image_batch` normalizes the image leaves of a train batch, as
the JAX train step does first (``steps.py:116``).
"""

from __future__ import annotations

import numpy as np
import torch


def device_normalize(u8_nhwc: torch.Tensor, mask: bool) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, C, H, W] float32 in [0, 1] (+ mask ch)."""
    out = (u8_nhwc.float() / 255.0).permute(0, 3, 1, 2)
    if not mask:
        return out.contiguous()
    u = u8_nhwc.to(torch.int64)
    luma = (u[..., 0] * 19595 + u[..., 1] * 38470 + u[..., 2] * 7471 + 0x8000) >> 16
    gray = luma.float()
    thres = gray.mean(dim=(1, 2), keepdim=True)
    m = (gray <= thres).float()
    return torch.cat([out, m[:, None]], dim=1)


def host_normalize_u8(u8_nhwc: np.ndarray, mask: bool) -> np.ndarray:
    """Numpy twin of :func:`device_normalize`."""
    out = (u8_nhwc.astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
    if not mask:
        return out
    u = u8_nhwc.astype(np.uint32)
    luma = (u[..., 0] * 19595 + u[..., 1] * 38470 + u[..., 2] * 7471 + 0x8000) >> 16
    gray = luma.astype(np.float32)
    thres = gray.mean(axis=(1, 2), keepdims=True)
    m = (gray <= thres).astype(np.float32)
    return np.concatenate([out, m[:, None]], axis=1)


IMAGE_KEYS = ("images_hr", "images_lr", "images_hr_y", "images_lr_y")


def prep_image_batch(batch: dict, mask: bool) -> dict:
    """The batch with its uint8 image leaves normalized
    (:func:`device_normalize`); float leaves pass through."""
    return {k: device_normalize(v, mask) if k in IMAGE_KEYS and v.dtype == torch.uint8 else v
            for k, v in batch.items()}
