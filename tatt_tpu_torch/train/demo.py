"""Demo and visualisation (counterpart of ``tatt_tpu/train/demo.py``).

  - :func:`run_demo` is ``TextSR.demo`` (``super_resolution.py:1788-1876``):
    super-resolve every image of a directory, print the recognizer's LR and
    SR readings and the images per second, save each SR image.
  - :func:`triptych` is ``tripple_display`` (``interfaces/base.py:565-619``):
    LR (bicubic-upscaled), SR and HR stacked into one PNG.
  - :func:`attention_grid`: the TP-Interpreter's attention, one tile per
    text slot (``super_resolution.py:925-1020``).
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
from PIL import Image

from tatt_tpu_torch.data.collate import batch_u8
from tatt_tpu_torch.data.device_pipeline import device_normalize


def _to_pil(chw: np.ndarray) -> Image.Image:
    rgb = np.clip(chw[:3].transpose(1, 2, 0) * 255.0, 0, 255).astype(np.uint8)
    return Image.fromarray(rgb)


def triptych(lr: np.ndarray, sr: np.ndarray, hr: np.ndarray, out_path: str) -> None:
    """Stack LR (bicubic to HR's size), SR and HR ([C, H, W] in [0, 1])
    vertically into one PNG."""
    h, w = hr.shape[-2:]
    canvas = Image.new("RGB", (w, h * 3))
    for i, im in enumerate((_to_pil(lr).resize((w, h), Image.BICUBIC), _to_pil(sr), _to_pil(hr))):
        canvas.paste(im, (0, i * h))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    canvas.save(out_path)


def attention_grid(pr_weights: np.ndarray, out_path: str, feat_hw: tuple[int, int] = (16, 64),
                   grid: tuple[int, int] = (8, 4)) -> None:
    """``pr_weights`` [HW, T], one sample's attention: a grayscale tile per
    text slot (each scaled to its maximum), ``grid`` tiles down and across."""
    h_tiles, w_tiles = grid
    fh, fw = feat_hw
    canvas = np.full(((fh + 1) * h_tiles, (fw + 1) * w_tiles), 255, np.uint8)
    for t in range(min(pr_weights.shape[-1], h_tiles * w_tiles)):
        i, j = divmod(t, w_tiles)
        att = pr_weights[:, t].reshape(fh, fw)
        att = att / (att.max() + 1e-10)
        canvas[i * (fh + 1): i * (fh + 1) + fh, j * (fw + 1): j * (fw + 1) + fw] = (att * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(canvas).save(out_path)


def run_demo(demo_dir: str, sr_fn: Callable[[torch.Tensor], torch.Tensor],
             judge_fn: Callable[[torch.Tensor], list], out_dir: str, device: torch.device,
             width: int = 128, height: int = 32, scale: int = 2, mask: bool = True,
             log=print) -> dict:
    """Each ``.png`` / ``.jpg`` / ``.jpeg`` / ``.bmp`` of ``demo_dir`` in name
    order: resized to the LR size and normalized on ``device``, ``sr_fn``
    (LR [1, C, h, w] -> SR [1, C, H, W]), ``judge_fn`` on LR and SR, the SR
    image saved under ``out_dir``.  Returns the readings and the fps."""
    names = sorted(f for f in os.listdir(demo_dir) if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    results = []
    for name in names:
        img = Image.open(os.path.join(demo_dir, name)).convert("RGB")
        lr = device_normalize(torch.from_numpy(batch_u8([img], (width // scale, height // scale))).to(device),
                              mask)
        sr = sr_fn(lr)
        pred_lr, pred_sr = judge_fn(lr)[0], judge_fn(sr)[0]
        _to_pil(sr[0].cpu().numpy()).save(os.path.join(out_dir, name))
        results.append({"image": name, "pred_lr": pred_lr, "pred_sr": pred_sr})
        log(f"{name}: LR='{pred_lr}' -> SR='{pred_sr}'")
    dt = time.time() - t0
    fps = len(results) / dt if dt > 0 else 0.0
    log(f"demo: {len(results)} images, fps={fps:.2f}")
    return {"results": results, "fps": fps}
