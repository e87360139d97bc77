"""Model FLOPs of a cell's work, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
and convolutions (forward, and for a train step the backward too) of the
reference's step (its arch's ``loss`` and ``sr``, ``reference/archs/``)
on meta tensors at the cell's shapes: nothing is computed, and the port's
model is never counted, whose recurrences run in kernels that the counter
cannot see.  The reference's recurrences are loops of matrix products, so
theirs are counted.  Dropout and the rotation draw nothing here; they add
no products.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from stisr_bench.reference import archs, nets, ops, steps


def _images(batch: int, geometry: dict) -> dict:
    w, h, s = geometry["width"], geometry["height"], geometry["down_sample_scale"]
    return {"images_hr": torch.zeros((batch, h, w, 3), dtype=torch.uint8, device="meta"),
            "images_lr": torch.zeros((batch, h // s, w // s, 3), dtype=torch.uint8, device="meta")}


def train_step(config: dict, batch: int) -> float:
    """FLOPs of one training step at ``batch``."""
    with torch.device("meta"):
        models = nets.build(config)
    for name in ("generator", "student"):
        models[name].train()
    models["teacher"].eval()
    counter = FlopCounterMode(display=False)
    with counter:
        archs.load(config["arch"]).loss(models, _images(batch, config["geometry"]), None).backward()
    return float(counter.get_total_flops())


def eval_batch(config: dict, batch: int) -> float:
    """FLOPs of the evaluation of one batch: SR, PSNR / SSIM of SR and of
    the bicubic LR, and the judge on SR, LR and HR."""
    with torch.device("meta"):
        models = nets.build(config)
    for m in models.values():
        m.eval().requires_grad_(False)
    counter = FlopCounterMode(display=False)
    imgs = _images(batch, config["geometry"])
    with counter:
        hr = ops.normalize_u8(imgs["images_hr"], True)
        lr = ops.normalize_u8(imgs["images_lr"], True)
        sr = steps.sr_images(config["arch"], models, lr)
        lr_up = ops.resize_bicubic(lr, hr.shape[-2], hr.shape[-1])
        for x in (sr, lr_up):
            ops.psnr(x, hr), ops.ssim(x, hr)
        for x in (sr, lr, hr):
            models["teacher"](ops.crnn_input(x))
    return float(counter.get_total_flops())
